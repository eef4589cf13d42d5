"""Node-local dataset staging (reference datasets/data_util.py:117-169
`preparing_dataset`); the port's own copy of the JAX package's
data/staging.py.

The reference copies datasets from shared storage to node-local disk before
training (rank 0 of a node copies or unzips, and the copied paths are
recorded for cleanup at exit).  `main --stage_dir` stages the manifest's
paths, trains or evaluates on the copies, and removes them at the end.  A
marker file next to each copy makes a second run idempotent, and lets the
processes of a node share one copy (`stage_datasets_for_node`: local rank 0
copies, the others find the markers after a barrier, the JAX package's
staging barrier in its main.py:171-175).

Manifest entries keep their split/mode keys; `root`, `anno` and
`label_map` paths are rewritten to the staged locations.  `.zip` sources
are extracted next to their copy, mirroring the reference's unzip branch.
"""
from __future__ import annotations

import os
import shutil
import zipfile
from typing import Dict, List, Tuple

from ..parallel import dist


def _stage_one(src: str, stage_dir: str, copylist: List[str]) -> str:
    """Copy file/dir/zip `src` under stage_dir (idempotent via a .staged
    marker); returns the staged path to use in the manifest."""
    src = os.path.abspath(src)
    name = os.path.basename(src.rstrip("/"))
    dst = os.path.join(stage_dir, name)
    marker = dst + ".staged"
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() != src:
                # basename collision between two different sources:
                # disambiguate with a short hash of the source path
                import hashlib

                tag = hashlib.sha1(src.encode()).hexdigest()[:8]
                dst = os.path.join(stage_dir, f"{tag}_{name}")
                marker = dst + ".staged"

    if src.endswith(".zip"):
        # copy + extract (reference data_util.py:141-149); the manifest
        # path becomes the extraction dir named after the archive stem
        extract_dir = dst[: -len(".zip")]
        if not os.path.exists(marker):
            os.makedirs(stage_dir, exist_ok=True)
            shutil.copy2(src, dst)
            with zipfile.ZipFile(dst, "r") as zf:
                zf.extractall(extract_dir)
            copylist.extend([dst, extract_dir])
            with open(marker, "w") as f:
                f.write(src)
        return extract_dir

    if not os.path.exists(marker):
        os.makedirs(stage_dir, exist_ok=True)
        if os.path.isdir(src):
            if os.path.exists(dst):
                shutil.rmtree(dst)  # reference: "path exist. remove it!"
            # never descend into the stage dir itself (staging a root that
            # CONTAINS stage_dir would otherwise recurse forever)
            stage_abs = os.path.abspath(stage_dir)

            def _skip_stage(d, names):
                return [
                    n for n in names
                    if os.path.abspath(os.path.join(d, n)) == stage_abs
                ]

            shutil.copytree(src, dst, ignore=_skip_stage)
        else:
            shutil.copy2(src, dst)
        copylist.append(dst)
        with open(marker, "w") as f:
            f.write(src)
    return dst


def stage_datasets(
    manifest: Dict, stage_dir: str
) -> Tuple[Dict, List[str]]:
    """Stage every dataset path in a `datasets.json`-shaped manifest to
    `stage_dir`; returns (staged_manifest, copyfilelist).  copyfilelist is
    the reference's `args.copyfilelist` — pass it to `cleanup_staged` at
    exit to reclaim the local disk."""
    copylist: List[str] = []
    staged: Dict = {}
    for split, entries in manifest.items():
        staged[split] = []
        for entry in entries:
            e = dict(entry)
            for key in ("root", "anno", "label_map"):
                if e.get(key):
                    e[key] = _stage_one(e[key], stage_dir, copylist)
            staged[split].append(e)
    return staged, copylist


def stage_datasets_for_node(manifest: Dict, stage_dir: str,
                            local_rank: int) -> Tuple[Dict, List[str]]:
    """stage_datasets in every process of a node: local rank 0 copies, every
    rank waits at a barrier, then the others stage too, finding each copy's
    marker and copying nothing.  Returns the staged manifest and the copies
    this process made (local rank 0's), for cleanup_staged once no rank
    reads them."""
    staged, copylist = (stage_datasets(manifest, stage_dir) if local_rank == 0
                        else (None, []))
    dist.barrier()
    if local_rank != 0:
        staged, _ = stage_datasets(manifest, stage_dir)
    return staged, copylist


def cleanup_staged(copylist: List[str]) -> None:
    """Remove staged copies (reference data_util.py remove())."""
    for p in copylist or []:
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.remove(p)
        marker = p + ".staged"
        if os.path.exists(marker):
            os.remove(marker)
