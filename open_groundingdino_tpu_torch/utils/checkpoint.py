"""Checkpoint save and resume through torch.save (the port of the JAX
package's utils/checkpoint.py save_checkpoint / latest_checkpoint /
restore_checkpoint, which use Orbax; reference main.py:348-381).

`OUT/checkpoint_{epoch}.pth` holds TrainState.state_dict() plus "epoch":
{"model": reference-keyed state dict, "optimizer", "ema", "epoch", "step",
"nonfinite_count", "generator"}.  Its "model" key is the container a
reference .pth has, so `inference.load_model`, `load_reference_state_dict`
and the JAX package's `load_torch_state_dict` read it as one.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Dict, Optional

import torch

_NAME = re.compile(r"checkpoint_(\d+)\.pth$")


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"checkpoint_{epoch}.pth")


def save_checkpoint(ckpt_dir: str, epoch: int, payload: Dict) -> str:
    """torch.save `payload` as ckpt_dir/checkpoint_{epoch}.pth, written under
    a temporary name and renamed, so a reader never sees half a file;
    returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, epoch)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def link_checkpoint(src: str, ckpt_dir: str, epoch: int) -> str:
    """ckpt_dir/checkpoint_{epoch}.pth as a hard link to the checkpoint file
    `src`, for a state already on disk (best/ of the epoch just saved: one
    write of ~2.6 GB instead of two); made under a temporary name and
    renamed as save_checkpoint writes, so a later save replaces the link and
    leaves `src` as it is.  A file system without hard links gets a copy.
    Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, epoch)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the largest epoch in ckpt_dir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m]
    return checkpoint_path(ckpt_dir, max(epochs)) if epochs else None


def restore_checkpoint(path: str) -> Dict:
    """The saved payload, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
