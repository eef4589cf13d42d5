"""Export a checkpoint as a serving artifact (the JAX package's
tools/export_model.py; serving.py has the artifact layout).

    python -m open_groundingdino_tpu_torch.tools.export_model -c CONFIG \\
        --checkpoint ckpt.pth --vocab vocab.txt -o artifact_dir \\
        [--bucket 800x1216 ...] [--batch 1] [--device cuda]

CONFIG picks the model and its MSDA path (msda_kernel); CKPT is a
reference-keyed .pth.  One torch.export program is written per bucket (by
default every image bucket of the config), for the device it runs on (CUDA
unless --device says otherwise), which is the device the artifact is then
served on: `serving.load_exported(artifact_dir)` rebuilds the model there
without its code.  Prints each file written, its size, and each program's
export seconds.
"""
from __future__ import annotations

import argparse
import os

from ..inference import load_model
from ..serving import export_model


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("GroundingDINO port: export a serving artifact")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--checkpoint", required=True, help="reference-keyed .pth")
    ap.add_argument("--vocab", required=True, help="bert vocab.txt")
    ap.add_argument("--output_dir", "-o", required=True)
    ap.add_argument("--bucket", action="append", default=None,
                    help="HxW static shape to export (repeatable); default: every config "
                         "image bucket")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the device the programs are exported for, and served on")
    return ap


def main(args) -> list:
    """Writes the artifact; returns the file names written."""
    buckets = None
    if args.bucket:
        buckets = [tuple(int(v) for v in b.lower().split("x")) for b in args.bucket]
    im = load_model(args.config_file, args.checkpoint, args.vocab, device=args.device)
    seconds = {}
    written = export_model(im, args.output_dir, buckets=buckets, batch=args.batch,
                           vocab_path=args.vocab, seconds=seconds)
    print(f"wrote {len(written)} files to {args.output_dir}:")
    for name in written:
        size = os.path.getsize(os.path.join(args.output_dir, name))
        took = f"  (export {seconds[name]:.1f} s)" if name in seconds else ""
        print(f"  {name}  {size / 1e6:.2f} MB{took}")
    return written


if __name__ == "__main__":
    main(get_args_parser().parse_args())
