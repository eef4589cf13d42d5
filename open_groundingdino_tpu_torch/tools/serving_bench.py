"""Serving latency of the port's ahead-of-time artifact (the JAX package's
tools/serving_bench.py, plus --device).

Exports the model as a serving artifact (serving.export_model: torch.export
programs whose hand-written kernels are the ogd_torch ops), reloads it as a
serving process would (serving.load_exported) and times the loaded
program's call on a device-resident batch, each call closed by a host fetch
of the boxes.

    python -m open_groundingdino_tpu_torch.tools.serving_bench          # flagship, card
    python -m open_groundingdino_tpu_torch.tools.serving_bench --nano --device cpu

Prints ONE JSON line {"aot_latency_ms", "aot_img_s", "first_call_s",
"export_s", "artifact_mb", "bucket", "batch", "platform", ...}.  The weights
are a seeded random init; the artifact goes to a temporary directory,
removed afterwards.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from .benchmark import DEFAULT_CONFIG, build_model, platform

# the JAX tool's --nano geometry
NANO = dict(backbone="swin_nano_test", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
            dim_feedforward=64, num_queries=12, max_text_len=24, bert_vocab_size=32,
            bert_hidden_size=32, bert_layers=1, bert_heads=4, bert_intermediate=32,
            use_checkpoint=False, use_transformer_ckpt=False)
VOCAB = "[PAD] [UNK] [CLS] [SEP] [MASK] .".split() + [f"tok{i}" for i in range(64)]
REPEATS = 3   # the latency is the least mean of --iters calls over this many runs


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("serving_bench")
    ap.add_argument("-c", "--config", default=DEFAULT_CONFIG)
    ap.add_argument("--bucket", default="800x1216")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--nano", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def run(cli, cfg=None) -> Dict:
    """The benchmark of parsed `cli`; `cfg` stands in for --config.  Returns
    the line it prints."""
    import torch

    from ..config import SLConfig
    from ..data.tokenization import build_tokenizer
    from ..data.transforms import Bucketer
    from ..inference import InferenceModel
    from ..serving import export_model, load_exported

    args = cfg if cfg is not None else SLConfig.fromfile(cli.config)
    bucket = cli.bucket
    if cli.nano:
        for k, v in NANO.items():
            setattr(args, k, v)
        bucket = "64x96"
    H, W = (int(x) for x in bucket.split("x"))
    B, T = cli.batch, int(args.max_text_len)
    device = torch.device(cli.device)
    model = build_model(args, device).eval()

    rng = np.random.RandomState(0)
    ids = rng.randint(5, 30, size=(B, T)).astype(np.int64)
    inputs = (rng.randn(B, H, W, 3).astype(np.float32), np.asarray([[H, W]] * B, np.int64), ids,
              np.ones((B, T), bool), np.tile(np.arange(T, dtype=np.int64)[None], (B, 1)),
              np.ones((B, T, T), bool))

    work = tempfile.mkdtemp(prefix="serving_bench_")
    try:
        vocab = os.path.join(work, "vocab_src.txt")
        with open(vocab, "w") as f:
            f.write("\n".join(VOCAB) + "\n")
        im = InferenceModel(model=model, tokenizer=build_tokenizer(vocab), args=args,
                            bucketer=Bucketer([(H, W)]), max_text_len=T, device=device)
        out_dir = os.path.join(work, "artifact")
        t0 = time.perf_counter()
        export_model(im, out_dir, buckets=[(H, W)], batch=B, vocab_path=vocab)
        export_s = time.perf_counter() - t0
        artifact_mb = sum(os.path.getsize(os.path.join(out_dir, f))
                          for f in os.listdir(out_dir)) / 1e6
        del im, model

        sm = load_exported(out_dir, device=device)
        dev_inputs = tuple(torch.from_numpy(x).to(device) for x in inputs)
        t0 = time.perf_counter()
        out = sm.model(*dev_inputs)
        out["pred_boxes"].cpu()   # the first call settles; the host fetch fences
        first_call_s = time.perf_counter() - t0

        best = float("inf")
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(cli.iters):
                out = sm.model(*dev_inputs)
                out["pred_boxes"].cpu()
            best = min(best, (time.perf_counter() - t0) / cli.iters)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    line = {
        "metric": ("AOT serving latency (nano, cpu)" if cli.nano
                   else f"AOT serving latency ({args.backbone})"),
        "aot_latency_ms": round(best * 1e3, 2),
        "aot_img_s": round(B / best, 3),
        "first_call_s": round(first_call_s, 2),
        "export_s": round(export_s, 2),
        "artifact_mb": round(artifact_mb, 1),
        "bucket": f"{H}x{W}",
        "batch": B,
        "platform": platform(device),
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[list] = None) -> Dict:
    return run(get_args_parser().parse_args(argv))


if __name__ == "__main__":
    main()
