#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits nonzero, with no result):
  1. device  - the card (nvidia-smi name and power limit); TF32 off for parity
  2. build   - nvcc of every csrc/*.cu kernel (into build/torch_kernels/)
  3. K1      - the MSDA kernel against its plain PyTorch version on the card,
               at the encoder (Q = L, 2-d refs) and decoder (Q = 900, 4-d refs)
               shapes of the 800x1216 bucket
  4. K2      - the fusion kernel against its plain version at the encoder
               fusion shape (Nv = 20197, Nl = 256 with 41 live tokens, E = 1024)
  5. serve   - load_model + predict at full Swin-T / BERT-base width (seeded
               random weights, synthetic 30522-entry WordPiece vocab) on three
               images of different sizes with two captions; counts the kernel
               launches of that run (12 K1 + 6 K2 per request)
  6. forward - one request's pred_logits / pred_boxes on the card against the
               same model on the CPU (plain versions), flip-aware
  7. profile - torch.profiler over one request: device time by kernel group
then the {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

Exits nonzero when no CUDA device is present.  Scratch files (checkpoint and
vocab) go to build/chip_smoke/ and are removed at the end.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BUCKET = (800, 1216)
HEADS, HEAD_DIM, LEVELS, POINTS = 8, 32, 4, 4      # flagship MSDA geometry
FUSION_E, FUSION_HEADS, TEXT_LEN, LIVE_TEXT = 1024, 4, 256, 41
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside the
# tensor cores (both kernels compute in f32 on the SIMT units)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
K1_TOL = 1e-4   # f32; only the order of the 64 weighted taps differs
K2_TOL = 1e-4   # f32; online softmax and split partials reorder the sums
CAPTIONS = ("a cat . a dog .", "person . bicycle . car . traffic light .")
IMAGE_SIZES = ((480, 640), (720, 1280), (700, 500))   # (h, w): three buckets


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def level_shapes(h: int, w: int):
    """Feature-map shapes of the flagship model at an (h, w) bucket: Swin-T
    patch 4, three ceil-halving merges (out_indices 1, 2, 3), then the extra
    stride-2 3x3 conv level."""
    h, w = -(-h // 4), -(-w // 4)
    shapes = []
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    shapes.append(((h - 1) // 2 + 1, (w - 1) // 2 + 1))
    return tuple(shapes)


def event_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn over `iters` back-to-back launches,
    after one warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- K1 (MSDA)
def msda_inputs(shapes, num_queries, ref_dim: int, g, device):
    """Seeded K1 operands at the model's layout.  Encoder (ref_dim 2): every
    token queries around its own centre; decoder (ref_dim 4): queries around
    random boxes.  Offsets of a few pixels, as after training."""
    import torch

    B, H, D, NL, P = 1, HEADS, HEAD_DIM, LEVELS, POINTS
    L = sum(h * w for h, w in shapes)
    value = torch.randn(B, L, H, D, generator=g, device=device)
    offs = torch.randn(B, num_queries, H, NL, P, 2, generator=g, device=device) * 2.0
    if ref_dim == 2:
        centres = []
        for h, w in shapes:
            ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                                    indexing="ij")
            centres.append(torch.stack([(xs.flatten() + 0.5) / w, (ys.flatten() + 0.5) / h], -1))
        ref = torch.cat(centres)[None, :, None, None, None, :]
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=device)
        locs = ref + offs / wh[None, None, None, :, None, :]
    else:
        cxcy = torch.rand(B, num_queries, 1, 1, 1, 2, generator=g, device=device)
        bwh = 0.02 + 0.48 * torch.rand(B, num_queries, 1, 1, 1, 2, generator=g, device=device)
        locs = cxcy + offs / P * bwh * 0.5
    logits = torch.randn(B, num_queries, H, NL * P, generator=g, device=device)
    attn = torch.softmax(logits, -1).view(B, num_queries, H, NL, P)
    return value, locs.contiguous(), attn.contiguous()


def msda_bound_ms(value, shapes, locs, attn) -> tuple:
    """(least ms, "bytes"|"operations"): the value rows these locations touch
    (distinct in-map corner (position, head) rows, each read once), locations
    and weights read once and the output written once, against 2 FLOP per
    channel for every in-map corner plus ~16 FLOP of index math per sample."""
    import torch

    B, Q, H, NL, P, _ = locs.shape
    L, D = value.shape[1], value.shape[-1]
    touched = torch.zeros(B, H, L, dtype=torch.bool, device=locs.device)
    bh = (torch.arange(B, device=locs.device)[:, None, None, None] * H
          + torch.arange(H, device=locs.device)[None, None, :, None]) * L     # (B, 1, H, 1)
    corners, start = 0, 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(locs[:, :, :, lvl, :, 0] * w - 0.5).long()
        y0 = torch.floor(locs[:, :, :, lvl, :, 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                corners += int(inside.sum())
                touched.view(-1)[(bh + start + y * w + x)[inside]] = True
        start += h * w
    nbytes = (int(touched.sum()) * D * value.element_size() + locs.numel() * 4
              + attn.numel() * 4 + B * Q * H * D * value.element_size())
    ops = 2 * D * corners + 16 * B * Q * H * NL * P
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_msda(g, device):
    import torch

    from open_groundingdino_tpu_torch.ops import msda

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    rows = {}
    for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
        value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device)
        out_k = msda.ms_deform_attn(value, shapes, starts, locs, attn)
        out_p = msda.ms_deform_attn_plain(value, shapes, starts, locs, attn)
        err = float((out_k - out_p).abs().max())
        ms = event_ms(lambda: msda.ms_deform_attn(value, shapes, starts, locs, attn), 50)
        plain_ms = event_ms(lambda: msda.ms_deform_attn_plain(value, shapes, starts, locs, attn), 5)
        bound_ms, bound_by = msda_bound_ms(value, shapes, locs, attn)
        rows[name] = dict(Q=q, L=L, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log("K1", f"{name}: Q={q} L={L} shapes={shapes} max|kernel-plain|={err:.3e} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})")
        if not err <= K1_TOL:
            raise AssertionError(f"K1 {name}: max abs error {err} > {K1_TOL}")
        # the bf16-value entry point: both versions accumulate in f32 and
        # round the output to bf16 (8 significant bits), so they differ by at
        # most one bf16 step, 2^-7 of the largest output
        value_bf16 = value.to(torch.bfloat16)
        out_k = msda.ms_deform_attn(value_bf16, shapes, starts, locs, attn).float()
        out_p = msda.ms_deform_attn_plain(value_bf16, shapes, starts, locs, attn).float()
        err, tol = float((out_k - out_p).abs().max()), 2 ** -7 * float(out_p.abs().max())
        rows[name]["bf16_max_abs_err"] = err
        log("K1", f"{name} with bf16 values: max|kernel-plain|={err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K1 {name} bf16: max abs error {err} > {tol}")
    return rows


# ---------------------------------------------------------------- K2 (fusion)
def fusion_inputs(g, device):
    """Seeded K2 operands at the encoder fusion shape: the raw (B, N, E)
    projections, q pre-scaled by D^-0.5; the image of the 800x1216 bucket is
    800x1066 (the right columns of every level padded); 41 live text tokens."""
    import torch

    shapes = level_shapes(*BUCKET)
    nv = sum(h * w for h, w in shapes)
    D = FUSION_E // FUSION_HEADS
    q = torch.randn(1, nv, FUSION_E, generator=g, device=device) * D ** -0.5
    k = torch.randn(1, TEXT_LEN, FUSION_E, generator=g, device=device)
    val_v = torch.randn(1, nv, FUSION_E, generator=g, device=device)
    val_l = torch.randn(1, TEXT_LEN, FUSION_E, generator=g, device=device)
    masks = []
    for (h, w), s in zip(shapes, (8, 16, 32, 64)):
        cols = torch.arange(w, device=device)
        masks.append((cols >= -(-1066 // s)).expand(h, w).flatten())
    mask_v = torch.cat(masks)[None]
    mask_l = (torch.arange(TEXT_LEN, device=device) >= LIVE_TEXT)[None]
    return q, k, val_v, val_l, mask_v, mask_l


def fusion_bound_ms(q, k, mask_v, mask_l) -> tuple:
    """Each operand read once and each output written once, against the
    products this data needs: logits for the (image, text) pairs some output
    reads (every image token with the live text, every text token with the
    live image), the image->text product over live text tokens, the
    text->image product over live image tokens."""
    B, nv, E = q.shape
    nl = k.shape[1]
    D = E // FUSION_HEADS
    nbytes = 4 * (3 * B * nv * E + 3 * B * nl * E) + mask_v.numel() + mask_l.numel()
    products = 0   # multiply-adds of length D per head
    for lv, ll in zip((~mask_v).sum(-1).tolist(), (~mask_l).sum(-1).tolist()):
        products += (nv * ll + lv * nl - lv * ll) + nv * ll + nl * lv
    ops = 2 * D * FUSION_HEADS * products
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_fusion(g, device):
    from open_groundingdino_tpu_torch.ops import fusion

    args = fusion_inputs(g, device)
    q, k, val_v, val_l, mask_v, mask_l = args
    ov_k, ol_k = fusion.fused_bi_attention(*args, FUSION_HEADS)
    ov_p, ol_p = fusion.fused_bi_attention_plain(*args, FUSION_HEADS)
    err = max(float((ov_k - ov_p).abs().max()), float((ol_k - ol_p).abs().max()))
    ms = event_ms(lambda: fusion.fused_bi_attention(*args, FUSION_HEADS), 10)
    plain_ms = event_ms(lambda: fusion.fused_bi_attention_plain(*args, FUSION_HEADS), 3)
    bound_ms, bound_by = fusion_bound_ms(q, k, mask_v, mask_l)
    log("K2", f"Nv={q.shape[1]} ({int((~mask_v).sum())} live) Nl={k.shape[1]} "
              f"({int((~mask_l).sum())} live) "
              f"E={FUSION_E} H={FUSION_HEADS}: max|kernel-plain|={err:.3e} kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not err <= K2_TOL:
        raise AssertionError(f"K2: max abs error {err} > {K2_TOL}")
    return dict(Nv=q.shape[1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------- serving
VOCAB_WORDS = ("a", "the", "cat", "dog", "person", "bicycle", "car", "traffic", "light",
               "on", "in", "bird", "chair", "table", "sofa", "tree")


def write_vocab(path: str, size: int = 30522) -> None:
    """A bert-base-uncased-shaped vocab: the special tokens at their usual
    ids, punctuation, the caption words, then synthetic words and
    continuation pieces up to `size` entries."""
    toks = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += list(".,?!;:'\"()-") + list(VOCAB_WORDS)
    i = 0
    while len(toks) < size:
        toks.append(f"w{i}" if i % 2 == 0 else f"##p{i}")
        i += 1
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(toks) + "\n")


def write_checkpoint(cfg_path: str, path: str) -> None:
    """Seeded random flagship weights with the reference state-dict keys.
    The deformable-attention offset and weight projections get small random
    kernels (zero at init) so that every sampling point is query-dependent
    and off the pixel lattice, as in a trained model."""
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino, init_weights_

    model = init_weights_(build_groundingdino(SLConfig.fromfile(cfg_path), device="cpu"), SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for lin in (m.sampling_offsets, m.attention_weights):
                    lin.weight.normal_(0.0, 0.01, generator=g)
    torch.save({"model": model.state_dict()}, path)


def synthetic_image(h: int, w: int, seed: int):
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    return Image.fromarray(base).resize((w, h), Image.BILINEAR)   # smooth blobs


def serve(cfg: str, work: str, device: str):
    """load_model + predict on a few requests; returns (model, per-request
    seconds, launch counts of the run, the images, the model's files)."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference
    from open_groundingdino_tpu_torch.ops import fusion, msda

    vocab, ckpt = os.path.join(work, "vocab.txt"), os.path.join(work, "ckpt.pth")
    t0 = time.perf_counter()
    write_vocab(vocab)
    write_checkpoint(cfg, ckpt)
    log("serve", f"wrote vocab + checkpoint ({os.path.getsize(ckpt) / 2**20:.0f} MiB) "
                 f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    im = inference.load_model(cfg, ckpt, vocab, device=device)
    log("serve", f"load_model on {device} in {time.perf_counter() - t0:.1f} s")
    images = [synthetic_image(h, w, i) for i, (h, w) in enumerate(IMAGE_SIZES)]

    msda.ms_deform_attn.launches = 0
    fusion.fused_bi_attention.launches = 0
    inference.predict(im, images[0], CAPTIONS[0])           # warm-up
    torch.cuda.synchronize()
    lat = []
    for i, img in enumerate(images):
        for cap in CAPTIONS:
            t0 = time.perf_counter()
            boxes, scores, phrases = inference.predict(im, img, cap)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            if not (len(boxes) == len(scores) == len(phrases)
                    and np.isfinite(boxes).all() and ((boxes >= 0) & (boxes <= 1)).all()
                    and ((scores > 0.35) & (scores <= 1)).all()):
                raise AssertionError(f"malformed predict output for image {i} {cap!r}")
    n_req = len(images) * len(CAPTIONS) + 1
    counts = {"msda_fwd": msda.ms_deform_attn.launches,
              "fusion_fwd": fusion.fused_bi_attention.launches}
    log("serve", f"{n_req - 1} requests after 1 warm-up: latency ms "
                 f"{[round(t * 1e3, 1) for t in lat]} "
                 f"(median {1e3 * sorted(lat)[len(lat) // 2]:.1f}); "
                 f"launches over {n_req} requests: {counts}")
    # one K1 per encoder and decoder layer, one K2 per encoder fusion layer
    a = im.args
    want = {"msda_fwd": (a.enc_layers + a.dec_layers) * n_req, "fusion_fwd": a.enc_layers * n_req}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return im, lat, counts, images, (cfg, ckpt, vocab)


def check_forward(im_gpu, files, image, caption):
    """pred_logits / pred_boxes of one request on the card against the same
    checkpoint on the CPU, flip-aware (__graft_entry__.py:376-393 bounds)."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference

    def run(im):
        inputs, _ = inference.prepare_inputs(im, image, inference.preprocess_caption(caption))
        with torch.inference_mode():
            out = im.model(**inputs)
        return (out["pred_logits"].float().cpu().numpy(), out["pred_boxes"].float().cpu().numpy(),
                tuple(inputs["images"].shape))

    lg_g, bx_g, shape = run(im_gpu)
    t0 = time.perf_counter()
    lg_c, bx_c, _ = run(inference.load_model(*files, device="cpu"))
    cpu_s = time.perf_counter() - t0
    flip = np.max(np.abs(bx_g - bx_c), axis=-1) > 1e-2
    keep = ~flip
    fin = np.isfinite(lg_c) & keep[..., None]
    same_inf = bool(np.array_equal(np.isfinite(lg_g), np.isfinite(lg_c)))
    lg_err = float(np.max(np.abs(lg_g[fin] - lg_c[fin]))) if fin.any() else 0.0
    bx_err = float(np.max(np.abs(bx_g[keep] - bx_c[keep]))) if keep.any() else 0.0
    log("forward", f"image {shape} pred_logits {lg_g.shape} pred_boxes {bx_g.shape}: "
                   f"flipped {flip.mean():.1%}, bulk max|dlogit| {lg_err:.3e}, "
                   f"bulk max|dbox| {bx_err:.3e} (CPU forward {cpu_s:.1f} s)")
    ok = (same_inf and np.isfinite(bx_g).all() and flip.mean() < 0.10
          and lg_err < 5e-2 and bx_err < 5e-3)
    if not ok:
        raise AssertionError("card forward disagrees with the CPU forward")


def profile_request(im, image, caption, top: int = 8) -> dict:
    """torch.profiler over one warm request: device time by kernel, grouped
    as K1, K2, matrix products and the rest, against the request's wall
    time (profiler on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from open_groundingdino_tpu_torch import inference

    inference.predict(im, image, caption)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference.predict(im, image, caption)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    groups = {"K1 msda_fwd": 0.0, "K2 fusion_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for key, ms, _ in kernels:
        if "msda_fwd_kernel" in key:
            groups["K1 msda_fwd"] += ms
        elif "attend_kernel" in key or "combine_kernel" in key:
            groups["K2 fusion_fwd"] += ms
        elif any(t in key.lower() for t in ("gemm", "xmma", "cutlass", "matmul")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    log("profile", f"one request {wall_ms:.1f} ms wall (profiler on), device busy {busy:.1f} ms "
                   f"({busy / wall_ms:.0%}); by group ms "
                   f"{ {k: round(v, 2) for k, v in groups.items()} }; top kernels "
                   f"{[(k[:48], round(ms, 2), n) for k, ms, n in kernels[:top]]}")
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "groups_ms": groups}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from open_groundingdino_tpu_torch.ops import build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log("device", f"{name}, torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")

    # 2. build
    secs = build.build_all()
    log("build", f"nvcc of {', '.join(build.SOURCES)} in {secs:.1f} s; " + build.ptxas_summary())

    g = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = check_msda(g, "cuda")        # 3
    k2 = check_fusion(g, "cuda")      # 4

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    try:
        cfg = os.path.join(REPO, "open_groundingdino_tpu_torch", "config", "cfg_coco.py")
        im, lat, counts, images, files = serve(cfg, work, "cuda")      # 5
        check_forward(im, files, images[0], CAPTIONS[0])               # 6
        profile_request(im, images[0], CAPTIONS[0])                    # 7
    finally:
        shutil.rmtree(work, ignore_errors=True)

    enc, dec = k1["encoder"], k1["decoder"]
    # K1 runs 6x at each shape per request: its row is the mean launch
    k1_row = {key: (enc[key] + dec[key]) / 2 for key in ("ms", "plain_ms", "bound_ms")}
    kernels = [
        {"name": "msda_fwd", "route": "cuda",
         "source": "open_groundingdino_tpu_torch/csrc/msda_fwd.cu",
         "replaces": "open_groundingdino_tpu/ops/msda_banded.py:311",
         "launches": counts["msda_fwd"],
         "max_abs_err": max(enc["max_abs_err"], dec["max_abs_err"]),
         **k1_row, "bound_by": enc["bound_by"], "library_ms": None,
         "per_shape": k1},
        {"name": "fusion_fwd", "route": "cuda",
         "source": "open_groundingdino_tpu_torch/csrc/fusion_fwd.cu",
         "replaces": "open_groundingdino_tpu/ops/fusion_pallas.py:50",
         "launches": counts["fusion_fwd"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
