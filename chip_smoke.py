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
               fusion shape (Nv = 20197, Nl = 256 with 41 live tokens, E = 1024);
               its library's SASS must hold tensor-core MMA instructions
               (cuobjdump), and ptxas's registers, shared memory and spills
               of each of its kernels are printed
  5. serve   - load_model + predict at full Swin-T / BERT-base width (seeded
               random weights, synthetic 30522-entry WordPiece vocab) on three
               images of different sizes with two captions; counts the kernel
               launches of that run (12 K1 + 6 K2 per request)
  6. forward - one request's pred_logits / pred_boxes on the card against the
               same model on the CPU (plain versions), flip-aware
  7. profile - torch.profiler over one request: device time by kernel group
  8. K3      - the MSDA backward kernel against autograd of K1's plain
               version (grad_value, grad_locs, grad_attn), and K1 against its
               plain version on the same operands, at the encoder and decoder
               shapes of a B = 4 training batch of the 800x1216 bucket whose
               images each have their own valid region, with a seeded
               upstream gradient
  9. K4      - the fusion backward kernel against autograd of K2's plain
               version (gq, gk, gvv, gvl), and K2 against its plain version
               on the same operands, at the encoder fusion shape of that
               B = 4 batch, each image with its own valid region and live
               text count; K2 is also timed there, against its B = 4 bound;
               phase 4's SASS and ptxas report for both fusion libraries
 10. train   - the port's training entry (open_groundingdino_tpu_torch.main) on
               a synthetic 8-image ODVG set at full Swin-T / BERT-base width
               and depth, B = 4, f32, from the seeded checkpoint: 1 warm-up +
               5 timed steps, each loss finite; median step time, peak device
               memory, and the launches of K1-K4 (18 / 12 / 12 / 6 a step
               with checkpointing); then torch.profiler over one more step
 11. train parity - one training step on the card and the same step on the
               CPU (plain versions): B = 1, the 800x1216 bucket, droppath 0;
               loss within 5e-3, each top-level module's gradient norm within
               1e-2 and the gradient of each parameter that K3 or K4 feeds
               within 1e-2, relative; then the card's step with K3's
               grad_locs, and apart K4's gvl, negated must fail that check
 12. sweep   - the sweep MSDA kernels (the JAX package's msda_impl="pallas"
               with MSDA_BANDED=0): K6 (and K7 on the decoder's sorted query
               set), K9 and K10 against their plain versions on the operands
               the model path gives them, at phase 8's encoder and decoder
               shapes; then the sweep op against K1 and K3 on the same inputs
 13. sweep serve - load_model + predict through msda_kernel="sweep" (K6), and
               again with msda_dec_fused=True (K7 in the decoder), on phase
               5's requests; each one forward against phase 6's CPU forward,
               flip-aware; a profiled request
 14. sweep train - main with --options msda_kernel=sweep: 2 B = 4 steps (K6,
               K9) and a profiled one; then 1 step with msda_sweep_bwd=rowtap
               (K10)
 15. sweep train parity - phase 11's step through the sweep against the
               gather's step on the card: loss within 5e-3, each gradient the
               MSDA kernels feed within 1e-2; with K9's gw negated it must fail
 16. K5, K8  - the per-point banded forward K5 and the corner-tap sweep
               forward K8 against their plain versions on the operands their
               paths give them, and each op against K1 on the same inputs, at
               phase 3's B = 1 and phase 8's B = 4 encoder and decoder shapes
 17. banded serve - load_model + predict through msda_kernel="banded_point"
               (K5: 12 a request, no K1) on phase 5's requests; one forward
               against phase 6's CPU forward, flip-aware; a profiled request
 18. banded train - main with --options msda_kernel=banded_point: 2 B = 4
               steps (18 K5 and 12 K3 a step) and a profiled one; then phase
               11's step through K5 against the gather's step on the card:
               loss within 5e-3, each MSDA-fed gradient within 1e-2
 19. microbench - open_groundingdino_tpu_torch.tools.msda_microbench with
               --sweep --fwd_variant corner --banded_mp 0 --bwd --xla: K5 and
               K8 (K3 and K9 under --bwd) at the flagship B = 4 encoder shape
then the {"kernels": [...]} line (K1-K10) and, last,
{"ok": true, "device": {...}}.

Exits nonzero when no CUDA device is present.  Scratch files (checkpoint,
vocab, the ODVG set, the training run's output) go to build/chip_smoke/ and
are removed at the end.
"""
from __future__ import annotations

import json
import math
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
# tensor cores (the MSDA kernels compute in f32 on the SIMT units)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the least time f32-accurate products take on the tensor cores: 3xTF32, three
# TF32 products (495 TFLOP/s dense) for each f32 one; the fusion kernels' rate
TF32X3_FLOP_PER_S = 495e12 / 3
K1_TOL = 1e-4   # f32; only the order of the 64 weighted taps differs
K2_TOL = 1e-4   # f32; online softmax and split partials reorder the sums
# K3 and K4 against autograd of the plain versions, relative to the largest
# |reference| of each gradient: f32 sums of up to ~10^3 terms (K3: atomics in
# an order that changes from run to run, warp-shuffle trees; K4: flash tiles
# and split partials over 20k image tokens) taken in another order than
# cuBLAS and the scatter-add take them: a few 1e-7 relative, 1e-4 leaves room
K3_RTOL = 1e-4
K4_RTOL = 1e-4
# a B = 4 training batch of the 800x1216 bucket: each image's valid (h, w)
# region of the canvas and its caption's live text tokens (phases 8 and 9)
BATCH_VALID = ((800, 1066), (800, 1216), (608, 1216), (704, 939))
BATCH_LIVE_TEXT = (41, 9, 187, 256)
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


def padded_tokens(shapes, valid, device):
    """(B, L) bool, True where a feature-map position lies outside its
    image's valid (h, w) region of the BUCKET canvas (level strides 8, 16,
    32, 64)."""
    import torch

    masks = []
    for lvl, (h, w) in enumerate(shapes):
        s = 8 << lvl
        rows = torch.arange(h, device=device)[None, :, None]
        cols = torch.arange(w, device=device)[None, None, :]
        hv = torch.tensor([-(-vh // s) for vh, _ in valid], device=device)[:, None, None]
        wv = torch.tensor([-(-vw // s) for _, vw in valid], device=device)[:, None, None]
        masks.append(((rows >= hv) | (cols >= wv)).flatten(1))
    return torch.cat(masks, 1)


# ---------------------------------------------------------------- K1 (MSDA)
def msda_inputs(shapes, num_queries, ref_dim: int, g, device, valid=(BUCKET,)):
    """Seeded K1 operands at the model's layout for a batch of B = len(valid)
    images, each with its valid (h, w) region of the BUCKET canvas: value
    zeroed outside the region, as the model's masked value projection is.
    Encoder (ref_dim 2): every token queries around its own centre, scaled
    into its image's region; decoder (ref_dim 4): queries around random boxes
    inside it.  Offsets of a few pixels, as after training."""
    import torch

    B, H, D, NL, P = len(valid), HEADS, HEAD_DIM, LEVELS, POINTS
    L = sum(h * w for h, w in shapes)
    value = torch.randn(B, L, H, D, generator=g, device=device)
    offs = torch.randn(B, num_queries, H, NL, P, 2, generator=g, device=device) * 2.0
    ratio = torch.tensor([[vw / BUCKET[1], vh / BUCKET[0]] for vh, vw in valid],
                         device=device)[:, None, None, None, None, :]      # (x, y)
    if ref_dim == 2:
        centres = []
        for h, w in shapes:
            ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                                    indexing="ij")
            centres.append(torch.stack([(xs.flatten() + 0.5) / w, (ys.flatten() + 0.5) / h], -1))
        ref = torch.cat(centres)[None, :, None, None, None, :] * ratio
        wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=device)
        locs = ref + offs / wh[None, None, None, :, None, :]
    else:
        cxcy = torch.rand(B, num_queries, 1, 1, 1, 2, generator=g, device=device)
        bwh = 0.02 + 0.48 * torch.rand(B, num_queries, 1, 1, 1, 2, generator=g, device=device)
        locs = (cxcy + offs / P * bwh * 0.5) * ratio
    logits = torch.randn(B, num_queries, H, NL * P, generator=g, device=device)
    attn = torch.softmax(logits, -1).view(B, num_queries, H, NL, P)
    value = value.masked_fill(padded_tokens(shapes, valid, device)[:, :, None, None], 0.0)
    return value, locs.contiguous(), attn.contiguous()


def msda_traffic(value, shapes, locs) -> tuple:
    """(distinct in-map corner (position, head) value rows these locations
    touch, in-map corners summed over every sample)."""
    import torch

    B, Q, H, NL, P, _ = locs.shape
    L = value.shape[1]
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
    return int(touched.sum()), corners


def msda_bound_ms(value, shapes, locs, attn) -> tuple:
    """(least ms, "bytes"|"operations"): the value rows these locations touch
    (distinct in-map corner (position, head) rows, each read once), locations
    and weights read once and the output written once, against 2 FLOP per
    channel for every in-map corner plus ~16 FLOP of index math per sample."""
    B, Q, H, NL, P, _ = locs.shape
    D = value.shape[-1]
    rows, corners = msda_traffic(value, shapes, locs)
    nbytes = (rows * D * value.element_size() + locs.numel() * 4
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
def fusion_inputs(g, device, valid=((800, 1066),), live=(LIVE_TEXT,)):
    """Seeded K2 operands at the encoder fusion shape for B = len(valid)
    images of the 800x1216 bucket: the raw (B, N, E) projections, q
    pre-scaled by D^-0.5; image b's valid (h, w) region is valid[b] (the
    positions outside it padded at every level) and its caption has live[b]
    live text tokens.  The default is serving's: one 800x1066 image, 41
    live tokens."""
    import torch

    shapes = level_shapes(*BUCKET)
    nv = sum(h * w for h, w in shapes)
    B, D = len(valid), FUSION_E // FUSION_HEADS
    q = torch.randn(B, nv, FUSION_E, generator=g, device=device) * D ** -0.5
    k = torch.randn(B, TEXT_LEN, FUSION_E, generator=g, device=device)
    val_v = torch.randn(B, nv, FUSION_E, generator=g, device=device)
    val_l = torch.randn(B, TEXT_LEN, FUSION_E, generator=g, device=device)
    mask_v = padded_tokens(shapes, valid, device)
    mask_l = torch.arange(TEXT_LEN, device=device)[None] >= torch.tensor(live, device=device)[:, None]
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / TF32X3_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tensor_core_report(libs, nv: int) -> dict:
    """Each library's SASS (cuobjdump) must hold tensor-core MMA instructions
    (HMMA with TF32 from mma.sync, or HGMMA from wgmma); returns the count
    of each, ptxas's registers, static shared memory and spills of each
    kernel from the build's report, and the dynamic shared memory of the
    main kernel's two passes at Nv = nv image tokens."""
    import ctypes
    import re

    from open_groundingdino_tpu_torch.ops import build, fusion

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report = {}
    for name in libs:
        sass = subprocess.run([tool, "-sass", os.path.join(build.BUILD_DIR, f"lib{name}.so")],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        hmma = sum(1 for line in sass.splitlines() if "HMMA" in line and "TF32" in line)
        hgmma = sass.count("HGMMA")
        if hmma + hgmma == 0:
            raise AssertionError(f"{name}: no tensor-core MMA instruction in its SASS")
        with open(os.path.join(build.BUILD_DIR, f"{name}.log")) as f:
            ptxas = f.read()
        kernels = {}
        for entry, body in re.findall(r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry|\Z)",
                                      ptxas, re.S):
            kname = next((k for k in ("attend_kernel", "combine_kernel", "bwd_kernel",
                                      "sum_splits_kernel") if k in entry), entry)
            regs = re.search(r"Used (\d+) registers", body)
            smem = re.search(r"(\d+) bytes smem", body)
            spill = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", body)]
            kernels[kname] = dict(registers=int(regs.group(1)) if regs else None,
                                  static_smem=int(smem.group(1)) if smem else 0,
                                  spill_bytes=sum(spill))
        smem_fn = getattr(build.load(name), f"{name}_smem_bytes")
        smem_fn.argtypes, smem_fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        n_splits = max(2, min(64, -(-nv // fusion.IMAGE_TOKENS_PER_SPLIT)))
        dynamic = {"image_rows": smem_fn(TEXT_LEN, 1), "text_rows": smem_fn(nv, n_splits)}
        report[name] = dict(hmma_tf32=hmma, hgmma=hgmma, ptxas=kernels, dynamic_smem=dynamic)
        log("sass", f"lib{name}.so: {hmma} HMMA.TF32, {hgmma} HGMMA; ptxas {kernels}; "
                    f"dynamic shared memory {dynamic} bytes")
    return report


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
    sass = tensor_core_report(("fusion_fwd",), q.shape[1])
    return dict(Nv=q.shape[1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, sass=sass)


# ---------------------------------------------------------------- K3 (MSDA backward)
def msda_bwd_bound_ms(value, shapes, locs, attn) -> tuple:
    """(least ms, "bytes"|"operations"): the touched value rows, locations,
    weights and upstream gradient read once; grad_value (whole), grad_locs
    and grad_attn written once; against 8 FLOP per channel for every in-map
    corner (the value product, the scatter and the two location derivatives)
    plus ~16 FLOP of index math per sample."""
    B, Q, H, NL, P, _ = locs.shape
    D = value.shape[-1]
    rows, corners = msda_traffic(value, shapes, locs)
    nbytes = 4 * (rows * D + 2 * locs.numel() + 2 * attn.numel() + B * Q * H * D
                  + value.numel())
    ops = 8 * D * corners + 16 * B * Q * H * NL * P
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_msda_bwd(device):
    """K3 against autograd of the plain version, and K1 against the plain
    version on the same operands, at the encoder and decoder shapes of a
    B = 4 training batch (BATCH_VALID: each image its own valid region) with
    a seeded upstream gradient."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    B = len(BATCH_VALID)
    rows = {}
    for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
        value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, BATCH_VALID)
        fwd_err = float((msda.ms_deform_attn(value, shapes, starts, locs, attn)
                         - msda.ms_deform_attn_plain(value, shapes, starts, locs, attn)).abs().max())
        if not fwd_err <= K1_TOL:
            raise AssertionError(f"K1 {name} at B={B}: max abs error {fwd_err} > {K1_TOL}")
        grad_out = torch.randn(B, q, HEADS * HEAD_DIM, generator=g, device=device)
        args = (value, shapes, starts, locs, attn, grad_out)
        got = msda.ms_deform_attn_bwd(*args)
        ref = msda.ms_deform_attn_bwd_plain(*args)
        errs = {}
        for key, a, b in zip(("grad_value", "grad_locs", "grad_attn"), got, ref):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            errs[key] = err
            if not err <= K3_RTOL * scale:
                raise AssertionError(f"K3 {name} {key}: max abs error {err} > "
                                     f"{K3_RTOL} x max|ref| {scale}")
        ms = event_ms(lambda: msda.ms_deform_attn_bwd(*args), 20)
        plain_ms = event_ms(lambda: msda.ms_deform_attn_bwd_plain(*args), 3)
        bound_ms, bound_by = msda_bwd_bound_ms(value, shapes, locs, attn)
        rows[name] = dict(B=B, Q=q, L=L, max_abs_err=max(errs.values()), errs=errs,
                          k1_max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        log("K3", f"{name}: B={B} (valid {BATCH_VALID}) Q={q} max|kernel-plain| "
                  f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance {K3_RTOL} x "
                  f"max|ref|), K1 on the same operands {fwd_err:.3e} (tolerance {K1_TOL}); "
                  f"kernel {ms:.4f} ms, plain (autograd: forward + backward) "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return rows


# ---------------------------------------------------------------- K4 (fusion backward)
def fusion_bwd_bound_ms(q, k, mask_v, mask_l) -> tuple:
    """The forward operands, K2's outputs and statistics and both upstream
    gradients read once, the four gradients written once; against the
    products this data needs: over the (image, text) pairs that some softmax
    reaches (U = every image token with the live text, every text token with
    the live image), the logits and gq and gk; G1 and gvl where the row
    softmax is live; G2 and gvv where the column softmax is live; at the
    3xTF32 rate."""
    B, nv, E = q.shape
    nl = k.shape[1]
    H = FUSION_HEADS
    D = E // H
    nbytes = 4 * (8 * B * nv * E + 8 * B * nl * E + B * H * (nv + nl)) \
        + mask_v.numel() + mask_l.numel()
    products = 0
    for lv, ll in zip((~mask_v).sum(-1).tolist(), (~mask_l).sum(-1).tolist()):
        union = nv * ll + lv * nl - lv * ll
        products += 3 * union + 2 * nv * ll + 2 * lv * nl
    ops = 2 * D * H * products
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / TF32X3_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_fusion_bwd(device):
    """K4 against autograd of the plain version, and K2 against the plain
    version on the same operands, at the encoder fusion shape of a B = 4
    training batch (BATCH_VALID, BATCH_LIVE_TEXT: each image its own valid
    region and live text count) with seeded upstream gradients."""
    import torch

    from open_groundingdino_tpu_torch.ops import fusion

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    args = fusion_inputs(g, device, BATCH_VALID, BATCH_LIVE_TEXT)
    q, k, val_v, val_l, mask_v, mask_l = args
    g_ov = torch.randn(q.shape, generator=g, device=device)
    g_ol = torch.randn(k.shape, generator=g, device=device)
    out_v, out_l, lse_v, lse_l = fusion._fusion_fwd_cuda(*args, FUSION_HEADS)
    ov_p, ol_p = fusion.fused_bi_attention_plain(*args, FUSION_HEADS)
    fwd_err = max(float((out_v - ov_p).abs().max()), float((out_l - ol_p).abs().max()))
    del ov_p, ol_p
    if not fwd_err <= K2_TOL:
        raise AssertionError(f"K2 at B={q.shape[0]}: max abs error {fwd_err} > {K2_TOL}")
    # K2 at the B = 4 shape, where the training step's launches run
    k2_ms = event_ms(lambda: fusion._fusion_fwd_cuda(*args, FUSION_HEADS), 5)
    k2_plain_ms = event_ms(lambda: fusion.fused_bi_attention_plain(*args, FUSION_HEADS), 3)
    k2_bound_ms, k2_bound_by = fusion_bound_ms(q, k, mask_v, mask_l)
    log("K2", f"B={q.shape[0]} (valid {BATCH_VALID}, live text {BATCH_LIVE_TEXT}): "
              f"max|kernel-plain|={fwd_err:.3e} kernel {k2_ms:.3f} ms, plain "
              f"{k2_plain_ms:.3f} ms, bound {k2_bound_ms:.4f} ms ({k2_bound_by})")
    bwd_args = (*args, out_v, out_l, lse_v, lse_l, g_ov, g_ol, FUSION_HEADS)
    got = fusion.fused_bi_attention_bwd(*bwd_args)
    ref = fusion.fused_bi_attention_bwd_plain(*args, g_ov, g_ol, FUSION_HEADS)
    errs = {}
    for key, a, b in zip(("gq", "gk", "gvv", "gvl"), got, ref):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        errs[key] = err
        if not err <= K4_RTOL * scale:
            raise AssertionError(f"K4 {key}: max abs error {err} > {K4_RTOL} x max|ref| {scale}")
    ms = event_ms(lambda: fusion.fused_bi_attention_bwd(*bwd_args), 5)
    plain_ms = event_ms(
        lambda: fusion.fused_bi_attention_bwd_plain(*args, g_ov, g_ol, FUSION_HEADS), 3)
    bound_ms, bound_by = fusion_bwd_bound_ms(q, k, mask_v, mask_l)
    log("K4", f"B={q.shape[0]} (valid {BATCH_VALID}, live text {BATCH_LIVE_TEXT}) "
              f"Nv={q.shape[1]} Nl={k.shape[1]} E={FUSION_E} H={FUSION_HEADS}: max|kernel-plain| "
              f"{ {k_: f'{v:.3e}' for k_, v in errs.items()} } (tolerance {K4_RTOL} x max|ref|), "
              f"K2 on the same operands {fwd_err:.3e} (tolerance {K2_TOL}); "
              f"kernel {ms:.3f} ms, plain (autograd: forward + backward) {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    sass = tensor_core_report(("fusion_fwd", "fusion_bwd"), q.shape[1])
    k2 = dict(B=q.shape[0], max_abs_err=fwd_err, ms=k2_ms, plain_ms=k2_plain_ms,
              bound_ms=k2_bound_ms, bound_by=k2_bound_by)
    return dict(B=q.shape[0], Nv=q.shape[1], max_abs_err=max(errs.values()), errs=errs,
                k2_max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, k2=k2, sass=sass)


# ---------------------------------------------------------------- K6, K7, K9, K10 (sweep)
# the sweep kernels against their plain versions: forward abs (f32, only the
# order of each output's sums differs); backward relative to each gradient's
# largest |reference| (grad_value by atomics in an order that changes from
# run to run), tap gradients where the tap is live (w != 0: a dead tap's
# gradient depends on the sweep's ranges and the chain rule multiplies it by
# zero)
SWEEP_TOL = 1e-4
SWEEP_RTOL = 1e-4


def sweep_operands(value, shapes, locs, attn, grad_out):
    """The operands MSDASweepFunction hands the kernels on the model path:
    row taps (row, px, w) and corner taps (idx, wc), in the kernels' query
    order (sorted for Q != L) and padded to the query block, and the
    upstream gradient likewise."""
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    B, L, H, D = value.shape
    Q = locs.shape[1]
    locs_t, attn_t = sw.kernel_layout(locs, attn)
    row, px, w = sw.rowtap_positions_and_weights(locs_t, attn_t, shapes)
    idx, wc = sw.corner_indices_and_weights(locs_t, attn_t, shapes)
    order = sw.query_order(row, px, L)
    g_k = grad_out.view(B, Q, H, D).permute(0, 2, 1, 3).reshape(B * H, Q, D)
    return {"row": sw.sort_and_pad(row, order), "px": sw.sort_and_pad(px, order),
            "w": sw.sort_and_pad(w, order),
            "idx": sw.sort_and_pad(idx, order), "wc": sw.sort_and_pad(wc, order),
            "g": sw.sort_and_pad(g_k, order, 1)}


def rel_errs(got, ref, masks=None) -> dict:
    """max |got - ref| / max |ref| for each named pair, over mask[name]
    where one is given."""
    out = {}
    for key in ref:
        a, b = got[key], ref[key]
        if masks and key in masks:
            a, b = a[masks[key]], b[masks[key]]
        out[key] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return out


def check_sweep(device) -> dict:
    """K6 (and K7 on the decoder's sorted query set), K9 and K10 against their
    plain versions at the encoder and decoder shapes of phase 8's B = 4
    batch; then the sweep op as the model calls it against K1 and K3 on the
    same inputs."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    B = len(BATCH_VALID)
    rows = {}
    for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
        value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, BATCH_VALID)
        grad_out = torch.randn(B, q, HEADS * HEAD_DIM, generator=g, device=device)
        ops = sweep_operands(value, shapes, locs, attn, grad_out)
        row, px, w, idx, wc, g_k = (ops[k] for k in ("row", "px", "w", "idx", "wc", "g"))
        fwd_bound = msda_bound_ms(value, shapes, locs, attn)
        bwd_bound = msda_bwd_bound_ms(value, shapes, locs, attn)
        out_p = sw.sweep_fwd_plain(value, row, px, w)
        fwd_plain_ms = event_ms(lambda: sw.sweep_fwd_plain(value, row, px, w), 3)
        fwds = [("K6", sw.sweep_fwd)] + ([("K7", sw.sweep_fwd_allq)] if q != L else [])
        for kname, fn in fwds:
            err = float((fn(value, shapes, row, px, w) - out_p).abs().max())
            ms = event_ms(lambda: fn(value, shapes, row, px, w), 10)
            rows[kname, name] = dict(Q=q, max_abs_err=err, ms=ms, plain_ms=fwd_plain_ms,
                                     bound_ms=fwd_bound[0], bound_by=fwd_bound[1])
            log(kname, f"{name}: B={B} Q={q} L={L}: max|kernel-plain| {err:.3e} (tolerance "
                       f"{SWEEP_TOL}); kernel {ms:.4f} ms, plain {fwd_plain_ms:.3f} ms, bound "
                       f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]})")
            if not err <= SWEEP_TOL:
                raise AssertionError(f"{kname} {name}: max abs error {err} > {SWEEP_TOL}")
        del out_p
        live_c, live_r = wc != 0, w != 0
        for kname, fn, plain, args, keys, masks in (
                ("K9", sw.sweep_bwd_corner, sw.sweep_bwd_corner_plain, (idx, wc),
                 ("grad_value", "gw"), {"gw": live_c}),
                ("K10", sw.sweep_bwd_rowtap, sw.sweep_bwd_rowtap_plain, (row, px, w),
                 ("grad_value", "gpx", "gw"), {"gpx": live_r, "gw": live_r})):
            got = dict(zip(keys, fn(value, shapes, *args, g_k)))
            ref = dict(zip(keys, plain(value, *args, g_k)))
            errs = rel_errs(got, ref, masks)
            del got, ref
            ms = event_ms(lambda: fn(value, shapes, *args, g_k), 5)
            plain_ms = event_ms(lambda: plain(value, *args, g_k), 2)
            rows[kname, name] = dict(Q=q, max_abs_err=max(errs.values()), errs=errs, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bwd_bound[0],
                                     bound_by=bwd_bound[1])
            log(kname, f"{name}: B={B} Q={q}: max|kernel-plain| / max|plain| "
                       f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance {SWEEP_RTOL}, "
                       f"tap gradients where w != 0); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                       f"bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
            if not max(errs.values()) <= SWEEP_RTOL:
                raise AssertionError(f"{kname} {name}: {errs} > {SWEEP_RTOL}")
        rows["vs K1/K3", name] = sweep_vs_gather(value, shapes, starts, locs, attn, grad_out)
    return rows


def lattice_samples(locs, shapes):
    """(B, Q, H, NL, P) bool: sampling points with a coordinate exactly on
    the pixel lattice (zero fraction of x * W - 0.5 or y * H - 0.5, rounded
    as the expansions round it)."""
    import torch

    on = []
    for lvl, (h, w) in enumerate(shapes):
        x = locs[:, :, :, lvl, :, 0] * w - 0.5
        y = locs[:, :, :, lvl, :, 1] * h - 0.5
        on.append((x == torch.floor(x)) | (y == torch.floor(y)))
    return torch.stack(on, 3)


def sweep_vs_gather(value, shapes, starts, locs, attn, grad_out) -> dict:
    """The sweep op as the model calls it (MSDASweepFunction: K6, or K7 for a
    sorted query set under dec_fused; K9 or K10 backward) against K1 and K3
    on the same inputs.  The two compute one function: the forward within
    SWEEP_TOL, each gradient within SWEEP_RTOL of its largest |reference|
    (f32 sums in another order; grad_value by atomics on both sides).
    Location gradients are compared off the pixel lattice: at B = 4 some
    tens of the 10M f32 sampling points have a coordinate with zero
    fraction, where K3 takes the one-sided derivative through floor and the
    sweep, as its TPU kernels do, another one (row taps: sign(0) = 0; a tap
    whose bilinear weight is zero there is swept only with a live tap's
    tile).  The count is reported."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    keys = ("grad_value", "grad_locs", "grad_attn")
    ref_out = msda.ms_deform_attn(value, shapes, starts, locs, attn)
    ref = dict(zip(keys, msda.ms_deform_attn_bwd(value, shapes, starts, locs, attn, grad_out)))
    lattice = lattice_samples(locs, shapes)
    off = {"grad_locs": ~lattice[..., None].expand_as(locs)}
    res = {}
    for bwd, dec_fused in (("corner", False), ("rowtap", True)):
        leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, attn)]
        out = sw.ms_deform_attn_sweep(leaves[0], shapes, starts, leaves[1], leaves[2], bwd=bwd,
                                      dec_fused=dec_fused)
        fwd_err = float((out.detach() - ref_out).abs().max())
        errs = rel_errs(dict(zip(keys, torch.autograd.grad(out, leaves, grad_out))), ref, off)
        res[bwd] = dict(fwd_max_abs_err=fwd_err, grad_errs=errs, lattice=int(lattice.sum()))
        k7 = " + K7" if dec_fused and locs.shape[1] != value.shape[1] else ""
        log("sweep", f"Q={locs.shape[1]} {bwd} backward{k7}: forward vs K1 {fwd_err:.3e} "
                     f"(tolerance {SWEEP_TOL}); gradients vs K3, max|d| / max|K3| "
                     f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tolerance {SWEEP_RTOL}; "
                     f"locations off the lattice: {int(lattice.sum())} of {lattice.numel()} "
                     f"samples on it)")
        if not (fwd_err <= SWEEP_TOL and max(errs.values()) <= SWEEP_RTOL):
            raise AssertionError(f"the sweep ({bwd}) disagrees with K1/K3: {res[bwd]}")
    return res


# ---------------------------------------------------------------- K5, K8
# K5 and K8 against their plain versions and against K1: forwards on exact
# corner or row weights, so only the order of each output's f32 sums differs
K5_K8_TOL = 1e-4


def check_banded_corner(device) -> dict:
    """K5 (per-point banded forward) and K8 (corner-tap sweep forward)
    against their plain versions on the operands their paths give them (K5:
    banded_operands, the decoder's queries sorted; K8: corner taps sorted by
    the first for Q != L), and the ops that launch them against K1 on the
    same inputs, at phase 3's B = 1 and phase 8's B = 4 (BATCH_VALID)
    encoder and decoder shapes."""
    import torch

    from open_groundingdino_tpu_torch.ops import msda
    from open_groundingdino_tpu_torch.ops import msda_banded as mb
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    shapes = level_shapes(*BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    g = torch.Generator(device=device).manual_seed(SEED + 16)
    rows = {}
    for batch, valid in (("B=1", (BUCKET,)), ("B=4", BATCH_VALID)):
        for name, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = msda_inputs(shapes, q, ref_dim, g, device, valid)
            k1 = msda.ms_deform_attn(value, shapes, starts, locs, attn)
            bound = msda_bound_ms(value, shapes, locs, attn)
            _, locs_t, px, py, wa = mb.banded_operands(locs, attn, shapes, L)
            ranges = mb.band_ranges(locs_t, shapes, px.shape[-1] // sw.QBLOCK,
                                    mb.level_bands(shapes, mb.BAND))
            idx, w = sw.corner_indices_and_weights(*sw.kernel_layout(locs, attn), shapes)
            order = sw.query_order(idx, None, L)
            idx, w = sw.sort_and_pad(idx, order), sw.sort_and_pad(w, order)
            for kname, kernel, plain, op in (
                    ("K5", lambda: mb.banded_fwd(value, shapes, px, py, wa),
                     lambda: mb.banded_fwd_plain(value, shapes, px, py, wa, ranges),
                     lambda: mb.ms_deform_attn_banded(value, shapes, starts, locs, attn)),
                    ("K8", lambda: sw.sweep_fwd_corner(value, shapes, idx, w),
                     lambda: sw.sweep_fwd_corner_plain(value, idx, w),
                     lambda: sw.ms_deform_attn_sweep(value, shapes, starts, locs, attn,
                                                     fwd="corner"))):
                err = float((kernel() - plain()).abs().max())
                op_err = float((op() - k1).abs().max())
                ms = event_ms(kernel, 10)
                plain_ms = event_ms(plain, 2)
                rows[kname, batch, name] = dict(Q=q, max_abs_err=err, k1_max_abs_err=op_err,
                                                ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                                                bound_by=bound[1])
                log(kname, f"{name}: {batch} Q={q} L={L}: max|kernel-plain| {err:.3e}, the op "
                           f"against K1 {op_err:.3e} (tolerance {K5_K8_TOL}); kernel {ms:.4f} ms, "
                           f"plain {plain_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
                if not (err <= K5_K8_TOL and op_err <= K5_K8_TOL):
                    raise AssertionError(f"{kname} {batch} {name}: {rows[kname, batch, name]}")
    return rows


def check_banded_train_parity(harness, gather_card) -> dict:
    """One training step through banded_point (K5 forward, K3 backward)
    against the gather's step on the card (phase 11's) from the same weights
    and batch: loss within PARITY_LOSS_RTOL, module gradient norms within
    PARITY_GRAD_RTOL, each parameter that the MSDA kernels feed within
    PARITY_LEAF_RTOL."""
    step, gaps, within = harness
    run = step("cuda", msda={"kernel": "banded_point"})
    gap = gaps(run, gather_card, MSDA_FED)
    loss_rel, norm_rel, leaf_rel = gap
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("banded-train-parity", f"banded_point step vs gather step on the card: loss "
                               f"{run['loss']:.6f} vs {gather_card['loss']:.6f} (rel "
                               f"{loss_rel:.2e}, limit {PARITY_LOSS_RTOL}); grad-norm rel by "
                               f"module { {k: f'{v:.2e}' for k, v in norm_rel.items()} }; "
                               f"{len(leaf_rel)} MSDA-fed leaves ||dg||/||g|| max "
                               f"{max(leaf_rel.values()):.2e} (limit {PARITY_LEAF_RTOL}), worst "
                               f"{[(n, f'{v:.2e}') for n, v in worst]}; step s {run['seconds']:.1f}")
    if not (math.isfinite(run["loss"]) and within(gap)):
        raise AssertionError("the banded_point training step disagrees with the gather's")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, leaf_rel_max=max(leaf_rel.values()))


def run_microbench() -> tuple:
    """The port's MSDA microbench in this process, K5 and K8 paths with
    their backwards and the plain op, a few iterations; returns (its
    results, the kernels' launches in the run)."""
    from open_groundingdino_tpu_torch.tools import msda_microbench

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    argv = ["--sweep", "--fwd_variant", "corner", "--banded_mp", "0", "--bwd", "--xla",
            "--iters", "3", "--repeats", "2"]
    res = msda_microbench.main(argv)
    counts = {k: fn.launches for k, fn in counters.items()}
    log("microbench", f"msda_microbench {' '.join(argv)}: ms a layer "
                      f"{ {k: round(v, 3) for k, v in res.items() if k != 'max_abs_diff'} }, "
                      f"max|banded - plain| {res['max_abs_diff']:.2e}; launches "
                      f"{ {k: v for k, v in counts.items() if v} }")
    if not all(counts[k] > 0 for k in ("banded_fwd", "sweep_fwd_corner", "sweep_bwd_corner",
                                       "msda_bwd")) or not res["max_abs_diff"] <= K5_K8_TOL:
        raise AssertionError(f"the microbench missed a kernel or disagrees: {counts} {res}")
    return res, counts


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


def write_checkpoint(cfg_path: str, path: str, random_biases: bool = False) -> None:
    """Seeded random flagship weights with the reference state-dict keys.
    The deformable-attention offset and weight projections get small random
    kernels (zero at init) so that every sampling point is query-dependent
    and off the pixel lattice, as in a trained model.  With `random_biases`
    every Linear/Conv bias is drawn from N(0, 0.02) too, as a trained
    network's are non-zero: with zero biases the zero-padded image region
    gives constant tokens, whose LayerNorm gradients grow by 1/sqrt(eps) at
    every Swin layer, and the first training step at B = 4 overflows f32 in
    the JAX package and the port alike (ROADMAP section 3,
    tests/test_torch_padding_init.py)."""
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
        if random_biases:
            for m in model.modules():
                if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)) and m.bias is not None:
                    m.bias.normal_(0.0, 0.02, generator=g)
    torch.save({"model": model.state_dict()}, path)


def synthetic_image(h: int, w: int, seed: int):
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    return Image.fromarray(base).resize((w, h), Image.BILINEAR)   # smooth blobs


def write_serving_files(cfg: str, work: str):
    """The smoke's vocab and seeded checkpoint; returns (cfg, ckpt, vocab)."""
    vocab, ckpt = os.path.join(work, "vocab.txt"), os.path.join(work, "ckpt.pth")
    t0 = time.perf_counter()
    write_vocab(vocab)
    write_checkpoint(cfg, ckpt)
    log("serve", f"wrote vocab + checkpoint ({os.path.getsize(ckpt) / 2**20:.0f} MiB) "
                 f"in {time.perf_counter() - t0:.1f} s")
    return cfg, ckpt, vocab


def msda_config(cfg: str, work: str, name: str, **keys) -> str:
    """A config file that takes `cfg` and sets the given MSDA keys."""
    path = os.path.join(work, f"cfg_{name}.py")
    with open(path, "w") as f:
        f.write(f"_base_ = {cfg!r}\n" + "".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return path


def serving_launches(args, n_req: int) -> dict:
    """The kernel launches of n_req forwards: one MSDA forward per encoder and
    decoder layer (K1, or the sweep: K6, with K7 for the decoder under
    msda_dec_fused), one K2 per encoder fusion layer, no backward."""
    want = dict.fromkeys(kernel_counters(), 0)
    enc, dec = args.enc_layers * n_req, args.dec_layers * n_req
    want["fusion_fwd"] = enc
    if str(args.msda_kernel) == "banded_point":
        want["banded_fwd"] = enc + dec
    elif str(args.msda_kernel) == "sweep":
        fused = bool(args.msda_dec_fused)
        want["sweep_fwd"] = enc + (0 if fused else dec)
        want["sweep_fwd_allq"] = dec if fused else 0
    else:
        want["msda_fwd"] = enc + dec
    return want


def serve(files, device: str, tag: str = "serve"):
    """load_model + predict on a few requests; returns (model, per-request
    seconds, launch counts of the run, the images)."""
    import numpy as np
    import torch

    from open_groundingdino_tpu_torch import inference

    cfg, ckpt, vocab = files
    t0 = time.perf_counter()
    im = inference.load_model(cfg, ckpt, vocab, device=device)
    log(tag, f"load_model on {device} in {time.perf_counter() - t0:.1f} s")
    images = [synthetic_image(h, w, i) for i, (h, w) in enumerate(IMAGE_SIZES)]

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
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
    counts = {k: fn.launches for k, fn in counters.items()}
    log(tag, f"{n_req - 1} requests after 1 warm-up: latency ms "
             f"{[round(t * 1e3, 1) for t in lat]} "
             f"(median {1e3 * sorted(lat)[len(lat) // 2]:.1f}); "
             f"launches over {n_req} requests: { {k: v for k, v in counts.items() if v} }")
    want = serving_launches(im.args, n_req)
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return im, lat, counts, images


def forward_outputs(im, image, caption):
    """(pred_logits, pred_boxes, image shape) of one request, on the host."""
    import torch

    from open_groundingdino_tpu_torch import inference

    inputs, _ = inference.prepare_inputs(im, image, inference.preprocess_caption(caption))
    with torch.inference_mode():
        out = im.model(**inputs)
    return (out["pred_logits"].float().cpu().numpy(), out["pred_boxes"].float().cpu().numpy(),
            tuple(inputs["images"].shape))


def check_forward(im_gpu, files, image, caption, tag="forward"):
    """pred_logits / pred_boxes of one request on the card against the same
    checkpoint on the CPU, flip-aware (__graft_entry__.py:376-393 bounds);
    returns the CPU's outputs."""
    from open_groundingdino_tpu_torch import inference

    t0 = time.perf_counter()
    cpu = forward_outputs(inference.load_model(*files, device="cpu"), image, caption)
    compare_forward(forward_outputs(im_gpu, image, caption), cpu, tag,
                    f"CPU forward {time.perf_counter() - t0:.1f} s")
    return cpu


def compare_forward(card, cpu, tag, note=""):
    """The card's (logits, boxes) against the CPU's: fewer than 10% of the
    queries flipped, and on the rest |dlogit| < 5e-2, |dbox| < 5e-3."""
    import numpy as np

    lg_g, bx_g, shape = card
    lg_c, bx_c, _ = cpu
    flip = np.max(np.abs(bx_g - bx_c), axis=-1) > 1e-2
    keep = ~flip
    fin = np.isfinite(lg_c) & keep[..., None]
    same_inf = bool(np.array_equal(np.isfinite(lg_g), np.isfinite(lg_c)))
    lg_err = float(np.max(np.abs(lg_g[fin] - lg_c[fin]))) if fin.any() else 0.0
    bx_err = float(np.max(np.abs(bx_g[keep] - bx_c[keep]))) if keep.any() else 0.0
    log(tag, f"image {shape} pred_logits {lg_g.shape} pred_boxes {bx_g.shape}: "
             f"flipped {flip.mean():.1%}, bulk max|dlogit| {lg_err:.3e}, "
             f"bulk max|dbox| {bx_err:.3e}" + (f" ({note})" if note else ""))
    ok = (same_inf and np.isfinite(bx_g).all() and flip.mean() < 0.10
          and lg_err < 5e-2 and bx_err < 5e-3)
    if not ok:
        raise AssertionError(f"{tag}: the card's forward disagrees with the CPU forward")


# ---------------------------------------------------------------- training
CATEGORIES = ("cat", "dog", "person", "bicycle", "car", "traffic light", "bird", "chair",
              "table", "sofa")
TRAIN_IMAGE_SIZES = ((480, 640), (720, 1280), (600, 800), (1024, 768), (500, 700),
                     (640, 480), (800, 1200), (900, 1350))   # (h, w)
TRAIN_STEPS = 6            # 1 warm-up + 5 timed
TRAIN_EPOCHS = 3           # 8 images, B = 4: 2 steps an epoch
# K1 per step: 6 encoder + 6 decoder forward + 6 encoder replays under
# checkpointing; K2: 6 forward + 6 replays; K3: one per MSDA layer; K4: one
# per fusion layer
TRAIN_LAUNCHES_PER_STEP = {"msda_fwd": 18, "fusion_fwd": 12, "msda_bwd": 12, "fusion_bwd": 6}
PARITY_LOSS_RTOL = 5e-3    # the JAX package's kernel-vs-reference train-step bound
PARITY_GRAD_RTOL = 1e-2    # per top-level module gradient norm
# ||g_card - g_cpu|| / ||g_cpu|| of each parameter that K3 or K4 computes the
# gradient of (the deformable attention's offset, weight and value
# projections, the fusion's four input projections).  The derivative of a
# bilinear sample in its position jumps where the position crosses a pixel
# centre, and the card's and the CPU's products round the positions apart:
# the encoder's sampling-offset leaves differ by up to 3.75e-3 (H100 run);
# a negated kernel output gives ~2
PARITY_LEAF_RTOL = 1e-2
KERNEL_FED = (".sampling_offsets.", ".attention_weights.", ".value_proj.", ".attn.v_proj.",
              ".attn.l_proj.", ".attn.values_v_proj.", ".attn.values_l_proj.")
MSDA_FED = KERNEL_FED[:3]   # the deformable attentions' projections


def write_odvg(work: str) -> str:
    """A seeded synthetic ODVG set (OD mode): 8 images of mixed sizes with
    1-5 boxes each, a 10-category label map, and the datasets.json
    manifest; returns the manifest's path."""
    import numpy as np

    root = os.path.join(work, "odvg")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(SEED + 10)
    lines = []
    for i, (h, w) in enumerate(TRAIN_IMAGE_SIZES):
        name = f"img{i}.jpg"
        synthetic_image(h, w, 100 + i).save(os.path.join(root, name), quality=90)
        instances = []
        for _ in range(rng.randint(1, 6)):
            bw, bh = rng.uniform(0.1, 0.6) * w, rng.uniform(0.1, 0.6) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            instances.append({"bbox": [float(x0), float(y0), float(x0 + bw), float(y0 + bh)],
                              "label": int(rng.randint(len(CATEGORIES)))})
        lines.append(json.dumps({"filename": name, "height": h, "width": w,
                                 "detection": {"instances": instances}}))
    with open(os.path.join(root, "train.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "label_map.json"), "w") as f:
        json.dump({str(i): c for i, c in enumerate(CATEGORIES)}, f)
    manifest = os.path.join(work, "datasets.json")
    with open(manifest, "w") as f:
        json.dump({"train": [{"root": root, "anno": os.path.join(root, "train.jsonl"),
                              "label_map": os.path.join(root, "label_map.json"),
                              "dataset_mode": "odvg"}]}, f)
    return manifest


def kernel_counters():
    from open_groundingdino_tpu_torch.ops import fusion, msda
    from open_groundingdino_tpu_torch.ops import msda_banded as mb
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    return {"msda_fwd": msda.ms_deform_attn, "fusion_fwd": fusion.fused_bi_attention,
            "msda_bwd": msda.ms_deform_attn_bwd, "fusion_bwd": fusion.fused_bi_attention_bwd,
            "banded_fwd": mb.banded_fwd,
            "sweep_fwd": sw.sweep_fwd, "sweep_fwd_allq": sw.sweep_fwd_allq,
            "sweep_fwd_corner": sw.sweep_fwd_corner,
            "sweep_bwd_corner": sw.sweep_bwd_corner, "sweep_bwd_rowtap": sw.sweep_bwd_rowtap}


def train_launches_per_step(msda_keys: dict) -> dict:
    """TRAIN_LAUNCHES_PER_STEP with the MSDA kernels the config selects: the
    sweep runs K6 where the gather runs K1 (the decoder's B = 4 query sets
    too: msda_dec_fused is off), and K9 or K10 where it runs K3; banded_point
    runs K5 where the gather runs K1, and K3."""
    want = dict.fromkeys(kernel_counters(), 0) | TRAIN_LAUNCHES_PER_STEP
    if msda_keys.get("msda_kernel") == "banded_point":
        want["banded_fwd"], want["msda_fwd"] = want["msda_fwd"], 0
    elif msda_keys.get("msda_kernel") == "sweep":
        want["sweep_fwd"] = want.pop("msda_fwd")
        bwd = "sweep_bwd_" + msda_keys.get("msda_sweep_bwd", "corner")
        want[bwd] = want.pop("msda_bwd")
        want["msda_fwd"] = want["msda_bwd"] = 0
    return want


def train(cfg: str, work: str, files, device: str, msda_keys=None, epochs: int = TRAIN_EPOCHS,
          max_steps: int = None, tag: str = "train") -> dict:
    """The port's training entry (main.main) on the synthetic ODVG set at
    the config's full width and depth: B = 4, f32, two steps an epoch (at
    most max_steps) from the smoke's seeded checkpoint (random biases), with
    the MSDA config keys `msda_keys` given as --options; counts the kernels'
    launches of the run."""
    import torch

    from open_groundingdino_tpu_torch import main as train_main

    manifest = write_odvg(work)
    _, ckpt, vocab = files
    msda_keys = msda_keys or {}
    out_dir = os.path.join(work, f"{tag}_out")
    steps = 2 * epochs if max_steps is None else min(2 * epochs, max_steps)
    cli = train_main.get_args_parser().parse_args([
        "-c", cfg, "--datasets", manifest, "--output_dir", out_dir,
        "--vocab", vocab, "--pretrain_model_path", ckpt, "--device", device,
        "--seed", str(SEED), "--num_workers", "2", "--print_freq", "1",
        *(["--max_steps", str(max_steps)] if max_steps else []),
        "--options", f"epochs={epochs}", "batch_size=4", "compute_dtype=float32",
        *(f"{k}={v}" for k, v in msda_keys.items()),
    ])
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_main.main(cli)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    records = run["records"]
    losses = [r["loss"] for r in records]
    step_s = [r["step_seconds"] for r in records]
    timed = sorted(step_s[1:]) or step_s   # the first step warms up
    median_s = timed[len(timed) // 2]
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "log.txt")) as f:
        epochs_logged = len(f.read().splitlines())
    log(tag, f"{len(records)} steps (B=4, f32, TF32 off{', ' if msda_keys else ''}"
             f"{', '.join(f'{k}={v}' for k, v in msda_keys.items())}) in {wall:.1f} s with set-up: "
                 f"losses {[round(x, 4) for x in losses]}; step s "
                 f"{[round(x, 3) for x in step_s]} (median of the {len(timed)} timed: "
                 f"{median_s:.3f} s); max_memory_allocated {peak / 2**30:.2f} GiB; "
                 f"log.txt lines {epochs_logged}; launches { {k: v for k, v in counts.items() if v} } "
                 f"(per step { {k: v / max(len(records), 1) for k, v in counts.items() if v} })")
    if len(records) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"expected {steps} finite losses, got {losses}")
    if epochs_logged != epochs:
        raise AssertionError(f"log.txt has {epochs_logged} lines, expected {epochs}")
    want = {k: v * steps for k, v in train_launches_per_step(msda_keys).items()}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return dict(run=run, counts=counts, losses=losses, step_seconds=step_s,
                median_step_s=median_s, peak_bytes=peak, wall_s=wall)


def profile_train_step(run, top: int = 8, tag: str = "train-profile") -> dict:
    """torch.profiler over one more training step: device time by kernel
    group against the step's wall time (profiler on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = iter(run["loader"])
    batch = next(batches)
    batches.close()   # stops the loader's threads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run["train_step"](run["state"], batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    groups = {"K1 msda_fwd": 0.0, "K2 fusion_fwd": 0.0, "K3 msda_bwd": 0.0,
              "K4 fusion_bwd": 0.0, "K5 banded_fwd": 0.0, "K6/K7 sweep_fwd": 0.0,
              "K9/K10 sweep_bwd": 0.0, "matmul": 0.0, "other": 0.0}
    for key, ms, _ in kernels:
        if "banded_fwd_kernel" in key:
            groups["K5 banded_fwd"] += ms
        elif "sweep_fwd_kernel" in key:
            groups["K6/K7 sweep_fwd"] += ms
        elif "sweep_bwd_kernel" in key:
            groups["K9/K10 sweep_bwd"] += ms
        elif "msda_fwd_kernel" in key:
            groups["K1 msda_fwd"] += ms
        elif "attend_kernel" in key or "combine_kernel" in key:
            groups["K2 fusion_fwd"] += ms
        elif "msda_bwd_kernel" in key:
            groups["K3 msda_bwd"] += ms
        elif "bwd_kernel" in key or "sum_splits_kernel" in key:
            groups["K4 fusion_bwd"] += ms
        elif any(t in key.lower() for t in ("gemm", "xmma", "cutlass", "matmul")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    log(tag, f"one step {wall_ms:.1f} ms wall (profiler on), device busy "
                         f"{busy:.1f} ms ({busy / wall_ms:.0%}); by group ms "
                         f"{ {k: round(v, 2) for k, v in groups.items()} }; top kernels "
                         f"{[(k[:48], round(ms, 2), n) for k, ms, n in kernels[:top]]}")
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "groups_ms": groups}


def module_of(name: str) -> str:
    for prefix, group in (("backbone.", "backbone"), ("bert.", "bert"),
                          ("transformer.encoder.", "encoder"),
                          ("transformer.decoder.", "decoder")):
        if name.startswith(prefix):
            return group
    return "heads"


def negated_output(fn, index: int):
    """`fn` with its index-th output negated: a planted kernel fault."""
    def planted(*args):
        out = list(fn(*args))
        out[index] = -out[index]
        return tuple(out)
    planted.launches = 0   # the kernel's wrapper counts on its module's name, now this
    return planted


def parity_harness(cfg: str, files):
    """The one-step comparisons' common ground: the same seeded weights, the
    same batch (B = 1, an 800x1216-bucket image), fusion droppath 0, the
    config's full depth.  Returns (step, gaps, within):
      step(device, msda=None) - one training step of a fresh copy of the
          weights (MSDeformAttn attributes `msda` set on every deformable
          attention): loss, every parameter's gradient on the host, seconds;
      gaps(run, ref, fed) - (loss rel, {module: gradient-norm rel}, {leaf
          whose name holds one of `fed`: ||g_run - g_ref|| / ||g_ref||});
      within(gaps) - all three inside the PARITY_* limits."""
    import copy

    import numpy as np
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
    from open_groundingdino_tpu_torch.data.transforms import Sample
    from open_groundingdino_tpu_torch.inference import load_reference_state_dict
    from open_groundingdino_tpu_torch.models.criterion import build_criterion
    from open_groundingdino_tpu_torch.models.deformable import MSDeformAttn
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino
    from open_groundingdino_tpu_torch.parallel.optim import make_optimizer
    from open_groundingdino_tpu_torch.parallel.train_state import TrainState, make_train_step

    _, ckpt, vocab = files
    args = SLConfig.fromfile(cfg)
    args.merge_from_dict({"fusion_droppath": 0.0})
    base = build_groundingdino(args, device="cpu")
    load_reference_state_dict(base, ckpt)

    h, w = 800, 1200
    rng = np.random.RandomState(SEED + 11)
    boxes = np.asarray([[100, 120, 500, 600], [600, 200, 1100, 700], [300, 400, 700, 780]],
                       np.float32)
    cap_list = list(CATEGORIES)
    sample = Sample(image=synthetic_image(h, w, 200), boxes=boxes,
                    labels=rng.randint(len(cap_list), size=len(boxes)).astype(np.int64),
                    caption=" . ".join(cap_list) + " .", cap_list=cap_list)
    collator = Collator(build_tokenizer(vocab), args.image_buckets, int(args.max_text_len),
                        int(args.max_gt_boxes), u8_images=True)
    batch = collator([sample])
    if tuple(batch["images"].shape[1:3]) != BUCKET:
        raise AssertionError(f"parity batch landed in {batch['images'].shape}, not {BUCKET}")

    def step(device, msda=None):
        model = copy.deepcopy(base).to(device)
        for m in model.modules():
            if isinstance(m, MSDeformAttn):
                for k, v in (msda or {}).items():
                    setattr(m, k, v)
        opt = make_optimizer(model, lr=float(args.lr), base_lr=float(args.lr),
                             lr_backbone=float(args.lr_backbone),
                             lr_linear_proj_mult=float(args.lr_linear_proj_mult),
                             weight_decay=float(args.weight_decay),
                             clip_max_norm=float(args.clip_max_norm))
        grads = {}
        step_fn = opt.step

        def spy(gs, norm):
            grads.update((n, g.detach().to("cpu", copy=True)) for n, g in zip(opt.names, gs))
            step_fn(gs, norm)

        opt.step = spy
        t0 = time.perf_counter()
        metrics = make_train_step(build_criterion(args))(TrainState.create(model, opt, seed=SEED),
                                                         batch)
        if device == "cuda":
            torch.cuda.synchronize()
        return dict(loss=metrics["loss"], grads=grads, seconds=time.perf_counter() - t0)

    def gaps(run, ref, fed):
        sq = {}
        for dev, r in (("run", run), ("ref", ref)):
            for name, g in r["grads"].items():
                key = (dev, module_of(name))
                sq[key] = sq.get(key, 0.0) + float(g.double().pow(2).sum())
        modules = {m for _, m in sq}
        norm_rel = {m: abs(sq["run", m] ** 0.5 - sq["ref", m] ** 0.5)
                    / max(sq["ref", m] ** 0.5, 1e-30) for m in modules}
        leaf_rel = {}
        for name, g in ref["grads"].items():
            if any(k in name for k in fed):
                g = g.double()
                leaf_rel[name] = float((run["grads"][name].double() - g).norm()
                                       / max(float(g.norm()), 1e-30))
        loss_rel = abs(run["loss"] - ref["loss"]) / abs(ref["loss"])
        return loss_rel, norm_rel, leaf_rel

    def within(gap):
        loss_rel, norm_rel, leaf_rel = gap
        return (loss_rel < PARITY_LOSS_RTOL and all(v < PARITY_GRAD_RTOL for v in norm_rel.values())
                and all(v < PARITY_LEAF_RTOL for v in leaf_rel.values()))

    return step, gaps, within


def planted_faults(step, gaps, within, ref, fed, faults, tag, **step_kw) -> dict:
    """The card's step again with each planted kernel fault (label, module,
    wrapper name, output index): each must fail the comparison with ref."""
    planted = {}
    for label, module, attr, index in faults:
        kernel = getattr(module, attr)
        setattr(module, attr, negated_output(kernel, index))
        try:
            run = step("cuda", **step_kw)
        finally:
            setattr(module, attr, kernel)
        gap = gaps(run, ref, fed)
        planted[label] = max(gap[2].values())
        log(tag, f"planted fault, {label}: leaves ||dg||/||g|| max {planted[label]:.2e}, "
                 f"module grad-norm rel max {max(gap[1].values()):.2e}")
        if within(gap):
            raise AssertionError(f"{tag} passes with a planted fault: {label}")
    return planted


def check_train_parity(harness) -> dict:
    """One training step on the card and the same step on the CPU (plain
    versions of the kernels).  Loss within PARITY_LOSS_RTOL, each top-level
    module's gradient norm within PARITY_GRAD_RTOL, and the gradient of each
    parameter that K3 or K4 feeds within PARITY_LEAF_RTOL.  Then the card's
    step again with K3's grad_locs and, apart, K4's gvl negated: each planted
    fault must fail the same comparison.  Returns the comparison and the
    card's step."""
    from open_groundingdino_tpu_torch.ops import fusion, msda

    step, gaps, within = harness
    card, cpu = step("cuda"), step("cpu")
    gap = gaps(card, cpu, KERNEL_FED)
    loss_rel, norm_rel, leaf_rel = gap
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("train-parity", f"B=1 {BUCKET} bucket, config depth, droppath 0: loss card "
                        f"{card['loss']:.6f} CPU {cpu['loss']:.6f} (rel {loss_rel:.2e}, limit "
                        f"{PARITY_LOSS_RTOL}); grad-norm rel diff by module "
                        f"{ {k: f'{v:.2e}' for k, v in norm_rel.items()} } (limit "
                        f"{PARITY_GRAD_RTOL}); {len(leaf_rel)} K3/K4-fed leaves "
                        f"||dg||/||g|| max {max(leaf_rel.values()):.2e} (limit "
                        f"{PARITY_LEAF_RTOL}), worst {[(n, f'{v:.2e}') for n, v in worst]}; "
                        f"step s card {card['seconds']:.1f}, CPU {cpu['seconds']:.1f}")
    if len(card["grads"]) != len(cpu["grads"]) or not within(gap):
        raise AssertionError("the card's training step disagrees with the CPU's")
    planted = planted_faults(step, gaps, within, cpu, KERNEL_FED,
                             (("K3 grad_locs negated", msda, "ms_deform_attn_bwd", 1),
                              ("K4 gvl negated", fusion, "fused_bi_attention_bwd", 3)),
                             "train-parity")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, leaf_rel_max=max(leaf_rel.values()),
                planted=planted), card


def check_sweep_train_parity(harness, gather_card) -> dict:
    """One training step through the sweep (K6 forward, K9 backward) against
    the gather's step on the card (phase 11's) from the same weights and
    batch: loss within PARITY_LOSS_RTOL, module gradient norms within
    PARITY_GRAD_RTOL, and each parameter that the MSDA kernels feed within
    PARITY_LEAF_RTOL.  Then with K9's gw negated, which must fail."""
    from open_groundingdino_tpu_torch.ops import msda_sweep as sw

    step, gaps, within = harness
    sweep = {"kernel": "sweep", "sweep_bwd": "corner"}
    run = step("cuda", msda=sweep)
    gap = gaps(run, gather_card, MSDA_FED)
    loss_rel, norm_rel, leaf_rel = gap
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("sweep-train-parity", f"sweep step vs gather step on the card: loss {run['loss']:.6f} "
                              f"vs {gather_card['loss']:.6f} (rel {loss_rel:.2e}); grad-norm rel "
                              f"by module { {k: f'{v:.2e}' for k, v in norm_rel.items()} }; "
                              f"{len(leaf_rel)} MSDA-fed leaves ||dg||/||g|| max "
                              f"{max(leaf_rel.values()):.2e} (limit {PARITY_LEAF_RTOL}), worst "
                              f"{[(n, f'{v:.2e}') for n, v in worst]}; step s {run['seconds']:.1f}")
    if not within(gap):
        raise AssertionError("the sweep's training step disagrees with the gather's")
    planted = planted_faults(step, gaps, within, gather_card, MSDA_FED,
                             (("K9 gw negated", sw, "sweep_bwd_corner", 1),),
                             "sweep-train-parity", msda=sweep)
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, leaf_rel_max=max(leaf_rel.values()),
                planted=planted)


def profile_request(im, image, caption, top: int = 8, tag: str = "profile") -> dict:
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
    groups = {"K1 msda_fwd": 0.0, "K2 fusion_fwd": 0.0, "K5 banded_fwd": 0.0,
              "K6/K7 sweep_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for key, ms, _ in kernels:
        if "banded_fwd_kernel" in key:
            groups["K5 banded_fwd"] += ms
        elif "sweep_fwd_kernel" in key:
            groups["K6/K7 sweep_fwd"] += ms
        elif "msda_fwd_kernel" in key:
            groups["K1 msda_fwd"] += ms
        elif "attend_kernel" in key or "combine_kernel" in key:
            groups["K2 fusion_fwd"] += ms
        elif any(t in key.lower() for t in ("gemm", "xmma", "cutlass", "matmul")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    log(tag, f"one request {wall_ms:.1f} ms wall (profiler on), device busy {busy:.1f} ms "
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
        files = write_serving_files(cfg, work)
        im, lat, counts, images = serve(files, "cuda")                 # 5
        cpu_out = check_forward(im, files, images[0], CAPTIONS[0])     # 6
        profile_request(im, images[0], CAPTIONS[0])                    # 7
        del im
        k3 = check_msda_bwd("cuda")                                    # 8
        k4 = check_fusion_bwd("cuda")                                  # 9
        train_files = (cfg, os.path.join(work, "train_ckpt.pth"), files[2])
        write_checkpoint(cfg, train_files[1], random_biases=True)
        tr = train(cfg, work, train_files, "cuda")                     # 10
        profile_train_step(tr.pop("run"))
        harness = parity_harness(cfg, train_files)
        _, gather_card = check_train_parity(harness)                   # 11

        sweep = check_sweep("cuda")                                    # 12
        serve_counts = {}
        for tag, keys in (("sweep-serve", {"msda_kernel": "sweep"}),   # 13
                          ("sweep-serve-fused", {"msda_kernel": "sweep", "msda_dec_fused": True})):
            sweep_files = (msda_config(cfg, work, tag, **keys), *files[1:])
            im, _, serve_counts[tag], _ = serve(sweep_files, "cuda", tag)
            compare_forward(forward_outputs(im, images[0], CAPTIONS[0]), cpu_out,
                            f"{tag}-forward", "against phase 6's CPU forward")
            if tag == "sweep-serve":
                profile_request(im, images[0], CAPTIONS[0], tag="sweep-profile")
            del im
        train_counts_sweep = {}
        for tag, keys, kw in (                                          # 14
                ("sweep-train", {"msda_kernel": "sweep"}, dict(epochs=1)),
                ("sweep-train-rowtap", {"msda_kernel": "sweep", "msda_sweep_bwd": "rowtap"},
                 dict(epochs=1, max_steps=1))):
            run = train(cfg, work, train_files, "cuda", keys, tag=tag, **kw)
            train_counts_sweep[tag] = run["counts"]
            if tag == "sweep-train":
                profile_train_step(run.pop("run"), tag="sweep-train-profile")
            del run
        check_sweep_train_parity(harness, gather_card)                 # 15

        banded = check_banded_corner("cuda")                           # 16
        banded_files = (msda_config(cfg, work, "banded-serve", msda_kernel="banded_point"),
                        *files[1:])
        im, _, serve_counts["banded-serve"], _ = serve(banded_files, "cuda", "banded-serve")  # 17
        compare_forward(forward_outputs(im, images[0], CAPTIONS[0]), cpu_out,
                        "banded-serve-forward", "against phase 6's CPU forward")
        profile_request(im, images[0], CAPTIONS[0], tag="banded-profile")
        del im
        run = train(cfg, work, train_files, "cuda", {"msda_kernel": "banded_point"},  # 18
                    tag="banded-train", epochs=1)
        train_counts_sweep["banded-train"] = run["counts"]
        profile_train_step(run.pop("run"), tag="banded-train-profile")
        del run
        check_banded_train_parity(harness, gather_card)
        _, bench_counts = run_microbench()                              # 19
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def mean_row(rows):
        """K1 and K3 run 6x at each shape per forward/backward: their row is
        the mean launch"""
        enc, dec = rows["encoder"], rows["decoder"]
        return {"max_abs_err": max(enc["max_abs_err"], dec["max_abs_err"]),
                **{key: (enc[key] + dec[key]) / 2 for key in ("ms", "plain_ms", "bound_ms")},
                "bound_by": enc["bound_by"], "library_ms": None, "per_shape": rows}

    def single_row(row):
        return {key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by")} | {"library_ms": None}

    src, tpu = "open_groundingdino_tpu_torch/csrc/", "open_groundingdino_tpu/ops/"
    # launches: the serving run's (phase 5) for K1 and K2, the training run's
    # (phase 10) for K3 and K4; both runs' counts under launches_by_path
    train_counts = tr["counts"]
    # K1 and K2 were also held to their plain versions at B = 4 (phases 8, 9)
    k1_err = max(r["k1_max_abs_err"] for r in k3.values())
    k2_err = k4["k2_max_abs_err"]
    kernels = [
        {"name": "msda_fwd", "route": "cuda", "source": src + "msda_fwd.cu",
         "replaces": tpu + "msda_banded.py:311", "launches": counts["msda_fwd"],
         "launches_by_path": {"serve": counts["msda_fwd"], "train": train_counts["msda_fwd"]},
         **mean_row(k1) | {"max_abs_err": max(mean_row(k1)["max_abs_err"], k1_err)}},
        {"name": "fusion_fwd", "route": "cuda", "source": src + "fusion_fwd.cu",
         "replaces": tpu + "fusion_pallas.py:50", "launches": counts["fusion_fwd"],
         "launches_by_path": {"serve": counts["fusion_fwd"],
                              "train": train_counts["fusion_fwd"]},
         **single_row(k2) | {"max_abs_err": max(k2["max_abs_err"], k2_err)},
         "per_shape": {"B=1": single_row(k2), "B=4": single_row(k4["k2"])},
         "sass": k2["sass"]["fusion_fwd"]},
        {"name": "msda_bwd", "route": "cuda", "source": src + "msda_bwd.cu",
         "replaces": tpu + "msda_banded.py:524", "launches": train_counts["msda_bwd"],
         "launches_by_path": {"serve": 0, "train": train_counts["msda_bwd"]},
         **mean_row(k3)},
        {"name": "fusion_bwd", "route": "cuda", "source": src + "fusion_bwd.cu",
         "replaces": tpu + "fusion_pallas.py:198", "launches": train_counts["fusion_bwd"],
         "launches_by_path": {"serve": 0, "train": train_counts["fusion_bwd"]},
         **single_row(k4), "sass": k4["sass"]["fusion_bwd"]},
    ]
    # K5 and K8 (phase 16; the row is phase 8's B = 4 shapes, per_shape adds
    # B = 1) and the sweep kernels (phase 12 at phase 8's B = 4 shapes);
    # launches: K5's from the banded serving run (phase 17), K6's and K7's
    # from the sweep serving runs (phase 13), K8's from the microbench (phase
    # 19), K9's and K10's from the sweep training runs (phase 14); every
    # run's counts under launches_by_path
    by_path = {**serve_counts, **train_counts_sweep, "microbench": bench_counts}
    measured = {**sweep, **{(k, n): r for (k, batch, n), r in banded.items() if batch == "B=4"}}
    for kname, counter, launches_from, source, line in (
            ("K5", "banded_fwd", "banded-serve", "msda_banded_fwd.cu", "msda_banded.py:152"),
            ("K6", "sweep_fwd", "sweep-serve", "msda_sweep_fwd.cu", "msda_pallas.py:484"),
            ("K7", "sweep_fwd_allq", "sweep-serve-fused", "msda_sweep_fwd.cu",
             "msda_pallas.py:634"),
            ("K8", "sweep_fwd_corner", "microbench", "msda_sweep_fwd.cu", "msda_pallas.py:169"),
            ("K9", "sweep_bwd_corner", "sweep-train", "msda_sweep_bwd.cu", "msda_pallas.py:955"),
            ("K10", "sweep_bwd_rowtap", "sweep-train-rowtap", "msda_sweep_bwd.cu",
             "msda_pallas.py:1200")):
        shapes = {n: measured[kname, n] for n in ("encoder", "decoder") if (kname, n) in measured}
        row = mean_row(shapes) if len(shapes) == 2 else single_row(shapes["decoder"])
        if kname in ("K5", "K8"):
            row["per_shape"] = {f"{batch} {n}": r for (k, batch, n), r in banded.items()
                                if k == kname}
            row["max_abs_err"] = max(max(r["max_abs_err"], r["k1_max_abs_err"])
                                     for r in row["per_shape"].values())
        kernels.append({"name": counter, "route": "cuda", "source": src + source,
                        "replaces": tpu + line, "launches": by_path[launches_from][counter],
                        "launches_by_path": {k: v[counter] for k, v in by_path.items()}, **row})
        if kernels[-1]["launches"] <= 0:
            raise AssertionError(f"{kname} was not launched on its path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
