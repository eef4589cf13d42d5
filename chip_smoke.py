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
               text count
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
then the {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

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
# tensor cores (both kernels compute in f32 on the SIMT units)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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
    softmax is live; G2 and gvv where the column softmax is live."""
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
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
    return dict(B=q.shape[0], Nv=q.shape[1], max_abs_err=max(errs.values()), errs=errs,
                k2_max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


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

    for fn in kernel_counters().values():
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
    if msda.ms_deform_attn_bwd.launches or fusion.fused_bi_attention_bwd.launches:
        raise AssertionError("serving launched a backward kernel")
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

    return {"msda_fwd": msda.ms_deform_attn, "fusion_fwd": fusion.fused_bi_attention,
            "msda_bwd": msda.ms_deform_attn_bwd, "fusion_bwd": fusion.fused_bi_attention_bwd}


def train(cfg: str, work: str, files, device: str) -> dict:
    """The port's training entry (main.main) on the synthetic ODVG set at
    the config's full width and depth: B = 4, f32, TRAIN_STEPS steps from the
    smoke's seeded checkpoint (random biases); counts the kernels' launches
    of the run."""
    import torch

    from open_groundingdino_tpu_torch import main as train_main

    manifest = write_odvg(work)
    _, ckpt, vocab = files
    cli = train_main.get_args_parser().parse_args([
        "-c", cfg, "--datasets", manifest, "--output_dir", os.path.join(work, "train_out"),
        "--vocab", vocab, "--pretrain_model_path", ckpt, "--device", device,
        "--seed", str(SEED), "--num_workers", "2", "--print_freq", "1",
        "--options", f"epochs={TRAIN_EPOCHS}", "batch_size=4", "compute_dtype=float32",
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
    timed = sorted(step_s[1:])
    median_s = timed[len(timed) // 2]
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(work, "train_out", "log.txt")) as f:
        epochs_logged = len(f.read().splitlines())
    log("train", f"{len(records)} steps (B=4, f32, TF32 off) in {wall:.1f} s with set-up: "
                 f"losses {[round(x, 4) for x in losses]}; step s "
                 f"{[round(x, 3) for x in step_s]} (median of the {len(timed)} timed: "
                 f"{median_s:.3f} s); max_memory_allocated {peak / 2**30:.2f} GiB; "
                 f"log.txt lines {epochs_logged}; launches {counts} "
                 f"(per step {({k: v / max(len(records), 1) for k, v in counts.items()})})")
    if len(records) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"expected {TRAIN_STEPS} finite losses, got {losses}")
    if epochs_logged != TRAIN_EPOCHS:
        raise AssertionError(f"log.txt has {epochs_logged} lines, expected {TRAIN_EPOCHS}")
    want = {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    return dict(run=run, counts=counts, losses=losses, step_seconds=step_s,
                median_step_s=median_s, peak_bytes=peak, wall_s=wall)


def profile_train_step(run, top: int = 8) -> dict:
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
              "K4 fusion_bwd": 0.0, "matmul": 0.0, "other": 0.0}
    for key, ms, _ in kernels:
        if "msda_fwd_kernel" in key:
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
    log("train-profile", f"one step {wall_ms:.1f} ms wall (profiler on), device busy "
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


def check_train_parity(cfg: str, files) -> dict:
    """One training step on the card and the same step on the CPU (plain
    versions of the kernels): the same seeded weights, the same batch (B = 1,
    an 800x1216-bucket image), fusion droppath 0, the config's full depth.
    Loss within PARITY_LOSS_RTOL, each top-level module's gradient norm
    within PARITY_GRAD_RTOL, and the gradient of each parameter that K3 or
    K4 feeds within PARITY_LEAF_RTOL.  Then the card's step again with K3's
    grad_locs and, apart, K4's gvl negated: each planted fault must fail
    the same comparison."""
    import copy

    import numpy as np
    import torch

    from open_groundingdino_tpu_torch.config import SLConfig
    from open_groundingdino_tpu_torch.data.loader import Collator
    from open_groundingdino_tpu_torch.data.tokenization import build_tokenizer
    from open_groundingdino_tpu_torch.data.transforms import Sample
    from open_groundingdino_tpu_torch.inference import load_reference_state_dict
    from open_groundingdino_tpu_torch.models.criterion import build_criterion
    from open_groundingdino_tpu_torch.models.groundingdino import build_groundingdino
    from open_groundingdino_tpu_torch.ops import fusion, msda
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

    def step(device):
        """One training step of a fresh copy of the weights: loss, every
        parameter's gradient on the host, seconds."""
        model = copy.deepcopy(base).to(device)
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

    def gaps(card, cpu):
        """(loss rel, {module: gradient-norm rel}, {kernel-fed leaf:
        ||g_card - g_cpu|| / ||g_cpu||})."""
        sq = {}
        for dev, run in (("card", card), ("cpu", cpu)):
            for name, g in run["grads"].items():
                key = (dev, module_of(name))
                sq[key] = sq.get(key, 0.0) + float(g.double().pow(2).sum())
        modules = {m for _, m in sq}
        norm_rel = {m: abs(sq["card", m] ** 0.5 - sq["cpu", m] ** 0.5)
                    / max(sq["cpu", m] ** 0.5, 1e-30) for m in modules}
        leaf_rel = {}
        for name, g in cpu["grads"].items():
            if any(k in name for k in KERNEL_FED):
                ref = g.double()
                leaf_rel[name] = float((card["grads"][name].double() - ref).norm()
                                       / max(float(ref.norm()), 1e-30))
        loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        return loss_rel, norm_rel, leaf_rel

    def within(loss_rel, norm_rel, leaf_rel):
        return (loss_rel < PARITY_LOSS_RTOL and all(v < PARITY_GRAD_RTOL for v in norm_rel.values())
                and all(v < PARITY_LEAF_RTOL for v in leaf_rel.values()))

    card, cpu = step("cuda"), step("cpu")
    loss_rel, norm_rel, leaf_rel = gaps(card, cpu)
    worst = sorted(leaf_rel.items(), key=lambda kv: -kv[1])[:3]
    log("train-parity", f"B=1 {BUCKET} bucket, config depth, droppath 0: loss card "
                        f"{card['loss']:.6f} CPU {cpu['loss']:.6f} (rel {loss_rel:.2e}, limit "
                        f"{PARITY_LOSS_RTOL}); grad-norm rel diff by module "
                        f"{ {k: f'{v:.2e}' for k, v in norm_rel.items()} } (limit "
                        f"{PARITY_GRAD_RTOL}); {len(leaf_rel)} K3/K4-fed leaves "
                        f"||dg||/||g|| max {max(leaf_rel.values()):.2e} (limit "
                        f"{PARITY_LEAF_RTOL}), worst {[(n, f'{v:.2e}') for n, v in worst]}; "
                        f"step s card {card['seconds']:.1f}, CPU {cpu['seconds']:.1f}")
    if len(card["grads"]) != len(cpu["grads"]) or not within(loss_rel, norm_rel, leaf_rel):
        raise AssertionError("the card's training step disagrees with the CPU's")

    planted = {}
    for label, module, attr, index in (("K3 grad_locs negated", msda, "ms_deform_attn_bwd", 1),
                                       ("K4 gvl negated", fusion, "fused_bi_attention_bwd", 3)):
        kernel = getattr(module, attr)
        setattr(module, attr, negated_output(kernel, index))
        try:
            run = step("cuda")
        finally:
            setattr(module, attr, kernel)
        p_loss, p_norm, p_leaf = gaps(run, cpu)
        planted[label] = max(p_leaf.values())
        log("train-parity", f"planted fault, {label}: leaves ||dg||/||g|| max "
                            f"{planted[label]:.2e}, module grad-norm rel max "
                            f"{max(p_norm.values()):.2e}")
        if within(p_loss, p_norm, p_leaf):
            raise AssertionError(f"phase 11 passes with a planted fault: {label}")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, leaf_rel_max=max(leaf_rel.values()),
                planted=planted)


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
        del im
        k3 = check_msda_bwd("cuda")                                    # 8
        k4 = check_fusion_bwd("cuda")                                  # 9
        train_files = (cfg, os.path.join(work, "train_ckpt.pth"), files[2])
        write_checkpoint(cfg, train_files[1], random_biases=True)
        tr = train(cfg, work, train_files, "cuda")                     # 10
        profile_train_step(tr.pop("run"))
        check_train_parity(cfg, train_files)                           # 11
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
         **single_row(k2) | {"max_abs_err": max(k2["max_abs_err"], k2_err)}},
        {"name": "msda_bwd", "route": "cuda", "source": src + "msda_bwd.cu",
         "replaces": tpu + "msda_banded.py:524", "launches": train_counts["msda_bwd"],
         "launches_by_path": {"serve": 0, "train": train_counts["msda_bwd"]},
         **mean_row(k3)},
        {"name": "fusion_bwd", "route": "cuda", "source": src + "fusion_bwd.cu",
         "replaces": tpu + "fusion_pallas.py:198", "launches": train_counts["fusion_bwd"],
         "launches_by_path": {"serve": 0, "train": train_counts["fusion_bwd"]},
         **single_row(k4)},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
