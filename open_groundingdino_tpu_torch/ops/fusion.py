"""Bidirectional image<->text fusion attention core: K2
(csrc/fusion_fwd.cu) and its plain PyTorch version.

One logits matrix per head, L[v, l] = q_v . k_l, softmaxed in both
directions (reference fuse_modules.py:99-248; the JAX package's
models/layers.py BiMultiHeadAttention and ops/fusion_pallas.py):
row softmax over live text tokens for the image side, column softmax over
live image tokens for the text side.

Layouts: the projections' raw (B, N, E = H*D) outputs, q already scaled;
masks (B, N) bool with True = padded.  Returns (out_v (B, Nv, E),
out_l (B, Nl, E)) before the output projections.

`fused_bi_attention` launches the CUDA kernel for CUDA tensors and takes
`fused_bi_attention_plain` for CPU tensors.  `fused_bi_attention.launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIM = 256  # the kernel's one head dim: fusion E = 1024, H = 4
IMAGE_TOKENS_PER_SPLIT = 640  # image-axis split of the text-side pass


def fused_bi_attention_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads):
    """The literal formulation of the JAX package's models/layers.py:166-200:
    materialized logits, global-max shift, +-50000 clamps, masked softmaxes."""
    B, Nv, E = q.shape
    Nl = k.shape[1]
    H = num_heads
    D = E // H
    logits = torch.einsum(
        "bvhd,blhd->bhvl", q.reshape(B, Nv, H, D), k.reshape(B, Nl, H, D)
    )
    logits = logits - logits.max()
    logits = logits.clamp(-50000.0, 50000.0)

    logits_t = logits.transpose(-1, -2)                      # (B, H, Nl, Nv)
    logits_l = logits_t - logits_t.amax(dim=-1, keepdim=True)
    logits_l = logits_l.clamp(-50000.0, 50000.0)
    logits_l = logits_l.masked_fill(mask_v[:, None, None, :], -1e9)
    attn_l = torch.softmax(logits_l.float(), dim=-1).to(q.dtype)

    logits = logits.masked_fill(mask_l[:, None, None, :], -1e9)
    attn_v = torch.softmax(logits.float(), dim=-1).to(q.dtype)

    out_v = torch.einsum("bhvl,blhd->bvhd", attn_v, val_l.reshape(B, Nl, H, D))
    out_l = torch.einsum("bhlv,bvhd->blhd", attn_l, val_v.reshape(B, Nv, H, D))
    return out_v.reshape(B, Nv, E), out_l.reshape(B, Nl, E)


_CTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fused_bi_attention(q, k, val_v, val_l, mask_v, mask_l, num_heads: int):
    """K2 for CUDA tensors (f32, contiguous), the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return fused_bi_attention_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_bi_attention: unsupported device {q.device}")
    B, Nv, E = q.shape
    Nl = k.shape[1]
    H = num_heads
    if E != H * HEAD_DIM:
        raise ValueError(f"head dim E/H = {E}/{H}: the kernel is built for {HEAD_DIM} only")
    shapes = {
        "q": (q, (B, Nv, E)), "k": (k, (B, Nl, E)), "val_v": (val_v, (B, Nv, E)),
        "val_l": (val_l, (B, Nl, E)), "mask_v": (mask_v, (B, Nv)),
        "mask_l": (mask_l, (B, Nl)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name.startswith("mask"):
            if t.dtype != torch.bool:
                raise TypeError(f"{name} must be bool")
        elif t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be float32, contiguous and 16-byte aligned")

    n_splits = max(2, min(64, -(-Nv // IMAGE_TOKENS_PER_SPLIT)))
    D = E // H
    dev = q.device
    out_v = torch.empty_like(q)
    out_l = torch.empty_like(k)
    part_acc = torch.empty(B, H, n_splits, Nl, D, dtype=torch.float32, device=dev)
    part_m = torch.empty(B, H, n_splits, Nl, dtype=torch.float32, device=dev)
    part_s = torch.empty_like(part_m)
    pad_v = mask_v.to(torch.uint8).contiguous()
    pad_l = mask_l.to(torch.uint8).contiguous()

    fn = build.load("fusion_fwd").fusion_fwd_f32
    fn.argtypes = _CTYPES
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), val_v.data_ptr(), val_l.data_ptr(),
        pad_v.data_ptr(), pad_l.data_ptr(), out_v.data_ptr(), out_l.data_ptr(),
        part_acc.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        B, Nv, Nl, E, H, n_splits, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fusion_fwd")
    fused_bi_attention.launches += 1
    return out_v, out_l


fused_bi_attention.launches = 0
