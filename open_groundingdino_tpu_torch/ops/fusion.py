"""Bidirectional image<->text fusion attention core: K2
(csrc/fusion_fwd.cu), its gradient K4 (csrc/fusion_bwd.cu), and their plain
PyTorch versions.

One logits matrix per head, L[v, l] = q_v . k_l, softmaxed in both
directions (reference fuse_modules.py:99-248; the JAX package's
models/layers.py BiMultiHeadAttention and ops/fusion_pallas.py):
row softmax over live text tokens for the image side, column softmax over
live image tokens for the text side.

Layouts: the projections' raw (B, N, E = H*D) outputs, q already scaled;
masks (B, N) bool with True = padded.  Returns (out_v (B, Nv, E),
out_l (B, Nl, E)) before the output projections.

`fused_bi_attention` takes `fused_bi_attention_plain` for CPU tensors
(autograd differentiates it) and, for CUDA tensors,
`FusedBiAttentionFunction`: K2 forward, K4 backward.
`fused_bi_attention_bwd` is K4's wrapper and takes CUDA tensors only;
`fused_bi_attention_bwd_plain` is its reference.  `fused_bi_attention.launches`
and `fused_bi_attention_bwd.launches` count the kernels' launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIM = 256  # the kernels' one head dim: fusion E = 1024, H = 4
IMAGE_TOKENS_PER_SPLIT = 640  # image-axis split of the text-side passes


def fused_bi_attention_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads):
    """The literal formulation of the JAX package's models/layers.py:166-200:
    materialized logits, global-max shift, +-50000 clamps, masked softmaxes.
    Both max shifts are constants to autograd, as `stop_gradient` makes them
    in the JAX package."""
    B, Nv, E = q.shape
    Nl = k.shape[1]
    H = num_heads
    D = E // H
    logits = torch.einsum(
        "bvhd,blhd->bhvl", q.reshape(B, Nv, H, D), k.reshape(B, Nl, H, D)
    )
    logits = logits - logits.max().detach()
    logits = logits.clamp(-50000.0, 50000.0)

    logits_t = logits.transpose(-1, -2)                      # (B, H, Nl, Nv)
    logits_l = logits_t - logits_t.amax(dim=-1, keepdim=True).detach()
    logits_l = logits_l.clamp(-50000.0, 50000.0)
    logits_l = logits_l.masked_fill(mask_v[:, None, None, :], -1e9)
    attn_l = torch.softmax(logits_l.float(), dim=-1).to(q.dtype)

    logits = logits.masked_fill(mask_l[:, None, None, :], -1e9)
    attn_v = torch.softmax(logits.float(), dim=-1).to(q.dtype)

    out_v = torch.einsum("bhvl,blhd->bvhd", attn_v, val_l.reshape(B, Nl, H, D))
    out_l = torch.einsum("bhlv,bvhd->blhd", attn_l, val_v.reshape(B, Nv, H, D))
    return out_v.reshape(B, Nv, E), out_l.reshape(B, Nl, E)


def fused_bi_attention_bwd_plain(q, k, val_v, val_l, mask_v, mask_l, g_ov, g_ol, num_heads):
    """(gq, gk, gvv, gvl) of the plain version by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, val_v, val_l)]
        outs = fused_bi_attention_plain(*leaves, mask_v, mask_l, num_heads)
        return torch.autograd.grad(outs, leaves, (g_ov, g_ol))


_FWD_CTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_CTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if name.startswith("mask"):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool")
    elif t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be float32, contiguous and 16-byte aligned")


def _geometry(q, k, num_heads: int, what: str):
    """Validate the device and head dim; returns (B, Nv, Nl, E, H, n_splits)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    B, Nv, E = q.shape
    Nl = k.shape[1]
    if E != num_heads * HEAD_DIM:
        raise ValueError(f"head dim E/H = {E}/{num_heads}: the kernels are built for "
                         f"{HEAD_DIM} only")
    n_splits = max(2, min(64, -(-Nv // IMAGE_TOKENS_PER_SPLIT)))
    return B, Nv, Nl, E, num_heads, n_splits


def _pads(mask_v, mask_l):
    return mask_v.to(torch.uint8).contiguous(), mask_l.to(torch.uint8).contiguous()


def _fusion_fwd_cuda(q, k, val_v, val_l, mask_v, mask_l, num_heads: int):
    """K2: (out_v, out_l, lse_v (B, H, Nv), lse_l (B, H, Nl))."""
    B, Nv, Nl, E, H, n_splits = _geometry(q, k, num_heads, "fused_bi_attention")
    for name, t, shape in (("q", q, (B, Nv, E)), ("k", k, (B, Nl, E)),
                           ("val_v", val_v, (B, Nv, E)), ("val_l", val_l, (B, Nl, E)),
                           ("mask_v", mask_v, (B, Nv)), ("mask_l", mask_l, (B, Nl))):
        _check(name, t, shape, q)
    D = E // H
    dev = q.device
    out_v = torch.empty_like(q)
    out_l = torch.empty_like(k)
    lse_v = torch.empty(B, H, Nv, dtype=torch.float32, device=dev)
    lse_l = torch.empty(B, H, Nl, dtype=torch.float32, device=dev)
    part_acc = torch.empty(B, H, n_splits, Nl, D, dtype=torch.float32, device=dev)
    part_m = torch.empty(B, H, n_splits, Nl, dtype=torch.float32, device=dev)
    part_s = torch.empty_like(part_m)
    pad_v, pad_l = _pads(mask_v, mask_l)

    fn = build.load("fusion_fwd").fusion_fwd_f32
    fn.argtypes = _FWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), val_v.data_ptr(), val_l.data_ptr(),
        pad_v.data_ptr(), pad_l.data_ptr(), out_v.data_ptr(), out_l.data_ptr(),
        lse_v.data_ptr(), lse_l.data_ptr(),
        part_acc.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        B, Nv, Nl, E, H, n_splits, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fusion_fwd")
    fused_bi_attention.launches += 1
    return out_v, out_l, lse_v, lse_l


def fused_bi_attention_bwd(q, k, val_v, val_l, mask_v, mask_l, out_v, out_l, lse_v, lse_l,
                           g_ov, g_ol, num_heads: int):
    """K4 on CUDA tensors (f32, contiguous; out_* and lse_* from K2); raises
    for any other.  Returns (gq, gk, gvv, gvl)."""
    B, Nv, Nl, E, H, n_splits = _geometry(q, k, num_heads, "fused_bi_attention_bwd")
    for name, t, shape in (("q", q, (B, Nv, E)), ("k", k, (B, Nl, E)),
                           ("val_v", val_v, (B, Nv, E)), ("val_l", val_l, (B, Nl, E)),
                           ("mask_v", mask_v, (B, Nv)), ("mask_l", mask_l, (B, Nl)),
                           ("out_v", out_v, (B, Nv, E)), ("out_l", out_l, (B, Nl, E)),
                           ("lse_v", lse_v, (B, H, Nv)), ("lse_l", lse_l, (B, H, Nl)),
                           ("g_ov", g_ov, (B, Nv, E)), ("g_ol", g_ol, (B, Nl, E))):
        _check(name, t, shape, q)
    D = E // H
    dev = q.device
    # the row-softmax and column-softmax correction terms, as the JAX package
    # computes them outside its kernel (ops/fusion_pallas.py:291-320)
    rv = (g_ov * out_v).view(B, Nv, H, D).sum(-1).transpose(1, 2).contiguous()
    cl = (g_ol * out_l).view(B, Nl, H, D).sum(-1).transpose(1, 2).contiguous()
    gq, gvv = torch.empty_like(q), torch.empty_like(val_v)
    gk, gvl = torch.empty_like(k), torch.empty_like(val_l)
    part_k = torch.empty(B, H, n_splits, Nl, D, dtype=torch.float32, device=dev)
    part_vl = torch.empty_like(part_k)
    pad_v, pad_l = _pads(mask_v, mask_l)

    fn = build.load("fusion_bwd").fusion_bwd_f32
    fn.argtypes = _BWD_CTYPES
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), val_v.data_ptr(), val_l.data_ptr(),
        pad_v.data_ptr(), pad_l.data_ptr(), lse_v.data_ptr(), lse_l.data_ptr(),
        rv.data_ptr(), cl.data_ptr(), g_ov.data_ptr(), g_ol.data_ptr(),
        gq.data_ptr(), gk.data_ptr(), gvv.data_ptr(), gvl.data_ptr(),
        part_k.data_ptr(), part_vl.data_ptr(),
        B, Nv, Nl, E, H, n_splits, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "fusion_bwd")
    fused_bi_attention_bwd.launches += 1
    return gq, gk, gvv, gvl


class FusedBiAttentionFunction(torch.autograd.Function):
    """K2 forward, K4 backward (the JAX package's custom_vjp `_fused_core`,
    ops/fusion_pallas.py:362-400).  The forward saves its outputs and K2's
    softmax statistics for K4."""

    @staticmethod
    def forward(ctx, q, k, val_v, val_l, mask_v, mask_l, num_heads):
        out_v, out_l, lse_v, lse_l = _fusion_fwd_cuda(q, k, val_v, val_l, mask_v, mask_l,
                                                      num_heads)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, val_v, val_l, mask_v, mask_l, out_v, out_l, lse_v, lse_l)
        return out_v, out_l

    @staticmethod
    def backward(ctx, g_ov, g_ol):
        saved = ctx.saved_tensors
        grads = fused_bi_attention_bwd(*saved, g_ov.contiguous(), g_ol.contiguous(),
                                       ctx.num_heads)
        return (*grads, None, None, None)


def fused_bi_attention(q, k, val_v, val_l, mask_v, mask_l, num_heads: int):
    """K2 (K4 for its gradient) for CUDA tensors (f32, contiguous), the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return fused_bi_attention_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_bi_attention: unsupported device {q.device}")
    return FusedBiAttentionFunction.apply(q, k, val_v, val_l, mask_v, mask_l, num_heads)


fused_bi_attention.launches = 0
fused_bi_attention_bwd.launches = 0
