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

K2 is the custom op `ogd_torch::fusion_fwd` (`fusion_fwd`; ops/library.py)
and K4 the op `ogd_torch::fusion_bwd` (`fusion_bwd_op`): on CUDA tensors the
kernels (`_fusion_fwd_cuda`, `fused_bi_attention_bwd`), on CPU ones the plain
version with its softmax statistics (`fusion_fwd_plain`) and the plain
backward (`fused_bi_attention_bwd_plain`).  fusion_fwd's registered autograd
formula saves its outputs and statistics and calls fusion_bwd, so
`fused_bi_attention` calls the op whether or not a gradient is needed.
`fused_bi_attention_bwd` is K4's launcher and takes CUDA tensors only.
`fused_bi_attention.launches` and `fused_bi_attention_bwd.launches` count
the kernels' f32 launches, `.launches_bf16` their bf16 ones.

The operands are all f32 or all bf16.  In bf16 the kernels compute what the
TPU kernels compute on bf16 operands (ops/fusion_pallas.py): logits and
softmax statistics in f32, each product on bf16 operands with f32
accumulation, the image side's probabilities P_v (and K4's dL) rounded to
bf16 as the TPU kernel casts them, outputs in bf16.  K2's text side sums
val_v^T . P_l in f32 as the TPU kernel does: P_l is split into a bf16 high
and low part, two tensor-core products into one f32 sum.  K4's text-side
gradients are summed in f32 over the image axis and rounded once.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import build, library
from .library import fusion_flops, kernel_rows, vjp_on_fresh_thread

HEAD_DIM = 256  # the kernels' one head dim: fusion E = 1024, H = 4
IMAGE_TOKENS_PER_SPLIT = 640  # image-axis split of the text-side passes


def fused_bi_attention_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads):
    """The literal formulation of the JAX package's models/layers.py:166-200:
    materialized logits, global-max shift, +-50000 clamps, masked softmaxes.
    Both max shifts are constants to autograd, as `stop_gradient` makes them
    in the JAX package.  For bf16 operands, the TPU kernel's arithmetic
    (ops/fusion_pallas.py:85-120): f32 logits and softmaxes, the image-side
    probabilities rounded to bf16 ahead of P_v . val_l, the text side's
    val_v^T . P_l in f32, the outputs rounded to bf16."""
    return _fusion_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads, stats=False)


def fusion_fwd_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads):
    """K2's four outputs: the plain version's (out_v, out_l) and the softmax
    statistics K2 writes for K4, lse_v (B, H, Nv) each image row's
    log-sum-exp of q . k over the live text, lse_l (B, H, Nl) each text
    column's over the live image tokens (+inf where none is live), f32."""
    return _fusion_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads, stats=True)


def _fusion_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads, stats: bool):
    B, Nv, E = q.shape
    Nl = k.shape[1]
    H = num_heads
    D = E // H
    dt = q.dtype
    raw = torch.einsum(
        "bvhd,blhd->bhvl", q.float().reshape(B, Nv, H, D), k.float().reshape(B, Nl, H, D)
    )
    logits = raw - raw.max().detach()
    logits = logits.clamp(-50000.0, 50000.0)

    logits_t = logits.transpose(-1, -2)                      # (B, H, Nl, Nv)
    logits_l = logits_t - logits_t.amax(dim=-1, keepdim=True).detach()
    logits_l = logits_l.clamp(-50000.0, 50000.0)
    logits_l = logits_l.masked_fill(mask_v[:, None, None, :], -1e9)
    attn_l = torch.softmax(logits_l, dim=-1)

    logits = logits.masked_fill(mask_l[:, None, None, :], -1e9)
    attn_v = torch.softmax(logits, dim=-1).to(dt).float()

    out_v = torch.einsum("bhvl,blhd->bvhd", attn_v, val_l.float().reshape(B, Nl, H, D))
    out_l = torch.einsum("bhlv,bvhd->blhd", attn_l, val_v.float().reshape(B, Nv, H, D))
    out_v, out_l = out_v.reshape(B, Nv, E).to(dt), out_l.reshape(B, Nl, E).to(dt)
    if not stats:
        return out_v, out_l
    inf = float("inf")
    lse_v = torch.logsumexp(raw.masked_fill(mask_l[:, None, None, :], -inf), dim=-1)
    lse_l = torch.logsumexp(raw.masked_fill(mask_v[:, None, :, None], -inf), dim=-2)
    lse_v = torch.where((~mask_l).any(-1)[:, None, None], lse_v, inf)
    lse_l = torch.where((~mask_v).any(-1)[:, None, None], lse_l, inf)
    return out_v, out_l, lse_v, lse_l


def fused_bi_attention_bwd_plain(q, k, val_v, val_l, mask_v, mask_l, g_ov, g_ol, num_heads):
    """(gq, gk, gvv, gvl): for f32 operands, the plain version's gradient by
    autograd; for bf16 ones, the TPU backward kernel's arithmetic
    (ops/fusion_pallas.py:_fused_bwd_kernel :198-280, wrapper :291-320,
    :395-396): P_v and P_l in f32, the four products G1, G2, then gq, gk,
    gvv, gvl on bf16 operands (g_ov, g_ol, dL, P_l and P_v rounded to bf16)
    with f32 sums, rounded to bf16 at the end.  Padded text columns take
    their column softmax on their raw logits, as the plain forward does."""
    if q.dtype == torch.bfloat16:
        return _fusion_bwd_bf16_plain(q, k, val_v, val_l, mask_v, mask_l, g_ov, g_ol, num_heads)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, val_v, val_l)]
        outs = fused_bi_attention_plain(*leaves, mask_v, mask_l, num_heads)
        return torch.autograd.grad(outs, leaves, (g_ov, g_ol))


def _fusion_bwd_bf16_plain(q, k, val_v, val_l, mask_v, mask_l, g_ov, g_ol, num_heads):
    B, Nv, E = q.shape
    Nl = k.shape[1]
    H = num_heads
    D = E // H
    bf = torch.bfloat16
    heads = lambda t, n: t.float().reshape(B, n, H, D)
    qh, kh, vv, vl = heads(q, Nv), heads(k, Nl), heads(val_v, Nv), heads(val_l, Nl)
    gov, gol = heads(g_ov, Nv), heads(g_ol, Nl)
    out_v, out_l = fused_bi_attention_plain(q, k, val_v, val_l, mask_v, mask_l, num_heads)
    logits = torch.einsum("bvhd,blhd->bhvl", qh, kh)
    p_v = torch.softmax(logits.masked_fill(mask_l[:, None, None, :], -1e9), dim=-1)
    p_l = torch.softmax(logits.masked_fill(mask_v[:, None, :, None], -1e9), dim=2)
    g1 = torch.einsum("bvhd,blhd->bhvl", gov, vl)
    g2 = torch.einsum("bvhd,blhd->bhvl", vv, gol)
    rv = (gov * heads(out_v, Nv)).sum(-1).transpose(1, 2)[..., None]    # (B, H, Nv, 1)
    cl = (gol * heads(out_l, Nl)).sum(-1).transpose(1, 2)[:, :, None]   # (B, H, 1, Nl)
    dl = (p_v * (g1 - rv) + p_l * (g2 - cl)).to(bf).float()
    gq = torch.einsum("bhvl,blhd->bvhd", dl, kh)
    gk = torch.einsum("bhvl,bvhd->blhd", dl, qh)
    gvv = torch.einsum("bhvl,blhd->bvhd", p_l.to(bf).float(), gol)
    gvl = torch.einsum("bhvl,bvhd->blhd", p_v.to(bf).float(), gov)
    return tuple(t.reshape(t.shape[0], t.shape[1], E).to(bf) for t in (gq, gk, gvv, gvl))


_FWD_CTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_BWD_CTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check(name: str, t: torch.Tensor, shape, like: torch.Tensor) -> None:
    """Shape, device and (but for the bool masks) q's dtype, f32 or bf16,
    contiguous and 16-byte aligned."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if name.startswith("mask"):
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool")
    elif (like.dtype not in (torch.float32, torch.bfloat16) or t.dtype != like.dtype
          or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be float32 or bfloat16 as q is, contiguous and 16-byte "
                         f"aligned; got {t.dtype} (q {like.dtype})")


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

    bf16 = q.dtype == torch.bfloat16
    lib = build.load("fusion_fwd")
    fn = lib.fusion_fwd_bf16 if bf16 else lib.fusion_fwd_f32
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
    if bf16:
        fused_bi_attention.launches_bf16 += 1
    else:
        fused_bi_attention.launches += 1
    return out_v, out_l, lse_v, lse_l


def fused_bi_attention_bwd(q, k, val_v, val_l, mask_v, mask_l, out_v, out_l, lse_v, lse_l,
                           g_ov, g_ol, num_heads: int):
    """K4 on CUDA tensors (all f32 or all bf16 but the f32 lse_*, contiguous;
    out_* and lse_* from K2); raises for any other.  Returns (gq, gk, gvv,
    gvl) in the operands' dtype."""
    B, Nv, Nl, E, H, n_splits = _geometry(q, k, num_heads, "fused_bi_attention_bwd")
    for name, t, shape in (("q", q, (B, Nv, E)), ("k", k, (B, Nl, E)),
                           ("val_v", val_v, (B, Nv, E)), ("val_l", val_l, (B, Nl, E)),
                           ("mask_v", mask_v, (B, Nv)), ("mask_l", mask_l, (B, Nl)),
                           ("out_v", out_v, (B, Nv, E)), ("out_l", out_l, (B, Nl, E)),
                           ("g_ov", g_ov, (B, Nv, E)), ("g_ol", g_ol, (B, Nl, E))):
        _check(name, t, shape, q)
    for name, t, shape in (("lse_v", lse_v, (B, H, Nv)), ("lse_l", lse_l, (B, H, Nl))):
        _check(name, t, shape, lse_v)
    D = E // H
    dev = q.device
    # the row-softmax and column-softmax correction terms, as the JAX package
    # computes them outside its kernel (ops/fusion_pallas.py:291-320)
    rv = (g_ov.float() * out_v.float()).view(B, Nv, H, D).sum(-1).transpose(1, 2).contiguous()
    cl = (g_ol.float() * out_l.float()).view(B, Nl, H, D).sum(-1).transpose(1, 2).contiguous()
    gq, gvv = torch.empty_like(q), torch.empty_like(val_v)
    gk, gvl = torch.empty_like(k), torch.empty_like(val_l)
    part_k = torch.empty(B, H, n_splits, Nl, D, dtype=torch.float32, device=dev)
    part_vl = torch.empty_like(part_k)
    pad_v, pad_l = _pads(mask_v, mask_l)

    bf16 = q.dtype == torch.bfloat16
    lib = build.load("fusion_bwd")
    fn = lib.fusion_bwd_bf16 if bf16 else lib.fusion_bwd_f32
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
    if bf16:
        fused_bi_attention_bwd.launches_bf16 += 1
    else:
        fused_bi_attention_bwd.launches += 1
    return gq, gk, gvv, gvl


@torch.library.custom_op("ogd_torch::fusion_fwd", mutates_args=(), device_types="cuda")
def fusion_fwd(q: torch.Tensor, k: torch.Tensor, val_v: torch.Tensor, val_l: torch.Tensor,
               mask_v: torch.Tensor, mask_l: torch.Tensor, num_heads: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 as an op: (out_v, out_l, lse_v (B, H, Nv) f32, lse_l (B, H, Nl)
    f32); on CUDA tensors the kernel, counted on
    fused_bi_attention.launches(_bf16).  Its split partials stay inside.
    Its gradient is K4's op (`fusion_bwd_op`); the statistics carry none."""
    return library.kernel_output("fusion_fwd", _fusion_fwd_cuda, q, k, val_v, val_l, mask_v,
                                 mask_l, num_heads)


@fusion_fwd.register_kernel("cpu")
def _fusion_fwd_cpu(q, k, val_v, val_l, mask_v, mask_l, num_heads):
    return library.kernel_output("fusion_fwd", fusion_fwd_plain, q, k, val_v, val_l, mask_v,
                                 mask_l, num_heads)


@fusion_fwd.register_fake
def _fusion_fwd_fake(q, k, val_v, val_l, mask_v, mask_l, num_heads):
    B, Nv, _ = q.shape
    Nl = k.shape[1]
    return (torch.empty_like(q), torch.empty_like(k),
            q.new_empty(B, num_heads, Nv, dtype=torch.float32),
            q.new_empty(B, num_heads, Nl, dtype=torch.float32))


@torch.library.custom_op("ogd_torch::fusion_bwd", mutates_args=(), device_types="cuda")
def fusion_bwd_op(q: torch.Tensor, k: torch.Tensor, val_v: torch.Tensor, val_l: torch.Tensor,
                  mask_v: torch.Tensor, mask_l: torch.Tensor, out_v: torch.Tensor,
                  out_l: torch.Tensor, lse_v: torch.Tensor, lse_l: torch.Tensor,
                  g_ov: torch.Tensor, g_ol: torch.Tensor, num_heads: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 as an op: (gq, gk, gvv, gvl); on CUDA tensors the kernel
    (`fused_bi_attention_bwd`), counted on fused_bi_attention_bwd.launches(_bf16)."""
    return fused_bi_attention_bwd(q, k, val_v, val_l, mask_v, mask_l, out_v, out_l, lse_v, lse_l,
                                  g_ov, g_ol, num_heads)


@fusion_bwd_op.register_kernel("cpu")
def _fusion_bwd_cpu(q, k, val_v, val_l, mask_v, mask_l, out_v, out_l, lse_v, lse_l, g_ov, g_ol,
                    num_heads):
    grads = vjp_on_fresh_thread(fused_bi_attention_bwd_plain, q, k, val_v, val_l, mask_v, mask_l,
                                g_ov, g_ol, num_heads)
    return tuple(t.contiguous() for t in grads)


@fusion_bwd_op.register_fake
def _fusion_bwd_fake(q, k, val_v, val_l, mask_v, mask_l, out_v, out_l, lse_v, lse_l, g_ov, g_ol,
                     num_heads):
    return tuple(torch.empty_like(t) for t in (q, k, val_v, val_l))


def _fusion_fwd_setup(ctx, inputs, output):
    q, k, val_v, val_l, mask_v, mask_l, num_heads = inputs
    ctx.num_heads = num_heads
    ctx.mark_non_differentiable(output[2], output[3])
    ctx.save_for_backward(q, k, val_v, val_l, mask_v, mask_l, *output)


def _fusion_fwd_backward(ctx, g_ov, g_ol, g_lse_v, g_lse_l):
    """K4 (the JAX package's custom_vjp `_fused_core`,
    ops/fusion_pallas.py:362-400) on K2's outputs and softmax statistics."""
    saved = ctx.saved_tensors
    dt = saved[0].dtype
    grads = fusion_bwd_op(*saved, kernel_rows(g_ov, dt), kernel_rows(g_ol, dt), ctx.num_heads)
    return (*grads, None, None, None)


fusion_fwd.register_autograd(_fusion_fwd_backward, setup_context=_fusion_fwd_setup)


@register_flop_formula(torch.ops.ogd_torch.fusion_fwd, get_raw=True)
def _fusion_fwd_flops(q, k, val_v, val_l, mask_v, mask_l, num_heads, out_val=None):
    return fusion_flops(q, k, mask_v, mask_l, backward=False)


@register_flop_formula(torch.ops.ogd_torch.fusion_bwd, get_raw=True)
def _fusion_bwd_flops(q, k, val_v, val_l, mask_v, mask_l, *rest, out_val=None):
    return fusion_flops(q, k, mask_v, mask_l, backward=True)


def fused_bi_attention(q, k, val_v, val_l, mask_v, mask_l, num_heads: int):
    """K2 (K4 for its gradient) for CUDA tensors (all f32 or all bf16,
    contiguous), the plain versions for CPU tensors; through the ops either
    way.  Returns (out_v, out_l)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_bi_attention: unsupported device {q.device}")
    return fusion_fwd(q, k, val_v, val_l, mask_v, mask_l, num_heads)[:2]


fused_bi_attention.launches = fused_bi_attention.launches_bf16 = 0
fused_bi_attention_bwd.launches = fused_bi_attention_bwd.launches_bf16 = 0
