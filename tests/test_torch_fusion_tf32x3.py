"""The precision of the fusion kernels' tensor-core products, emulated on the
CPU.

K2 (csrc/fusion_fwd.cu) and K4 (csrc/fusion_bwd.cu) take every product on
the tensor cores in 3xTF32: each f32 operand x is split into
hi = tf32(x) and lo = tf32(x - hi), rounded to nearest (ties away from
zero, as `cvt.rna.tf32.f32`), and a.b is taken as
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with f32 accumulation.  Here the same
products run in PyTorch on the CPU, through the function the kernels
compute (logits, masked row and column softmaxes, the four forward and
backward products of each direction), at the flagship head width (D = 256,
E = 1024, H = 4), on phase 4's operand distribution (chip_smoke.py: q
scaled by D^-0.5) for a B = 2 batch of a few hundred image tokens, each
image with its own padding, with padded text.  Against the f32 plain
versions, the forward must stay within the smoke's K2_TOL (abs) and the
gradients within its K4_RTOL (of each gradient's largest |reference|), with
a margin of 10; one TF32 pass (hi.hi only) must miss them.
"""
import numpy as np
import pytest
import torch

from chip_smoke import K2_TOL, K4_RTOL
from open_groundingdino_tpu_torch.ops import fusion

B, NV, NL, E, H = 2, 300, 256, 1024, 4
D = E // H
LIVE_V, LIVE_L = (300, 233), (41, 187)
MARGIN = 10.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 mantissa bits): nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def _inputs():
    rng = np.random.RandomState(0)
    q = rng.randn(B, NV, E).astype(np.float32) * D ** -0.5
    k, val_l, g_ol = (rng.randn(B, NL, E).astype(np.float32) for _ in range(3))
    val_v, g_ov = (rng.randn(B, NV, E).astype(np.float32) for _ in range(2))
    mask_v = np.arange(NV)[None] >= np.array(LIVE_V)[:, None]
    mask_l = np.arange(NL)[None] >= np.array(LIVE_L)[:, None]
    t = [torch.from_numpy(x) for x in (q, k, val_v, val_l, mask_v, mask_l, g_ov, g_ol)]
    return t[:6], t[6:]


def _heads(x):
    return x.view(x.shape[0], x.shape[1], H, D).transpose(1, 2)   # (B, H, N, D)


def _merge(x):
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], E)


def emulated(args, grads, mm):
    """The kernels' forward (K2) and backward (K4) formulas with every
    product taken by `mm`: (out_v, out_l, gq, gk, gvv, gvl)."""
    q, k, val_v, val_l, mask_v, mask_l = args
    g_ov, g_ol = grads
    qh, kh, vvh, vlh = map(_heads, (q, k, val_v, val_l))
    s = mm(qh, kh.transpose(-1, -2))                                    # (B, H, Nv, Nl)
    p_v = torch.softmax(s.masked_fill(mask_l[:, None, None, :], -float("inf")), -1)
    p_l = torch.softmax(s.masked_fill(mask_v[:, None, :, None], -float("inf")), -2)
    out_v, out_l = mm(p_v, vlh), mm(p_l.transpose(-1, -2), vvh)
    gvh, glh = _heads(g_ov), _heads(g_ol)
    rv = (gvh * _heads(_merge(out_v))).sum(-1, keepdim=True)
    cl = (glh * _heads(_merge(out_l))).sum(-1)[:, :, None, :]
    x, y = mm(gvh, vlh.transpose(-1, -2)), mm(vvh, glh.transpose(-1, -2))
    dl = p_v * (x - rv) + p_l * (y - cl)
    gq, gk = mm(dl, kh), mm(dl.transpose(-1, -2), qh)
    gvv, gvl = mm(p_l, glh), mm(p_v.transpose(-1, -2), gvh)
    return tuple(map(_merge, (out_v, out_l, gq, gk, gvv, gvl)))


def _errors(args, grads, mm):
    """(forward max abs error, [each gradient's max abs error / max|ref|])."""
    got = emulated(args, grads, mm)
    ref_fwd = fusion.fused_bi_attention_plain(*args, H)
    ref_bwd = fusion.fused_bi_attention_bwd_plain(*args, *grads, H)
    fwd = max(float((a - b).abs().max()) for a, b in zip(got[:2], ref_fwd))
    bwd = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(got[2:], ref_bwd)]
    return fwd, bwd


@pytest.fixture(scope="module")
def operands():
    return _inputs()


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # a tf32 value
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one + 2.0 ** -11])
    assert tf32(x).tolist() == [one, -one, 1.0, 1.0 + 2.0 ** -9]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((y - hi) / y).abs().max()) <= 2.0 ** -11


def test_3xtf32_meets_the_smoke_tolerances(operands):
    fwd, bwd = _errors(*operands, mm_3xtf32)
    assert fwd * MARGIN <= K2_TOL, fwd
    assert max(bwd) * MARGIN <= K4_RTOL, bwd


def test_one_tf32_pass_misses_them(operands):
    fwd, bwd = _errors(*operands, mm_1xtf32)
    assert fwd > K2_TOL, fwd
    assert max(bwd) > K4_RTOL, bwd
