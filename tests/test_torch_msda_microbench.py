"""The port's MSDA microbench (open_groundingdino_tpu_torch/tools/msda_microbench.py).

  * Its `make_operands` is the JAX package's tools/msda_microbench.py
    operand code (lines 59-92, transcribed below at a tiny shape): the same
    seeded numpy draws in the same order, so both tools time the same
    inputs.
  * One run of every path on CPU tensors at a tiny shape (the kernels'
    plain versions): each path times and the banded op agrees with the
    plain op, in f32 and with a bf16 value (K5 and K8, K3 and K9 under
    --bwd), there within one bf16 step of the plain op.
"""
import numpy as np

from open_groundingdino_tpu_torch.tools import msda_microbench as mm

TINY = ((6, 8), (3, 4), (2, 2), (1, 1))


def _jax_tool_operands(shapes, B, H, D, P, spread, jitter):
    """The JAX tool's operand code, before its TPU-only interleaved query
    order."""
    L = sum(h * w for h, w in shapes)
    Q = L
    rng = np.random.RandomState(0)
    value = rng.randn(B, L, H, D).astype(np.float32)
    ref = []
    for (h, w) in shapes:
        ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        ref.append(np.stack([xs, ys], -1).reshape(-1, 2))
    ref = np.concatenate(ref, 0)
    theta = np.arange(H) * (2 * np.pi / H)
    grid = np.stack([np.cos(theta), np.sin(theta)], -1)
    grid /= np.abs(grid).max(-1, keepdims=True)
    bias = grid[:, None, :] * (np.arange(P) + 1)[None, :, None]
    bias = np.tile(bias[:, None], (1, len(shapes), 1, 1))
    offs = (bias[None, None] * spread
            + rng.randn(B, Q, H, len(shapes), P, 2) * jitter).astype(np.float32)
    wh = np.asarray([[w, h] for h, w in shapes], np.float32)
    locs = ref[None, :, None, None, None, :] + (offs / wh[None, None, None, :, None, :])
    attn = rng.rand(B, Q, H, len(shapes), P).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    return value, locs.astype(np.float32), attn


def test_operands_are_the_jax_tools():
    got = mm.make_operands(1.5, 0.25, TINY, batch=2, heads=3, head_dim=4, points=2)
    want = _jax_tool_operands(TINY, 2, 3, 4, 2, 1.5, 0.25)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert mm.make_operands()[1].shape == (4, 20197, 8, 4, 4, 2)   # the flagship's shapes


def test_one_timed_run_on_the_cpu(capsys):
    args = mm.get_args_parser().parse_args(
        ["--device", "cpu", "--iters", "1", "--repeats", "1", "--sweep", "--fwd_variant",
         "corner", "--banded_mp", "0", "--bwd", "--xla", "--profile"])
    res = mm.run(args, shapes=TINY, batch=1)
    names = ["banded fwd (K5)", "banded fwd+bwd (K5)", "sweep fwd (K8)", "sweep fwd+bwd (K8)",
             "xla fwd (plain)"]
    assert all(res[n] > 0 for n in names) and set(res["profiles"]) == set(names)
    assert res["max_abs_diff"] < 1e-5
    out = capsys.readouterr().out
    assert all(f"{n}: " in out for n in names) and "max abs diff banded vs plain" in out


def test_one_bf16_run_on_the_cpu():
    """--dtype bf16 on the K5 and K8 paths with their backwards: finite
    times, and the banded op (f32 sums rounded to bf16 once) within one bf16
    step of the plain op (the same sums in another order, rounded once) on
    the bf16 value: 2^-7 of the largest output, at most the value's largest
    |element| (each output is a weighted mean of value rows)."""
    args = mm.get_args_parser().parse_args(
        ["--device", "cpu", "--iters", "1", "--repeats", "1", "--dtype", "bf16", "--sweep",
         "--fwd_variant", "corner", "--banded_mp", "0", "--bwd", "--xla"])
    res = mm.run(args, shapes=TINY, batch=1)
    names = ["banded fwd (K5)", "banded fwd+bwd (K5)", "sweep fwd (K8)", "sweep fwd+bwd (K8)",
             "xla fwd (plain)"]
    assert all(np.isfinite(res[n]) and res[n] > 0 for n in names)
    value = mm.make_operands(shapes=TINY, batch=1)[0]
    assert res["max_abs_diff"] <= 2.0 ** -7 * float(np.abs(value).max())   # one bf16 step
