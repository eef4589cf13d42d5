"""The port's ports of the JAX package's last tools, at nano size on the CPU,
in-process: tools/benchmark.py (forward and --train), profile.py,
matcher_microbench.py and opt_microbench.py, each printing the JAX tool's
keys (serving_bench.py and eval_pipeline_bench.py run in
tests/test_torch_tools_serving.py).

  * Each tool runs and prints (or writes) the JAX tool's output: its JSON
    keys, its summary lines.
  * eval_pipeline_bench's `build_workspace` writes the JAX tool's files byte
    for byte (the JAX module imports JAX only inside its main).
  * matcher_microbench's seeded inputs equal the JAX tool's, captured from
    its main as it uploads them (nothing compiled), at a reduced
    S/B/Q/G/T; the port's cost build on them against the JAX
    `compute_cost_matrix` within 1e-5 (f32; its logits sit around -3, far
    from the sigmoid's saturation, where XLA:CPU's jit turns a class cost
    into NaN: ROADMAP section 3).
  * FlopCounterMode on a nano forward and backward counts each ogd_torch op
    by its formula (ops/library.py) on the operands it was called with; the
    in-map corner count against a brute-force count.
"""
import ast
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from open_groundingdino_tpu_torch.config import SLConfig
from open_groundingdino_tpu_torch.ops import library
from open_groundingdino_tpu_torch.tools import (benchmark, eval_pipeline_bench, matcher_microbench,
                                                opt_microbench, profile)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "open_groundingdino_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "open_groundingdino_tpu")
TOOLS = ("benchmark", "profile", "serving_bench", "eval_pipeline_bench", "matcher_microbench",
         "opt_microbench")
NANO_CFG = """
_base_ = "{base}"
backbone = "swin_nano_test"
hidden_dim = 32
nheads = 4
enc_layers = 1
dec_layers = 1
dim_feedforward = 64
num_queries = 12
max_text_len = 16
bert_vocab_size = 40
bert_hidden_size = 32
bert_layers = 1
bert_heads = 4
bert_intermediate = 32
bert_max_position = 32
image_buckets = [(64, 96)]
use_checkpoint = False
use_transformer_ckpt = False
"""


def _jax_tool(name):
    """The JAX package's tools/<name>.py as a module (its imports of JAX sit
    inside its main)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "nano.py"
    path.write_text(NANO_CFG.format(base=os.path.join(PKG, "config", "cfg_coco.py")))
    return str(path)


def _cfg(cfg_path):
    return SLConfig.fromfile(cfg_path)


def test_tools_import_no_jax():
    """The tools import nothing of JAX or the JAX package (an AST scan;
    tests/test_torch_imports.py imports them all)."""
    for name in TOOLS:
        tree = ast.parse(open(os.path.join(PKG, "tools", f"{name}.py")).read())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert not roots & set(FORBIDDEN), name


# ---------------------------------------------------------------- benchmark
FWD_KEYS = {"nparam", "flops_per_forward", "gflops", "time_s", "fps", "shape", "platform"}
TRAIN_KEYS = {"mode", "nparam", "compute_dtype", "step_time_s", "steps_per_call", "imgs_per_sec",
              "loss", "shape", "platform"}


def test_benchmark_forward_and_train(cfg_path, tmp_path, capsys):
    ap = benchmark.get_args_parser()
    common = ["-o", str(tmp_path), "--height", "64", "--width", "96", "--iters", "1",
              "--device", "cpu"]
    fwd = benchmark.run(ap.parse_args(common + ["--warmup", "0"]), _cfg(cfg_path))
    assert FWD_KEYS <= set(fwd) and fwd["platform"] == "cpu" and fwd["shape"] == [1, 64, 96]
    assert fwd["flops_per_forward"] > 0 and set(fwd["kernel_flops"]) == {"msda_fwd", "fusion_fwd"}
    with open(tmp_path / "flops" / "log.txt") as f:
        assert json.load(f) == json.loads(json.dumps(fwd))
    train = benchmark.run(ap.parse_args(common + ["--warmup", "1", "--train", "--batch", "2",
                                                  "--compute_dtype", "float32"]), _cfg(cfg_path))
    assert TRAIN_KEYS <= set(train) and train["compute_dtype"] == "float32"
    assert np.isfinite(train["loss"]) and train["flops_per_step"] > fwd["flops_per_forward"]
    # K3's and K4's formulas count in the step, K1's and K2's in its forward
    assert {"msda_fwd", "fusion_fwd", "msda_bwd", "fusion_bwd"} <= set(train["kernel_flops"])
    assert all(n > 0 for n in train["kernel_flops"].values())
    printed = capsys.readouterr().out
    assert '"flops_per_forward"' in printed and '"step_time_s"' in printed
    # --steps_per_call 2: one call takes two optimizer steps on the batch stacked
    # two deep (the JAX tool's), and the printed line says so
    multi = benchmark.run(ap.parse_args(common + ["--warmup", "1", "--train", "--batch", "2",
                                                  "--compute_dtype", "float32",
                                                  "--steps_per_call", "2"]), _cfg(cfg_path))
    assert TRAIN_KEYS <= set(multi) and multi["steps_per_call"] == 2
    assert np.isfinite(multi["loss"]) and multi["flops_per_step"] > fwd["flops_per_forward"]
    assert '"steps_per_call": 2' in capsys.readouterr().out


def test_profile_forward(cfg_path, tmp_path, capsys):
    args = profile.get_args_parser().parse_args(
        ["-o", str(tmp_path), "--height", "64", "--width", "96", "--batch", "1", "--iters", "1",
         "--device", "cpu"])
    r = profile.run(args, _cfg(cfg_path))
    out = capsys.readouterr().out
    assert os.path.getsize(r["trace"]) > 0 and "fwd trace ->" in out
    assert "ms/iter across" in out and "fwd: " in out and "ms/batch" in out
    assert 0 < len(r["summary"]["buckets"]) <= 30 and r["summary"]["device_ms_per_iter"] > 0


# ---------------------------------------------------------------- eval pipeline workspace
def test_build_workspace_equals_jax_tool(tmp_path):
    jax_tool = _jax_tool("eval_pipeline_bench")
    assert eval_pipeline_bench.COCO_CATS == jax_tool.COCO_CATS
    cats = eval_pipeline_bench.COCO_CATS[:6]
    assert eval_pipeline_bench.make_vocab(cats) == jax_tool.make_vocab(cats)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    eval_pipeline_bench.build_workspace(str(ours), 3, (64, 80), cats)
    jax_tool.build_workspace(str(theirs), 3, (64, 80), cats)
    files = sorted(os.path.relpath(os.path.join(d, f), theirs)
                   for d, _, fs in os.walk(theirs) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ours)
                           for d, _, fs in os.walk(ours) for f in fs)
    assert len(files) == 5
    for rel in files:
        assert (ours / rel).read_bytes() == (theirs / rel).read_bytes(), rel


# ---------------------------------------------------------------- matcher and optimizer
SMALL = dict(S=2, B=2, Q=30, G=8, T=16, n_real_gt=3)


def test_matcher_inputs_and_costs_equal_jax_tool(monkeypatch):
    import jax

    from open_groundingdino_tpu.models.matcher import compute_cost_matrix

    captured = []

    class Uploaded(Exception):
        pass

    def device_put(x, *a, **k):
        captured.append(np.asarray(x))
        if len(captured) == 5:
            raise Uploaded
        return x

    argv = ["matcher_microbench"] + [f"--{k}={v}" for k, v in SMALL.items()]
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(jax, "device_put", device_put)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent")
    with pytest.raises(Uploaded):
        _jax_tool("matcher_microbench").main()
    ours = matcher_microbench.seeded_inputs(**SMALL)
    for got, want in zip(ours, captured):
        np.testing.assert_array_equal(got, want)
    costs = matcher_microbench.build_costs(*(torch.from_numpy(a) for a in ours)).numpy()
    for s in range(SMALL["S"]):
        want = np.asarray(compute_cost_matrix(*(a[s] if i < 2 else a
                                                for i, a in enumerate(captured))))
        np.testing.assert_allclose(costs[s], want, rtol=1e-5, atol=1e-5)


def test_matcher_and_opt_microbench(cfg_path, capsys):
    ap = matcher_microbench.get_args_parser()
    small = [f"--{k}={v}" for k, v in SMALL.items()] + ["--iters", "1", "--repeats", "1",
                                                        "--device", "cpu"]
    for flag, label in (([], "cost build + assign"), (["--costs_only"], "cost build"),
                        (["--assign_only"], "assign")):
        assert matcher_microbench.run(ap.parse_args(small + flag))["label"] == label
    out = capsys.readouterr().out
    assert "cost build + assign (S=2 B=2 Q=30 G=8 T=16): " in out and "(min of 1)" in out
    r = opt_microbench.run(opt_microbench.get_args_parser().parse_args(
        ["--iters", "1", "--repeats", "1", "--device", "cpu", "--ema"]), _cfg(cfg_path))
    out = capsys.readouterr().out
    assert out.startswith("params: ") and f"in {r['leaves']} leaves" in out
    assert "optimizer update: " in out and "ms/step (min of 1)" in out
    assert "EMA update: masked " in out and r["ema_ms"] > 0 and r["ema_inplace_ms"] > 0


# ---------------------------------------------------------------- FLOP formulas
def _brute_corners(locs, shapes):
    """Each sample's in-map corners one by one, in f32 as the kernels take
    the pixel position."""
    n = 0
    half = np.float32(0.5)
    for lvl, (h, w) in enumerate(shapes):
        for x, y in locs[..., lvl, :, :].reshape(-1, 2):
            x0, y0 = np.floor(x * np.float32(w) - half), np.floor(y * np.float32(h) - half)
            n += sum(0 <= x0 + dx < w and 0 <= y0 + dy < h for dx in (0, 1) for dy in (0, 1))
    return n


def test_flop_counter_counts_each_op_by_its_formula(cfg_path):
    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "ogd_torch":
                calls.append((func.__name__.split(".")[0], args))
            return func(*args, **(kwargs or {}))

    cfg = _cfg(cfg_path)
    model = benchmark.build_model(cfg, "cpu")
    inputs = {k: torch.from_numpy(v) for k, v in benchmark.synthetic_inputs(
        1, 64, 96, 16, 40).items()}
    with FlopCounterMode(display=False) as counter, Record():
        out = model(**inputs)
        (out["pred_boxes"].sum() + out["pred_logits"].sum()).backward()
    counted = {str(op).split(".")[-1]: n for op, n in counter.get_flop_counts()["Global"].items()
               if str(op).startswith("ogd_torch.")}
    want = {}
    for name, args in calls:
        if name in ("msda_fwd", "msda_bwd"):
            value, flat, _, locs = args[:4]
            B, Q, H, NL, P, _ = locs.shape
            n = library.msda_flops(B * Q * H * NL * P,
                                   library.in_map_corners(locs, library.shape_pairs(flat)),
                                   value.shape[-1], 2 if name == "msda_fwd" else 8)
        else:
            q, k, _, _, mask_v, mask_l = args[:6]
            n = library.fusion_flops(q, k, mask_v, mask_l, backward=name == "fusion_bwd")
        want[name] = want.get(name, 0) + n
    assert set(want) == {"msda_fwd", "msda_bwd", "fusion_fwd", "fusion_bwd"}
    assert counted == want
    locs = next(a for n, a in calls if n == "msda_fwd")[3]
    shapes = library.shape_pairs(next(a for n, a in calls if n == "msda_fwd")[1])
    assert library.in_map_corners(locs, shapes) == _brute_corners(locs.detach().numpy(), shapes)
