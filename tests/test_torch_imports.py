"""The port stands alone: importing every module of open_groundingdino_tpu_torch
loads neither JAX nor the JAX package, and chip_smoke.py imports neither."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "open_groundingdino_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "open_groundingdino_tpu")


def _modules():
    mods = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, PKG)):
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for f in sorted(files):
            if f.endswith(".py"):
                mods.append(rel if f == "__init__.py" else f"{rel}.{f[:-3]}")
    return sorted(mods)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


# every module of the serving, training, sweep, banded, eval, backbone, PAVE,
# serving-export, RoBERTa / zero-shot, multi-process and device-step slices and
# the tools (the JAX package's last tools among them), plot_utils and the
# profile reader:
# the walk below
# must find them all,
# and importing them must load nothing of JAX
EXPECTED = (
    "inference", "main", "engine", "ops.msda", "ops.msda_sweep", "ops.msda_banded", "ops.fusion",
    "ops.build", "tools", "tools.msda_microbench", "tools.inference_on_a_image",
    "models.resnet", "models.swin", "utils.visualizer", "utils.convert",
    "models.matcher", "models.criterion", "models.layers", "models.transformer",
    "models.postprocess", "eval", "eval.coco_eval",
    "parallel.optim", "parallel.train_state", "utils.ema", "utils.box_ops", "utils.checkpoint",
    "data.odvg", "data.loader", "data.transforms", "data.tokenization", "data.coco",
    "pave", "pave.crop_utils", "pave.metrics", "pave.engine", "pave.dmg_dataset",
    "pave.infer_utils", "pave.batch_eval", "pave.repvit_seg",
    "tools.inference_pave", "tools.get_metrics", "tools.inference_from_csv",
    "tools.inference_a_folder", "serving", "ops.library", "tools.export_model",
    "data.staging", "data.strong_aug", "utils.native", "tools.zero_shot_eval",
    "parallel.dist", "utils.logger", "utils.slio", "utils.time_counter",
    "tools.benchmark", "tools.profile", "tools.serving_bench", "tools.eval_pipeline_bench",
    "tools.matcher_microbench", "tools.opt_microbench", "utils.plot_utils", "utils.profiling",
    "utils.graph_check", "ops.lsap", "utils.device", "tools.step_ab",
)


def test_port_imports_no_jax():
    mods = _modules()
    missing = [m for m in EXPECTED if f"{PKG}.{m}" not in mods]
    assert not missing, missing
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_no_jax():
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert PKG in roots
    assert not roots & set(FORBIDDEN), sorted(roots & set(FORBIDDEN))
