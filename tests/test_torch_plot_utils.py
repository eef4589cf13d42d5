"""The port's utils/plot_utils.py against the JAX package's on the same
log.txt files: every subplot's plotted series (x and y, exactly), its
labels and titles, with and without the exponential smoothing, epochs that
lack a field skipped; the P/R plot's curves and axes.  Both draw with
matplotlib's Agg backend on the host.
"""
import ast
import json
import os

import pytest

from open_groundingdino_tpu.utils import plot_utils as jax_plot
from open_groundingdino_tpu_torch.utils import plot_utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "open_groundingdino_tpu")


def test_module_imports_no_jax():
    tree = ast.parse(open(os.path.join(ROOT, "open_groundingdino_tpu_torch", "utils",
                                       "plot_utils.py")).read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert not roots & set(FORBIDDEN)


def _write_run(path, seed):
    """A main-style log.txt: one JSON line an epoch, AP only on eval epochs."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "log.txt"), "w") as f:
        for epoch in range(6):
            rec = {"epoch": epoch, "loss": 10.0 / (epoch + 1) + seed, "loss_bbox": 0.5 - 0.05 * epoch,
                   "grad_norm": 3.0 + seed * epoch}
            if epoch % 2:
                rec["AP"] = 0.1 * epoch + 0.01 * seed
            f.write(json.dumps(rec) + "\n")


def _series(axes):
    return [(ax.get_title(), ax.get_xlabel(),
             [(line.get_label(), list(line.get_xdata()), list(line.get_ydata()))
              for line in ax.get_lines()]) for ax in axes]


@pytest.mark.parametrize("fields,ewm_com", [(("loss", "loss_bbox", "AP"), 0.0),
                                            (("loss", "AP"), 1.5), (("grad_norm",), 0.0)],
                         ids=["default", "smoothed", "one-field"])
def test_plot_logs_equals_jax(tmp_path, fields, ewm_com):
    import matplotlib.pyplot as plt

    runs = [str(tmp_path / "run_a"), str(tmp_path / "run_b")]
    for seed, run in enumerate(runs):
        _write_run(run, seed)
    fig, axes = plot_utils.plot_logs(runs, fields=fields, ewm_com=ewm_com)
    jfig, jaxes = jax_plot.plot_logs(runs, fields=fields, ewm_com=ewm_com)
    assert len(axes) == len(fields)
    got, want = _series(axes), _series(jaxes)
    assert got == want
    assert [label for label, _, _ in got[0][2]] == ["run_a", "run_b"]
    plt.close(fig)
    plt.close(jfig)


def test_plot_logs_missing_log(tmp_path):
    with pytest.raises(FileNotFoundError, match="log.txt"):
        plot_utils.plot_logs(str(tmp_path))


def test_plot_precision_recall_equals_jax():
    import matplotlib.pyplot as plt

    curves = [("ours", [0.0, 0.5, 1.0], [1.0, 0.8, 0.3]), ("ema", [0.0, 1.0], [0.9, 0.2])]
    fig, ax = plot_utils.plot_precision_recall(curves)
    jfig, jax_ax = jax_plot.plot_precision_recall(curves)
    assert _series([ax]) == _series([jax_ax])
    assert (ax.get_xlim(), ax.get_ylim(), ax.get_ylabel()) == (jax_ax.get_xlim(), jax_ax.get_ylim(),
                                                               jax_ax.get_ylabel())
    plt.close(fig)
    plt.close(jfig)
