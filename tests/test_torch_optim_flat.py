"""The port's AdamW (`parallel/optim.GroupedAdamW`: one f32 buffer a
parameter group, the clip over every gradient as optax's) against the JAX
package's optimizers, and the bounds of its layout.

* tests/test_optim.py's small tree as named parameters, four steps with a
  piecewise schedule and the clip active: the parameters agree after every
  step at that test's rtol 1e-5 / atol 3e-6 with the JAX default optax
  chain (OPT_FLAT=0) where the frozen group's gradients are large, and with
  the JAX flat variant (OPT_FLAT=1, whose clip skips the frozen groups)
  where they are zero; the frozen parameters never move;
* a non-finite step leaves the parameters, both moments and the count as
  they were, bit for bit;
* the guard's norm (`safe_global_norm`, multi-tensor passes) against the
  JAX package's over leaves of every scale;
* a state_dict (moments by parameter name) resumes with next updates equal
  bit for bit to the uninterrupted optimizer's;
* the ops one update dispatches (views aside, which launch nothing) are the
  same for 10 and for 100 parameter tensors of a group;
* a nano train step: its grad_norm is the per-leaf norm of its gradients,
  and a non-finite batch moves nothing.
"""
import collections

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import optax

from open_groundingdino_tpu.parallel import optim as joptim
from open_groundingdino_tpu_torch.parallel import optim

# tests/test_optim.py:69-79's tree, by the port's parameter names
SHAPES = {"backbone.w": (5, 3), "bert.e": (7,), "transformer.ref_point_head.k": (4, 2),
          "transformer.dec.k": (6,), "head.w": (2, 2)}
KW = dict(base_lr=1e-3, lr_backbone=1e-4, lr_linear_proj_mult=0.1, weight_decay=1e-4,
          clip_max_norm=0.05, frozen_keys=("head",))


def _tree(flat):
    """{name: array} -> the JAX nested dict."""
    tree = {}
    for name, x in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = x
    return tree


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}


def _opt(values, schedule=None, **kw):
    named = [(n, torch.nn.Parameter(torch.from_numpy(v.copy()))) for n, v in values.items()]
    sched = schedule or optim.piecewise_constant_schedule(1e-3, {2: 0.1})
    return named, optim.GroupedAdamW(named, sched, **{**KW, **kw})


def _update(opt, grads, finite=None):
    norm = optim.safe_global_norm(grads)
    opt.step(grads, norm, torch.isfinite(norm) if finite is None else finite)


def _against_jax(monkeypatch, opt_flat: str, frozen_scale: float):
    params = _params()
    monkeypatch.setenv("OPT_FLAT", opt_flat)
    tx = joptim.make_optimizer(_tree(params), lr=optax.piecewise_constant_schedule(1e-3, {2: 0.1}),
                               **KW)
    jparams = _tree(params)
    jstate = tx.init(jparams)
    named, opt = _opt(params)
    for step in range(4):
        grads = {n: (np.random.RandomState(10 + step).randn(*s) * (1.0 + step)).astype(np.float32)
                 for n, s in SHAPES.items()}
        for n in grads:   # "head" is in ref_point_head's name too
            if "head" in n:
                grads[n] *= frozen_scale
        updates, jstate = tx.update(_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _update(opt, [torch.from_numpy(grads[n]) for n in SHAPES])
        flat_ref = {".".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                    for kp, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
        for n, p in named:
            np.testing.assert_allclose(p.detach().numpy(), flat_ref[n], rtol=1e-5, atol=3e-6,
                                       err_msg=f"step {step} {n}")
    np.testing.assert_array_equal(dict(named)["head.w"].detach().numpy(), params["head.w"])
    assert int(opt.count) == 4


def test_matches_optax_with_frozen_gradients(monkeypatch):
    """The JAX default chain: the clip norm takes the frozen gradients,
    which here would dominate it."""
    _against_jax(monkeypatch, "0", 1e3)


def test_flat_matches_the_jax_flat_variant(monkeypatch):
    """The JAX flat variant clips over the non-frozen groups only: with zero
    frozen gradients the two clips agree."""
    _against_jax(monkeypatch, "1", 0.0)


def test_nonfinite_update_is_a_no_op():
    named, opt = _opt(_params())
    grads = [torch.randn(s, generator=torch.Generator().manual_seed(1)) for s in SHAPES.values()]
    _update(opt, grads)                                   # nonzero moments
    before = [t.detach().clone() for t in [p for _, p in named] + opt.m + opt.v]
    count = opt.count.clone()
    grads[1][0] = float("nan")
    _update(opt, grads)
    after = [p for _, p in named] + opt.m + opt.v
    for a, b in zip(after, before):
        assert torch.equal(a.detach(), b)
    assert torch.equal(opt.count, count)


def _grads(step):
    g = torch.Generator().manual_seed(20 + step)
    return [torch.randn(s, generator=g) * 10.0 ** (step - 1) for s in SHAPES.values()]


def test_guard_norm_matches_jax():
    rng = np.random.RandomState(5)
    leaves = [(rng.randn(*s) * 10.0 ** rng.randint(-8, 18)).astype(np.float32)
              for s in [(3, 4), (7,), (1,), (2, 2, 2), (50,)] * 4]
    ours = float(optim.safe_global_norm([torch.from_numpy(x) for x in leaves]))
    np.testing.assert_allclose(ours, float(joptim.safe_global_norm(leaves)), rtol=1e-6)


def test_state_dict_resumes():
    params = _params()
    named_a, a = _opt(params)
    for step in range(2):
        _update(a, _grads(step))
    state = a.state_dict()
    assert set(state["m"]) == set(SHAPES) and state["count"] == 2
    assert all(state["m"][n].shape == p.shape for n, p in named_a)
    named_b, b = _opt({n: p.detach().numpy() for n, p in named_a})
    b.load_state_dict(state)
    for opt in (a, b):
        _update(opt, _grads(2))
    for x, y in zip([p for _, p in named_a] + a.m + a.v, [p for _, p in named_b] + b.m + b.v):
        assert torch.equal(x.detach(), y.detach())
    assert int(a.count) == int(b.count) == 3


class OpCounts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _dispatched(n_tensors):
    rng = np.random.RandomState(0)
    values = {f"transformer.layers.{i}.w": rng.randn(3, 1 + i % 4).astype(np.float32)
              for i in range(n_tensors)}
    values.update({"backbone.0.w": rng.randn(5).astype(np.float32),
                   "transformer.decoder.ref_point_head.w": rng.randn(2, 2).astype(np.float32),
                   "head.w": rng.randn(2).astype(np.float32)})
    named, opt = _opt(values)
    grads = [torch.randn_like(p) for _, p in named]
    with OpCounts() as mode:
        _update(opt, grads)
    return mode.ops


def test_dispatched_ops_do_not_grow_with_the_tensors():
    ten, hundred = _dispatched(10), _dispatched(100)
    assert ten == hundred


def _per_leaf_norm(grads):
    """The overflow-safe norm written out a leaf at a time."""
    gmax = max(float(g.abs().max()) for g in grads)
    return gmax * float(sum(((g.double() / gmax) ** 2).sum() for g in grads)) ** 0.5


def test_train_step_norm_and_guard():
    """One step of a nano model through make_train_step: its grad_norm is
    the per-leaf norm of the gradients it hands the optimizer, and then a
    non-finite batch moves nothing."""
    from open_groundingdino_tpu_torch.models.bert import BertConfig
    from open_groundingdino_tpu_torch.models.criterion import SetCriterion
    from open_groundingdino_tpu_torch.models.groundingdino import GroundingDINO, init_weights_
    from open_groundingdino_tpu_torch.models.swin import SwinConfig
    from open_groundingdino_tpu_torch.parallel.train_state import TrainState, make_train_step
    from test_torch_remat import BERT, QN, SWIN, TOP, _batch

    model = init_weights_(GroundingDINO(SwinConfig(**SWIN), BertConfig(**BERT), **TOP), 0)
    opt = optim.make_optimizer(model, lr=1e-4, base_lr=1e-4, lr_backbone=1e-5)
    state = TrainState.create(model, opt, seed=0)
    step = make_train_step(SetCriterion(num_queries=QN))
    seen, real = [], opt.step

    def spy(grads, norm, finite):
        seen.append([g.clone() for g in grads])
        real(grads, norm, finite)

    opt.step = spy
    p0 = [p.detach().clone() for p in opt.params]
    norm = float(step(state, _batch(1))["grad_norm"])
    np.testing.assert_allclose(norm, _per_leaf_norm(seen[0]), rtol=1e-6)
    after = [p.detach().clone() for p in opt.params]
    assert any(not torch.equal(a, b) for a, b in zip(after, p0))
    bad = _batch(2)
    bad["gt_boxes"][0, 0, 0] = np.nan
    assert not np.isfinite(float(step(state, bad)["loss"]))
    assert all(torch.equal(a, b.detach()) for a, b in zip(after, opt.params))
    assert int(opt.count) == 1 and int(state.nonfinite_count) == 1
