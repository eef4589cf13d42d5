"""Every kernel of the port as a `torch.library` custom op, the forwards
differentiable.

Each kernel has a dispatcher-level identity in the namespace `ogd_torch`, so
that PyTorch's graph tools (`torch.export`, serving.py; `torch.compile` and
AOTAutograd, through the forward and the backward; `FlopCounterMode`) see
it as one operator and not as the ctypes call inside it:

  ogd_torch::msda_fwd          K1, ops/msda.py         (gather path)
  ogd_torch::msda_bwd          K3, ops/msda.py         (gather, banded_point)
  ogd_torch::fusion_fwd        K2, ops/fusion.py       (every path)
  ogd_torch::fusion_bwd        K4, ops/fusion.py
  ogd_torch::banded_fwd        K5, ops/msda_banded.py  (banded_point path)
  ogd_torch::sweep_fwd         K6, ops/msda_sweep.py   (sweep path)
  ogd_torch::sweep_fwd_allq    K7, ops/msda_sweep.py   (sweep, dec_fused)
  ogd_torch::sweep_fwd_corner  K8, ops/msda_sweep.py   (fwd="corner", microbench)
  ogd_torch::sweep_bwd_corner  K9, ops/msda_sweep.py   (sweep, the default backward)
  ogd_torch::sweep_bwd_rowtap  K10, ops/msda_sweep.py  (sweep, msda_sweep_bwd="rowtap")
  ogd_torch::lsap              LSAP, ops/lsap.py       (the Hungarian matcher; no gradient)

Each op is defined beside its launcher.  Its CUDA implementation is the
launcher, unchanged, on the current stream (which counts the launch); its
CPU implementation is the kernel's plain version (a backward's: its plain
backward, or the VJP of the plain forward, `vjp_on_fresh_thread`); its fake
implementation gives the output shapes and dtypes without touching data.
Schemas take the level shapes flat (h0, w0, h1, w1, ...), as custom-op
schemas take no nested tuples.

Every forward op carries its gradient as a registered autograd formula
(`torch.library.register_autograd`) whose backward calls a backward op:
msda_fwd and banded_fwd -> msda_bwd, fusion_fwd -> fusion_bwd, sweep_fwd and
sweep_fwd_allq -> sweep_bwd_corner or sweep_bwd_rowtap (their `bwd`
argument), sweep_fwd_corner -> sweep_bwd_corner.  No autograd Function
wraps a kernel.  Each op also has a FLOP formula
(`torch.utils.flop_counter.register_flop_formula`): the operations of the
work the kernel does on this data (`msda_flops`, `fusion_flops`), the count
the smoke's bounds take.

`custom_ops()` imports the five modules, which registers every op, and
returns them by name; a program saved by torch.export resolves its ops only
once they are registered.

`saving_checkpoint_contexts` is the `context_fn` of training's
checkpointed encoder blocks (models/transformer.py): the forward kernels'
outputs are kept and everything else is recomputed in the backward, so the
backward replays no forward kernel (the JAX package's remat policy
`save_only_these_names("msda_out", "fusion_attn_out")`, its default
REMAT_SAVE_KERNELS=1).  The forward ops' implementations keep and hand back
their own outputs (`kernel_output`, `KernelOutputs`), below their
registered autograd: the recompute rebuilds what each op's autograd saves
(the value projection, the locations, the softmax) and takes the kernel's
output from the forward.  torch.utils.checkpoint's selective contexts
would do the same through a dispatch mode, whose Python call on every op of
the block cost more host time than the replays cost device time (PERF.md
§6).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

NAMESPACE = "ogd_torch"
# index math a sample takes in the MSDA kernels, beside 2 FLOP per channel
# of each corner it reads (8 in a backward: the value product, the scatter
# and the two location derivatives)
SAMPLE_FLOPS = 16


def flat_shapes(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """((h0, w0), (h1, w1), ...) -> [h0, w0, h1, w1, ...], the ops' form."""
    return [int(v) for hw in spatial_shapes for v in hw]


def shape_pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """The inverse of flat_shapes."""
    return tuple((int(h), int(w)) for h, w in zip(flat[::2], flat[1::2]))


def kernel_rows(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An upstream gradient as the backward kernels read it: `dtype`,
    contiguous, 16-byte aligned (a view at an offset is copied)."""
    t = t.to(dtype).contiguous()
    if t.storage_offset() * t.element_size() % 16:
        t = t.clone()
    return t


def vjp_on_fresh_thread(fn, *args):
    """fn(*args) on a new thread.  A custom op's kernel runs below the
    autograd dispatch keys, so autograd records nothing there; a new
    thread's dispatch state is fresh, and a plain backward that
    differentiates the plain forward by autograd runs there."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:   # re-raised on the caller's thread
            box["err"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def is_real(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether every tensor holds data (not a fake or meta tensor): a FLOP
    formula counts this data's work then, and the most it could be
    otherwise."""
    from torch._subclasses.fake_tensor import FakeTensor

    return all(t is None or (not isinstance(t, FakeTensor) and t.device.type != "meta")
               for t in tensors)


def in_map_corners(locs: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]) -> int:
    """The in-map bilinear corners of every sample of locs (B, Q, H, NL, P,
    2), normalised (x, y): the value rows an MSDA kernel reads."""
    total = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x0 = torch.floor(locs[..., lvl, :, 0].float() * w - 0.5)
        y0 = torch.floor(locs[..., lvl, :, 1].float() * h - 0.5)
        inx = ((x0 >= 0) & (x0 < w)).int() + ((x0 + 1 >= 0) & (x0 + 1 < w)).int()
        iny = ((y0 >= 0) & (y0 < h)).int() + ((y0 + 1 >= 0) & (y0 + 1 < h)).int()
        total += int((inx * iny).sum())
    return total


def msda_flops(samples: int, corners: int, D: int, per_corner: int) -> int:
    """An MSDA kernel's operations: per_corner FLOP a channel of each corner
    it reads (2 forward, 8 backward), SAMPLE_FLOPS of index math a sample."""
    return per_corner * D * corners + SAMPLE_FLOPS * samples


def fusion_flops(q: torch.Tensor, k: torch.Tensor, mask_v: torch.Tensor, mask_l: torch.Tensor,
                 backward: bool) -> int:
    """K2's (K4's) operations: multiply-adds of length E over the (image,
    text) pairs this data needs (the smoke's fusion bounds).  Forward: the
    logits for the pairs some output reads (U = every image token with the
    live text, every text token with the live image), the image->text
    product over live text, the text->image product over live image.
    Backward: over U the logits, gq and gk; G1 and gvl where the row softmax
    is live; G2 and gvv where the column softmax is live.  Every token
    counts as live on a fake tensor."""
    B, nv, E = q.shape
    nl = k.shape[1]
    if is_real(mask_v, mask_l):
        live = zip((~mask_v).sum(-1).tolist(), (~mask_l).sum(-1).tolist())
    else:
        live = [(nv, nl)] * B
    products = 0
    for lv, ll in live:
        union = nv * ll + lv * nl - lv * ll
        products += (3 * union + 2 * nv * ll + 2 * lv * nl) if backward else \
            (union + nv * ll + nl * lv)
    return 2 * E * products


# the forward kernels' ops whose outputs the checkpointed blocks keep: every
# MSDA forward (the JAX package names the banded and the sweep outputs
# "msda_out") and fusion_fwd's four outputs (out_v, out_l and both softmax
# statistics are "fusion_attn_out").  The decoder's ops are listed too; the
# decoder is checkpointed in neither package.
SAVED_OPS = ("msda_fwd", "fusion_fwd", "banded_fwd", "sweep_fwd", "sweep_fwd_allq",
             "sweep_fwd_corner")
_kept = threading.local()   # .stack: the KernelOutputs entered on this thread, innermost last


def _tensors(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class KernelOutputs:
    """The outputs of the forward kernels (SAVED_OPS) of one checkpointed
    call: kept, in order, while its forward runs (`contexts()[0]`), and
    handed back in that order while the backward recomputes the call
    (`contexts()[1]`), so that the recompute launches no forward kernel and
    rebuilds everything else.  Each op's implementation reaches its kernel
    through `kernel_output`.  A recompute that reaches another op than the
    forward did at that place, or a kept output changed in place since,
    raises."""

    def __init__(self):
        self.outs: List[tuple] = []   # (op name, its output, the output's tensor versions)
        self.at: Optional[int] = None   # the next output handed back while replaying

    def contexts(self):
        """(the forward's context, the recompute's): torch.utils.checkpoint's
        `context_fn` result."""
        return _Entered(self, replay=False), _Entered(self, replay=True)

    def run(self, name: str, impl, args):
        if self.at is None:
            out = impl(*args)
            self.outs.append((name, out, tuple(t._version for t in _tensors(out))))
            return out
        if self.at >= len(self.outs) or self.outs[self.at][0] != name:
            raise RuntimeError(f"a checkpointed recompute reached {name} where its forward ran "
                               f"{self.outs[self.at][0] if self.at < len(self.outs) else 'none'}")
        _, out, versions = self.outs[self.at]
        self.at += 1
        if tuple(t._version for t in _tensors(out)) != versions:
            raise RuntimeError(f"{name}'s kept output was changed in place before its recompute")
        return tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach()


class _Entered:
    """KernelOutputs in force on the thread that enters this (the forward's
    on the caller's, the recompute's on the backward's)."""

    def __init__(self, kept: KernelOutputs, replay: bool):
        self.kept, self.replay = kept, replay

    def __enter__(self):
        self.kept.at = 0 if self.replay else None
        _kept.__dict__.setdefault("stack", []).append(self.kept)

    def __exit__(self, *exc):
        _kept.stack.pop()
        self.kept.at = None


def kernel_output(name: str, impl, *args):
    """impl(*args), the implementation of the forward op `name` (of
    SAVED_OPS); inside a call checkpointed under saving_checkpoint_contexts
    its output is kept in the forward and handed back in the recompute."""
    stack = getattr(_kept, "stack", None)
    if stack:
        return stack[-1].run(name, impl, args)
    return impl(*args)


def saving_checkpoint_contexts():
    """`context_fn` of torch.utils.checkpoint (non-reentrant) that keeps the
    forward kernels' outputs of the call (a KernelOutputs of its own)."""
    return KernelOutputs().contexts()


def custom_ops() -> Dict[str, object]:
    """{op name: the op}, every op of the namespace registered."""
    from . import fusion, lsap, msda, msda_banded, msda_sweep

    return {"msda_fwd": msda.msda_fwd, "msda_bwd": msda.msda_bwd,
            "fusion_fwd": fusion.fusion_fwd, "fusion_bwd": fusion.fusion_bwd_op,
            "banded_fwd": msda_banded.banded_fwd_op, "sweep_fwd": msda_sweep.sweep_fwd_op,
            "sweep_fwd_allq": msda_sweep.sweep_fwd_allq_op,
            "sweep_fwd_corner": msda_sweep.sweep_fwd_corner_op,
            "sweep_bwd_corner": msda_sweep.sweep_bwd_corner_op,
            "sweep_bwd_rowtap": msda_sweep.sweep_bwd_rowtap_op, "lsap": lsap.lsap_op}
