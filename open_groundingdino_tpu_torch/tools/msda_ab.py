"""A/B of the MSDA kernels K1, K3 and K5-K10 on one GPU: this checkout's
against other checkouts' (the parent commit unpacked with `git archive`, or
a copy with one change), on the same seeded operands, in turns on one card.

    python -m open_groundingdino_tpu_torch.tools.msda_ab --ref NAME=DIR [--ref NAME=DIR ...] \\
        [--kernels K1,K3,K5,K6,K7,K8,K9,K10] [--set NAME.ATTR=VALUE ...] [--iters N] \\
        [--rounds N]

Run it from the repository root: the operands are chip_smoke.py's, at the
800x1216 bucket's encoder (Q = L = 20197) and decoder (Q = 900) shapes, for
serving's B = 1 (smoke phase 3) and training's B = 4 with a valid region
for each image (phase 8).  K1, K5 (the per-point banded forward, on the
operands `banded_operands` makes), K6 (the row-tap forward, on the row
taps the sweep makes) and K8 (the corner-tap forward, on the corner taps
sorted as the corner forward sorts them) are timed at all four, K7 (the
fused decoder's row-tap forward) at the two decoder shapes, K3, K9 and K10
(the corner- and row-tap backwards, on the taps the sweep's backward
makes) at B = 4.  Each DIR holds an `open_groundingdino_tpu_torch/`
package whose ops have `ms_deform_attn`, `ms_deform_attn_bwd`,
`banded_fwd`, `sweep_fwd`, `sweep_fwd_allq`, `sweep_fwd_corner`,
`sweep_bwd_corner` and `sweep_bwd_rowtap`;
it is imported under NAME and builds its MSDA kernels into DIR/build/.  The
same DIR may be given twice: `--set NAME.ATTR=VALUE` sets an int constant of
NAME's ops/msda.py, ops/msda_banded.py or ops/msda_sweep.py (the first that
has it; a launch-plan constant such as FWD_MIN_CTAS).  This checkout is
"this".

Every version is held to the plain version with the smoke's tolerances
first (K9's gw and K10's gw and gpx where the tap is live: older versions
give a dead tap 0).  Then each round times every version
with CUDA events (the mean of `--iters` back-to-back calls after a warm-up),
in the order refs, this, this, refs; at the decoder's shapes that time is
the host's launch cost as much as the kernel's, so torch.profiler's device
time of the kernel itself is taken too.  Prints one line a (shape, kernel,
version) with the mean and least of its times and the device time, and a
JSON line of all of them last; exits nonzero when a version disagrees with
the plain version.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import types

THIS = "this"
KERNELS = ("K1", "K3", "K5", "K6", "K7", "K8", "K9", "K10")
# the libraries the timed kernels live in, in this checkout or an older one
LIBRARIES = ("msda_fwd", "msda_bwd", "msda_banded_fwd", "msda_sweep_fwd", "msda_sweep_bwd",
             "msda_rowtap_fwd", "msda_rowtap_bwd", "msda_corner_fwd", "msda_corner_bwd")
# the kernels' names as torch.profiler sees them (K6-K10's before and after
# they left the sweep's tile-product templates)
DEVICE_NAMES = {"K1": "msda_fwd_kernel", "K3": "msda_bwd_kernel", "K5": "banded_fwd_kernel",
                "K6": ("sweep_fwd_kernel", "rowtap_fwd_kernel"),
                "K7": ("sweep_fwd_kernel", "allq_fwd_kernel"),
                "K8": ("sweep_fwd_kernel", "corner_fwd_kernel"),
                "K9": ("sweep_bwd_kernel", "corner_bwd_kernel"),
                "K10": ("sweep_bwd_kernel", "rowtap_bwd_kernel")}


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout to time against this one")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to time, comma-separated")
    ap.add_argument("--set", action="append", default=[], metavar="NAME.ATTR=VALUE",
                    help="set an int constant of version NAME's MSDA ops")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    return ap


def _ops(prefix: str):
    """The MSDA op modules of the package imported as `prefix`."""
    return types.SimpleNamespace(**{m: importlib.import_module(f"{prefix}.ops.{m}")
                                    for m in ("build", "msda", "msda_banded", "msda_sweep")})


def restrict_build(build) -> None:
    """Build only the MSDA libraries this tool times."""
    build.SOURCES = tuple(s for s in build.SOURCES if s in LIBRARIES)


def load_version(name: str, root: str):
    """The MSDA ops of the open_groundingdino_tpu_torch package under root,
    imported as package `name`, building only the MSDA kernels."""
    pkg_dir = os.path.join(os.path.abspath(root), "open_groundingdino_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    ops = _ops(name)
    restrict_build(ops.build)
    return ops


def cases(kernels, cs, this, shapes, g, device="cuda"):
    """(key, {kernel: (call(ops), reference outputs, masks of the outputs to
    compare or None, tolerance, bound ms)}) for each batch and shape, the
    operands made on `device` from g in the same order whatever `kernels`
    holds."""
    import torch

    L = sum(h * w for h, w in shapes)
    starts = this.msda.level_starts(shapes)
    mb, sw = this.msda_banded, this.msda_sweep
    for batch, valid in (("B=1", (cs.BUCKET,)), ("B=4", cs.BATCH_VALID)):
        for part, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = cs.msda_inputs(shapes, q, ref_dim, g, device, valid)
            grad_out = torch.randn(len(valid), q, cs.HEADS * cs.HEAD_DIM, generator=g,
                                   device=device)
            fwd_bound = cs.msda_bound_ms(value, shapes, locs, attn)[0]
            bwd_bound = cs.msda_bwd_bound_ms(value, shapes, locs, attn)[0]
            out = {}
            if "K1" in kernels:
                out["K1"] = (lambda m: m.msda.ms_deform_attn(value, shapes, starts, locs, attn),
                             [this.msda.ms_deform_attn_plain(value, shapes, starts, locs, attn)],
                             None, cs.K1_TOL, fwd_bound)
            if "K3" in kernels and batch == "B=4":
                out["K3"] = (lambda m: m.msda.ms_deform_attn_bwd(value, shapes, starts, locs,
                                                                 attn, grad_out),
                             this.msda.ms_deform_attn_bwd_plain(value, shapes, starts, locs,
                                                                attn, grad_out),
                             None, cs.K3_RTOL, bwd_bound)
            if "K5" in kernels:
                _, locs_t, px, py, wa = mb.banded_operands(locs, attn, shapes, L)
                ranges = mb.band_ranges(locs_t, shapes, px.shape[-1] // sw.QBLOCK,
                                        mb.level_bands(shapes, mb.BAND))
                out["K5"] = (lambda m: m.msda_banded.banded_fwd(value, shapes, px, py, wa),
                             [mb.banded_fwd_plain(value, shapes, px, py, wa, ranges)],
                             None, cs.K5_K8_TOL, fwd_bound)
            if {"K6", "K7", "K9", "K10"} & set(kernels):
                ops = cs.sweep_operands(value, shapes, locs, attn, grad_out)
                row, rpx, w, idx, wc, g_k = (ops[k] for k in ("row", "px", "w", "idx", "wc", "g"))
            if "K6" in kernels:
                out["K6"] = (lambda m: m.msda_sweep.sweep_fwd(value, shapes, row, rpx, w),
                             [sw.sweep_fwd_plain(value, row, rpx, w)], None, cs.SWEEP_TOL,
                             fwd_bound)
            if "K7" in kernels and part == "decoder":
                out["K7"] = (lambda m: m.msda_sweep.sweep_fwd_allq(value, shapes, row, rpx, w),
                             [sw.sweep_fwd_plain(value, row, rpx, w)], None, cs.SWEEP_TOL,
                             fwd_bound)
            if "K8" in kernels:
                idx8, w8 = cs.corner_operands(value, shapes, locs, attn)
                out["K8"] = (lambda m: m.msda_sweep.sweep_fwd_corner(value, shapes, idx8, w8),
                             [sw.sweep_fwd_corner_plain(value, idx8, w8)], None, cs.K5_K8_TOL,
                             fwd_bound)
            if "K9" in kernels and batch == "B=4":
                out["K9"] = (lambda m: m.msda_sweep.sweep_bwd_corner(value, shapes, idx, wc, g_k),
                             sw.sweep_bwd_corner_plain(value, idx, wc, g_k),
                             [None, wc != 0], cs.SWEEP_RTOL, bwd_bound)
            if "K10" in kernels and batch == "B=4":
                out["K10"] = (lambda m: m.msda_sweep.sweep_bwd_rowtap(value, shapes, row, rpx, w,
                                                                      g_k),
                              sw.sweep_bwd_rowtap_plain(value, row, rpx, w, g_k),
                              [None, w != 0, w != 0], cs.SWEEP_RTOL, bwd_bound)
            if out:
                yield f"{batch} {part}", out
            del value, locs, attn, grad_out, out


def rel_err(kernel, got, ref, masks) -> float:
    """Forwards: max abs error; backwards: each output's max abs error over
    its largest |reference| (over the mask where one is given)."""
    errs = []
    for i, (a, b) in enumerate(zip(got, ref)):
        mask = masks[i] if masks else None
        if mask is not None:
            a, b = a[mask], b[mask]
        scale = 1.0 if kernel in ("K1", "K5", "K6", "K7", "K8") else max(float(b.abs().max()),
                                                                          1e-30)
        errs.append(float((a - b).abs().max()) / scale)
    return max(errs)


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs

    args = get_args_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("msda_ab: no CUDA device", file=sys.stderr)
        return 1
    kernels = [k for k in args.kernels.split(",") if k]
    if not set(kernels) <= set(KERNELS):
        raise ValueError(f"--kernels takes {KERNELS}, got {kernels}")
    this = _ops("open_groundingdino_tpu_torch")
    restrict_build(this.build)
    versions = {}
    for spec in args.ref:
        name, root = spec.split("=", 1)
        versions[name] = load_version(name, root)
    versions[THIS] = this
    for spec in args.set:
        target, value = spec.split("=", 1)
        name, attr = target.split(".", 1)
        mods = [m for m in (versions[name].msda, versions[name].msda_banded,
                            versions[name].msda_sweep) if hasattr(m, attr)]
        if not mods:
            raise ValueError(f"{name}'s MSDA ops have no {attr}")
        setattr(mods[0], attr, int(value))

    # one nvcc a source, every build directory's started together
    builders = {v.build.BUILD_DIR: v.build for v in versions.values()}
    threads = [threading.Thread(target=b.build_all) for b in builders.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v in builders.values():   # a failed build raises here
        v.build_all()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    print(f"ptxas: {this.build.ptxas_summary()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    shapes = cs.level_shapes(*cs.BUCKET)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    order = [n for n in versions if n != THIS] + [THIS]
    order = order + order[::-1]
    results, ok = {}, True
    for shape, calls in cases(kernels, cs, this, shapes, g):
        for kernel, (call, ref, masks, tol, bound) in calls.items():
            key = f"{kernel} {shape}"
            row = results[key] = {"bound_ms": bound}
            for name, m in versions.items():
                got = call(m)
                got = got if isinstance(got, tuple) else (got,)
                err = rel_err(kernel, got, ref, masks)
                del got
                row[name] = {"err": err, "ms": []}
                if not err <= tol:
                    ok = False
                    print(f"{key} {name}: error {err:.3e} > {tol}", flush=True)
            for _ in range(args.rounds):
                for name in order:
                    row[name]["ms"].append(cs.event_ms(lambda m=versions[name]: call(m),
                                                       args.iters))
            for name in versions:
                ms = row[name]["ms"]
                row[name] |= {"mean_ms": sum(ms) / len(ms), "min_ms": min(ms),
                              "device_ms": cs.kernel_device_ms(
                                  lambda m=versions[name]: call(m), args.iters,
                                  DEVICE_NAMES[kernel])}
                print(f"{key} {name}: mean {row[name]['mean_ms']:.4f} ms, least "
                      f"{row[name]['min_ms']:.4f} ms of {len(ms)}, kernel device time "
                      f"{row[name]['device_ms']:.4f} ms, err {row[name]['err']:.2e}; "
                      f"bound {row['bound_ms']:.4f} ms", flush=True)
        del calls
    print(json.dumps(results), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
