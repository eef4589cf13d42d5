"""A/B of the MSDA kernels K1 and K3 on one GPU: this checkout's against
other checkouts' (the parent commit unpacked with `git archive`, or a copy
with one change), on the same seeded operands, in turns on one card.

    python -m open_groundingdino_tpu_torch.tools.msda_ab --ref NAME=DIR [--ref NAME=DIR ...] \\
        [--set NAME.ATTR=VALUE ...] [--iters N] [--rounds N]

Run it from the repository root: the operands are chip_smoke.py's, at the
800x1216 bucket's encoder (Q = L = 20197) and decoder (Q = 900) shapes, for
serving's B = 1 (smoke phase 3) and training's B = 4 with a valid region
for each image (phase 8).  K1 is timed at all four, K3 at B = 4.  Each DIR
holds an `open_groundingdino_tpu_torch/` package whose ops/msda.py has
`ms_deform_attn` and `ms_deform_attn_bwd`; it is imported under NAME and
builds its two MSDA kernels into DIR/build/.  The same DIR may be given
twice: `--set NAME.ATTR=VALUE` sets a constant of NAME's ops/msda.py (a
launch-plan constant such as FWD_MIN_CTAS) to an int.  This checkout is
"this".

Every version is held to the plain version with the smoke's tolerances
first.  Then each round times every version with CUDA events (the mean of
`--iters` back-to-back calls after a warm-up), in the order refs, this,
this, refs; at the decoder's shapes that time is the host's launch cost as
much as the kernel's, so torch.profiler's device time of the kernel itself
is taken too.  Prints one line a (shape, kernel, version) with the mean and
least of its times and the device time, and a JSON line of all of them
last; exits nonzero when a version disagrees with the plain version.
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

THIS = "this"


def get_args_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", action="append", default=[], metavar="NAME=DIR",
                    help="another checkout to time against this one")
    ap.add_argument("--set", action="append", default=[], metavar="NAME.ATTR=VALUE",
                    help="set an int constant of version NAME's ops/msda.py")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    return ap


def load_version(name: str, root: str):
    """ops.msda of the open_groundingdino_tpu_torch package under root,
    imported as package `name`, building only the two MSDA kernels."""
    pkg_dir = os.path.join(os.path.abspath(root), "open_groundingdino_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    importlib.import_module(f"{name}.ops.build").SOURCES = ("msda_fwd", "msda_bwd")
    return importlib.import_module(f"{name}.ops.msda")


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from open_groundingdino_tpu_torch.ops import build as this_build
    from open_groundingdino_tpu_torch.ops import msda as this_msda

    args = get_args_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("msda_ab: no CUDA device", file=sys.stderr)
        return 1
    this_build.SOURCES = ("msda_fwd", "msda_bwd")
    versions = {}
    for spec in args.ref:
        name, root = spec.split("=", 1)
        versions[name] = load_version(name, root)
    versions[THIS] = this_msda
    for spec in args.set:
        target, value = spec.split("=", 1)
        name, attr = target.split(".", 1)
        if not hasattr(versions[name], attr):
            raise ValueError(f"{name}'s ops/msda.py has no {attr}")
        setattr(versions[name], attr, int(value))

    # one nvcc a source, every build directory's started together
    builders = {m.build.BUILD_DIR: m.build for m in versions.values()}
    threads = [threading.Thread(target=b.build_all) for b in builders.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    shapes = cs.level_shapes(*cs.BUCKET)
    L = sum(h * w for h, w in shapes)
    starts = this_msda.level_starts(shapes)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    order = [n for n in versions if n != THIS] + [THIS]
    order = order + order[::-1]
    results, ok = {}, True
    for batch, valid in (("B=1", (cs.BUCKET,)), ("B=4", cs.BATCH_VALID)):
        for part, q, ref_dim in (("encoder", L, 2), ("decoder", 900, 4)):
            value, locs, attn = cs.msda_inputs(shapes, q, ref_dim, g, "cuda", valid)
            grad_out = torch.randn(len(valid), q, cs.HEADS * cs.HEAD_DIM, generator=g,
                                   device="cuda")
            plain_out = this_msda.ms_deform_attn_plain(value, shapes, starts, locs, attn)
            calls = {"K1": lambda m: m.ms_deform_attn(value, shapes, starts, locs, attn)}
            plain = {"K1": [plain_out]}
            bounds = {"K1": cs.msda_bound_ms(value, shapes, locs, attn)}
            if batch == "B=4":
                calls["K3"] = lambda m: m.ms_deform_attn_bwd(value, shapes, starts, locs, attn,
                                                             grad_out)
                plain["K3"] = this_msda.ms_deform_attn_bwd_plain(value, shapes, starts, locs,
                                                                 attn, grad_out)
                bounds["K3"] = cs.msda_bwd_bound_ms(value, shapes, locs, attn)
            del plain_out
            for kernel, call in calls.items():
                key = f"{kernel} {batch} {part}"
                row = results[key] = {"bound_ms": bounds[kernel][0]}
                for name, m in versions.items():
                    got = call(m)
                    got = got if isinstance(got, tuple) else (got,)
                    errs = [float((a - b).abs().max()) / (float(b.abs().max()) if kernel == "K3"
                                                          else 1.0)
                            for a, b in zip(got, plain[kernel])]
                    tol = cs.K3_RTOL if kernel == "K3" else cs.K1_TOL
                    row[name] = {"err": max(errs), "ms": []}
                    if not max(errs) <= tol:
                        ok = False
                        print(f"{key} {name}: error {max(errs):.3e} > {tol}", flush=True)
                for _ in range(args.rounds):
                    for name in order:
                        row[name]["ms"].append(
                            cs.event_ms(lambda m=versions[name]: call(m), args.iters))
                for name in versions:
                    ms = row[name]["ms"]
                    row[name] |= {"mean_ms": sum(ms) / len(ms), "min_ms": min(ms),
                                  "device_ms": cs.kernel_device_ms(
                                      lambda m=versions[name]: call(m), args.iters, "msda")}
                    print(f"{key} {name}: mean {row[name]['mean_ms']:.4f} ms, least "
                          f"{row[name]['min_ms']:.4f} ms of {len(ms)}, kernel device time "
                          f"{row[name]['device_ms']:.4f} ms, err {row[name]['err']:.2e}; "
                          f"bound {row['bound_ms']:.4f} ms", flush=True)
            del value, locs, attn, grad_out, plain
    print(json.dumps(results), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
