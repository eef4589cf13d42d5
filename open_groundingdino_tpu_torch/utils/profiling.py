"""One reader of torch.profiler's device time, for the tools and the chip
smoke alike.

Every reader here takes the profiler's raw kineto events (`device_kernels`):
`prof.key_averages()` gives the same numbers but first builds an event tree
of every host op, 10-24 s for a profiled training step on an H100 host
(`check_device_kernels` holds the two against each other).  Calls are
profiled twice and only the second pass is recorded (the schedule's warm-up
step): launches right after the profiler starts can go unrecorded, and
`kernel_device_ms` takes a profile again, twice at most, when it recorded
fewer launches than were made.

The port's kernels are grouped by the names the profiler shows
(`KERNEL_GROUPS`, first match wins; each MSDA kernel's f32 and bf16 entries
are one template, told apart by `I13__nv_bfloat16` / `<__nv_bfloat16>`),
matrix products by cuBLAS / CUTLASS names, the rest as "other".
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

BF16_MANGLED = "I13__nv_bfloat16"


def bf16_names(kernel: str) -> tuple:
    """The names of a kernel template's bf16 instance, demangled or not."""
    return (f"{kernel}<__nv_bfloat16", f"{kernel}{BF16_MANGLED}")


K1_BF16_NAMES = bf16_names("msda_fwd_kernel")
K3_BF16_NAMES = bf16_names("msda_bwd_kernel")
SWEEP_BF16_NAMES = {"K6": bf16_names("rowtap_fwd_kernel"), "K7": bf16_names("allq_fwd_kernel"),
                    "K9": bf16_names("corner_bwd_kernel"), "K10": bf16_names("rowtap_bwd_kernel"),
                    "K5": bf16_names("banded_fwd_kernel"), "K8": bf16_names("corner_fwd_kernel")}
# the port's kernels by the names torch.profiler shows, first match wins
# (K4's bwd_kernel after the MSDA backwards, whose names hold it too)
KERNEL_GROUPS = (("K1 msda_fwd bf16", K1_BF16_NAMES),
                 ("K3 msda_bwd bf16", K3_BF16_NAMES),
                 ("K2 fusion_fwd bf16", ("attend_bf16_kernel", "combine_bf16_kernel")),
                 ("K4 fusion_bwd bf16", ("bwd_bf16_kernel", "sum_splits_bf16_kernel")),
                 ("K6 rowtap_fwd bf16", SWEEP_BF16_NAMES["K6"]),
                 ("K7 allq_fwd bf16", SWEEP_BF16_NAMES["K7"]),
                 ("K9 corner_bwd bf16", SWEEP_BF16_NAMES["K9"]),
                 ("K10 rowtap_bwd bf16", SWEEP_BF16_NAMES["K10"]),
                 ("K5 banded_fwd bf16", SWEEP_BF16_NAMES["K5"]),
                 ("K8 corner_fwd bf16", SWEEP_BF16_NAMES["K8"]),
                 ("K5 banded_fwd", ("banded_fwd_kernel",)),
                 ("K6 rowtap_fwd", ("rowtap_fwd_kernel",)),
                 ("K7 allq_fwd", ("allq_fwd_kernel",)),
                 ("K8 corner_fwd", ("corner_fwd_kernel",)),
                 ("K9 corner_bwd", ("corner_bwd_kernel",)),
                 ("K10 rowtap_bwd", ("rowtap_bwd_kernel",)),
                 ("K1 msda_fwd", ("msda_fwd_kernel",)),
                 ("K2 fusion_fwd", ("attend_kernel", "combine_kernel")),
                 ("K3 msda_bwd", ("msda_bwd_kernel",)),
                 ("K4 fusion_bwd", ("bwd_kernel", "sum_splits_kernel")),
                 ("LSAP lsap", ("lsap_kernel",)))
MATMUL_NAMES = ("gemm", "xmma", "cutlass", "matmul")


def _duration_ns(e) -> float:
    return e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1e3


def device_kernels(prof, host: bool = False) -> Dict[str, list]:
    """{name: [device ms, launches]} of a finished profile's device events
    (kernels, copies, sets), summed by name in one pass over the profiler's
    raw kineto events (`host`: its host events instead, nested ones
    included)."""
    from torch.autograd import DeviceType

    want = DeviceType.CPU if host else DeviceType.CUDA
    out: Dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        # the schedule's step annotation spans the step on the device too
        if e.device_type() != want or e.name().startswith("ProfilerStep"):
            continue
        ns = _duration_ns(e)
        if ns > 0:
            rec = out.setdefault(e.name(), [0.0, 0])
            rec[0] += ns / 1e6
            rec[1] += 1
    return out


def host_spans_ms(prof, name: str) -> List[float]:
    """The host milliseconds of every CPU event `name` of a finished
    profile, in the order they began."""
    from torch.autograd import DeviceType

    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.name() == name and e.device_type() == DeviceType.CPU:
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
            spans.append((start, _duration_ns(e) / 1e6))
    return [ms for _, ms in sorted(spans)]


def check_device_kernels(prof) -> dict:
    """device_kernels against key_averages() on one profile: the same
    launches and device ms by kernel (a name's sum to 1e-6 relative, both
    readers of the same kineto durations); raises otherwise.  Returns both
    readers' seconds, the kernels each found, their device ms and the worst
    relative difference."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    raw = device_kernels(prof)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not e.key.startswith("ProfilerStep")):
            ref[e.key] = [e.self_device_time_total / 1e3, e.count]
    ref_s = time.perf_counter() - t0
    by_launch = lambda d: sorted((n, round(ms, 6)) for ms, n in d.values())
    worst = max((abs(a[0] - b[0]) / max(b[0], 1e-9)
                 for a, b in zip(sorted(raw.values()), sorted(ref.values()))), default=0.0)
    result = {"raw_s": raw_s, "key_averages_s": ref_s, "kernels": len(raw),
              "ref_kernels": len(ref), "raw_ms": sum(ms for ms, _ in raw.values()),
              "ref_ms": sum(ms for ms, _ in ref.values()), "worst_rel": worst}
    if (len(raw) != len(ref) or [n for _, n in by_launch(raw)] != [n for _, n in by_launch(ref)]
            or worst > 1e-6):
        raise AssertionError(f"the raw kineto events and key_averages() read different device "
                             f"times: {result}")
    return result


def group_of(name: str) -> str:
    """The KERNEL_GROUPS group of a device event's name, else "matmul" or
    "other"."""
    group = next((g for g, frags in KERNEL_GROUPS if any(f in name for f in frags)), None)
    if group is None:
        return "matmul" if any(t in name.lower() for t in MATMUL_NAMES) else "other"
    return group


def device_time_by_group(prof) -> Tuple[List[tuple], Dict[str, float], Dict[str, int]]:
    """A profile's device kernels, largest first, as (name, ms, launches),
    and their device ms and launches summed by KERNEL_GROUPS, matrix
    products and the rest."""
    kernels = [(name, ms, n) for name, (ms, n) in device_kernels(prof).items()]
    kernels.sort(key=lambda k: -k[1])
    names = [g for g, _ in KERNEL_GROUPS] + ["matmul", "other"]
    groups, launches = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for key, ms, n in kernels:
        group = group_of(key)
        groups[group] += ms
        launches[group] += n
    return kernels, groups, launches


def profile_calls(fn: Callable[[], object], iters: int = 1, cpu: bool = True,
                  trace_path: Optional[str] = None):
    """torch.profiler over `iters` calls of fn, after `iters` more under its
    warm-up step; returns (the profile, the recorded pass's wall ms, after a
    CUDA sync).  The host's events are recorded with `cpu`, the card's
    wherever CUDA is available.  `trace_path`: where to write the recorded
    pass as a Chrome trace (JSON)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = ([ProfilerActivity.CPU] if cpu or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    wall_ms = 0.0
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            if cuda:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return prof, wall_ms


def kernel_device_ms(fn, iters: int, match, per_call: int = 0,
                     note: Optional[Callable[[str], None]] = None) -> float:
    """torch.profiler's mean device time a launch of the kernels whose
    names hold `match` (a string, or a tuple of them: any), over `iters`
    calls of fn that each launch one: the kernel alone, without the host's
    launch cost, which sets a CUDA-event time where a kernel takes tens of
    microseconds (`per_call`: the number of matching launches a call makes,
    for a call that launches several; then the device time of all of them a
    call).  A profile that records fewer than the iters x per_call launches
    made is taken again, twice at most; the one that recorded most gives
    the mean over the launches it recorded (`note` is told when that is
    fewer than were made), NaN where none was."""
    import torch

    fn()
    torch.cuda.synchronize()
    matches = (match,) if isinstance(match, str) else match
    made = iters * max(per_call, 1)
    count, total = 0, 0.0

    def calls():
        for _ in range(iters):
            fn()

    for _ in range(3):
        prof, _ = profile_calls(calls, cpu=False)
        events = [(ms, n) for name, (ms, n) in device_kernels(prof).items()
                  if any(m in name for m in matches)]
        seen = sum(n for _, n in events)
        if seen > count:
            count, total = seen, sum(ms for ms, _ in events)
        if count >= made:
            break
    if count != made and note is not None:
        note(f"{count} of {made} launches of {matches} recorded")
    return total / count * max(per_call, 1) if count else float("nan")


def summarize(prof, iters: int, top: int = 30, printer: Callable[[str], None] = print
              ) -> Dict[str, object]:
    """The JAX package's profile summary (tools/profile.py summarize_trace)
    on a torch profile: device self-time per iteration, then the top
    buckets (device event names cut at 60 characters) by device time with
    their launch counts; the host's events where the profile holds no
    device event (a CPU run; parent spans include their children there).
    Returns {"device_ms_per_iter", "buckets": [(ms a iteration, launches,
    name)]}."""
    durs: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for name, (ms, n) in (device_kernels(prof) or device_kernels(prof, host=True)).items():
        key = name[:60]
        durs[key] = durs.get(key, 0.0) + ms
        counts[key] = counts.get(key, 0) + n
    rows = sorted(((ms, name, counts[name]) for name, ms in durs.items()), reverse=True)
    per = max(iters, 1)
    total = sum(r[0] for r in rows)
    printer(f"device self-time {total / per:.1f} ms/iter across {len(rows)} buckets "
            f"(top {top}):")
    for ms, name, c in rows[:top]:
        printer(f"  {ms / per:8.2f} ms  x{c:5d}  {name}")
    return {"device_ms_per_iter": total / per,
            "buckets": [(ms / per, c, name) for ms, name, c in rows[:top]]}
