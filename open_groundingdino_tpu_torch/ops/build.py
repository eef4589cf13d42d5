"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` (with the shared `csrc/*.cuh` headers it includes)
has a plain C interface and is compiled by `nvcc` into its own shared library
under `<repo>/build/torch_kernels/`, then loaded with ctypes (no PyTorch
headers, so a build takes seconds).  All sources are compiled in parallel,
once per process, at the first kernel call; a library newer than its source
and the headers is reused.  A failed build raises: nothing falls back to the
plain versions.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")
SOURCES = ("msda_fwd", "msda_bwd", "fusion_fwd", "fusion_bwd", "msda_rowtap_fwd", "msda_corner_fwd",
           "msda_rowtap_bwd", "msda_banded_fwd", "msda_corner_bwd", "lsap")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(CSRC_DIR, f"{name}.cu")]
    deps += [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(d) for d in deps)


def build_all() -> float:
    """Compile every stale source (one nvcc each, all started together) and
    return the wall seconds spent.  The ptxas report of each build (registers,
    shared memory, spills) is kept in `<build>/<name>.log`."""
    todo = [n for n in SOURCES if _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _lib_path(name) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{log[-4000:]}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_summary() -> str:
    """Registers and spill bytes of every kernel in the last build's ptxas
    reports, one clause per source."""
    parts = []
    for name in SOURCES:
        path = os.path.join(BUILD_DIR, f"{name}.log")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            text = f.read()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill (?:stores|loads)", text))
        parts.append(f"{name}: registers {regs}, spill bytes {spills}")
    return "; ".join(parts)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building the kernels first if
    needed."""
    with _lock:
        if name not in _libs:
            build_all()
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
