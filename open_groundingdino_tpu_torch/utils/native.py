"""The port's C++ host code (the JAX package's utils/native.py): the COCO
evaluator's greedy matcher, `native/coco_match.cpp`, compiled by g++ at first
use into `<repo>/build/torch_native/` and loaded through ctypes.

When the library cannot be built or loaded (no g++), `coco_greedy_match`
returns None and the caller keeps its numpy matcher, as the JAX package's
does; unlike it, the port says so once, with a warning.
`coco_greedy_match.calls` counts the matches the library made.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import warnings
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs = {}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_and_load(name: str) -> Optional[ctypes.CDLL]:
    """`native/<name>.cpp` built (when its library is missing or older than
    the source) and loaded, once a process; None, after one warning, when
    that fails.  The library is written under a temporary name and renamed,
    so that processes building at once never load a partial file."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src, out = os.path.join(NATIVE_DIR, f"{name}.cpp"), lib_path(name)
        try:
            if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
                os.makedirs(BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src], check=True,
                                   capture_output=True, text=True)
                    os.replace(tmp, out)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or str(e)
            warnings.warn(f"the C++ {name} could not be built or loaded ({detail.strip()[:500]}); "
                          "the numpy version runs instead", RuntimeWarning, stacklevel=3)
            lib = None
        _libs[name] = lib
        return lib


def coco_greedy_match(
    ious: np.ndarray,       # (D, G) float64
    gt_ignore: np.ndarray,  # (G,) bool, sorted non-ignored first
    iscrowd: np.ndarray,    # (G,) bool
    thrs: np.ndarray,       # (T,) float64
):
    """Native greedy COCO matching; returns (dt_m (T, D), gt_m (T, G),
    dt_ig_gt (T, D)), or None when the library is unavailable."""
    lib = build_and_load("coco_match")
    if lib is None:
        return None
    D, G = ious.shape
    T = len(thrs)
    ious = np.ascontiguousarray(ious, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    iscrowd = np.ascontiguousarray(iscrowd, np.uint8)
    thrs = np.ascontiguousarray(thrs, np.float64)
    dt_m = np.full((T, D), -1, np.int64)
    gt_m = np.full((T, G), -1, np.int64)
    dt_ig = np.zeros((T, D), np.uint8)

    lib.coco_greedy_match(
        ious.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        gt_ignore.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        iscrowd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        thrs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(D), ctypes.c_int64(G), ctypes.c_int64(T),
        dt_m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gt_m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dt_ig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    coco_greedy_match.calls += 1
    return dt_m, gt_m, dt_ig.astype(bool)


coco_greedy_match.calls = 0
