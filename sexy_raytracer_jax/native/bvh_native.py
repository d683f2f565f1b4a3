"""ctypes binding for the native BVH builder (with on-demand compile).

The shared library is compiled from bvh_builder.cpp on first use if a
toolchain is available; models/bvh.py transparently falls back to the numpy
builder otherwise. Both builders produce bit-identical trees
(tests/test_native.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_LIB_PATH = os.path.join(_HERE, "libsrtbvh.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _compile() -> bool:
    try:
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-shared", "-fPIC",
                "-std=c++17", _SRC, "-o", _LIB_PATH,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH)
        ):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.srt_build_bvh.restype = ctypes.c_int64
        lib.srt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build(pmin: np.ndarray, pmax: np.ndarray):
    from sexy_raytracer_jax.models.bvh import FlatBVH

    lib = _load()
    if lib is None:
        raise RuntimeError("native BVH builder unavailable")
    pmin = np.ascontiguousarray(pmin, np.float32)
    pmax = np.ascontiguousarray(pmax, np.float32)
    n = pmin.shape[0]
    n_nodes = 2 * n - 1
    node_min = np.empty((n_nodes, 3), np.float32)
    node_max = np.empty((n_nodes, 3), np.float32)
    left = np.empty((n_nodes,), np.int32)
    right = np.empty((n_nodes,), np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    written = lib.srt_build_bvh(
        ptr(pmin, ctypes.c_float),
        ptr(pmax, ctypes.c_float),
        n,
        ptr(node_min, ctypes.c_float),
        ptr(node_max, ctypes.c_float),
        ptr(left, ctypes.c_int32),
        ptr(right, ctypes.c_int32),
    )
    if written != n_nodes:
        raise RuntimeError(f"native BVH build failed ({written} != {n_nodes})")
    return FlatBVH(node_min, node_max, left, right)
