"""The Morton-ordered approximate KNN of csrc/knn.cpp, bound with ctypes
(port of tpu2dgs/native/__init__.py).

Host code, in both packages: a multithreaded O(N log N) pass over the
Morton-sorted cloud that gives the mean squared distance to (about) the 3
nearest neighbours, used once at init for clouds too large for the exact
O(N^2) sweep of model/knn.py. The source is the JAX package's, compiled
with the same flags, so both packages start a large cloud from the same
scales. Built with g++ at first use into csrc/build/.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from tpu2dgs_torch.native.build import BUILD, CSRC

GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_LIB = None


def build_library() -> str:
    """Compile csrc/knn.cpp if its library is missing; the library's path."""
    src = CSRC / "knn.cpp"
    tag = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD / f"libknn-{tag}.so"
    if out.exists():
        return str(out)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the Morton KNN of tpu2dgs_torch is built from "
                           "csrc/knn.cpp at first use")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    done = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on csrc/knn.cpp:\n{done.stdout}{done.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return str(out)


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library())
            lib.knn_mean_dist2.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ]
            lib.knn_mean_dist2.restype = None
            _LIB = lib
    return _LIB


def knn_mean_dist2(points: np.ndarray, window: int = 16, threads: int = 0) -> np.ndarray:
    """(N,3) float32 -> (N,) approximate mean squared 3-NN distance."""
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N,3), got {pts.shape}")
    lib = _load()
    out = np.empty(pts.shape[0], np.float32)
    lib.knn_mean_dist2(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), window, threads)
    return out
