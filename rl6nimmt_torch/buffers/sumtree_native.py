"""ctypes binding for the native replay-sampling kernels of ``native/sumtree.cpp``
(port of ``buffers/sumtree_native.py``).

The library is built with ``g++`` into ``rl6nimmt_torch/_build/sumtree-<hash>/``
(the hash covers the source and the flags) on the first call of
:func:`library`, never when this module is imported.  :func:`library` raises
``OSError`` when it cannot be built or loaded (no compiler); the host buffers
then sample with NumPy, which gives the same indices.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sumtree.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
# No -march=native: a library built on one host must load on another.
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"sumtree-{digest}" / "librl6sumtree.so"


def build() -> Path:
    """Compile ``native/sumtree.cpp`` unless this source is built already; the .so path."""
    target = _target()
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None or not SOURCE.exists():
        raise OSError("the native sampler needs g++ and native/sumtree.cpp")
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    out = subprocess.run([cxx, *FLAGS, "-o", tmp, str(SOURCE)], capture_output=True, text=True)
    if out.returncode != 0:
        os.unlink(tmp)
        raise OSError(f"g++ failed on {SOURCE.name}:\n{out.stderr}")
    os.replace(tmp, target)   # atomic: concurrent builds race safely
    return target


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded sampler library (built on the first call)."""
    lib = ctypes.CDLL(str(build()))
    lib.rl6_stratified_sample.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rl6_stratified_sample.restype = None
    lib.rl6_update_priorities.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.rl6_update_priorities.restype = None
    lib.rl6_max_priority.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.rl6_max_priority.restype = ctypes.c_double
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def stratified_sample(priorities: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Leaf indices for ascending stratified draws ``u`` over ``priorities``."""
    pri = np.ascontiguousarray(priorities, dtype=np.float64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    out = np.empty(u.shape[0], dtype=np.int64)
    library().rl6_stratified_sample(_dptr(pri), pri.shape[0], _dptr(u), u.shape[0], _iptr(out))
    return out


def update_priorities(priorities: np.ndarray, idx: np.ndarray, abs_errors: np.ndarray,
                      eps: float, cap: float, alpha: float) -> None:
    """In-place clipped-power priority writeback (priorities f64 and C-contiguous)."""
    if priorities.dtype != np.float64 or not priorities.flags.c_contiguous:
        raise ValueError("priorities must be a C-contiguous float64 array")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= priorities.shape[0]):
        raise IndexError(f"priority index out of range [0, {priorities.shape[0]})")
    err = np.ascontiguousarray(abs_errors, dtype=np.float64)
    if err.shape != idx.shape:
        raise ValueError(f"{idx.shape[0]} indices but {err.shape} errors")
    library().rl6_update_priorities(_dptr(priorities), _iptr(idx), _dptr(err), idx.shape[0], eps, cap, alpha)


def max_priority(priorities: np.ndarray, n: int) -> float:
    pri = np.ascontiguousarray(priorities, dtype=np.float64)
    return float(library().rl6_max_priority(_dptr(pri), min(int(n), pri.shape[0])))
