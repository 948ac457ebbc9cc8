"""ctypes bridge to the C++ k-hop preprocessing kernels (counterpart of
kpgnn_tpu/prep/native.py).

``_native/khop_native.cpp`` is the port's own copy of the JAX package's
source.  It is built with g++ at first use into the git-ignored
``_native/build/<hash>/`` (the hash covers the source and the compiler
flags, as ``ops/cuda_lib.py`` keys the CUDA build), so a fresh checkout
builds from its own source, a changed source rebuilds, and the JAX
package's committed library is never loaded.  ``available()`` gates use:
``prep.khop.extract_khop`` takes this path for graphs of at most
``NATIVE_MAX_NODES`` nodes when the library builds, as the JAX prep
does; its results are the numpy path's, bit for bit.  ``BUILD_ERROR``
keeps the reason a build failed.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "_native", "khop_native.cpp")
BUILD_ROOT = os.path.join(_HERE, "_native", "build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

NATIVE_MAX_NODES = 4096

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
BUILD_ERROR: Optional[str] = None
# seconds spent compiling (0.0 when the library was already built)
BUILD_SECONDS: Optional[float] = None

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def source_hash() -> str:
    """The build key: a hash of the source and the g++ flags (16 hex
    digits)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return digest.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_ROOT, source_hash(), "libkhop_native.so")


def build() -> str:
    """Compile the source unless its hash-keyed library exists; returns
    the library path.  The output is written to a temporary name and
    renamed, so a concurrent or interrupted build never leaves a partial
    library behind.  Raises if g++ is missing or fails."""
    global BUILD_SECONDS
    out = lib_path()
    if os.path.exists(out):
        if BUILD_SECONDS is None:
            BUILD_SECONDS = 0.0
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native prep is built "
                           "from source at first use")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.adjacency_powers.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64,
                                     _i64p]
    lib.spd_mask.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.gd_union.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.bfs_apsp.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int64, _i32p]
    lib.peripheral_hop.argtypes = [_i64p, _i64p] + [ctypes.c_int64] * 5 + \
        [_i64p, _i64p]
    for fn in (lib.adjacency_powers, lib.spd_mask, lib.gd_union,
               lib.bfs_apsp, lib.peripheral_hop):
        fn.restype = None
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build is
    tried once per process and leaves its reason in ``BUILD_ERROR``."""
    global _lib, _failed, BUILD_ERROR
    if _lib is not None:
        return True
    if _failed:
        return False
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _load()
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _failed, BUILD_ERROR = True, str(e)
    return _lib is not None


def adjacency_powers(adj: np.ndarray, K: int) -> np.ndarray:
    n = adj.shape[0]
    out = np.empty((K, n, n), dtype=np.int64)
    _lib.adjacency_powers(np.ascontiguousarray(adj, np.int64), n, K, out)
    return out


def spd_mask(powers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    K, n, _ = powers.shape
    powers = np.ascontiguousarray(powers, np.int64)
    union = np.empty((n, n), dtype=np.int64)
    _lib.spd_mask(powers, n, K, union)
    return powers, union


def gd_union(powers: np.ndarray) -> np.ndarray:
    K, n, _ = powers.shape
    union = np.empty((n, n), dtype=np.int64)
    _lib.gd_union(np.ascontiguousarray(powers, np.int64), n, K, union)
    return union


def bfs_apsp(adj_bool: np.ndarray, max_len: int) -> np.ndarray:
    n = adj_bool.shape[0]
    dist = np.empty((n, n), dtype=np.int32)
    _lib.bfs_apsp(np.ascontiguousarray(adj_bool, np.uint8), n, max_len, dist)
    return dist


def peripheral_hop(attr_adj: np.ndarray, hop_adj: np.ndarray,
                   max_hop_num: int, max_edge_type: int,
                   max_edge_count: int, max_distance_count: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    n = attr_adj.shape[0]
    edge_mat = np.empty((n, max_edge_type, 2), dtype=np.int64)
    config_mat = np.empty((n, max_hop_num + 1), dtype=np.int64)
    _lib.peripheral_hop(
        np.ascontiguousarray(attr_adj, np.int64),
        np.ascontiguousarray(hop_adj, np.int64),
        n, max_hop_num, max_edge_type, max_edge_count, max_distance_count,
        edge_mat, config_mat)
    return edge_mat, config_mat
