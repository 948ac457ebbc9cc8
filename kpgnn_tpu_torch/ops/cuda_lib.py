"""Build and load the port's hand-written CUDA kernels.

Each source under ``kpgnn_tpu_torch/csrc`` is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``.  The build happens at first use, into
``csrc/build/<hash of the sources>/`` (git-ignored), so a fresh checkout
builds from its own sources and a changed source rebuilds.  Nothing here
runs at import time: the CPU-only test environment imports every module
but has no ``nvcc``.
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
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_ROOT = os.path.join(CSRC, "build")
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling, per source (0.0 when the library was cached)
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use and need the CUDA toolkit")
    return path


def source_hash(source: str) -> str:
    """The build key of ``csrc/<source>``: a hash of its text and the nvcc
    flags (16 hex digits)."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _lib_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_ROOT, source_hash(source), f"lib{stem}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its hash-keyed library exists;
    returns the library path.  The output is written to a temporary name
    and renamed, so a concurrent or interrupted build never leaves a
    partial library behind."""
    out = _lib_path(source)
    if os.path.exists(out):
        BUILD_SECONDS.setdefault(source, 0.0)
        return out
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[source] = time.perf_counter() - t0
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first call."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _LIBS[source] = lib
        return lib


def build_all(sources) -> Dict[str, float]:
    """Compile several sources at once (one nvcc process each, all started
    together); returns the build seconds per source."""
    todo = [s for s in sources if not os.path.exists(_lib_path(s))]
    errors = []

    def run(s):
        try:
            build(s)
        except Exception as e:          # surfaced below, per source
            errors.append((s, e))

    threads = [threading.Thread(target=run, args=(s,)) for s in todo]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("; ".join(f"{s}: {e}" for s, e in errors))
    for s in sources:
        load(s)
    return {s: BUILD_SECONDS.get(s, 0.0) for s in sources}
