"""Build and load the hand-written CUDA kernels.

``csrc/power_plane.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so the build takes seconds. It happens at first kernel
use, never at import (this module imports on a machine with no ``nvcc``),
from the sources in the package and nothing else. The library lands in
``build/repro_torch/`` at the root of the checkout, or in
``$REPRO_TORCH_BUILD_DIR``.

A failed build or load raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "power_plane.cu"
LIB_NAME = "libpower_plane.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: what the last build in this process cost and printed (``None`` until
#: a build ran; a library found up to date reports 0 seconds)
BUILD_INFO: dict = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are compiled at first use and "
        "cannot run without the CUDA toolkit")


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, publish atomically: several processes
    # may find the library missing at the same time
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      command=" ".join(cmd), log=proc.stderr.strip())


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.sa_occupancy_launch.argtypes = [
        ptr, ptr, ptr, ptr, f64, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.sa_occupancy_launch.restype = ctypes.c_int
    lib.segment_sum_launch.argtypes = [ptr, ptr, i64, i64, i64, ptr, ptr]
    lib.segment_sum_launch.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernels' library, built first if it is missing or older than
    its source. Loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            out = build_dir() / LIB_NAME
            if not out.exists() \
                    or out.stat().st_mtime < SOURCE.stat().st_mtime:
                _compile(out)
            else:
                BUILD_INFO.setdefault("seconds", 0.0)
            _LIB = _bind(ctypes.CDLL(str(out)))
        return _LIB


def check(err: int, what: str) -> None:
    """Raise on a launcher's non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
