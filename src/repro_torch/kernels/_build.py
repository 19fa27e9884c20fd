"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. The first
``load`` in a process builds every library that is missing or older than
its own source or a shared header (``csrc/*.cuh``), one ``nvcc`` per
source, all started together; never at import (this module imports on a
machine with no ``nvcc``), and from the sources in the package and
nothing else. The libraries land in
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
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"

COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _bind_power_plane(lib: ctypes.CDLL) -> None:
    ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
    lib.sa_occupancy_launch.argtypes = [
        ptr, ptr, ptr, ptr, f64, i64, i64, ptr, ptr]
    lib.sa_occupancy_launch.restype = ctypes.c_int
    lib.segment_sum_launch.argtypes = [
        ptr, ptr, i64, i64, i64, ctypes.c_int, ptr, ptr]
    lib.segment_sum_launch.restype = ctypes.c_int


def _bind_attention(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
        ptr, ptr, ptr, f32, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.decode_attention_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
        i32, i32, ptr, ptr, ptr, f32, ptr]
    lib.decode_attention_launch.restype = ctypes.c_int


def _bind_attention_bwd(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_bwd_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, i32, f32, i32, i32, i32, i32, ptr]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int


def _bind_ssd_scan(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_bf16_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.ssd_scan_bf16_launch.restype = ctypes.c_int
    lib.ssd_scan_bf16_occupancy.argtypes = [i32, i32, ptr]
    lib.ssd_scan_bf16_occupancy.restype = ctypes.c_int


def _bind_ssd_scan_bwd(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
        ptr, ptr, ptr]
    lib.ssd_scan_bwd_launch.restype = ctypes.c_int


def _bind_gated_matmul(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gated_matmul_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.gated_matmul_launch.restype = ctypes.c_int


def _bind_program_plane(lib: ctypes.CDLL) -> None:
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.program_exec_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr,
        ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.program_exec_launch.restype = ctypes.c_int


@dataclass(frozen=True)
class Library:
    source: Path
    flags: tuple[str, ...]
    bind: Callable[[ctypes.CDLL], None]

    def file_name(self) -> str:
        return f"lib{self.source.stem}.so"


LIBRARIES = {
    # -fmad=false: K1 and K2 promise the same bits as their plain
    # versions, and a fused multiply-add rounds once where they round twice
    "power_plane": Library(CSRC / "power_plane.cu",
                           COMMON_FLAGS + ("-fmad=false",), _bind_power_plane),
    "attention": Library(CSRC / "attention.cu", COMMON_FLAGS,
                         _bind_attention),
    "attention_bwd": Library(CSRC / "attention_bwd.cu", COMMON_FLAGS,
                             _bind_attention_bwd),
    "ssd_scan": Library(CSRC / "ssd_scan.cu", COMMON_FLAGS, _bind_ssd_scan),
    "ssd_scan_bwd": Library(CSRC / "ssd_scan_bwd.cu", COMMON_FLAGS,
                            _bind_ssd_scan_bwd),
    "gated_matmul": Library(CSRC / "gated_matmul.cu", COMMON_FLAGS,
                            _bind_gated_matmul),
    # integers only: nothing for -fmad to change
    "program_plane": Library(CSRC / "program_plane.cu", COMMON_FLAGS,
                             _bind_program_plane),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: per library, what its build in this process cost and printed:
#: ``{"seconds", "command", "log"}``; a library found up to date reports
#: ``{"seconds": 0.0}``. Empty until the first ``load``.
BUILD_INFO: dict[str, dict] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def library_path(name: str) -> Path:
    return build_dir() / LIBRARIES[name].file_name()


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


def _stale() -> list[str]:
    """The libraries missing or older than their source or any shared
    header of ``csrc/``."""
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                  default=0.0)
    out = []
    for name, lib in LIBRARIES.items():
        path = library_path(name)
        if not path.exists() or path.stat().st_mtime \
                < max(lib.source.stat().st_mtime, headers):
            out.append(name)
        else:
            BUILD_INFO.setdefault(name, {"seconds": 0.0})
    return out


def _compile(names: list[str]) -> None:
    """One ``nvcc`` per library, all started together; each publishes
    its library atomically (several processes may find it missing)."""
    if not names:
        return
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        lib, out = LIBRARIES[name], library_path(name)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *lib.flags, "-o", str(tmp), str(lib.source)]
        jobs.append((name, out, tmp, cmd, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, out, tmp, cmd, t0, proc in jobs:
        try:
            stdout, stderr = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)
                BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                    "command": " ".join(cmd),
                                    "log": stderr.strip()}
            else:
                errors.append(f"nvcc failed ({proc.returncode}) on "
                              f"{LIBRARIES[name].source.name}:\n"
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        finally:
            if tmp.exists():
                tmp.unlink()
    if errors:
        raise RuntimeError("\n\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (a key of ``LIBRARIES``), loaded once per
    process. The first call builds every stale library of the package."""
    with _LOCK:
        if not _LIBS:
            _compile(_stale())
        if name not in _LIBS:
            lib = ctypes.CDLL(str(library_path(name)))
            LIBRARIES[name].bind(lib)
            _LIBS[name] = lib
        return _LIBS[name]


def check_no_grad(what: str, tensors, route: str) -> None:
    """Raise where a kernel would drop a gradient: a hand kernel's
    output has no ``grad_fn``, so a call with grad enabled on an input
    that requires it must not go ahead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no autograd and would "
                           f"drop the gradient; {route}")


def check(err: int, what: str) -> None:
    """Raise on a launcher's non-zero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
