"""SA PE-occupancy closed form (paper §4.1, Fig 10) — CUDA kernel K1.

Replaces the Pallas TPU kernel ``src/repro/kernels/sa_occupancy.py``
(``_kernel`` / ``sa_occupancy_p``). The kernel itself, its bound on the
card and the reasons for its design are in ``csrc/power_plane.cu``; in
short: 64 bytes per (width, op) element and a few dozen float64
operations, so at the sweep's size one launch's latency is the floor,
and the design makes the whole ``(S, n)`` pass exactly one launch — the
unique-width axis is a grid dimension.

``sa_occupancy`` launches the kernel for CUDA tensors and evaluates
``sa_occupancy_plain`` (the same arithmetic in tensor ops) for CPU
tensors; nothing else selects between them, and a kernel that fails to
build or launch raises. ``sa_occupancy.launches`` counts kernel
launches.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.sa_gating import STAT_KEYS, gating_stats_batch_xp
from repro_torch.kernels import _build


def _width_column(saw, device) -> tuple[torch.Tensor, bool]:
    """``saw`` as a float64 ``(S,)`` tensor + whether it was a scalar."""
    saw_t = torch.as_tensor(saw, dtype=torch.float64, device=device)
    if saw_t.dim() > 1:
        raise ValueError(f"saw must be a scalar or (S,), got shape "
                         f"{tuple(saw_t.shape)}")
    return saw_t.reshape(-1).contiguous(), saw_t.dim() == 0


def sa_occupancy_plain(mm_m: torch.Tensor, mm_k: torch.Tensor,
                       mm_n: torch.Tensor, saw,
                       weight_load_cycles=None) -> dict:
    """Plain PyTorch version of K1: ``gating_stats_batch_xp`` with the
    width as a leading batch axis. Same shapes as ``sa_occupancy``."""
    saw_v, scalar = _width_column(saw, mm_m.device)
    st = gating_stats_batch_xp(mm_m, mm_k, mm_n, saw_v[:, None],
                               weight_load_cycles)
    return {k: (v[0] if scalar else v) for k, v in st.items()}


def sa_occupancy(mm_m: torch.Tensor, mm_k: torch.Tensor, mm_n: torch.Tensor,
                 saw, weight_load_cycles=None) -> dict:
    """Per-op SA occupancy stats for ``[M,K]x[K,N]`` matmul streams.

    ``mm_m/mm_k/mm_n``: ``(n,)`` float64 matmul dims (exact integers);
    ``saw``: SA width, a scalar or an ``(S,)`` float64 tensor of widths;
    ``weight_load_cycles``: optional scalar override (``None`` → saw).
    Returns a dict of five float64 tensors (``STAT_KEYS``), ``(n,)`` for
    a scalar width and ``(S, n)`` for a width vector.
    """
    dims = (mm_m, mm_k, mm_n)
    for name, a in zip(("mm_m", "mm_k", "mm_n"), dims):
        if a.dtype != torch.float64 or a.dim() != 1 \
                or a.shape != mm_m.shape or a.device != mm_m.device:
            raise ValueError(
                f"{name}: want a float64 (n,) tensor on {mm_m.device}, "
                f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    if weight_load_cycles is not None and float(weight_load_cycles) < 0.0:
        raise ValueError(f"weight_load_cycles must be >= 0, got "
                         f"{float(weight_load_cycles)}")
    if mm_m.device.type != "cuda":
        return sa_occupancy_plain(mm_m, mm_k, mm_n, saw, weight_load_cycles)

    dev = mm_m.device
    saw_v, scalar = _width_column(saw, dev)
    n, n_saw = mm_m.shape[0], saw_v.shape[0]
    shape = (n,) if scalar else (n_saw, n)
    if n == 0 or n_saw == 0:  # a zero-size grid is a launch error
        return dict(zip(STAT_KEYS, torch.zeros(
            (len(STAT_KEYS), *shape), dtype=torch.float64,
            device=dev).unbind(0)))
    # the kernel reads a negative value as "default to the width"
    wlc = -1.0 if weight_load_cycles is None else float(weight_load_cycles)
    dims = tuple(a.contiguous() for a in dims)
    # one buffer, the five outputs its planes
    out = torch.empty((len(STAT_KEYS), *shape), dtype=torch.float64,
                      device=dev)
    lib = _build.load("power_plane")
    with contextlib.nullcontext() if dev.index == torch.cuda.current_device() \
            else torch.cuda.device(dev):
        err = lib.sa_occupancy_launch(
            *(a.data_ptr() for a in dims), saw_v.data_ptr(), wlc, n, n_saw,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "sa_occupancy")
    sa_occupancy.launches += 1
    return dict(zip(STAT_KEYS, out.unbind(0)))


sa_occupancy.launches = 0
