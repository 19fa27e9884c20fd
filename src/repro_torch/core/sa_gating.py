"""Spatially power-gated systolic array model (paper §4.1, Figs 10–13).

A weight-stationary SAW x SAW systolic array computes [M,K] x [K,N].
K maps to SA rows, N to SA columns, M streams through diagonally.

Three underutilization cases (paper Fig 10):
  * N < SAW — right columns hold zero weights; cols >= N are OFF.
  * K < SAW — bottom rows hold zero weights; rows >= K are OFF.
  * M < SAW — all live PEs must hold weights (W_on), but a PE is fully ON
    only while input data passes through it; the PE_on signal propagates
    diagonally with the dataflow, costing one PE's wake-up delay total.

Two implementations of the closed-form 4-category ragged-tile math:
  * ``gating_stats_batch_xp`` — float64 tensor ops on whatever device
    the inputs live on. All intermediates are exact integers in float64
    (< 2**53), so it is bitwise identical to the int64 batch below. It
    is the plain PyTorch version of the ``sa_occupancy`` CUDA kernel
    (``repro_torch.kernels.sa_occupancy``): the kernel repeats this
    arithmetic in this order.
  * ``gating_stats_batch`` — vectorized int64 NumPy batch on the host,
    kept as an independent check of the float64 form.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

STAT_KEYS = ("duration_cycles", "frac_on", "frac_w_on", "frac_off",
             "wake_events")


@dataclass(frozen=True)
class SAStatsBatch:
    """PE-state cycle occupancy over arrays of matmul shapes (one entry
    per shape), normalized by total PE-cycles = SAW*SAW*duration."""

    duration_cycles: np.ndarray
    frac_on: np.ndarray
    frac_w_on: np.ndarray
    frac_off: np.ndarray
    wake_events: np.ndarray


def gating_stats_batch(M, K, N, saw,
                       weight_load_cycles: int | None = None) -> SAStatsBatch:
    """Closed-form PE-state occupancy over arrays of (M, K, N), int64 on
    the host.

    Tiling: ceil(K/saw) x ceil(N/saw) weight tiles; M rows stream per
    tile. Only the LAST tile in each dimension is ragged, so the tile
    population has 4 categories (full, ragged-K, ragged-N, ragged-both).
    ``saw`` may be a scalar or an array broadcastable against the dims.
    """
    M = np.asarray(M, np.int64)
    K = np.asarray(K, np.int64)
    N = np.asarray(N, np.int64)
    saw_a = np.asarray(saw, np.int64)
    wlc = saw_a if weight_load_cycles is None else np.asarray(
        weight_load_cycles, np.int64)
    kt = -(-K // saw_a)
    nt = -(-N // saw_a)
    k_last = K - (kt - 1) * saw_a
    n_last = N - (nt - 1) * saw_a
    cyc = (M + 2 * saw_a - 1) + wlc
    on_per_live = np.minimum(M, cyc).astype(np.float64)
    won_per_live = np.maximum(0.0, (cyc - M).astype(np.float64))
    live_total = ((kt - 1) * (nt - 1) * saw_a * saw_a
                  + (kt - 1) * saw_a * n_last
                  + (nt - 1) * k_last * saw_a
                  + k_last * n_last).astype(np.float64)
    n_tiles = kt * nt
    on = live_total * on_per_live
    w_on = live_total * won_per_live
    duration = n_tiles.astype(np.float64) * cyc
    total = saw_a.astype(np.float64) * saw_a * duration
    off = total - on - w_on
    return SAStatsBatch(
        duration_cycles=duration,
        frac_on=on / total,
        frac_w_on=w_on / total,
        frac_off=off / total,
        wake_events=n_tiles,
    )


def gating_stats_batch_xp(M: torch.Tensor, K: torch.Tensor, N: torch.Tensor,
                          saw, weight_load_cycles=None) -> dict:
    """The same closed form in float64 tensor ops.

    ``M/K/N`` are float64 tensors of exact integers; ``saw`` and
    ``weight_load_cycles`` are Python numbers or float64 tensors that
    broadcast against them — a ``(S, 1)`` width column against ``(n,)``
    dims gives ``(S, n)`` results, which is how the sweep kernel carries
    SA width as a batch axis. All intermediate tile counts and PE-cycle
    totals are exact integers in float64 (far below 2**53), so the
    results are bitwise identical to the int64 ``gating_stats_batch``.
    Degenerate rows (K or N zero — never produced by real traces) yield
    zeros instead of dividing by zero.

    Returns a dict of float64 tensors: ``duration_cycles``, ``frac_on``,
    ``frac_w_on``, ``frac_off``, ``wake_events``.
    """
    f8 = torch.float64
    dev = M.device
    saw = torch.as_tensor(saw, dtype=f8, device=dev)
    wlc = saw if weight_load_cycles is None \
        else torch.as_tensor(weight_load_cycles, dtype=f8, device=dev)
    # ceil(K/saw) on exact float64 integers: the quotient is correctly
    # rounded and 1/saw >= 2**-53 away from the next integer, so floor
    # can never land on the wrong side
    kt = torch.floor((K + saw - 1.0) / saw)
    nt = torch.floor((N + saw - 1.0) / saw)
    k_last = K - (kt - 1.0) * saw
    n_last = N - (nt - 1.0) * saw
    cyc = (M + 2.0 * saw - 1.0) + wlc
    on_per_live = torch.minimum(M, cyc)
    won_per_live = (cyc - M).clamp_min(0.0)
    live_total = ((kt - 1.0) * (nt - 1.0) * saw * saw
                  + (kt - 1.0) * saw * n_last
                  + (nt - 1.0) * k_last * saw
                  + k_last * n_last)
    n_tiles = kt * nt
    on = live_total * on_per_live
    w_on = live_total * won_per_live
    duration = n_tiles * cyc
    total = saw * saw * duration
    off = total - on - w_on
    # total is an exact integer >= 1 for all valid shapes, so the guard
    # only rescues degenerate rows (it never changes a real quotient)
    denom = total.clamp_min(1.0)
    return {
        "duration_cycles": duration,
        "frac_on": on / denom,
        "frac_w_on": w_on / denom,
        "frac_off": off / denom,
        "wake_events": n_tiles,
    }
