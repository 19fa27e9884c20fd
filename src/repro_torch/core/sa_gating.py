"""Spatially power-gated systolic array model (paper §4.1, Figs 10–13).

A weight-stationary SAW x SAW systolic array computes [M,K] x [K,N].
K maps to SA rows, N to SA columns, M streams through diagonally.

Three underutilization cases (paper Fig 10):
  * N < SAW — right columns hold zero weights; they still would pass data
    rightward, but nothing to their right is live, so cols >= N are OFF.
  * K < SAW — bottom rows hold zero weights; rows >= K are OFF (prefix-sum
    over the row_nz bitmap keeps rows above live ones ON to pass data).
  * M < SAW — all live PEs must hold weights (W_on), but a PE is fully ON
    only while input data passes through it; the PE_on signal propagates
    diagonally with the dataflow, costing one PE's wake-up delay total.

Implementations of the closed-form 4-category ragged-tile math:
  * ``gating_stats_batch_xp`` — float64 tensor ops on whatever device
    the inputs live on. All intermediates are exact integers in float64
    (< 2**53), so it is bitwise identical to the int64 batch below. It
    is the plain PyTorch version of the ``sa_occupancy`` CUDA kernel
    (``repro_torch.kernels.sa_occupancy``): the kernel repeats this
    arithmetic in this order.
  * ``gating_stats_batch`` — vectorized int64 NumPy batch on the host
    (the oracle ``policies.trace_times`` uses), kept as an independent
    check of the float64 form.
  * ``gating_stats`` — LRU-cached scalar closed form (cache size
    configurable via ``set_gating_cache_size`` / ``$REPRO_SA_GATING_CACHE``
    so huge sweeps can bound it); ``gating_stats_reference`` /
    ``gating_stats_batch_reference`` are the uncached oracles, so
    equivalence tests never depend on cache state.
  * ``simulate_pe_grid`` — exact cycle-level simulation of the PE_on
    propagation on a small grid; the tests check the closed forms
    against it.

The prefix-sum row/col logic (paper Fig 12) is ``prefix_on_bitmap``. Its
tile-level analogue is the any-nonzero tile bitmap of the ``gated_matmul``
kernel (``repro_torch.kernels.ops.tile_nonzero_bitmap``).

The scalar half (everything but the two batch closed forms) is host
numpy, numpy in and numpy out, as in the reference.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from functools import lru_cache as _lru_cache

import numpy as np
import torch

STAT_KEYS = ("duration_cycles", "frac_on", "frac_w_on", "frac_off",
             "wake_events")


def prefix_on_bitmap(nz: np.ndarray) -> np.ndarray:
    """Paper Fig 12: a row/col is ON iff it or anything AFTER it is nonzero.

    (Column 0 must stay ON if column 1 is live, to pass data rightward.)
    ``nz``: bool (W,) — nonzero-weight bitmap. Returns bool (W,).
    """
    nz = np.asarray(nz, bool)
    return np.cumsum(nz[::-1])[::-1] > 0


@dataclass(frozen=True)
class SAStats:
    """PE-state cycle occupancy of one matmul on one SA (per-PE-cycle units,
    normalized by total PE-cycles = SAW*SAW*duration)."""

    duration_cycles: float     # total SA-busy cycles for the op
    frac_on: float             # fraction of PE-cycles fully ON
    frac_w_on: float           # fraction only weight-register powered
    frac_off: float            # fraction fully gated
    wake_events: int           # PE wake fronts (for delay accounting)

    @property
    def active_pe_fraction(self) -> float:
        return self.frac_on


def _tile_cycles(m: int, saw: int) -> float:
    """Cycles to stream m rows through a saw-wide SA (fill + drain)."""
    return m + 2 * saw - 1


def gating_stats_reference(M: int, K: int, N: int, saw: int,
                           weight_load_cycles: int | None = None) -> SAStats:
    """Closed-form PE-state occupancy for [M,K]x[K,N] tiled onto the SA.

    Tiling: ceil(K/saw) x ceil(N/saw) weight tiles; M rows stream per tile.
    Only the LAST tile in each dimension is ragged, so the tile population
    has 4 categories (full, ragged-K, ragged-N, ragged-both) — O(1) math.

    This is the *uncached* scalar oracle; ``gating_stats`` wraps it in a
    configurable LRU.
    """
    if weight_load_cycles is None:
        weight_load_cycles = saw  # weights pushed row by row
    kt = math.ceil(K / saw)
    nt = math.ceil(N / saw)
    k_last = K - (kt - 1) * saw
    n_last = N - (nt - 1) * saw
    cyc = _tile_cycles(M, saw) + weight_load_cycles
    on_per_live = min(M, cyc)           # diagonal ON occupancy per live PE
    won_per_live = max(0.0, cyc - M)

    # (multiplicity, live PEs) per tile category
    cats = (
        ((kt - 1) * (nt - 1), saw * saw),
        ((kt - 1), saw * n_last),
        ((nt - 1), k_last * saw),
        (1, k_last * n_last),
    )
    n_tiles = kt * nt
    live_total = sum(m * live for m, live in cats)
    on = live_total * on_per_live
    w_on = live_total * won_per_live
    duration = n_tiles * cyc
    total_pe_cycles = saw * saw * duration
    off = total_pe_cycles - on - w_on
    return SAStats(
        duration_cycles=duration,
        frac_on=on / total_pe_cycles,
        frac_w_on=w_on / total_pe_cycles,
        frac_off=off / total_pe_cycles,
        wake_events=n_tiles,
    )


# The scalar closed form sits behind an LRU because the scalar engine
# calls it per op; a bounded default keeps huge generated sweeps from
# growing the cache without limit. The public ``gating_stats`` delegates
# through a module global so resizing never invalidates callers that
# imported the function object directly.
_DEFAULT_CACHE_SIZE = int(os.environ.get("REPRO_SA_GATING_CACHE", 65536))
_cached_gating_stats = _lru_cache(maxsize=_DEFAULT_CACHE_SIZE)(
    gating_stats_reference)


def gating_stats(M: int, K: int, N: int, saw: int,
                 weight_load_cycles: int | None = None) -> SAStats:
    """LRU-cached ``gating_stats_reference`` (see there for the math)."""
    return _cached_gating_stats(M, K, N, saw, weight_load_cycles)


def set_gating_cache_size(maxsize: int | None) -> int | None:
    """Resize the ``gating_stats`` LRU (dropping its contents); returns
    the previous maxsize. ``None`` means unbounded, ``0`` disables
    caching entirely. Correctness never depends on cache state
    (``gating_stats_reference`` / ``gating_stats_batch_reference`` are
    the cache-free oracles)."""
    global _cached_gating_stats
    prev = _cached_gating_stats.cache_info().maxsize
    _cached_gating_stats = _lru_cache(maxsize=maxsize)(
        gating_stats_reference)
    return prev


def gating_cache_info():
    """``functools.lru_cache`` statistics of the scalar closed form."""
    return _cached_gating_stats.cache_info()


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


def gating_stats_batch_reference(M, K, N, saw,
                                 weight_load_cycles=None) -> SAStatsBatch:
    """Loop-of-scalars oracle for the batch implementations: calls the
    *uncached* closed form per element, so equivalence tests depend on
    neither vectorization nor LRU state."""
    M, K, N, saw_a = np.broadcast_arrays(
        np.asarray(M, np.int64), np.asarray(K, np.int64),
        np.asarray(N, np.int64), np.asarray(saw, np.int64))
    wlc = np.broadcast_to(
        np.asarray(-1 if weight_load_cycles is None else weight_load_cycles,
                   np.int64), M.shape)
    stats = [gating_stats_reference(
        int(m), int(k), int(n), int(s),
        None if w < 0 else int(w))
        for m, k, n, s, w in zip(M.ravel(), K.ravel(), N.ravel(),
                                 saw_a.ravel(), wlc.ravel())]

    def col(attr, dtype=np.float64):
        return np.array([getattr(s, attr) for s in stats],
                        dtype).reshape(M.shape)

    return SAStatsBatch(
        duration_cycles=col("duration_cycles"),
        frac_on=col("frac_on"), frac_w_on=col("frac_w_on"),
        frac_off=col("frac_off"),
        wake_events=col("wake_events", np.int64))


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


def spatial_efficiency(M: int, K: int, N: int, saw: int) -> float:
    """Achieved/peak FLOPs while the SA is active (paper Fig 5 metric):
    useful MAC-cycles over total PE-cycles of the busy window."""
    st = gating_stats(M, K, N, saw)
    flops_cycles_needed = M * K * N / (saw * saw)  # perfect PE-cycles
    return min(1.0, flops_cycles_needed / max(1e-12, st.duration_cycles))


# --------------------------------------------------------------------------
# Exact cycle-level reference simulation (small grids; used by tests)
# --------------------------------------------------------------------------

def simulate_pe_grid(M: int, K: int, N: int, saw: int) -> dict:
    """Cycle-accurate PE_on propagation for ONE weight tile (K,N <= saw).

    Weight-stationary: weights W[0:K, 0:N] nonzero, rest zero-padded.
    Row r receives input element m at cycle m + r (diagonal skew); PE (r,c)
    is ON at cycle t iff it is processing some input, i.e.
    t - r - c in [0, M). Rows >= K / cols >= N handled by the prefix
    bitmaps. Returns per-state PE-cycle counts.

    NumPy-broadcast: instead of walking the (t, r, c) cube, the number of
    ON cycles of a live PE is the size of the integer interval
    [max(0, r+c), min(total, r+c+M)) — integer-exact, so results are
    bitwise equal to ``simulate_pe_grid_reference``.
    """
    nz_row = prefix_on_bitmap(np.arange(saw) < K)
    nz_col = prefix_on_bitmap(np.arange(saw) < N)
    total_cycles = int(_tile_cycles(M, saw))
    live = nz_row[:, None] & nz_col[None, :]
    rc = np.arange(saw)[:, None] + np.arange(saw)[None, :]
    on_per_pe = np.clip(np.minimum(total_cycles, rc + M)
                        - np.maximum(0, rc), 0, None)
    n_live = int(live.sum())
    on = int(on_per_pe[live].sum())
    w_on = n_live * total_cycles - on
    off = (saw * saw - n_live) * total_cycles
    return {"on": on, "w_on": w_on, "off": off,
            "total": saw * saw * total_cycles}


def simulate_pe_grid_reference(M: int, K: int, N: int, saw: int) -> dict:
    """Pure-Python triple loop over (t, r, c); O(saw²·cycles).

    The ground-truth oracle for the vectorized ``simulate_pe_grid`` (the
    tests check them bitwise equal on randomized shapes).
    """
    nz_row = prefix_on_bitmap(np.arange(saw) < K)
    nz_col = prefix_on_bitmap(np.arange(saw) < N)
    total_cycles = _tile_cycles(M, saw)
    on = w_on = off = 0
    for t in range(int(total_cycles)):
        for r in range(saw):
            for c in range(saw):
                if not (nz_row[r] and nz_col[c]):
                    off += 1
                    continue
                if 0 <= t - r - c < M:
                    on += 1
                else:
                    w_on += 1
    return {"on": on, "w_on": w_on, "off": off,
            "total": saw * saw * int(total_cycles)}
