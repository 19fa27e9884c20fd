"""Sorted-id segmented sum with a fixed add order — CUDA kernel K2.

Replaces ``jax.ops.segment_sum(..., indices_are_sorted=True)`` as the
JAX package's ``core/backend.py::JaxBackend.segment_sum`` calls it (XLA
compiled it into the one jitted sweep program); the reference's oracle
is ``np.bincount`` (``NumpyBackend.segment_sum``). The kernel, its bound
and its design are in ``csrc/power_plane.cu``; in short: the bound is
one read of ``data`` and one write of the result; the add order is
fixed — each segment left to right from 0.0, as ``np.bincount`` — so the
result has the same bits as the CPU plain version and from run to run,
which an atomic scatter-add (or any tree) cannot promise. A block stages
a row's span through shared memory in sub-tiles that land on mbarriers
of their own, and each segment's one owner thread adds from there as
soon as its sub-tile has arrived, so the only serial part left is the
chain of adds of the longest segment. ``stage_subtiles`` sizes the
staging window. A launch whose runs of segments are short enough to be
one load a thread on average (the idle-gap chunks) reads straight from
device memory instead, in the same order.

``segment_sum`` launches the kernel for CUDA tensors and evaluates
``segment_sum_plain`` for CPU tensors; nothing else selects between
them, and a kernel that fails to build or launch raises.
``segment_sum.launches`` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

SEGS_PER_BLOCK = 128  # consecutive segments a block owns (csrc k2::THREADS)
SUB = 1024            # elements per staged sub-tile (k2::SUB)
MAX_SUBS = 12         # sub-tiles per window, 96 KB (k2::MAX_SUBS)


def stage_subtiles(n: int, num_segments: int) -> int:
    """Sub-tiles of ``SUB`` elements in the kernel's staging window: about
    twice the mean span of a block's run of ``SEGS_PER_BLOCK`` segments,
    within ``[1, MAX_SUBS]``. A longer span takes several windows, with
    the same sums; the window sets only the shared memory a block holds
    (and so how many blocks share an SM), never the add order."""
    if num_segments <= 0 or n <= 0:
        return 1
    span = n * min(SEGS_PER_BLOCK, num_segments) / num_segments
    return max(1, min(MAX_SUBS, math.ceil(2 * span / SUB)))


def segment_starts(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``(num_segments + 1,)`` int64 range bounds of sorted ``seg_ids``:
    segment ``s`` owns ``[starts[s], starts[s+1])``. Empty segments get
    an empty range; ids >= ``num_segments`` fall outside every range.
    Computed on the ids' device, so a caller that sums over the same id
    vector many times can compute it once and pass it as ``starts=``."""
    edges = torch.arange(num_segments + 1, dtype=torch.int64,
                         device=seg_ids.device)
    return torch.searchsorted(seg_ids, edges)


def segment_sum_plain(data: torch.Tensor, seg_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of K2: ``index_add_`` over the last axis.

    The leading axes are folded into the ids (row ``b`` adds into slots
    ``b * num_segments + id``) so the add is ONE 1-D ``index_add_``; on
    the CPU that is a serial loop in index order, i.e. left to right
    within every segment, the order of ``np.bincount``."""
    lead = data.shape[:-1]
    # (B, n) with B spelled out: reshape(-1, 0) is ambiguous
    rows = data.reshape(math.prod(lead), data.shape[-1])
    keep = seg_ids < num_segments
    if not bool(keep.all()):
        # ids past the last segment are dropped, as bincount[:num] does
        rows, seg_ids = rows[:, keep], seg_ids[keep]
    b = rows.shape[0]
    slot = seg_ids[None, :] + num_segments * torch.arange(
        b, dtype=torch.int64, device=data.device)[:, None]
    out = torch.zeros(b * num_segments, dtype=torch.float64,
                      device=data.device)
    out.index_add_(0, slot.reshape(-1), rows.reshape(-1))
    return out.reshape(*lead, num_segments)


def segment_sum(data: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int,
                starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment sums over the last axis of ``data``.

    ``data``: float64 ``(..., n)``; ``seg_ids``: int64 ``(n,)``, sorted
    ascending, on the same device; returns float64
    ``(..., num_segments)`` with empty segments 0. ``starts`` optionally
    carries ``segment_starts(seg_ids, num_segments)`` computed earlier.
    """
    if data.dtype != torch.float64 or data.dim() < 1:
        raise ValueError(f"data: want float64 (..., n), got {data.dtype} "
                         f"{tuple(data.shape)}")
    n = data.shape[-1]
    if seg_ids.dtype != torch.int64 or seg_ids.shape != (n,) \
            or seg_ids.device != data.device:
        raise ValueError(
            f"seg_ids: want int64 ({n},) on {data.device}, got "
            f"{seg_ids.dtype} {tuple(seg_ids.shape)} on {seg_ids.device}")
    num_segments = int(num_segments)
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if data.device.type != "cuda":
        return segment_sum_plain(data, seg_ids, num_segments)

    dev = data.device
    lead = data.shape[:-1]
    batch = math.prod(lead)
    rows = data.reshape(batch, n).contiguous()
    if n == 0 or num_segments == 0 or batch == 0:
        # nothing to add, and a zero-size grid is a launch error
        return torch.zeros(*lead, num_segments, dtype=torch.float64,
                           device=dev)
    if starts is None:
        starts = segment_starts(seg_ids, num_segments)
    elif starts.dtype != torch.int64 or starts.device != dev \
            or starts.shape != (num_segments + 1,):
        raise ValueError(
            f"starts: want int64 ({num_segments + 1},) on {dev}, got "
            f"{starts.dtype} {tuple(starts.shape)} on {starts.device}")
    starts = starts.contiguous()
    if rows.data_ptr() % 16:  # the kernel's 16-byte copies line up
        rows = rows.clone()
    out = torch.empty(batch, num_segments, dtype=torch.float64, device=dev)
    lib = _build.load("power_plane")
    with torch.cuda.device(dev):
        err = lib.segment_sum_launch(
            rows.data_ptr(), starts.data_ptr(), n, num_segments, batch,
            stage_subtiles(n, num_segments), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out.reshape(*lead, num_segments)


segment_sum.launches = 0
