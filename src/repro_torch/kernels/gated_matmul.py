"""Gated matmul, the analogue of the paper's spatial SA gating — CUDA
kernel B2.

Replaces the Pallas TPU kernel ``src/repro/kernels/gated_matmul.py``
(``_kernel`` / ``gated_matmul_p``, wrapper ``ops.gated_matmul``). The
paper powers off the systolic-array rows and columns that hold only zero
weights (the col_nz/row_nz prefix bitmaps of Fig 12,
``core.sa_gating.prefix_on_bitmap``); software cannot gate a PE, but it
can skip the work of a weight tile that is entirely zero. The kernel
takes a per-(K-tile, N-tile) nonzero bitmap and skips, for a zero bit,
both the loads of that x/w tile pair and its multiply-adds (the Pallas
kernel skips only the dot). Its bound on the card and the reasons for its
design are in ``csrc/gated_matmul.cu``.

``gated_matmul_p`` launches the kernel for CUDA tensors and evaluates
``gated_matmul_plain`` for CPU tensors; nothing else selects between
them, and a kernel that fails to build or launch raises.
``gated_matmul_p.launches`` counts kernel launches, and
``gated_matmul_p.tiles_run`` counts executed ``(mi, ni, ki)`` tiles: an
int64 0-d tensor that follows the calls to their device (``int(...)``
reads it, ``.zero_()`` resets it).
"""
from __future__ import annotations

import torch

from repro_torch.core import costs
from repro_torch.kernels import _build

#: the block sizes the CUDA kernel is built for (bm, bn and bk each)
BLOCKS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1
_GRID_Y_MAX = 65535


def _check(x, w, bitmap, bm: int, bn: int, bk: int) -> tuple[int, int, int]:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"want x (M, K) and w (K, N), got {tuple(x.shape)} "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if min(bm, bn, bk) <= 0 or M % bm or N % bn or K % bk:
        raise ValueError(f"M, N, K = {(M, N, K)} must be multiples of the "
                         f"blocks bm, bn, bk = {(bm, bn, bk)}")
    if bitmap.shape != (K // bk, N // bn):
        raise ValueError(f"bitmap: want shape {(K // bk, N // bn)} "
                         f"(K/bk, N/bn), got {tuple(bitmap.shape)}")
    if not (x.device == w.device == bitmap.device):
        raise ValueError(f"x, w, bitmap on {x.device}, {w.device}, "
                         f"{bitmap.device}")
    return M, K, N


def gated_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       bitmap: torch.Tensor, *, bm: int = 128,
                       bn: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain PyTorch version of B2: the product of the live tiles only.

    For each K tile in order, the x columns of that tile times the w
    columns of its live N tiles, in float32; the sum cast to x's dtype.
    A tile is dropped by its bit, not by its values: a 0 over nonzero
    weights drops them, as in the Pallas kernel, and a NaN in x or w
    meets only the tiles that are run.
    """
    M, K, N = _check(x, w, bitmap, bm, bn, bk)
    live = bitmap != 0
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    xf, wf = x.float(), w.float()
    for ki in range(K // bk):
        cols = live[ki].repeat_interleave(bn)
        if not bool(cols.any()):
            continue
        ks = slice(ki * bk, (ki + 1) * bk)
        if bool(cols.all()):
            acc += xf[:, ks] @ wf[ks]
        else:
            acc[:, cols] += xf[:, ks] @ wf[ks][:, cols]
    return acc.to(x.dtype)


def _counter(device: torch.device) -> torch.Tensor:
    """``gated_matmul_p.tiles_run``, moved to ``device`` if it is not
    there (the count goes with it)."""
    cnt = gated_matmul_p.tiles_run
    if cnt.device != device:
        cnt = gated_matmul_p.tiles_run = cnt.to(device)
    return cnt


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, with a 16-byte aligned first element (the
    kernel's TMA tensor maps and vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gated_matmul_cost(x, w, bitmap, *, bm: int = 128, bn: int = 128,
                      bk: int = 128) -> tuple[float, float]:
    """``(flops, bytes)`` of one B2 call: 2 M bk bn operations a live
    weight tile (every tile of a fake bitmap, which holds no data); x, the
    live w tiles and the output moved once."""
    M, K = x.shape
    N = w.shape[1]
    bk, bn = int(bk), int(bn)
    if costs.is_fake(bitmap):
        live = bitmap.numel()
    else:
        with costs.uncounted():
            live = int((bitmap != 0).sum())
    nbytes = x.element_size() * (M * K + M * N) \
        + w.element_size() * live * bk * bn
    return 2.0 * M * bk * bn * live, float(nbytes)


@costs.counted("B2", gated_matmul_cost)
def gated_matmul_p(x: torch.Tensor, w: torch.Tensor, bitmap: torch.Tensor,
                   *, bm: int = 128, bn: int = 128,
                   bk: int = 128) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` with the weight tiles whose bit in
    ``bitmap`` (int32 ``(K/bk, N/bn)``) is 0 skipped; float32
    accumulation, the output ``(M, N)`` in x's dtype. M, N and K must be
    multiples of bm, bn and bk. On a CUDA tensor x and w are one dtype of
    ``DTYPES`` and each block is one of ``BLOCKS``. A cost counter is
    told ``gated_matmul_cost``; fake tensors launch nothing.
    """
    bm, bn, bk = int(bm), int(bn), int(bk)
    M, K, N = _check(x, w, bitmap, bm, bn, bk)
    dev = x.device
    if costs.is_fake(x):  # a dry run's: the output's shape, no work
        return torch.empty((M, N), dtype=x.dtype, device=dev)
    if dev.type != "cuda":
        out = gated_matmul_plain(x, w, bitmap, bm=bm, bn=bn, bk=bk)
        _counter(dev).add_((M // bm) * int((bitmap != 0).sum()))
        return out
    _build.check_no_grad("gated_matmul", (x, w), "B2 has no backward")
    if not {bm, bn, bk} <= set(BLOCKS):
        raise ValueError(f"blocks bm, bn, bk = {(bm, bn, bk)}: the kernel is "
                         f"built for {BLOCKS} each")
    if not (x.dtype == w.dtype) or x.dtype not in DTYPES:
        raise ValueError(f"want x and w of one dtype of {DTYPES}, got "
                         f"{x.dtype} {w.dtype}")
    if max(M, N, K) > _INT32_MAX or M // bm > _GRID_Y_MAX:
        raise ValueError(f"M, N, K = {(M, N, K)}: too large for the kernel's "
                         f"int32 sizes and {_GRID_Y_MAX} M tiles")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if out.numel() == 0:  # a zero-size grid is a launch error
        return out
    x, w = _aligned(x), _aligned(w)
    bitmap = bitmap.to(torch.int32).contiguous()
    cnt = _counter(dev)
    lib = _build.load("gated_matmul")
    with torch.cuda.device(dev):
        err = lib.gated_matmul_launch(
            int(x.dtype == torch.bfloat16), x.data_ptr(), w.data_ptr(),
            bitmap.data_ptr(), out.data_ptr(), cnt.data_ptr(), M, N, K,
            bm, bn, bk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gated_matmul")
    gated_matmul_p.launches += 1
    return out


gated_matmul_p.launches = 0
gated_matmul_p.tiles_run = torch.zeros((), dtype=torch.int64)
