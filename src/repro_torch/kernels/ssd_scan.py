"""Mamba-2 chunked SSD scan — CUDA kernel B5.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``
(``_kernel`` / ``ssd_scan_p``, wrapper ``ops.ssd_scan``), which computes
what the JAX model's ``blocks._ssd_chunk_scan`` computes at every SSD
prefill. The kernels, their bound on the card and the reasons for their
design are in ``csrc/ssd_scan.cu``; in short: one block per (head, batch)
walks the chunks in order with the ``(P, N)`` state on the chip from the
first chunk to the last; it takes the model's ``(B, S, nh, hd)`` x and
``(B, S, G, N)`` B/C (not repeated to heads) through strides, any S (the
ragged last chunk is masked), and writes the final state where the caller
asks (the model: its cache's layer slice). Bound by bytes at the serving
shape. bf16 runs on the tensor cores (``mma.sync``; C·Bᵀ computed once per
(batch, chunk, group) by a first kernel into a float32 workspace; x, B, C
loaded by TMA in a two-stage ring over the chunks; the state in
registers; every float32 operand as a bf16 hi/lo pair); float32 runs true
float32 FMAs on the CUDA cores.

``ssd_scan`` launches the kernels for CUDA tensors and evaluates
``ssd_scan_plain`` for CPU tensors; nothing else selects between them,
and a kernel that fails to build or launch raises. A bf16 x, B or C whose
rows do not start on 16-byte boundaries (TMA's rule, see
``flash_attention.rows_aligned``) is first copied densely.
``ssd_scan.launches`` counts wrapper calls that launched (one a call: the
bf16 route's two kernels count once).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import costs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (for_kernel,
                                                 kernel_strides)

#: the kernels' own chunk length (``csrc/ssd_scan.cu``), also the plain
#: version's default
CHUNK = 64
HEAD_DIMS = (16, 32, 64)          # P
STATE_DIMS = (16, 32, 64, 128)    # N
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30


def _check(x, dt, A, B, C) -> tuple[int, int, int, int, int, int]:
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"want x (B, S, nh, hd) and B/C (B, S, G, N); got "
                         f"{tuple(x.shape)} {tuple(B.shape)}")
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dt.shape != (Bz, S, H) or A.shape != (Bz, H):
        raise ValueError(f"want dt ({Bz}, {S}, {H}) and A ({Bz}, {H}); got "
                         f"{tuple(dt.shape)} {tuple(A.shape)}")
    if B.shape != (Bz, S, G, N) or C.shape != B.shape:
        raise ValueError(f"B/C must be ({Bz}, {S}, G, N) alike, got "
                         f"{tuple(B.shape)} {tuple(C.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"heads {H} must be a multiple of groups {G}")
    if S == 0:
        raise ValueError("empty sequence (S = 0)")
    if not (x.dtype == B.dtype == C.dtype) or x.dtype not in DTYPES:
        raise ValueError(f"want x, B, C of one dtype of {DTYPES}, got "
                         f"{x.dtype} {B.dtype} {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"want dt and A in float32, got {dt.dtype} "
                         f"{A.dtype}")
    devs = {t.device for t in (x, dt, A, B, C)}
    if len(devs) != 1:
        raise ValueError(f"x, dt, A, B, C on several devices: {devs}")
    return Bz, S, H, P, G, N


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int = CHUNK
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B5: the chunked einsum form of the JAX
    model path (``blocks._ssd_chunk_scan``), chunk for chunk, in the
    wrapper's layout. Groups are repeated to heads (head ``h`` reads group
    ``h // (nh // G)``); a ragged last chunk is padded with ``dt = 0``,
    ``x = B = C = 0``, as the kernel does. Returns y ``(B, S, nh, hd)``
    and the final state ``(B, nh, hd, N)``, both float32."""
    Bz, S, H, P, G, N = _check(x, dt, A, B, C)
    if H != G:
        B = B.repeat_interleave(H // G, dim=2)
        C = C.repeat_interleave(H // G, dim=2)
    Q = int(chunk)
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, Bf, Cf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    Af = A.float()[:, None, :]  # (B, 1, nh)
    dev = x.device
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=dev)
    iq = torch.arange(Q, device=dev)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq, Bq, Cq = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dtq * Af, dim=1)          # (B, Q, nh)
        # mask the log BEFORE exp: above the diagonal it is positive and
        # would overflow
        lmat = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Qi, Qj, nh)
        lmat = torch.exp(torch.where(causal, lmat,
                                     torch.full((), NEG_INF, device=dev)))
        scores = torch.einsum("bihn,bjhn->bijh", Cq, Bq)
        dx = dtq[..., None] * xq                      # (B, Q, nh, hd)
        y_intra = torch.einsum("bijh,bijh,bjhp->bihp", scores, lmat, dx)
        y_inter = torch.einsum("bihn,bhpn,bih->bihp", Cq, h, torch.exp(cum))
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)  # (B, Q, nh)
        s_chunk = torch.einsum("bjhn,bjhp,bjh->bhpn", Bq, dx, decay_to_end)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + s_chunk
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def _st(t: torch.Tensor, dims):
    return (ctypes.c_int64 * len(dims))(*(t.stride(i) for i in dims))


def _launch(lib, x, dt, A, B, C, y, state, *, stream: int) -> int:
    """One call of the C launcher of x's type; the arguments are already
    checked. bf16: x, B and C as TMA takes them (``for_kernel``), with
    ``kernel_strides``, and a float32 workspace for C·Bᵀ."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    common = (_st(dt, (0, 1, 2)), _st(A, (0, 1)))
    if x.dtype != torch.bfloat16:
        return lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), Bz, S, H, G, P, N,
            _st(x, (0, 1, 2)), *common, _st(B, (0, 1, 2)),
            _st(C, (0, 1, 2)), _st(state, (0, 1, 2)), stream)
    x, B, C = (for_kernel(t) for t in (x, B, C))
    cb = torch.empty((Bz, -(-S // CHUNK), G, CHUNK, CHUNK),
                     dtype=torch.float32, device=x.device)
    ks = [(ctypes.c_int64 * 3)(*kernel_strides(t)) for t in (x, B, C)]
    return lib.ssd_scan_bf16_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), cb.data_ptr(), Bz, S,
        H, G, P, N, ks[0], *common, ks[1], ks[2], _st(state, (0, 1, 2)),
        stream)


def bf16_occupancy(P: int = 64, N: int = 128) -> dict:
    """The bf16 scan kernel's residency at head dim ``P`` and state dim
    ``N`` on the current CUDA device: blocks per SM (by the CUDA
    occupancy calculator), registers a thread, static and dynamic shared
    memory a block in bytes."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.load("ssd_scan").ssd_scan_bf16_occupancy(P, N, out),
                 "ssd_scan_bf16_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "static_smem_bytes",
                     "dynamic_smem_bytes"), out))


def ssd_scan_cost(x, dt, A, B, C, **_) -> tuple[float, float]:
    """``(flops, bytes)`` of one B5 call, the chunk scan of ``CHUNK``
    rows: per (batch, group) and chunk the causal half of C B^T (2 N
    operations a pair); per (batch, head) and chunk its product with x
    (2 P a pair), the entering state's read-out C h and the state's
    update B^T x (2 P N a row each). x, B, C, dt and A read once, y
    (float32) and the final state written once."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = CHUNK
    nc = -(-S // Q)
    pairs = Q * (Q + 1) // 2
    flops = 2.0 * nc * (Bz * G * pairs * N
                        + Bz * H * (pairs * P + 2 * Q * P * N))
    el = x.element_size()
    nbytes = el * (Bz * S * H * P + 2 * Bz * S * G * N) + 4 * (
        Bz * S * H + H + Bz * S * H * P + Bz * H * P * N)
    return flops, float(nbytes)


@costs.counted("B5", ssd_scan_cost)
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *,
             out_state: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan over x ``(B, S, nh, hd)`` (bf16 or float32), dt
    ``(B, S, nh)`` float32 (after softplus), A ``(B, nh)`` float32
    (negative; any strides, e.g. an ``(nh,)`` vector expanded over the
    batch), B/C ``(B, S, G, N)`` in x's dtype with ``nh % G == 0``.
    Returns y ``(B, S, nh, hd)`` float32 and the final state
    ``(B, nh, hd, N)`` float32 — written into ``out_state`` when it is
    given (e.g. a cache's layer slice), which is then returned. A cost
    counter is told ``ssd_scan_cost``; fake tensors launch nothing.
    """
    Bz, S, H, P, G, N = _check(x, dt, A, B, C)
    dev = x.device
    if out_state is not None and (
            out_state.shape != (Bz, H, P, N)
            or out_state.dtype != torch.float32 or out_state.device != dev
            or out_state.stride(-1) != 1 or out_state.stride(-2) != N):
        raise ValueError(f"out_state: want float32 ({Bz}, {H}, {P}, {N}) on "
                         f"{dev} with its last two dims contiguous")
    if costs.is_fake(x):  # a dry run's: the outputs' shapes, no work
        y = torch.empty((Bz, S, H, P), dtype=torch.float32, device=dev)
        return y, (out_state if out_state is not None else torch.empty(
            (Bz, H, P, N), dtype=torch.float32, device=dev))
    if dev.type != "cuda":
        y, h = ssd_scan_plain(x, dt, A, B, C)
        if out_state is None:
            return y, h
        out_state.copy_(h)
        return y, out_state
    _build.check_no_grad("ssd_scan", (x, dt, A, B, C),
                  "train through repro_torch.models.blocks.ssd_fwd, whose "
                  "backward is kernel B10")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"head dim {P}, state dim {N}: the kernel is built "
                         f"for {HEAD_DIMS} x {STATE_DIMS}")
    if not all(t.stride(-1) == 1 for t in (x, B, C)):
        # float32: the kernel's loads are scalar, so no alignment beyond
        # the element's own is needed; bf16 rows that TMA cannot take are
        # copied by _launch
        raise ValueError("x, B and C must have a contiguous last dim")
    y = torch.empty((Bz, S, H, P), dtype=torch.float32, device=dev)
    state = out_state if out_state is not None else torch.empty(
        (Bz, H, P, N), dtype=torch.float32, device=dev)
    if Bz == 0 or H == 0:  # a zero-size grid is a launch error
        return y, state
    lib = _build.load("ssd_scan")
    with torch.cuda.device(dev):
        err = _launch(lib, x, dt, A, B, C, y, state,
                      stream=torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
