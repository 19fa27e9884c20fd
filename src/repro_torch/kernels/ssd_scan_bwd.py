"""The backward of the Mamba-2 chunked SSD scan — CUDA kernel B10.

Replaces no Pallas kernel: the JAX package trains its SSD layers through
``jax.vjp`` of ``blocks._ssd_chunk_scan`` (``src/repro/models/blocks.py:
510``). On the card the port's forward is kernel B5 (``ssd_scan``), which
keeps nothing for a backward; B10 takes B5's inputs and the gradient of
its output y (and, when given, of its final state) and returns dx, ddt,
dA, dB, dC. The kernel, its bound and the reasons for its design are in
``csrc/ssd_scan_bwd.cu``; in short, four kernels, each a pass over the
chunks of 64 positions, chunk-parallel (Mamba-2's chunked algorithm):
(1) per (chunk, head) the in-chunk cumsum and the chunk's own contribution
to the state s_c and to the state's gradient d_c; (2) the only serial part, two elementwise walks over the
chunks that turn s_c into the state entering each chunk and d_c into the
gradient of the state leaving it (the final state's gradient seeds the
reverse walk); (3) per (chunk, head) every gradient of the chunk from
those two alone; (4) dB and dC summed over a group's heads in head order,
dA over the chunks in chunk order. The bf16 route's products run on the
tensor cores (``mma.sync``, float32 operands as bf16 hi/lo pairs), the
float32 route's on the CUDA cores; every sum in a fixed order and no float
atomic, so a result is the same from run to run (the training loop's
bit-exact resume rests on it). The workspaces are float32 tensors the
wrapper allocates (``WORKSPACES``).

``ssd_scan_bwd`` launches the kernels for CUDA tensors and evaluates
``ssd_scan_bwd_plain`` for CPU tensors; nothing else selects between
them, and a kernel that fails to build or launch raises.
``ssd_scan_bwd.launches`` counts wrapper calls that launched (one a call:
its four kernels count once).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import costs
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import (CHUNK, HEAD_DIMS, STATE_DIMS, _check,
                                          _st, ssd_scan_plain)


def _check_bwd(x, dt, A, B, C, dy, dstate):
    Bz, S, H, P, G, N = _check(x, dt, A, B, C)
    if dy.shape != (Bz, S, H, P) or dy.dtype != torch.float32:
        raise ValueError(f"dy: want float32 ({Bz}, {S}, {H}, {P}), got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    if dstate is not None and (dstate.shape != (Bz, H, P, N)
                               or dstate.dtype != torch.float32):
        raise ValueError(f"dstate: want float32 ({Bz}, {H}, {P}, {N}), got "
                         f"{dstate.dtype} {tuple(dstate.shape)}")
    devs = {t.device for t in (x, dy) + ((dstate,) if dstate is not None
                                         else ())}
    if len(devs) != 1:
        raise ValueError(f"x, dy, dstate on several devices: {devs}")
    return Bz, S, H, P, G, N


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate=None):
    """Plain PyTorch version of B10 (CPU tensors only): autograd through
    ``ssd_scan_plain`` (in the kernel's chunks) for the output gradient
    ``dy`` (and ``dstate`` on the final state, where given). Returns dx,
    ddt, dA, dB, dC of the inputs' shapes and dtypes (dB and dC per group:
    its heads summed)."""
    _check_bwd(x, dt, A, B, C, dy, dstate)
    if x.device.type != "cpu":
        raise ValueError("ssd_scan_bwd_plain takes CPU tensors; on the card "
                         "the kernel runs")
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
    with torch.enable_grad():
        y, h = ssd_scan_plain(*leaves)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(h)
            grads.append(dstate)
        torch.autograd.backward(outs, grads)
    return tuple(t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in leaves)


def _launch(lib, x, dt, A, B, C, dy, dstate, dx, ddt, dA, dB, dC, ws, *,
            stream: int) -> int:
    """One call of the C launcher; the arguments are already checked and
    ``ws`` holds the float32 workspaces (``_workspaces``)."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    return lib.ssd_scan_bwd_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        *(ws[k].data_ptr() for k in WORKSPACES), Bz, S, H, G, P, N,
        _st(x, (0, 1, 2)), _st(dt, (0, 1, 2)), _st(A, (0, 1)),
        _st(B, (0, 1, 2)), _st(C, (0, 1, 2)), stream)


#: the kernels' float32 workspaces, in the launcher's order: dB and dC per
#: head (B, S, H, N); s_c / h_c and d_c / dH_c per chunk (B, H, nc, P, N);
#: the in-chunk cumsums (B, H, nc * 64); each chunk's sum dt da (B, H, nc)
WORKSPACES = ("dB_ws", "dC_ws", "states", "dstates", "cum", "da")


def _workspaces(Bz, S, H, P, N, dev) -> dict:
    nc = -(-S // CHUNK)
    shapes = {"dB_ws": (Bz, S, H, N), "dC_ws": (Bz, S, H, N),
              "states": (Bz, H, nc, P, N), "dstates": (Bz, H, nc, P, N),
              "cum": (Bz, H, nc * CHUNK), "da": (Bz, H, nc)}
    return {k: torch.empty(shapes[k], dtype=torch.float32, device=dev)
            for k in WORKSPACES}


def ssd_scan_bwd_cost(x, dt, A, B, C, *_) -> tuple[float, float]:
    """``(flops, bytes)`` of one B10 call, the chunked backward's products
    per (batch, head) and chunk of ``CHUNK``: the causal half of the
    chunk's C B^T, dy x^T and the three products that read it back
    (3 N + 2 P multiply-adds a pair), and five P N Q products (the
    entering state's recompute, C's and B's state terms, dH B, the state
    gradient's update); x, dt, A, B, C and dy read once, dx, ddt, dA, dB,
    dC written once."""
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Q = CHUNK
    nc = -(-S // Q)
    fmas = Bz * H * nc * (Q * (Q + 1) // 2 * (3 * N + 2 * P) + 5 * P * N * Q)
    el = x.element_size()
    nbytes = 2 * el * (Bz * S * H * P + 2 * Bz * S * G * N) + 4 * (
        2 * Bz * S * H + 2 * Bz * H + Bz * S * H * P)
    return 2.0 * fmas, float(nbytes)


@costs.counted("B10", ssd_scan_bwd_cost)
def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                 dstate: Optional[torch.Tensor] = None):
    """dx, ddt, dA, dB, dC of ``y, state = ssd_scan(x, dt, A, B, C)`` for
    the gradients ``dy`` (float32, y's shape) and ``dstate`` (float32
    ``(B, nh, hd, N)``, or None: the state feeds nothing). The inputs as
    ``ssd_scan`` takes them; dx, dB, dC come back in x's dtype (dB and dC
    per group, ``(B, S, G, N)``: its heads summed), ddt ``(B, S, nh)`` and
    dA ``(B, nh)`` in float32. A cost counter is told
    ``ssd_scan_bwd_cost``; fake tensors launch nothing."""
    Bz, S, H, P, G, N = _check_bwd(x, dt, A, B, C, dy, dstate)
    dev = x.device
    if costs.is_fake(x):  # a dry run's: the outputs' shapes, no work
        return (torch.empty_like(x), torch.empty_like(dt),
                torch.empty((Bz, H), dtype=torch.float32, device=dev),
                torch.empty_like(B), torch.empty_like(C))
    if dev.type != "cuda":
        return ssd_scan_bwd_plain(x, dt, A, B, C, dy, dstate)
    _build.check_no_grad("ssd_scan_bwd", (x, dt, A, B, C, dy),
                         "it is the backward of models.blocks.ssd_fwd on "
                         "the card")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"head dim {P}, state dim {N}: the kernel is built "
                         f"for {HEAD_DIMS} x {STATE_DIMS}")
    if not all(t.stride(-1) == 1 for t in (x, B, C)):
        raise ValueError("x, B and C must have a contiguous last dim")
    dy = dy.contiguous()
    dstate = None if dstate is None else dstate.contiguous()
    dx = torch.empty((Bz, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bz, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((Bz, H), dtype=torch.float32, device=dev)
    dB = torch.empty((Bz, S, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty_like(dB)
    if Bz * S * H == 0:  # a zero-size grid is a launch error
        return dx, ddt.zero_(), dA.zero_(), dB.zero_(), dC.zero_()
    ws = _workspaces(Bz, S, H, P, N, dev)
    lib = _build.load("ssd_scan_bwd")
    with torch.cuda.device(dev):
        err = _launch(lib, x, dt, A, B, C, dy, dstate, dx, ddt, dA, dB, dC,
                      ws, stream=torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_scan_bwd.launches = 0
