"""Blocked attention with causal, sliding-window and prefix-LM masks and
tile skipping — CUDA kernel B3.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``_kernel`` / ``flash_attention_p``, wrapper ``ops.flash_attention``).
The kernel, its bound on the card and the reasons for its design are in
``csrc/attention.cu``; in short: at the serving path's prefill it is
bound by operations (thousands per byte), it takes the model's
``(B, S, H, D)`` / ``(B, S, Hkv, D)`` layout through strides with no
transpose or head repeat, and its key loop stops at the diagonal, so the
tiles the causal mask would zero are never loaded. Beyond the Pallas
kernel it takes a value head dim of v's own (multi-head latent
attention's q/k 192 with v 128, and the reduced config's 24 with v 16,
``HEAD_DIM_PAIRS``), the JAX model path's other masks (a sliding
``window``, a bidirectional ``prefix_len``; ``ref.attention_mask``) and
its query offset (``q_offset``: query row ``i`` at position ``q_offset +
i``, as a chunk of a prefill behind earlier keys), and loads only the key
tiles that hold a live pair (``live_tiles`` counts them). bf16
runs on the tensor cores (``mma.sync``, the online softmax in registers,
q/K/V tiles loaded by TMA, K/V double-buffered); float32 runs true
float32 FMAs on the CUDA cores.

``flash_attention`` launches the kernel for CUDA tensors and evaluates
``flash_attention_plain`` for CPU tensors; nothing else selects between
them, and a kernel that fails to build or launch raises.
``flash_attention.launches`` counts kernel launches. With ``return_lse``
it also returns each query row's log-sum-exp, which the backward kernel
B9 (``flash_attention_bwd``) takes; serving asks for none, and the
kernel then writes none. The wrapper is not differentiable: a CUDA call
with grad enabled on an input that requires it raises (training goes
through ``models.common.attention``, whose backward is B9).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core import costs
from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF, attention_mask, ref_attention

#: the kernel's tile (query rows and keys); ``tiles_loaded`` counts in it
TILE = 64
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: the (q/k, v) head dims the kernel takes: v's equal to q's, and
#: multi-head latent attention's (nope 128 + rope 64, v 128; the reduced
#: config's nope 16 + rope 8, v 16)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128), (24, 16))
#: q / k head dims the kernels take zero-padded to a multiple of mma.sync's
#: bf16 k-step of 16 (both routes, for one instantiation): the padded
#: columns add exact zeros to every score, the scale stays that of the
#: true width, and B9 drops dq's and dk's padded columns
PADDED_D = {24: 32}
DTYPES = (torch.float32, torch.bfloat16)
#: the bf16 kernel's TMA tensor maps need 16-byte aligned base addresses
#: and strides: every row must start on a 16-byte boundary
ROW_ALIGN = 16
_GRID_YZ_MAX = 65535


def _check(q, k, v) -> tuple[int, int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q (B, Sq, H, D), k (B, Sk, Hkv, D), v (B, "
                         f"Sk, Hkv, Dv); got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (B, Sk, Hkv, D) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"want k ({B}, Sk, Hkv, {D}) and v ({B}, Sk, Hkv, "
                         f"Dv), got {tuple(k.shape)} {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"query heads {H} must be a multiple of KV heads "
                         f"{Hkv}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"want one dtype of {DTYPES}, got {q.dtype} "
                         f"{k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    return B, Sq, H, D, Sk, Hkv, Dv


def _check_mask(Sq: int, Sk: int, window, prefix_len: int,
                q_offset: int = 0):
    """``window`` as an int (None stays None), ``prefix_len`` and
    ``q_offset``, checked: a window of at least 1 key, no negative prefix
    or offset, and, with a window, every query row's own position inside
    the keys (``q_offset + Sq <= Sk``: past them a windowed row could have
    no live key)."""
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window {window}: want at least 1 key")
        if q_offset + Sq > Sk:
            raise ValueError(f"a window needs every query's position among "
                             f"the keys, q_offset + Sq <= Sk; got "
                             f"{q_offset} + {Sq} > {Sk}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len {prefix_len} < 0")
    return window, int(prefix_len), q_offset


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: Optional[float] = None,
                          return_lse: bool = False, window=None,
                          prefix_len: int = 0, q_offset: int = 0):
    """Plain PyTorch version of B3: KV heads repeated to the query heads
    (head ``h`` reads KV head ``h // (H // Hkv)``), then ``ref_attention``
    in float32 over ``ref.attention_mask``; the output ``(B, Sq, H, Dv)``
    in q's dtype, ``Dv`` v's head dim (any; the kernel's are
    ``HEAD_DIM_PAIRS``). With
    ``return_lse`` also the row log-sum-exp of the scaled live scores,
    float32 ``(B, H, Sq)``."""
    _, Sq, H, D, Sk, Hkv, _ = _check(q, k, v)
    window, prefix_len, q_offset = _check_mask(Sq, Sk, window, prefix_len,
                                               q_offset)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    out = ref_attention(q, k, v, causal=causal, scale=scale, window=window,
                        prefix_len=prefix_len, q_offset=q_offset)
    if not return_lse:
        return out
    scale = D ** -0.5 if scale is None else float(scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    live = attention_mask(Sq, Sk, causal=causal, window=window,
                          prefix_len=prefix_len, q_offset=q_offset,
                          device=q.device)
    s = torch.where(live, s, torch.full((), NEG_INF, device=q.device))
    return out, torch.logsumexp(s, dim=-1)


def live_tiles(Sq: int, Sk: int, *, causal: bool = True, window=None,
               prefix_len: int = 0, q_offset: int = 0,
               device=None) -> torch.Tensor:
    """int32 ``(ceil(Sq / TILE),)``: for each query tile, the number of
    ``TILE``-key tiles that hold a live pair of ``ref.attention_mask`` --
    what the kernel loads, computed from the mask itself."""
    window, prefix_len, q_offset = _check_mask(Sq, Sk, window, prefix_len,
                                               q_offset)
    n_qt, n_kt = -(-Sq // TILE), -(-Sk // TILE)
    ok = attention_mask(Sq, Sk, causal=causal, window=window,
                        prefix_len=prefix_len, q_offset=q_offset,
                        device=device)
    ok = torch.nn.functional.pad(ok, (0, n_kt * TILE - Sk,
                                      0, n_qt * TILE - Sq))
    return ok.view(n_qt, TILE, n_kt, TILE).any(dim=3).any(dim=1) \
        .sum(dim=1, dtype=torch.int32)


def rows_aligned(t: torch.Tensor) -> bool:
    """Whether every ``(batch, seq, head)`` row of ``t`` is contiguous and
    starts on a ``ROW_ALIGN``-byte boundary: the base address and the
    stride of every dim longer than 1 are multiples of it. A length-1
    dim's stride is never used to address a row; ``kernel_strides`` gives
    the launcher a dense one in its place."""
    el = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % ROW_ALIGN == 0 and all(
        n == 1 or (st * el) % ROW_ALIGN == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def for_kernel(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel takes it: itself where it can, else a dense
    copy. float32 needs only a contiguous head dim; bf16 needs
    ``rows_aligned`` (a view sliced at an odd offset, or with a stride
    that is not a multiple of 8 elements, is copied)."""
    if t.dtype != torch.bfloat16:
        return t if t.stride(-1) == 1 else t.contiguous()
    if rows_aligned(t):
        return t
    t = t.contiguous()
    return t if rows_aligned(t) else t.clone()


def kernel_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The ``(batch, seq, head)`` element strides the launcher gets: ``t``'s
    own, except that a length-1 dim takes the dense stride (the next dim's
    length times its stride). Its index is always 0, so the kernel reads
    the same elements, and the bf16 kernel's tensor maps, which want every
    stride a multiple of 16 bytes whatever the dim's length, accept it."""
    st = [t.stride(0), t.stride(1), t.stride(2), 1]
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = t.shape[i + 1] * st[i + 1]
    return st[0], st[1], st[2]


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """q or k as the kernels take it: itself, or, at a head dim of
    ``PADDED_D``, a dense copy zero-padded to the padded width."""
    d = PADDED_D.get(t.shape[-1])
    return t if d is None else torch.nn.functional.pad(
        t, (0, d - t.shape[-1]))


def _strides(t: torch.Tensor):
    return (ctypes.c_int64 * 3)(*kernel_strides(t))


def _launch(lib, q, k, v, out, *, causal: bool, scale: float,
            tiles_loaded: Optional[torch.Tensor], stream: int,
            lse: Optional[torch.Tensor] = None, window=None,
            prefix_len: int = 0, q_offset: int = 0) -> int:
    """One call of the C launcher; the arguments are already checked."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    return lib.flash_attention_launch(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, H, Hkv, Sq, Sk, D, v.shape[3],
        _strides(q), _strides(k), _strides(v), float(scale), int(causal),
        0 if window is None else int(window), int(prefix_len),
        int(q_offset),
        None if tiles_loaded is None else tiles_loaded.data_ptr(),
        None if lse is None else lse.data_ptr(), stream)


def live_pairs(Sq: int, Sk: int, *, causal: bool = True, window=None,
                prefix_len: int = 0, q_offset: int = 0) -> int:
    """The live (query, key) pairs of one (batch, head) under the mask
    ``ref.attention_mask`` draws: key ``j`` is live for the query at
    position ``i`` (row ``i - q_offset``) when ``j <= i`` (causal), ``j > i
    - window`` (a window), or ``j < prefix_len``. The work B3 and B9 do,
    pair by pair (host arithmetic: no tensor op, which a cost counter
    would see)."""
    i = int(q_offset) + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i if causal else np.full(Sq, Sk - 1), Sk - 1)
    lo = np.zeros(Sq, dtype=np.int64) if window is None \
        else np.maximum(i - int(window) + 1, 0)
    base = np.maximum(hi - lo + 1, 0)
    pre = min(max(int(prefix_len), 0), Sk)
    if pre:  # prefix keys outside [lo, hi] are live too
        base = base + pre - np.maximum(np.minimum(hi, pre - 1) - lo + 1, 0)
    return int(base.sum())


def flash_attention_cost(q, k, v, *, causal: bool = True, window=None,
                         prefix_len: int = 0, return_lse: bool = False,
                         q_offset: int = 0, **_) -> tuple[float, float]:
    """``(flops, bytes)`` of one B3 call: QK^T and PV over the live pairs
    (``live_pairs``), 2 (D + Dv) operations a pair and (batch, head); q,
    k, v read and the output (and lse) written once."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    live = live_pairs(Sq, Sk, causal=causal, window=window,
                      prefix_len=prefix_len, q_offset=q_offset)
    nbytes = (q.element_size() * B * Sq * H * (D + Dv)
              + k.element_size() * B * Sk * Hkv * D
              + v.element_size() * B * Sk * Hkv * Dv
              + (4 * B * H * Sq if return_lse else 0))
    return 2.0 * B * H * (D + Dv) * live, float(nbytes)


@costs.counted("B3", flash_attention_cost)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    tiles_loaded: Optional[torch.Tensor] = None,
                    return_lse: bool = False, window=None,
                    prefix_len: int = 0, q_offset: int = 0):
    """Softmax attention of q ``(B, Sq, H, D)`` over k ``(B, Sk, Hkv, D)``
    and v ``(B, Sk, Hkv, Dv)``, GQA by head grouping; float32 or bf16,
    float32 softmax and accumulation, output ``(B, Sq, H, Dv)`` in q's
    dtype. ``(D, Dv)`` is one of ``HEAD_DIM_PAIRS``: ``Dv == D``, or
    multi-head latent attention's (192, 128) and (24, 16) (q and k of 24
    columns go to the kernel zero-padded to 32, ``PADDED_D``). ``scale``
    defaults to ``D ** -0.5``. Query row ``i`` sits at position ``p =
    q_offset + i`` (default 0: self-attention's rows). With ``causal``,
    key ``j`` is live for it iff ``j <= p``; ``window`` (an int >= 1, with
    ``q_offset + Sq <= Sk``) also drops keys ``j <= p - window``; keys ``j
    < prefix_len`` are then live for every query (prefix-LM).

    ``tiles_loaded`` (CUDA only): an int32 ``(B, H, ceil(Sq / 64))``
    tensor that receives the number of 64-key tiles each query tile
    loaded — how a caller sees the skip (``live_tiles`` is the count the
    mask allows).

    The kernel reads q, k and v in place through their strides. A bf16
    tensor whose rows do not start on 16-byte boundaries (see
    ``rows_aligned``) is first copied densely (``for_kernel``); the kernel
    is launched all the same, never a fallback.

    ``return_lse``: also return each query row's log-sum-exp of its
    scaled live scores, float32 ``(B, H, Sq)`` — ``(out, lse)``.

    A cost counter (``core.costs``) is told ``flash_attention_cost``; on
    fake tensors the call returns outputs of the right shape and launches
    nothing.
    """
    B, Sq, H, D, Sk, Hkv, Dv = _check(q, k, v)
    window, prefix_len, q_offset = _check_mask(Sq, Sk, window, prefix_len,
                                               q_offset)
    scale = D ** -0.5 if scale is None else float(scale)
    if costs.is_fake(q):  # a dry run's: the outputs' shapes, no work
        out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
        return (out, torch.empty((B, H, Sq), dtype=torch.float32,
                                 device=q.device)) if return_lse else out
    if q.device.type != "cuda":
        if tiles_loaded is not None:
            raise ValueError("tiles_loaded counts the CUDA kernel's loads; "
                             "CPU tensors take the plain version")
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     return_lse=return_lse, window=window,
                                     prefix_len=prefix_len,
                                     q_offset=q_offset)
    _build.check_no_grad("flash_attention", (q, k, v),
                  "train through repro_torch.models.common.attention, whose "
                  "backward is kernel B9")
    if (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {D}, v {Dv}): the kernel is built "
                         f"for the (D, Dv) pairs {HEAD_DIM_PAIRS}")
    if Sk == 0 and Sq > 0:
        raise ValueError("no keys to attend to (Sk = 0)")
    dev = q.device
    n_qt = -(-Sq // TILE)
    if max(n_qt, H, B) > _GRID_YZ_MAX:
        raise ValueError(f"Sq = {Sq}, H = {H}, B = {B}: the kernels' grids "
                         f"take at most {_GRID_YZ_MAX} query tiles, heads "
                         f"and batches")
    if tiles_loaded is not None and (
            tiles_loaded.dtype != torch.int32
            or tiles_loaded.shape != (B, H, n_qt)
            or tiles_loaded.device != dev
            or not tiles_loaded.is_contiguous()):
        raise ValueError(f"tiles_loaded: want a contiguous int32 "
                         f"({B}, {H}, {n_qt}) tensor on {dev}")
    q, k, v = (for_kernel(t) for t in (q, k, v))
    q, k = pad_head_dim(q), pad_head_dim(k)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) \
        if return_lse else None
    if out.numel() == 0:  # a zero-size grid is a launch error
        return (out, lse) if return_lse else out
    lib = _build.load("attention")
    with torch.cuda.device(dev):
        err = _launch(lib, q, k, v, out, causal=causal, scale=scale,
                      tiles_loaded=tiles_loaded, lse=lse, window=window,
                      prefix_len=prefix_len, q_offset=q_offset,
                      stream=torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
