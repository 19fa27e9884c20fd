"""Single-token attention against the KV cache — CUDA kernel B4.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``
(``_kernel`` / ``decode_attention_p``). The kernel, its bound on the card
and the reasons for its design are in ``csrc/attention.cu``; in short: a
decode step is bound by the bytes of the live cache, so the live slots
are split over many blocks (flash-decoding: ``decode_splits`` gives the
schedule, from ``cache_len`` alone), each block serves all of its KV
head's query heads and reads each cache row once, and a second kernel
merges the splits' partial softmax sums in split order. Slots past
``cache_len`` are never read, and no sum depends on the order in which
blocks finish, so the result is the same from run to run. With a sliding
``window`` (and a ``prefix_len`` beside it, as the JAX model path combines
them; ``ref.decode_live``) the splits cover the live slots alone
(``live_slots``): slots before the window are never read either.

``decode_attention`` launches the kernels for CUDA tensors and evaluates
``decode_attention_plain`` for CPU tensors; nothing else selects between
them, and a kernel that fails to build or launch raises.
``decode_attention.launches`` counts wrapper calls that launched (one
per call, for the split pass and its combine together).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import costs
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_decode_attention

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUPS = 8  # query heads per KV head the kernel holds in registers
DTYPES = (torch.float32, torch.bfloat16)
SPLIT_LEN = 64  # live slots per split: the most the kernel holds in registers


def live_slots(cache_len: int, window=None,
               prefix_len: int = 0) -> tuple[int, int, int]:
    """``(n_live, n_pre, first)``: the live slots of a decode step at
    ``cache_len`` (``ref.decode_live``) are ``[0, n_pre)`` and ``[first,
    cache_len]``, ``n_live`` of them. No window: ``(cache_len + 1, 0,
    0)``. A window of ``w`` starts at ``first = max(0, cache_len - w +
    1)``; the prefix slots before it, ``n_pre = min(prefix_len, first)``,
    stay live."""
    cache_len = int(cache_len)
    if window is None:
        return cache_len + 1, 0, 0
    if int(window) < 1:
        raise ValueError(f"window {window}: want at least 1 slot")
    first = max(0, cache_len - int(window) + 1)
    n_pre = min(max(int(prefix_len), 0), first)
    return n_pre + cache_len - first + 1, n_pre, first


def decode_splits(n_live: int, first: int = 0,
                  n_pre: int = 0) -> tuple[int, int]:
    """``(n_split, split_len)``: the ``n_live`` live slots, taken in slot
    order (``[0, n_pre)``, then from ``first`` on: ``live_slots``), are
    cut into runs of ``split_len``; split ``s`` covers runs ``[s *
    split_len, min((s + 1) * split_len, n_live))`` of them, so the splits
    cover the live slots exactly, disjoint, none past the last. The plan
    depends on ``n_live``, ``first`` and ``n_pre`` alone -- never on the
    card, its SM count or timing -- so the sums, and the bits, do not
    either."""
    n_live, first, n_pre = int(n_live), int(first), int(n_pre)
    if n_live < 1 or not 0 <= n_pre <= first or n_live <= n_pre:
        raise ValueError(f"want n_live >= 1 live slots after n_pre <= "
                         f"first; got n_live={n_live}, first={first}, "
                         f"n_pre={n_pre}")
    return -(-n_live // SPLIT_LEN), SPLIT_LEN


def _check(q, k_cache, v_cache, cache_len) -> tuple[int, int, int, int,
                                                    int, int]:
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"want q (B, 1, H, D) and caches (B, S, Hkv, D); "
                         f"got {tuple(q.shape)} {tuple(k_cache.shape)}")
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be ({B}, S, Hkv, {D}) alike, got "
                         f"{tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"query heads {H} must be a multiple of KV heads "
                         f"{Hkv}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in DTYPES:
        raise ValueError(f"want one dtype of {DTYPES}, got {q.dtype} "
                         f"{k_cache.dtype} {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"q and caches on {q.device}, {k_cache.device}, "
                         f"{v_cache.device}")
    cache_len = int(cache_len)
    if not 0 <= cache_len < S:
        raise ValueError(f"cache_len {cache_len} outside the cache's "
                         f"{S} slots")
    return B, H, D, S, Hkv, cache_len


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           scale: Optional[float] = None, window=None,
                           prefix_len: int = 0) -> torch.Tensor:
    """Plain PyTorch version of B4: every query head against its KV
    head's cache rows (head ``h`` reads KV head ``h // (H // Hkv)``) by
    ``ref_decode_attention`` in float32 over the slots of
    ``ref.decode_live``; the output in q's dtype."""
    B, H, D, S, Hkv, cache_len = _check(q, k_cache, v_cache, cache_len)
    head = torch.arange(H, device=q.device) // (H // Hkv)

    def rows(c):  # (B, S, Hkv, D) -> (B*H, S, D)
        return c[:, :, head].permute(0, 2, 1, 3).reshape(B * H, S, D)

    live_slots(cache_len, window, prefix_len)  # checks the window
    o = ref_decode_attention(q.reshape(B * H, D), rows(k_cache),
                             rows(v_cache), cache_len, scale=scale,
                             window=window, prefix_len=prefix_len)
    return o.reshape(B, 1, H, D)


def _aligned(t: torch.Tensor, dims=(0, 1, 2)) -> bool:
    """16-byte loads of rows: base and the strides of ``dims`` on 16
    bytes, the head dim contiguous."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) % per16 == 0 for i in dims))


def _launch(lib, q, k_cache, v_cache, out, *, cache_len: int, scale: float,
            stream: int, window=None, prefix_len: int = 0) -> int:
    """One call of the C launcher (the split pass and its combine); the
    arguments are already checked. The float32 workspace holds each
    split's partial sums."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    n_live, n_pre, first = live_slots(cache_len, window, prefix_len)
    n_split, split_len = decode_splits(n_live, first, n_pre)
    ws = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                     device=q.device)
    st = lambda t, dims: (ctypes.c_int64 * len(dims))(
        *(t.stride(i) for i in dims))
    return lib.decode_attention_launch(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, Hkv, D,
        n_live, n_pre, first, split_len, n_split, st(q, (0, 2)),
        st(k_cache, (0, 1, 2)), st(v_cache, (0, 1, 2)), float(scale),
        stream)


def decode_attention_cost(q, k_cache, v_cache, cache_len, *, window=None,
                          prefix_len: int = 0, **_) -> tuple[float, float]:
    """``(flops, bytes)`` of one B4 call: one query per head against the
    ``live_slots``, 2 D operations a slot for the score and 2 D for the
    value; the live K and V rows read once, q read and the output
    written."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    n_live = live_slots(int(cache_len), window, prefix_len)[0]
    el = k_cache.element_size()
    nbytes = el * 2 * B * n_live * Hkv * D + q.element_size() * 2 * B * H * D
    return 4.0 * B * H * D * n_live, float(nbytes)


@costs.counted("B4", decode_attention_cost)
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     scale: Optional[float] = None, window=None,
                     prefix_len: int = 0) -> torch.Tensor:
    """One query token ``(B, 1, H, D)`` against caches
    ``(B, S, Hkv, D)`` over slots ``[0, cache_len]`` inclusive (the new
    token sits at slot ``cache_len``); with a ``window`` (an int >= 1)
    over ``(cache_len - window, cache_len]`` and the slots before
    ``prefix_len`` (``live_slots``); float32 or bf16, float32 softmax and
    accumulation, output ``(B, 1, H, D)`` in q's dtype. ``scale``
    defaults to ``D ** -0.5``. A cost counter is told
    ``decode_attention_cost``; fake tensors launch nothing.
    """
    B, H, D, S, Hkv, cache_len = _check(q, k_cache, v_cache, cache_len)
    scale = D ** -0.5 if scale is None else float(scale)
    if costs.is_fake(q):  # a dry run's: the output's shape, no work
        return torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      scale=scale, window=window,
                                      prefix_len=prefix_len)
    _build.check_no_grad("decode_attention", (q, k_cache, v_cache),
                  "decode is not a training path")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if H // Hkv > MAX_GROUPS:
        raise ValueError(f"{H // Hkv} query heads per KV head: the kernel "
                         f"holds at most {MAX_GROUPS}")
    if not (_aligned(k_cache) and _aligned(v_cache)):
        raise ValueError("caches must have a contiguous head dim and start "
                         "rows on 16-byte boundaries")
    if not _aligned(q, (0, 2)):  # q too is read 16 bytes at a time
        q = q.clone(memory_format=torch.contiguous_format)
    dev = q.device
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:  # a zero-size grid is a launch error
        return out
    lib = _build.load("attention")
    with torch.cuda.device(dev):
        err = _launch(lib, q, k_cache, v_cache, out, cache_len=cache_len,
                      scale=scale, window=window, prefix_len=prefix_len,
                      stream=torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
