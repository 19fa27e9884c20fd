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
blocks finish, so the result is the same from run to run.

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

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_decode_attention

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUPS = 8  # query heads per KV head the kernel holds in registers
DTYPES = (torch.float32, torch.bfloat16)
SPLIT_LEN = 64  # live slots per split: the most the kernel holds in registers


def decode_splits(n_live: int) -> tuple[int, int]:
    """``(n_split, split_len)``: split ``s`` covers slots ``[s *
    split_len, min((s + 1) * split_len, n_live))``, so the splits cover
    the ``n_live = cache_len + 1`` live slots exactly, disjoint, none
    past the last. It depends on ``n_live`` alone -- never on the card,
    its SM count or timing -- so the sums, and the bits, do not either."""
    n_live = int(n_live)
    if n_live < 1:
        raise ValueError(f"want n_live >= 1, got {n_live}")
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
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of B4: every query head against its KV
    head's cache rows (head ``h`` reads KV head ``h // (H // Hkv)``) by
    ``ref_decode_attention`` in float32; the output in q's dtype."""
    B, H, D, S, Hkv, cache_len = _check(q, k_cache, v_cache, cache_len)
    head = torch.arange(H, device=q.device) // (H // Hkv)

    def rows(c):  # (B, S, Hkv, D) -> (B*H, S, D)
        return c[:, :, head].permute(0, 2, 1, 3).reshape(B * H, S, D)

    o = ref_decode_attention(q.reshape(B * H, D), rows(k_cache),
                             rows(v_cache), cache_len, scale=scale)
    return o.reshape(B, 1, H, D)


def _aligned(t: torch.Tensor, dims=(0, 1, 2)) -> bool:
    """16-byte loads of rows: base and the strides of ``dims`` on 16
    bytes, the head dim contiguous."""
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(t.stride(i) % per16 == 0 for i in dims))


def _launch(lib, q, k_cache, v_cache, out, *, cache_len: int, scale: float,
            stream: int) -> int:
    """One call of the C launcher (the split pass and its combine); the
    arguments are already checked. The float32 workspace holds each
    split's partial sums."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    n_split, split_len = decode_splits(cache_len + 1)
    ws = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                     device=q.device)
    st = lambda t, dims: (ctypes.c_int64 * len(dims))(
        *(t.stride(i) for i in dims))
    return lib.decode_attention_launch(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), ws.data_ptr(), B, H, Hkv, D,
        cache_len, split_len, n_split, st(q, (0, 2)),
        st(k_cache, (0, 1, 2)), st(v_cache, (0, 1, 2)), float(scale),
        stream)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token ``(B, 1, H, D)`` against caches
    ``(B, S, Hkv, D)`` over slots ``[0, cache_len]`` inclusive (the new
    token sits at slot ``cache_len``); float32 or bf16, float32 softmax
    and accumulation, output ``(B, 1, H, D)`` in q's dtype. ``scale``
    defaults to ``D ** -0.5``.
    """
    B, H, D, S, Hkv, cache_len = _check(q, k_cache, v_cache, cache_len)
    scale = D ** -0.5 if scale is None else float(scale)
    if q.device.type != "cuda":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      scale=scale)
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
                      scale=scale,
                      stream=torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
