"""Plain PyTorch oracles of the occupancy, matmul, attention and SSD
kernels (the allclose references), as ``repro/kernels/ref.py`` keeps them
for the Pallas ones."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_sa_occupancy(mm_m, mm_k, mm_n, saw, weight_load_cycles=None) -> dict:
    """The SA PE-occupancy closed form in float64 tensor ops -- the oracle
    of kernel K1 (``sa_occupancy``), under the reference's name: the
    backend-neutral ``core.sa_gating.gating_stats_batch_xp``, which
    ``sa_occupancy_plain`` also runs (with the width as a batch axis).
    ``mm_m/mm_k/mm_n``: float64 ``(n,)`` tensors of exact integers; ``saw``
    a number (or a tensor that broadcasts against them). Returns the five
    float64 statistics (``STAT_KEYS``)."""
    from repro_torch.core.sa_gating import gating_stats_batch_xp
    return gating_stats_batch_xp(mm_m, mm_k, mm_n, saw, weight_load_cycles)


def ref_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M,K] x [K,N] in float32, returned in x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def attention_mask(Sq: int, Sk: int, *, causal: bool = True, window=None,
                   prefix_len: int = 0, q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """(Sq, Sk) bool: key ``j`` live for query row ``i``, at position ``p =
    q_offset + i``, by the JAX model path's rules
    (``src/repro/models/common.py``: ``plain_attention``, ``_window_ok``):
    ``j <= p`` under ``causal``, and ``j > p - window`` with a window, then
    OR-ed with ``j < prefix_len``."""
    q_pos = int(q_offset) + torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    ok = k_pos <= q_pos if causal else torch.ones((Sq, Sk), dtype=torch.bool,
                                                  device=device)
    if window is not None:
        ok = ok & (k_pos > q_pos - int(window))
    if prefix_len > 0:
        ok = ok | (k_pos < int(prefix_len))
    return ok


def decode_live(S: int, cache_len: int, *, window=None,
                prefix_len: int = 0, device=None) -> torch.Tensor:
    """(S,) bool: the cache slots a decode step at ``cache_len`` attends
    to, by the JAX model path's rule (``src/repro/models/common.py::
    decode_attention``): ``[0, cache_len]``, with a window only
    ``(cache_len - window, cache_len]``, then (with a window only) OR-ed
    with the slots ``< prefix_len``."""
    k_pos = torch.arange(S, device=device)
    ok = k_pos <= int(cache_len)
    if window is not None:
        okw = ok & (k_pos > int(cache_len) - int(window))
        if prefix_len > 0:
            okw = okw | (ok & (k_pos < int(prefix_len)))
        ok = okw
    return ok


def ref_attention(q, k, v, *, causal: bool = True, scale=None, window=None,
                  prefix_len: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q/k: (B, S, H, D), v: (B, S, H, Dv) (same head count; v's head dim
    its own); plain softmax attention over the live keys of
    ``attention_mask`` (query row ``i`` at position ``q_offset + i``),
    returned as (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal or window is not None or prefix_len > 0:
        dev = q.device
        mask = attention_mask(Sq, Sk, causal=causal, window=window,
                              prefix_len=prefix_len, q_offset=q_offset,
                              device=dev)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def ref_decode_attention(q, k_cache, v_cache, cache_len: int, *,
                         scale=None, window=None,
                         prefix_len: int = 0) -> torch.Tensor:
    """q: (BH, D); caches: (BH, S, D). One query per row against the
    cache slots of ``decode_live``; returns (BH, D)."""
    D = q.shape[-1]
    S = k_cache.shape[1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bd,bkd->bk", q.float() * scale, k_cache.float())
    live = decode_live(S, cache_len, window=window, prefix_len=prefix_len,
                       device=q.device)
    s = torch.where(live[None, :], s, torch.full((), NEG_INF,
                                                 device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bk,bkd->bd", p, v_cache.float()).to(q.dtype)


def ref_ssd(x, dt, A, B, C) -> tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential SSD recurrence (the ground truth), a Python loop
    over time in float32; for the tests.

    x: (BH, S, P); dt: (BH, S); A: (BH,); B/C: (BH, S, N).
    h_t = exp(dt_t A) h_{t-1} + dt_t * B_t (outer) x_t ;  y_t = C_t . h_t
    Returns y: (BH, S, P) in x's dtype and the final state (BH, P, N)
    in float32.
    """
    BH, S, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    A = A.float()
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)  # (BH,)
        h = h * decay[:, None, None] \
            + (dtf[:, t, None] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bpn,bn->bp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h
