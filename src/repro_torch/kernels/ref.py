"""Plain PyTorch oracles of the matmul, attention and SSD kernels (the
allclose references), as ``repro/kernels/ref.py`` keeps them for the
Pallas ones."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[M,K] x [K,N] in float32, returned in x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def ref_attention(q, k, v, *, causal: bool = True,
                  scale=None) -> torch.Tensor:
    """q/k/v: (B, S, H, D) (same head count); plain softmax attention.
    With ``causal``, key ``j`` is live for query ``i`` iff ``j <= i``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        dev = q.device
        mask = torch.arange(Sk, device=dev)[None, :] \
            <= torch.arange(Sq, device=dev)[:, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def ref_decode_attention(q, k_cache, v_cache, cache_len: int, *,
                         scale=None) -> torch.Tensor:
    """q: (BH, D); caches: (BH, S, D). One query per row against cache
    slots ``[0, cache_len]``; returns (BH, D)."""
    D = q.shape[-1]
    S = k_cache.shape[1]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bd,bkd->bk", q.float() * scale, k_cache.float())
    live = torch.arange(S, device=q.device) <= int(cache_len)
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
