"""Transformer block implementations: dense / GQA attention and the MLP.

Every block family exposes:

* ``<family>_specs(cfg)``   -> ParamSpec tree for one layer;
* ``<family>_fwd(p, x, ...)``  -> sequence forward (prefill). In prefill
  mode it also returns the per-layer cache entries;
* ``<family>_decode(p, x, cache, ...)`` -> single-token forward.

Only the families of the dense text archs are here; MLA, MoE, SSD and
hybrid blocks wait for ROADMAP A7 (``registry.param_specs`` refuses those
archs before a block is reached).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (
    Window, act_fn, apply_rope, attention, decode_attention, rms_norm)
from repro_torch.models.param import spec


# ==========================================================================
# Dense / GQA attention
# ==========================================================================

def attn_specs(cfg: ArchConfig) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: dict[str, Any] = {
        "ln": spec((D,), ("embed",), init="ones"),
        "wq": spec((D, H * hd), ("embed", "q_heads")),
        "wk": spec((D, Hkv * hd), ("embed", "kv_heads")),
        "wv": spec((D, Hkv * hd), ("embed", "kv_heads")),
        "wo": spec((H * hd, D), ("q_heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = spec((H * hd,), ("q_heads",), init="zeros")
        s["bk"] = spec((Hkv * hd,), ("kv_heads",), init="zeros")
        s["bv"] = spec((Hkv * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = spec((hd,), (None,), init="ones")
        s["k_norm"] = spec((hd,), (None,), init="ones")
    return s


def _qkv(p, x, cfg: ArchConfig, positions):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Hkv, hd)
    v = v.reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not cfg.encoder_only:  # encoder (hubert) uses learned/conv pos
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_fwd(p, x, cfg: ArchConfig, *, window: Window = None,
             prefix_len: int = 0, return_cache: bool = False):
    """x: (B, S, D) -> (B, S, D) [+ (k, v) cache entries]."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(p, h, cfg, positions)
    o = attention(q, k, v, causal=not cfg.encoder_only, window=window,
                  prefix_len=prefix_len)
    out = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if return_cache:
        return out, (k, v)
    return out


def attn_decode(p, x, k_cache, v_cache, cache_len: int, cfg: ArchConfig, *,
                window: Window = None, prefix_len: int = 0):
    """x: (B, 1, D); caches: (B, Smax, Hkv, hd). Returns out and the caches.

    Unlike the JAX package, which returns updated copies, the new token's
    K/V are written into ``k_cache`` / ``v_cache`` in place at slot
    ``cache_len``, and the same tensors are returned: a copy of the
    whole cache per layer and step is what the port avoids.
    """
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    positions = torch.full((1,), cache_len, dtype=torch.int64,
                           device=x.device)
    q, k, v = _qkv(p, h, cfg, positions)
    k_cache[:, cache_len] = k[:, 0].to(k_cache.dtype)
    v_cache[:, cache_len] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, cache_len, window=window,
                         prefix_len=prefix_len)
    out = o.reshape(B, 1, H * hd) @ p["wo"]
    return out, k_cache, v_cache


# ==========================================================================
# MLPs (dense)
# ==========================================================================

def mlp_specs(cfg: ArchConfig) -> dict:
    """Gated MLP (SwiGLU / GeGLU), the one the dense text archs use; the
    plain 2-layer MLP of the encoder (hubert) waits with it (ROADMAP A7)."""
    D, F = cfg.d_model, cfg.d_ff
    return {"ln": spec((D,), ("embed",), init="ones"),
            "wg": spec((D, F), ("embed", "mlp")),
            "wu": spec((D, F), ("embed", "mlp")),
            "wd": spec((F, D), ("mlp", "embed"))}


def mlp_fwd(p, x, cfg: ArchConfig):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return (act_fn(cfg.act)(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
