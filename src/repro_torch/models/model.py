"""Model assembly: embedding -> layer stack -> unembedding.

Plain functions over a parameter tree (nested dicts of tensors, layer
weights stacked on a leading axis), with the JAX package's names and its
``(B, S, H, D)`` layout at every public function. The layer ``lax.scan``
is a Python loop over the stacked weights (a layer's weights are views,
nothing is copied). On a CUDA tensor every attention call goes through
the hand kernels (B3 at prefill, B4 at decode); on a CPU tensor through
their plain forms.

This slice runs the dense text family; ``registry.param_specs`` raises
for the rest, and so do the entry points here, before any work.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, registry
from repro_torch.models.common import rms_norm
from repro_torch.models.param import cast_tree, tree_map


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def embed_inputs(params, batch: dict, cfg: ArchConfig,
                 dtype=torch.bfloat16):
    """Returns x: (B, S, D) and the prefix length (0: text only)."""
    registry.check_ported(cfg)
    emb = params["embed"].to(dtype)
    return emb[batch["tokens"]], 0


def unembed(params, x, cfg: ArchConfig):
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if "lm_head" in params:
        return h @ params["lm_head"].to(h.dtype)
    return h @ params["embed"].to(h.dtype).T  # tied: h @ embed.T


# --------------------------------------------------------------------------
# Layer application
# --------------------------------------------------------------------------

def _layer(layers, i: int):
    """Layer ``i``'s weights: views into the stacked tree."""
    return tree_map(lambda a: a[i], layers)


def _apply_layer(p, x, cfg: ArchConfig, *, window, prefix_len: int,
                 prefill: bool):
    """Returns (x, cache_entry_or_None)."""
    if prefill:
        y, cache = blocks.attn_fwd(p["attn"], x, cfg, window=window,
                                   prefix_len=prefix_len, return_cache=True)
    else:
        y = blocks.attn_fwd(p["attn"], x, cfg, window=window,
                            prefix_len=prefix_len)
        cache = None
    x = x + y
    x = x + blocks.mlp_fwd(p["mlp"], x, cfg)
    return x, cache


# --------------------------------------------------------------------------
# Sequence forward (prefill)
# --------------------------------------------------------------------------

def forward(params, batch: dict, cfg: ArchConfig, *, prefill: bool = False,
            dtype=torch.bfloat16, cache: Optional[dict] = None):
    """Full-sequence forward over ``batch["tokens"]`` (B, S) int64.

    Returns (logits (B, S, V), aux) when ``prefill=False``, aux a zero
    scalar (it carries the MoE loss in the JAX package); (last_logits
    (B, 1, V), cache) when ``prefill=True``. The cache is
    ``{"layers": (k, v)}``, each (L, B, S, Hkv, hd): a new one, or, when
    ``cache`` (an ``init_cache`` of at least S slots) is given, that one
    with the prompt's K/V written into its first S slots in place.
    """
    params = cast_tree(params, dtype)
    x, prefix_len = embed_inputs(params, batch, cfg, dtype)
    S = x.shape[1]
    L = registry.n_scanned_layers(cfg)
    kv = []
    for i in range(L):
        x, entry = _apply_layer(_layer(params["layers"], i), x, cfg,
                                window=None, prefix_len=prefix_len,
                                prefill=prefill)
        if not prefill:
            continue
        if cache is None:
            kv.append(entry)
        else:
            for buf, t in zip(cache["layers"], entry):
                buf[i, :, :S] = t.to(buf.dtype)
    if prefill:
        last = unembed(params, x[:, -1:], cfg)
        if cache is None:
            cache = {"layers": (torch.stack([e[0] for e in kv]),
                                torch.stack([e[1] for e in kv]))}
        return last, cache
    return unembed(params, x, cfg), torch.zeros((), device=x.device)


# --------------------------------------------------------------------------
# Decode (one token against the cache)
# --------------------------------------------------------------------------

def kv_cache_struct(cfg: ArchConfig, B: int, S: int, dtype):
    """Shapes and dtype of one layer's (k, v) cache entries."""
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    return (shape, dtype), (shape, dtype)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Zeroed ``{"layers": (k, v)}``, each (L, B, max_seq, Hkv, hd)."""
    registry.check_ported(cfg)
    L = registry.n_scanned_layers(cfg)
    entry = kv_cache_struct(cfg, batch, max_seq, dtype)
    return {"layers": tuple(
        torch.zeros((L, *shape), dtype=dt, device=device)
        for shape, dt in entry)}


def _decode_layer(p, x, cache, cache_len: int, cfg: ArchConfig, *, window,
                  prefix_len: int):
    k, v = cache
    y, k, v = blocks.attn_decode(p["attn"], x, k, v, cache_len, cfg,
                                 window=window, prefix_len=prefix_len)
    x = x + y
    x = x + blocks.mlp_fwd(p["mlp"], x, cfg)
    return x, (k, v)


def decode_step(params, cache: dict, batch: dict, cfg: ArchConfig, *,
                dtype=torch.bfloat16):
    """One decode step. batch: {"tokens": (B, 1) int64, "cache_len": int}.

    Returns (logits (B, 1, V), cache). The new token's K/V are written
    into ``cache`` in place at slot ``cache_len``; the returned cache is
    the same object.
    """
    params = cast_tree(params, dtype)
    cache_len = int(batch["cache_len"])
    x, prefix_len = embed_inputs(params, batch, cfg, dtype)
    k_all, v_all = cache["layers"]
    for i in range(registry.n_scanned_layers(cfg)):
        x, _ = _decode_layer(_layer(params["layers"], i), x,
                             (k_all[i], v_all[i]), cache_len, cfg,
                             window=None, prefix_len=prefix_len)
    return unembed(params, x, cfg), cache


def prefill_step(params, batch: dict, cfg: ArchConfig, *,
                 dtype=torch.bfloat16, cache: Optional[dict] = None):
    """Prefill: build the KV cache for a prompt, return last logits (see
    ``forward`` for ``cache``)."""
    return forward(params, batch, cfg, prefill=True, dtype=dtype,
                   cache=cache)
