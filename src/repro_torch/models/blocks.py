"""Block implementations: dense / GQA attention, the MLPs, the SSD
(Mamba-2) block and the hybrid (hymba) block that runs both beside each
other; the parameter specs (no forward yet) of MLA and MoE.

Every block family exposes:

* ``<family>_specs(cfg)``   -> ParamSpec tree for one layer;
* ``<family>_fwd(p, x, ...)``  -> sequence forward (prefill). In prefill
  mode it also returns the per-layer cache entries;
* ``<family>_decode(p, x, cache, ...)`` -> single-token forward.

MLA and MoE have their specs only, so that every arch's parameters can
be counted; their forwards wait for ROADMAP A7b (the model's entry points
refuse those archs before a block is reached).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
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
# MLA (DeepSeek-V2 multi-head latent attention): specs only
# ==========================================================================

def mla_specs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qh = m.nope_head_dim + m.rope_head_dim
    return {
        "ln": spec((D,), ("embed",), init="ones"),
        "q_a": spec((D, m.q_lora_rank), ("embed", "q_lora")),
        "q_a_norm": spec((m.q_lora_rank,), ("q_lora",), init="ones"),
        "q_b": spec((m.q_lora_rank, H * qh), ("q_lora", "q_heads")),
        "kv_a": spec((D, m.kv_lora_rank + m.rope_head_dim),
                     ("embed", "kv_lora")),
        "kv_a_norm": spec((m.kv_lora_rank,), ("kv_lora",), init="ones"),
        "kv_b": spec((m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim)),
                     ("kv_lora", "q_heads")),
        "wo": spec((H * m.v_head_dim, D), ("q_heads", "embed")),
    }


# ==========================================================================
# MLPs (dense)
# ==========================================================================

def mlp_specs(cfg: ArchConfig, d_ff=None) -> dict:
    """Gated MLP (SwiGLU / GeGLU: ``wg``, ``wu``, ``wd``) for the silu and
    gelu_glu archs; the plain 2-layer MLP (``w1``, ``w2``) of the encoder
    (hubert, act gelu) otherwise. ``d_ff`` defaults to the config's."""
    D = cfg.d_model
    F = d_ff if d_ff is not None else cfg.d_ff
    s = {"ln": spec((D,), ("embed",), init="ones")}
    if cfg.act in ("silu", "gelu_glu"):
        s["wg"] = spec((D, F), ("embed", "mlp"))
        s["wu"] = spec((D, F), ("embed", "mlp"))
        s["wd"] = spec((F, D), ("mlp", "embed"))
    else:
        s["w1"] = spec((D, F), ("embed", "mlp"))
        s["w2"] = spec((F, D), ("mlp", "embed"))
    return s


def mlp_fwd(p, x, cfg: ArchConfig):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    a = act_fn(cfg.act)
    if "wg" in p:
        return (a(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    return a(h @ p["w1"]) @ p["w2"]


# ==========================================================================
# MoE: specs only
# ==========================================================================

def moe_specs(cfg: ArchConfig) -> dict:
    mo = cfg.moe
    D, E, Fe = cfg.d_model, mo.n_experts, mo.d_ff_expert
    s = {
        "ln": spec((D,), ("embed",), init="ones"),
        "router": spec((D, E), ("embed", "experts"), dtype=torch.float32),
        "wg": spec((E, D, Fe), ("experts", "embed", "expert_mlp")),
        "wu": spec((E, D, Fe), ("experts", "embed", "expert_mlp")),
        "wd": spec((E, Fe, D), ("experts", "expert_mlp", "embed")),
    }
    if mo.n_shared_experts:
        Fs = mo.n_shared_experts * Fe
        s["sh_wg"] = spec((D, Fs), ("embed", "mlp"))
        s["sh_wu"] = spec((D, Fs), ("embed", "mlp"))
        s["sh_wd"] = spec((Fs, D), ("mlp", "embed"))
    return s


# ==========================================================================
# SSD (Mamba-2 state-space duality)
#
# Dispatch follows the device, as attention does: on a CUDA tensor
# ``ssd_fwd`` runs kernel B5 on the un-repeated groups; on a CPU tensor the
# plain ``_ssd_chunk_scan`` exactly as the JAX package computes it (groups
# repeated to heads, the JAX chunk choice). ``ssd_decode`` is plain PyTorch
# on both devices: a handful of elementwise ops on a (B, nh, hd, N) state,
# for which the JAX package has no Pallas kernel either.
# ==========================================================================

def _a_log_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """A_log = log(1 + 15 u), u uniform: A = -exp(A_log) in [-16, -1]."""
    lo, hi = 1.0, 16.0
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return torch.log(lo + u * (hi - lo)).to(dtype)


def ssd_specs(cfg: ArchConfig) -> dict:
    ss = cfg.ssm
    D = cfg.d_model
    di = ss.d_inner(D)
    nh = ss.n_heads(D)
    GN = ss.n_groups * ss.d_state
    w = ss.conv_width
    return {
        "ln": spec((D,), ("embed",), init="ones"),
        "in_x": spec((D, di), ("embed", "ssm_inner")),
        "in_z": spec((D, di), ("embed", "ssm_inner")),
        "in_B": spec((D, GN), ("embed", None)),
        "in_C": spec((D, GN), ("embed", None)),
        "in_dt": spec((D, nh), ("embed", None)),
        "conv_x": spec((w, di), (None, "ssm_inner"), init="small_normal",
                       init_scale=0.5),
        "conv_B": spec((w, GN), (None, None), init="small_normal",
                       init_scale=0.5),
        "conv_C": spec((w, GN), (None, None), init="small_normal",
                       init_scale=0.5),
        "conv_b": spec((di + 2 * GN,), (None,), init="zeros"),
        "dt_bias": spec((nh,), (None,), init="zeros"),
        "A_log": spec((nh,), (None,), custom_init=_a_log_init),
        "D_skip": spec((nh,), (None,), init="ones"),
        "gnorm": spec((di,), ("ssm_inner",), init="ones"),
        "out_proj": spec((di, D), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (W, C) depthwise causal conv via shifted adds."""
    W = w.shape[0]
    y = x * w[W - 1]
    for i in range(1, W):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i or None, :]
        y = y + shifted * w[W - 1 - i]
    return y + b


def _largest_chunk(S: int) -> int:
    for q in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if S % q == 0:
            return q
    return 1


def _ssd_chunk_scan(xh, dt, A, Bm, Cm):
    """Chunked SSD core, the JAX package's plain form and chunk choice.

    xh: (B, S, nh, hd); dt: (B, S, nh) (post-softplus); A: (nh,) negative;
    Bm/Cm: (B, S, nh, N) (already broadcast from groups to heads).
    Returns y: (B, S, nh, hd) and the final state (B, nh, hd, N), float32.
    """
    Bsz, S, nh, _ = xh.shape
    Q = min(S, 256) if S % 256 == 0 or S < 256 else _largest_chunk(S)
    return ssd_scan_plain(xh, dt, A.float().expand(Bsz, nh), Bm, Cm,
                          chunk=Q)


def _heads(t, nh: int):
    """(B, S, G, N) groups -> (B, S, nh, N) heads, the ``jnp.repeat``
    order: head h reads group h // (nh // G)."""
    return t.repeat_interleave(nh // t.shape[2], dim=2)


def _ssd_inputs(p, h, cfg: ArchConfig, conv_state=None):
    """Shared projection + causal conv for fwd and decode.

    h: (B, S, D). Returns x (B, S, nh, hd), z, dt (float32), Bm and Cm
    (B, S, G, N) — per group, not repeated to heads as in the JAX package
    (``_heads`` does that where a plain form needs it) — and the new conv
    tail, three (B, W-1, ·) tensors. At prefill the tail is the last W-1
    pre-conv rows, right-aligned with zeros before them when S < W-1 (the
    JAX package keeps only the S rows it has, and its server grafts them
    left-aligned into the decode cache); at decode (``conv_state`` given)
    it is the stored tail shifted by the new token.
    """
    ss = cfg.ssm
    D = cfg.d_model
    di, nh = ss.d_inner(D), ss.n_heads(D)
    GN = ss.n_groups * ss.d_state
    W = ss.conv_width
    B_, S, _ = h.shape

    x = h @ p["in_x"]
    z = h @ p["in_z"]
    Bm = h @ p["in_B"]
    Cm = h @ p["in_C"]
    dt = h @ p["in_dt"]

    bx, bB, bC = torch.split(p["conv_b"], [di, GN, GN])
    if conv_state is not None:  # decode: prepend the stored tail
        full = [torch.cat([tail.to(t.dtype), t], dim=1)
                for tail, t in zip(conv_state, (x, Bm, Cm))]
        new_tail = tuple(f[:, -(W - 1):] for f in full)
        x, Bm, Cm = (_causal_conv(f, p[k], b)[:, W - 1:] for f, k, b in
                     zip(full, ("conv_x", "conv_B", "conv_C"), (bx, bB, bC)))
    else:
        # a copy of the last rows, not a view that would keep the whole
        # (B, S, ·) projection alive
        new_tail = tuple(F.pad(t[:, -(W - 1):], (0, 0, max(0, W - 1 - S), 0))
                         for t in (x, Bm, Cm))
        x = _causal_conv(x, p["conv_x"], bx)
        Bm = _causal_conv(Bm, p["conv_B"], bB)
        Cm = _causal_conv(Cm, p["conv_C"], bC)
    x = F.silu(x)
    Bm = F.silu(Bm)
    Cm = F.silu(Cm)
    dt = F.softplus(dt.float() + p["dt_bias"].float())

    x = x.reshape(B_, S, nh, ss.head_dim)
    Bm = Bm.reshape(B_, S, ss.n_groups, ss.d_state)
    Cm = Cm.reshape(B_, S, ss.n_groups, ss.d_state)
    return x, z, dt, Bm, Cm, new_tail


def _ssd_output(p, y, x, z, cfg: ArchConfig):
    ss = cfg.ssm
    B_, S = y.shape[0], y.shape[1]
    di = ss.d_inner(cfg.d_model)
    y = y + x.float() * p["D_skip"].float()[..., None]
    y = y.reshape(B_, S, di)
    y = rms_norm(y.to(z.dtype) * F.silu(z), p["gnorm"], cfg.norm_eps)
    return y @ p["out_proj"]


def ssd_fwd(p, x_res, cfg: ArchConfig, *, return_cache: bool = False,
            state_out=None):
    """Mamba-2 block over a sequence. x_res: (B, S, D).

    With ``return_cache`` also returns ``(conv_tail, h_final)``.
    ``state_out`` (a float32 ``(B, nh, hd, N)`` tensor, e.g. a cache's
    layer slice) receives the final state in place — written by kernel B5
    itself on the card — and is the ``h_final`` returned.

    On the card with grad enabled on an input that requires it, raises
    ``NotImplementedError`` before any work: B5 has no backward yet
    (ROADMAP Queue B, the B5 backward), so the SSD family trains on the
    CPU only, through the plain scan.
    """
    if x_res.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_res, *p.values())):
        raise NotImplementedError(
            "ssd_fwd on the card runs kernel B5, which has no backward yet "
            "(ROADMAP Queue B: the B5 backward, for mamba2 training on the "
            "card); train the SSD family on the CPU (device='cpu')")
    h = rms_norm(x_res, p["ln"], cfg.norm_eps)
    x, z, dt, Bm, Cm, conv_tail = _ssd_inputs(p, h, cfg)
    A = -torch.exp(p["A_log"].float())
    if x.device.type == "cuda":
        y, h_final = ssd_scan(x, dt, A.expand(x.shape[0], -1), Bm, Cm,
                              out_state=state_out)
    else:
        nh = x.shape[2]
        y, h_final = _ssd_chunk_scan(x, dt, A, _heads(Bm, nh),
                                     _heads(Cm, nh))
        if state_out is not None:
            h_final = state_out.copy_(h_final)
    out = _ssd_output(p, y, x, z, cfg)
    if return_cache:
        return out, (conv_tail, h_final)
    return out


def ssd_decode(p, x_res, conv_state, ssm_state, cfg: ArchConfig):
    """Single-token recurrent update. x_res: (B, 1, D); conv_state: 3x
    (B, W-1, ·); ssm_state: (B, nh, hd, N) float32.

    Unlike the JAX package, which returns updated copies, the conv tails
    and the SSM state are updated in place, as the KV cache is, and the
    same tensors are returned.
    """
    h = rms_norm(x_res, p["ln"], cfg.norm_eps)
    x, z, dt, Bm, Cm, new_tail = _ssd_inputs(p, h, cfg, conv_state)
    for dst, src in zip(conv_state, new_tail):
        dst.copy_(src)
    A = -torch.exp(p["A_log"].float())
    nh = x.shape[2]
    # recurrent step: h' = exp(dt*A) h + dt * B (outer) x ; y = C . h'
    dtq = dt[:, 0]                              # (B, nh)
    xq = x[:, 0].float()                        # (B, nh, hd)
    Bq = _heads(Bm, nh)[:, 0].float()           # (B, nh, N)
    Cq = _heads(Cm, nh)[:, 0].float()
    decay = torch.exp(dtq * A)[..., None, None]
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtq, xq, Bq)
    ssm_state.mul_(decay).add_(upd)
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Cq)[:, None]  # (B,1,nh,hd)
    out = _ssd_output(p, y, x, z, cfg)
    return out, conv_state, ssm_state


# ==========================================================================
# Hybrid (hymba): parallel attention + SSD branches sharing the residual
# ==========================================================================

def hybrid_specs(cfg: ArchConfig) -> dict:
    return {"attn": attn_specs(cfg), "ssd": ssd_specs(cfg)}


def hybrid_fwd(p, x, cfg: ArchConfig, *, window: Window = None,
               return_cache: bool = False, state_out=None):
    """Both branches over the same input, averaged: ``0.5 * (attn +
    ssd)``; the attention with the layer's ``window`` (B3 on the card),
    the SSD half through B5 on the card. With ``return_cache`` also
    ``((k, v), (conv_tail, h_final))``; ``state_out`` as ``ssd_fwd``."""
    if return_cache:
        a, kv = attn_fwd(p["attn"], x, cfg, window=window, return_cache=True)
        s, st = ssd_fwd(p["ssd"], x, cfg, return_cache=True,
                        state_out=state_out)
        return 0.5 * (a + s), (kv, st)
    a = attn_fwd(p["attn"], x, cfg, window=window)
    s = ssd_fwd(p["ssd"], x, cfg)
    return 0.5 * (a + s)


def hybrid_decode(p, x, k_cache, v_cache, conv_state, ssm_state,
                  cache_len: int, cfg: ArchConfig, *, window: Window = None):
    """One token through both branches (B4 with the layer's window, the
    SSD recurrent step); every cache is updated in place."""
    a, k_cache, v_cache = attn_decode(p["attn"], x, k_cache, v_cache,
                                      cache_len, cfg, window=window)
    s, conv_state, ssm_state = ssd_decode(p["ssd"], x, conv_state, ssm_state,
                                          cfg)
    return 0.5 * (a + s), k_cache, v_cache, conv_state, ssm_state
