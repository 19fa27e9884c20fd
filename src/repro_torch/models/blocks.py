"""Block implementations: dense / GQA attention, multi-head latent
attention (MLA), the MLPs, the MoE layer, the SSD (Mamba-2) block and the
hybrid (hymba) block that runs attention and SSD beside each other.

Every block family exposes:

* ``<family>_specs(cfg)``   -> ParamSpec tree for one layer;
* ``<family>_fwd(p, x, ...)``  -> sequence forward (prefill). In prefill
  mode it also returns the per-layer cache entries;
* ``<family>_decode(p, x, cache, ...)`` -> single-token forward.

MLA's prefill attends through kernel B3 on the card (q/k head dim 192, v
128); its decode is the JAX package's absorbed form in plain PyTorch, as
the reference computes it in XLA. MoE dispatch is plain PyTorch too (the
reference's is XLA): the sort-free GShard dispatch, token group by token
group, with the expert products as batched matmuls.

On a mesh (DTensor activations and weights, ``parallel``) the blocks are
the same code: ``constrain`` stands where the JAX package's sharding
hints stand, ``split_heads`` makes the combined heads dim divide at head
boundaries before a view to heads, the scans and attentions run on local
shards (``common.heads_local``), and the routed experts, with
``MOE_SHARD_MAP`` on, per shard (``_moe_smap``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import costs
from repro_torch.kernels.ssd_scan import (ssd_scan, ssd_scan_cost,
                                          ssd_scan_plain)
from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd, ssd_scan_bwd_cost
from repro_torch.models.common import (
    Window, act_fn, apply_rope, attention, decode_attention, heads_local,
    rms_norm)
from repro_torch.models.param import spec
from repro_torch.parallel.dist import (current_mesh, is_dtensor, local_map,
                                       mesh_axis_sizes)
from repro_torch.parallel.sharding import (act_placements, act_pspec,
                                           constrain, current_rules)


# ==========================================================================
# Dense / GQA attention
# ==========================================================================

def split_heads(t, shape, heads_axis: str = "heads"):
    """``t`` (B, S, H * hd) viewed as ``shape`` (B, S, H, hd) and
    constrained to ``("batch", "seq", heads_axis, None)``. On a mesh the
    combined dim is first redistributed to those placements -- sharded at
    head boundaries, or gathered where the heads do not split evenly (2
    KV heads of 128 on a 16-way model axis put a shard inside a head,
    which GSPMD reshards silently and DTensor's view refuses)."""
    axes = ("batch", "seq", heads_axis, None)
    rules, mesh = current_rules(), current_mesh()
    if is_dtensor(t) and rules is not None and mesh is not None:
        pl = act_placements(rules, axes, shape, mesh)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
    return constrain(t.reshape(shape), *axes)


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
    # the heads' constraints sit before the per-head norm and RoPE, which
    # read a head's dims whole: a shard that ended inside a head (2 KV
    # heads of 128 on a 16-way model axis) is gathered here
    q = split_heads(q, (B, S, H, hd))
    k = split_heads(k, (B, S, Hkv, hd), "kv_heads")
    v = split_heads(v, (B, S, Hkv, hd), "kv_heads")
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
    out = constrain(out, "batch", "seq", "embed")
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
    return constrain(out, "batch", None, "embed"), k_cache, v_cache


# ==========================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
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


def _mla_q(p, h, cfg: ArchConfig, positions):
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = h.shape
    q = rms_norm(h @ p["q_a"], p["q_a_norm"], cfg.norm_eps) @ p["q_b"]
    q = split_heads(q, (B, S, H, m.nope_head_dim + m.rope_head_dim))
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, h, cfg: ArchConfig, positions):
    m = cfg.mla
    c, k_rope = (h @ p["kv_a"]).split([m.kv_lora_rank, m.rope_head_dim],
                                      dim=-1)
    c = rms_norm(c, p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c, k_rope


def mla_qkv(p, h, cfg: ArchConfig, positions):
    """The per-head q, k, v of non-absorbed MLA over the normed input h
    (B, S, D): q and k (B, S, H, nope + rope), v (B, S, H, v_head_dim) --
    a view into the kv_b product, as the reference's split -- and the
    compressed cache entries (c (B, S, kv_lora), k_rope (B, S, rope))."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = h.shape
    q_nope, q_rope = _mla_q(p, h, cfg, positions)
    c, k_rope = _mla_ckv(p, h, cfg, positions)
    kv = split_heads(c @ p["kv_b"],
                     (B, S, H, m.nope_head_dim + m.v_head_dim))
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, (c, k_rope)


def mla_fwd(p, x, cfg: ArchConfig, *, return_cache: bool = False):
    """Non-absorbed MLA (prefill): per-head K/V materialized, causal
    attention at q/k head dim nope + rope and v head dim ``v_head_dim``
    (B3 on the card, whose v is read through its strides in the kv_b
    product). With ``return_cache`` also the compressed cache entries
    ``(c, k_rope)``. Under grad on the card the attention's backward is
    B9 at the same head dims (``common.KernelAttention``)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    positions = torch.arange(S, device=x.device)
    q, k, v, cache = mla_qkv(p, h, cfg, positions)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    o = attention(q, k, v, causal=True, scale=scale)
    out = o.reshape(B, S, H * m.v_head_dim) @ p["wo"]
    out = constrain(out, "batch", "seq", "embed")
    if return_cache:
        return out, cache  # compressed: kv_lora + rope dims only
    return out


def mla_decode(p, x, c_cache, krope_cache, cache_len: int,
               cfg: ArchConfig):
    """Absorbed MLA decode: scores and values in the latent space, float32
    throughout, as the JAX package computes them (plain PyTorch on both
    devices: the reference has no Pallas kernel here). caches: c (B,
    Smax, kv_lora), k_rope (B, Smax, rope); the new token's entries are
    written in place at slot ``cache_len`` and the same tensors returned.
    Only the live slots [0, cache_len] are read: the reference's -1e30
    bias on the others gives them a weight of exactly 0."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    positions = torch.full((1,), cache_len, dtype=torch.int64,
                           device=x.device)
    q_nope, q_rope = _mla_q(p, h, cfg, positions)  # (B, 1, H, ·)
    c, k_rope = _mla_ckv(p, h, cfg, positions)
    c_cache[:, cache_len] = c[:, 0].to(c_cache.dtype)
    krope_cache[:, cache_len] = k_rope[:, 0].to(krope_cache.dtype)

    # absorb kv_b into q: q_lat[h] = q_nope[h] @ W_uk[h]^T  (per head)
    f32 = torch.float32
    w_kv = p["kv_b"].reshape(m.kv_lora_rank, H,
                             m.nope_head_dim + m.v_head_dim).to(f32)
    w_uk, w_uv = w_kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    q_lat = torch.einsum("bqhn,lhn->bhql", q_nope.to(f32), w_uk)
    cc = c_cache[:, :cache_len + 1].to(f32)
    kr = krope_cache[:, :cache_len + 1].to(f32)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    s = torch.einsum("bhql,bkl->bhqk", q_lat, cc)
    s = s + torch.einsum("bqhr,bkr->bhqk", q_rope.to(f32), kr)
    s = constrain(s, "batch", "heads", None, "kv_seq")
    prob = torch.softmax(s * scale, dim=-1)
    o_lat = torch.einsum("bhqk,bkl->bhql", prob, cc)
    o = torch.einsum("bhql,lhv->bqhv", o_lat, w_uv)
    out = o.reshape(B, 1, H * m.v_head_dim).to(x.dtype) @ p["wo"]
    return constrain(out, "batch", None, "embed"), c_cache, krope_cache


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
        y = (a(h @ p["wg"]) * (h @ p["wu"])) @ p["wd"]
    else:
        y = a(h @ p["w1"]) @ p["w2"]
    return constrain(y, "batch", "seq", "embed")


# ==========================================================================
# MoE (sort-free GShard-style dispatch; honest FLOPs)
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


#: the bytes a batch of token groups dispatched together may give the
#: expert buffer (E, groups, C + 1, max(D, Fe)); ``moe_fwd`` takes as many
#: groups a call as fit, at least one
MOE_BUFFER_BYTES = 1 << 30


def moe_capacity(G: int, cfg: ArchConfig) -> int:
    """Slots per expert for a group of G tokens: ``ceil(G K cf / E)``
    rounded up to a multiple of 8, at least 8."""
    mo = cfg.moe
    return max(8, int(math.ceil(G * mo.top_k * mo.capacity_factor
                                / mo.n_experts / 8.0)) * 8)


def moe_route(tok, router, top_k: int):
    """Router of token groups tok (n, G, D): float32 softmax probabilities
    (n, G, E) of ``tok @ router`` (both sides in float32, as the JAX
    package promotes them), and each token's top ``top_k`` experts in
    descending probability, a tie to the lower index (``jax.lax.top_k``'s
    order; a stable descending sort), with their probabilities normalized
    to sum 1: (gate_vals (n, G, K), topk_idx (n, G, K) int64)."""
    probs = torch.softmax(tok.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, topk_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, topk_idx


def _moe_groups(p, tok, cfg: ArchConfig, experts=None):
    """Dispatch n token groups, each as the JAX package's ``_moe_group``
    dispatches one, in one pass. tok: (n, G, D) -> y (n, G, D) in tok's
    dtype and aux (n,), float32.

    ``experts = (lo, n_local)``: ``p``'s expert weights hold only experts
    ``[lo, lo + n_local)`` (one model shard's, ``_moe_smap``); the
    routing is the whole bank's, the assignments to other experts are
    dropped, y holds this shard's experts' share of each token's sum,
    and in place of aux come its two factors, each expert's mean
    probability and routed fraction (``(me, ce)``, (n, E) each), which a
    data shard holds for its own tokens only.

    Each (token, slot) assignment is ranked within its expert by a
    one-hot cumsum over the group's flat (token, slot) order; ranks of C
    and more are dropped (capacity C, ``moe_capacity``). Kept assignments
    land in unique buffer slots (a plain ``index_put_``; drops all land in
    slot C, which is never read); the expert products are batched matmuls
    over the E experts' C slots of every group; each token's K slots are
    weighted by their gates in float32 and summed in slot order (no
    atomics: the bits are the same run to run). aux is the Switch-style
    load-balance loss, E * sum(mean prob x fraction routed), per group.
    """
    mo = cfg.moe
    n, G, D = tok.shape
    E, K = mo.n_experts, mo.top_k
    C = moe_capacity(G, cfg)
    dev = tok.device

    tok = constrain(tok, None, "batch", None)
    probs, gate_vals, topk_idx = moe_route(tok, p["router"], K)
    flat_e = topk_idx.reshape(n, G * K)
    # the one-hot expert-major (n, E, G*K), so that the rank's cumsum runs
    # along the contiguous axis
    sel = (flat_e[:, None, :] == torch.arange(E, device=dev)[:, None]) \
        .to(torch.int32)
    ce = sel.sum(dim=-1).float() * (1.0 / (G * K))            # (n, E)
    aux = E * (probs.mean(dim=1) * ce).sum(dim=-1) if experts is None \
        else (probs.mean(dim=1), ce)
    pos = torch.cumsum(sel, dim=-1).gather(
        1, flat_e[:, None, :])[:, 0] - 1                      # rank in expert
    del sel
    keep = pos < C
    grp = torch.arange(n, device=dev)[:, None].expand(n, G * K)
    row, hrow, rows = flat_e, flat_e, E
    if experts is not None:  # other shards' experts: the drop row E_loc
        lo, E = experts
        mine = (flat_e >= lo) & (flat_e < lo + E)
        keep = keep & mine
        row = torch.where(mine, flat_e - lo, E)
        hrow, rows = torch.where(mine, flat_e - lo, 0), E + 1

    buf = constrain(tok.new_zeros((rows, n, C + 1, D)),
                    "experts", None, None, None)
    buf[row, grp, torch.where(keep, pos, C)] = \
        tok.repeat_interleave(K, dim=1)
    xin = constrain(buf[:E, :, :C].reshape(E, n * C, D),
                    "experts", None, None)
    del buf
    a = act_fn(cfg.act)
    hmid = a(torch.bmm(xin, p["wg"])) * torch.bmm(xin, p["wu"])
    hout = constrain(torch.bmm(hmid, p["wd"]).view(E, n, C, D),
                     "experts", None, None, None)

    picked = hout[hrow, grp, torch.where(keep, pos, 0)].float() \
        * gate_vals.reshape(n, G * K, 1)
    picked = torch.where(keep[..., None], picked, 0.0).view(n, G, K, D)
    y = picked[:, :, 0]
    for j in range(1, K):  # each token's slots, in slot order
        y = y + picked[:, :, j]
    return y.to(tok.dtype), aux


def _moe_group(p, tok, cfg: ArchConfig):
    """One token group tok (G, D) -> (y (G, D), aux): the JAX package's
    ``_moe_group``."""
    y, aux = _moe_groups(p, tok[None], cfg)
    return y[0], aux[0]


def _moe_seq_groups(p, h, cfg: ArchConfig, gs: int, experts=None):
    """h (B, S, D) in groups of ``gs`` positions over the whole batch,
    dispatched ``MOE_BUFFER_BYTES`` at a time: (y (B, S, D), aux (nc,));
    with ``experts`` (``_moe_groups``) aux's factors (me, ce), (nc, E)
    each."""
    mo = cfg.moe
    B, S, D = h.shape
    nc = S // gs
    tok = h.reshape(B, nc, gs, D).transpose(0, 1).reshape(nc, B * gs, D)
    C = moe_capacity(B * gs, cfg)
    rows = mo.n_experts if experts is None else experts[1] + 1
    per_group = rows * (C + 1) * max(D, mo.d_ff_expert) * tok.element_size()
    step = max(1, MOE_BUFFER_BYTES // per_group)
    parts = [_moe_groups(p, tok[i:i + step], cfg, experts)
             for i in range(0, nc, step)]
    y = torch.cat([y for y, _ in parts]) if len(parts) > 1 else parts[0][0]
    y = y.view(nc, B, gs, D).transpose(0, 1).reshape(B, S, D)
    if experts is not None:
        return y, tuple(torch.cat([a[i] for _, a in parts]) for i in (0, 1))
    return y, torch.cat([a for _, a in parts])


#: the JAX package's ``MOE_SHARD_MAP`` toggle: on a mesh, dispatch each
#: model shard's experts on its data shard's tokens (``_moe_smap``)
#: instead of letting DTensor shard the dispatch's ops
MOE_SHARD_MAP = {"enabled": False}


@contextlib.contextmanager
def moe_dispatch(mode: str):
    """``MOE_SHARD_MAP`` inside the block: on for ``"shard_map"``, off for
    ``"gspmd"`` (the dry run's ``--moe``)."""
    if mode not in ("gspmd", "shard_map"):
        raise ValueError(f"moe dispatch {mode!r}: want gspmd or shard_map")
    old = MOE_SHARD_MAP["enabled"]
    MOE_SHARD_MAP["enabled"] = mode == "shard_map"
    try:
        yield
    finally:
        MOE_SHARD_MAP["enabled"] = old


def moe_shard_map_applicable(cfg: ArchConfig) -> bool:
    mesh = current_mesh()
    if mesh is None:
        return False
    n_model = mesh_axis_sizes(mesh).get("model", 1)
    return cfg.moe is not None and cfg.moe.n_experts % n_model == 0


def _moe_smap(p, h, cfg: ArchConfig, gs: int):
    """The mesh path of the routed experts (the JAX package's
    ``_moe_group_smap``): each model shard runs its ``E / n_model``
    experts on its data shard's tokens -- routed over the whole bank, at
    the capacity of a local group -- and the shards' partial sums are
    all-reduced over ``"model"``. aux's factors, each expert's mean
    probability and routed fraction, are averaged over the data shards
    before their product, so aux is the whole group's, as on one device.
    h: a (B, S, D) DTensor; returns (y, aux (nc,)) as DTensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mo = cfg.moe
    mesh = h.device_mesh
    sizes = mesh_axis_sizes(mesh)
    names = list(mesh.mesh_dim_names)
    n_model = sizes.get("model", 1)
    e_loc = mo.n_experts // n_model
    lo = mesh.get_local_rank("model") * e_loc if "model" in sizes else 0
    rules = current_rules()
    b_spec = act_pspec(rules, ("batch",), (h.shape[0],), sizes) \
        if rules is not None else ()
    b_axes = () if not b_spec else (
        (b_spec[0],) if isinstance(b_spec[0], str) else tuple(b_spec[0]))
    n_batch = 1
    for a in b_axes:
        n_batch *= sizes[a]
    reduced = [a for a in names if a == "model" or a in b_axes]

    def pl(batch_dim=None, experts=False, partial=()):
        out = [Replicate()] * len(names)
        for a in b_axes:
            if batch_dim is not None:
                out[names.index(a)] = Shard(batch_dim)
        if experts and "model" in names:
            out[names.index("model")] = Shard(0)
        for a in partial:
            out[names.index(a)] = Partial()
        return tuple(out)

    def local(h_loc, router, wg, wu, wd):
        y, (me, ce) = _moe_seq_groups(
            {"router": router, "wg": wg, "wu": wu, "wd": wd}, h_loc, cfg, gs,
            experts=(lo, e_loc))
        # summed over the data shards, me and ce are the whole group's
        # means; every model shard holds the same me, so its sum over
        # the model shards is scaled back (and so is its gradient)
        return y, me / (n_batch * n_model), ce / n_batch

    w_pl = pl(experts=True)
    w_grad = pl(experts=True, partial=b_axes)
    model = ("model",) if "model" in names else ()
    ins = (h, p["router"], p["wg"], p["wu"], p["wd"])
    y, me, ce = local_map(
        local, ins, (pl(0), pl(), w_pl, w_pl, w_pl),
        (pl(0, partial=model), pl(partial=reduced), pl(partial=b_axes)),
        grad_placements=(pl(0, partial=model), pl(partial=reduced), w_grad,
                         w_grad, w_grad))
    me, ce = me.redistribute(mesh, pl()), ce.redistribute(mesh, pl())
    return y.redistribute(mesh, pl(0)), \
        mo.n_experts * (me * ce).sum(dim=-1)


def moe_fwd(p, x, cfg: ArchConfig):
    """x: (B, S, D) -> (y, aux_loss), the JAX package's grouping: token
    groups are sequence chunks of ``gs = max(1, min(group_size, B S) //
    B)`` positions over the whole batch (``gs = 1`` when S is not a
    multiple of it), a group's tokens batch-major; aux is the mean over
    groups. The reference scans the groups one by one; here as many as
    ``MOE_BUFFER_BYTES`` allows go through one dispatch. The shared
    experts, where the arch has them, are a dense gated MLP over every
    token. On a mesh with ``MOE_SHARD_MAP`` on (and the experts dividing
    the model axis) the routed experts take ``_moe_smap``."""
    mo = cfg.moe
    B, S, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    G = min(mo.group_size, B * S)
    gs = max(1, G // B)
    if S % gs != 0:
        gs = 1
    if MOE_SHARD_MAP["enabled"] and is_dtensor(h) \
            and moe_shard_map_applicable(cfg):
        y, aux = _moe_smap(p, h, cfg, gs)
    else:
        y, aux = _moe_seq_groups(p, h, cfg, gs)
    aux = aux.mean()
    if mo.n_shared_experts:
        a = act_fn(cfg.act)
        y = y + (a(h @ p["sh_wg"]) * (h @ p["sh_wu"])) @ p["sh_wd"]
    return constrain(y, "batch", "seq", "embed"), aux


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

    x = constrain(h @ p["in_x"], "batch", "seq", "ssm_inner")
    z = constrain(h @ p["in_z"], "batch", "seq", "ssm_inner")
    Bm = constrain(h @ p["in_B"], "batch", "seq", None)
    Cm = constrain(h @ p["in_C"], "batch", "seq", None)
    dt = constrain(h @ p["in_dt"], "batch", "seq", None)

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

    x = split_heads(x, (B_, S, nh, ss.head_dim))
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
    return constrain(y @ p["out_proj"], "batch", "seq", "embed")


class KernelSSD(torch.autograd.Function):
    """The SSD scan whose forward is kernel B5 and whose backward is kernel
    B10: the card's training scan. ``apply(x, dt, A, Bm, Cm)`` with
    ``ssd_scan``'s arguments returns y and the final state; the state's
    gradient, where it feeds the loss, reaches B10 too."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        y, state = ssd_scan(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate)


def _ssd_scan_any(x, dt, A, Bm, Cm, state_out=None):
    """The scan of ``ssd_fwd`` on plain tensors: y and the final state
    (written into ``state_out`` when given). The card (and a dry run's
    fake tensors): B5, or ``KernelSSD`` under grad; the CPU: the JAX
    package's plain form, groups repeated to heads, counted as B5 (and
    its backward as B10)."""
    if x.device.type == "cuda" or costs.is_fake(x):
        A = A.expand(x.shape[0], -1)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, Bm, Cm)):
            y, h_final = KernelSSD.apply(x, dt, A, Bm, Cm)
            if state_out is not None:
                h_final = state_out.copy_(h_final.detach())
            return y, h_final
        return ssd_scan(x, dt, A, Bm, Cm, out_state=state_out)
    nh = x.shape[2]
    A_b = A.expand(x.shape[0], -1)  # as B5 and B10 take it
    y, h_final = costs.as_kernel(
        "B5", lambda: ssd_scan_cost(x, dt, A_b, Bm, Cm),
        lambda x, dt, A, Bm, Cm: _ssd_chunk_scan(
            x, dt, A, _heads(Bm, nh), _heads(Cm, nh)),
        (x, dt, A, Bm, Cm),
        backward=("B10", lambda: ssd_scan_bwd_cost(x, dt, A_b, Bm, Cm)))
    if state_out is not None:
        h_final = state_out.copy_(h_final)
    return y, h_final


def ssd_fwd(p, x_res, cfg: ArchConfig, *, return_cache: bool = False,
            state_out=None):
    """Mamba-2 block over a sequence. x_res: (B, S, D).

    With ``return_cache`` also returns ``(conv_tail, h_final)``.
    ``state_out`` (a float32 ``(B, nh, hd, N)`` tensor, e.g. a cache's
    layer slice) receives the final state in place — written by kernel B5
    itself on the card — and is the ``h_final`` returned.

    On the card with grad enabled on an input that requires it, the scan
    goes through ``KernelSSD`` (B5 forward, B10 backward); ``state_out``
    then receives a copy of the final state. On a
    mesh the scan runs on local shards (``common.heads_local``: heads as
    the rules shard ``"heads"``, B and C cut to the groups they read).
    """
    h = rms_norm(x_res, p["ln"], cfg.norm_eps)
    x, z, dt, Bm, Cm, conv_tail = _ssd_inputs(p, h, cfg)
    A = -torch.exp(p["A_log"].float())
    if is_dtensor(x):
        if state_out is not None:
            raise NotImplementedError("a cache's state slot on a mesh")
        y, h_final = heads_local(
            _ssd_scan_any, (x, dt, A, Bm, Cm), ("q", "q", "q", "kv", "kv"),
            ("q", "q"), n_heads=x.shape[2], n_groups=Bm.shape[2],
            head_dims=(2, 2, 0, 2, 2, 2, 1),
            batched=(True, True, False, True, True, True, True))
    else:
        y, h_final = _ssd_scan_any(x, dt, A, Bm, Cm, state_out)
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
    if is_dtensor(x):  # each device's heads, its state slice in place
        y = heads_local(
            _ssd_recur, (x, dt, A, Bm, Cm, ssm_state),
            ("q", "q", "q", "kv", "kv", "q"), ("q",), n_heads=x.shape[2],
            n_groups=Bm.shape[2], head_dims=(2, 2, 0, 2, 2, 1, 2),
            batched=(True, True, False, True, True, True, True))
    else:
        y = _ssd_recur(x, dt, A, Bm, Cm, ssm_state)
    out = _ssd_output(p, y, x, z, cfg)
    return out, conv_state, ssm_state


def _ssd_recur(x, dt, A, Bm, Cm, ssm_state):
    """One token's recurrent update of ``ssm_state`` (B, nh, hd, N) in
    place and its read-out y (B, 1, nh, hd)."""
    nh = x.shape[2]
    # recurrent step: h' = exp(dt*A) h + dt * B (outer) x ; y = C . h'
    dtq = dt[:, 0]                              # (B, nh)
    xq = x[:, 0].float()                        # (B, nh, hd)
    Bq = _heads(Bm, nh)[:, 0].float()           # (B, nh, N)
    Cq = _heads(Cm, nh)[:, 0].float()
    decay = torch.exp(dtq * A)[..., None, None]
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtq, xq, Bq)
    ssm_state.mul_(decay).add_(upd)
    return torch.einsum("bhpn,bhn->bhp", ssm_state, Cq)[:, None]


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
