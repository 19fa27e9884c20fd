"""Shared model primitives: norms, RoPE, activations, attention cores.

``window`` arguments are ``None`` (no sliding window) or an int / 0-d
int tensor (sliding-window size).

Attention dispatch follows the tensor's device, as the kernels' wrappers
do. On a CUDA tensor, sequence attention (``attention``: causal, causal
with a sliding window or a prefix-LM block, or bidirectional, with or
without a query offset) goes to the hand-written kernel B3 and
single-token attention against the cache (``decode_attention``, with or
without a window) to B4, at every length; a window of at least every
query's position is no window. When an input requires grad (training),
``attention`` on the card runs ``KernelAttention``, an autograd function
whose forward is B3 with its row log-sum-exp and whose backward is kernel
B9 under the same mask, at B9's (q/k, v) head dims (its
``HEAD_DIM_PAIRS``: equal widths, or multi-head latent attention's 192
and 128, and 24 and 16); B4 has no backward, and its wrapper raises then
rather than drop a gradient. On a CPU tensor both
run the plain forms exactly as the JAX package dispatches them
(``plain_attention`` up to ``chunk_threshold`` keys, then
``flash_attention_jax``, or, with ``ATTENTION_VARIANT`` set to
``"triangle"``, ``flash_attention_triangle`` where the JAX package takes
it), and training differentiates through those, as the JAX package
differentiates through its own. The triangle on the card is B3 itself:
its key loop already visits only the key tiles in ``[lo(window),
diagonal]`` of each query tile, the triangle's live blocks at the
kernel's own tile size, so the toggle changes no card output. A cost
counter (``core.costs``) counts those plain forms as the kernels they
stand for (``costs.as_kernel``: B3's formula, and B9's for the backward
through it; B4's), so a step counts the same on either device; a dry
run's fake tensors take the kernels' route, whose wrappers return shaped
outputs.

On a mesh (DTensor inputs, ``parallel``) both attentions run on local
shards (``heads_local``): batch sharded as the rules shard ``"batch"``,
query heads as they shard ``"heads"`` where the heads split evenly into
whole GQA groups, each device's K/V heads cut to the groups its query
heads read. The JAX package's sharding hints are ``constrain`` calls
here, no-ops without rules and a mesh.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import costs
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_attention_kernel
from repro_torch.kernels.decode_attention import decode_attention_cost
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention_cost
from repro_torch.kernels.flash_attention_bwd import \
    HEAD_DIM_PAIRS as B9_HEAD_DIM_PAIRS
from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd,
                                                     flash_attention_bwd_cost)
from repro_torch.parallel.dist import is_dtensor, local_map
from repro_torch.parallel.sharding import act_pspec, constrain, current_rules

Window = Union[None, int, torch.Tensor]

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * w.float()).to(dt)


def gelu(x):  # tanh approximation, as the JAX package
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": gelu, "gelu_glu": gelu}[name]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,) or (..., seq)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * freqs  # (..., seq, d/2)
    cos = ang.cos()[..., None, :]  # broadcast over heads
    sin = ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Plain attention cores (the CPU path; the plain versions of B3/B4 live
# beside the kernels). ``plain`` materializes (Sq, Sk) scores;
# ``flash_attention_jax`` is the online-softmax scan over KV blocks of the
# JAX package's XLA path, kept as its plain form for long sequences.
# --------------------------------------------------------------------------

def _window_ok(ok, q_pos, k_pos, window: Window):
    if window is None:
        return ok
    return ok & (k_pos[None, :] > q_pos[:, None] - window)


def _mask_bias(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, 0.0, NEG_INF)


def plain_attention(q, k, v, *, causal: bool, window: Window = None,
                    q_offset=0, scale: Optional[float] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D[v]). GQA by head grouping."""
    B, Sq, H, D = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    groups = H // Hkv
    dev = q.device
    qg = q.reshape(B, Sq, Hkv, groups, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * scale, k.float())
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
    ok = _window_ok(ok, q_pos, k_pos, window)
    if prefix_len > 0:  # prefix-LM: everything attends to the prefix block
        ok = ok | (k_pos[None, :] < prefix_len)
    p = torch.softmax(scores + _mask_bias(ok), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _pad_seq(x, chunk):
    S = x.shape[1]
    n = (S + chunk - 1) // chunk
    pad = n * chunk - S
    if pad:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
    return x, n


def flash_attention_jax(q, k, v, *, causal: bool, window: Window = None,
                        q_offset=0, q_chunk: int = 2048,
                        kv_chunk: int = 1024,
                        scale: Optional[float] = None,
                        prefix_len: int = 0) -> torch.Tensor:
    """Double-chunked online-softmax attention (the JAX package's XLA
    flash path), chunk for chunk. Like the original it scans the full
    (q x kv) rectangle and masks; kernel B3 is what skips the tiles past
    the diagonal. Returns v's dtype, as the original."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    Hkv = k.shape[2]
    Dv = v.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    k = constrain(k, "batch", "kv_seq", "heads", None)
    v = constrain(v, "batch", "kv_seq", "heads", None)
    dev = q.device

    q = q.float() * scale
    qp, nq = _pad_seq(q, q_chunk)
    kp, nk = _pad_seq(k, kv_chunk)
    vp, _ = _pad_seq(v, kv_chunk)
    outs = []
    for qi in range(nq):
        qb = qp[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, H, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, H, q_chunk), device=dev)
        acc = torch.zeros((B, H, q_chunk, Dv), device=dev)
        for ki in range(nk):
            kb = kp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = vp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            # the operands in k's dtype, the sums in float32
            s = torch.einsum("bqhd,bkhd->bhqk", qb.to(kb.dtype).float(),
                             kb.float())
            bounds = (k_pos[None, :] < Sk) & (q_pos[:, None] < Sq + q_offset)
            ok = bounds
            if causal:
                ok = ok & (k_pos[None, :] <= q_pos[:, None])
            okw = _window_ok(ok, q_pos, k_pos, window)
            if prefix_len > 0:  # bidirectional attention within the prefix
                okw = okw | (bounds & (k_pos[None, :] < prefix_len))
            s = s + _mask_bias(okw)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        ob = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B, H, qc, Dv)
        outs.append(ob.transpose(1, 2))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


def flash_attention_triangle(q, k, v, *, causal: bool = True,
                             window: Optional[int] = None,
                             q_chunk: int = 2048, kv_chunk: int = 1024,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's triangle/window-blocked causal attention (its
    hill-climb variant of ``flash_attention_jax``), block for block: the q
    chunks unrolled, and each q chunk's kv loop over only the blocks that
    can be live, ``[lo(window), qi]``, where the baseline scans the whole
    rectangle and masks. Causal self-attention (Sq == Sk) with a static
    ``window`` (an int or None) and no prefix, as the original asserts.
    q is scaled in float32 and rounded to k's dtype, the products in the
    operands' dtype summed in float32. A kv block past the keys (the
    original reads a clamped slice there, wholly masked) adds nothing, so
    the loop stops at the last one. Returns v's dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    assert causal and Sq == Sk, "triangle variant is causal self-attn only"
    Hkv = k.shape[2]
    Dv = v.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    k = constrain(k, "batch", "kv_seq", "heads", None)
    v = constrain(v, "batch", "kv_seq", "heads", None)
    dev = q.device

    q = (q.float() * scale).to(k.dtype)
    qp, nq = _pad_seq(q, q_chunk)
    kp, nk = _pad_seq(k, kv_chunk)
    vp, _ = _pad_seq(v, kv_chunk)
    outs = []
    for qi in range(nq):  # unrolled: nq is small (S / q_chunk)
        qb = qp[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        hi = qi * q_chunk + q_chunk - 1          # last live kv position
        lo = 0 if window is None else max(0, qi * q_chunk - int(window))
        k_lo, k_hi = lo // kv_chunk, min(hi // kv_chunk, nk - 1)
        m = torch.full((B, H, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, H, q_chunk), device=dev)
        acc = torch.zeros((B, H, q_chunk, Dv), device=dev)
        for ki in range(k_lo, k_hi + 1):
            kb = kp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = vp[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb.float())
            ok = (k_pos[None, :] < Sk) & (q_pos[:, None] < Sq) \
                & (k_pos[None, :] <= q_pos[:, None])
            ok = _window_ok(ok, q_pos, k_pos, window)
            s = s + _mask_bias(ok)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        ob = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(ob.transpose(1, 2))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(v.dtype)


#: the JAX package's hill-climb toggle (``--attention triangle``): on the
#: CPU, long causal self-attention with a static window and no prefix runs
#: ``flash_attention_triangle``; on the card B3 runs either way
ATTENTION_VARIANT = {"impl": "baseline"}


class KernelAttention(torch.autograd.Function):
    """Attention whose forward is kernel B3 (with its row log-sum-exp) and
    whose backward is kernel B9, both under one mask: the card's training
    attention. ``apply(q, k, v, scale, causal, window, prefix_len,
    q_offset)``; scale None is ``D ** -0.5``, window None or an int
    (B3's), prefix_len and q_offset ints."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, prefix_len,
                q_offset=0):
        o, lse = flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                        return_lse=True, window=window,
                                        prefix_len=prefix_len,
                                        q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(scale=scale, causal=causal, window=window,
                        prefix_len=prefix_len, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def _kernel_window(window: Window, Sq: int, q_offset: int = 0
                   ) -> Optional[int]:
    """The window as the kernels take it: an int, or None where it masks
    nothing (none given, or at least ``q_offset + Sq`` keys, every query's
    position: hymba's global layers)."""
    if window is None or int(window) >= q_offset + Sq:
        return None
    return int(window)


def _triangle(causal: bool, window: Window, prefix_len: int, Sq: int,
              Sk: int, q_offset) -> bool:
    """Whether the JAX package's ``attention`` takes the triangle variant
    here: toggled on, causal self-attention with no prefix (and, as the
    triangle has none, no query offset) and a static window."""
    return (ATTENTION_VARIANT["impl"] == "triangle" and causal
            and prefix_len == 0 and Sq == Sk and q_offset == 0
            and isinstance(window, (int, type(None))))


def attention(q, k, v, *, causal: bool, window: Window = None, q_offset=0,
              scale: Optional[float] = None, prefix_len: int = 0,
              chunk_threshold: int = 2048, q_chunk: int = 2048,
              kv_chunk: int = 1024) -> torch.Tensor:
    """Sequence attention, query row ``i`` at position ``q_offset + i``.
    CUDA: kernel B3 (any of its masks), through ``KernelAttention``
    (backward B9, under the same mask) when an input requires grad. CPU:
    plain, chunked flash or (``ATTENTION_VARIANT``) the triangle by KV
    length, as the JAX package (counted as B3 and B9). Fake tensors: B3's
    route. DTensors: on local shards."""
    if is_dtensor(q):
        return heads_local(
            lambda ql, kl, vl: attention(
                ql, kl, vl, causal=causal, window=window, q_offset=q_offset,
                scale=scale, prefix_len=prefix_len,
                chunk_threshold=chunk_threshold, q_chunk=q_chunk,
                kv_chunk=kv_chunk),
            (q, k, v), ("q", "kv", "kv"), ("q",), n_heads=q.shape[2],
            n_groups=k.shape[2])
    Sq, Sk = q.shape[1], k.shape[1]
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    q_offset = int(q_offset)
    if q.device.type == "cuda" or costs.is_fake(q):
        window = _kernel_window(window, Sq, q_offset)
        if grad:
            D, Dv = q.shape[-1], v.shape[-1]
            if (D, Dv) not in B9_HEAD_DIM_PAIRS:
                raise NotImplementedError(
                    f"training on the card differentiates attention at "
                    f"B9's (q/k, v) head dims {B9_HEAD_DIM_PAIRS} only "
                    f"(got {D}, {Dv})")
            return KernelAttention.apply(q, k, v, scale, causal, window,
                                         prefix_len, q_offset)
        return flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                      window=window, prefix_len=prefix_len,
                                      q_offset=q_offset)

    def plain(q, k, v):
        if Sk <= chunk_threshold:
            return plain_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale,
                                   prefix_len=prefix_len)
        if _triangle(causal, window, prefix_len, Sq, Sk, q_offset):
            return flash_attention_triangle(
                q, k, v, causal=True, window=window,
                q_chunk=min(q_chunk, Sq), kv_chunk=kv_chunk, scale=scale)
        return flash_attention_jax(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset,
                                   q_chunk=min(q_chunk, Sq),
                                   kv_chunk=kv_chunk, scale=scale,
                                   prefix_len=prefix_len)
    mask = dict(causal=causal, window=_kernel_window(window, Sq, q_offset),
                prefix_len=prefix_len, q_offset=q_offset)
    return costs.as_kernel(
        "B3", lambda: flash_attention_cost(q, k, v, return_lse=grad, **mask),
        plain, (q, k, v), backward=(
            "B9", lambda: flash_attention_bwd_cost(q, k, v, **mask)))


def decode_attention(q, k_cache, v_cache, cache_len, *, scale=None,
                     window: Window = None, prefix_len: int = 0
                     ) -> torch.Tensor:
    """Single-token attention against the KV cache.

    q: (B, 1, H, D); caches: (B, S, Hkv, D). Positions > cache_len masked
    (the new token itself sits at slot ``cache_len``); a ``window`` keeps
    the last ``window`` of them and, beside it, the slots before
    ``prefix_len``. CUDA: kernel B4, which reads the live slots alone.
    CPU: the JAX package's form — q scaled in float32 and rounded to the
    cache's dtype, products in the cache's dtype summed in float32
    (counted as B4). Fake tensors: B4's route. DTensors: on local shards,
    the cache's sequence gathered.
    """
    if is_dtensor(q):
        return heads_local(
            lambda ql, kl, vl: decode_attention(
                ql, kl, vl, cache_len, scale=scale, window=window,
                prefix_len=prefix_len),
            (q, k_cache, v_cache), ("q", "kv", "kv"), ("q",),
            n_heads=q.shape[2], n_groups=k_cache.shape[2])
    if q.device.type == "cuda" or costs.is_fake(q):
        return decode_attention_kernel(q, k_cache, v_cache, cache_len,
                                       scale=scale, window=window,
                                       prefix_len=prefix_len)
    return costs.as_kernel(
        "B4", lambda: decode_attention_cost(
            q, k_cache, v_cache, cache_len, window=window,
            prefix_len=prefix_len),
        lambda q, k_cache, v_cache: _plain_decode(
            q, k_cache, v_cache, cache_len, scale=scale, window=window,
            prefix_len=prefix_len), (q, k_cache, v_cache))


def _plain_decode(q, k_cache, v_cache, cache_len, *, scale, window,
                  prefix_len):
    """``decode_attention``'s CPU form, the JAX package's."""
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    groups = H // Hkv
    qg = (q.float() * scale).to(k_cache.dtype).reshape(B, Hkv, groups, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    k_pos = torch.arange(S, device=q.device)
    ok = k_pos <= cache_len
    if window is not None:
        okw = ok & (k_pos > cache_len - window)
        if prefix_len > 0:
            okw = okw | (ok & (k_pos < prefix_len))
        ok = okw
    s = constrain(s + _mask_bias(ok), "batch", "kv_heads", None, "kv_seq")
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------
# Shard-local calls over heads
# --------------------------------------------------------------------------

def _head_layout(n_heads: int, n_groups: int, batch: int, mesh):
    """How a per-head call is cut on ``mesh`` under the current rules:
    ``(batch_spec, head_axes, n_shards, rank)`` -- the batch dim's spec
    entry, the mesh axes the heads are sharded over (``()`` when they are
    not: no rules, or the heads do not split into whole GQA groups
    evenly), how many ways, and this device's index among them."""
    rules = current_rules()
    if rules is None:
        return None, (), 1, 0
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = act_pspec(rules, ("batch", "heads"), (batch, n_heads), sizes)
    spec = spec + (None,) * (2 - len(spec))
    b_spec, h_spec = spec
    if h_spec is None:
        return b_spec, (), 1, 0
    axes = (h_spec,) if isinstance(h_spec, str) else tuple(h_spec)
    n = 1
    rank = 0
    for a in axes:
        n *= sizes[a]
        rank = rank * sizes[a] + mesh.get_local_rank(a)
    local, per_group = n_heads // n, n_heads // n_groups
    if local % per_group and per_group % local:
        return b_spec, (), 1, 0
    return b_spec, axes, n, rank


def heads_local(fn, args, kinds, out_kinds, *, n_heads: int, n_groups: int,
                head_dims=None, batched=None):
    """``fn`` on each device's local shards of per-head DTensor ``args``,
    its outputs wrapped back as DTensors: the batch dim 0 sharded as the
    rules shard ``"batch"``; an argument of kind ``"q"`` (or output) with
    its heads sharded as the rules shard ``"heads"``; one of kind
    ``"kv"`` with its ``n_groups`` groups replicated and then cut to the
    groups this device's query heads read (head ``h`` reads group ``h //
    (n_heads // n_groups)``), its gradient summed over the devices that
    cut it; ``"rep"``: replicated whole. ``head_dims`` (default 2 each)
    is each argument's then each output's head dim, ``batched`` (default
    all) whether it has the batch dim 0."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    n_all = len(args) + len(out_kinds)
    head_dims = (2,) * n_all if head_dims is None else tuple(head_dims)
    batched = (True,) * n_all if batched is None else tuple(batched)
    batch = next(a.shape[0] for a, b in zip(args, batched) if b)
    b_spec, h_axes, n, rank = _head_layout(n_heads, n_groups, batch, mesh)
    names = list(mesh.mesh_dim_names)
    b_axes = () if b_spec is None else (
        (b_spec,) if isinstance(b_spec, str) else tuple(b_spec))

    def placements(kind, hd, has_batch, grad=False):
        out = [Replicate()] * len(names)
        if has_batch:
            for a in b_axes:
                out[names.index(a)] = Shard(0)
        for a in h_axes:
            if kind == "q":
                out[names.index(a)] = Shard(hd)
            elif kind == "kv" and grad:
                out[names.index(a)] = Partial()
        return tuple(out)

    per_group = n_heads // n_groups
    local_heads = n_heads // n
    g_lo = rank * local_heads // per_group
    g_n = max(1, local_heads // per_group)
    nargs = len(args)
    in_pl = [placements(k, hd, b) for k, hd, b in
             zip(kinds, head_dims[:nargs], batched[:nargs])]
    grad_pl = [placements(k, hd, b, grad=True) for k, hd, b in
               zip(kinds, head_dims[:nargs], batched[:nargs])]
    out_pl = [placements(k, hd, b) for k, hd, b in
              zip(out_kinds, head_dims[nargs:], batched[nargs:])]

    def local(*xs):
        if h_axes:
            xs = [x.narrow(hd, g_lo, g_n) if k == "kv" else x
                  for x, k, hd in zip(xs, kinds, head_dims)]
        return fn(*xs)

    args = [a if is_dtensor(a) or not isinstance(a, torch.Tensor)
            else _replicated(a, mesh) for a in args]
    return local_map(local, args, in_pl, out_pl, grad_placements=grad_pl)


def _replicated(t: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)
