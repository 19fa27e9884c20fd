"""Model assembly: embedding -> layer stack -> unembedding.

Plain functions over a parameter tree (nested dicts of tensors, layer
weights stacked on a leading axis), with the JAX package's names and its
``(B, S, H, D)`` layout at every public function. The layer ``lax.scan``
is a Python loop over the stacked weights: each stacked leaf is
``unbind``-ed once a forward into its layers' views (nothing is copied;
under autograd the backward of one ``unbind`` is one ``stack``, where a
view ``a[i]`` per layer would write a zero gradient of the whole stack
per layer). On a CUDA tensor every attention call goes through the hand
kernels (B3 at prefill and in training, whose backward is B9; B4 at
decode) and every SSD prefill through B5; on a CPU tensor through their
plain forms, and autograd through those.

Training (``loss_fn``, ``forward(..., remat=)``) runs with no cache and
no in-place write: the inference-only code (caches written in place,
preallocated outputs) is on the prefill and decode paths only. The
remat policies wrap each layer: ``"full"`` recomputes it in the backward
(``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the 2-D
matmul outputs and recomputes the rest (a selective-checkpoint policy
that saves ``aten.mm``, the JAX package's
``dots_with_no_batch_dims_saveable``), ``"none"`` keeps everything.

The port runs every family of the JAX package: the dense text family,
the SSD family, the hybrid family (hymba: attention beside an SSD branch,
sliding-window layers between global ones), the audio encoder (hubert:
projected frame embeddings plus a sinusoidal table, bidirectional
attention, no decode), the vision prefix-LM (paligemma: projected patch
embeddings before the scaled text embedding, the patches attended
bidirectionally) and MoE (granite: GQA attention and routed experts;
deepseek-v2: multi-head latent attention, shared and routed experts, and
a leading dense layer ``dense0`` before the stack). Caches are updated in
place: the KV cache by slot, MLA's latent cache (c, k_rope) by slot, the
SSD conv tails and states whole.
"""
from __future__ import annotations

import contextvars
import functools
from typing import Any, Optional

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks, registry
from repro_torch.models.common import rms_norm
from repro_torch.models.param import cast_tree, tree_leaves, tree_with_leaves
from repro_torch.parallel.dist import is_dtensor, local_map
from repro_torch.parallel.sharding import constrain, gather_params

REMAT_POLICIES = {
    "full": None,  # save nothing
    "dots": "torch.ops.aten.mm saved (dots_with_no_batch_dims_saveable)",
    "none": "everything saved",
}


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of 2-D matmuls (``x @ w``
    lowers to ``aten.mm``; the attention einsums, with batch dims, to
    ``aten.bmm``), recompute everything else."""
    CP = torch_checkpoint.CheckpointPolicy
    return CP.MUST_SAVE if op is torch.ops.aten.mm.default \
        else CP.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` wrapped by the remat policy ``policy`` (a key of
    ``REMAT_POLICIES``). A layer's recompute runs in the context
    variables of its forward call -- the mesh and the sharding rules
    (``parallel``) are context variables, and the backward of a CUDA
    tensor runs on the autograd engine's device thread, which does not
    inherit them: without them a mesh layer's recompute would place its
    tensors otherwise than its forward did."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat {policy!r}: want one of "
                         f"{sorted(REMAT_POLICIES)}")
    if policy == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_dots)

    def remat(*args):
        ctx = contextvars.copy_context()
        return torch_checkpoint.checkpoint(
            lambda *a: ctx.run(fn, *a), *args, **kw)
    return remat


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def _sinusoid(S: int, D: int, device) -> torch.Tensor:
    """(S, D) float32 sinusoidal positions, the JAX package's table
    (sin in the even columns, cos in the odd), in float32 throughout."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    rate = -torch.log(torch.tensor(10000.0, device=device)) / D
    div = torch.exp(torch.arange(0, D, 2, dtype=torch.float32,
                                 device=device) * rate)
    pe = torch.zeros((S, D), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _text_scale(cfg: ArchConfig, dtype, device) -> torch.Tensor:
    """The vision arch's text-embedding scale ``d_model ** 0.5``, rounded
    to the compute dtype first as the JAX package does (gemma)."""
    return torch.tensor(cfg.d_model ** 0.5, dtype=dtype, device=device)


def _rows(table, ids):
    """``table[ids]``: the embedding lookup. On a mesh the table is
    gathered whole and each device looks up its own ids (the table's
    gradient summed over the devices that hold different ids)."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate
    mesh = table.device_mesh
    ids_pl = tuple(ids.placements)
    rep = (Replicate(),) * mesh.ndim
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in ids_pl)
    return local_map(lambda t, i: t[i], (table, ids), (rep, ids_pl),
                     (ids_pl,), grad_placements=(grad, None))


def embed_inputs(params, batch: dict, cfg: ArchConfig,
                 dtype=torch.bfloat16):
    """Returns x: (B, S_total, D) and the prefix length (the vision arch's
    patches; 0 otherwise). The audio arch reads ``batch["frames"]``
    (B, T, frontend_dim), the vision arch ``batch["patches"]`` (B,
    frontend_seq, frontend_dim) and ``batch["tokens"]``, the rest
    ``batch["tokens"]``."""
    if cfg.frontend == "audio":
        x = batch["frames"].to(dtype) @ params["frontend_proj"].to(dtype)
        x = x + _sinusoid(x.shape[1], x.shape[2], x.device).to(dtype)
        return constrain(x, "batch", "seq", "embed"), 0
    tx = _rows(params["embed"].to(dtype), batch["tokens"])
    if cfg.frontend == "vision":
        img = batch["patches"].to(dtype) @ params["frontend_proj"].to(dtype)
        tx = tx * _text_scale(cfg, dtype, tx.device)
        x = torch.cat([constrain(img, "batch", "seq", "embed"),
                       constrain(tx, "batch", "seq", "embed")], dim=1)
        return constrain(x, "batch", "seq", "embed"), cfg.frontend_seq
    return constrain(tx, "batch", "seq", "embed"), 0


def unembed(params, x, cfg: ArchConfig):
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if "lm_head" in params:
        logits = h @ params["lm_head"].to(h.dtype)
    else:
        logits = h @ params["embed"].to(h.dtype).T  # tied: h @ embed.T
    return constrain(logits, "batch", "seq", "vocab")


# --------------------------------------------------------------------------
# Layer application
# --------------------------------------------------------------------------

def _layers(layers, L: int) -> list:
    """The L layers' weight trees: views into the stacked tree, each
    stacked leaf ``unbind``-ed once."""
    per = {path: leaf.unbind(0) for path, leaf in tree_leaves(layers)}
    return [tree_with_leaves(layers, {path: v[i] for path, v in per.items()})
            for i in range(L)]


def _cache_slice(tree, i: int):
    """Layer ``i``'s entries of a stacked cache (nested tuples): views."""
    if isinstance(tree, tuple):
        return tuple(_cache_slice(t, i) for t in tree)
    return tree[i]


def _apply_layer(p, x, cfg: ArchConfig, *, window, prefix_len: int,
                 prefill: bool, slot=None):
    """Returns (x, aux, cache_entry_or_None): aux is the layer's MoE
    load-balance loss, a float32 zero for other layers. ``slot``: this
    layer's slice of a given cache, where an SSD layer's final state is
    written in place."""
    aux = torch.zeros((), device=x.device)
    if cfg.family == "ssm":
        if prefill:
            y, cache = blocks.ssd_fwd(
                p["ssd"], x, cfg, return_cache=True,
                state_out=None if slot is None else slot[1])
        else:
            y, cache = blocks.ssd_fwd(p["ssd"], x, cfg), None
        return x + y, aux, cache
    if cfg.family == "hybrid":
        if prefill:
            y, cache = blocks.hybrid_fwd(
                p["mix"], x, cfg, window=window, return_cache=True,
                state_out=None if slot is None else slot[1][1])
        else:
            y, cache = blocks.hybrid_fwd(p["mix"], x, cfg,
                                         window=window), None
        x = x + y
        return x + blocks.mlp_fwd(p["mlp"], x, cfg), aux, cache
    cache = None
    if cfg.mla:
        if prefill:
            y, cache = blocks.mla_fwd(p["attn"], x, cfg, return_cache=True)
        else:
            y = blocks.mla_fwd(p["attn"], x, cfg)
    elif prefill:
        y, cache = blocks.attn_fwd(p["attn"], x, cfg, window=window,
                                   prefix_len=prefix_len, return_cache=True)
    else:
        y = blocks.attn_fwd(p["attn"], x, cfg, window=window,
                            prefix_len=prefix_len)
    x = x + y
    if "moe" in p:
        y, aux = blocks.moe_fwd(p["moe"], x, cfg)
        return x + y, aux, cache
    return x + blocks.mlp_fwd(p["mlp"], x, cfg), aux, cache


def _apply_dense0(p, x, cfg: ArchConfig, *, prefill: bool):
    """DeepSeek's leading dense layer: MLA attention + a wide dense MLP.
    Returns (x, its (c, k_rope) cache entry or None)."""
    if prefill:
        y, cache = blocks.mla_fwd(p["attn"], x, cfg, return_cache=True)
    else:
        y, cache = blocks.mla_fwd(p["attn"], x, cfg), None
    x = x + y
    return x + blocks.mlp_fwd(p["mlp"], x, cfg), cache


# --------------------------------------------------------------------------
# Sequence forward (prefill)
# --------------------------------------------------------------------------

def _windows(cfg: ArchConfig, seq_hint: int) -> list:
    """Each layer's attention window (``registry.window_list``), or None
    for every layer of an arch without one -- no tensor is made (a dry
    run's fake tensors hold no values)."""
    return registry.window_list(cfg, seq_hint) \
        or [None] * registry.n_scanned_layers(cfg)


def forward(params, batch: dict, cfg: ArchConfig, *, prefill: bool = False,
            remat: str = "full", dtype=torch.bfloat16,
            cache: Optional[dict] = None):
    """Full-sequence forward over ``batch`` (``embed_inputs``: tokens
    (B, S) int64, and the frontend's frames or patches).

    Returns (logits (B, S, V), aux) when ``prefill=False``, aux the sum
    over layers of the MoE load-balance loss (0 without MoE), float32;
    (last_logits (B, 1, V), cache) when ``prefill=True``. The cache is
    ``{"layers": entries}`` stacked on L (``layer_cache_struct``): for the
    dense and GQA-MoE families (k, v), each (L, B, S, Hkv, hd); for MLA
    (c, k_rope), (L, B, S, kv_lora) and (L, B, S, rope), and beside it
    ``"dense0"``, the leading dense layer's (c, k_rope) unstacked; for the
    SSD family ((conv_x, conv_B, conv_C), ssm); for the hybrid family
    ((k, v), ((conv_x, conv_B, conv_C), ssm)). A new one, or, when
    ``cache`` (an ``init_cache`` of at least S slots) is given, that one
    written in place: the prompt's K/V or latents into its first S slots,
    or each layer's conv tail and final state (B5 writes the state
    straight into the layer's slice on the card). Each layer attends with
    its window (``registry.window_array`` at the sequence's length:
    hymba's sliding layers, and global ones whose window covers the
    sequence), and the vision arch's patches form a bidirectional
    prefix.

    ``remat`` (a key of ``REMAT_POLICIES``) wraps each layer of a
    training forward (``prefill=False``) when grad is enabled; prefill
    and no-grad calls keep nothing for a backward and ignore it.
    """
    params = _gathered_top(cast_tree(params, dtype))
    x, prefix_len = embed_inputs(params, batch, cfg, dtype)
    S = x.shape[1]
    L = registry.n_scanned_layers(cfg)
    layers = _layers(params["layers"], L)
    windows = _windows(cfg, S)
    if not prefill:
        def one(p_layer, x, window):
            return _apply_layer(gather_params(p_layer), x, cfg,
                                window=window, prefix_len=prefix_len,
                                prefill=False)[:2]

        dense0 = lambda p, x: _apply_dense0(  # noqa: E731
            gather_params(p), x, cfg, prefill=False)[0]
        if torch.is_grad_enabled():
            one, dense0 = _remat(one, remat), _remat(dense0, remat)
        if "dense0" in params:
            x = dense0(params["dense0"], x)
        aux = torch.zeros((), device=x.device)
        for p_layer, window in zip(layers, windows):
            x, a = one(p_layer, x, window)
            aux = aux + a
        return unembed(params, x, cfg), aux
    new = {}
    if "dense0" in params:
        x, entry = _apply_dense0(gather_params(params["dense0"]), x, cfg,
                                 prefill=True)
        if cache is None:
            new["dense0"] = entry
        else:
            _store(cache["dense0"], entry, S)
    entries = []
    for i, p_layer in enumerate(layers):
        slot = None if cache is None else _cache_slice(cache["layers"], i)
        x, _, entry = _apply_layer(gather_params(p_layer), x, cfg,
                                   window=windows[i],
                                   prefix_len=prefix_len, prefill=True,
                                   slot=slot)
        if cache is None:
            entries.append(entry)
        else:
            _store(slot, entry, S)
    last = unembed(params, x[:, -1:], cfg)
    if cache is None:
        cache = {"layers": _stack(entries), **new}
    return last, cache


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def loss_fn(params, batch: dict, cfg: ArchConfig, *, remat: str = "full",
            dtype=torch.bfloat16, aux_weight: float = 0.01,
            z_weight: float = 1e-4):
    """Next-token cross-entropy over ``batch["labels"]`` plus the z-loss
    (the square of each row's log-sum-exp) and the auxiliary loss, the
    logits in float32 (the vision arch's image positions carry no labels
    and are dropped). Returns ``(loss, {"loss", "ce", "aux", "z"})``."""
    logits, aux = forward(params, batch, cfg, prefill=False, remat=remat,
                          dtype=dtype)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        logits = logits[:, cfg.frontend_seq:]
    lse, ll = _lse_ll_mesh(logits, labels) if _vocab_sharded(logits) \
        else local_map(_lse_ll, (logits, labels),
                       *_row_placements(logits, labels))
    ce = (lse - ll).mean()
    z = (lse ** 2).mean()  # z-loss keeps logits bounded
    loss = ce + aux_weight * aux + z_weight * z
    metrics = {"loss": loss, "ce": ce, "aux": aux, "z": z}
    return loss, metrics


def _lse_ll(logits, labels):
    """Each row's float32 log-sum-exp and its label's logit."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return lse, ll


def _vocab_sharded(logits) -> bool:
    return is_dtensor(logits) and any(
        p.is_shard(logits.dim() - 1) for p in logits.placements)


def _lse_ll_mesh(logits, labels):
    """``_lse_ll`` with the vocab left sharded (as the rules shard
    ``"vocab"``): each device reduces its slice of the vocab -- the max,
    then the sum of exponentials below it, and the label's logit where it
    holds that label -- and the slices' results are combined (a max, then
    two sums). A gathered vocab would hold a (rows, V) float32 block per
    device."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = logits.device_mesh
    vdim = logits.dim() - 1
    v_axes = [i for i, p in enumerate(logits.placements) if p.is_shard(vdim)]
    rows = tuple(Replicate() if i in v_axes else p
                 for i, p in enumerate(logits.placements))
    part = tuple(Partial() if i in v_axes else p for i, p in enumerate(rows))
    top = tuple(Partial("max") if i in v_axes else p
                for i, p in enumerate(rows))
    n_v, rank = 1, 0
    for i in v_axes:
        n_v *= mesh.size(i)
        rank = rank * mesh.size(i) + mesh.get_local_rank(i)
    v_loc = logits.shape[-1] // n_v

    m = local_map(lambda lg: lg.float().amax(dim=-1), (logits,),
                  (logits.placements,), (top,)).redistribute(mesh, rows)
    m = m.detach()

    def sums(lg, lab, mx):
        lg = lg.float()
        s = torch.exp(lg - mx[..., None]).sum(dim=-1)
        j = lab.to(torch.int64) - rank * v_loc
        mine = (j >= 0) & (j < v_loc)
        ll = torch.gather(lg, -1, j.clamp(0, v_loc - 1)[..., None])[..., 0]
        return s, torch.where(mine, ll, 0.0)

    s, ll = local_map(sums, (logits, labels, m),
                      (logits.placements, rows, rows), (part, part))
    s, ll = s.redistribute(mesh, rows), ll.redistribute(mesh, rows)
    return m + torch.log(s), ll


def _row_placements(logits, labels):
    """``local_map`` placements for ``_lse_ll`` on a mesh: the labels' own
    (rows sharded as the batch), the logits' vocab gathered."""
    if not is_dtensor(logits):
        return (None, None), (None, None)
    pl = tuple(labels.placements)
    return (pl, pl), (pl, pl)


def _gathered_top(params: dict) -> dict:
    """The top-level leaves (embedding, head, final norm, frontend) of a
    parameter tree gathered over the FSDP axes for the step
    (``gather_params``); the layers' leaves are gathered layer by layer
    where they are used. A no-op off a mesh."""
    return {k: v if k in ("layers", "dense0") else gather_params(v)
            for k, v in params.items()}


def _store(slot, entry, S: int) -> None:
    """Write one layer's prefill ``entry`` into its cache ``slot`` (views
    of the stacked cache), by the JAX server's graft rule: an entry of the
    slot's shape (a conv tail, a state) whole, a KV entry into its first S
    slots. A state B5 already wrote in place is left as it is."""
    if isinstance(slot, tuple):
        for dst, src in zip(slot, entry):
            _store(dst, src, S)
    elif entry.data_ptr() == slot.data_ptr():
        return
    elif entry.shape == slot.shape:
        slot.copy_(entry)
    else:
        slot[:, :S] = entry.to(slot.dtype)


def _stack(entries: list):
    """Per-layer entries (nested tuples) stacked on a leading L axis."""
    if isinstance(entries[0], tuple):
        return tuple(_stack([e[k] for e in entries])
                     for k in range(len(entries[0])))
    return torch.stack(entries)


# --------------------------------------------------------------------------
# Decode (one token against the cache)
# --------------------------------------------------------------------------

def kv_cache_struct(cfg: ArchConfig, B: int, S: int, dtype):
    """Shapes and dtype of one layer's (k, v) cache entries."""
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    return (shape, dtype), (shape, dtype)


def ssd_cache_struct(cfg: ArchConfig, B: int, dtype):
    """Shapes and dtypes of one SSD layer's cache entries: the conv tails
    ((B, W-1, d_inner), (B, W-1, G*N) twice) in ``dtype`` and the state
    (B, nh, hd, N) in float32."""
    ss = cfg.ssm
    di = ss.d_inner(cfg.d_model)
    nh = ss.n_heads(cfg.d_model)
    GN = ss.n_groups * ss.d_state
    W = ss.conv_width
    conv = (((B, W - 1, di), dtype), ((B, W - 1, GN), dtype),
            ((B, W - 1, GN), dtype))
    ssm = ((B, nh, ss.head_dim, ss.d_state), torch.float32)
    return conv, ssm


def mla_cache_struct(cfg: ArchConfig, B: int, S: int, dtype):
    """Shapes and dtype of one MLA layer's latent cache entries: c (B, S,
    kv_lora) and k_rope (B, S, rope)."""
    m = cfg.mla
    return ((B, S, m.kv_lora_rank), dtype), ((B, S, m.rope_head_dim), dtype)


def layer_cache_struct(cfg: ArchConfig, B: int, S: int, dtype):
    """One layer's cache entries as nested tuples of (shape, dtype)."""
    if cfg.family == "ssm":
        return ssd_cache_struct(cfg, B, dtype)
    if cfg.family == "hybrid":
        return (kv_cache_struct(cfg, B, S, dtype),
                ssd_cache_struct(cfg, B, dtype))
    if cfg.mla:
        return mla_cache_struct(cfg, B, S, dtype)
    return kv_cache_struct(cfg, B, S, dtype)


def _zeros(struct, L: Optional[int], device):
    """Zeros of a cache struct, stacked on a leading L axis (None: not
    stacked)."""
    if not isinstance(struct[1], torch.dtype):
        return tuple(_zeros(s, L, device) for s in struct)
    shape, dt = struct
    lead = () if L is None else (L,)
    return torch.zeros((*lead, *shape), dtype=dt, device=device)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device="cuda") -> dict:
    """Zeroed ``{"layers": entries}`` stacked on L: (k, v), each
    (L, B, max_seq, Hkv, hd), for the attention families; (c, k_rope) for
    MLA (``mla_cache_struct``), with ``"dense0"``, the leading dense
    layer's (c, k_rope) unstacked, beside it; ((conv_x, conv_B, conv_C),
    ssm) for the SSD family (``ssd_cache_struct``; ``max_seq`` bounds no
    SSD shape); both, ((k, v), (conv, ssm)), for the hybrid family. On the
    card unless ``device`` says otherwise; raises when there is no
    card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to allocate "
                           "the cache on the CPU")
    L = registry.n_scanned_layers(cfg)
    c = {"layers": _zeros(layer_cache_struct(cfg, batch, max_seq, dtype),
                          L, device)}
    if cfg.moe and cfg.moe.first_dense_layers:
        c["dense0"] = _zeros(mla_cache_struct(cfg, batch, max_seq, dtype),
                             None, device)
    return c


def _decode_layer(p, x, cache, cache_len: int, cfg: ArchConfig, *, window,
                  prefix_len: int):
    if cfg.family == "ssm":
        conv, ssm = cache
        y, conv, ssm = blocks.ssd_decode(p["ssd"], x, conv, ssm, cfg)
        return x + y, (conv, ssm)
    if cfg.family == "hybrid":
        (k, v), (conv, ssm) = cache
        y, k, v, conv, ssm = blocks.hybrid_decode(
            p["mix"], x, k, v, conv, ssm, cache_len, cfg, window=window)
        x = x + y
        return x + blocks.mlp_fwd(p["mlp"], x, cfg), ((k, v), (conv, ssm))
    if cfg.mla:
        c, kr = cache
        y, c, kr = blocks.mla_decode(p["attn"], x, c, kr, cache_len, cfg)
        cache = (c, kr)
    else:
        k, v = cache
        y, k, v = blocks.attn_decode(p["attn"], x, k, v, cache_len, cfg,
                                     window=window, prefix_len=prefix_len)
        cache = (k, v)
    x = x + y
    if "moe" in p:
        return x + blocks.moe_fwd(p["moe"], x, cfg)[0], cache
    return x + blocks.mlp_fwd(p["mlp"], x, cfg), cache


def decode_step(params, cache: dict, batch: dict, cfg: ArchConfig, *,
                dtype=torch.bfloat16):
    """One decode step. batch: {"tokens": (B, 1) int64, "cache_len": int}.

    Returns (logits (B, 1, V), cache). The cache is updated in place —
    the new token's K/V or latents at slot ``cache_len`` (the leading
    dense layer's first, for deepseek), or each SSD layer's conv tail and
    state — and the returned cache is the same object. As in the
    JAX package, the vision arch's image prefix lives in cache slots
    ``[0, frontend_seq)`` and the token's embedding is scaled; each
    layer's window is ``registry.window_array`` at a sequence hint read
    off the cache's shapes (``_seq_hint``).
    """
    params = _gathered_top(cast_tree(params, dtype))
    cache_len = int(batch["cache_len"])
    prefix_len = cfg.frontend_seq if cfg.frontend == "vision" else 0
    x = _rows(params["embed"].to(dtype), batch["tokens"])
    if cfg.frontend == "vision":
        x = x * _text_scale(cfg, dtype, x.device)
    x = constrain(x, "batch", None, "embed")
    if "dense0" in cache:
        p0 = gather_params(params["dense0"])
        y, _, _ = blocks.mla_decode(p0["attn"], x, *cache["dense0"],
                                    cache_len, cfg)
        x = x + y
        x = x + blocks.mlp_fwd(p0["mlp"], x, cfg)
    L = registry.n_scanned_layers(cfg)
    windows = _windows(cfg, _seq_hint(cache))
    for i, p_layer in enumerate(_layers(params["layers"], L)):
        x, _ = _decode_layer(gather_params(p_layer), x,
                             _cache_slice(cache["layers"], i),
                             cache_len, cfg, window=windows[i],
                             prefix_len=prefix_len)
    return unembed(params, x, cfg), cache


def _seq_hint(cache: dict) -> int:
    """The JAX package's decode-time sequence hint: the largest dim 2 of a
    stacked cache leaf of rank >= 3 (a KV cache's slot count, beside an
    SSD state's head count and a conv tail's width)."""
    def leaves(tree):
        if isinstance(tree, tuple):
            for t in tree:
                yield from leaves(t)
        else:
            yield tree

    return max((leaf.shape[2] for leaf in leaves(cache["layers"])
                if leaf.dim() >= 3), default=0)


def prefill_step(params, batch: dict, cfg: ArchConfig, *,
                 dtype=torch.bfloat16, cache: Optional[dict] = None):
    """Prefill: build the KV / state cache for a prompt, return last
    logits (see ``forward`` for ``cache``)."""
    return forward(params, batch, cfg, prefill=True, dtype=dtype,
                   cache=cache)
