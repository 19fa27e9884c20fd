"""The backward of GQA attention under B3's masks — CUDA kernel B9.

Replaces no Pallas kernel: the JAX package trains through ``jax.vjp`` of
its attention (``src/repro/models/common.py:281-300``, autodiff of
``plain_attention`` / ``flash_attention_jax``). On the card the port's
forward is kernel B3, which keeps no probabilities; B9 takes what B3
leaves — q, k, v, the output o and its row log-sum-exp ``lse`` — and the
output's gradient do, and returns dq, dk, dv. The kernels, their bound and
the reasons for their design are in ``csrc/attention_bwd.cu``; in short:
bound by operations at the training shape; four kernels a call (a rowsum
pre-pass, dK/dV per key tile and query head into a float32 workspace, the
group's sum in head order, dQ per query tile) -- three on the bf16 route
for a group of one head, whose dK/dV kernel writes dK and dV itself and
allocates no workspace (``needs_workspace``); every sum in a fixed order
and no float atomic, so a result is the same from run to run (the training
loop's bit-exact resume rests on it); B3's masks (causal order, a sliding
``window``, a bidirectional ``prefix_len``, or none: bidirectional
attention), with only the tiles that hold a live pair loaded -- the key
tiles of a query tile for dQ, as B3 walks them, and the query tiles of a
key tile for dK / dV -- so a windowed layer does O(window) work a row;
B3's head dims (``HEAD_DIM_PAIRS``): q / k and v of one width, or
multi-head latent attention's q / k 192 with v 128 (and the reduced
config's 24 with v 16, q and k zero-padded to 32 columns on the way in and
dq, dk cut back to 24 on the way out); B3's query offset (``q_offset``).
bf16 runs FlashAttention-2's backward on the tensor cores
(``mma.sync``, q / k / v / do tiles by TMA, P and dS in registers, rounded
to bf16 as the operands of their products — as B3 rounds P — with float32
sums: it reads as ``flash_attention_bwd_plain(..., p_bits=7, ds_bits=7)``);
float32 runs true float32 FMAs on the CUDA cores.

``flash_attention_bwd`` launches the kernels for CUDA tensors and
evaluates ``flash_attention_bwd_plain`` for CPU tensors; nothing else
selects between them, and a kernel that fails to build or launch raises.
``flash_attention_bwd.launches`` counts wrapper calls that launched (one
a call: the kernels of a call count once, on either route).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import costs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_GRID_YZ_MAX, DTYPES,
                                                 ROW_ALIGN, TILE, _check,
                                                 _check_mask, live_pairs,
                                                 pad_head_dim)
from repro_torch.kernels.ref import NEG_INF, attention_mask

#: the (q / k, v) head dims B9 takes, B3's: ``(d, d)`` and multi-head
#: latent attention's (192, 128) and (24, 16) (``PADDED_D``)
HEAD_DIM_PAIRS = tuple((d, d) for d in (16, 32, 64, 80, 128, 256)) + (
    (192, 128), (24, 16))


def _check_bwd(q, k, v, o, lse, do):
    """The shapes, types and devices of B9's inputs; off the CPU (where
    the kernels run) also its head dims, one of ``HEAD_DIM_PAIRS``: the
    plain version takes any."""
    B, Sq, H, D, Sk, Hkv, Dv = _check(q, k, v)
    if q.device.type != "cpu" and (D, Dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head dims (q/k {D}, v {Dv}): B9 is built for the "
                         f"pairs {HEAD_DIM_PAIRS}")
    want = (B, Sq, H, Dv)
    if o.shape != want or do.shape != want:
        raise ValueError(f"o and do must be {want} (q's rows, v's head "
                         f"dim), got {tuple(o.shape)} {tuple(do.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must be {q.dtype}, got {o.dtype} "
                         f"{do.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse: want float32 ({B}, {H}, {Sq}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    devs = {t.device for t in (q, o, lse, do)}
    if len(devs) != 1:
        raise ValueError(f"q, k, v, o, lse, do on several devices: {devs}")
    return B, Sq, H, D, Sk, Hkv, Dv


def _probs(q, k, lse, *, causal: bool, scale: float, window=None,
           prefix_len: int = 0, q_offset: int = 0):
    """P = exp(scale q.k - lse) over the live keys of ``ref.attention_mask``,
    float32 (B, H, Sq, Sk), KV heads repeated to the query heads."""
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    live = attention_mask(q.shape[1], k.shape[1], causal=causal,
                          window=window, prefix_len=prefix_len,
                          q_offset=q_offset)
    s = torch.where(live, s, torch.full((), NEG_INF))
    return torch.exp(s - lse[..., None])


def _round_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties away from zero) at ``bits``
    stored mantissa bits."""
    drop = 23 - int(bits)
    return ((x.view(torch.int32) + (1 << (drop - 1)))
            & ~((1 << drop) - 1)).view(torch.float32)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None, window=None,
                              prefix_len: int = 0, q_offset: int = 0,
                              p_bits: Optional[int] = None,
                              ds_bits: Optional[int] = None):
    """Plain PyTorch version of B9 (CPU tensors only), in float32: P
    recomputed from ``lse`` over the live keys of B3's mask (``causal``,
    ``window``, ``prefix_len``, ``q_offset``), ``dS = P o (dP - D)`` with ``D =
    rowsum(do o o)``; a KV head's gradient is the sum over its group's
    query heads. Returns dq, dk, dv in q's dtype.

    ``p_bits``: round P to nearest at that many stored mantissa bits
    before it is used; ``ds_bits``: round dS likewise before it is used
    in dQ and dK. At 7 bits each is bf16's rounding, what the bf16
    kernel multiplies; at 3 a deliberately wrong rounding, the card's
    bf16 gate's control. None keeps float32."""
    B, Sq, H, D, Sk, Hkv, Dv = _check_bwd(q, k, v, o, lse, do)
    window, prefix_len, q_offset = _check_mask(Sq, Sk, window, prefix_len,
                                               q_offset)
    if q.device.type != "cpu":
        raise ValueError("flash_attention_bwd_plain takes CPU tensors; on "
                         "the card the kernel runs")
    scale = D ** -0.5 if scale is None else float(scale)
    G = H // Hkv
    p = _probs(q, k, lse, causal=causal, scale=scale, window=window,
               prefix_len=prefix_len, q_offset=q_offset)
    if p_bits is not None:
        p = _round_bits(p, p_bits)
    dof, of = do.float(), o.float()
    kr, vr = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    delta = (dof * of).sum(dim=-1).transpose(1, 2)        # (B, H, Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta[..., None])
    if ds_bits is not None:
        ds = _round_bits(ds, ds_bits)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Sk, Hkv, G, D).sum(dim=3)
    dv = dv.reshape(B, Sk, Hkv, G, Dv).sum(dim=3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def needs_workspace(dtype: torch.dtype, H: int, Hkv: int) -> bool:
    """Whether a B9 call sums its dK / dV partials through the float32
    workspaces: not on the bf16 route for a group of one head (``H ==
    Hkv``, multi-head latent attention's case), where the dK/dV kernel
    writes them in bf16 itself -- the one rounding the reduce would apply
    to its one partial, so the same bits."""
    return not (dtype == torch.bfloat16 and H == Hkv)


def _launch(lib, q, k, v, o, lse, do, delta, dk_ws, dv_ws, dq, dk, dv, *,
            causal: bool, scale: float, stream: int, window=None,
            prefix_len: int = 0, q_offset: int = 0) -> int:
    """One call of the C launcher; the arguments are already checked."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    return lib.flash_attention_bwd_launch(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(dk_ws), _ptr(dv_ws), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq, Sk, D, Dv, float(scale),
        int(causal), 0 if window is None else int(window), int(prefix_len),
        int(q_offset), stream)


def flash_attention_bwd_cost(q, k, v, *_, causal: bool = True, window=None,
                             prefix_len: int = 0, q_offset: int = 0,
                             **__) -> tuple[float, float]:
    """``(flops, bytes)`` of one B9 call: five products over the live
    pairs (``live_pairs``) -- q k^T, dS^T q and dS k at 2 D operations a
    pair, dO v^T and P^T dO at 2 Dv; q, k, v, o, do and lse read once, dq,
    dk, dv written once."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    live = live_pairs(Sq, Sk, causal=causal, window=window,
                      prefix_len=prefix_len, q_offset=q_offset)
    el = q.element_size()
    nbytes = el * (2 * B * Sq * H * (D + Dv) + 2 * B * Sk * Hkv * (D + Dv)) \
        + 4 * B * H * Sq
    return 2.0 * B * H * (3 * D + 2 * Dv) * live, float(nbytes)


@costs.counted("B9", flash_attention_bwd_cost)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None, window=None,
                        prefix_len: int = 0, q_offset: int = 0):
    """dq, dk, dv of ``o = flash_attention(q, k, v, causal=causal,
    scale=scale, window=window, prefix_len=prefix_len, q_offset=q_offset)``
    for the output
    gradient ``do``: q ``(B, Sq, H, D)``, k ``(B, Sk, Hkv, D)``, v ``(B,
    Sk, Hkv, Dv)``, o, do ``(B, Sq, H, Dv)`` of one dtype (float32 or
    bf16), ``(D, Dv)`` one of ``HEAD_DIM_PAIRS``; ``lse`` the forward's
    float32 ``(B, H, Sq)`` row log-sum-exp (``flash_attention(...,
    return_lse=True)``). Returns dq, dk, dv in q's dtype and q's, k's and
    v's shapes. The kernels read dense tensors: a view that is not
    contiguous is copied first (multi-head latent attention's v, a
    stride-256 view into the kv_b product, is copied: 2 B Sk H Dv bytes
    in bf16, 67 MB at deepseek-v2's training microbatch). A cost counter
    is told ``flash_attention_bwd_cost``; fake tensors launch nothing."""
    B, Sq, H, D, Sk, Hkv, Dv = _check_bwd(q, k, v, o, lse, do)
    window, prefix_len, q_offset = _check_mask(Sq, Sk, window, prefix_len,
                                               q_offset)
    scale = D ** -0.5 if scale is None else float(scale)
    if costs.is_fake(q):  # a dry run's: the outputs' shapes, no work
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale, window=window,
                                         prefix_len=prefix_len,
                                         q_offset=q_offset)
    if q.dtype not in DTYPES:
        raise ValueError(f"{q.dtype}: the kernels are built for {DTYPES}")
    if max(-(-max(Sq, Sk) // TILE), B) > _GRID_YZ_MAX:
        raise ValueError(f"Sq = {Sq}, Sk = {Sk}, B = {B}: the grids take at "
                         f"most {_GRID_YZ_MAX} tiles and batches")
    _build.check_no_grad("flash_attention_bwd", (q, k, v, o, do),
                  "it is the backward of models.common.attention on the card")
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    q, k = pad_head_dim(q), pad_head_dim(k)
    if q.dtype == torch.bfloat16:  # TMA's tensor maps: 16-byte aligned bases
        q, k, v, do = (t if t.data_ptr() % ROW_ALIGN == 0 else t.clone()
                       for t in (q, k, v, do))
    dev = q.device
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:  # a zero-size grid is an error
        return dq[..., :D], dk.zero_()[..., :D], dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    dk_ws = dv_ws = None
    if needs_workspace(q.dtype, H, Hkv):
        dk_ws = torch.empty((B, Sk, H, k.shape[3]), dtype=torch.float32,
                            device=dev)
        dv_ws = torch.empty((B, Sk, H, Dv), dtype=torch.float32, device=dev)
    lib = _build.load("attention_bwd")
    with torch.cuda.device(dev):
        err = _launch(lib, q, k, v, o, lse, do, delta, dk_ws, dv_ws, dq, dk,
                      dv, causal=causal, scale=scale, window=window,
                      prefix_len=prefix_len, q_offset=q_offset,
                      stream=torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    # at a padded head dim the padded columns' gradients are exact zeros
    return dq[..., :D], dk[..., :D], dv


flash_attention_bwd.launches = 0
