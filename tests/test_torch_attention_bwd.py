"""Kernel B9's plain version and the training attention, on the CPU.

* ``flash_attention_bwd_plain`` (the plain version of B9, from B3's
  ``lse``) against ``jax.vjp`` of the JAX package's ``plain_attention``
  and, past a small ``chunk_threshold``, of ``flash_attention_jax``
  (through ``repro.models.common.attention``), causal GQA in float32, at
  sequence lengths on both sides of the threshold: each of dq, dk, dv
  within 1e-5 of its largest value, at least 1 (measured at most 9.0e-7);
* B3's ``lse`` (``flash_attention_plain(..., return_lse=True)`` and the
  wrapper on CPU tensors) against a float64 log-sum-exp of the scaled
  live scores, within 1e-5 (measured at most 4.7e-7);
* the same under B3's masks -- a sliding window, a prefix, both, and
  bidirectional attention -- at head dims 80 and 256, against ``jax.vjp``
  of ``plain_attention`` with the same mask;
* the port's CPU ``attention`` differentiates through the plain forms
  (as the reference's does), and ``KernelAttention`` (the card's
  autograd function: B3 forward, B9 backward) wired through the wrappers,
  which take their plain versions on CPU tensors, gives the same
  gradients;
* the bf16 gate's control (P rounded to 3 mantissa bits) is far from the
  float32 result, and P at 7 bits near it; with dS rounded as well (what
  the bf16 kernel multiplies), 7 bits read below ``chip_smoke.py``'s
  ``B9_REL_L2_BF16`` and 3 bits above it, and no rounding asked for gives
  the float32 formula's bits;
* multi-head latent attention's head dims -- v's narrower than q's: the
  reduced deepseek's (24, 16) and the published (192, 128) -- through the
  plain version, and ``KernelAttention`` on CPU tensors, against
  ``jax.vjp`` of the reference's attention (both sides through its
  dispatch, past the chunk threshold too); off the CPU ``_check_bwd``
  refuses every pair outside ``HEAD_DIM_PAIRS``, and ``attention``
  refuses them under grad before ``KernelAttention`` is reached;
* a hand kernel with grad enabled on an input that requires it raises
  (``_build.check_no_grad``), and the plain version of B9 takes CPU
  tensors only;
* a query offset (query row ``i`` at position ``q_offset + i``, Sq <= Sk:
  causal, with a window and a prefix, and bidirectional): B9's plain
  version and ``KernelAttention`` on CPU tensors against ``jax.vjp`` of
  the reference's ``attention`` with the same ``q_offset``, on both sides
  of the chunk threshold, and at the reduced MLA head dims.
"""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    HEAD_DIM_PAIRS, flash_attention_bwd, flash_attention_bwd_plain)
from repro_torch.models import common as tcommon  # noqa: E402

GRAD_TOL = 1e-5   # of each gradient's largest value (at least 1)
LSE_TOL = 1e-5
THRESHOLD = 32    # chunk_threshold at reduced size; q_chunk 32, kv_chunk 16
CASES = [(1, 1, 4, 2, 16), (2, 17, 4, 2, 16), (1, 32, 4, 1, 16),
         (2, 33, 4, 2, 16), (1, 70, 8, 2, 32), (1, 100, 4, 4, 16)]


def _inputs(B, S, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D))]


@jax.jit
def _vjp(q, k, v, do):
    def f(q, k, v):
        return jcommon.attention(q, k, v, causal=True,
                                 chunk_threshold=THRESHOLD, q_chunk=32,
                                 kv_chunk=16)
    return jax.vjp(f, q, k, v)[1](do)


@functools.lru_cache(maxsize=None)
def _ref_grads(shape):
    """jax.vjp of the reference's attention dispatch (plain up to the
    threshold, flash_attention_jax past it) on ``_inputs(*shape)``."""
    return [np.asarray(g) for g in _vjp(*map(jnp.asarray, _inputs(*shape)))]


def _close(got, want, tol=GRAD_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("shape", CASES, ids=str)
def test_plain_bwd_equals_jax_vjp(shape):
    q, k, v, do = _inputs(*shape)
    want = _ref_grads(shape)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(flash_attention_bwd(tq, tk, tv, o, lse, tdo), got):
        assert torch.equal(a, b)


# B3's masks at B9's new head dims: (B, S, H, Hkv, D), causal, window,
# prefix_len -- a window, a prefix, both, and bidirectional attention
MASK_CASES = [((1, 40, 4, 2, 80), True, 9, 0), ((2, 33, 2, 1, 256), True,
                                                 None, 7),
              ((1, 40, 4, 1, 80), True, 12, 5), ((1, 30, 2, 2, 256), False,
                                                 None, 0),
              ((2, 70, 4, 2, 16), True, 16, 20), ((1, 37, 2, 2, 80), False,
                                                  None, 0)]


@functools.partial(jax.jit, static_argnames=("causal", "window", "prefix"))
def _vjp_masked(q, k, v, do, *, causal, window, prefix):
    def f(q, k, v):
        return jcommon.plain_attention(q, k, v, causal=causal,
                                       window=window, prefix_len=prefix)
    return jax.vjp(f, q, k, v)[1](do)


@pytest.mark.parametrize("case", MASK_CASES, ids=str)
def test_plain_bwd_under_masks_equals_jax_vjp(case):
    """B9's plain version under a window, a prefix, both, and with no
    mask at all, at head dims 80 and 256 (and 16), against ``jax.vjp`` of
    the reference's ``plain_attention`` with the same mask: float32, each
    of dq, dk, dv within ``GRAD_TOL`` of its largest value; the wrapper on
    CPU tensors is the plain version."""
    shape, causal, window, prefix = case
    q, k, v, do = _inputs(*shape, seed=2)
    want = [np.asarray(g) for g in _vjp_masked(
        *map(jnp.asarray, (q, k, v, do)), causal=causal, window=window,
        prefix=prefix)]
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    for a, b in zip(flash_attention_bwd(tq, tk, tv, o, lse, tdo, **kw), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", MASK_CASES[:2], ids=str)
def test_kernel_function_under_masks_is_the_cpu_attention(case):
    """``KernelAttention`` with a mask, on CPU tensors (its wrappers'
    plain versions), gives the gradients of the CPU route's
    ``attention`` with that mask."""
    shape, causal, window, prefix = case
    q, k, v, do = _inputs(*shape, seed=6)
    grads = []
    for fn in (lambda q, k, v: tcommon.KernelAttention.apply(
                   q, k, v, None, causal, window, prefix),
               lambda q, k, v: tcommon.attention(
                   q, k, v, causal=causal, window=window,
                   prefix_len=prefix)):
        ts = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
        fn(*ts).backward(torch.tensor(do))
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        _close(a, b.numpy())


@pytest.mark.parametrize("shape", CASES, ids=str)
def test_lse_equals_the_reference(shape):
    B, S, H, Hkv, D = shape
    q, k, v, _ = _inputs(*shape, seed=1)
    kr = np.repeat(k, H // Hkv, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q * D ** -0.5, kr)
    live = np.arange(S)[None, :] <= np.arange(S)[:, None]
    s = np.where(live, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]
    tq, tk, tv = (torch.tensor(x) for x in (q, k, v))
    o, lse = flash_attention(tq, tk, tv, return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=LSE_TOL)
    assert torch.equal(o, flash_attention(tq, tk, tv))


@pytest.mark.parametrize("shape", CASES, ids=str)
def test_cpu_attention_autograd_and_kernel_function(shape):
    """The CPU route differentiates through the plain forms; the card's
    autograd function, run here on CPU tensors (its wrappers' plain
    versions), gives the same gradients."""
    q, k, v, do = _inputs(*shape)
    want = _ref_grads(shape)
    routes = {
        "attention": lambda q, k, v: tcommon.attention(
            q, k, v, causal=True, chunk_threshold=THRESHOLD, q_chunk=32,
            kv_chunk=16),
        "kernel_function": lambda q, k, v: tcommon.KernelAttention.apply(
            q, k, v, None, True, None, 0)}
    for name, fn in routes.items():
        tq, tk, tv = (torch.tensor(x).requires_grad_() for x in (q, k, v))
        fn(tq, tk, tv).backward(torch.tensor(do))
        for t, w in zip((tq, tk, tv), want):
            _close(t.grad, w)


def test_rounded_p_control_is_far_and_bf16_rounding_is_near():
    q, k, v, do = (torch.tensor(x) for x in _inputs(1, 96, 8, 2, 32, 3))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    exact = flash_attention_bwd_plain(q, k, v, o, lse, do)

    def rel(bits):
        got = flash_attention_bwd_plain(q, k, v, o, lse, do, p_bits=bits)
        return max(float((g - e).norm() / e.norm())
                   for g, e in zip(got, exact))

    assert rel(7) < 4e-3 < rel(3)


def _smoke_constant(name):
    """A constant of the repo root's ``chip_smoke.py`` (which imports
    nothing heavy at module level)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def _plain_float32_formula(q, k, v, o, lse, do, scale):
    """B9's plain version as the float32 formula with nothing rounded:
    what ``flash_attention_bwd_plain`` computed before it took
    ``ds_bits``."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(G, dim=2)) * scale
    live = torch.arange(Sk)[None, :] <= torch.arange(Sq)[:, None]
    s = torch.where(live, s, torch.full((), -1e30))
    p = torch.exp(s - lse[..., None])
    dof, of = do.float(), o.float()
    kr, vr = (t.float().repeat_interleave(G, dim=2) for t in (k, v))
    delta = (dof * of).sum(dim=-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vr) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Sk, Hkv, G, D).sum(dim=3)
    dv = dv.reshape(B, Sk, Hkv, G, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_rounded_p_and_ds_straddle_the_bf16_limit(dtype):
    """The bf16 gate of B9 on the card: P and dS rounded to bf16 (what
    the kernel multiplies) read below ``B9_REL_L2_BF16`` in each of dq,
    dk, dv, the control at 3 bits above it; with no rounding the plain
    version is the float32 formula bit for bit."""
    limit = _smoke_constant("B9_REL_L2_BF16")
    bits = _smoke_constant("B9_CONTROL_BITS")
    q, k, v, do = (torch.tensor(x).to(dtype)
                   for x in _inputs(1, 96, 8, 2, 32, 3))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    exact = flash_attention_bwd_plain(q, k, v, o, lse, do)
    for a, b in zip(exact, flash_attention_bwd_plain(
            q, k, v, o, lse, do, p_bits=None, ds_bits=None)):
        assert torch.equal(a, b)
    for a, b in zip(exact, _plain_float32_formula(q, k, v, o, lse, do,
                                                  32 ** -0.5)):
        assert torch.equal(a, b)

    def rel(n):
        got = flash_attention_bwd_plain(q, k, v, o, lse, do, p_bits=n,
                                        ds_bits=n)
        return [float((g.float() - e.float()).norm() / e.float().norm())
                for g, e in zip(got, exact)]

    assert max(rel(7)) < limit < min(rel(bits))
    # dS alone at 3 bits moves dq and dk, never dv
    ds_only = flash_attention_bwd_plain(q, k, v, o, lse, do, ds_bits=bits)
    assert torch.equal(ds_only[2], exact[2])
    assert not torch.equal(ds_only[0], exact[0])


def test_kernels_refuse_to_drop_a_gradient():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        _build.check_no_grad("k", (x,), "route")
    with torch.no_grad():
        _build.check_no_grad("k", (x,), "route")
    _build.check_no_grad("k", (x.detach(),), "route")


def test_plain_bwd_takes_cpu_tensors_only():
    q = torch.zeros((1, 4, 2, 16), device="meta")
    k = torch.zeros((1, 4, 1, 16), device="meta")
    lse = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="CPU tensors"):
        flash_attention_bwd_plain(q, k, k, q, lse, q)


def test_bwd_checks_shapes():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, k, q, torch.zeros((1, 4, 2)), q)
    with pytest.raises(ValueError, match="o and do"):
        flash_attention_bwd(q, k, k, q[:, :3], torch.zeros((1, 2, 4)), q)


# multi-head latent attention's head dims, (B, S, H, Hkv, D, Dv): the
# reduced deepseek's (24, 16) and the published (192, 128), one case of
# each past THRESHOLD (the reference's flash_attention_jax)
MLA_CASES = [(2, 21, 4, 4, 24, 16), (1, 40, 4, 4, 24, 16),
             (1, 18, 2, 2, 192, 128), (2, 33, 2, 1, 192, 128)]


def _mla_inputs(B, S, H, Hkv, D, Dv, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv), (B, S, H, Dv))]


@jax.jit
def _vjp_mla(q, k, v, do):
    def f(q, k, v):
        return jcommon.attention(q, k, v, causal=True,
                                 scale=q.shape[-1] ** -0.5,
                                 chunk_threshold=THRESHOLD, q_chunk=32,
                                 kv_chunk=16)
    return jax.vjp(f, q, k, v)[1](do)


@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_plain_bwd_at_mla_head_dims_equals_jax_vjp(case):
    """B9's plain version with v's head dim apart from q's: dq, dk of q's
    width and dv of v's, each within ``GRAD_TOL`` of its largest value of
    ``jax.vjp`` of the reference's attention; the wrapper on CPU tensors
    is the plain version."""
    q, k, v, do = _mla_inputs(*case)
    want = [np.asarray(g) for g in _vjp_mla(*map(jnp.asarray,
                                                 (q, k, v, do)))]
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True)
    assert o.shape == tdo.shape
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == torch.float32
        _close(g, w)
    for a, b in zip(flash_attention_bwd(tq, tk, tv, o, lse, tdo), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_kernel_function_at_mla_head_dims_is_the_reference(case):
    """``KernelAttention`` at MLA's head dims on CPU tensors (B3's and
    B9's plain versions), with MLA's scale, gives the gradients of
    ``jax.vjp`` of the reference's attention, as the CPU ``attention``
    does."""
    q, k, v, do = _mla_inputs(*case, seed=5)
    want = [np.asarray(g) for g in _vjp_mla(*map(jnp.asarray,
                                                 (q, k, v, do)))]
    scale = q.shape[-1] ** -0.5
    for fn in (lambda q, k, v: tcommon.KernelAttention.apply(
                   q, k, v, scale, True, None, 0),
               lambda q, k, v: tcommon.attention(
                   q, k, v, causal=True, scale=scale,
                   chunk_threshold=THRESHOLD, q_chunk=32, kv_chunk=16)):
        ts = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
        fn(*ts).backward(torch.tensor(do))
        for t, w in zip(ts, want):
            _close(t.grad, w)


@pytest.mark.parametrize("pair", [(24, 24), (192, 64), (128, 64), (96, 96),
                                  (256, 128)])
def test_bwd_refuses_head_dims_outside_its_pairs_off_the_cpu(pair):
    """Off the CPU (here the meta device) ``flash_attention_bwd`` refuses
    a (q/k, v) pair the kernels are not built for before anything runs;
    a pair of ``HEAD_DIM_PAIRS`` passes the check and reaches the plain
    version's own refusal of a tensor that is not on the CPU."""
    D, Dv = pair
    assert pair not in HEAD_DIM_PAIRS and (192, 128) in HEAD_DIM_PAIRS \
        and (24, 16) in HEAD_DIM_PAIRS

    def call(D, Dv):
        q = torch.zeros((1, 4, 2, D), device="meta")
        k = torch.zeros((1, 4, 2, D), device="meta")
        v = torch.zeros((1, 4, 2, Dv), device="meta")
        o = torch.zeros((1, 4, 2, Dv), device="meta")
        lse = torch.zeros((1, 2, 4), device="meta")
        flash_attention_bwd_plain(q, k, v, o, lse, o)

    with pytest.raises(ValueError, match="B9 is built for the pairs"):
        call(D, Dv)
    with pytest.raises(ValueError, match="CPU tensors"):
        call(192, 128)


# a query offset: (B, Sq, Sk, H, Hkv, D, Dv), q_offset, causal, window,
# prefix_len -- a chunk at the end of the keys (chunked prefill), one
# inside them, with a window and a prefix, bidirectional, past the chunk
# threshold (the reference's flash_attention_jax), and at MLA's (24, 16)
OFFSET_CASES = [((1, 16, 40, 4, 2, 16, 16), 24, True, None, 0),
                ((2, 9, 40, 4, 4, 16, 16), 20, True, 12, 0),
                ((1, 20, 64, 4, 1, 32, 32), 30, True, 16, 10),
                ((1, 30, 64, 2, 2, 16, 16), 34, False, None, 0),
                ((2, 40, 80, 4, 2, 16, 16), 40, True, None, 0),
                ((1, 33, 70, 4, 4, 24, 16), 37, True, None, 0),
                ((1, 20, 50, 4, 2, 16, 16), 1, True, None, 6)]


@functools.partial(jax.jit, static_argnames=("off", "causal", "window",
                                             "prefix", "scale"))
def _vjp_offset(q, k, v, do, *, off, causal, window, prefix, scale):
    def f(q, k, v):
        return jcommon.attention(q, k, v, causal=causal, window=window,
                                 q_offset=off, prefix_len=prefix,
                                 scale=scale, chunk_threshold=THRESHOLD,
                                 q_chunk=32, kv_chunk=16)
    return jax.vjp(f, q, k, v)[1](do)


@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_bwd_with_a_query_offset_equals_jax_vjp(case):
    """B9's plain version (from B3's plain ``lse``) at a query offset,
    ``KernelAttention`` on CPU tensors and the port's CPU ``attention``
    against ``jax.vjp`` of the reference's ``attention`` with the same
    offset and mask: each of dq, dk, dv within ``GRAD_TOL`` of its
    largest value; the wrapper on CPU tensors is the plain version."""
    (B, Sq, Sk, H, Hkv, D, Dv), off, causal, window, prefix = case
    rng = np.random.default_rng(Sq + Sk)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                    (B, Sq, H, Dv)))
    scale = D ** -0.5
    want = [np.asarray(g) for g in _vjp_offset(
        *map(jnp.asarray, (q, k, v, do)), off=off, causal=causal,
        window=window, prefix=prefix, scale=scale)]
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_offset=off)
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape
        _close(g, w)
    for a, b in zip(flash_attention_bwd(tq, tk, tv, o, lse, tdo, **kw), got):
        assert torch.equal(a, b)
    for fn in (lambda q, k, v: tcommon.KernelAttention.apply(
                   q, k, v, scale, causal, window, prefix, off),
               lambda q, k, v: tcommon.attention(
                   q, k, v, scale=scale, chunk_threshold=THRESHOLD,
                   q_chunk=32, kv_chunk=16, **kw)):
        ts = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
        fn(*ts).backward(tdo)
        for t, w in zip(ts, want):
            _close(t.grad, w)
