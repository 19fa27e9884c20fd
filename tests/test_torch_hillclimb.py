"""The JAX package's hill-climb toggles in the port, against the JAX
package, on the CPU.

* ``flash_attention_triangle`` (the triangle / window-blocked causal
  attention) against the reference's on ``tests/test_attention_equiv.py``'s
  cases (S 96, 128, 256; GQA 4/2 and 2/2; no window, 32, 64; q and kv
  chunks of 32), float32, to 2e-5;
* ``attention`` under both ``ATTENTION_VARIANT``s with a small
  ``chunk_threshold``, so that the chunked forms run: the reference's
  ``attention`` under the same toggle, to 2e-5, and the triangle taken
  exactly where the reference takes it (causal self-attention, a static
  window, no prefix);
* ``STATIC_WINDOW_SEGMENTS``: reduced hymba cut to 5 layers (global
  layers 0, 2 and 4; 1 and 3 slide over a window of 16) at 24 and 40
  positions, past the window: the forward, the prefill's logits and
  cache, and the loss's gradients against the reference's
  ``_segmented_stack`` (float32, ``tests/_torch_train_common.py``'s
  limits), and against the port's own uniform loop bit for bit.

The reference's toggles are module dicts; every test sets them and
restores them in ``try`` / ``finally``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_common as train_common  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.param import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402

ATOL = 2e-5          # float32 attention, both packages
LOGIT_ATOL = 1e-4    # float32 logits through 5 layers (test_torch_families)
HYMBA = dict(n_layers=5)


@contextlib.contextmanager
def reference_toggles(attention="baseline", segments=False):
    """The JAX package's toggles set, and restored after the block."""
    old = (JC.ATTENTION_VARIANT["impl"], JM.STATIC_WINDOW_SEGMENTS["enabled"])
    JC.ATTENTION_VARIANT["impl"] = attention
    JM.STATIC_WINDOW_SEGMENTS["enabled"] = segments
    try:
        yield
    finally:
        (JC.ATTENTION_VARIANT["impl"],
         JM.STATIC_WINDOW_SEGMENTS["enabled"]) = old


@contextlib.contextmanager
def both_toggles(attention="baseline", segments=False):
    with reference_toggles(attention, segments), \
            TM.hillclimb(attention, segments):
        yield


def _qkv(seed, B, Sq, Sk, H, Hkv, D=16):
    g = np.random.default_rng(seed)
    arrs = [g.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a)
                                            for a in arrs]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ------------------------------------------------- the triangle itself

@pytest.mark.parametrize("window", [None, 32, 64])
@pytest.mark.parametrize("heads", [(4, 2), (2, 2)])
@pytest.mark.parametrize("S", [96, 128, 256])
def test_triangle_matches_the_reference(S, heads, window):
    H, Hkv = heads
    (jq, jk, jv), (q, k, v) = _qkv(S + H, 1, S, S, H, Hkv)
    want = JC.flash_attention_triangle(jq, jk, jv, causal=True,
                                       window=window, q_chunk=32,
                                       kv_chunk=32)
    got = TC.flash_attention_triangle(q, k, v, causal=True, window=window,
                                      q_chunk=32, kv_chunk=32)
    _close(got, want)
    # and the port's own plain attention, as the reference's test holds it
    _close(got, TC.plain_attention(q, k, v, causal=True, window=window)
           .numpy())


def test_triangle_refuses_what_the_reference_refuses():
    q = torch.zeros(1, 32, 2, 16)
    with pytest.raises(AssertionError, match="causal self-attn"):
        TC.flash_attention_triangle(q, q, q, causal=False)
    with pytest.raises(AssertionError, match="causal self-attn"):
        TC.flash_attention_triangle(q, q[:, :16], q[:, :16])


def test_triangle_visits_only_the_live_blocks(monkeypatch):
    """A windowed q chunk's kv loop starts at ``lo(window) // kv_chunk``:
    with S 256, chunks of 32 and a window of 32, q chunk i reads blocks
    i - 1 and i (block 0 alone for chunk 0), 15 in all, where the
    baseline reads the whole 8 x 8 rectangle."""
    calls = []
    real = torch.einsum

    def count(eq, *ops):
        if eq == "bqhd,bkhd->bhqk":
            calls.append(1)
        return real(eq, *ops)
    monkeypatch.setattr(TC.torch, "einsum", count)
    q = torch.randn(1, 256, 2, 16)
    TC.flash_attention_triangle(q, q, q, window=32, q_chunk=32, kv_chunk=32)
    assert len(calls) == 15
    calls.clear()
    TC.flash_attention_jax(q, q, q, causal=True, window=32, q_chunk=32,
                           kv_chunk=32)
    assert len(calls) == 64


# ------------------------------------------- attention under the toggle

ATTN_CASES = {  # causal, window, prefix_len, Sq, Sk, q_offset
    "causal": (True, None, 0, 80, 80, 0),
    "window": (True, 24, 0, 80, 80, 0),
    "prefix": (True, None, 12, 80, 80, 0),
    "bidirectional": (False, None, 0, 80, 80, 0),
    "offset": (True, None, 0, 40, 80, 40),
    "offset-window": (True, 24, 0, 40, 80, 40),
}
TRIANGLE = {"causal", "window"}  # where the reference takes the triangle


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("variant", ["baseline", "triangle"])
def test_attention_under_the_variant_matches_the_reference(variant, case,
                                                           monkeypatch):
    causal, window, prefix, Sq, Sk, off = ATTN_CASES[case]
    (jq, jk, jv), (q, k, v) = _qkv(len(case) + Sq, 2, Sq, Sk, 4, 2)
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_offset=off,
              chunk_threshold=16, q_chunk=32, kv_chunk=32)
    taken = []
    real = TC.flash_attention_triangle
    monkeypatch.setattr(TC, "flash_attention_triangle",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    with both_toggles(variant):
        want = JC.attention(jq, jk, jv, **kw)
        got = TC.attention(q, k, v, **kw)
    _close(got, want)
    assert bool(taken) == (variant == "triangle" and case in TRIANGLE)


def test_the_variant_defaults_to_the_baseline():
    assert TC.ATTENTION_VARIANT == {"impl": "baseline"}
    assert TM.STATIC_WINDOW_SEGMENTS == {"enabled": False}


# ------------------------------------------------------- the segments

def _hymba():
    cfg = dataclasses.replace(get_arch("hymba-1.5b").reduced(), **HYMBA)
    rcfg = dataclasses.replace(ref_get_arch("hymba-1.5b").reduced(), **HYMBA)
    jp = ref_init_params(jreg.param_specs(rcfg), jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, rcfg, jp, tp


def _tokens(cfg, B, S, seed):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t).long()}


def test_segments_are_the_references():
    cfg, rcfg, _, _ = _hymba()
    assert TM.segments(cfg) == [(0, 1, None), (1, 2, 16), (2, 3, None),
                                (3, 4, 16), (4, 5, None)]
    full = get_arch("hymba-1.5b")
    runs = TM.segments(full)
    assert sum(hi - lo for lo, hi, _ in runs) == full.n_layers
    assert [lo for lo, hi, w in runs if w is None] \
        == jreg.global_layer_indices(ref_get_arch("hymba-1.5b"))


@pytest.mark.parametrize("attention", ["baseline", "triangle"])
@pytest.mark.parametrize("S", [24, 40])
def test_segmented_forward_matches_the_reference(S, attention):
    cfg, rcfg, jp, tp = _hymba()
    jb, tb = _tokens(cfg, 2, S, seed=S)
    with torch.no_grad():
        uniform, aux0 = TM.forward(tp, tb, cfg, dtype=torch.float32)
    with both_toggles(attention, segments=True):
        want, _ = JM.forward(jp, jb, rcfg, dtype=jnp.float32)
        with torch.no_grad():
            got, aux = TM.forward(tp, tb, cfg, dtype=torch.float32)
    _close(got, want, LOGIT_ATOL)
    assert torch.equal(got, uniform) and torch.equal(aux, aux0)


@pytest.mark.parametrize("S", [24, 40])
def test_segmented_prefill_matches_the_reference(S):
    """The last logits and the cache, in layer order: against the
    reference's segmented prefill, and bit for bit against the port's
    uniform loop (a new cache, and one written in place)."""
    cfg, rcfg, jp, tp = _hymba()
    jb, tb = _tokens(cfg, 2, S, seed=S + 1)
    base_last, base_cache = TM.prefill_step(tp, tb, cfg, dtype=torch.float32)
    with both_toggles(segments=True):
        want, jcache = JM.prefill_step(jp, jb, rcfg, dtype=jnp.float32)
        got, cache = TM.prefill_step(tp, tb, cfg, dtype=torch.float32)
        slots = TM.init_cache(cfg, 2, S + 4, torch.float32, device="cpu")
        got2, _ = TM.prefill_step(tp, tb, cfg, dtype=torch.float32,
                                  cache=slots)
    _close(got, want, LOGIT_ATOL)
    ours = jax.tree.leaves(cache["layers"])
    theirs = jax.tree.leaves(jcache["layers"])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _close(a, b, LOGIT_ATOL)
    assert torch.equal(got, base_last) and torch.equal(got2, base_last)
    for a, b, c in zip(ours, jax.tree.leaves(base_cache["layers"]),
                       jax.tree.leaves(slots["layers"])):
        assert torch.equal(a, b)
        assert torch.equal(c[:, :, :a.shape[2]] if c.shape != a.shape
                           else c, a)


def test_segmented_loss_gradients_match_the_reference():
    """``loss_fn``'s loss and every gradient leaf under the segments:
    against ``jax.value_and_grad`` of the reference's segmented loss at
    ``tests/_torch_train_common.py``'s limits (hymba's 24 positions past
    its window), and bit for bit against the port's uniform loop."""
    (rcfg, _, rst, rdata), (cfg, _, st, data) = train_common._setup(
        "hymba-1.5b")
    rb, tb = rdata.batch(0), data.batch(0)

    def port_grads():
        for _, p in tree_leaves(st.params):
            p.grad = None
        loss, m = TM.loss_fn(st.params, tb, cfg, dtype=torch.float32)
        loss.backward()
        return m, {path: p.grad.clone() for path, p in
                   tree_leaves(st.params)}
    m0, g0 = port_grads()
    with both_toggles(segments=True):
        (_, rm), rg = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(p, rb, rcfg, dtype=jnp.float32),
            has_aux=True))(rst.params)
        m, g = port_grads()
    for key in ("loss", "ce", "z"):
        assert float(m[key].detach()) == pytest.approx(float(rm[key]),
                                              rel=train_common.LOSS_RTOL)
        assert torch.equal(m[key], m0[key])
    ref = dict(tree_leaves(jax.tree.map(np.asarray, rg)))
    for path, grad in g.items():
        assert train_common._rel(ref[path], grad.numpy()) \
            <= train_common.LEAF_TOL, path
        assert torch.equal(grad, g0[path]), path
