"""The port's attention against the JAX package's, on the CPU.

* the model's attention functions (``plain_attention``,
  ``flash_attention_jax``, ``attention``, ``decode_attention``) against
  the JAX functions of the same names, over causal / window / prefix /
  GQA, float32: the two differ only in the order of float32 sums, so
  1e-5 absolute on outputs of size ~1;
* the plain versions of kernels B3 and B4 against the Pallas kernels
  ``flash_attention_p`` / ``decode_attention_p`` run in interpret mode at
  the reference's own cases (``tests/test_kernels.py``: ``FA_CASES``,
  ``DA_CASES``) and tolerances (2e-5 float32, 2e-2 bf16);
* the plain versions of B3 and B4 with a sliding window and a prefix (the
  masks the Pallas kernels lack) against the JAX model path's
  ``plain_attention`` / ``decode_attention``, at 1e-5; the key tiles B3
  loads (``live_tiles``) and the slots B4's splits cover (``live_slots``)
  against the masks themselves;
* that the wrappers take the plain versions for CPU tensors and never
  reach a kernel;
* B3's plain version with a query offset (query row ``i`` at position
  ``q_offset + i``: causal attention with Sq < Sk, with a window and a
  prefix) against the JAX model path's ``plain_attention`` and
  ``flash_attention_jax`` with the same ``q_offset``, and at the reduced
  deepseek's MLA head dims (q / k 24, v 16); ``live_tiles`` with an
  offset against the mask and the kernel's tile walk.

Inputs are drawn with numpy from fixed seeds and handed to both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import decode_attention_p  # noqa: E402
from repro.kernels.flash_attention import flash_attention_p  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    SPLIT_LEN, decode_attention, decode_attention_plain, decode_splits,
    live_slots)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    TILE, flash_attention, flash_attention_plain, live_tiles)
from repro_torch.kernels.ref import attention_mask, decode_live  # noqa
from repro_torch.models import common as tc  # noqa: E402

# float32 on both sides; only the summation order differs
F32_ATOL = 1e-5
# the reference's kernel tolerances (tests/test_kernels.py)
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FA_CASES = [(1, 256, 2, 64, True), (2, 256, 4, 128, True),
            (1, 512, 2, 64, False), (2, 128, 1, 128, True)]
DA_CASES = [(4, 1024, 64, 256, 300), (2, 2048, 128, 512, 2047),
            (3, 512, 32, 128, 0),
            # live slots ending on and next to the port's split boundaries
            (2, 512, 128, 128, 127), (2, 512, 64, 128, 128),
            (2, 512, 64, 256, 255)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(a, dtype="float32"):
    """The same numbers as a jax array and a torch CPU tensor."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


MASKS = [  # (causal, window, prefix)
    (True, None, 0), (False, None, 0), (True, 16, 0), (True, None, 8),
    (True, 48, 8), (False, 16, 0)]
HEADS = [(4, 2), (4, 4), (2, 1)]


def _qkv(seed, B, S, H, Hkv, D=16):
    return [_both(_normal(seed + i, B, S, h, D))
            for i, h in enumerate((H, Hkv, Hkv))]


@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"H{h[0]}kv{h[1]}")
@pytest.mark.parametrize("mask", MASKS, ids=str)
def test_plain_and_flash_attention_match_jax(mask, heads):
    causal, window, prefix = mask
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 2, 96, *heads)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    _close(tc.plain_attention(tq, tk, tv, **kw),
           jc.plain_attention(jq, jk, jv, **kw), F32_ATOL)
    ch = dict(q_chunk=32, kv_chunk=48)  # ragged: 96 keys in chunks of 48
    _close(tc.flash_attention_jax(tq, tk, tv, **kw, **ch),
           jc.flash_attention_jax(jq, jk, jv, **kw, **ch), F32_ATOL)


@pytest.mark.parametrize("S,threshold", [(40, 2048), (72, 32)],
                         ids=["plain-route", "flash-route"])
@pytest.mark.parametrize("mask", MASKS[:4], ids=str)
def test_attention_dispatch_matches_jax(mask, S, threshold):
    causal, window, prefix = mask
    (jq, tq), (jk, tk), (jv, tv) = _qkv(11, 1, S, 4, 2)
    kw = dict(causal=causal, window=window, prefix_len=prefix,
              chunk_threshold=threshold, q_chunk=32, kv_chunk=32)
    _close(tc.attention(tq, tk, tv, **kw), jc.attention(jq, jk, jv, **kw),
           F32_ATOL)


@pytest.mark.parametrize("window,prefix", [(None, 0), (8, 0), (8, 4)])
@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"H{h[0]}kv{h[1]}")
@pytest.mark.parametrize("cache_len", [0, 17, 39])
def test_decode_attention_matches_jax(cache_len, heads, window, prefix):
    H, Hkv = heads
    (jq, tq) = _both(_normal(5, 2, 1, H, 16))
    (jk, tk) = _both(_normal(6, 2, 40, Hkv, 16))
    (jv, tv) = _both(_normal(7, 2, 40, Hkv, 16))
    kw = dict(window=window, prefix_len=prefix)
    _close(tc.decode_attention(tq, tk, tv, cache_len, **kw),
           jc.decode_attention(jq, jk, jv, jnp.int32(cache_len), **kw),
           F32_ATOL)


def test_decode_attention_bf16_cache_matches_jax():
    """bf16 caches: q rounded to bf16 after scaling and p rounded before
    P.V on both sides; the float32 outputs then differ by the order of
    float32 sums of the same bf16 products."""
    (jq, tq) = _both(_normal(8, 2, 1, 8, 32), "bfloat16")
    (jk, tk) = _both(_normal(9, 2, 64, 2, 32), "bfloat16")
    (jv, tv) = _both(_normal(10, 2, 64, 2, 32), "bfloat16")
    got = tc.decode_attention(tq, tk, tv, 50)
    want = jc.decode_attention(jq, jk, jv, jnp.int32(50))
    assert got.dtype == torch.bfloat16
    # outputs are rounded to bf16: one rounding step of values near 1
    _close(got, want, atol=2 ** -7)


# ----------------------------------------------- plain versions vs Pallas

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_ops_flash_attention_matches_the_references(case, dtype):
    """``ops.flash_attention`` (the reference's public name and
    signature, equal head counts) against the reference's
    ``ops.flash_attention`` in interpret mode, as
    ``tests/test_kernels.py`` calls it, at its tolerances."""
    B, S, H, D, causal = case
    (jq, tq), (jk, tk), (jv, tv) = [
        _both(_normal(40 + i, B, S, H, D), dtype) for i in range(3)]
    want = jops.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, bq=64, bk=64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = KERNEL_TOL[dtype]
    _close(got, np.asarray(want.astype(jnp.float32)), atol=tol * 3,
           rtol=tol)
    with pytest.raises(ValueError, match="block sizes"):
        ops.flash_attention(tq, tk, tv, bq=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_plain_matches_pallas_kernel(case, dtype):
    B, S, H, D, causal = case
    (jq, tq), (jk, tk), (jv, tv) = [
        _both(_normal(20 + i, B, S, H, D), dtype) for i in range(3)]
    fold = lambda t: t.transpose(0, 2, 1, 3).reshape(B * H, S, D)
    want = flash_attention_p(fold(jq), fold(jk), fold(jv), causal=causal,
                             interpret=True)
    want = np.asarray(want.astype(jnp.float32)).reshape(
        B, H, S, D).transpose(0, 2, 1, 3)
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = KERNEL_TOL[dtype]
    _close(got, want, atol=tol * 3, rtol=tol)


@pytest.mark.parametrize("case", DA_CASES, ids=str)
def test_decode_plain_matches_pallas_kernel(case):
    BH, S, D, bk, clen = case
    (jq, tq) = _both(_normal(30, BH, D))
    (jk, tk) = _both(_normal(31, BH, S, D))
    (jv, tv) = _both(_normal(32, BH, S, D))
    want = decode_attention_p(jq, jk, jv, jnp.int32(clen), bk=bk,
                              interpret=True)
    # the port's layout: BH batch rows of one head each
    got = decode_attention_plain(tq[:, None, None, :], tk[:, :, None, :],
                                 tv[:, :, None, :], clen)
    _close(got[:, 0, 0], want, atol=KERNEL_TOL["float32"])


@pytest.mark.parametrize("cache_len", sorted({0, 1, SPLIT_LEN - 1, SPLIT_LEN,
                                              SPLIT_LEN + 1, 2079}))
def test_decode_splits_cover_the_live_slots_exactly(cache_len):
    """B4's schedule: the splits tile ``[0, cache_len]`` exactly --
    disjoint, none empty, none past the last live slot -- and depend on
    the slot count alone."""
    n_live = cache_len + 1
    n_split, length = decode_splits(n_live)
    assert length == SPLIT_LEN
    spans = [range(s * length, min((s + 1) * length, n_live))
             for s in range(n_split)]
    assert all(len(r) > 0 for r in spans)
    assert [i for r in spans for i in r] == list(range(n_live))
    assert decode_splits(n_live) == (n_split, length)


def test_decode_splits_refuse_an_empty_cache():
    with pytest.raises(ValueError):
        decode_splits(0)


def test_gqa_head_map_is_h_over_groups():
    """Query head h reads KV head h // (H // Hkv) (the jnp.repeat order),
    not h % Hkv: each head alone against its own KV head."""
    q = torch.from_numpy(_normal(40, 1, 24, 8, 16))
    k = torch.from_numpy(_normal(41, 1, 24, 2, 16))
    v = torch.from_numpy(_normal(42, 1, 24, 2, 16))
    got = flash_attention_plain(q, k, v)
    for h in range(8):
        one = flash_attention_plain(q[:, :, h:h + 1], k[:, :, h // 4:h // 4 + 1],
                                    v[:, :, h // 4:h // 4 + 1])
        torch.testing.assert_close(got[:, :, h:h + 1], one, atol=1e-6,
                                   rtol=0)
    clen = 20
    got = decode_attention_plain(q[:, :1], k, v, clen)
    model = tc.decode_attention(q[:, :1], k, v, clen)
    torch.testing.assert_close(got, model, atol=F32_ATOL, rtol=0)


# ----------------------------------------------------- the CPU route only

def test_cpu_tensors_take_the_plain_versions():
    q = torch.from_numpy(_normal(50, 2, 33, 4, 16))
    k = torch.from_numpy(_normal(51, 2, 33, 2, 16))
    launches = (flash_attention.launches, decode_attention.launches)
    lib = dict(_build._LIBS)
    assert torch.equal(flash_attention(q, k, k), flash_attention_plain(q, k, k))
    assert torch.equal(ops.flash_attention(q, k, k),
                       flash_attention_plain(q, k, k))
    assert torch.equal(decode_attention(q[:, :1], k, k, 32),
                       decode_attention_plain(q[:, :1], k, k, 32))
    assert torch.equal(ops.decode_attention(q[:, :1], k, k, 5),
                       decode_attention_plain(q[:, :1], k, k, 5))
    assert (flash_attention.launches, decode_attention.launches) == launches
    assert _build._LIBS == lib  # nothing was built or loaded


@pytest.mark.parametrize("bad", ["heads", "dtype", "cache_len", "tiles"])
def test_wrappers_reject_bad_arguments(bad):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        if bad == "heads":
            flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
        elif bad == "dtype":
            flash_attention(q, k.double(), k.double())
        elif bad == "cache_len":
            decode_attention(q[:, :1], k, k, 8)
        else:
            flash_attention(q, k, k, tiles_loaded=torch.zeros(
                1, 4, 1, dtype=torch.int32))


def test_model_attention_on_the_card_refuses_other_masks(monkeypatch):
    """The CUDA route takes every mask of the reference's ``attention``
    to B3 -- a query offset and causal attention with Sq != Sk among them
    (the refusals of earlier slices) -- with no plain fallback, a window
    that covers every query's position dropped as no window; under grad
    every mask reaches ``KernelAttention`` (B3 forward, B9 backward) with
    that mask and offset; what it still refuses is a (q/k, v) head-dim
    pair B9 is not built for, under grad. (Checked on the dispatch alone:
    the meta device stands in for the card so no kernel runs.)"""
    q = torch.zeros(1, 8, 4, 16, device="meta")
    k = torch.zeros(1, 8, 2, 16, device="meta")

    class Cuda:  # the device test the dispatch makes
        type = "cuda"

    class Q(torch.Tensor):
        @property
        def device(self):
            return Cuda()

    qc = q.as_subclass(Q)
    calls = []
    monkeypatch.setattr(tc, "flash_attention_kernel",
                        lambda q, k, v, **kw: calls.append(kw) or "B3")
    for kw, want in (
            (dict(causal=True, q_offset=3), dict(q_offset=3, window=None)),
            (dict(causal=False, q_offset=1), dict(q_offset=1, window=None)),
            (dict(causal=True, q_offset=3, window=4),
             dict(q_offset=3, window=4)),
            (dict(causal=True, q_offset=3, window=11),  # covers 3 + 8 rows
             dict(q_offset=3, window=None))):
        assert tc.attention(qc, k, k, **kw) == "B3"
        got = calls.pop()
        assert {key: got[key] for key in want} == want
    assert tc.attention(qc[:, :5], k, k, causal=True) == "B3"
    assert calls.pop()["q_offset"] == 0
    qg = q.clone().requires_grad_().as_subclass(Q)
    seen = []
    monkeypatch.setattr(tc.KernelAttention, "apply",
                        lambda *args: seen.append(args[3:]) or "B9")
    for kw, mask in ((dict(causal=True, window=4), (None, True, 4, 0, 0)),
                     (dict(causal=False), (None, False, None, 0, 0)),
                     (dict(causal=True, prefix_len=4),
                      (None, True, None, 4, 0)),
                     (dict(causal=True, window=8), (None, True, None, 0, 0)),
                     (dict(causal=True, q_offset=2, window=5),
                      (None, True, 5, 0, 2))):
        assert tc.attention(qg, k, k, **kw) == "B9"
        assert seen.pop() == mask
    qw = torch.zeros(1, 8, 4, 96, device="meta").requires_grad_() \
        .as_subclass(Q)
    with pytest.raises(NotImplementedError, match="head dims"):
        tc.attention(qw, qw[:, :, :2], qw[:, :, :2], causal=True)


def _wide(dtype, offset, D=64, extra=16):
    """q (2, 9, 4, D) sliced at ``offset`` out of a (2, 9, 4, D + extra)
    tensor: its head stride is D + extra, not D."""
    g = np.random.default_rng(offset)
    t = torch.tensor(g.standard_normal((2, 9, 4, D + extra)),
                     dtype=torch.float32).to(dtype)
    return t[..., offset:offset + D]


@pytest.mark.parametrize("offset,extra,aligned", [
    (0, 0, True), (8, 16, True), (3, 16, False), (0, 4, False),
    (8, 12, False), (8, 8, True)])
def test_bf16_rows_aligned_and_for_kernel(offset, extra, aligned):
    """B3's bf16 kernel reads through TMA tensor maps (16-byte aligned
    bases and strides): a view whose rows start off a 16-byte boundary is
    copied, an aligned one is taken in place; either way the values are
    q's."""
    from repro_torch.kernels.flash_attention import for_kernel, rows_aligned
    q = _wide(torch.bfloat16, offset, extra=extra)
    assert rows_aligned(q) == aligned
    got = for_kernel(q)
    assert rows_aligned(got) and torch.equal(got, q)
    assert (got.data_ptr() == q.data_ptr()) == aligned


def test_for_kernel_float32_needs_only_a_contiguous_head_dim():
    from repro_torch.kernels.flash_attention import for_kernel, rows_aligned
    q = _wide(torch.float32, 3)
    assert not rows_aligned(q)  # 12 bytes off: fine for float32 loads
    assert for_kernel(q).data_ptr() == q.data_ptr()
    t = q.transpose(2, 3)  # head dim no longer contiguous: copied
    got = for_kernel(t)
    assert got.stride(-1) == 1 and torch.equal(got, t)


def test_rows_aligned_ignores_the_stride_of_length_one_dims():
    """A length-1 dim's odd stride addresses no row, so the view is taken
    in place; the launcher gets a dense stride for that dim, a multiple
    of 16 bytes as the bf16 kernel's tensor maps want for every dim."""
    from repro_torch.kernels.flash_attention import (ROW_ALIGN,
                                                     kernel_strides,
                                                     rows_aligned)
    buf = torch.zeros(2048, dtype=torch.bfloat16)
    for shape, strides, want in [
            ((2, 1, 4, 64), (512, 3, 64, 1), (512, 256, 64)),  # seq len 1
            ((1, 2, 4, 64), (5, 256, 64, 1), (512, 256, 64)),  # batch 1
            ((2, 3, 1, 64), (512, 128, 7, 1), (512, 128, 64)),  # 1 head
            ((1, 1, 1, 64), (3, 5, 7, 1), (64, 64, 64))]:
        odd = buf.as_strided(shape, strides)
        assert rows_aligned(odd)
        assert kernel_strides(odd) == want
        assert all(s * 2 % ROW_ALIGN == 0 for s in kernel_strides(odd))
    assert not rows_aligned(buf.as_strided((2, 2, 4, 64), (512, 3, 64, 1)))
    dense = buf[:1024].view(2, 2, 4, 64)
    assert kernel_strides(dense) == dense.stride()[:3]


# ------------------------------------ B3 / B4 masks beyond the Pallas ones

@pytest.mark.parametrize("heads", HEADS, ids=lambda h: f"H{h[0]}kv{h[1]}")
@pytest.mark.parametrize("mask", MASKS + [(True, 1, 0), (True, 100, 0),
                                          (False, None, 8), (True, 7, 13)],
                         ids=str)
def test_flash_plain_masks_match_jax(mask, heads):
    """B3's plain version with a window and a prefix against the JAX model
    path's ``plain_attention``: the kernel's masks are the reference's."""
    causal, window, prefix = mask
    (jq, tq), (jk, tk), (jv, tv) = _qkv(13, 2, 96, *heads)
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    got = flash_attention_plain(tq, tk, tv, **kw)
    _close(got, jc.plain_attention(jq, jk, jv, **kw), F32_ATOL)
    _close(flash_attention(tq, tk, tv, **kw), got, 0.0)  # the CPU route
    # D = 80 and 256, the head dims of hubert and paligemma
    for D in (80, 256):
        (jq, tq), (jk, tk), (jv, tv) = _qkv(14, 1, 40, *heads, D=D)
        _close(flash_attention_plain(tq, tk, tv, **kw),
               jc.plain_attention(jq, jk, jv, **kw), F32_ATOL)


@pytest.mark.parametrize("window,prefix", [(None, 0), (1, 0), (8, 0),
                                           (8, 4), (8, 30), (64, 0),
                                           (200, 5)])
@pytest.mark.parametrize("heads", [(8, 1), (4, 2)],
                         ids=lambda h: f"H{h[0]}kv{h[1]}")
@pytest.mark.parametrize("cache_len", [0, 7, 8, 39, 130])
def test_decode_plain_masks_match_jax(cache_len, heads, window, prefix):
    H, Hkv = heads
    (jq, tq) = _both(_normal(15, 2, 1, H, 16))
    (jk, tk) = _both(_normal(16, 2, 140, Hkv, 16))
    (jv, tv) = _both(_normal(17, 2, 140, Hkv, 16))
    kw = dict(window=window, prefix_len=prefix)
    got = decode_attention_plain(tq, tk, tv, cache_len, **kw)
    _close(got, jc.decode_attention(jq, jk, jv, jnp.int32(cache_len), **kw),
           F32_ATOL)
    _close(decode_attention(tq, tk, tv, cache_len, **kw), got, 0.0)


@pytest.mark.parametrize("window,prefix", [(None, 0), (1, 0), (16, 0),
                                           (16, 5), (16, 40), (63, 64),
                                           (100, 0), (200, 3)])
@pytest.mark.parametrize("cache_len", [0, 5, 63, 64, 65, 150, 2079])
def test_decode_splits_cover_the_windowed_live_slots(cache_len, window,
                                                     prefix):
    """B4's plan with a window (and a prefix beside it): the splits, in
    logical order, tile exactly the slots ``ref.decode_live`` keeps."""
    n_live, n_pre, first = live_slots(cache_len, window, prefix)
    n_split, length = decode_splits(n_live, first, n_pre)
    slot = lambda u: u if u < n_pre else first + u - n_pre  # noqa: E731
    covered = [slot(u) for s in range(n_split)
               for u in range(s * length, min((s + 1) * length, n_live))]
    live = decode_live(cache_len + 1, cache_len, window=window,
                       prefix_len=prefix)
    assert covered == torch.nonzero(live).flatten().tolist()
    assert all(s * length < n_live for s in range(n_split))


@pytest.mark.parametrize("Sq,Sk,causal,window,prefix", [
    (4096, 4096, True, 2048, 0), (300, 300, True, 40, 0),
    (300, 300, True, 100, 0), (300, 300, True, None, 70),
    (2304, 2304, True, None, 256), (500, 500, True, 64, 130),
    (1500, 1500, False, None, 0), (130, 200, False, None, 0),
    (130, 300, True, None, 0), (200, 200, False, 50, 0)])
def test_live_tiles_count_the_mask(Sq, Sk, causal, window, prefix):
    """``live_tiles`` against a brute-force count over the mask, and the
    tile list the kernel walks (``key_tiles`` in attention.cu: the prefix's
    tiles, then the band) -- the count a CUDA call reports in
    ``tiles_loaded``."""
    got = live_tiles(Sq, Sk, causal=causal, window=window,
                     prefix_len=prefix)
    ok = attention_mask(Sq, Sk, causal=causal, window=window,
                        prefix_len=prefix).numpy()
    want, walk = [], []
    for qt in range(-(-Sq // TILE)):
        rows = ok[qt * TILE:(qt + 1) * TILE]
        want.append(sum(bool(rows[:, kt * TILE:(kt + 1) * TILE].any())
                        for kt in range(-(-Sk // TILE))))
        q0, q_last = qt * TILE, min(qt * TILE + TILE, Sq) - 1
        hi = min(q_last + 1, Sk) if causal else Sk
        lo = max(0, q0 - window + 1) if window else 0
        pt = -(-min(prefix, Sk) // TILE)
        end = max(-(-hi // TILE), pt)
        lo_t = min(lo // TILE, end)
        walk.append(min(pt, lo_t) + end - lo_t)
    assert got.tolist() == want == walk
    if (Sq, window) == (4096, 2048):  # hymba's windowed layer at S = 4096
        assert int(got.sum()) == 1584


@pytest.mark.parametrize("bad", ["window0", "window_cross", "prefix",
                                 "decode_window0", "offset",
                                 "window_offset"])
def test_wrappers_reject_bad_masks(bad):
    """A window needs every query's position among the keys (``q_offset +
    Sq <= Sk``: past them a windowed row could have no live key); no
    negative window, prefix or offset."""
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        if bad == "window0":
            flash_attention(q, k, k, window=0)
        elif bad == "window_cross":
            flash_attention(q, torch.zeros(1, 7, 2, 16),
                            torch.zeros(1, 7, 2, 16), window=4)
        elif bad == "prefix":
            flash_attention(q, k, k, prefix_len=-1)
        elif bad == "offset":
            flash_attention(q, k, k, q_offset=-1)
        elif bad == "window_offset":
            flash_attention(q, torch.zeros(1, 9, 2, 16),
                            torch.zeros(1, 9, 2, 16), window=4, q_offset=2)
        else:
            decode_attention(q[:, :1], k, k, 5, window=0)


# a query offset: (Sq, Sk, q_offset, causal, window, prefix) -- a chunk of
# a prefill behind earlier keys, the chunk at the end of the keys or not,
# with a window and a prefix, bidirectional, and offsets past the tiles
OFFSET_CASES = [(16, 40, 24, True, None, 0), (9, 40, 31, True, 12, 0),
                (20, 64, 1, True, None, 8), (20, 64, 30, True, 16, 10),
                (30, 64, 34, False, None, 0), (12, 70, 58, True, 1, 0),
                (40, 40, 0, True, 10, 4), (33, 200, 100, True, None, 0)]


@pytest.mark.parametrize("heads", HEADS[:2], ids=lambda h: f"H{h[0]}kv{h[1]}")
@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_flash_plain_with_a_query_offset_matches_jax(case, heads):
    """B3's plain version (and the wrapper on CPU tensors) at a query
    offset against the JAX model path's ``plain_attention`` and its
    chunked ``flash_attention_jax`` with the same ``q_offset``, float32,
    and the port's own model functions."""
    Sq, Sk, off, causal, window, prefix = case
    H, Hkv = heads
    (jq, q), (jk, k), (jv, v) = (_both(_normal(7 + i + Sq, 2, n, h, 16))
                                 for i, (n, h) in enumerate(
                                     ((Sq, H), (Sk, Hkv), (Sk, Hkv))))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    got = flash_attention_plain(q, k, v, q_offset=off, **kw)
    _close(got, jc.plain_attention(jq, jk, jv, q_offset=off, **kw),
           F32_ATOL)
    _close(got, jc.flash_attention_jax(jq, jk, jv, q_offset=off,
                                       q_chunk=8, kv_chunk=16, **kw),
           F32_ATOL)
    assert torch.equal(flash_attention(q, k, v, q_offset=off, **kw), got)
    _close(tc.attention(q, k, v, q_offset=off, chunk_threshold=16,
                        q_chunk=8, kv_chunk=16, **kw).detach(), got.numpy(),
           F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 21, 70])
def test_flash_plain_at_the_reduced_mla_head_dims_matches_jax(S, causal):
    """B3's plain version at q / k 24 and v 16 (the reduced deepseek's
    multi-head latent attention; the kernel pads q and k to 32 columns)
    against the reference's ``plain_attention`` with MLA's scale."""
    (jq, q), (jk, k) = (_both(_normal(S + i, 2, S, 4, 24)) for i in (0, 1))
    jv, v = _both(_normal(S + 2, 2, S, 4, 16))
    scale = 24 ** -0.5
    got, lse = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     return_lse=True)
    assert got.shape == (2, S, 4, 16) and lse.shape == (2, 4, S)
    _close(got, jc.plain_attention(jq, jk, jv, causal=causal, scale=scale),
           F32_ATOL)
    assert torch.equal(flash_attention(q, k, v, causal=causal), got)


@pytest.mark.parametrize("Sq,Sk,off,causal,window,prefix", [
    (1024, 2048, 1024, True, None, 0), (100, 1101, 1000, True, 300, 0),
    (77, 300, 1, True, None, 90), (65, 129, 64, True, 40, 0),
    (200, 300, 64, False, None, 0), (64, 4096, 4032, True, 2048, 0),
    (130, 130, 0, True, 40, 0), (33, 700, 600, True, 64, 100)])
def test_live_tiles_count_the_mask_with_an_offset(Sq, Sk, off, causal,
                                                  window, prefix):
    """``live_tiles`` at a query offset against a brute-force count over
    the mask and the tile walk of ``key_tiles`` in attention_mask.cuh with
    the offset added to the rows' positions."""
    got = live_tiles(Sq, Sk, causal=causal, window=window,
                     prefix_len=prefix, q_offset=off)
    ok = attention_mask(Sq, Sk, causal=causal, window=window,
                        prefix_len=prefix, q_offset=off).numpy()
    want, walk = [], []
    for qt in range(-(-Sq // TILE)):
        rows = ok[qt * TILE:(qt + 1) * TILE]
        want.append(sum(bool(rows[:, kt * TILE:(kt + 1) * TILE].any())
                        for kt in range(-(-Sk // TILE))))
        q0, q_last = qt * TILE, min(qt * TILE + TILE, Sq) - 1
        hi = min(q_last + off + 1, Sk) if causal else Sk
        lo = max(0, q0 + off - window + 1) if window else 0
        pt = -(-min(prefix, Sk) // TILE)
        end = max(-(-hi // TILE), pt)
        lo_t = min(lo // TILE, end)
        walk.append(min(pt, lo_t) + end - lo_t)
    assert got.tolist() == want == walk
