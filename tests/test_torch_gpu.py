"""The port's CUDA kernels on a card (marker ``gpu``).

These need an NVIDIA GPU and ``nvcc``; without a card they skip. Run
them on a machine that has one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at the sweep's and the
serving paths' full size.
"""
import importlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import isa as pp_isa  # noqa: E402
from repro_torch.core import opgen  # noqa: E402
from repro_torch.core import program_plane as pp  # noqa: E402
from repro_torch.core.policies import POLICIES, KnobGrid  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.sa_occupancy import (sa_occupancy,  # noqa: E402
                                              sa_occupancy_plain)
from repro_torch.kernels.segment_sum import (segment_sum,  # noqa: E402
                                             segment_sum_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa
from repro_torch.kernels.ssd_scan_bwd import (  # noqa: E402
    ssd_scan_bwd, ssd_scan_bwd_plain)

from _torch_programs import pack_programs, seeded_programs  # noqa: E402
from _torch_programs import program_arrays, row_knobs  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    # decided here, at run time: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 255, 257, 4099])
@pytest.mark.parametrize("wlc", [None, 0.0])
def test_sa_occupancy_kernel_equals_plain_bit_for_bit(card, n, wlc):
    rng = np.random.default_rng(n)
    dims = [torch.tensor(rng.integers(1, hi, n).astype(np.float64),
                         device=card) for hi in (5000, 600, 5000)]
    saws = torch.tensor([8.0, 32.0, 128.0, 256.0, 512.0],
                        dtype=torch.float64, device=card)
    before = sa_occupancy.launches
    for saw in (saws, 128.0):
        got = sa_occupancy(*dims, saw, wlc)
        want = sa_occupancy_plain(*dims, saw, wlc)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert sa_occupancy.launches == before + 2


@pytest.mark.parametrize("batch", [(), (6,), (90,)])
def test_segment_sum_kernel_equals_cpu_plain_bit_for_bit(card, batch):
    rng = np.random.default_rng(len(batch) + 40)
    ids = np.sort(rng.integers(3, 37, 5000)).astype(np.int64)
    ids = ids[ids % 5 != 0]  # empty segments: head, middle, tail
    data = rng.standard_normal(batch + ids.shape) \
        * 10.0 ** rng.integers(-8, 8, batch + ids.shape)
    d, i = torch.tensor(data, device=card), torch.tensor(ids, device=card)
    before = segment_sum.launches
    got = segment_sum(d, i, 40)
    assert segment_sum.launches == before + 1
    assert torch.equal(got, segment_sum(d, i, 40))       # run to run
    want = segment_sum_plain(d.cpu(), i.cpu(), 40)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(
        got.cpu().numpy().reshape(-1, 40)[0],
        np.bincount(ids, weights=data.reshape(-1, len(ids))[0],
                    minlength=40))


def _direct_or_staged_ids(case):
    """Segment lengths for K2 around its DIRECT_SPAN (256): a launch whose
    blocks' runs of 128 segments span at most that many elements on
    average reads device memory directly, a longer one is staged."""
    if case == "long chain, direct":  # mean run ~192: one 10 000-op chain
        lengths = np.ones(20_001, dtype=np.int64)
        lengths[7_000] = 10_000
        return lengths
    lengths = np.ones(128, dtype=np.int64)  # one block's run: mean = span
    lengths[5] = int(case.split()[-1]) - 127
    return lengths


@pytest.mark.parametrize("case", ["span 255", "span 256", "span 257",
                                  "span 258", "long chain, direct"])
def test_segment_sum_direct_and_staged_launches(card, case):
    """On both sides of the launcher's choice, and with a long chain read
    straight from device memory: np.bincount's bits."""
    lengths = _direct_or_staged_ids(case)
    num = lengths.shape[0]
    ids = np.repeat(np.arange(num), lengths)
    rng = np.random.default_rng(num)
    data = rng.uniform(1e-9, 1e3, (3, ids.shape[0]))
    d, i = torch.tensor(data, device=card), torch.tensor(ids, device=card)
    got = segment_sum(d, i, num)
    assert torch.equal(got.cpu(), segment_sum_plain(d.cpu(), i.cpu(), num))
    for b in range(3):
        assert np.array_equal(got[b].cpu().numpy(),
                              np.bincount(ids, weights=data[b],
                                          minlength=num))


def _sweep_id_sets(card):
    """K2's id vectors at the sweep's shapes (NPU-D, the paper suite)
    and a row longer than the kernel's largest staging window."""
    from repro_torch.core.hw import get_npu
    from repro_torch.core.policies import _host_columns
    from repro_torch.kernels.segment_sum import MAX_SUBS, SUB
    st = opgen.stack_traces(opgen.paper_suite())
    host, _ = _host_columns(st, get_npu("NPU-D"))
    seg = host["op"]["seg_ids"]
    gap = host["gap_seg"]["hbm"]
    chunk = host["op"]["chunk_hbm"]
    long_row = np.repeat(np.arange(3), (MAX_SUBS * SUB * 2 + 1, 5, 999))
    return {"ops->workloads, per triple": (seg, st.n_segments, 72),
            "gaps->workloads, per triple": (gap, st.n_segments, 72),
            "ops->gap chunks, per width": (chunk, gap.shape[0], 5),
            "ops->workloads, per width": (seg, st.n_segments, 5),
            "long rows": (long_row, 3, 4)}


@pytest.mark.parametrize("shape", [
    "ops->workloads, per triple", "gaps->workloads, per triple",
    "ops->gap chunks, per width", "ops->workloads, per width",
    "long rows"])
def test_segment_sum_kernel_at_the_sweep_shapes(card, shape):
    ids, num, batch = _sweep_id_sets(card)[shape]
    ids = np.asarray(ids, dtype=np.int64)
    rng = np.random.default_rng(len(shape))
    data = rng.uniform(1e-9, 1e3, (batch, ids.shape[0]))
    d, i = torch.tensor(data, device=card), torch.tensor(ids, device=card)
    got = segment_sum(d, i, num)
    assert torch.equal(got, segment_sum(d, i, num))       # run to run
    assert torch.equal(got.cpu(), segment_sum_plain(d.cpu(), i.cpu(), num))
    keep = ids < num
    for b in (0, batch - 1):
        assert np.array_equal(
            got[b].cpu().numpy(),
            np.bincount(ids[keep], weights=data[b][keep], minlength=num))


def test_sweep_on_the_card_matches_the_cpu(card):
    sweep = importlib.import_module("repro_torch.core.sweep").sweep
    grid = KnobGrid(delay_scale=(0.5, 2.0), sa_width=(None, 64),
                    window_scale=(0.5, 1.0)).product()
    wls = opgen.paper_suite()[6:14]
    k1, k2 = sa_occupancy.launches, segment_sum.launches
    on_card = sweep(wls, ("NPU-A", "NPU-E"), POLICIES, grid)  # device=None
    assert sa_occupancy.launches > k1 and segment_sum.launches > k2
    on_cpu = sweep(wls, ("NPU-A", "NPU-E"), POLICIES, grid, device="cpu")
    assert len(on_card) == len(on_cpu)
    for a, b in zip(on_cpu, on_card):
        for k, va in a.items():
            if isinstance(va, float):
                assert abs(va - b[k]) <= 1e-9 * max(1e-30, abs(va),
                                                    abs(b[k])), k
            else:
                assert va == b[k], k


# B3/B4 against their plain versions: float32 differs only in the order
# of the float32 sums (~1e-6 seen); bf16 outputs are rounded to bf16, so
# one rounding step of a value near 1 (2**-8) is allowed, as in
# tests/test_kernels.py
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(card, dtype, seed, *shapes):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*s, generator=g).to(card, dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,Hkv,D,causal", [
    (1, 2, 1, 128, True), (17, 16, 2, 128, True), (130, 4, 4, 64, True),
    (257, 8, 1, 16, True), (200, 4, 2, 32, False)])
def test_flash_attention_kernel_matches_plain(card, dtype, S, H, Hkv, D,
                                              causal):
    q, k, v = _attn_inputs(card, dtype, S, (2, S, H, D), (2, S, Hkv, D),
                           (2, S, Hkv, D))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_flash_attention_skips_tiles_past_the_diagonal(card):
    B, S, H = 1, 64 * 5, 2
    q, k, v = _attn_inputs(card, torch.bfloat16, 1, (B, S, H, 64),
                           (B, S, 1, 64), (B, S, 1, 64))
    tiles = torch.zeros((B, H, 5), dtype=torch.int32, device=card)
    flash_attention(q, k, v, tiles_loaded=tiles)
    assert tiles.cpu().tolist() == [[[1, 2, 3, 4, 5]] * H]


def _b3_check(card, q, k, v, causal):
    """B3 bf16 against its plain version (2e-2), one launch, and for
    causal self-attention the key tiles each query tile loaded: tile t
    loads tiles 0..t (the diagonal's) and no more."""
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    n_qt = -(-Sq // 64)
    tiles = torch.zeros((B, H, n_qt), dtype=torch.int32, device=card)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, tiles_loaded=tiles)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    n_k = -(-Sk // 64)
    want_tiles = [min(t + 1, n_k) if causal else n_k for t in range(n_qt)]
    assert (tiles == torch.tensor(want_tiles, dtype=torch.int32,
                                  device=card)).all()


@pytest.mark.parametrize("S", [1, 17, 63, 64, 65, 130, 2049])
@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_attention_bf16_tensor_cores(card, D, groups, S):
    Hkv = 2
    q, k, v = _attn_inputs(card, torch.bfloat16, S + D + groups,
                           (2, S, Hkv * groups, D), (2, S, Hkv, D),
                           (2, S, Hkv, D))
    _b3_check(card, q, k, v, causal=True)


@pytest.mark.parametrize("Sq,Sk", [(70, 150), (150, 70), (1, 300),
                                   (2049, 65), (64, 1)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_flash_attention_bf16_ragged_lengths(card, D, causal, Sq, Sk):
    q, k, v = _attn_inputs(card, torch.bfloat16, Sq + Sk, (2, Sq, 8, D),
                           (2, Sk, 2, D), (2, Sk, 2, D))
    _b3_check(card, q, k, v, causal=causal)


@pytest.mark.parametrize("offset", [8, 3])
def test_flash_attention_bf16_strided_heads(card, offset):
    """q sliced out of a wider tensor: its head stride is not its dense
    stride. At a 16-byte offset the kernel reads it in place; at 3
    elements the wrapper copies it (TMA needs 16-byte rows)."""
    from repro_torch.kernels.flash_attention import rows_aligned
    wide, k, v = _attn_inputs(card, torch.bfloat16, offset,
                              (2, 130, 4, 160), (2, 130, 2, 128),
                              (2, 130, 2, 128))
    q = wide[..., offset:offset + 128]
    assert q.stride(2) == 160 and rows_aligned(q) == (offset == 8)
    _b3_check(card, q, k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,strides", [
    ((2, 1, 8, 64), (1024, 3, 64, 1)),     # seq len 1, odd seq stride
    ((1, 70, 8, 64), (5, 512, 64, 1)),     # batch 1, odd batch stride
    ((1, 1, 8, 64), (3, 5, 64, 1))])       # both
def test_flash_attention_odd_strides_of_length_one_dims(card, dtype, shape,
                                                        strides):
    """q viewed with odd strides on its length-1 dims: the wrapper takes
    it in place (no row lies there) and the kernel, whose bf16 tensor maps
    want every stride a multiple of 16 bytes, launches on it."""
    from repro_torch.kernels.flash_attention import rows_aligned
    B, S, H, D = shape
    span = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    buf, k, v = _attn_inputs(card, dtype, S + B, (span,),
                             (B, 65, 2, D), (B, 65, 2, D))
    q = buf.as_strided(shape, strides)
    assert rows_aligned(q)
    if dtype == torch.bfloat16:
        _b3_check(card, q, k, v, causal=False)
        return
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_plain(q, k, v, causal=False)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,Hkv,D,cache_len", [
    (512, 16, 2, 128, 0), (512, 16, 2, 128, 511), (700, 8, 8, 64, 256),
    (300, 4, 2, 16, 255)])
def test_decode_attention_kernel_matches_plain(card, dtype, S, H, Hkv, D,
                                               cache_len):
    q, kc, vc = _attn_inputs(card, dtype, cache_len, (3, 1, H, D),
                             (3, S, Hkv, D), (3, S, Hkv, D))
    want = decode_attention_plain(q, kc, vc, cache_len)
    kc[:, cache_len + 1:] = float("nan")  # slots the kernel must not read
    vc[:, cache_len + 1:] = float("nan")
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, cache_len)
    assert decode_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_len", [0, 126, 127, 128, 255, 256, 2079])
@pytest.mark.parametrize("groups", [1, 2, 8])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_decode_attention_split_kv(card, D, groups, cache_len, dtype):
    """B4 at the serving shape's batch, KV heads and cache (B 4, Hkv 2,
    2 080 slots), with the live slots ending on and next to split
    boundaries: against the plain version, no slot past cache_len read
    (NaN there), and a second call bit-identical (the splits are merged
    in a fixed order)."""
    H = 2 * groups
    q, kc, vc = _attn_inputs(card, dtype, cache_len + D, (4, 1, H, D),
                             (4, 2080, 2, D), (4, 2080, 2, D))
    want = decode_attention_plain(q, kc, vc, cache_len)
    kc[:, cache_len + 1:] = float("nan")
    vc[:, cache_len + 1:] = float("nan")
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, cache_len)
    again = decode_attention(q, kc, vc, cache_len)
    assert decode_attention.launches == before + 2  # one per call
    assert torch.equal(got, again)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_merges_any_number_of_splits(card, dtype):
    """A cache of 400 000 live slots (6 250 splits): the combine reads
    the splits' statistics from the workspace, so their number has no
    limit."""
    cache_len = 399_999
    q, kc, vc = _attn_inputs(card, dtype, 7, (1, 1, 4, 16),
                             (1, cache_len + 1, 2, 16),
                             (1, cache_len + 1, 2, 16))
    got = decode_attention(q, kc, vc, cache_len)
    want = decode_attention_plain(q, kc, vc, cache_len)
    assert torch.equal(got, decode_attention(q, kc, vc, cache_len))
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


# ---------------------------------------- B3 / B4: windows, prefixes, D 80/256
MASK_CASES = [  # (S, H, Hkv, D, causal, window, prefix)
    (300, 4, 2, 64, True, 40, 0),      # a window smaller than a tile
    (300, 4, 2, 64, True, 100, 0),     # not a multiple of 64
    (640, 5, 1, 64, True, 128, 0),     # on tile edges, G = 5 (hymba)
    (300, 8, 1, 256, True, None, 70),  # a prefix not a multiple of 64
    (320, 8, 1, 256, True, None, 64),  # on a tile edge (paligemma's D)
    (500, 4, 2, 64, True, 64, 130),    # window and prefix together
    (150, 16, 16, 80, False, None, 0),  # hubert: bidirectional, D 80
    (200, 4, 2, 80, True, 50, 0),
    (130, 2, 2, 256, False, 30, 0)]    # a window without causal order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MASK_CASES, ids=str)
def test_flash_attention_masks_match_plain(card, dtype, case):
    """B3 with a sliding window and / or a prefix, and at head dims 80
    and 256, against its plain version; the key tiles each query tile
    loaded equal the count the mask allows (``live_tiles``)."""
    from repro_torch.kernels.flash_attention import live_tiles
    S, H, Hkv, D, causal, window, prefix = case
    q, k, v = _attn_inputs(card, dtype, S + D, (2, S, H, D), (2, S, Hkv, D),
                           (2, S, Hkv, D))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    tiles = torch.zeros((2, H, -(-S // 64)), dtype=torch.int32, device=card)
    before = flash_attention.launches
    got = flash_attention(q, k, v, tiles_loaded=tiles, **kw)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, **kw)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(tiles, live_tiles(S, S, device=card, **kw)
                       .expand(2, H, -1))
    assert torch.equal(got, flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("S", [1, 17, 64, 130, 1500])
@pytest.mark.parametrize("D", [80, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dims_80_and_256(card, dtype, D, S):
    """The new head dims, causal and bidirectional (D = 80 fills its
    second 64-column TMA box with zeros past column 80)."""
    q, k, v = _attn_inputs(card, dtype, S + D, (2, S, 8, D), (2, S, 1, D),
                           (2, S, 1, D))
    tol = ATTN_TOL[dtype]
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("D", [80, 256])
def test_flash_attention_bf16_unaligned_new_head_dims(card, D):
    """bf16 rows off a 16-byte boundary at D 80 and 256: the wrapper
    copies them (TMA), the result is the aligned call's, bit for bit."""
    q, k, v = _attn_inputs(card, torch.bfloat16, D, (1, 130, 4, D),
                           (1, 130, 2, D), (1, 130, 2, D))

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 != 0
        return out

    kw = dict(causal=True, window=70, prefix_len=9)
    assert torch.equal(flash_attention(off(q), off(k), off(v), **kw),
                       flash_attention(q, k, v, **kw))


def _mla_inputs(card, dtype, seed, B, S, H):
    """q and k of head dim 192 and v of 128 as MLA makes them: v a view
    into a (B, S, H, 256) tensor (its nope half in front), k's rope part
    one vector broadcast over the heads."""
    q, kv, kr = _attn_inputs(card, dtype, seed, (B, S, H, 192),
                             (B, S, H, 256), (B, S, 1, 64))
    k = torch.cat([kv[..., :128], kr.expand(B, S, H, 64)], dim=-1)
    return q, k, kv[..., 128:]


@pytest.mark.parametrize("S", [1, 17, 64, 130, 2049])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_value_head_dim_of_its_own(card, dtype, causal, S):
    """B3 at (D, Dv) = (192, 128), multi-head latent attention's prefill,
    against its plain version: v read in place through its head stride of
    256 (no copy), the output (B, S, H, 128), the key tiles the mask
    allows, and a second call bit-identical."""
    from repro_torch.kernels.flash_attention import for_kernel, live_tiles
    q, k, v = _mla_inputs(card, dtype, S, 2, S, 4)
    assert v.stride(2) == 256 and for_kernel(v) is v
    tiles = torch.zeros((2, 4, -(-S // 64)), dtype=torch.int32, device=card)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, tiles_loaded=tiles)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == want.shape == (2, S, 4, 128)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(tiles, live_tiles(S, S, causal=causal, device=card)
                       .expand(2, 4, -1))
    assert torch.equal(got, flash_attention(q, k, v, causal=causal))


def test_flash_attention_refuses_other_head_dim_pairs(card):
    q, k, v = _attn_inputs(card, torch.bfloat16, 0, (1, 8, 2, 64),
                           (1, 8, 2, 64), (1, 8, 2, 32))
    with pytest.raises(ValueError, match="pairs"):
        flash_attention(q, k, v)


def _families_cfg(arch):
    """The reduced MoE arch (deepseek's MLA at its reduced head dims, q /
    k 24 and v 16, which B3 takes zero-padded to 32)."""
    from repro_torch.configs import get_arch
    return get_arch(arch).reduced()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-236b"])
def test_reduced_moe_prefill_and_decode_on_the_card(card, arch):
    """Prefill and 4 decode steps of a reduced MoE arch on the card
    against the CPU, float32, teacher-forced: one B3 a layer at prefill
    (deepseek's dense0 included), one B4 a layer and step for granite
    and none for deepseek (its absorbed decode is plain)."""
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, tree_map
    cfg = _families_cfg(arch)
    params = init_params(registry.param_specs(cfg),
                         torch.Generator(device=card).manual_seed(0), card)
    on = {"cuda": params, "cpu": tree_map(lambda t: t.cpu(), params)}
    toks = torch.randint(0, cfg.vocab_size, (2, 45),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        cache = M.init_cache(cfg, 2, 48, torch.float32, device=dev)
        b3, b4 = flash_attention.launches, decode_attention.launches
        with torch.no_grad():
            last, cache = M.prefill_step(on[dev], {"tokens": toks[:, :41]
                                                   .to(dev)}, cfg,
                                         dtype=torch.float32, cache=cache)
            steps = [last]
            for t in range(4):
                lg, cache = M.decode_step(
                    on[dev], cache, {"tokens": toks[:, 41 + t:42 + t]
                                     .to(dev), "cache_len": 41 + t}, cfg,
                    dtype=torch.float32)
                steps.append(lg)
        out[dev] = torch.cat(steps, dim=1).cpu()
        launched = (flash_attention.launches - b3,
                    decode_attention.launches - b4)
    L = registry.n_scanned_layers(cfg)
    assert launched == (cfg.n_layers, 0 if cfg.mla else 4 * L)
    torch.testing.assert_close(out["cuda"], out["cpu"], atol=1e-4, rtol=0)


def test_moe_combine_is_bit_identical_on_a_rerun(card):
    """The MoE dispatch and combine (no atomics: a token's slots summed
    in slot order) give the same bits on a rerun, in bf16 and float32,
    over several groups."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import blocks, registry
    from repro_torch.models.param import init_params
    cfg = get_arch("deepseek-v2-236b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=64))
    p = init_params(registry.layer_specs(cfg)["moe"],
                    torch.Generator(device=card).manual_seed(0), card)
    x = torch.randn((4, 96, cfg.d_model), device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    for dtype in (torch.float32, torch.bfloat16):
        pd = {k: t.to(dtype) for k, t in p.items()}
        y, aux = blocks.moe_fwd(pd, x.to(dtype), cfg)
        y2, aux2 = blocks.moe_fwd(pd, x.to(dtype), cfg)
        assert torch.equal(y, y2) and torch.equal(aux, aux2)
        assert bool(torch.isfinite(y.float()).all())


def test_granite_training_step_is_bit_identical_on_a_rerun(card):
    """Two training steps of granite-moe-1b-a400m (cut to 2 layers at
    full width, bf16 on float32 masters, remat "full", 2 microbatches of
    1 x 256 tokens) from one seeded state on the card give the same bits:
    the loss and every parameter after the update, which carries every
    gradient leaf through AdamW -- the MoE combine's accumulating
    backward, B3 and B9 included."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.models import registry
    from repro_torch.models.param import (init_params, train_params,
                                          tree_leaves)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainState, make_train_step
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m"), n_layers=2)
    opt = AdamWConfig(warmup_steps=1, total_steps=10)
    batch = SyntheticDataset(cfg, ShapeConfig("t", 256, 2, "train"), seed=0,
                             device=card).batch(0)
    step = make_train_step(cfg, opt, microbatches=2)
    out = []
    before = flash_attention_bwd.launches
    for _ in range(2):
        params = train_params(init_params(
            registry.param_specs(cfg),
            torch.Generator(device=card).manual_seed(0), card))
        st, m = step(TrainState.create(params, opt), batch)
        out.append((m["loss"].clone(), [p.detach().clone()
                                        for _, p in tree_leaves(st.params)]))
    assert flash_attention_bwd.launches - before == 2 * 2 * 2
    assert torch.equal(out[0][0], out[1][0])
    assert bool(torch.isfinite(out[0][0]))
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_len", [0, 40, 99, 100, 101, 300, 2079])
@pytest.mark.parametrize("D,groups,prefix", [(64, 5, 0), (256, 8, 0),
                                             (128, 2, 30)])
def test_decode_attention_window_matches_plain(card, D, groups, prefix,
                                               cache_len, dtype):
    """B4 with a window of 100 at cache lengths below, at and above it
    (hymba's G = 5 at D 64, paligemma's G = 8 at D 256, a prefix beside
    the window): against the plain version, no slot outside the live ones
    read (NaN there), a second call bit-identical."""
    from repro_torch.kernels.ref import decode_live
    window, H = 100, 2 * groups
    q, kc, vc = _attn_inputs(card, dtype, cache_len + D, (3, 1, H, D),
                             (3, 2080, 2, D), (3, 2080, 2, D))
    kw = dict(window=window, prefix_len=prefix)
    want = decode_attention_plain(q, kc, vc, cache_len, **kw)
    dead = ~decode_live(2080, cache_len, device=card, **kw)
    kc[:, dead], vc[:, dead] = float("nan"), float("nan")
    got = decode_attention(q, kc, vc, cache_len, **kw)
    assert torch.equal(got, decode_attention(q, kc, vc, cache_len, **kw))
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_head_dim_256(card, dtype):
    q, kc, vc = _attn_inputs(card, dtype, 256, (4, 1, 8, 256),
                             (4, 2336, 1, 256), (4, 2336, 1, 256))
    for cache_len in (0, 63, 64, 2335):
        got = decode_attention(q, kc, vc, cache_len)
        want = decode_attention_plain(q, kc, vc, cache_len)
        tol = ATTN_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_reduced_families_on_the_card(card):
    """Reduced hymba (5 layers: windowed ones among them), paligemma and
    hubert on the card against the CPU, float32, and their launches."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, tree_map
    for arch, kw in (("hymba-1.5b", dict(n_layers=5)), ("paligemma-3b", {}),
                     ("hubert-xlarge", {})):
        cfg = dataclasses.replace(get_arch(arch).reduced(), **kw)
        params = init_params(registry.param_specs(cfg),
                             torch.Generator(device=card).manual_seed(0),
                             card)
        cpu = tree_map(lambda t: t.cpu(), params)
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40),
                                         generator=g)}
        if cfg.frontend:
            n = 40 if cfg.frontend == "audio" else cfg.frontend_seq
            batch["frames" if cfg.frontend == "audio" else "patches"] = \
                torch.randn((2, n, cfg.frontend_dim), generator=g)
        before = flash_attention.launches
        with torch.no_grad():
            got, _ = M.forward(params, {k: v.to(card) for k, v in
                                        batch.items()}, cfg,
                               dtype=torch.float32)
            want, _ = M.forward(cpu, batch, cfg, dtype=torch.float32)
        assert flash_attention.launches == before + cfg.n_layers
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def test_reduced_server_on_the_card(card):
    """The reduced qwen2.5-3b served on the card (head dim 16): one B3
    launch per layer at prefill, one B4 per layer and step, and prefill
    logits within bf16 rounding of the CPU's on the same weights
    (0.0625: eight bf16 steps at the logits' scale of ~2, as in
    tests/test_torch_serve.py)."""
    from repro_torch.launch.serve import Server
    from repro_torch.models.param import tree_map
    srv = Server("qwen2.5-3b", batch=2, max_seq=48)  # device="cuda"
    cpu = Server("qwen2.5-3b", batch=2, max_seq=48, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), srv.params)
    prompts = np.random.default_rng(0).integers(0, 256, (2, 20))
    toks = torch.tensor(prompts)
    got, _ = srv.prefill(srv.params, {"tokens": toks.to(card)})
    want, _ = cpu.prefill(cpu.params, {"tokens": toks})
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.0625,
                               rtol=0)
    b3, b4 = flash_attention.launches, decode_attention.launches
    out = srv.generate(prompts, 4)
    L = srv.cfg.n_layers
    assert flash_attention.launches == b3 + L
    assert decode_attention.launches == b4 + 3 * L
    assert out.shape == (2, 4) and ((out >= 0) & (out < 256)).all()


# B5 against its plain version, scaled by the largest value: float32 sums
# in another order (1e-4, the scaled atol of tests/test_kernels.py); bf16
# inputs are the same values on both sides, with larger rounding in the
# float32 sums of their products (2e-3)
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}


def _ssd_inputs(card, dtype, seed, Bz, S, H, P, G, N):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(Bz, S, H, P, generator=g).to(card, dtype)
    dt = torch.nn.functional.softplus(torch.randn(Bz, S, H, generator=g))
    A = -torch.exp(1.5 * torch.rand(H, generator=g))
    B = torch.randn(Bz, S, G, N, generator=g).to(card, dtype)
    C = torch.randn(Bz, S, G, N, generator=g).to(card, dtype)
    return x, dt.to(card), A.to(card).expand(Bz, H), B, C


def _scaled(got, want):
    return float((got.float() - want.float()).abs().max()) / (
        float(want.float().abs().max()) + 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bz,S,H,P,G,N", [
    (2, 256, 1, 64, 1, 32), (4, 256, 1, 32, 1, 16), (1, 512, 1, 64, 1, 64),
    (2, 1, 8, 64, 1, 128), (2, 17, 8, 64, 1, 128), (1, 2049, 4, 64, 1, 128),
    (2, 300, 8, 64, 2, 128), (2, 77, 8, 16, 1, 16)])
def test_ssd_scan_kernel_matches_plain(card, dtype, Bz, S, H, P, G, N):
    args = _ssd_inputs(card, dtype, S, Bz, S, H, P, G, N)
    before = ssd_scan.launches
    buf = torch.full((3, Bz, H, P, N), 7.0, device=card)
    y, h = ssd_scan(*args, out_state=buf[1])
    assert ssd_scan.launches == before + 1
    assert h.data_ptr() == buf[1].data_ptr()
    assert (buf[0] == 7).all() and (buf[2] == 7).all()
    yw, hw = ssd_scan_plain(*args)
    assert _scaled(y, yw) <= SSD_TOL[dtype]
    assert _scaled(h, hw) <= SSD_TOL[dtype]


@pytest.mark.parametrize("S", [130, 255])
def test_ssd_scan_strong_decay_has_no_nan(card, S):
    """A = -16, dt ~ 10, against the sequential ``ref_ssd``. S = 255 ends
    on a ragged chunk of 63 rows with |cum| ~ 1e4: the last row's weight
    exp(cum_last - cum_j) must be exactly 1 there."""
    from repro_torch.kernels.ref import ref_ssd
    x, dt, A, B, C = _ssd_inputs(card, torch.float32, 1, 1, S, 2, 16, 1, 16)
    dt = 10.0 + 0.1 * torch.rand(dt.shape, device=card)
    A = torch.full_like(A, -16.0)
    y, h = ssd_scan(x, dt, A, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    fold = lambda t: t.repeat_interleave(2 // t.shape[2], dim=2).permute(
        0, 2, 1, 3).reshape(2, S, -1)  # noqa: E731
    yr, hr = ref_ssd(fold(x), dt[0].T, A[0], fold(B), fold(C))
    assert _scaled(y[0].permute(1, 0, 2), yr) <= 1e-4
    assert _scaled(h[0], hr) <= 1e-4


@pytest.mark.parametrize("S", [130, 255])
def test_ssd_scan_bf16_strong_decay_has_no_nan(card, S):
    """The strong-decay case in bf16 (x, B, C rounded to bf16 first; the
    same values go to ``ref_ssd`` in float32): the tensor-core route folds
    exp(cum_i - cum_j) dt_j into S and carries the state as hi/lo pairs,
    and holds the float32 route's 1e-4."""
    from repro_torch.kernels.ref import ref_ssd
    x, dt, A, B, C = _ssd_inputs(card, torch.bfloat16, 1, 1, S, 2, 64, 1,
                                 128)
    dt = 10.0 + 0.1 * torch.rand(dt.shape, device=card)
    A = torch.full_like(A, -16.0)
    y, h = ssd_scan(x, dt, A, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    fold = lambda t: t.float().repeat_interleave(  # noqa: E731
        2 // t.shape[2], dim=2).permute(0, 2, 1, 3).reshape(2, S, -1)
    yr, hr = ref_ssd(fold(x), dt[0].T, A[0], fold(B), fold(C))
    assert _scaled(y[0].permute(1, 0, 2), yr) <= 1e-4
    assert _scaled(h[0], hr) <= 1e-4


@pytest.mark.parametrize("Bz,S,H,P,G,N", [
    (2, 64, 4, 64, 1, 128), (2, 128, 4, 64, 1, 128),
    (2, 192, 4, 64, 1, 128), (1, 2049, 4, 64, 1, 128),
    (2, 300, 8, 64, 2, 128), (2, 200, 8, 32, 1, 64), (2, 90, 4, 16, 2, 32),
    (3, 65, 2, 64, 1, 16)])
def test_ssd_scan_bf16_tiling_boundaries(card, Bz, S, H, P, G, N):
    """The bf16 route at its tiling's edges: one, two and three whole
    chunks (the two-stage ring filled, then refilled), 33 chunks with one
    row in the last, two groups, the warps of p past P idle, N below one
    TMA box. Its float32 operands go in as hi/lo pairs, so it holds the
    float32 route's 1e-4."""
    args = _ssd_inputs(card, torch.bfloat16, S + 1, Bz, S, H, P, G, N)
    y, h = ssd_scan(*args)
    yw, hw = ssd_scan_plain(*args)
    assert _scaled(y, yw) <= 1e-4 and _scaled(h, hw) <= 1e-4


def test_ssd_scan_bf16_unaligned_x_is_copied(card):
    """An x that starts 2 bytes into its storage, rows 513 elements
    apart: TMA cannot take it, the wrapper copies it, the kernel runs."""
    x, dt, A, B, C = _ssd_inputs(card, torch.bfloat16, 5, 2, 130, 8, 64, 1,
                                 128)
    wide = torch.cat([x.flatten(2), x.flatten(2)[..., :1]], dim=2)
    xo = wide[..., 1:].view(2, 130, 8, 64)
    assert xo.data_ptr() % 16 != 0
    before = ssd_scan.launches
    y, h = ssd_scan(xo, dt, A, B, C)
    assert ssd_scan.launches == before + 1
    yw, hw = ssd_scan_plain(xo, dt, A, B, C)
    assert _scaled(y, yw) <= 1e-4 and _scaled(h, hw) <= 1e-4


def test_ssd_scan_bf16_one_wave_at_the_serving_shape(card):
    """mamba2-780m's prefill launches 4 x 48 scan blocks: all resident at
    once on the card's SMs."""
    from repro_torch.kernels.ssd_scan import bf16_occupancy
    occ = bf16_occupancy(64, 128)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert occ["blocks_per_sm"] * sms >= 4 * 48, occ


def test_reduced_ssm_server_on_the_card(card):
    """The reduced mamba2-780m served on the card (head dim 16, state
    16): one B5 launch per layer at prefill, none at decode, and prefill
    logits within bf16 rounding of the CPU's on the same weights."""
    from repro_torch.launch.serve import Server
    from repro_torch.models.param import tree_map
    srv = Server("mamba2-780m", batch=2, max_seq=48)  # device="cuda"
    cpu = Server("mamba2-780m", batch=2, max_seq=48, device="cpu")
    cpu.params = tree_map(lambda t: t.cpu(), srv.params)
    prompts = np.random.default_rng(0).integers(0, 256, (2, 20))
    toks = torch.tensor(prompts)
    got, _ = srv.prefill(srv.params, {"tokens": toks.to(card)})
    want, _ = cpu.prefill(cpu.params, {"tokens": toks})
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.0625,
                               rtol=0)
    b5 = ssd_scan.launches
    out = srv.generate(prompts, 4)
    assert ssd_scan.launches == b5 + srv.cfg.n_layers
    assert out.shape == (2, 4) and ((out >= 0) & (out < 256)).all()


def test_reduced_ssm_decode_matches_forward_on_the_card(card):
    """float32 on the card: prefill (B5) and decode steps (the plain
    recurrent update) against one forward over the whole sequence (B5
    over a ragged last chunk)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params
    cfg = get_arch("mamba2-780m").reduced()
    params = init_params(registry.param_specs(cfg),
                         torch.Generator(device=card).manual_seed(2), card)
    toks = torch.tensor(np.random.default_rng(2).integers(0, 256, (2, 75)),
                        device=card)
    S, f32 = 70, torch.float32
    want, _ = M.forward(params, {"tokens": toks}, cfg, dtype=f32)
    cache = M.init_cache(cfg, 2, 80, f32, device=card)
    got, cache = M.prefill_step(params, {"tokens": toks[:, :S]}, cfg,
                                dtype=f32, cache=cache)
    torch.testing.assert_close(got[:, 0], want[:, S - 1], atol=1e-4, rtol=0)
    for t in range(5):
        got, cache = M.decode_step(params, cache, {
            "tokens": toks[:, S + t:S + t + 1], "cache_len": S + t}, cfg,
            dtype=f32)
        torch.testing.assert_close(got[:, 0], want[:, S + t], atol=1e-4,
                                   rtol=0)


# B2 against its plain version on the card, at the tolerances of
# tests/test_kernels.py: atol = tol * max|plain| + 1e-5, rtol = tol, with
# tol 1e-4 for float32 (true float32 FMAs in another order) and 2e-2 for
# bf16 (the output rounded to bf16 on each side)
GM_CASES = [(128, 128, 128, 0, 0), (256, 256, 512, 256, 0),
            (384, 512, 256, 0, 256), (128, 256, 384, 128, 128),
            (512, 128, 128, 0, 0)]
GM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _gm_check(x, w, bitmap, **blocks):
    from repro_torch.kernels.gated_matmul import (gated_matmul_p,
                                                  gated_matmul_plain)
    bm = blocks.get("bm", 128)
    gated_matmul_p.tiles_run.zero_()
    before = gated_matmul_p.launches
    got = gated_matmul_p(x, w, bitmap, **blocks)
    assert gated_matmul_p.launches == before + 1
    assert int(gated_matmul_p.tiles_run) \
        == (x.shape[0] // bm) * int((bitmap != 0).sum())
    want = gated_matmul_plain(x, w, bitmap, **blocks)
    tol = GM_TOL[x.dtype]
    assert got.dtype == x.dtype and got.shape == want.shape
    torch.testing.assert_close(
        got.float(), want.float(), rtol=tol,
        atol=tol * float(want.float().abs().max()) + 1e-5)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GM_CASES)
def test_gated_matmul_kernel_matches_plain(card, dtype, case):
    from repro_torch.kernels import ops
    M, K, N, zn, zk = case
    x, w = _attn_inputs(card, dtype, sum(case), (M, K), (K, N))
    if zn:
        w[:, N - zn:] = 0.0
    if zk:
        w[K - zk:] = 0.0
    _gm_check(x, w, ops.tile_nonzero_bitmap(w, 128, 128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("bk", [64, 128])
def test_gated_matmul_every_block_instance(card, dtype, bm, bn, bk):
    x, w = _attn_inputs(card, dtype, bm + bn + bk, (256, 384), (384, 256))
    g = np.random.default_rng(bm * bn + bk)
    bitmap = torch.tensor(g.random((384 // bk, 256 // bn)) > 0.4,
                          dtype=torch.int32, device=card)
    _gm_check(x, w, bitmap, bm=bm, bn=bn, bk=bk)


def test_gated_matmul_drops_a_nonzero_tile_and_refuses_other_blocks(card):
    from repro_torch.kernels.gated_matmul import gated_matmul_p
    x, w = _attn_inputs(card, torch.bfloat16, 9, (256, 256), (256, 512))
    x[:, 128:] = float("nan")  # K tile 1 never runs
    bitmap = torch.tensor([[1, 0, 1, 1], [0, 0, 0, 0]], dtype=torch.int32,
                          device=card)
    got = _gm_check(x, w, bitmap)
    assert bool(torch.isfinite(got).all())
    assert float(got[:, 128:256].abs().max()) == 0.0
    with pytest.raises(ValueError, match="built for"):
        gated_matmul_p(x, w, bitmap, bm=32)


def _column_bitmap(n_k, n_n, live):
    """A (n_k, n_n) bitmap with ``live[c]`` the live K tiles of column c."""
    bitmap = np.zeros((n_k, n_n), dtype=np.int32)
    for c, ks in enumerate(live):
        bitmap[list(ks), c] = 1
    return bitmap


@pytest.mark.parametrize("live", [
    [(0, 3, 4, 7), (1, 6)],        # scattered: the ring skips the gaps
    [(5,), (2,)],                  # a single live tile a column
    [(), (0, 2, 3, 5, 6, 7)],      # column 0 all dead: zeros written
    [(1, 2, 3, 4, 5, 6, 7), ()]])  # only the first tile dead
@pytest.mark.parametrize("blocks", [(64, 64, 64), (128, 128, 128)])
def test_gated_matmul_bf16_ring_over_live_tiles(card, live, blocks):
    bm, bn, bk = blocks
    K = 8 * bk
    x, w = _attn_inputs(card, torch.bfloat16, K + bn, (256, K),
                        (K, 2 * bn))
    bitmap = torch.tensor(_column_bitmap(8, 2, live), device=card)
    got = _gm_check(x, w, bitmap, bm=bm, bn=bn, bk=bk)
    for c, ks in enumerate(live):
        if not ks:
            assert float(got[:, c * bn:(c + 1) * bn].abs().max()) == 0.0


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("bk", [64, 128])
def test_gated_matmul_bf16_nan_under_dead_tiles(card, bm, bn, bk):
    """NaN in x under the K tiles that are dead in every column: never
    loaded, so every output is finite; 40 K tiles of 64 take two ballots
    of the live-tile list."""
    n_k = 40 if bk == 64 else 12
    K = n_k * bk
    x, w = _attn_inputs(card, torch.bfloat16, bm + bn + bk, (2 * bm, K),
                        (K, 3 * bn))
    g = np.random.default_rng(bm + bn + bk)
    bitmap = (g.random((n_k, 3)) > 0.5).astype(np.int32)
    dead = [ki for ki in range(n_k) if ki % 5 == 1]
    bitmap[dead] = 0
    for ki in dead:
        x[:, ki * bk:(ki + 1) * bk] = float("nan")
    got = _gm_check(x, w, torch.tensor(bitmap, device=card), bm=bm, bn=bn,
                    bk=bk)
    assert bool(torch.isfinite(got).all())


def test_evaluate_all_on_the_card_matches_evaluate(card):
    from repro_torch.core import evaluate, evaluate_all
    wl = opgen.paper_suite()[8]
    k1, k2 = sa_occupancy.launches, segment_sum.launches
    reps = evaluate_all(wl, "NPU-D")  # device=None: the card
    assert sa_occupancy.launches > k1 and segment_sum.launches > k2
    for p, got in reps.items():
        want = evaluate(wl, "NPU-D", p)
        for f in ("static_j", "dynamic_j", "wake_events", "gated_s",
                  "setpm_by"):
            for c, v in getattr(want, f).items():
                assert abs(getattr(got, f)[c] - v) <= 1e-9 * max(
                    1e-30, abs(v), abs(getattr(got, f)[c])), (p, f, c)
        assert abs(got.runtime_s - want.runtime_s) \
            <= 1e-9 * want.runtime_s, p


# ------------------------------------------------------------------- B7
def _b7_stack(rows, horizons, scales) -> dict:
    return {k: torch.from_numpy(v) for k, v in
            pack_programs(pp, pp_isa, rows, horizons, scales).items()}


def _b7_check(card, data: dict) -> dict:
    from repro_torch.kernels.program_exec import (program_exec,
                                                  program_exec_plain)
    before = program_exec.launches
    got = program_exec({k: v.to(card) for k, v in data.items()})
    assert program_exec.launches == before + 1
    want = program_exec_plain(data)
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), v), k
    return want


B7_SCALES = [(1.0, 1.0), (0.25, 1.0), (4.0, 1.0), (1.0, 0.25), (1.0, 4.0),
             (2.0, 0.5)]


@pytest.mark.parametrize("scale", B7_SCALES,
                         ids=lambda s: f"d{s[0]}-w{s[1]}")
def test_program_exec_kernel_equals_plain_on_seeded_programs(card, scale):
    rows, horizons = seeded_programs(pp_isa, 10, 24)
    _b7_check(card, _b7_stack(rows, horizons, [scale] * 24))


def test_program_exec_kernel_inert_and_padded_rows(card):
    """Padding events inside and after a row, and inert rows (horizon 0,
    no events) appended to the stack."""
    rows, horizons = seeded_programs(pp_isa, 3, 6)
    data = _b7_stack(rows, horizons, B7_SCALES)
    for k in ("cycle", "lat", "pm"):
        v = data[k]
        hole = torch.full((3,) + v.shape[1:], -1 if k == "cycle" else 7,
                          dtype=v.dtype)
        v = torch.cat([v[:4], hole, v[4:], hole])
        data[k] = torch.cat([v, torch.full(
            (v.shape[0], 2) + v.shape[2:], -1 if k == "cycle" else 0,
            dtype=v.dtype)], dim=1)
    for k in ("delay", "window", "mode0", "horizon"):
        v = data[k]
        data[k] = torch.cat([v, torch.zeros((2,) + v.shape[1:],
                                            dtype=v.dtype)])
    want = _b7_check(card, data)
    assert not any(v[6:].any() for v in want.values())


def test_program_exec_kernel_ragged_stack(card):
    """One row of 1 event beside one of thousands, and rows between."""
    rows, horizons = seeded_programs(pp_isa, 11, 5,
                                     n_events=[1, 3000, 17, 1, 640])
    _b7_check(card, _b7_stack(rows, horizons, B7_SCALES[:5]))


def test_program_plane_records_on_the_card_equal_cpu(card):
    from repro_torch.kernels.program_exec import program_exec
    sw = importlib.import_module("repro_torch.core.sweep")
    grid = KnobGrid(delay_scale=(1.0, 4.0), window_scale=(1.0, 0.5))
    wls = opgen.paper_suite()[8:14]
    before = program_exec.launches
    got = sw.sweep_program_plane(wls, ("NPU-B", "NPU-D"), grid)
    assert program_exec.launches == before + 1
    assert got == sw.sweep_program_plane(wls, ("NPU-B", "NPU-D"), grid,
                                         device="cpu")


def _b7_ring_events() -> int:
    """D, the events a stage of B7's ring holds, as the port builds it."""
    cu = (Path(pp.__file__).resolve().parents[1] / "kernels" / "csrc"
          / "program_plane.cu").read_text()
    return int(re.search(r"constexpr int D = (\d+);", cu).group(1))


def _b7_streams_check(card, rows, horizons, stream_of_row, scales) -> dict:
    """The stream entry on the card: one launch, ``torch.equal`` to its
    plain version on the CPU, and the same on a second call."""
    from repro_torch.kernels.program_exec import (program_exec,
                                                  program_exec_streams,
                                                  program_exec_streams_plain)
    pa = program_arrays(pp, pp_isa, rows, horizons)
    sor = np.asarray(stream_of_row, np.int64)
    delay, window = row_knobs(pp, pp_isa, scales)
    hz = np.asarray(horizons, np.int64)[sor]
    on_card = pp._upload_streams(pa, sor, window, delay, hz, card)
    before = program_exec.launches
    got = program_exec_streams(*on_card)
    assert program_exec.launches == before + 1
    again = program_exec_streams(*on_card)
    want = program_exec_streams_plain(
        *pp._upload_streams(pa, sor, window, delay, hz, "cpu"))
    for k, v in want.items():
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), v), k
        assert torch.equal(got[k], again[k]), k
    return want


@pytest.mark.parametrize("scale", B7_SCALES,
                         ids=lambda s: f"d{s[0]}-w{s[1]}")
def test_program_exec_streams_kernel_equals_plain_on_seeded_programs(
        card, scale):
    """The 24 seeded programs, each stream run by 3 rows at three
    detection windows, the rows shuffled."""
    rows, horizons = seeded_programs(pp_isa, 10, 24)
    sor = np.random.default_rng(1).permutation(np.repeat(np.arange(24), 3))
    d, w = scale
    scales = [(d, w * (0.5, 1.0, 2.0)[i % 3]) for i in range(len(sor))]
    _b7_streams_check(card, rows, horizons, sor, scales)


@pytest.mark.parametrize("k", ["0", "1", "D-1", "D", "D+1", "3D+1"])
def test_program_exec_ring_edge_cases(card, k):
    """A stream of 0, 1, D - 1, D, D + 1 or 3 D + 1 events (D the ring
    stage's events), behind streams of 1, 2 and 3 events so that it
    starts at each offset modulo 4 in turn, each stream run by 2 rows."""
    d = _b7_ring_events()
    n = {"0": 0, "1": 1, "D-1": d - 1, "D": d, "D+1": d + 1,
         "3D+1": 3 * d + 1}[k]
    lens = [1, n, 2, n, 3, n, n]
    rows, horizons = seeded_programs(pp_isa, 12, len(lens),
                                     n_events=[max(x, 1) for x in lens])
    rows = [r if x else [] for r, x in zip(rows, lens)]
    sor = np.repeat(np.arange(len(lens)), 2)[::-1].copy()
    _b7_streams_check(card, rows, horizons, sor,
                      [B7_SCALES[i % 6] for i in range(len(sor))])


def test_program_exec_long_stream_beside_short_ones(card):
    """One stream of 3 000 events beside streams of 1."""
    rows, horizons = seeded_programs(pp_isa, 13, 5,
                                     n_events=[1, 3000, 1, 1, 17])
    _b7_streams_check(card, rows, horizons, [1, 0, 1, 2, 3, 4, 1, 1],
                      B7_SCALES + B7_SCALES[:2])


@pytest.mark.parametrize("n_rows", [9, 20, 33])
def test_program_exec_stream_shared_by_more_rows_than_a_warp(card, n_rows):
    """A warp steps 8 rows of a stream at once (a lane a unit): more
    rows than that take several passes over the stream."""
    rows, horizons = seeded_programs(pp_isa, 14, 2, n_events=[700, 5])
    sor = np.zeros(n_rows + 2, np.int64)
    sor[[3, n_rows]] = 1
    _b7_streams_check(card, rows, horizons, sor,
                      [B7_SCALES[i % 6] for i in range(len(sor))])


def test_program_plane_shared_streams_on_the_card_equal_cpu(card):
    """Three detection windows a delay scale: each stream run by 3 rows,
    as at program_plane_full."""
    from repro_torch.kernels.program_exec import program_exec
    sw = importlib.import_module("repro_torch.core.sweep")
    grid = KnobGrid(delay_scale=(0.5, 2.0), window_scale=(0.5, 1.0, 2.0))
    wls = opgen.paper_suite()[:6]
    before = program_exec.launches
    got = sw.sweep_program_plane(wls, ("NPU-A", "NPU-E"), grid)
    assert program_exec.launches == before + 1
    assert got == sw.sweep_program_plane(wls, ("NPU-A", "NPU-E"), grid,
                                         device="cpu")


# --------------------------------------------------------------------------
# the fleet / chaos / guard planes on the card
# --------------------------------------------------------------------------

def _small_fleet_day():
    from repro_torch.core import fleet
    classes = (
        fleet.WorkloadClass(
            "decode", opgen.llm_workload("llama3-8b", "decode", batch=8),
            fleet.ArrivalSpec("diurnal", rate_rps=6.0, peak_frac=0.8,
                              period_s=7200.0),
            requests_per_invocation=8),
        fleet.WorkloadClass(
            "rank", opgen.dlrm_workload("S"),
            fleet.ArrivalSpec("bursty", rate_rps=1.0, burst_prob=0.3,
                              burst_factor=6.0),
            requests_per_invocation=1024))
    return fleet.FleetScenario(
        classes=classes, n_chips=64, npu="NPU-D",
        policies=("NoPG", "ReGate-HW", "ReGate-Full"), duration_s=7200.0,
        epoch_s=900.0, seed=5, severity_levels=(0.0, 0.5, 1.0))


def test_fleet_day_on_the_card_equals_cpu(card):
    """A small fleet day: every epoch's ``evaluate_batch`` on the card
    (K1 once a call, K2 for its segmented sums) gives the CPU's report,
    integers and flags exact, floats ≤1e-9; a second card run is bit
    identical; a guarded card run records no event."""
    from repro_torch.core import fleet
    from repro_torch.core.guard import GuardPolicy
    from _torch_parity import assert_fleet_reports_match
    sc = _small_fleet_day()
    grid = KnobGrid(window_scale=(0.5, 1.0, 2.0), delay_scale=(1.0, 2.0))
    k1, k2 = sa_occupancy.launches, segment_sum.launches
    on_card = fleet.sweep_fleet(sc, grid, device=card)
    calls = sc.n_epochs + 1
    assert sa_occupancy.launches - k1 == calls
    assert (segment_sum.launches - k2) % calls == 0
    assert segment_sum.launches > k2
    on_cpu = fleet.sweep_fleet(sc, grid, device="cpu")
    assert_fleet_reports_match(on_cpu, on_card)
    assert fleet.sweep_fleet(sc, grid, device=card).to_dict() \
        == on_card.to_dict()
    guarded = fleet.sweep_fleet(sc, grid, device=card,
                                guard=GuardPolicy(timeout_s=600.0))
    assert guarded.guard["events"] == []
    guarded.guard = None
    assert guarded.to_dict() == on_card.to_dict()


def test_guard_raises_when_the_card_is_wedged(card):
    """The card's ladder has no rung below it: a card rung that sleeps
    past its deadline is abandoned and the call raises ``GuardError``;
    nothing runs on the CPU. A card rung that recovers gives the card's
    result with one recorded retry."""
    import time
    from repro_torch.core.guard import GuardedRunner, GuardError, GuardPolicy
    from repro_torch.core.backend import failover_rungs
    from repro_torch.core.policies import evaluate_batch
    from _torch_parity import assert_cubes_match
    wls = opgen.paper_suite()[12:15]
    dev = str(card)
    rungs = failover_rungs(card)
    assert rungs == ((dev, None),)
    calls = []

    def wedged(rung, *args):
        calls.append(rung)
        time.sleep(2.0)   # abandoned by the watchdog; launches nothing
        return None

    runner = GuardedRunner(GuardPolicy(timeout_s=0.5, max_retries=0),
                           rungs=rungs, runner=wedged)
    with pytest.raises(GuardError, match="exhausted at step 1 .timeout"):
        runner.evaluate_batch(wls, ("NPU-D",), POLICIES, None, step=1)
    assert calls == [dev] and runner.report.events == []

    state = {"n": 0}

    def raises_once(rung, *args):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("injected")
        return GuardedRunner._default_runner(rung, *args)

    runner = GuardedRunner(GuardPolicy(max_retries=1, backoff_base_s=0.01),
                           rungs=rungs, runner=raises_once)
    got = runner.evaluate_batch(wls, ("NPU-D",), POLICIES, None, step=2)
    assert [(e["kind"], e["rung"]) for e in runner.report.events] \
        == [("retry", dev)]
    assert_cubes_match(evaluate_batch(wls, ("NPU-D",), POLICIES, None,
                                      device=card), got, exact=True)
    time.sleep(2.0)  # the abandoned attempt ends before the next test


# ------------------------------------------------------ training: B9, B3's lse
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1, 4, 2, 64), (2, 63, 16, 2, 128),
                                   (1, 257, 8, 1, 128), (2, 130, 4, 2, 16),
                                   (1, 1000, 4, 4, 32),
                                   (2, 70, 4, 4, 192, 128),
                                   (1, 257, 8, 2, 192, 128)], ids=str)
def test_attention_bwd_kernel_matches_plain(card, dtype, shape):
    """(B, S, H, Hkv, D[, Dv]): v's head dim is D unless given
    (multi-head latent attention's (192, 128))."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd, flash_attention_bwd_plain)
    B, S, H, Hkv, D = shape[:5]
    Dv = shape[5] if len(shape) > 5 else D
    gen = torch.Generator(device=card).manual_seed(S)
    q, k, v, do = (torch.randn(s, generator=gen, device=card).to(dtype)
                   for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv),
                             (B, S, H, Dv)))
    before = flash_attention_bwd.launches
    o, lse = flash_attention(q, k, v, return_lse=True)
    assert torch.equal(o, flash_attention(q, k, v))
    _, lse_plain = flash_attention_plain(q, k, v, return_lse=True)
    assert torch.allclose(lse, lse_plain, atol=1e-4, rtol=1e-5)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    assert flash_attention_bwd.launches == before + 2
    want = flash_attention_bwd_plain(*(t.cpu() for t in (q, k, v, o, lse,
                                                         do)))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # no float atomics: the same bits
        w = w.float()
        err = (g.float().cpu() - w).abs()
        assert bool((err <= tol * (max(float(w.abs().max()), 1.0)
                                   + w.abs())).all())


@pytest.mark.parametrize("shape", [(1, 300, 300, 8, 128),
                                   (1, 77, 77, 8, 16),
                                   (1, 200, 333, 8, 64)], ids=str)
def test_attention_bwd_bf16_group_of_eight_one_kv_head_not_causal(card,
                                                                  shape):
    """B9's bf16 route (tensor cores, TMA tiles) at B = 1, Hkv = 1, a
    group of 8 query heads and causal=False, Sq = Sk and not: the same
    allclose as the causal cases, each of dq, dk, dv within
    ``chip_smoke.B9_REL_L2_BF16`` relative L2, and a rerun bit-identical."""
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd, flash_attention_bwd_plain)
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    B, Sq, Sk, H, D = shape
    gen = torch.Generator(device=card).manual_seed(Sq + Sk)
    q, k, v, do = (torch.randn(s, generator=gen, device=card)
                   .to(torch.bfloat16)
                   for s in ((B, Sq, H, D), (B, Sk, 1, D), (B, Sk, 1, D),
                             (B, Sq, H, D)))
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = flash_attention_bwd_plain(
        *(t.cpu() for t in (q, k, v, o, lse, do)), causal=False)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # no float atomics: the same bits
        g, w = g.float().cpu(), w.float()
        assert bool(((g - w).abs() <= 2e-2 * (max(float(w.abs().max()), 1.0)
                                              + w.abs())).all())
        assert float((g - w).norm() / w.norm()) \
            <= chip_smoke.B9_REL_L2_BF16


def test_attention_bwd_bf16_unaligned_inputs_are_copied(card):
    """A bf16 input that is contiguous but starts off a 16-byte boundary
    (which a TMA tensor map refuses) is copied first: the same bits as
    the aligned call."""
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v, do = (torch.randn(s, generator=gen, device=card)
                   .to(torch.bfloat16)
                   for s in ((1, 65, 4, 64), (1, 65, 2, 64), (1, 65, 2, 64),
                             (1, 65, 4, 64)))
    o, lse = flash_attention(q, k, v, return_lse=True)

    def off(t):  # the same values one element into a fresh buffer
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 != 0
        return out

    want = flash_attention_bwd(q, k, v, o, lse, do)
    got = flash_attention_bwd(off(q), off(k), off(v), o, lse, off(do))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_attention_grads_match_the_cpu(card):
    """The card's training attention (B3 forward, B9 backward) against
    autograd through the CPU's plain attention, float32."""
    from repro_torch.models.common import attention
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((2, 96, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64))]
    do = torch.tensor(rng.standard_normal((2, 96, 8, 64)).astype(np.float32))
    grads = {}
    for dev in ("cpu", card):
        ts = [torch.tensor(x, device=dev).requires_grad_() for x in xs]
        attention(*ts, causal=True).backward(do.to(dev))
        grads[str(dev)] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cpu"], grads[str(card)]):
        assert torch.allclose(a, b, atol=1e-4 * float(a.abs().max()),
                              rtol=1e-4)


def test_card_kernels_refuse_to_drop_a_gradient(card):
    """Every card route without a backward raises before any work when
    an input requires grad: decode attention (B4's wrapper) and the raw
    kernel wrappers; ssd_fwd trains through B5 and its backward B10, one
    launch each, with finite gradients."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.gated_matmul import gated_matmul_p
    from repro_torch.models import blocks, registry
    from repro_torch.models.common import decode_attention
    from repro_torch.models.param import init_params, train_params
    cfg = dataclasses.replace(get_arch("mamba2-780m").reduced(), n_layers=1)
    p = train_params(init_params(registry.param_specs(cfg),
                                 torch.Generator(device=card).manual_seed(0),
                                 card))["layers"]["ssd"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((1, 16, cfg.d_model), device=card)
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    xg = x.clone().requires_grad_()
    blocks.ssd_fwd(p, xg, cfg).float().square().mean().backward()
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0
    q = torch.randn((1, 1, 4, 64), device=card, requires_grad=True)
    kc = torch.randn((1, 8, 2, 64), device=card)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        decode_attention(q, kc, kc, 3)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    w = torch.randn((128, 128), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        gated_matmul_p(w, w, torch.ones((1, 1), dtype=torch.int32,
                                        device=card))
    with torch.no_grad():  # serving: no gradient, the kernels run
        blocks.ssd_fwd(p, x, cfg)


def _ssd_bwd_inputs(card, Bz, S, H, P, G, N, dtype, seed, strong=False):
    g = np.random.default_rng(seed)
    x = torch.tensor(g.standard_normal((Bz, S, H, P)), dtype=torch.float32)
    dt = torch.tensor(np.log1p(np.exp(g.standard_normal((Bz, S, H)))),
                      dtype=torch.float32)
    A = -torch.tensor(g.uniform(1.0, 16.0 if strong else 2.0, H),
                      dtype=torch.float32).expand(Bz, H)
    B, C = (torch.tensor(g.standard_normal((Bz, S, G, N)) * 0.3,
                         dtype=torch.float32) for _ in range(2))
    dy = torch.tensor(g.standard_normal((Bz, S, H, P)), dtype=torch.float32)
    x, B, C = (t.to(dtype) for t in (x, B, C))
    return [t.to(card) for t in (x, dt, A, B, C, dy)]


@pytest.mark.parametrize("state", [False, True], ids=["no_dstate",
                                                      "dstate"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 200, 4, 64, 1, 128, False),
                                   (2, 130, 4, 16, 2, 16, True),
                                   (1, 64, 2, 32, 1, 32, False)], ids=str)
def test_ssd_bwd_kernel_matches_plain(card, dtype, shape, state):
    """B10 against autograd through B5's plain version on the CPU copies,
    with and without the final state's gradient (which seeds the
    kernel's reverse state walk): every gradient within 1e-4 of its
    largest value (float32 route and the float32 outputs of the bf16 one;
    dA 1e-3, see chip_smoke.py's B10_SCALED_TOL), bf16 dx / dB / dC
    within 4e-3 relative L2; a second call bit-identical."""
    *dims, strong = shape
    x, dt, A, B, C, dy = _ssd_bwd_inputs(card, *dims, dtype, 3, strong)
    Bz, _, H, P, _, N = dims
    dstate = torch.tensor(np.random.default_rng(4).standard_normal(
        (Bz, H, P, N)), dtype=torch.float32).to(card) if state else None
    before = ssd_scan_bwd.launches
    got = ssd_scan_bwd(x, dt, A, B, C, dy, dstate)
    again = ssd_scan_bwd(x, dt, A, B, C, dy, dstate)
    assert ssd_scan_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ssd_scan_bwd_plain(*(t.cpu().float() if t.dtype == torch.bfloat16
                                else t.cpu() for t in (x, dt, A, B, C, dy)),
                              None if dstate is None else dstate.cpu())
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        a = a.float().cpu()
        if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
            assert float((a - w).norm() / w.norm()) <= 4e-3, name
        else:
            tol = 1e-3 if name == "dA" else 1e-4
            assert float((a - w).abs().max()) <= tol * float(w.abs().max()), \
                name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [
    (2, 300, 4, 2, 64, True, 100, 0), (1, 300, 8, 1, 256, True, None, 70),
    (1, 150, 4, 4, 80, False, None, 0), (1, 257, 4, 2, 80, True, 40, 30)],
    ids=str)
def test_attention_bwd_kernel_under_masks(card, dtype, mask):
    """B9 under B3's masks and at head dims 80 / 256 against its plain
    version on the CPU copies (float32 1e-4 of the largest value; bf16
    relative L2 8e-3, as chip_smoke.py), a second call bit-identical."""
    B, S, H, Hkv, D, causal, window, prefix = mask
    gen = torch.Generator(device=card).manual_seed(S + D)
    q, do = (torch.randn((B, S, H, D), generator=gen, device=card)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device=card)
            .to(dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd, flash_attention_bwd_plain)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_bwd_plain(*(t.cpu() for t in (q, k, v, o, lse,
                                                         do)), **kw)
    for a, w in zip(got, want):
        a, w = a.float().cpu(), w.float()
        if dtype == torch.float32:
            assert float((a - w).abs().max()) <= 1e-4 * max(
                float(w.abs().max()), 1.0)
        else:
            assert float((a - w).norm() / w.norm()) <= 8e-3


def _counted_train_step(device):
    """One reduced qwen2.5-3b train step (2 microbatches, remat "full")
    on ``device`` under a ``CostCounter``: its costs."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.core.costs import CostCounter
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, train_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainState, make_train_step
    cfg = get_arch("qwen2.5-3b").reduced()
    opt = AdamWConfig()
    gen = torch.Generator(device=device).manual_seed(0)
    state = TrainState.create(train_params(init_params(
        registry.param_specs(cfg), gen, device)), opt)
    batch = SyntheticDataset(cfg, ShapeConfig("t", 128, 4, "train"),
                             device=device).batch(0)
    step = make_train_step(cfg, opt, microbatches=2)
    counter = CostCounter(track_memory=False)
    with counter:
        step(state, batch)
    return counter.costs


def test_cost_count_with_kernels_equals_the_plain_count(card):
    """The counter counts a step the same with the kernels launched (the
    card) as through their plain versions (the CPU): each wrapper reports
    its formula and the ops inside it are not counted."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    b3, b9 = flash_attention.launches, flash_attention_bwd.launches
    got = _counted_train_step(card)
    assert (flash_attention.launches - b3, flash_attention_bwd.launches - b9) \
        == (2 * 2 * 2, 2 * 2)
    want = _counted_train_step("cpu")
    assert got.kernels == want.kernels == {"B3": 8, "B9": 4}
    assert abs(got.flops - want.flops) <= 1e-9 * want.flops
    assert got.dots == want.dots


def test_reduced_train_mesh_on_the_card(card):
    """``launch.train.run`` on a one-card (1, 1) mesh: the losses of the
    same run without a mesh, bit for bit."""
    from repro_torch.launch.train import TrainLoopConfig, run
    kw = dict(device="cuda", steps=3, microbatches=2, log_every=100)
    assert run(TrainLoopConfig(mesh="1x1", **kw))["losses"] \
        == run(TrainLoopConfig(**kw))["losses"]


def test_sweep_and_plane_on_a_one_rank_nccl_mesh(card):
    """The power plane's mesh path on the card in a one-rank NCCL world
    (the backend a world with a card for each rank takes): the sharded
    sweep on a (1, 1) mesh equals the unsharded one bit for bit with K1
    and K2 launched, and the row-sharded program plane's executor one
    launch of B7 with the unsharded integers."""
    from repro_torch.core.policies import evaluate_batch
    from repro_torch.kernels.program_exec import program_exec
    from repro_torch.parallel.dist import single_process_world, sweep_mesh
    import torch.distributed as dist
    wls = opgen.paper_suite()[:4]
    grid = KnobGrid(delay_scale=(0.25, 1.0, 4.0), sa_width=(None, 64))
    want = evaluate_batch(wls, ("NPU-B", "NPU-E"), POLICIES, grid,
                          device=card)
    plane_want = pp.program_plane_batch(wls, ("NPU-B",), grid.product(),
                                        device=card)
    with single_process_world("cuda"):
        assert dist.get_backend() == "nccl"
        mesh = sweep_mesh(1, 1, device_type="cuda")
        k1, k2 = sa_occupancy.launches, segment_sum.launches
        got = evaluate_batch(wls, ("NPU-B", "NPU-E"), POLICIES, grid,
                             device=card, mesh=mesh)
        assert sa_occupancy.launches > k1 and segment_sum.launches > k2
        b7 = program_exec.launches
        plane = pp.program_plane_batch(wls, ("NPU-B",), grid.product(),
                                       device=card, mesh=mesh)
        assert program_exec.launches == b7 + 1
    assert not dist.is_initialized()
    assert got.records() == want.records()
    for f in ("cycles", "stall_cycles", "n_events"):
        assert np.array_equal(getattr(plane, f), getattr(plane_want, f)), f
    assert plane.records() == plane_want.records()


# ------------------------------------------------ B3 / B9 at a query offset
# and at the reduced MLA's head dims (24, 16)
OFFSET_CASES = [  # (B, Sq, Sk, H, Hkv, D, Dv, mask)
    (2, 300, 300, 4, 4, 24, 16, dict()),
    (1, 130, 130, 8, 8, 24, 16, dict(causal=False)),
    (1, 1, 1, 8, 8, 24, 16, dict()),
    (2, 64, 200, 4, 2, 64, 64, dict(q_offset=136)),
    (1, 100, 1101, 4, 1, 128, 128, dict(q_offset=1000, window=300)),
    (1, 77, 300, 8, 2, 80, 80, dict(q_offset=1, prefix_len=90)),
    (1, 65, 129, 4, 4, 24, 16, dict(q_offset=64, window=40)),
    (1, 200, 300, 4, 2, 64, 64, dict(q_offset=64, causal=False)),
    (1, 300, 1400, 4, 4, 256, 256, dict(q_offset=1000, window=64,
                                        prefix_len=100))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_attention_at_an_offset_and_mla_dims_matches_plain(card, dtype,
                                                           case):
    """B3 at a query offset (query row ``i`` at position ``q_offset + i``)
    and at (24, 16) against its plain version, the key tiles each query
    tile loaded equal to ``live_tiles``; B9 on B3's outputs against its
    plain version on the CPU copies (float32 ``1e-4 (max(max|plain|, 1)
    + |plain|)``, bf16 relative L2 ``chip_smoke.B9_REL_L2_BF16``), dq and
    dk at q's and k's 24 columns, and a rerun bit-identical."""
    from repro_torch.kernels.flash_attention import live_tiles
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd, flash_attention_bwd_plain)
    B, Sq, Sk, H, Hkv, D, Dv, mask = case
    q, k, v, do = _attn_inputs(card, dtype, Sq + Sk, (B, Sq, H, D),
                               (B, Sk, Hkv, D), (B, Sk, Hkv, Dv),
                               (B, Sq, H, Dv))
    tiles = torch.zeros((B, H, -(-Sq // 64)), dtype=torch.int32,
                        device=card)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    o, lse = flash_attention(q, k, v, return_lse=True, tiles_loaded=tiles,
                             **mask)
    want = flash_attention_plain(q, k, v, **mask)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(tiles, live_tiles(Sq, Sk, device=card, **mask)
                       .expand(B, H, -1))
    got = flash_attention_bwd(q, k, v, o, lse, do, **mask)
    again = flash_attention_bwd(q, k, v, o, lse, do, **mask)
    assert (flash_attention.launches, flash_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 2)
    plain = flash_attention_bwd_plain(*(t.cpu() for t in (q, k, v, o, lse,
                                                          do)), **mask)
    for g, a, w, t in zip(got, again, plain, (q, k, v)):
        assert g.shape == t.shape and torch.equal(g, a)
        g, w = g.float().cpu(), w.float()
        if dtype == torch.float32:
            assert bool(((g - w).abs() <= 1e-4 * (
                max(float(w.abs().max()), 1.0) + w.abs())).all())
        elif Sq > 1:
            assert float((g - w).norm() / w.norm().clamp_min(1e-30)) \
                <= 8e-3
