"""The port's CUDA kernels on a card (marker ``gpu``).

These need an NVIDIA GPU and ``nvcc``; without a card they skip. Run
them on a machine that has one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at the sweep's and the
serving paths' full size.
"""
import importlib
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
