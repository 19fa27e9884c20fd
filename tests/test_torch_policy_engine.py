"""The port's host policy engines and spatial SA-gating model against the
JAX package's.

``evaluate``, ``evaluate_reference``, the scalar ``sa_gating`` functions
and ``sweep_reference`` are host numpy in both packages, written the same
way, so they are held to equality on the paper suite and on the
randomized shapes of ``tests/test_sa_occupancy.py`` and
``tests/test_policy_engine_equiv.py``. The two port engines are held to
each other at the reference's own 1e-9 relative, and so are the batched
plane (``evaluate_all``, ``sweep`` on the CPU) and the loop oracle.
"""
import importlib
import math
from dataclasses import asdict, replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import opgen as ref_opgen  # noqa: E402
from repro.core import policies as ref_pol  # noqa: E402
from repro.core import sa_gating as ref_sa  # noqa: E402
from repro.core.sweep import sweep_reference as ref_sweep_reference  # noqa
from repro_torch import core as port_core  # noqa: E402
from repro_torch.core import opgen as port_opgen  # noqa: E402
from repro_torch.core import policies as port_pol  # noqa: E402
from repro_torch.core import sa_gating as port_sa  # noqa: E402
from repro_torch.core import session as port_session  # noqa: E402
from repro_torch.core.hw import NPUS, get_npu  # noqa: E402
from repro_torch.core.power import COMPONENTS  # noqa: E402

port_sweep = importlib.import_module("repro_torch.core.sweep")
RTOL = 1e-9
POLICIES = port_pol.POLICIES
KNOB_OVERRIDES = [
    dict(delay_scale=0.5),
    dict(delay_scale=4.0),
    dict(leak_off_logic=0.2, leak_sram_sleep=0.4, leak_sram_off=0.02),
    dict(leak_off_logic=0.0, delay_scale=2.0),
]
SUITE = port_opgen.paper_suite()
REF_SUITE = ref_opgen.paper_suite()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1e-30, abs(a), abs(b))


def _fields(rep) -> dict:
    return {"workload": rep.workload, "policy": rep.policy, "npu": rep.npu,
            "runtime_s": rep.runtime_s, "setpm_count": rep.setpm_count,
            **{f"{f}.{c}": getattr(rep, f)[c] for c in COMPONENTS
               for f in ("static_j", "dynamic_j", "wake_events", "gated_s",
                         "setpm_by")}}


def _assert_equal(port, ref, ctx):
    assert _fields(port) == _fields(ref), ctx


def _assert_reports_match(a, b, ctx):
    fa, fb = _fields(a), _fields(b)
    for k, va in fa.items():
        if isinstance(va, str):
            assert va == fb[k], (ctx, k)
        else:
            assert _rel(va, fb[k]) <= RTOL, (ctx, k, va, fb[k])
    assert _rel(a.total_j, b.total_j) <= RTOL, ctx


def test_the_suites_are_the_same():
    assert [w.name for w in SUITE] == [w.name for w in REF_SUITE]
    assert [len(w.ops) for w in SUITE] == [len(w.ops) for w in REF_SUITE]


@pytest.mark.parametrize("npu", sorted(NPUS))
@pytest.mark.parametrize("policy", POLICIES)
def test_engines_equal_the_jax_packages(npu, policy):
    for wl, rwl in zip(SUITE, REF_SUITE):
        ctx = f"{wl.name}/{policy}/{npu}"
        _assert_equal(port_pol.evaluate(wl, npu, policy),
                      ref_pol.evaluate(rwl, npu, policy), ctx)
        _assert_equal(port_pol.evaluate_reference(wl, npu, policy),
                      ref_pol.evaluate_reference(rwl, npu, policy), ctx)


@pytest.mark.parametrize("npu", sorted(NPUS))
@pytest.mark.parametrize("policy", POLICIES)
def test_columnar_engine_matches_scalar_oracle(npu, policy):
    for wl in SUITE:
        _assert_reports_match(port_pol.evaluate(wl, npu, policy),
                              port_pol.evaluate_reference(wl, npu, policy),
                              f"{wl.name}/{policy}/{npu}")


@pytest.mark.parametrize("kw", KNOB_OVERRIDES,
                         ids=[str(k) for k in KNOB_OVERRIDES])
def test_knob_overrides(kw):
    pk, rk = port_pol.PolicyKnobs(**kw), ref_pol.PolicyKnobs(**kw)
    for wl, rwl in zip(SUITE[::4], REF_SUITE[::4]):
        for policy in POLICIES:
            ctx = f"{wl.name}/{policy}/{kw}"
            got = port_pol.evaluate(wl, "NPU-D", policy, pk)
            _assert_equal(got, ref_pol.evaluate(rwl, "NPU-D", policy, rk),
                          ctx)
            oracle = port_pol.evaluate_reference(wl, "NPU-D", policy, pk)
            _assert_equal(oracle, ref_pol.evaluate_reference(
                rwl, "NPU-D", policy, rk), ctx)
            _assert_reports_match(got, oracle, ctx)


def test_op_times_equal_per_op():
    npu, rnpu = get_npu("NPU-C"), ref_pol.get_npu("NPU-C")
    for op, rop in zip(SUITE[5].ops, REF_SUITE[5].ops):
        assert port_pol.op_times(op, npu) == ref_pol.op_times(rop, rnpu)


@pytest.mark.parametrize("mode", ["none", "hw", "sw", "ideal"])
def test_gated_idle_energy_scalar_and_vector(mode):
    g = np.random.default_rng(4)
    gaps = np.concatenate([[0.0, -1.0, 1e-9, 2e-7], g.random(50) * 1e-5])
    kw = dict(mode=mode, bet_s=3e-7, delay_s=5e-8, window_s=1e-7, leak=0.05)
    got = port_pol._gated_idle_energy_vec(gaps, 2.5, **kw)
    want = ref_pol._gated_idle_energy_vec(gaps, 2.5, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for i, gap in enumerate(gaps):
        one = port_pol._gated_idle_energy(float(gap), 2.5, **kw)
        assert one == ref_pol._gated_idle_energy(float(gap), 2.5, **kw)
        for k in range(5):
            assert math.isclose(one[k], got[k][i], rel_tol=1e-12,
                                abs_tol=1e-300)


def test_merged_gaps_equal():
    g = np.random.default_rng(6)
    for n in (0, 1, 7, 300):
        active = g.random(n) > 0.6
        idle = np.where(active, 0.0, g.random(n))
        np.testing.assert_array_equal(port_pol._merged_gaps(active, idle),
                                      ref_pol._merged_gaps(active, idle))


# ---- the spatial SA-gating model ------------------------------------------

def _shapes(seed, n, extra):
    rng = np.random.default_rng(seed)
    Ms = np.concatenate([rng.integers(1, 5000, n), extra[0]])
    Ks = np.concatenate([rng.integers(1, 3000, n), extra[1]])
    Ns = np.concatenate([rng.integers(1, 3000, n), extra[2]])
    return Ms, Ks, Ns


SHAPE_SETS = {
    # tests/test_sa_occupancy.py::test_xp_matches_scalar_randomized_all_widths
    "sa_occupancy": (7, 300, ([1, 131072], [1, 16384], [1, 8016]),
                     (1, 4, 8, 128, 256)),
    # tests/test_policy_engine_equiv.py::test_gating_stats_batch_matches...
    "policy_engine": (0, 200, ([1, 1, 8, 131072], [1, 128, 64, 16384],
                               [1, 128, 129, 8016]), (8, 128, 256)),
}


@pytest.mark.parametrize("name", sorted(SHAPE_SETS))
@pytest.mark.parametrize("wlc", [None, 0])
def test_gating_stats_equal_bit_for_bit(name, wlc):
    seed, n, extra, widths = SHAPE_SETS[name]
    Ms, Ks, Ns = _shapes(seed, n, extra)
    for saw in widths:
        got = port_sa.gating_stats_batch_reference(Ms, Ks, Ns, saw, wlc)
        want = ref_sa.gating_stats_batch_reference(Ms, Ks, Ns, saw, wlc)
        batch = port_sa.gating_stats_batch(Ms, Ks, Ns, saw, wlc)
        for f in ("duration_cycles", "frac_on", "frac_w_on", "frac_off",
                  "wake_events"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            np.testing.assert_array_equal(getattr(batch, f), getattr(got, f))
        for M, K, N in list(zip(Ms, Ks, Ns))[::37]:
            args = (int(M), int(K), int(N), saw, wlc)
            st = port_sa.gating_stats(*args)
            assert st == port_sa.gating_stats_reference(*args)
            assert asdict(st) == asdict(ref_sa.gating_stats_reference(*args))
            assert st.active_pe_fraction == st.frac_on
            assert port_sa.spatial_efficiency(*args[:4]) == \
                ref_sa.spatial_efficiency(*args[:4])


@pytest.mark.parametrize("seed", [1, 3])
def test_simulate_pe_grid_equal_bit_for_bit(seed):
    """The randomized tiny grids of the two reference test files."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        saw = int(rng.choice([2, 4, 8, 12]))
        M = int(rng.integers(1, 3 * saw))
        K = int(rng.integers(1, saw + 1))
        N = int(rng.integers(1, saw + 1))
        got = port_sa.simulate_pe_grid(M, K, N, saw)
        assert got == port_sa.simulate_pe_grid_reference(M, K, N, saw)
        assert got == ref_sa.simulate_pe_grid(M, K, N, saw)
        tot = got["total"]
        st = port_sa.gating_stats_reference(M, K, N, saw, 0)
        assert math.isclose(st.frac_on, got["on"] / tot, rel_tol=RTOL,
                            abs_tol=1e-15)


def test_simulate_pe_grid_large_grid_matches_closed_form():
    sim = port_sa.simulate_pe_grid(512, 100, 64, 128)
    assert sim == ref_sa.simulate_pe_grid(512, 100, 64, 128)
    st = port_sa.gating_stats(512, 100, 64, 128, weight_load_cycles=0)
    for k in ("on", "w_on", "off"):
        assert math.isclose(getattr(st, f"frac_{k}"), sim[k] / sim["total"],
                            rel_tol=RTOL)


def test_prefix_on_bitmap_equal():
    rng = np.random.default_rng(2)
    for w in (1, 2, 7, 128):
        for _ in range(10):
            nz = rng.random(w) > 0.7
            got = port_sa.prefix_on_bitmap(nz)
            np.testing.assert_array_equal(got, ref_sa.prefix_on_bitmap(nz))
            # ON iff it or anything after it is nonzero (paper Fig 12)
            want = np.array([nz[i:].any() for i in range(w)])
            np.testing.assert_array_equal(got, want)


def test_gating_cache_resizable_and_reference_uncached():
    prev = port_sa.set_gating_cache_size(4)
    try:
        assert port_sa.gating_cache_info().maxsize == 4
        for m in range(1, 9):
            port_sa.gating_stats(m, 64, 64, 128)
        assert port_sa.gating_cache_info().currsize <= 4
        before = port_sa.gating_cache_info()
        st = port_sa.gating_stats_reference(12345, 67, 89, 128)
        ref = port_sa.gating_stats_batch_reference([12345], [67], [89], 128)
        after = port_sa.gating_cache_info()
        assert (before.hits, before.misses) == (after.hits, after.misses)
        assert ref.frac_on[0] == st.frac_on
        assert port_sa.gating_stats(12345, 67, 89, 128) == st
    finally:
        port_sa.set_gating_cache_size(prev)
    assert port_sa.gating_cache_info().maxsize == prev == \
        port_sa._DEFAULT_CACHE_SIZE == ref_sa._DEFAULT_CACHE_SIZE


def test_session_scopes_the_gating_cache():
    base = port_sa.gating_cache_info().maxsize
    assert port_session.resolve("gating_cache_size") is None
    with port_session.SweepSession(gating_cache_size=8) as outer:
        assert port_sa.gating_cache_info().maxsize == 8
        assert port_session.resolve("gating_cache_size") == 8
        with port_session.SweepSession(device="cpu"):  # inherits the size
            assert port_sa.gating_cache_info().maxsize == 8
            assert port_session.current() == {"device": "cpu",
                                              "gating_cache_size": 8,
                                              "guard": None}
        with port_session.SweepSession(gating_cache_size=None):
            assert port_sa.gating_cache_info().maxsize is None
        assert port_sa.gating_cache_info().maxsize == 8
        assert "gating_cache_size=8" in repr(outer)
    assert port_sa.gating_cache_info().maxsize == base
    with pytest.raises(RuntimeError):
        with port_session.SweepSession(gating_cache_size=2):
            raise RuntimeError("restored on the way out")
    assert port_sa.gating_cache_info().maxsize == base


# ---- trace_times, sweep_reference, evaluate_all ----------------------------

def test_trace_times_cached_per_npu_identity():
    wl = port_opgen.llm_workload("llama3-8b", "prefill", batch=4, n_chips=1)
    tr = port_opgen.compile_trace(wl)
    tm_d = port_pol.trace_times(tr, get_npu("NPU-D"))
    assert port_pol.trace_times(tr, get_npu("NPU-D")) is tm_d
    assert port_pol.trace_times(tr, get_npu("NPU-E")) is not tm_d
    # a replace()d spec reusing the registry name must not hit the cache
    fat = replace(get_npu("NPU-D"), sa_width=256)
    tm_fat = port_pol.trace_times(tr, fat)
    assert tm_fat is not tm_d
    _assert_reports_match(port_pol.evaluate(wl, fat, "NoPG"),
                          port_pol.evaluate_reference(wl, fat, "NoPG"),
                          "modified-spec")
    rtr = ref_opgen.compile_trace(ref_opgen.llm_workload(
        "llama3-8b", "prefill", batch=4, n_chips=1))
    want = ref_pol.trace_times(rtr, ref_pol.get_npu("NPU-D"))
    assert sorted(want) == sorted(tm_d)
    for k in want:
        np.testing.assert_array_equal(tm_d[k], want[k])


def _assert_records(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k, va in a.items():
            if isinstance(va, (str, type(None))) or k == "knob_idx":
                assert va == b[k], k
            else:
                assert _rel(va, b[k]) <= RTOL, (k, va, b[k])


def test_sweep_reference_matches_the_batched_sweep_and_jax():
    grid = [port_pol.PolicyKnobs(), port_pol.PolicyKnobs(delay_scale=2.0),
            port_pol.PolicyKnobs(sa_width=64)]
    rgrid = [ref_pol.PolicyKnobs(**asdict(k)) for k in grid]
    npus = ("NPU-A", "NPU-D")
    ref_recs = port_core.sweep_reference(SUITE[10:13], npus, POLICIES, grid)
    assert len(ref_recs) == 3 * 2 * 5 * 3
    _assert_records(port_sweep.sweep(SUITE[10:13], npus, POLICIES, grid,
                                     device="cpu"), ref_recs)
    _assert_records(ref_recs, ref_sweep_reference(REF_SUITE[10:13], npus,
                                                  POLICIES, rgrid))
    assert port_sweep.sweep_reference(SUITE[0])[0]["workload"] == \
        SUITE[0].name


def test_evaluate_all_on_the_cpu_matches_evaluate():
    wl = SUITE[8]
    knobs = port_pol.PolicyKnobs(delay_scale=2.0)
    reps = port_core.evaluate_all(wl, "NPU-C", knobs, device="cpu")
    assert list(reps) == list(POLICIES)
    for p, got in reps.items():
        want = port_core.evaluate(wl, "NPU-C", p, knobs)
        assert got.workload == want.workload and got.npu == want.npu
        _assert_reports_match(got, want, p)


def test_savings_vs_nopg():
    reps = {p: port_pol.evaluate(SUITE[2], "NPU-D", p) for p in POLICIES}
    got = port_core.savings_vs_nopg(reps)
    rreps = {p: ref_pol.evaluate(REF_SUITE[2], "NPU-D", p) for p in POLICIES}
    assert got == ref_pol.savings_vs_nopg(rreps)
    assert got["NoPG"] == 0.0
    assert 0.0 < got["ReGate-Base"] < got["ReGate-Full"] <= got["Ideal"] < 1


def test_evaluate_all_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_core.evaluate_all(SUITE[0], "NPU-D")
