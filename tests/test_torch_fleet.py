"""The port's fleet serving plane (``repro_torch.core.fleet``) against
the reference's ``repro.core.fleet``.

Each case builds the same scenario in both packages and runs the port
on ``device="cpu"`` (every epoch's ``evaluate_batch`` through the
kernels' plain versions) and the reference on ``backend="numpy"``. The
arrival generators, allocation, severity ladder and governor are host
numpy in both, so arrival counts, severity indices, chosen and deployed
knobs, retune flags and chip allocations must be identical; every float
of the report (energies, runtimes, backlog and shed volumes) is held to
≤1e-9 relative, the sweep's parity bar. Then the case's own invariant is
asserted on the port's report. Mirrors ``tests/test_fleet.py`` case for
case, and the fleet part of ``tests/test_validation.py``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import carbon as r_carbon  # noqa: E402
from repro.core import fleet as r_fleet  # noqa: E402
from repro.core import opgen as r_opgen  # noqa: E402
from repro.core import policies as r_pol  # noqa: E402
from repro.core.sweep import sweep_grid as r_sweep_grid  # noqa: E402
from repro_torch.core import carbon as p_carbon  # noqa: E402
from repro_torch.core import faults as p_faults  # noqa: E402
from repro_torch.core import fleet as p_fleet  # noqa: E402
from repro_torch.core import opgen as p_opgen  # noqa: E402
from repro_torch.core import policies as p_pol  # noqa: E402
from repro_torch.core.sweep import sweep_grid as p_sweep_grid  # noqa: E402

from _torch_parity import RTOL, assert_fleet_reports_match, rel  # noqa: E402

REF = (r_fleet, r_opgen, r_pol)
PORT = (p_fleet, p_opgen, p_pol)
GRID_KW = dict(window_scale=(0.5, 1.0, 2.0))


def _scenario(pkg, n_chips=48, rate=4.0, rank_rate=1.0, duration_s=3600.0,
              epoch_s=600.0, severity_levels=(0.0, 1.0), seed=11):
    fl, og, _ = pkg
    decode = fl.WorkloadClass(
        "decode", og.llm_workload("llama3-8b", "decode", batch=8),
        fl.ArrivalSpec("diurnal", rate_rps=rate, peak_frac=0.8,
                       period_s=duration_s),
        requests_per_invocation=8)
    rank = fl.WorkloadClass(
        "rank", og.dlrm_workload("S"),
        fl.ArrivalSpec("bursty", rate_rps=rank_rate, burst_prob=0.3,
                       burst_factor=6.0),
        requests_per_invocation=1024)
    return fl.FleetScenario(
        classes=(decode, rank), n_chips=n_chips, npu="NPU-D",
        policies=("NoPG", "ReGate-Full"), duration_s=duration_s,
        epoch_s=epoch_s, slo_relax=1.15, seed=seed,
        severity_levels=severity_levels)


def run_both(grid_kw=GRID_KW, knobs=None, scenario=_scenario, **kw):
    """The scenario through the reference (numpy) and the port (CPU);
    their reports compared, the port's returned."""
    reports = []
    for pkg in (REF, PORT):
        fl, _, pol = pkg
        grid = pol.KnobGrid(**grid_kw) if knobs is None \
            else knobs(pol)
        extra = {"backend": "numpy"} if pkg is REF else {"device": "cpu"}
        reports.append(fl.sweep_fleet(scenario(pkg, **kw), grid, **extra))
    ref, got = reports
    assert_fleet_reports_match(ref, got)
    for a, b in zip(ref.records, got.records):
        assert (a["backlog_inv"] == 0.0) == (b["backlog_inv"] == 0.0)
        assert (a["shed_inv"] == 0.0) == (b["shed_inv"] == 0.0)
    return got


# --------------------------------------------------------------------------
# arrival generators
# --------------------------------------------------------------------------

def test_arrivals_deterministic_per_stream():
    for kind, kw in (("poisson", dict(rate_rps=7.0)),
                     ("diurnal", dict(rate_rps=7.0, peak_frac=2.0,
                                      period_s=720.0)),
                     ("bursty", dict(rate_rps=7.0, burst_prob=0.4,
                                     burst_factor=8.0))):
        spec = p_fleet.ArrivalSpec(kind, **kw)
        a = p_fleet.arrival_counts(spec, 12, 60.0,
                                   np.random.default_rng(5))
        b = p_fleet.arrival_counts(spec, 12, 60.0,
                                   np.random.default_rng(5))
        assert (a == b).all() and a.dtype == np.int64, kind
        want = r_fleet.arrival_counts(r_fleet.ArrivalSpec(kind, **kw), 12,
                                      60.0, np.random.default_rng(5))
        assert np.array_equal(a, want), kind
        c = p_fleet.arrival_counts(spec, 12, 60.0,
                                   np.random.default_rng(6))
        assert (a != c).any(), kind


def test_class_streams_isolated():
    rank = []
    for rate in (4.0, 32.0):
        rep = run_both(grid_kw={}, rate=rate)
        rank.append([r["requests"] for r in rep.records
                     if r["class"] == "rank" and r["policy"] == "NoPG"])
    assert rank[0] == rank[1]


def test_stochastic_kinds_require_generator():
    with pytest.raises(TypeError, match="explicit numpy.random"):
        p_fleet.arrival_counts(p_fleet.ArrivalSpec("poisson"), 4, 60.0)
    spec = p_fleet.ArrivalSpec("replay", times_s=(0.0, 10.0))
    assert p_fleet.arrival_counts(spec, 4, 60.0).tolist() == [1, 1, 0, 0]


def test_diurnal_rate_shape():
    for kind, kw, n, dt in (
            ("diurnal", dict(rate_rps=10.0, peak_frac=1.5, period_s=240.0),
             8, 30.0),
            ("diurnal", dict(rate_rps=3.0, peak_frac=0.9, period_s=86400.0,
                             phase_s=-21600.0), 96, 900.0),
            ("poisson", dict(rate_rps=3.0), 5, 60.0)):
        got = p_fleet.epoch_rates(p_fleet.ArrivalSpec(kind, **kw), n, dt)
        assert np.array_equal(
            got, r_fleet.epoch_rates(r_fleet.ArrivalSpec(kind, **kw), n,
                                     dt))
    rates = p_fleet.epoch_rates(p_fleet.ArrivalSpec(
        "diurnal", rate_rps=10.0, peak_frac=1.5, period_s=240.0), 8, 30.0)
    assert rates.shape == (8,) and (rates >= 0.0).all()
    assert rates.min() == 0.0 and rates.max() > 10.0


def test_replay_binning_rule():
    t = np.array([0.0, 5.0, 10.0, 15.0, 35.0, 40.0])
    counts = p_fleet.bin_requests(t, 4, 10.0)
    assert counts.tolist() == [1, 2, 1, 2]
    assert np.array_equal(counts, r_fleet.bin_requests(t, 4, 10.0))
    with pytest.raises(ValueError, match="finite"):
        p_fleet.bin_requests(np.array([-1.0]), 4, 10.0)
    with pytest.raises(ValueError, match="exceed"):
        p_fleet.bin_requests(np.array([41.0]), 4, 10.0)


def test_replay_binning_surfaces_clamped():
    times = np.array([0.0, 5.0, 10.0, 15.0, 35.0, 40.0])
    for t, n in ((times, 4), (np.array([30.0]), 4), (np.array([]), 4),
                 (np.arange(0.0, 100.0, 3.7), 10)):
        got = p_fleet.bin_requests(t, n, 10.0, with_clamped=True)
        want = r_fleet.bin_requests(t, n, 10.0, with_clamped=True)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    counts, clamped = p_fleet.bin_requests(times, 4, 10.0,
                                           with_clamped=True)
    assert counts.tolist() == [1, 2, 1, 2] and clamped == 2


def test_arrival_spec_validation():
    for kind, kw, field in (("weibull", {}, "unknown arrival kind"),
                            ("replay", {}, "times_s"),
                            ("poisson", dict(rate_rps=-1.0), "rate_rps"),
                            ("bursty", dict(burst_factor=0.5),
                             "burst_factor"),
                            ("diurnal", dict(period_s=0.0), "period_s")):
        for m in (r_fleet, p_fleet):
            with pytest.raises(ValueError, match=field):
                m.ArrivalSpec(kind, **kw)


# --------------------------------------------------------------------------
# chip allocation
# --------------------------------------------------------------------------

def test_allocate_chips_no_starvation():
    d = np.array([1e4, 1e-3, 0.0])
    a = p_fleet._allocate_chips(100, d)
    assert a.sum() == 100 and a[1] >= 1 and a[2] == 0
    assert p_fleet._allocate_chips(1, d).tolist() == [1, 0, 0]
    assert p_fleet._allocate_chips(10, np.zeros(3)).sum() == 0
    assert p_fleet._allocate_chips(30, np.array([2.0, 1.0])).tolist() \
        == [20, 10]
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 64, 4096):
        dem = rng.uniform(0.0, 1e3, 5) * (rng.random(5) < 0.7)
        assert np.array_equal(p_fleet._allocate_chips(n, dem),
                              r_fleet._allocate_chips(n, dem))


# --------------------------------------------------------------------------
# the simulator: determinism, equivalence, governor, carbon
# --------------------------------------------------------------------------

def test_report_bit_identical_under_seed():
    a = run_both()
    b = p_fleet.sweep_fleet(_scenario(PORT), p_pol.KnobGrid(**GRID_KW),
                            device="cpu")
    assert a.to_dict() == b.to_dict()
    c = run_both(seed=12)
    assert c.requests_total != a.requests_total


def test_requests_total_matches_generators():
    sc = _scenario(PORT)
    total = 0
    for ci, cls in enumerate(sc.classes):
        rng = np.random.default_rng((sc.seed, ci))
        total += int(p_fleet.arrival_counts(cls.arrivals, sc.n_epochs,
                                            sc.epoch_s, rng).sum())
    assert run_both().requests_total == total


def test_epoch_records_match_direct_sweep():
    """Each epoch is ONE batched call: the port's epoch inputs replayed
    through the port's ``sweep_grid`` on the CPU reproduce its records,
    and the epoch inputs are the reference's, trace for trace."""
    kw = dict(duration_s=1800.0, epoch_s=600.0)
    ref = r_fleet.sweep_fleet(_scenario(REF, **kw), r_pol.KnobGrid(**GRID_KW),
                              keep_epoch_inputs=True)
    rep = p_fleet.sweep_fleet(_scenario(PORT, **kw),
                              p_pol.KnobGrid(**GRID_KW),
                              keep_epoch_inputs=True, device="cpu")
    assert_fleet_reports_match(ref, rep)
    assert len(rep.epoch_inputs) == rep.n_epochs
    for e, ((wls, sev), (rwls, rsev)) in enumerate(
            zip(rep.epoch_inputs, ref.epoch_inputs)):
        assert sev == rsev
        assert [w.name for w in wls] == [w.name for w in rwls]
        for w, rw in zip(wls, rwls):
            assert [(o.name, o.flops_sa, o.flops_vu, o.bytes_hbm,
                     o.bytes_ici, o.count) for o in w.ops] \
                == [(o.name, o.flops_sa, o.flops_vu, o.bytes_hbm,
                     o.bytes_ici, o.count) for o in rw.ops]
        direct = p_sweep_grid(wls, npus=(rep.npu,), policies=rep.policies,
                              device="cpu", **GRID_KW)
        rdirect = r_sweep_grid(rwls, npus=(ref.npu,),
                               policies=ref.policies, **GRID_KW)
        by_cell = {(r["workload"], r["policy"], r["knob_idx"]): r
                   for r in direct}
        for a, b in zip(direct, rdirect):
            assert rel(a["total_j"], b["total_j"]) <= RTOL
        frecs = [r for r in rep.records if r["epoch"] == e]
        assert len(frecs) == 2 * len(rep.policies)
        for fr in frecs:
            assert fr["severity"] == sev
            dr = by_cell[(fr["workload"], fr["policy"], fr["knob_idx"])]
            assert rel(fr["runtime_s"], dr["runtime_s"]) <= RTOL
            assert rel(fr["inv_total_j"], dr["total_j"]) <= RTOL


def test_governor_never_violates_when_feasible():
    rep = run_both(n_chips=2, rate=650.0)
    assert all(not r["slo_violated"] for r in rep.records
               if r["feasible_exists"])
    assert any(r["slo_violated"] for r in rep.records)
    assert all(0 <= r["knob_idx"] < 3 for r in rep.records)
    assert all(not r["feasible_exists"] for r in rep.records
               if r["slo_violated"])
    for r in rep.records:
        assert r["served_inv"] <= r["demand_inv"] + 1e-12
        assert rel(r["backlog_inv"],
                   r["demand_inv"] - r["served_inv"]) <= 1e-9 \
            or abs(r["backlog_inv"]
                   - (r["demand_inv"] - r["served_inv"])) <= 1e-12


def _pressure_scenario(pkg):
    fl, og, _ = pkg
    decode = fl.WorkloadClass(
        "decode", og.llm_workload("llama3-8b", "decode", batch=8),
        fl.ArrivalSpec("diurnal", rate_rps=8.0, peak_frac=0.8,
                       period_s=3600.0),
        requests_per_invocation=8)
    rank = fl.WorkloadClass(
        "rank", og.dlrm_workload("M"),
        fl.ArrivalSpec("poisson", rate_rps=2.0),
        requests_per_invocation=1024)
    return fl.FleetScenario(
        classes=(decode, rank), n_chips=48, npu="NPU-D",
        policies=("NoPG", "ReGate-Full"), duration_s=3600.0,
        epoch_s=600.0, slo_relax=1.2, seed=2,
        severity_levels=(0.0, 0.5, 1.0))


def test_governor_retunes_under_pressure():
    rep = run_both(grid_kw=dict(window_scale=(0.5, 1.0, 2.0),
                                delay_scale=(1.0, 2.0)),
                   scenario=lambda pkg: _pressure_scenario(pkg))
    retuned = [r for r in rep.records if r["retuned"]]
    assert retuned, "scenario failed to trigger any governor retune"
    for r in retuned:
        assert r["knob_idx"] != r["deployed_knob_idx"]
    for s in rep.summary:
        assert s["retunes"] == sum(1 for r in rep.records
                                   if r["policy"] == s["policy"]
                                   and r["retuned"])


def test_carbon_rollup_reconciles():
    rep = run_both()
    for s in rep.summary:
        pol = s["policy"]
        recs = [r for r in rep.records if r["policy"] == pol]
        eps = [x for x in rep.epoch_summary if x["policy"] == pol]
        direct = math.fsum(r["total_j"] for r in recs) \
            + math.fsum(x["unallocated_idle_j"] for x in eps)
        assert rel(s["total_j"], direct) <= RTOL
        assert rel(s["busy_j"] + s["idle_j"], s["total_j"]) <= RTOL
        kwh = s["total_j"] / 3.6e6
        assert rel(s["chip_kwh"], kwh) <= RTOL
        assert rel(s["facility_kwh"], kwh * p_carbon.PUE) <= RTOL
        assert rel(s["co2_kg"],
                   kwh * p_carbon.PUE * p_carbon.CARBON_INTENSITY) <= RTOL
        assert rel(s["cost_usd"],
                   kwh * p_carbon.PUE * p_carbon.USD_PER_KWH) <= RTOL
        ru = rep.rollup(pol)
        assert ru.chip_kwh == s["chip_kwh"] and ru.cost_usd == s["cost_usd"]
        assert dataclasses.asdict(ru) \
            == dataclasses.asdict(r_carbon.fleet_rollup(s["total_j"]))
        assert rel(math.fsum(x["total_j"] for x in eps),
                   s["total_j"]) <= RTOL
    assert rep.policy_summary("ReGate-Full")["total_j"] \
        < rep.policy_summary("NoPG")["total_j"]
    for bad in (float("nan"), -1.0):
        with pytest.raises(ValueError):
            p_carbon.fleet_rollup(bad)


def test_knob_grid_and_flat_tuple_agree():
    kw = dict(duration_s=1800.0, epoch_s=600.0)
    a = run_both(**kw)
    b = run_both(knobs=lambda pol: tuple(pol.KnobGrid(**GRID_KW).product()),
                 **kw)
    assert a.records == b.records and a.summary == b.summary
    single = run_both(grid_kw={}, **kw)
    assert all(r["knob_idx"] == 0 for r in single.records)
    assert all(r["window_scale"] == 1.0 for r in single.records)


def test_severity_tracks_demand():
    rep = run_both()
    assert set(rep.severity_by_epoch) <= {0.0, 1.0}
    counts = np.array([r["requests"] for r in rep.records
                       if r["policy"] == rep.policies[0]
                       and r["class"] == "decode"])
    assert counts.shape == (rep.n_epochs,)
    demand = np.array([sum(r["requests"] for r in rep.records
                           if r["policy"] == rep.policies[0]
                           and r["epoch"] == e)
                       for e in range(rep.n_epochs)], np.float64)
    assert np.array_equal(p_fleet._severity_index(demand, 2),
                          r_fleet._severity_index(demand, 2))
    flat = run_both(severity_levels=(0.5,))
    assert set(flat.severity_by_epoch) == {0.5}


def test_scenario_validation():
    for m, og in ((r_fleet, r_opgen), (p_fleet, p_opgen)):
        wl = og.llm_workload("llama3-8b", "decode", batch=8)
        cls = m.WorkloadClass("a", wl, m.ArrivalSpec("poisson"))
        for kw, field in ((dict(classes=(cls, cls)),
                           "duplicate class names"),
                          (dict(classes=()), "at least one class"),
                          (dict(classes=(cls,), epoch_s=0.0), "epoch_s"),
                          (dict(classes=(cls,), duration_s=1.0,
                                epoch_s=900.0), "at least one epoch"),
                          (dict(classes=(cls,), slo_relax=0.0),
                           "slo_relax"),
                          (dict(classes=(cls,), severity_levels=()),
                           "severity_levels")):
            with pytest.raises(ValueError, match=field):
                m.FleetScenario(**kw)
        with pytest.raises(ValueError, match="requests_per_invocation"):
            m.WorkloadClass("b", wl, m.ArrivalSpec("poisson"),
                            requests_per_invocation=0.0)


def test_numpy_device_equals_the_reference_bit_for_bit():
    """``device="numpy"`` runs every epoch on the port's numpy batched
    engine, the reference's numpy code: the whole report is the
    reference's, to the bit."""
    ref = r_fleet.sweep_fleet(_scenario(REF), r_pol.KnobGrid(**GRID_KW))
    got = p_fleet.sweep_fleet(_scenario(PORT), p_pol.KnobGrid(**GRID_KW),
                              device="numpy")
    assert got.to_dict() == ref.to_dict()


# --------------------------------------------------------------------------
# validation (the fleet part of tests/test_validation.py)
# --------------------------------------------------------------------------

def _tiny_scenario(pkg, **kw):
    fl, og, _ = pkg
    cls = fl.WorkloadClass(
        "d", og.llm_workload("llama3-8b", "decode", batch=8),
        fl.ArrivalSpec("poisson", rate_rps=1.0), requests_per_invocation=8)
    base = dict(classes=(cls,), n_chips=8, npu="NPU-D",
                policies=("NoPG",), duration_s=1800.0, epoch_s=900.0,
                seed=0)
    base.update(kw)
    return fl.FleetScenario(**base)


def test_fleet_scenario_rejects_bad_shed_backlog():
    for bad in (0.0, -2.0, float("nan")):
        for pkg in (REF, PORT):
            with pytest.raises(ValueError, match="shed_backlog_x"):
                _tiny_scenario(pkg, shed_backlog_x=bad)


def test_arrival_spec_rejects_negative_rate():
    for m in (r_fleet, p_fleet):
        with pytest.raises(ValueError, match="rate_rps"):
            m.ArrivalSpec("poisson", rate_rps=-1.0)
        with pytest.raises(ValueError, match="rate_rps"):
            m.ArrivalSpec("bursty", rate_rps=float("inf"))


def test_sweep_fleet_rejects_mismatched_faults_and_hysteresis():
    sc = _tiny_scenario(PORT)
    with pytest.raises(ValueError, match="FaultTimeline"):
        p_fleet.sweep_fleet(sc, None, faults="chaos", device="cpu")
    with pytest.raises(ValueError, match="epochs"):
        p_fleet.sweep_fleet(sc, None, device="cpu",
                            faults=p_faults.FaultTimeline.empty(
                                5, sc.n_chips))
    with pytest.raises(ValueError, match="chips"):
        p_fleet.sweep_fleet(sc, None, device="cpu",
                            faults=p_faults.FaultTimeline.empty(2, 4))
    with pytest.raises(ValueError, match="Hysteresis"):
        p_fleet.sweep_fleet(sc, None, hysteresis=0.5, device="cpu")
