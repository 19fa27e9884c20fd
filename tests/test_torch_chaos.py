"""The port's chaos plane — faulted collective schedules, fault timelines
through the fleet simulator, degraded-mode failover, the anti-thrash
governor and the ``sweep_chaos`` campaign — against the reference's.

The port runs on ``device="cpu"``, the reference on ``backend="numpy"``.
Fault timelines, topology lowering and the governor are host numpy in
both packages, so every integer and flag of the reports (arrivals,
severity indices, chips down, chosen knobs, retunes, fault summaries)
must be identical and every float ≤1e-9 relative. Mirrors
``tests/test_chaos.py`` case for case (its fault-timeline cases are in
``tests/test_torch_faults.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as r_faults  # noqa: E402
from repro.core import fleet as r_fleet  # noqa: E402
from repro.core import ici_topology as r_ici  # noqa: E402
from repro.core import opgen as r_opgen  # noqa: E402
from repro.core import policies as r_pol  # noqa: E402
from repro.core import slo as r_slo  # noqa: E402
from repro_torch.core import faults as p_faults  # noqa: E402
from repro_torch.core import fleet as p_fleet  # noqa: E402
from repro_torch.core import ici_topology as p_ici  # noqa: E402
from repro_torch.core import opgen as p_opgen  # noqa: E402
from repro_torch.core import policies as p_pol  # noqa: E402
from repro_torch.core import slo as p_slo  # noqa: E402

from _torch_parity import (assert_fleet_reports_match,  # noqa: E402
                           assert_trees_match)

RTOL = 1e-9

REF = dict(faults=r_faults, fleet=r_fleet, ici=r_ici, opgen=r_opgen,
           pol=r_pol, slo=r_slo)
PORT = dict(faults=p_faults, fleet=p_fleet, ici=p_ici, opgen=p_opgen,
            pol=p_pol, slo=p_slo)

TOPOS = (("ring", (8,)), ("mesh2d", (4, 8)), ("mesh2d", (1, 6)))
KINDS = ("all_reduce", "all_gather", "all_to_all")
KNOB_KW = (dict(), dict(window_scale=2.0), dict(window_scale=0.5))


def decode(pkg):
    return pkg["opgen"].llm_workload("llama2-13b", "decode", batch=8,
                                     n_chips=8, tp=8)


def prefill(pkg):
    return pkg["opgen"].llm_workload("llama2-13b", "prefill", batch=4,
                                     n_chips=8, tp=8)


def knobs(pkg, rows=KNOB_KW):
    return tuple(pkg["pol"].PolicyKnobs(**kw) for kw in rows)


def _scenario(pkg, **kw):
    fl = pkg["fleet"]
    classes = (
        fl.WorkloadClass("decode", decode(pkg),
                         fl.ArrivalSpec("diurnal", rate_rps=40.0,
                                        period_s=4 * 3600.0),
                         requests_per_invocation=8),
        fl.WorkloadClass("prefill", prefill(pkg),
                         fl.ArrivalSpec("poisson", rate_rps=6.0),
                         requests_per_invocation=4),
    )
    base = dict(classes=classes, n_chips=64, duration_s=4 * 3600.0,
                epoch_s=900.0, seed=3, policies=("NoPG", "ReGate-Full"))
    base.update(kw)
    return fl.FleetScenario(**base)


def run_both(scenario, timeline=None, knob_rows=KNOB_KW, **kw):
    """``sweep_fleet`` on the reference (numpy) and the port (CPU), each
    with its own package's objects built by ``scenario(pkg)`` and
    ``timeline(pkg)``; the reports compared, the port's returned."""
    out = []
    for pkg in (REF, PORT):
        extra = {"backend": "numpy"} if pkg is REF else {"device": "cpu"}
        faults = None if timeline is None else timeline(pkg)
        hys = kw.get("hysteresis")
        if hys is not None:
            hys = pkg["slo"].Hysteresis()
        out.append(pkg["fleet"].sweep_fleet(
            scenario(pkg), knobs(pkg, knob_rows), faults=faults,
            **{**kw, "hysteresis": hys}, **extra))
    assert_fleet_reports_match(*out)
    return out[1]


def timeline_of(n_e, n_chips, n_links=0, chips_down=None, link_rates=None,
                pg_fault=None, severity_hint=None):
    """A hand-built ``FaultTimeline`` factory for both packages."""
    def build(pkg):
        return pkg["faults"].FaultTimeline(
            n_e, n_chips, n_links,
            chips_down=np.zeros(n_e, np.int64) if chips_down is None
            else chips_down,
            link_rates=np.ones((n_e, n_links)) if link_rates is None
            else link_rates,
            pg_fault=np.zeros(n_e, np.bool_) if pg_fault is None
            else pg_fault,
            severity_hint=np.zeros(n_e) if severity_hint is None
            else severity_hint)
    return build


# --------------------------------------------------------------------------
# faulted collective schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("topo", TOPOS, ids=lambda t: f"{t[0]}{t[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_uniform_trace_reproduces_clean_schedule(topo, kind):
    tp, tr = p_ici.Topology(*topo), r_ici.Topology(*topo)
    clean = p_ici.collective_schedule(kind, tp)
    uni = p_ici.collective_schedule(kind, tp, np.ones(p_ici.n_links(tp)))
    assert np.array_equal(clean, r_ici.collective_schedule(kind, tr))
    assert np.array_equal(uni, r_ici.collective_schedule(
        kind, tr, np.ones(r_ici.n_links(tr))))
    assert uni.shape == clean.shape
    if clean.size:
        assert float(np.max(np.abs(uni - clean))) <= RTOL
        assert abs(clean.sum() - 1.0) <= RTOL


def test_degraded_link_inflates_schedule():
    rates = np.ones(8)
    rates[3] = 0.5
    f = p_ici.collective_schedule("all_reduce", p_ici.Topology("ring", (8,)),
                                  rates)
    assert np.array_equal(f, r_ici.collective_schedule(
        "all_reduce", r_ici.Topology("ring", (8,)), rates))
    clean = p_ici.collective_schedule("all_reduce",
                                      p_ici.Topology("ring", (8,)))
    assert np.all(f > clean) and abs(f.sum() - 2.0) < 1e-9


def test_down_link_detours_the_long_way():
    rates = np.ones(8)
    rates[2] = 0.0
    f = p_ici.collective_schedule("all_gather", p_ici.Topology("ring", (8,)),
                                  rates)
    assert np.array_equal(f, r_ici.collective_schedule(
        "all_gather", r_ici.Topology("ring", (8,)), rates))
    assert abs(f.sum() - 7.0) < 1e-9


def test_partitioned_ring_raises_and_resolve_fixes_it():
    topo = p_ici.Topology("ring", (8,))
    rates = np.ones(8)
    rates[2] = rates[5] = 0.0
    with pytest.raises(ValueError, match="partition"):
        p_ici.collective_schedule("all_reduce", topo, rates)
    fixed = p_ici.resolve_link_rates(rates, topo)
    assert np.array_equal(fixed, r_ici.resolve_link_rates(
        rates, r_ici.Topology("ring", (8,))))
    assert (fixed <= 0).sum() == 1
    f = p_ici.collective_schedule("all_reduce", topo, fixed)
    assert np.isfinite(f).all() and f.sum() > 1.0


def test_mesh_per_step_trace_shape_enforced():
    topo = p_ici.Topology("mesh2d", (4, 8))
    s = p_ici.collective_schedule("all_reduce", topo).size
    with pytest.raises(ValueError, match="shape"):
        p_ici.collective_schedule("all_reduce", topo, np.ones(3))
    per_step = np.ones((s, p_ici.n_links(topo)))
    f = p_ici.collective_schedule("all_reduce", topo, per_step)
    assert abs(f.sum() - 1.0) <= RTOL


def test_lowered_faulted_variant_is_distinct_and_inflated():
    out = []
    for pkg in (REF, PORT):
        ici = pkg["ici"]
        topo = ici.topology_for(8)
        rates = np.ones(ici.n_links(topo))
        rates[0] = 0.0
        out.append((ici.lower_collectives(decode(pkg), topo),
                    ici.lower_collectives(decode(pkg), topo,
                                          link_rates=rates)))
    (r_clean, r_faulted), (clean, faulted) = out
    assert clean.name.endswith("+topo") and faulted.name.endswith("+topo!")
    assert len(clean.ops) == len(faulted.ops)
    for a, b in ((r_clean, clean), (r_faulted, faulted)):
        assert a.name == b.name
        assert [(o.name, o.bytes_ici, o.count) for o in a.ops] \
            == [(o.name, o.bytes_ici, o.count) for o in b.ops]
    wire = sum(o.bytes_ici * o.count for o in clean.ops)
    assert sum(o.bytes_ici * o.count for o in faulted.ops) > wire


# --------------------------------------------------------------------------
# fleet integration
# --------------------------------------------------------------------------

def test_empty_timeline_is_exact_noop():
    sc = lambda pkg: _scenario(pkg, severity_levels=(0.0, 0.6))  # noqa
    clean = run_both(sc)
    empty = run_both(sc, timeline=lambda pkg: pkg["faults"].FaultTimeline
                     .empty(16, 64, 16))
    assert clean.records == empty.records
    assert clean.epoch_summary == empty.epoch_summary
    assert clean.summary == empty.summary


def _seeded_timeline(pkg):
    f = pkg["faults"]
    return f.build_fault_timeline(f.fault_plan(2.0), n_epochs=16,
                                  n_chips=64, n_links=16, seed=5)


def test_faulted_report_deterministic_and_conserves_energy():
    tl = _seeded_timeline(PORT)
    assert tl.any_fault().any() and tl.has_link_faults
    a = run_both(_scenario, timeline=_seeded_timeline)
    b = p_fleet.sweep_fleet(_scenario(PORT), knobs(PORT), faults=tl,
                            device="cpu")
    assert a.records == b.records and a.summary == b.summary
    for s in a.epoch_summary:
        recs = [r["total_j"] for r in a.records
                if r["policy"] == s["policy"] and r["epoch"] == s["epoch"]]
        rhs = math.fsum(recs) + s["unallocated_idle_j"]
        assert abs(s["total_j"] - rhs) <= RTOL * max(1.0, abs(rhs))
    for pol in ("NoPG", "ReGate-Full"):
        tot = a.policy_summary(pol)["total_j"]
        rhs = math.fsum(r["total_j"] for r in a.records
                        if r["policy"] == pol) \
            + math.fsum(s["unallocated_idle_j"] for s in a.epoch_summary
                        if s["policy"] == pol)
        assert abs(tot - rhs) <= RTOL * max(1.0, abs(rhs))
    assert a.fault_summary["faulted_epochs"] == int(tl.any_fault().sum())


def test_failover_reallocation_over_survivors():
    n_e = 16
    rep = run_both(_scenario, timeline=timeline_of(
        n_e, 64, chips_down=np.where(np.arange(n_e) % 2 == 1, 24, 0
                                     ).astype(np.int64)))
    for s in rep.epoch_summary:
        assert s["chips_active"] + s["chips_unallocated"] \
            == 64 - s["chips_down"]
    for s in [s for s in rep.epoch_summary if s["chips_down"] > 0]:
        for r in rep.records:
            if r["epoch"] == s["epoch"] and r["policy"] == s["policy"] \
                    and r["demand_inv"] > 0:
                assert r["chips"] >= 1


def test_pg_fault_falls_back_to_nopg_point():
    n_e = 16
    pg = np.zeros(n_e, np.bool_)
    pg[4:8] = True
    rep = run_both(_scenario, timeline=timeline_of(n_e, 64, pg_fault=pg))
    by = {(r["epoch"], r["class"], r["policy"]): r for r in rep.records}
    for e in range(n_e):
        for cls in rep.class_names:
            rf, np_ = by[(e, cls, "ReGate-Full")], by[(e, cls, "NoPG")]
            if pg[e]:
                assert rf["pg_fallback"]
                assert rf["runtime_s"] == np_["runtime_s"]
                assert rf["inv_total_j"] == np_["inv_total_j"]
                assert rf["total_j"] == np_["total_j"]
            else:
                assert not rf["pg_fallback"]
                assert rf["inv_total_j"] < np_["inv_total_j"]
    assert rep.policy_summary("ReGate-Full")["pg_fallback_epochs"] == 4
    assert rep.policy_summary("NoPG")["pg_fallback_epochs"] == 0


def test_shed_ladder_bounds_backlog():
    def sc(shed):
        def build(pkg):
            fl = pkg["fleet"]
            kw = dict(classes=(fl.WorkloadClass(
                "decode", decode(pkg),
                fl.ArrivalSpec("poisson", rate_rps=500.0),
                requests_per_invocation=1),), n_chips=8,
                duration_s=4 * 900.0, epoch_s=900.0, seed=0,
                policies=("ReGate-Full",))
            if shed:
                kw["shed_backlog_x"] = 1.0
            return fl.FleetScenario(**kw)
        return build
    queued, shed = run_both(sc(False)), run_both(sc(True))
    assert queued.policy_summary("ReGate-Full")["shed_inv_total"] == 0.0
    s = shed.policy_summary("ReGate-Full")
    assert s["shed_inv_total"] > 0.0
    assert s["backlog_inv_final"] \
        < queued.policy_summary("ReGate-Full")["backlog_inv_final"]
    for r in shed.records:
        cap = r["chips"] * 900.0 / (r["runtime_s"] * 8.0)
        assert r["backlog_inv"] <= 1.0 * cap + 1e-6


def test_severity_hint_escalates_ladder():
    n_e = 16
    hint = np.zeros(n_e)
    hint[::2] = 2.0
    rep = run_both(lambda pkg: _scenario(pkg, severity_levels=(0.0, 0.8)),
                   timeline=timeline_of(n_e, 64, severity_hint=hint))
    for e in range(0, n_e, 2):
        assert rep.severity_by_epoch[e] == 0.8


# --------------------------------------------------------------------------
# anti-thrash: the flapping-link scenario
# --------------------------------------------------------------------------

def _flapping_scenario(pkg):
    fl = pkg["fleet"]
    classes = (fl.WorkloadClass(
        "decode", decode(pkg),
        fl.ArrivalSpec("replay", times_s=tuple(
            float(e) * 60.0 for e in range(24) for _ in range(8))),
        requests_per_invocation=8),)
    return fl.FleetScenario(classes, n_chips=8, duration_s=24 * 60.0,
                            epoch_s=60.0, seed=0, slo_relax=1.03,
                            policies=("NoPG", "ReGate-Full"))


def _flapping_timeline():
    n_e = 24
    n_l = p_ici.n_links(p_ici.topology_for(8))
    rates = np.ones((n_e, n_l))
    flap = np.array([(e // 3) % 2 == 1 for e in range(n_e)])
    rates[flap, 0] = 0.0
    return timeline_of(n_e, 8, n_l, link_rates=rates), int(flap.sum())


def test_antithrash_bound_vs_thrashing_baseline():
    tl_of, n_flap_epochs = _flapping_timeline()
    tl = tl_of(PORT)
    trans = tl.n_transitions
    assert trans == tl_of(REF).n_transitions and n_flap_epochs > trans
    rows = (dict(window_scale=0.25), dict(window_scale=2.0),
            dict(delay_scale=8.0), dict())
    gov = run_both(_flapping_scenario, timeline=tl_of, knob_rows=rows,
                   hysteresis=True)
    base = run_both(_flapping_scenario, timeline=tl_of, knob_rows=rows)
    g = gov.policy_summary("ReGate-Full")["retunes"]
    b = base.policy_summary("ReGate-Full")["retunes"]
    assert g <= trans, (g, trans)
    assert b >= n_flap_epochs, (b, n_flap_epochs)
    assert b > g
    flap_recs = [r for r in gov.records if r["policy"] == "ReGate-Full"
                 and tl.link_faulty(r["epoch"])]
    assert flap_recs and all(not r["feasible_exists"] for r in flap_recs)


def _campaign(pkg, **kw):
    sc = _scenario(pkg, n_chips=32, duration_s=8 * 900.0)
    extra = {"backend": "numpy"} if pkg is REF else {"device": "cpu"}
    return pkg["fleet"].sweep_chaos(sc, knobs(pkg), **kw, **extra)


def assert_campaigns_match(ref, got):
    assert_trees_match(ref["summary"], got["summary"])
    assert got["fault_severities"] == ref["fault_severities"]
    for sev, rep in ref["reports"].items():
        assert_fleet_reports_match(rep, got["reports"][sev])
        tl, rtl = got["timelines"][sev], ref["timelines"][sev]
        for name in ("chips_down", "link_rates", "pg_fault",
                     "severity_hint"):
            assert np.array_equal(getattr(tl, name), getattr(rtl, name))
    for sev, rep in ref["baseline_reports"].items():
        assert_fleet_reports_match(rep, got["baseline_reports"][sev])


def test_chaos_campaign_deterministic():
    a = _campaign(PORT, fault_severities=(0.0, 2.0))
    assert_campaigns_match(_campaign(REF, fault_severities=(0.0, 2.0)), a)
    b = _campaign(PORT, fault_severities=(0.0, 2.0))
    assert a["summary"] == b["summary"]
    for row in a["summary"]:
        if row["fault_severity"] == 0.0:
            assert row["n_transitions"] == 0
            assert row["faulted_epochs"] == 0
            assert row["recovery_epochs"] == []
        assert row["retunes"] >= 0
        assert "baseline_retunes" in row
    solo = _campaign(PORT, fault_severities=(2.0,), thrash_baseline=False)
    paired = [r for r in a["summary"] if r["fault_severity"] == 2.0]
    for pr, sr in zip(paired, solo["summary"]):
        for k in ("retunes", "n_transitions", "worst_regret_frac",
                  "total_j"):
            assert pr[k] == sr[k], (k, pr[k], sr[k])


def test_clamped_replay_surfaced_in_report():
    def sc(pkg):
        fl = pkg["fleet"]
        classes = (fl.WorkloadClass(
            "replayed", decode(pkg),
            fl.ArrivalSpec("replay",
                           times_s=(0.0, 100.0, 1000.0, 1750.0, 1800.0)),
            requests_per_invocation=8),)
        return fl.FleetScenario(classes, n_chips=8, duration_s=1800.0,
                                epoch_s=900.0, seed=0,
                                policies=("ReGate-Full",))
    rep = run_both(sc, knob_rows=(dict(),))
    assert rep.clamped_requests == 3
    assert rep.clamped_by_class == {"replayed": 3}
    assert rep.requests_total == 5
