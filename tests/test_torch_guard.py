"""The port's guard plane (``repro_torch.core.guard``), its failover
ladder (``backend.failover_rungs``), the session's ``guard`` field and
the numpy batched engine it falls back on (``policies.
evaluate_batch_numpy``), against the reference's.

The port's ladder for the card (``"cuda"``) is the card alone: once its
attempts are used up the call raises ``GuardError``, where the
reference's ``jax-mesh`` → ``jax`` → ``numpy`` would finish on the host.
Its ``"cpu"`` ladder falls to ``"numpy"`` (the independent numpy
engine), as the reference's ``jax`` does. Events compare with the rung
names mapped ``jax-mesh → cuda``, ``jax → cpu``, ``numpy → numpy``.
The port runs on
``device="cpu"``, the reference on ``backend="numpy"``. Mirrors
``tests/test_guard.py`` case for case and the guard part of
``tests/test_validation.py``.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as r_faults  # noqa: E402
from repro.core import fleet as r_fleet  # noqa: E402
from repro.core import guard as r_guard  # noqa: E402
from repro.core import opgen as r_opgen  # noqa: E402
from repro.core import policies as r_pol  # noqa: E402
from repro.core import slo as r_slo  # noqa: E402
from repro_torch.core import backend as p_backend  # noqa: E402
from repro_torch.core import faults as p_faults  # noqa: E402
from repro_torch.core import fleet as p_fleet  # noqa: E402
from repro_torch.core import guard as p_guard  # noqa: E402
from repro_torch.core import opgen as p_opgen  # noqa: E402
from repro_torch.core import policies as p_pol  # noqa: E402
from repro_torch.core import session as p_session  # noqa: E402
from repro_torch.core import slo as p_slo  # noqa: E402
from repro_torch.kernels.sa_occupancy import sa_occupancy  # noqa: E402

from _torch_parity import (CUBE_FIELDS, assert_cubes_match,  # noqa: E402
                           assert_fleet_reports_match, assert_trees_match)

RTOL = 1e-9
REF = dict(fleet=r_fleet, opgen=r_opgen, pol=r_pol, guard=r_guard)
PORT = dict(fleet=p_fleet, opgen=p_opgen, pol=p_pol, guard=p_guard)
RUNG_OF = {"jax-mesh": "cuda", "jax": "cpu", "numpy": "numpy"}
NPUS = ("NPU-D",)
POLS = ("NoPG", "ReGate-Full")


def wl(pkg):
    return pkg["opgen"].llm_workload("llama3-8b", "decode", batch=8,
                                     n_chips=8, tp=8)


def grid(pkg, ws=(0.5, 1.0)):
    return pkg["pol"].KnobGrid(window_scale=ws)


def knobs(pkg):
    P = pkg["pol"].PolicyKnobs
    return (P(), P(window_scale=2.0))


def _scenario(pkg, seed=11, **kw):
    fl = pkg["fleet"]
    base = dict(
        classes=(fl.WorkloadClass(
            "decode", wl(pkg),
            fl.ArrivalSpec("diurnal", rate_rps=12.0, period_s=1800.0),
            requests_per_invocation=8),),
        n_chips=16, npu="NPU-D", policies=POLS,
        duration_s=1800.0, epoch_s=600.0, seed=seed,
        severity_levels=(0.0, 1.0))
    base.update(kw)
    return fl.FleetScenario(**base)


def _core(report) -> str:
    d = report.to_dict()
    d.pop("guard")
    return json.dumps(d, sort_keys=True)


def mapped(events):
    """The reference's events with its rung names as the port's."""
    out = []
    for e in events:
        e = dict(e)
        for k in ("rung", "next_rung"):
            if k in e:
                e[k] = RUNG_OF[e[k]]
        e.pop("reason")
        out.append(e)
    return out


def without_reason(events):
    return [{k: v for k, v in e.items() if k != "reason"} for e in events]


# --------------------------------------------------------------------------
# the numpy batched engine: the oracle and the ladder's last rung
# --------------------------------------------------------------------------

ENGINE_GRID = dict(window_scale=(0.5, 1.0), sa_width=(None, 64, 256),
                   leak_off_logic=(None, 0.2), leak_sram_sleep=(None, 0.4))


@pytest.mark.parametrize("npus", [("NPU-B",), ("NPU-D",),
                                  ("NPU-B", "NPU-D")])
def test_numpy_engine_equals_reference_and_the_cpu_route(npus):
    r_suite, p_suite = r_opgen.paper_suite()[:7], p_opgen.paper_suite()[:7]
    want = r_pol.evaluate_batch(r_suite, npus, r_pol.POLICIES,
                                r_pol.KnobGrid(**ENGINE_GRID),
                                backend="numpy")
    got = p_pol.evaluate_batch_numpy(p_suite, npus, p_pol.POLICIES,
                                     p_pol.KnobGrid(**ENGINE_GRID))
    assert_cubes_match(want, got, exact=True)
    for f in CUBE_FIELDS:
        for arr in getattr(got, f).values():
            assert isinstance(arr, np.ndarray)
    cpu = p_pol.evaluate_batch(p_suite, npus, p_pol.POLICIES,
                               p_pol.KnobGrid(**ENGINE_GRID), device="cpu")
    assert_cubes_match(got, cpu, rtol=RTOL)
    assert got.records() == want.records()


def test_numpy_engine_touches_no_tensor_and_launches_nothing(monkeypatch):
    def no_tensors(*a, **k):
        raise AssertionError("the numpy engine made a tensor")
    k1 = sa_occupancy.launches
    monkeypatch.setattr(torch, "tensor", no_tensors)
    monkeypatch.setattr(torch, "as_tensor", no_tensors)
    res = p_pol.evaluate_batch_numpy(p_opgen.paper_suite()[12:14], NPUS,
                                     POLS, knobs(PORT))
    assert np.isfinite(res.runtime_s).all() and sa_occupancy.launches == k1
    with pytest.raises(ValueError, match="knob 1"):
        p_pol.evaluate_batch_numpy([wl(PORT)], NPUS, POLS,
                                   (p_pol.PolicyKnobs(),
                                    p_pol.PolicyKnobs(delay_scale=0.0)))


# --------------------------------------------------------------------------
# the ladder and the session's guard field
# --------------------------------------------------------------------------

def test_failover_rungs():
    # the card has no rung below it: nothing moves a card campaign to
    # the host
    assert p_backend.failover_rungs("cuda") == (("cuda", None),)
    assert p_backend.failover_rungs("cuda:1") == (("cuda:1", None),)
    assert p_backend.failover_rungs("cpu") == (("cpu", None),
                                               ("numpy", None))
    assert p_backend.failover_rungs("numpy") == (("numpy", None),)
    assert p_backend.failover_rungs(None) == (("cuda", None),)
    with p_session.SweepSession(device="cpu"):
        assert p_backend.failover_rungs() == (("cpu", None),
                                              ("numpy", None))
        assert p_guard.GuardedRunner().rungs == (("cpu", None),
                                                 ("numpy", None))
    with pytest.raises(KeyError, match="failover"):
        p_backend.failover_rungs("meta")
    # the reference's host ladder has the same shape: the requested
    # substrate down to the numpy oracle, which has nowhere to fall
    assert [RUNG_OF[n] for n, _ in r_guard.GuardedRunner(
        backend="jax").rungs] == ["cpu", "numpy"]


def test_guarded_fleet_matches_plain():
    plain = p_fleet.sweep_fleet(_scenario(PORT), grid(PORT), device="cpu")
    guarded = p_fleet.sweep_fleet(_scenario(PORT), grid(PORT), device="cpu",
                                  guard=p_guard.GuardPolicy(timeout_s=300.0))
    assert _core(plain) == _core(guarded)
    assert plain.guard is None
    assert guarded.guard is not None and guarded.guard["events"] == []
    ref = r_fleet.sweep_fleet(_scenario(REF), grid(REF),
                              guard=r_guard.GuardPolicy(timeout_s=300.0))
    assert_fleet_reports_match(ref, guarded)
    assert guarded.guard == ref.guard


def test_session_scopes_guard():
    with p_session.SweepSession(guard=p_guard.GuardPolicy(timeout_s=300.0),
                                device="cpu"):
        assert isinstance(p_session.resolve("guard"), p_guard.GuardPolicy)
        rep = p_fleet.sweep_fleet(_scenario(PORT), grid(PORT))
    assert rep.guard is not None and rep.guard["events"] == []
    assert p_session.resolve("guard") is None
    assert p_fleet.sweep_fleet(_scenario(PORT), grid(PORT),
                               device="cpu").guard is None


# --------------------------------------------------------------------------
# campaign checkpoints: resume + short-circuit + identity pinning
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_resume(tmp_path):
    sc, g = _scenario(PORT), grid(PORT)
    ref = p_fleet.sweep_fleet(sc, g, device="cpu",
                              guard=p_guard.GuardPolicy())
    full = p_fleet.sweep_fleet(sc, g, device="cpu",
                               checkpoint=str(tmp_path / "a"))
    assert _core(full) == _core(ref)
    again = p_fleet.sweep_fleet(sc, g, device="cpu",
                                checkpoint=str(tmp_path / "a"))
    assert json.dumps(again.to_dict(), sort_keys=True) \
        == json.dumps(full.to_dict(), sort_keys=True)
    ckdir = tmp_path / "b"
    p_fleet.sweep_fleet(sc, g, device="cpu", checkpoint=str(ckdir))
    epochs = sorted(int(p.stem.split("_")[1])
                    for p in ckdir.glob("epoch_*.json"))
    assert len(epochs) == 2
    manifest = json.loads((ckdir / "manifest.json").read_text())
    assert manifest["backend"] == "cpu"
    (ckdir / "final.json").unlink()
    (ckdir / f"epoch_{epochs[-1]}.json").unlink()
    resumed = p_fleet.sweep_fleet(sc, g, device="cpu",
                                  checkpoint=str(ckdir))
    assert _core(resumed) == _core(ref)
    # the same resume in the reference gives the same report
    rck = tmp_path / "r"
    r_fleet.sweep_fleet(_scenario(REF), grid(REF), checkpoint=str(rck))
    assert_fleet_reports_match(
        r_fleet.FleetReport.from_dict(
            json.loads((rck / "final.json").read_text())), resumed)


def test_checkpoint_refuses_different_campaign(tmp_path):
    ckdir = str(tmp_path / "ck")
    p_fleet.sweep_fleet(_scenario(PORT, seed=11), grid(PORT), device="cpu",
                        checkpoint=ckdir)
    with pytest.raises(ValueError, match="manifest mismatch on seed"):
        p_fleet.sweep_fleet(_scenario(PORT, seed=12), grid(PORT),
                            device="cpu", checkpoint=ckdir)
    with pytest.raises(ValueError, match="manifest mismatch on knob_digest"):
        p_fleet.sweep_fleet(_scenario(PORT, seed=11),
                            grid(PORT, (0.5, 2.0)), device="cpu",
                            checkpoint=ckdir)
    # a campaign checkpointed on one device is not resumed on another
    with pytest.raises(ValueError, match="manifest mismatch on backend"):
        p_fleet.sweep_fleet(_scenario(PORT, seed=11), grid(PORT),
                            device="numpy", checkpoint=ckdir)


def test_chaos_checkpoint_matches_plain(tmp_path):
    kw = dict(fault_severities=(0.0, 1.0), thrash_baseline=False)
    ref = p_fleet.sweep_chaos(_scenario(PORT), grid(PORT), device="cpu",
                              **kw)
    out = p_fleet.sweep_chaos(_scenario(PORT), grid(PORT), device="cpu",
                              checkpoint=str(tmp_path / "c"), **kw)
    assert json.dumps(out["summary"], sort_keys=True) \
        == json.dumps(ref["summary"], sort_keys=True)
    for sev in (0.0, 1.0):
        assert _core(out["reports"][sev]) == _core(ref["reports"][sev])
    want = r_fleet.sweep_chaos(_scenario(REF), grid(REF), **kw)
    assert_trees_match(want["summary"], out["summary"])


def test_manifest_named_mismatch():
    kw = dict(kind="fleet", seed=1, n_epochs=3, backend="cuda",
              knob_digest="k", scenario_digest="s")
    a = p_guard.RunManifest(**kw)
    with pytest.raises(ValueError, match="mismatch on backend"):
        a.check(p_guard.RunManifest(**{**kw, "backend": "cpu"}))
    a.check(p_guard.RunManifest(**kw))
    assert a.to_dict() == r_guard.RunManifest(**kw).to_dict()


def test_digest_of_is_stable_and_sensitive():
    g = p_pol.KnobGrid(window_scale=(0.5, 1.0))
    assert p_guard.digest_of(g) == p_guard.digest_of(
        p_pol.KnobGrid(window_scale=(0.5, 1.0)))
    assert p_guard.digest_of(g) != p_guard.digest_of(
        p_pol.KnobGrid(window_scale=(0.5, 2.0)))
    assert p_guard.digest_of(np.arange(3)) \
        != p_guard.digest_of(np.arange(3.0))


def _digest_inputs(pkg, faults, slo):
    sc = _scenario(pkg, severity_levels=(0.0, 0.5, 1.0),
                   shed_backlog_x=4.0)
    tl = faults.build_fault_timeline(faults.fault_plan(1.0),
                                     n_epochs=sc.n_epochs,
                                     n_chips=sc.n_chips, n_links=8, seed=3)
    P = pkg["pol"].PolicyKnobs
    return {
        "knobs": tuple(grid(pkg).product()),
        "knob_grid": pkg["pol"].KnobGrid(window_scale=(0.5, 1.0),
                                         sa_width=(None, 64),
                                         leak_off_logic=(None, 0.2)),
        "knob": P(delay_scale=2.0, sa_width=128, leak_sram_off=0.02),
        "fault_spec": faults.fault_plan(2.0),
        "arrivals": pkg["fleet"].ArrivalSpec("bursty", rate_rps=1.5,
                                             burst_prob=0.15),
        "replay": pkg["fleet"].ArrivalSpec("replay", times_s=(0, 1.5)),
        "scenario": (sc, tl, slo.Hysteresis()),
        "chaos": (sc, slo.Hysteresis(), True),
        "array": np.linspace(0.0, 1.0, 7),
    }


def test_digest_of_equals_the_reference_on_equal_inputs():
    """A checkpoint's identity is the same whichever package wrote it:
    the port's knobs, fault specs, arrival specs, scenarios and
    timelines give the reference's canonical JSON, hence its digest."""
    ref = _digest_inputs(REF, r_faults, r_slo)
    got = _digest_inputs(PORT, p_faults, p_slo)
    for name in ref:
        assert p_guard.digest_of(got[name]) \
            == r_guard.digest_of(ref[name]), name


# --------------------------------------------------------------------------
# quarantine: poisoned cells, oracle re-evaluation
# --------------------------------------------------------------------------

def _poison(res):
    rt = res.runtime_s.copy()
    rt[0, 0, 0, 0] = np.nan
    sj = {c: a.copy() for c, a in res.static_j.items()}
    sj["sa"][-1, 0, -1, -1] = np.inf
    return dataclasses.replace(res, runtime_s=rt, static_j=sj)


def _poisoning_runner(rung, workloads, npus, policies, knobs):
    """A rung whose cube comes back with a NaN and an Inf cell."""
    return _poison(p_pol.evaluate_batch(workloads, npus, policies, knobs,
                                        device="cpu"))


def _ref_poisoning_runner(rung, workloads, npus, policies, knobs, *,
                          jax_mesh=None):
    return _poison(r_pol.evaluate_batch(workloads, npus, policies, knobs,
                                        backend="numpy"))


def test_quarantine_patches_to_oracle():
    def two(pkg):
        return [wl(pkg), pkg["opgen"].llm_workload(
            "llama3-8b", "prefill", batch=4, n_chips=8, tp=8)]
    runner = p_guard.GuardedRunner(p_guard.GuardPolicy(),
                                   rungs=[("cpu", None)],
                                   runner=_poisoning_runner, seed=5)
    got = runner.evaluate_batch(two(PORT), NPUS, POLS, knobs(PORT), step=3)
    ref = p_pol.evaluate_batch_numpy(two(PORT), NPUS, POLS, knobs(PORT))
    assert_cubes_match(ref, got, rtol=RTOL)
    for name, a in p_guard._result_fields(got):
        assert np.isfinite(a).all(), name
    # the patched cells are the numpy oracle's, to the bit
    assert got.runtime_s[0, 0, 0, 0] == ref.runtime_s[0, 0, 0, 0]
    assert got.static_j["sa"][1, 0, 1, 1] == ref.static_j["sa"][1, 0, 1, 1]

    evs = runner.report.events
    q = [e for e in evs if e["kind"] == "quarantine"]
    assert runner.report.quarantined_cells == len(q) == 2
    assert sorted(e["cell"] for e in q) == [[0, 0, 0, 0], [1, 0, 1, 1]]
    assert q[0]["fields"] == ["runtime_s"] and q[0]["step"] == 3
    assert "non-finite runtime_s" in q[0]["reason"]
    assert "numpy oracle" in q[0]["reason"]
    assert q[1]["fields"] == ["static_j[sa]"]
    assert [e["kind"] for e in evs][-1] == "oracle_recheck"
    assert evs[-1]["n_quarantined"] == 2

    rrun = r_guard.GuardedRunner(r_guard.GuardPolicy(),
                                 rungs=[("jax", None)],
                                 runner=_ref_poisoning_runner, seed=5)
    rrun.evaluate_batch(two(REF), NPUS, POLS, knobs(REF), step=3)
    rq, pq = rrun.report.events[:-1], evs[:-1]
    assert without_reason(pq) == mapped(rq)
    assert evs[-1]["max_survivor_rel_err"] <= RTOL


def test_quarantine_rejects_poisoned_oracle():
    def bad_oracle(workloads, npus, policies, knobs):
        return _poisoning_runner("numpy", workloads, npus, policies, knobs)

    runner = p_guard.GuardedRunner(p_guard.GuardPolicy(),
                                   rungs=[("cpu", None)],
                                   runner=_poisoning_runner,
                                   oracle=bad_oracle)
    with pytest.raises(p_guard.GuardError,
                       match="the model, not the device"):
        runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT))


def test_quarantine_rejects_untrustworthy_survivors():
    def skewed(rung, workloads, npus, policies, knobs):
        res = _poisoning_runner(rung, workloads, npus, policies, knobs)
        return dataclasses.replace(res, runtime_s=res.runtime_s * 1.5)

    runner = p_guard.GuardedRunner(p_guard.GuardPolicy(),
                                   rungs=[("cpu", None)], runner=skewed)
    with pytest.raises(p_guard.GuardError, match="beyond 1e-09"):
        runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT))


# --------------------------------------------------------------------------
# watchdog + failover ladder + deterministic backoff
# --------------------------------------------------------------------------

def _wedged_unless_numpy(calls):
    def slow(rung, workloads, npus, policies, knobs):
        calls.append(rung)
        if rung != "numpy":
            time.sleep(10.0)   # wedged; abandoned by the watchdog
        return p_pol.evaluate_batch_numpy(workloads, npus, policies, knobs)
    return slow


def test_watchdog_walks_the_ladder():
    calls = []
    pol = p_guard.GuardPolicy(timeout_s=0.05, max_retries=1,
                              backoff_base_s=0.001, backoff_factor=2.0,
                              backoff_jitter=0.1)
    runner = p_guard.GuardedRunner(
        pol, rungs=p_backend.failover_rungs("cpu"),
        runner=_wedged_unless_numpy(calls), seed=7)
    got = runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT), step=2)
    ref = p_pol.evaluate_batch_numpy([wl(PORT)], NPUS, POLS, knobs(PORT))
    assert float(np.max(np.abs(got.runtime_s - ref.runtime_s))) == 0.0

    assert calls == ["cpu", "cpu", "numpy"]
    kinds = [e["kind"] for e in runner.report.events]
    assert kinds == ["retry", "failover"]
    fo = runner.report.events[1]
    assert (fo["rung"], fo["next_rung"]) == ("cpu", "numpy")
    assert "timeout" in runner.report.events[0]["reason"]
    assert "exhausted after 2 attempts" in fo["reason"]

    rng = np.random.default_rng((7, p_guard._GUARD_PLANE, 2))
    expect = [pol.backoff_delay(0, rng)]
    got_delays = [e["delay_s"] for e in runner.report.events
                  if e["kind"] == "retry"]
    assert got_delays == expect
    assert p_guard._GUARD_PLANE == r_guard._GUARD_PLANE
    rpol = r_guard.GuardPolicy(timeout_s=0.05, max_retries=1,
                               backoff_base_s=0.001, backoff_factor=2.0,
                               backoff_jitter=0.1)
    rrng = np.random.default_rng((7, r_guard._GUARD_PLANE, 2))
    assert expect == [rpol.backoff_delay(0, rrng)]


def test_wedged_card_raises_and_never_reaches_the_host():
    """The card's ladder has no rung below it: a card rung that misses
    every deadline is retried on the card, then the call raises
    ``GuardError``; no attempt runs on ``"cpu"`` or ``"numpy"``."""
    calls = []
    runner = p_guard.GuardedRunner(
        p_guard.GuardPolicy(timeout_s=0.05, max_retries=1,
                            backoff_base_s=0.001),
        rungs=p_backend.failover_rungs("cuda"),
        runner=_wedged_unless_numpy(calls), seed=7)
    with pytest.raises(p_guard.GuardError,
                       match=r"all 1 failover rungs exhausted at step 2 "
                             r"\(timeout"):
        runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT), step=2)
    assert calls == ["cuda", "cuda"]
    assert [(e["kind"], e["rung"]) for e in runner.report.events] \
        == [("retry", "cuda")]


def test_ladder_exhaustion_raises_named_guard_error():
    def broken(rung, workloads, npus, policies, knobs):
        raise RuntimeError("device lost")

    runner = p_guard.GuardedRunner(
        p_guard.GuardPolicy(max_retries=0, backoff_base_s=0.001),
        rungs=[("cpu", None), ("numpy", None)], runner=broken)
    with pytest.raises(p_guard.GuardError,
                       match="all 2 failover rungs exhausted"):
        runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT), step=1)
    assert [e["kind"] for e in runner.report.events] == ["failover"]
    assert "device lost" in runner.report.events[0]["reason"]


def test_retry_recovers_without_failover():
    state = {"n": 0}

    def flaky(rung, workloads, npus, policies, knobs):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("transient")
        return p_guard.GuardedRunner._default_runner(
            rung, workloads, npus, policies, knobs)

    runner = p_guard.GuardedRunner(
        p_guard.GuardPolicy(max_retries=2, backoff_base_s=0.001),
        rungs=p_backend.failover_rungs("cpu"), runner=flaky)
    got = runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT))
    assert runner.report.retries == 1
    assert runner.report.failovers == 0
    want = p_pol.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT),
                                device="cpu")
    assert_cubes_match(want, got, exact=True)


def test_default_ladder_falls_from_cpu_to_the_numpy_engine(monkeypatch):
    """The default runner on the CPU ladder: a ``"cpu"`` rung that fails
    every attempt steps down to the numpy engine, recorded, and the
    result is the engine's, to the bit."""
    real = p_pol.evaluate_batch

    def broken(*a, device=None, **k):
        raise RuntimeError(f"{device} lost")
    monkeypatch.setattr(p_pol, "evaluate_batch", broken)
    runner = p_guard.GuardedRunner(
        p_guard.GuardPolicy(max_retries=1, backoff_base_s=0.001),
        device="cpu", seed=3)
    got = runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT), step=4)
    monkeypatch.setattr(p_pol, "evaluate_batch", real)
    assert [(e["kind"], e["rung"]) for e in runner.report.events] \
        == [("retry", "cpu"), ("failover", "cpu")]
    assert runner.report.events[1]["next_rung"] == "numpy"
    assert "cpu lost" in runner.report.events[1]["reason"]
    want = p_pol.evaluate_batch_numpy([wl(PORT)], NPUS, POLS, knobs(PORT))
    assert_cubes_match(want, got, exact=True)


def test_cuda_rung_is_prepared_outside_the_deadline(monkeypatch):
    """A cold build happens before the deadline starts: a warm-up far
    longer than ``timeout_s`` trips no watchdog, runs once per rung, and
    a warm-up that fails (no ``nvcc``, a library that does not load)
    raises ``GuardError`` at once: no retry, no step down, no launch."""
    warmed = []

    def slow_warm(dev):
        warmed.append(str(dev))
        time.sleep(0.3)
    real = p_pol.evaluate_batch

    def as_cpu(*a, device=None, **k):
        return real(*a, device="cpu", **k)
    monkeypatch.setattr(p_guard, "_warm_device", slow_warm)
    monkeypatch.setattr(p_pol, "evaluate_batch", as_cpu)
    runner = p_guard.GuardedRunner(p_guard.GuardPolicy(timeout_s=0.2),
                                   device="cuda")
    for step in (0, 1):
        runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT),
                              step=step)
    assert warmed == ["cuda"] and runner.report.events == []

    tried = []

    def no_nvcc(dev):
        tried.append(str(dev))
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(p_guard, "_warm_device", no_nvcc)
    ran = []
    monkeypatch.setattr(p_pol, "evaluate_batch",
                        lambda *a, **k: ran.append(k) or real(*a, **k))
    k1 = sa_occupancy.launches
    runner = p_guard.GuardedRunner(
        p_guard.GuardPolicy(max_retries=2, backoff_base_s=0.001),
        device="cuda")
    with pytest.raises(p_guard.GuardError,
                       match="'cuda' could not be prepared at step 0 "
                             ".*nvcc not found"):
        runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT))
    assert tried == ["cuda"] and ran == []
    assert runner.report.events == []
    assert sa_occupancy.launches == k1


def test_watchdog_workers_retire_with_their_runner():
    """A guarded campaign leaves no idle thread behind: the worker stops
    when its runner is closed or collected, and an abandoned (wedged)
    worker stops once its call returns."""
    import gc
    runner = p_guard.GuardedRunner(p_guard.GuardPolicy(), device="cpu")
    runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT))
    worker = runner._watchdog._t
    assert worker.is_alive()
    del runner
    gc.collect()
    worker.join(10.0)
    assert not worker.is_alive()

    def slow(rung, workloads, npus, policies, knobs):
        if rung == "cpu":
            time.sleep(0.5)
        return p_pol.evaluate_batch_numpy(workloads, npus, policies, knobs)

    runner = p_guard.GuardedRunner(
        p_guard.GuardPolicy(timeout_s=0.05, max_retries=0),
        rungs=p_backend.failover_rungs("cpu"), runner=slow)
    wedged = runner._watchdog = p_guard._Watchdog()
    first = wedged._t
    runner.evaluate_batch([wl(PORT)], NPUS, POLS, knobs(PORT))
    assert runner.report.failovers == 1
    first.join(10.0)
    assert not first.is_alive()
    second = runner._watchdog._t
    runner._watchdog.close()
    second.join(10.0)
    assert not second.is_alive()


# --------------------------------------------------------------------------
# report + checkpoint plumbing
# --------------------------------------------------------------------------

def test_guard_report_roundtrip():
    r = p_guard.GuardReport()
    r.add("retry", "timeout: deadline 0.05s exceeded", step=1,
          delay_s=0.0011)
    r.add("quarantine", "non-finite runtime_s", cell=[0, 0, 0, 0])
    d = r.to_dict()
    assert d["retries"] == 1 and d["quarantined_cells"] == 1
    back = p_guard.GuardReport.from_dict(json.loads(json.dumps(d)))
    assert back.events == r.events
    assert r_guard.GuardReport.from_dict(d).to_dict() == d


def test_campaign_checkpoint_gc_and_async_wait(tmp_path):
    m = p_guard.RunManifest(kind="fleet", seed=0, n_epochs=10,
                            backend="cuda", knob_digest="k",
                            scenario_digest="s")
    ck = p_guard.CampaignCheckpoint(tmp_path / "ck", m, keep=2)
    for e in range(5):
        ck.save_epoch(e, {"epoch": e, "payload": [e] * 3})
    ck.wait()
    assert ck.epochs() == [3, 4]
    assert ck.load_epoch() == {"epoch": 4, "payload": [4, 4, 4]}
    assert ck.load_final() is None
    ck.save_final({"done": True})
    assert ck.load_final() == {"done": True}
    p_guard.CampaignCheckpoint(tmp_path / "ck", m, keep=2)
    # the reference reads the port's checkpoint directory alike
    assert r_guard.CampaignCheckpoint(
        tmp_path / "ck", r_guard.RunManifest(**m.to_dict()),
        keep=2).load_epoch() == {"epoch": 4, "payload": [4, 4, 4]}


# --------------------------------------------------------------------------
# validation (the guard part of tests/test_validation.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,field", [
    ({"timeout_s": 0.0}, "timeout_s"),
    ({"timeout_s": -1.0}, "timeout_s"),
    ({"timeout_s": float("nan")}, "timeout_s"),
    ({"timeout_s": True}, "timeout_s"),
    ({"max_retries": -1}, "max_retries"),
    ({"max_retries": 1.5}, "max_retries"),
    ({"backoff_base_s": 0.0}, "backoff_base_s"),
    ({"backoff_base_s": float("inf")}, "backoff_base_s"),
    ({"backoff_factor": 0.5}, "backoff_factor"),
    ({"backoff_factor": float("nan")}, "backoff_factor"),
    ({"backoff_jitter": -0.1}, "backoff_jitter"),
    ({"backoff_jitter": 1.0}, "backoff_jitter"),
    ({"oracle_tol": 0.0}, "oracle_tol"),
    ({"oracle_tol": float("inf")}, "oracle_tol"),
    ({"checkpoint_every": 0}, "checkpoint_every"),
    ({"checkpoint_every": 2.5}, "checkpoint_every"),
])
def test_guard_policy_rejects_bad_params(kwargs, field):
    msgs = []
    for m in (r_guard, p_guard):
        with pytest.raises(ValueError, match=field) as e:
            m.GuardPolicy(**kwargs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


_MANIFEST = dict(kind="fleet", seed=1, n_epochs=4, backend="cuda",
                 knob_digest="k", scenario_digest="s")


@pytest.mark.parametrize("kwargs,field", [
    ({"kind": ""}, "kind"),
    ({"kind": 3}, "kind"),
    ({"seed": 1.5}, "seed"),
    ({"seed": True}, "seed"),
    ({"n_epochs": 0}, "n_epochs"),
    ({"backend": ""}, "backend"),
    ({"knob_digest": ""}, "knob_digest"),
    ({"scenario_digest": None}, "scenario_digest"),
])
def test_run_manifest_rejects_bad_fields(kwargs, field):
    with pytest.raises(ValueError, match=field):
        p_guard.RunManifest(**{**_MANIFEST, **kwargs})


def test_campaign_checkpoint_rejects_bad_args(tmp_path):
    m = p_guard.RunManifest(**_MANIFEST)
    with pytest.raises(ValueError, match="directory path"):
        p_guard.CampaignCheckpoint(42, m)
    with pytest.raises(ValueError, match="RunManifest"):
        p_guard.CampaignCheckpoint(str(tmp_path), {"kind": "fleet"})
    with pytest.raises(ValueError, match="keep"):
        p_guard.CampaignCheckpoint(str(tmp_path), m, keep=0)


def test_guarded_runner_rejects_bad_policy_and_rungs():
    with pytest.raises(ValueError, match="GuardPolicy"):
        p_guard.GuardedRunner("strict")
    with pytest.raises(ValueError, match="rungs"):
        p_guard.GuardedRunner(p_guard.GuardPolicy(), rungs=())


def _tiny(pkg):
    fl = pkg["fleet"]
    cls = fl.WorkloadClass(
        "d", pkg["opgen"].llm_workload("llama3-8b", "decode", batch=8),
        fl.ArrivalSpec("poisson", rate_rps=1.0), requests_per_invocation=8)
    return fl.FleetScenario(classes=(cls,), n_chips=8, npu="NPU-D",
                            policies=("NoPG",), duration_s=1800.0,
                            epoch_s=900.0, seed=0)


def test_sweep_fleet_rejects_bad_guard_args(tmp_path):
    sc = _tiny(PORT)
    with pytest.raises(ValueError, match="GuardPolicy"):
        p_fleet.sweep_fleet(sc, None, guard="strict", device="cpu")
    with pytest.raises(ValueError, match="GuardPolicy"):
        p_fleet.sweep_fleet(sc, None, guard=r_guard.GuardPolicy(),
                            device="cpu")
    with pytest.raises(ValueError, match="directory path"):
        p_fleet.sweep_fleet(sc, None, checkpoint=7, device="cpu")
    with pytest.raises(ValueError, match="keep_epoch_inputs"):
        p_fleet.sweep_fleet(sc, None, checkpoint=str(tmp_path / "ck"),
                            keep_epoch_inputs=True, device="cpu")


def test_sweep_chaos_rejects_bad_checkpoint():
    with pytest.raises(ValueError, match="directory path"):
        p_fleet.sweep_chaos(_tiny(PORT), None, checkpoint=7, device="cpu")


def test_session_rejects_bad_guard():
    with pytest.raises(ValueError, match="GuardPolicy"):
        p_session.SweepSession(guard="paranoid")
    with pytest.raises(ValueError, match="GuardPolicy"):
        p_session.set_root(guard=r_guard.GuardPolicy())
    assert p_session.resolve("guard") is None
