"""The port's fault timelines (``repro_torch.core.faults``) against the
reference's ``repro.core.faults``.

All of it is host numpy in both packages (seeded streams stay
``numpy.random.Generator``), so every timeline, every ``chaos_fuzz``
statistic and every validation message must equal the reference's
exactly. Mirrors the fault-timeline cases of ``tests/test_chaos.py`` and
the chaos-plane part of ``tests/test_validation.py``, case for case,
each run through both packages.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as r_faults  # noqa: E402
from repro.core import perturb as r_perturb  # noqa: E402
from repro.core import slo as r_slo  # noqa: E402
from repro_torch.core import faults as p_faults  # noqa: E402
from repro_torch.core import perturb as p_perturb  # noqa: E402
from repro_torch.core import slo as p_slo  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMELINE_ARRAYS = ("chips_down", "link_rates", "pg_fault", "severity_hint")


def assert_timelines_equal(ref, got):
    assert (got.n_epochs, got.n_chips, got.n_links) \
        == (ref.n_epochs, ref.n_chips, ref.n_links)
    for name in TIMELINE_ARRAYS:
        a, b = getattr(ref, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.n_transitions == ref.n_transitions
    assert got.repair_epochs() == ref.repair_epochs()
    assert np.array_equal(got.any_fault(), ref.any_fault())


def both(fn):
    """``fn`` applied to the reference's module and to the port's."""
    return fn(r_faults), fn(p_faults)


# --------------------------------------------------------------------------
# fault plans and timelines: equal to the reference's, array for array
# --------------------------------------------------------------------------

@pytest.mark.parametrize("severity", [0.0, 0.3, 1.0, 1.5, 2.0, 5.0])
def test_fault_plan_matches_reference(severity):
    ref, got = both(lambda m: m.fault_plan(severity))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_timeline_seed_determinism():
    def build(m, seed):
        return m.build_fault_timeline(m.fault_plan(1.5), n_epochs=48,
                                      n_chips=32, n_links=8, seed=seed)
    a = build(p_faults, 7)
    assert_timelines_equal(build(r_faults, 7), a)
    assert_timelines_equal(a, build(p_faults, 7))
    c = build(p_faults, 8)
    assert_timelines_equal(build(r_faults, 8), c)
    assert (a.chips_down != c.chips_down).any() \
        or (a.link_rates != c.link_rates).any()


def test_per_link_streams_independent_of_fleet_shape():
    def build(m, n_links):
        return m.build_fault_timeline(m.fault_plan(2.0), n_epochs=48,
                                      n_chips=16, n_links=n_links, seed=7)
    small, wide = build(p_faults, 8), build(p_faults, 24)
    assert_timelines_equal(build(r_faults, 8), small)
    assert_timelines_equal(build(r_faults, 24), wide)
    assert (wide.link_rates[:, :8] == small.link_rates).all()
    assert (wide.chips_down == small.chips_down).all()


def test_chip_streams_independent_of_link_spec():
    def build(m, harsh):
        base = m.fault_plan(1.5)
        spec = base if not harsh else m.FaultSpec(
            chip=base.chip,
            link=m.LinkFaultSpec(flap_prob=0.9, down_prob=0.5))
        return m.build_fault_timeline(spec, n_epochs=48, n_chips=32,
                                      n_links=8, seed=7)
    a, b = build(p_faults, False), build(p_faults, True)
    assert_timelines_equal(build(r_faults, False), a)
    assert_timelines_equal(build(r_faults, True), b)
    assert (a.chips_down == b.chips_down).all()
    assert (a.pg_fault == b.pg_fault).all()


def test_fault_plan_zero_is_clean():
    ref, tl = both(lambda m: m.build_fault_timeline(
        m.fault_plan(0.0), n_epochs=24, n_chips=16, n_links=8, seed=0))
    assert_timelines_equal(ref, tl)
    assert not tl.any_fault().any()
    assert tl.n_transitions == 0 and tl.repair_epochs() == []
    empty = p_faults.FaultTimeline.empty(24, 16, 8)
    assert_timelines_equal(r_faults.FaultTimeline.empty(24, 16, 8), empty)
    assert (tl.chips_down == empty.chips_down).all()
    assert (tl.link_rates == empty.link_rates).all()


@pytest.mark.parametrize("severity,seed,n_epochs,n_chips,n_links", [
    (0.5, 0, 96, 4096, 0), (1.0, (7, 3), 96, 4096, 64),
    (2.0, (3, 2 ** 40), 40, 8, 16), (4.0, 11, 12, 1, 3)])
def test_seeded_timelines_match_reference(severity, seed, n_epochs,
                                          n_chips, n_links):
    ref, got = both(lambda m: m.build_fault_timeline(
        m.fault_plan(severity), n_epochs=n_epochs, n_chips=n_chips,
        n_links=n_links, seed=seed))
    assert_timelines_equal(ref, got)
    assert (got.has_chip_faults, got.has_link_faults, got.has_pg_faults) \
        == (ref.has_chip_faults, ref.has_link_faults, ref.has_pg_faults)


@pytest.mark.parametrize("n_programs,seed,n_events", [(6, 0, 40),
                                                      (4, 5, 24)])
def test_chaos_fuzz_stats_match_reference(n_programs, seed, n_events):
    ref, got = both(lambda m: m.chaos_fuzz(n_programs, seed,
                                           n_events=n_events))
    assert got == ref
    assert got["mismatches"] == 0 and got["programs"] == n_programs


def test_fuzz_cli_runs():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.faults", "--fuzz", "3",
         "--events", "16"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    stats = r_faults.chaos_fuzz(3, 0, n_events=16)
    assert f"{stats['runs']} runs, {stats['events']} events, " \
        f"{stats['cycles']} ref cycles, 0 mismatches" in proc.stdout


# --------------------------------------------------------------------------
# validation: the same error, naming the same field, in both packages
# --------------------------------------------------------------------------

def raises_alike(fn, match):
    """``fn(module)`` raises ``ValueError`` naming ``match`` for the
    reference's module and for the port's, with the same message."""
    msgs = []
    for m in (r_faults, p_faults):
        with pytest.raises(ValueError, match=match) as e:
            fn(m)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kwargs,field", [
    ({"mtbf_epochs": 0.0}, "mtbf_epochs"),
    ({"mtbf_epochs": -5.0}, "mtbf_epochs"),
    ({"mtbf_epochs": float("nan")}, "mtbf_epochs"),
    ({"repair_epochs": 0}, "repair_epochs"),
    ({"repair_epochs": 2.5}, "repair_epochs"),
    ({"drain_every": -1}, "drain_every"),
    ({"drain_frac": -0.1}, "drain_frac"),
    ({"drain_frac": 1.5}, "drain_frac"),
    ({"drain_epochs": 0}, "drain_epochs"),
    ({"pg_fault_prob": float("inf")}, "pg_fault_prob"),
    ({"pg_fault_prob": -0.2}, "pg_fault_prob"),
])
def test_chip_fault_spec_rejects_bad_params(kwargs, field):
    raises_alike(lambda m: m.ChipFaultSpec(**kwargs), field)


@pytest.mark.parametrize("kwargs,field", [
    ({"flap_prob": -0.1}, "flap_prob"),
    ({"flap_prob": 1.1}, "flap_prob"),
    ({"flap_epochs": 0}, "flap_epochs"),
    ({"degrade_prob": float("nan")}, "degrade_prob"),
    ({"degrade_rate": 0.0}, "degrade_rate"),
    ({"degrade_rate": 1.0}, "degrade_rate"),
    ({"degrade_rate": -0.5}, "degrade_rate"),
    ({"degrade_epochs": -2}, "degrade_epochs"),
    ({"down_prob": 2.0}, "down_prob"),
    ({"down_epochs": 0}, "down_epochs"),
])
def test_link_fault_spec_rejects_bad_params(kwargs, field):
    raises_alike(lambda m: m.LinkFaultSpec(**kwargs), field)


def test_fault_spec_rejects_wrong_member_types():
    with pytest.raises(ValueError, match="ChipFaultSpec"):
        p_faults.FaultSpec(chip={"mtbf_epochs": 10})
    with pytest.raises(ValueError, match="LinkFaultSpec"):
        p_faults.FaultSpec(link=0.5)
    # a member from the other package is not a member of this one
    with pytest.raises(ValueError, match="ChipFaultSpec"):
        p_faults.FaultSpec(chip=r_faults.ChipFaultSpec())


def test_fault_plan_rejects_bad_severity():
    for bad in (-0.5, float("nan"), float("inf"), "high"):
        raises_alike(lambda m: m.fault_plan(bad), "severity")


@pytest.mark.parametrize("seed", [
    None, 1.5, "zero", (), (1, 2.5), True, np.random.default_rng(0),
])
def test_build_timeline_rejects_bad_seed(seed):
    with pytest.raises(ValueError, match="seed"):
        p_faults.build_fault_timeline(p_faults.FaultSpec(), n_epochs=4,
                                      n_chips=2, seed=seed)


def test_build_timeline_rejects_bad_dims():
    raises_alike(lambda m: m.build_fault_timeline(
        m.FaultSpec(), n_epochs=0, n_chips=2), "n_epochs")
    raises_alike(lambda m: m.build_fault_timeline(
        m.FaultSpec(), n_epochs=4, n_chips=0), "n_chips")
    raises_alike(lambda m: m.build_fault_timeline(
        m.FaultSpec(), n_epochs=4, n_chips=2, n_links=-1), "n_links")
    raises_alike(lambda m: m.build_fault_timeline(
        None, n_epochs=4, n_chips=2), "FaultSpec")


def test_fault_timeline_rejects_inconsistent_arrays():
    ok = p_faults.FaultTimeline.empty(4, 8, 2)
    bad = [
        ("chips_down", dict(chips_down=np.zeros(3, np.int64))),
        ("chips_down", dict(chips_down=np.full(4, 9, np.int64))),
        ("link_rates", dict(link_rates=np.full((4, 2), 1.5))),
        ("link_rates", dict(link_rates=np.ones((4, 3)))),
        ("pg_fault", dict(pg_fault=np.zeros(4, np.int64))),
        ("severity_hint", dict(severity_hint=np.full(4, -1.0))),
    ]
    for field, over in bad:
        kw = {k: getattr(ok, k) for k in TIMELINE_ARRAYS}
        kw.update(over)
        raises_alike(lambda m: m.FaultTimeline(4, 8, 2, **kw), field)


def test_fault_severity_rejects_bad_inputs():
    for m in (r_perturb, p_perturb):
        with pytest.raises(ValueError, match="chip_down_frac"):
            m.fault_severity(-0.1)
        with pytest.raises(ValueError, match="chip_down_frac"):
            m.fault_severity(float("nan"))
        with pytest.raises(ValueError, match="link_rates"):
            m.fault_severity(0.0, link_rates=[1.0, 2.0])


@pytest.mark.parametrize("kwargs,field", [
    ({"cooldown_epochs": -1}, "cooldown_epochs"),
    ({"cooldown_epochs": 1.5}, "cooldown_epochs"),
    ({"min_improvement": -0.1}, "min_improvement"),
    ({"min_improvement": 1.0}, "min_improvement"),
    ({"backoff_base": 0.5}, "backoff_base"),
    ({"backoff_base": float("nan")}, "backoff_base"),
    ({"backoff_cap": 0}, "backoff_cap"),
])
def test_hysteresis_rejects_bad_params(kwargs, field):
    for m in (r_slo, p_slo):
        with pytest.raises(ValueError, match=field):
            m.Hysteresis(**kwargs)
