"""The port's jitter plane (``repro_torch.core.perturb``) against the
reference's ``repro.core.perturb``, bit for bit.

Every transform draws from an explicit ``numpy.random.Generator`` in a
fixed count, in both packages, so the same seed must give the same
perturbed columns, the same perturbed ``Workload`` and the same fuzz
corpus — compared with ``==`` / ``np.array_equal``, no tolerance.
Mirrors ``tests/test_perturb.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import opgen as r_opgen  # noqa: E402
from repro.core import perturb as r_pt  # noqa: E402
from repro_torch.core import opgen as p_opgen  # noqa: E402
from repro_torch.core import perturb as p_pt  # noqa: E402

TRANSFORMS = [
    ("BurstCompression", dict(factor=3.0)),
    ("LinkDegradation", dict(rate=0.4, n_events=3, window_frac=0.15)),
    ("Straggler", dict(slowdown=1.7, frac=0.6)),
    ("ClockJitter", dict(sigma=0.05)),
    ("IdleFragmentation", dict(factor=6, frac=0.5)),
]
SEVERITIES = (0.0, 0.25, 1.0, 1.5, 3.0)


def workloads(opgen):
    return [opgen.llm_workload("llama3-8b", "decode", batch=8, n_chips=8,
                               tp=8, dp=1),
            opgen.dlrm_workload("S"),
            opgen.llm_workload("llama3-8b", "train", batch=32, n_chips=4,
                               tp=4)]


def ops(wl) -> list:
    return [dataclasses.astuple(o) for o in wl.ops]


def same_workloads(got, want):
    assert [w.name for w in got] == [w.name for w in want]
    for a, b in zip(got, want):
        assert (a.kind, a.n_chips, a.note) == (b.kind, b.n_chips, b.note)
        assert ops(a) == ops(b), a.name


def columns(wl) -> dict:
    return {
        "flops_sa": np.array([o.flops_sa for o in wl.ops], np.float64),
        "flops_vu": np.array([o.flops_vu for o in wl.ops], np.float64),
        "bytes_hbm": np.array([o.bytes_hbm for o in wl.ops], np.float64),
        "bytes_ici": np.array([o.bytes_ici for o in wl.ops], np.float64),
        "count": np.array([o.count for o in wl.ops], np.float64),
        "collective": np.array([o.collective for o in wl.ops], bool),
    }


@pytest.mark.parametrize("name,kw", TRANSFORMS, ids=[t[0] for t in TRANSFORMS])
@pytest.mark.parametrize("seed", [0, 7])
def test_each_transform_matches_reference(name, kw, seed):
    for wl in workloads(r_opgen):
        rng_r, rng_p = (np.random.default_rng(seed) for _ in range(2))
        want = getattr(r_pt, name)(**kw).apply(columns(wl), rng_r)
        got = getattr(p_pt, name)(**kw).apply(columns(wl), rng_p)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (name, wl.name, k)
        # the same number of draws: the streams stay in step
        assert rng_p.random() == rng_r.random()


@pytest.mark.parametrize("severity", SEVERITIES)
def test_severity_plan_and_suite_match_reference(severity):
    plan_r, plan_p = r_pt.severity_plan(severity), p_pt.severity_plan(severity)
    assert [(type(p).__name__, dataclasses.astuple(p)) for p in plan_p] \
        == [(type(p).__name__, dataclasses.astuple(p)) for p in plan_r]
    same_workloads(
        p_pt.perturb_suite(workloads(p_opgen), plan_p, seed=11, stream=2),
        r_pt.perturb_suite(workloads(r_opgen), plan_r, seed=11, stream=2))


def test_perturb_workload_and_severity_variants_match_reference():
    plan_r, plan_p = r_pt.severity_plan(1.0), p_pt.severity_plan(1.0)
    for seed in (0, 1234):
        same_workloads(
            [p_pt.perturb_workload(workloads(p_opgen)[0], plan_p,
                                   np.random.default_rng(seed), name="x")],
            [r_pt.perturb_workload(workloads(r_opgen)[0], plan_r,
                                   np.random.default_rng(seed), name="x")])
    got = p_pt.severity_variants(workloads(p_opgen), (0.0, 0.5, 2.0), seed=4)
    want = r_pt.severity_variants(workloads(r_opgen), (0.0, 0.5, 2.0), seed=4)
    assert list(got) == list(want)
    for sev in want:
        same_workloads(got[sev], want[sev])


def test_fault_severity_matches_reference():
    rng = np.random.default_rng(9)
    for _ in range(50):
        f = float(rng.random())
        lr = rng.random(int(rng.integers(0, 6)))
        lr[rng.random(lr.size) < 0.2] = 0.0
        for pg in (False, True):
            assert p_pt.fault_severity(f, lr, pg) \
                == r_pt.fault_severity(f, lr, pg)
    assert p_pt.fault_severity(0.0) == r_pt.fault_severity(0.0) == 0.0


def test_validation_matches_reference():
    bad = [("severity_plan", (-1.0,)), ("severity_plan", (float("nan"),)),
           ("fault_severity", (1.5,)), ("fault_severity", (0.1, [1.2]))]
    for fn, args in bad:
        with pytest.raises(ValueError):
            getattr(r_pt, fn)(*args)
        with pytest.raises(ValueError):
            getattr(p_pt, fn)(*args)
    for name, kw in (("BurstCompression", dict(factor=0.5)),
                     ("LinkDegradation", dict(rate=0.0)),
                     ("Straggler", dict(frac=1.5)),
                     ("IdleFragmentation", dict(factor=2.5)),
                     ("ClockJitter", dict(sigma=-0.1))):
        with pytest.raises(ValueError):
            getattr(p_pt, name)(**kw)
    with pytest.raises(TypeError):
        p_pt.perturb_workload(workloads(p_opgen)[0], p_pt.severity_plan(1.0),
                              np.random.RandomState(0))


def _events(evs) -> list:
    def instr(i):
        return (i.opcode, i.unit, i.latency, i.pm_fu_type, i.pm_bitmap,
                None if i.pm_mode is None else i.pm_mode.value, i.pm_range)
    return [(c, sorted((k, instr(v)) for k, v in b.items())) for c, b in evs]


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_adversarial_events_match_reference(seed):
    rng_r, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        ev_r, hz_r = r_pt.adversarial_events(rng_r, n_events=40)
        ev_p, hz_p = p_pt.adversarial_events(rng_p, n_events=40)
        assert hz_p == hz_r and _events(ev_p) == _events(ev_r)


def test_differential_fuzz_matches_reference():
    assert p_pt.differential_fuzz(60, seed=5) \
        == r_pt.differential_fuzz(60, seed=5)
    stats = p_pt.differential_fuzz(30, seed=6, n_events=60, npu="NPU-B")
    assert stats["mismatches"] == 0 and stats["runs"] == 60
