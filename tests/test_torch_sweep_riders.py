"""The port's sweep-plane riders against the reference's: the ICI
topology model (``ici_topology``), carbon (``carbon``), the SLO search
and its re-tune governor (``slo``), and ``sweep.sweep_robustness``.

All of it is host numpy in both packages (seeded streams stay
``numpy.random.Generator``), so every output must equal the
reference's exactly; the one exception is what rides the batched sweep
(``slo_sweep``, ``sweep_robustness``), whose policy side is
``evaluate_batch`` on the CPU against the reference's numpy backend:
≤1e-9 relative, the sweep's parity bar. Mirrors
``tests/test_ici_topology.py``, ``tests/test_robustness_sweep.py``,
``tests/test_retune_properties.py`` and the slo part of
``tests/test_compression_slo.py``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import carbon as r_carbon  # noqa: E402
from repro.core import ici_topology as r_ici  # noqa: E402
from repro.core import opgen as r_opgen  # noqa: E402
from repro.core import slo as r_slo  # noqa: E402
from repro_torch.core import carbon as p_carbon  # noqa: E402
from repro_torch.core import ici_topology as p_ici  # noqa: E402
from repro_torch.core import opgen as p_opgen  # noqa: E402
from repro_torch.core import slo as p_slo  # noqa: E402
from repro_torch.core.session import SweepSession  # noqa: E402

from _sweep_equiv import rel  # noqa: E402

r_sweep = importlib.import_module("repro.core.sweep")
p_sweep = importlib.import_module("repro_torch.core.sweep")

RTOL = 1e-9
TOPOLOGIES = [("ring", (1,)), ("ring", (2,)), ("ring", (8,)),
              ("mesh2d", (4, 4)), ("mesh2d", (2, 8)), ("mesh2d", (1, 5)),
              ("mesh2d", (16, 16))]
KINDS = ("all_reduce", "all_gather", "all_to_all")


def ops(wl) -> list:
    return [dataclasses.astuple(o) for o in wl.ops]


# ------------------------------------------------------------ topology
@pytest.mark.parametrize("n_chips", [1, 2, 7, 8, 9, 12, 64, 256])
def test_topology_for_matches_reference(n_chips):
    for kind in (None, "ring", "mesh2d"):
        a, b = r_ici.topology_for(n_chips, kind), \
            p_ici.topology_for(n_chips, kind)
        assert (b.kind, b.shape, b.n_chips) == (a.kind, a.shape, a.n_chips)
        assert p_ici.n_links(b) == r_ici.n_links(a)


@pytest.mark.parametrize("kind,shape", TOPOLOGIES,
                         ids=[f"{k}{s}" for k, s in TOPOLOGIES])
def test_collective_schedules_match_reference(kind, shape):
    topo_r, topo_p = r_ici.Topology(kind, shape), p_ici.Topology(kind, shape)
    nl = r_ici.n_links(topo_r)
    rng = np.random.default_rng(nl)
    for ck in KINDS:
        clean = p_ici.collective_schedule(ck, topo_p)
        assert np.array_equal(clean, r_ici.collective_schedule(ck, topo_r))
        if clean.size == 0:
            continue
        for per_step in (False, True):
            rates = rng.uniform(0.1, 1.0, (clean.size, nl) if per_step
                                else (nl,))
            rates[..., 0] = 0.0  # one cut a ring: the detour reroute
            rates = r_ici.resolve_link_rates(rates, topo_r)
            assert np.array_equal(p_ici.resolve_link_rates(rates, topo_p),
                                  rates)
            assert np.array_equal(
                p_ici.collective_schedule(ck, topo_p, rates),
                r_ici.collective_schedule(ck, topo_r, rates))


def test_partitioned_ring_raises_like_reference():
    topo_r, topo_p = r_ici.Topology("ring", (6,)), p_ici.Topology("ring",
                                                                  (6,))
    rates = np.array([0.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    for ici, topo in ((r_ici, topo_r), (p_ici, topo_p)):
        with pytest.raises(ValueError):
            ici.collective_schedule("all_reduce", topo, rates)
    with pytest.raises(ValueError):
        p_ici.Topology("torus", (4,))
    for name in ("ar_grad", "moe_alltoall", "ag_weights", "x_a2a", "y"):
        assert p_ici.schedule_kind(name) == r_ici.schedule_kind(name)


@pytest.mark.parametrize("wl_idx", [0, 4, 8, 12, 14])
def test_lower_collectives_and_busy_idle_match_reference(wl_idx):
    wl_r, wl_p = r_opgen.paper_suite()[wl_idx], p_opgen.paper_suite()[wl_idx]
    for kw in (dict(), dict(staging=False)):
        a, b = r_ici.lower_collectives(wl_r, **kw), \
            p_ici.lower_collectives(wl_p, **kw)
        assert (b.name, b.note, b.n_chips) == (a.name, a.note, a.n_chips)
        assert ops(b) == ops(a)
    topo = r_ici.topology_for(max(1, wl_r.n_chips))
    nl = r_ici.n_links(topo)
    if nl:
        rates = np.linspace(0.3, 1.0, nl)
        assert ops(p_ici.lower_collectives(
            wl_p, p_ici.topology_for(max(1, wl_p.n_chips)),
            link_rates=rates)) == ops(r_ici.lower_collectives(
                wl_r, topo, link_rates=rates))
    for npu in ("NPU-A", "NPU-D"):
        a, b = r_ici.ici_busy_idle(wl_r, npu), p_ici.ici_busy_idle(wl_p, npu)
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(b[k], a[k]), k


# -------------------------------------------------------------- carbon
def test_carbon_matches_reference():
    for npu in ("NPU-A", "NPU-C", "NPU-E"):
        for w in (80.0, 310.5):
            for gated in (False, True):
                assert p_carbon.yearly_carbon(w, npu, gated, workload="x") \
                    .__dict__ == r_carbon.yearly_carbon(
                        w, npu, gated, workload="x").__dict__
    for j in (0.0, 1.0, 3.6e6, 1.234e12):
        assert dataclasses.astuple(p_carbon.fleet_rollup(j)) \
            == dataclasses.astuple(r_carbon.fleet_rollup(j))
    with pytest.raises(ValueError):
        p_carbon.fleet_rollup(-1.0)
    assert p_carbon.optimal_lifespan(250.0) == r_carbon.optimal_lifespan(250.0)
    assert p_carbon.optimal_lifespan(90.0, efficiency_ratio=0.8,
                                     horizon_years=7) \
        == r_carbon.optimal_lifespan(90.0, efficiency_ratio=0.8,
                                     horizon_years=7)
    assert p_carbon._d_over_c_yearly_ratio() \
        == r_carbon._d_over_c_yearly_ratio()


# ----------------------------------------------------------------- slo
def test_violation_rate_matches_reference():
    rng = np.random.default_rng(2)
    r, b = rng.uniform(0.5, 2, 50), rng.uniform(0.5, 2, 50)
    for relax in (1.0, 1.1, 2.0):
        assert p_slo.runtime_violation_rate(r, b, relax) \
            == r_slo.runtime_violation_rate(r, b, relax)
    assert p_slo.runtime_violation_rate([], []) == 0.0
    with pytest.raises(ValueError):
        p_slo.runtime_violation_rate(r, b[:3])


def _tables(seed, n, k):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, (n, k)), rng.uniform(0.5, 2.0, (n, k)),
            rng.uniform(0.4, 2.2, (n, 1)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_retune_knobs_stateless_matches_reference(seed):
    e, r, b = _tables(seed, 12, 7)
    assert np.array_equal(p_slo.retune_knobs(e, r, b),
                          r_slo.retune_knobs(e, r, b))
    dep = np.random.default_rng(seed + 50).integers(0, 7, 12)
    assert np.array_equal(p_slo.retune_knobs(e, r, b, dep),
                          r_slo.retune_knobs(e, r, b, dep))


@pytest.mark.parametrize("seed", [0, 1])
def test_hysteresis_governor_matches_reference(seed):
    """The stateful governor over 25 epochs of a flapping environment:
    the same choices and the same state after every epoch."""
    hy_r = r_slo.Hysteresis(cooldown_epochs=2, min_improvement=0.05,
                            backoff_base=2.0, backoff_cap=8)
    hy_p = p_slo.Hysteresis(cooldown_epochs=2, min_improvement=0.05,
                            backoff_base=2.0, backoff_cap=8)
    st_r, st_p = r_slo.GovernorState.init(10, hy_r), \
        p_slo.GovernorState.init(10, hy_p)
    dep_r = dep_p = np.zeros(10, np.int64)
    for epoch in range(25):
        e, r, b = _tables(seed * 100 + epoch % 4, 10, 6)
        dep_r = r_slo.retune_knobs(e, r, b, dep_r, hysteresis=hy_r,
                                   state=st_r)
        dep_p = p_slo.retune_knobs(e, r, b, dep_p, hysteresis=hy_p,
                                   state=st_p)
        assert np.array_equal(dep_p, dep_r), epoch
        for f in ("since_retune", "cooldown", "forced_streak", "retunes"):
            assert np.array_equal(getattr(st_p, f), getattr(st_r, f)), f
    with pytest.raises(ValueError):
        p_slo.retune_knobs(e, r, b, hysteresis=hy_p, state=st_p)
    with pytest.raises(ValueError):
        p_slo.Hysteresis(min_improvement=1.5)


def test_slo_sweep_matches_reference():
    kw = dict(batches=(8, 128), chip_counts=(1, 2, 4, 8))
    want = r_slo.slo_sweep("llama3-8b", "decode", backend="numpy", **kw)
    got = p_slo.slo_sweep("llama3-8b", "decode", device="cpu", **kw)
    assert set(got) == set(want)
    assert rel(got["_slo"], want["_slo"]) <= RTOL
    for gen, pt in want.items():
        if gen == "_slo":
            continue
        assert (pt is None) == (got[gen] is None), gen
        if pt is not None:
            q = got[gen]
            assert (q.npu, q.n_chips, q.batch, q.work) \
                == (pt.npu, pt.n_chips, pt.batch, pt.work)
            assert rel(q.perf, pt.perf) <= RTOL
            assert rel(q.energy_j, pt.energy_j) <= RTOL
    for phase in ("train", "decode"):
        assert p_slo.hbm_fits("llama3-70b", "NPU-B", 8, 32, phase) \
            == r_slo.hbm_fits("llama3-70b", "NPU-B", 8, 32, phase)


# ---------------------------------------------------------- robustness
@pytest.mark.parametrize("topology", [True, False])
def test_sweep_robustness_matches_reference(topology):
    kw = dict(npus=("NPU-D",), policies=("ReGate-HW", "ReGate-Base"),
              severities=(0.0, 1.0, 2.0), threshold_scales=(0.25, 1.0, 4.0),
              seed=3, topology=topology)
    want = r_sweep.sweep_robustness(r_opgen.paper_suite()[10:12],
                                    backend="numpy", **kw)
    with SweepSession(device="cpu"):
        got = p_sweep.sweep_robustness(p_opgen.paper_suite()[10:12], **kw)
    assert got["severities"] == want["severities"]
    assert got["threshold_scales"] == want["threshold_scales"]
    for key in ("records", "summary"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(want[key], got[key]):
            assert set(a) == set(b)
            for k, va in a.items():
                if isinstance(va, (str, bool, type(None))) \
                        or k == "knob_idx":
                    assert b[k] == va, (key, k)
                else:
                    assert rel(b[k], va) <= RTOL, (key, k, va, b[k])
    with pytest.raises(ValueError):
        p_sweep.sweep_robustness(p_opgen.paper_suite()[10:11],
                                 threshold_scales=(0.0,), device="cpu")
