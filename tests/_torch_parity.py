"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

The comparison rule is the one of ``_sweep_equiv``: strings, ``None``
and ``knob_idx`` compare exactly, every numeric field within ``rtol``
relative with a 1e-30 floor on the denominator. The ``dump_*`` helpers
turn the reference's objects into plain numpy arrays / dicts, which is
all ``repro_torch.convert`` ever sees of them.
"""
import dataclasses

import numpy as np

from _sweep_equiv import RTOL, assert_records_match, rel  # noqa: F401

from repro.core import policies as ref_policies
from repro_torch.core import policies as port_policies
from repro_torch.core.guard import cube_max_rel, tree_max_rel

STACK_COLUMNS = ("flops_sa", "flops_vu", "bytes_hbm", "bytes_ici",
                 "sram_demand", "count", "collective", "has_mm")
MM_COLUMNS = ("mm_m", "mm_k", "mm_n")
CUBE_FIELDS = ("static_j", "dynamic_j", "wake_events", "gated_s", "setpm_by")


def knob_pair(**kw):
    """The same knob point for the reference and for the port."""
    return ref_policies.PolicyKnobs(**kw), port_policies.PolicyKnobs(**kw)


def knob_grids(rows):
    """``rows`` of knob kwargs -> (reference grid, port grid)."""
    pairs = [knob_pair(**kw) for kw in rows]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def max_rel_dev(ref: list, got: list) -> float:
    """Worst relative deviation over every numeric record field; raises
    if orderings or field sets differ."""
    assert len(ref) == len(got), (len(ref), len(got))
    worst = 0.0
    for a, b in zip(ref, got):
        assert set(a) == set(b), set(a) ^ set(b)
        for k, va in a.items():
            vb = b[k]
            if isinstance(va, (str, type(None))) or k == "knob_idx":
                assert va == vb, (k, va, vb)
            else:
                worst = max(worst, rel(va, vb))
    return worst


def assert_cubes_match(ref, got, rtol: float = RTOL, exact: bool = False):
    """Two ``BatchResult`` cubes, field by field and component by
    component: within ``rtol`` relative, or bit for bit."""
    assert ref.shape == got.shape
    assert tuple(ref.workloads) == tuple(got.workloads)
    assert tuple(ref.policies) == tuple(got.policies)

    if not exact:   # the rule chip_smoke.py holds the card to
        cube_max_rel(ref, got, rtol)
        return
    assert np.array_equal(ref.runtime_s, got.runtime_s), "runtime_s"
    for f in CUBE_FIELDS:
        for c, arr in getattr(ref, f).items():
            assert np.array_equal(arr, getattr(got, f)[c]), (f, c)


def dump_stack(st) -> tuple[dict, tuple, np.ndarray]:
    """A reference ``StackedTrace`` as (columns, names, offsets) of plain
    numpy data."""
    cols = {k: np.array(getattr(st, k)) for k in STACK_COLUMNS}
    for k in MM_COLUMNS:
        parts = [getattr(tr, k) for tr in st.traces]
        cols[k] = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return cols, tuple(st.names), np.array(st.offsets)


def dump_npu(spec) -> dict:
    return dataclasses.asdict(spec)


def dump_knobs(grid) -> list:
    return [dataclasses.asdict(k) for k in grid]


def random_ops(rng: np.random.Generator, n_ops: int) -> list:
    """Adversarial op stream as a list of ``Op`` kwargs: per-op random
    component mix, long idle runs, pure-idle ops — the shapes where
    cross-workload gap leakage would show up. Both packages build their
    own ``Op`` objects from the same kwargs."""
    ops = []
    for j in range(n_ops):
        kind = rng.random()
        flops_sa = float(rng.uniform(1e9, 5e12)) if kind < 0.45 else 0.0
        mm = None
        if flops_sa and rng.random() < 0.8:
            mm = (int(rng.integers(1, 4096)), int(rng.integers(1, 512)),
                  int(rng.integers(1, 4096)))
        bytes_ici = float(rng.uniform(1e6, 1e9)) \
            if rng.random() < 0.15 else 0.0
        ops.append(dict(
            name=f"op{j}", flops_sa=flops_sa,
            flops_vu=float(rng.uniform(1e8, 5e11))
            if rng.random() < 0.5 else 0.0,
            bytes_hbm=float(rng.uniform(1e6, 1e10))
            if rng.random() < 0.6 else 0.0,
            bytes_ici=bytes_ici,
            sram_demand=int(rng.integers(0, 256 << 20)),
            matmul_dims=mm, count=int(rng.integers(1, 5)),
            collective=bytes_ici > 0))
    return ops


def build_workloads(opgen_mod, specs: list) -> list:
    """``specs`` = [(name, [op kwargs, ...]), ...] -> Workloads of the
    given package's ``opgen`` module."""
    return [opgen_mod.Workload(name, "prefill",
                               tuple(opgen_mod.Op(**kw) for kw in ops))
            for name, ops in specs]


def assert_trees_match(ref, got, rtol: float = RTOL, path: str = "") \
        -> float:
    """Nested dicts / lists / tuples of plain values (a report's
    ``to_dict()`` form): the same keys and lengths, every ``str``,
    ``bool``, ``int`` and ``None`` exactly, every float within ``rtol``
    relative (the port's ``guard.tree_max_rel``, which ``chip_smoke.py``
    holds the card to). Returns the worst relative deviation."""
    return tree_max_rel(ref, got, rtol, path)


def fleet_report_tree(report) -> dict:
    """A ``FleetReport``'s fields as plain values, without the guard log
    and the live epoch inputs."""
    skip = ("guard", "epoch_inputs")
    return {f.name: getattr(report, f.name)
            for f in dataclasses.fields(report) if f.name not in skip}


def assert_fleet_reports_match(ref, got, rtol: float = RTOL) -> float:
    """The port's ``FleetReport`` against the reference's: arrival
    counts, severity indices, chosen and deployed knobs, retune flags,
    chip allocations and every other integer or flag exactly; every
    float (energies, runtimes, backlog and shed volumes) within
    ``rtol``. Returns the worst relative deviation."""
    return assert_trees_match(fleet_report_tree(ref),
                              fleet_report_tree(got), rtol)
