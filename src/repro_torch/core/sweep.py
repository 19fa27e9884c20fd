"""Batched design-space sweeps over the policy engine.

``sweep`` evaluates the cross product ``workloads × npus × policies ×
knob_grid`` and returns a flat record table (one dict per cell). The
whole grid runs through ``policies.evaluate_batch``: the workload traces
are stacked into one ragged super-trace, the per-(stack, npu) device
data is reused across the policy/knob axes, and the records fall out of
a handful of segmented tensor passes — no per-cell Python round-trips.

``sweep_reference`` keeps the one-``evaluate``-call-per-cell loop on the
host as the oracle: same records, same order, ≤1e-9 relative.

``sweep_grid`` crosses the §6.5 sensitivity axes (wake-delay scale,
gated leakage ratios, SRAM sleep/off leakage, SA width, detection
window) into a single fine-grid ``evaluate_batch`` call.

Every entry point takes ``device=None``: ``None`` resolves through the
active ``SweepSession`` and otherwise means ``"cuda"``.

Records are emitted in deterministic order: workload-major, then NPU,
then policy, then knob index.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

from repro_torch.core.hw import NPUSpec, get_npu
from repro_torch.core.opgen import Workload, compile_trace
from repro_torch.core.policies import (POLICIES, BatchResult, EnergyReport,
                                       KnobGrid, PolicyKnobs, evaluate,
                                       evaluate_batch, knob_columns)
from repro_torch.core.power import COMPONENTS
from repro_torch.core.session import SweepSession  # noqa: F401  (re-export)


def _flatten(rep: EnergyReport, knobs: PolicyKnobs, knob_idx: int,
             npu: NPUSpec) -> dict:
    """One sweep record from one ``EnergyReport``: the columns of
    ``BatchResult.records()``."""
    rec = {
        "workload": rep.workload,
        "npu": rep.npu,
        "policy": rep.policy,
        # every knob column, unconditionally (KnobGrid.columns()):
        # record consumers (with_savings / group_by) key on these
        **knob_columns(knobs, knob_idx),
        "runtime_s": rep.runtime_s,
        "total_j": rep.total_j,
        "static_total_j": sum(rep.static_j.values()),
        "dynamic_total_j": sum(rep.dynamic_j.values()),
        "static_frac": rep.static_frac,
        "avg_power_w": rep.avg_power_w,
        "setpm_count": rep.setpm_count,
        "setpm_per_1k_cycles": rep.setpm_per_1k_cycles(npu),
        "wake_events": sum(rep.wake_events.values()),
    }
    for c in COMPONENTS:
        rec[f"static_j_{c}"] = rep.static_j[c]
        rec[f"dynamic_j_{c}"] = rep.dynamic_j[c]
    return rec


def sweep(workloads: Sequence[Workload] | Workload,
          npus: Iterable[NPUSpec | str] = ("NPU-D",),
          policies: Iterable[str] = POLICIES,
          knob_grid: Optional[Sequence[PolicyKnobs]] = None,
          device=None) -> list[dict]:
    """Evaluate every (workload, npu, policy, knobs) cell in one batched
    pass; flat records."""
    if isinstance(workloads, Workload):
        workloads = [workloads]
    if knob_grid is None:
        knob_grid = [PolicyKnobs()]
    npu_specs = [get_npu(n) if isinstance(n, str) else n for n in npus]
    return evaluate_batch(workloads, npu_specs, tuple(policies),
                          tuple(knob_grid), device=device).records()


def sweep_reference(workloads: Sequence[Workload] | Workload,
                    npus: Iterable[NPUSpec | str] = ("NPU-D",),
                    policies: Iterable[str] = POLICIES,
                    knob_grid: Optional[Sequence[PolicyKnobs]] = None) \
        -> list[dict]:
    """The loop sweep — one host ``evaluate`` round-trip per cell.

    The oracle for the batched path: same records, same deterministic
    ordering, ≤1e-9 relative on every record field. It runs on the host
    whatever the session's device.
    """
    if isinstance(workloads, Workload):
        workloads = [workloads]
    if knob_grid is None:
        knob_grid = [PolicyKnobs()]
    npu_specs = [get_npu(n) if isinstance(n, str) else n for n in npus]
    records: list[dict] = []
    for wl in workloads:
        compile_trace(wl)  # compile once up front (cached by identity)
        for npu in npu_specs:
            for policy in policies:
                for ki, knobs in enumerate(knob_grid):
                    rep = evaluate(wl, npu, policy, knobs)
                    records.append(_flatten(rep, knobs, ki, npu))
    return records


def knob_product(delay_scale: Sequence[float] = (1.0,),
                 leak_off_logic: Sequence[Optional[float]] = (None,),
                 leak_sram_sleep: Sequence[Optional[float]] = (None,),
                 leak_sram_off: Sequence[Optional[float]] = (None,),
                 sa_width: Sequence[Optional[int]] = (None,),
                 window_scale: Sequence[float] = (1.0,)) \
        -> list[PolicyKnobs]:
    """Thin shim over ``KnobGrid(...).product()``: crosses the §6.5
    sensitivity knobs into a flat knob grid — ``sa_width`` outermost,
    then ``window_scale``, then ``delay_scale``, ``leak_off_logic``,
    ``leak_sram_sleep``, ``leak_sram_off`` innermost. ``None`` leaves
    a knob at the per-NPU Table 3 default (``sa_width=None`` → the
    generation's native width)."""
    return KnobGrid(delay_scale=delay_scale,
                    leak_off_logic=leak_off_logic,
                    leak_sram_sleep=leak_sram_sleep,
                    leak_sram_off=leak_sram_off, sa_width=sa_width,
                    window_scale=window_scale).product()


def sweep_grid(workloads: Sequence[Workload] | Workload,
               npus: Iterable[NPUSpec | str] = ("NPU-D",),
               policies: Iterable[str] = POLICIES, *,
               grid: Optional[KnobGrid] = None,
               delay_scale: Sequence[float] = (1.0,),
               leak_off_logic: Sequence[Optional[float]] = (None,),
               leak_sram_sleep: Sequence[Optional[float]] = (None,),
               leak_sram_off: Sequence[Optional[float]] = (None,),
               sa_width: Sequence[Optional[int]] = (None,),
               window_scale: Sequence[float] = (1.0,),
               device=None, as_records: bool = True):
    """Fine-grid design-space sweep: the §6.5 sensitivity axes crossed
    into one ``evaluate_batch`` call.

    All six axes (``sa_width × window_scale × delay_scale ×
    leak_off_logic × leak_sram_sleep × leak_sram_off``) become the knob
    grid. ``sa_width`` is a real knob (``PolicyKnobs.sa_width``):
    records carry it in their ``sa_width`` column with the NPU name
    untouched, and a width axis costs extra batched (width, delay,
    window) rows inside the kernel, not extra kernel calls.

    Pass the axes as ``grid=KnobGrid(...)`` or as the six axis kwargs
    (which construct the same ``KnobGrid``: identical knob ordering and
    records); mixing the two is rejected. Returns flat records, or the
    ``BatchResult`` cube when ``as_records=False``.
    """
    if isinstance(workloads, Workload):
        workloads = [workloads]
    if sa_width is None:  # the "no width axis" spelling
        sa_width = (None,)
    kwargs_grid = KnobGrid(delay_scale=delay_scale,
                           leak_off_logic=leak_off_logic,
                           leak_sram_sleep=leak_sram_sleep,
                           leak_sram_off=leak_sram_off, sa_width=sa_width,
                           window_scale=window_scale)
    if grid is None:
        grid = kwargs_grid
    elif not isinstance(grid, KnobGrid):
        raise TypeError(f"grid must be a KnobGrid, got "
                        f"{type(grid).__name__}")
    elif kwargs_grid != KnobGrid():
        raise ValueError(
            "pass the knob axes either as grid=KnobGrid(...) or as "
            "the axis kwargs, not both")
    npu_specs = [get_npu(n) if isinstance(n, str) else n for n in npus]
    res: BatchResult = evaluate_batch(
        workloads, npu_specs, tuple(policies), grid, device=device)
    return res.records() if as_records else res


def with_savings(records: list[dict], baseline: str = "NoPG") -> list[dict]:
    """Attach ``savings`` (1 - total_j/baseline_total_j) to each record,
    in one bulk pass over the batched record table.

    A record's baseline is the ``baseline``-policy row of the same
    (workload, npu, knob_idx) cell. When that exact cell is missing,
    the un-gated ``NoPG`` baseline may fall back to the single knob
    point it was evaluated at — e.g. a knob grid that only evaluates
    the baseline at knob 0, which is sound because NoPG never gates
    and so no *gating* knob can change its energy. ``sa_width`` is the
    exception (it moves service times and therefore NoPG energy too),
    so the fallback additionally requires the record's ``sa_width`` to
    match the baseline row's — a width-mismatched denominator would be
    silently wrong, like any gating baseline. Gating baselines get no
    fallback at all. Baseline rows get savings 0.0; cells with no
    resolvable baseline get savings None.
    """
    def eff_width(r):
        """Record's effective SA width: ``None`` (native) and the
        explicitly spelled native width are the same configuration."""
        w = r["sa_width"]
        if w is not None:
            return w
        try:
            return get_npu(r["npu"]).sa_width
        except KeyError:  # ad-hoc spec name: compare the raw value
            return None

    _require_knob_columns(records, "with_savings")

    base: dict[tuple, float] = {}
    per_cell: dict[tuple, list[tuple]] = {}
    for r in records:
        if r["policy"] == baseline:
            base[(r["workload"], r["npu"], r["knob_idx"])] = r["total_j"]
            per_cell.setdefault((r["workload"], r["npu"]), []) \
                .append((r["total_j"], eff_width(r)))
    fallback = {k: v[0] for k, v in per_cell.items()
                if len(v) == 1} if baseline == "NoPG" else {}
    out = []
    for r in records:
        b = base.get((r["workload"], r["npu"], r["knob_idx"]))
        if b is None:
            fb = fallback.get((r["workload"], r["npu"]))
            if fb is not None and fb[1] == eff_width(r):
                b = fb[0]
        r = dict(r)
        r["savings"] = None if b is None else 1.0 - r["total_j"] / b
        out.append(r)
    return out


def _require_knob_columns(records: list[dict], caller: str) -> None:
    """Record-table consumers key on the knob columns; a hand-built
    record missing one would silently mis-baseline or mis-group, so
    fail loudly naming the gap."""
    need = ("knob_idx",) + KnobGrid.columns()
    for i, r in enumerate(records):
        missing = [k for k in need if k not in r]
        if missing:
            raise ValueError(
                f"{caller}: record {i} "
                f"({r.get('workload')!r}/{r.get('policy')!r}) is "
                f"missing knob column(s) {missing}; every sweep record "
                f"carries {need} — rebuild the table with a sweep entry "
                f"point, or fill the defaults explicitly")


def group_by(records: list[dict], *keys: str) -> dict[tuple, list[dict]]:
    """Group records by the given columns, preserving record order.
    A record missing one of ``keys`` fails loudly (records from any
    sweep entry point carry every knob column unconditionally)."""
    out: dict[tuple, list[dict]] = {}
    for i, r in enumerate(records):
        try:
            out.setdefault(tuple(r[k] for k in keys), []).append(r)
        except KeyError as e:
            raise KeyError(
                f"group_by: record {i} ({r.get('workload')!r}/"
                f"{r.get('policy')!r}) has no column {e.args[0]!r}; "
                f"available: {sorted(r)}") from None
    return out
