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

``sweep_fleet`` and ``sweep_chaos`` (lazy re-exports of
``repro_torch.core.fleet``) run a chip fleet over a day of seeded
arrivals, one ``evaluate_batch`` call per epoch, clean or under seeded
fault timelines; ``GuardPolicy`` arms their guard plane.

``sweep_robustness`` crosses idle-detection thresholds against seeded
trace perturbations (the jitter plane); ``sweep_program_plane`` runs
the software-managed program plane (the lowered, ``setpm``-instrumented
programs through the batched event executor) against the closed-form
``ReGate-Full`` policy, with ``sweep_program_plane_reference`` as its
per-cell oracle.

Every entry point takes ``device=None`` and ``mesh=None``: ``None``
resolves through the active ``SweepSession`` and otherwise means
``"cuda"`` and no mesh. A mesh (``parallel.dist.sweep_mesh``) shards the
call over the ranks of a ``torch.distributed`` world: each rank makes the
same call and gets the whole result (``policies.evaluate_batch``; the
program plane shards its executor's rows).

Records are emitted in deterministic order: workload-major, then NPU,
then policy, then knob index.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.hw import NPUSpec, get_npu
from repro_torch.core.opgen import Workload, compile_trace
from repro_torch.core.policies import (POLICIES, BatchResult, EnergyReport,
                                       KnobGrid, PolicyKnobs, evaluate,
                                       evaluate_batch, knob_columns)
from repro_torch.core.guard import (GuardPolicy,  # noqa: F401  (re-export)
                                    GuardReport)
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
          device=None, mesh=None) -> list[dict]:
    """Evaluate every (workload, npu, policy, knobs) cell in one batched
    pass; flat records."""
    if isinstance(workloads, Workload):
        workloads = [workloads]
    if knob_grid is None:
        knob_grid = [PolicyKnobs()]
    npu_specs = [get_npu(n) if isinstance(n, str) else n for n in npus]
    return evaluate_batch(workloads, npu_specs, tuple(policies),
                          tuple(knob_grid), device=device,
                          mesh=mesh).records()


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
               device=None, mesh=None, as_records: bool = True):
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
        workloads, npu_specs, tuple(policies), grid, device=device,
        mesh=mesh)
    return res.records() if as_records else res


def sweep_robustness(workloads: Sequence[Workload] | Workload,
                     npus: Iterable[NPUSpec | str] = ("NPU-D",),
                     policies: Iterable[str] = ("ReGate-HW",), *,
                     severities: Sequence[float] = (0.0, 0.5, 1.0),
                     threshold_scales: Sequence[float] =
                     (0.25, 0.5, 1.0, 2.0, 4.0),
                     seed: int = 0, slo_relax: float = 1.1,
                     topology: bool = True, device=None,
                     mesh=None) -> dict:
    """Idle-detection robustness sweep (jitter plane).

    Crosses HW idle-detection thresholds (``threshold_scales``, the
    ``window_scale`` knob — it scales ONLY the idle-detection window,
    the paper's BET/3 design point, leaving BETs and wake delays at
    their Table 3 values, so aggressive and conservative detection
    genuinely trade off and a clean-tuned threshold can regret under
    jitter) against perturbation severities (``perturb.severity_plan``
    applied with deterministic per-(severity, workload) generators seeded
    from ``seed``) in ONE ``sweep_grid``-style ``evaluate_batch`` pass:
    every (severity x workload) variant is stacked into the super-trace,
    with ``topology=True`` first lowering collectives onto their ring /
    2-D-mesh step schedules (``ici_topology``). ``device`` is where
    the one ``evaluate_batch`` pass runs (``None``: the session's).

    Reports, per (npu, policy, severity):

    * ``worst_exposed_wake_s`` — worst over workloads of the exposed-wake
      overhead (runtime minus the same cell's NoPG runtime) at the
      *deployed* threshold, i.e. the one that minimizes clean-trace
      energy per workload; ``worst_exposed_wake_any_s`` maxes over the
      whole threshold axis too.
    * ``slo_violation_rate`` — via ``slo.runtime_violation_rate``:
      fraction of workloads whose perturbed runtime at the deployed
      threshold exceeds ``slo_relax`` x its clean runtime.
    * ``max_regret_frac`` / ``mean_regret_frac`` — *SLO-constrained
      energy regret* of the clean-tuned threshold under jitter. Total
      energy is monotone in the detection window (per-PE SA gating has
      a 1-cycle wake, so a smaller window always saves energy), which
      pins the clean optimum at the most aggressive threshold; what
      jitter breaks is its *runtime*: fragmented idle makes the
      aggressive window gate every shard of an interval and pay the
      exposed wake delay each time. So regret is measured over the
      SLO-feasible set: if the deployed threshold still meets
      ``slo_relax`` x its clean runtime it is kept (regret relative to
      the unconstrained per-severity optimum — 0 when they coincide);
      once jitter pushes it past the SLO the operator must re-tune to
      the cheapest *feasible* threshold (or the least-violating one if
      none is feasible), and the regret is that configuration's energy
      over the unconstrained optimum — the energy given up to stay
      within SLO. Severity 0 has zero regret by construction.

    Returns ``{"records", "summary", "severities", "threshold_scales"}``
    where ``records`` has one dict per (workload, npu, policy, severity,
    threshold) cell.
    """
    from repro_torch.core.ici_topology import lower_collectives
    from repro_torch.core.perturb import perturb_suite, severity_plan
    from repro_torch.core.slo import retune_knobs, runtime_violation_rate
    if isinstance(workloads, Workload):
        workloads = [workloads]
    workloads = list(workloads)
    severities = [float(s) for s in severities]
    threshold_scales = [float(t) for t in threshold_scales]
    if any(t <= 0 or not np.isfinite(t) for t in threshold_scales):
        raise ValueError(
            f"threshold_scales must be finite and > 0: {threshold_scales}")
    base = [lower_collectives(wl) if topology else wl for wl in workloads]
    w_n, s_n, t_n = len(base), len(severities), len(threshold_scales)
    pol_in = tuple(policies)
    pols = pol_in if "NoPG" in pol_in else pol_in + ("NoPG",)
    npu_specs = [get_npu(n) if isinstance(n, str) else n for n in npus]

    variants: list[Workload] = []
    for si, sev in enumerate(severities):
        variants.extend(perturb_suite(
            base, severity_plan(sev), seed=seed, stream=si,
            names=[f"{wl.name}@s{si}" for wl in base]))
    thr_grid = KnobGrid(window_scale=threshold_scales)
    res: BatchResult = evaluate_batch(
        variants, npu_specs, pols, thr_grid, device=device, mesh=mesh)
    thr_knobs = thr_grid.product()

    rt = res.runtime_s                       # (S*W, A, P, T)
    tot = np.zeros_like(rt)
    for c in COMPONENTS:
        tot += res.static_j[c] + res.dynamic_j[c]
    nopg_pi = pols.index("NoPG")
    exposed = np.maximum(0.0, rt - rt[:, :, nopg_pi:nopg_pi + 1, :])

    records: list[dict] = []
    summary: list[dict] = []
    for ai, npu in enumerate(npu_specs):
        for pi, policy in enumerate(pol_in):
            # deployed threshold: clean-trace (severity index 0) optimum
            kstar = np.argmin(tot[:w_n, ai, pi, :], axis=1)   # (W,)
            wi_ix = np.arange(w_n)
            for si, sev in enumerate(severities):
                rows = slice(si * w_n, (si + 1) * w_n)
                e_s = tot[rows, ai, pi, :]                     # (W, T)
                r_s = rt[rows, ai, pi, :]
                x_s = exposed[rows, ai, pi, :]
                opt = e_s.min(axis=1)
                # SLO-feasible set per workload: perturbed runtime vs
                # the SAME threshold's clean runtime
                r_clean = rt[:w_n, ai, pi, :]                  # (W, T)
                # chosen threshold: the deployed one while feasible;
                # past the SLO, the cheapest feasible (or the
                # least-violating when nothing is feasible) — the
                # shared operator rule (slo.retune_knobs, also the
                # fleet governor)
                kchos = retune_knobs(e_s, r_s, slo_relax * r_clean,
                                     deployed=kstar)
                regret = e_s[wi_ix, kchos] - opt
                regret_frac = regret / np.maximum(opt, 1e-300)
                viol = runtime_violation_rate(
                    r_s[wi_ix, kstar],
                    r_clean[wi_ix, kstar], slo_relax)
                summary.append({
                    "npu": npu.name, "policy": policy,
                    "severity": sev,
                    "worst_exposed_wake_s":
                        float(x_s[wi_ix, kstar].max(initial=0.0)),
                    "worst_exposed_wake_any_s":
                        float(x_s.max(initial=0.0)),
                    "slo_violation_rate": viol,
                    "max_regret_frac":
                        float(regret_frac.max(initial=0.0)),
                    "mean_regret_frac":
                        float(regret_frac.mean()) if w_n else 0.0,
                })
                for wi, wl in enumerate(workloads):
                    for ki, ts in enumerate(threshold_scales):
                        records.append({
                            "workload": wl.name, "npu": npu.name,
                            "policy": policy, "severity": sev,
                            # full knob columns (knob_idx + every
                            # KnobGrid axis) so these records feed
                            # with_savings/group_by like any sweep's
                            **knob_columns(thr_knobs[ki], ki),
                            "runtime_s": float(r_s[wi, ki]),
                            "total_j": float(e_s[wi, ki]),
                            "exposed_wake_s": float(x_s[wi, ki]),
                            "deployed": bool(ki == kstar[wi]),
                            "chosen": bool(ki == kchos[wi]),
                        })
    return {"records": records, "summary": summary,
            "severities": severities,
            "threshold_scales": threshold_scales}


def sweep_program_plane(workloads: Sequence[Workload] | Workload,
                        npus: Iterable[NPUSpec | str] = ("NPU-D",),
                        knob_grid=None, *, device=None,
                        mesh=None) -> list[dict]:
    """Cross-validation sweep over the batched program plane: lower
    every (workload, npu) cell, place the §4.3 ``setpm``
    instrumentation once per unique delay scale, and execute ALL cells
    in one call of the ``repro_torch.core.program_plane`` executor (on a
    CUDA device, one launch of kernel B7). One flat record per
    (workload, npu, knob) cell compares gated-cycle fractions and setpm
    counts against the closed-form ``ReGate-Full`` evaluation
    (``evaluate_batch`` on the same device); every ``KnobGrid`` column
    is emitted unconditionally. Record order is workload-major, then
    NPU, then knob index (the ``sweep_grid`` convention).

    ``knob_grid`` accepts a ``KnobGrid`` (crossed), a flat sequence of
    ``PolicyKnobs``, or ``None`` (the single default point). ``device``
    resolves like ``sweep_grid``'s; cell for cell the records match the
    per-cell oracle (``sweep_program_plane_reference``) to ≤1e-9
    relative, executor integers exactly."""
    from repro_torch.core.policies import as_knob_tuple
    from repro_torch.core.program_plane import program_plane_batch
    return program_plane_batch(workloads, npus, as_knob_tuple(knob_grid),
                               device=device, mesh=mesh).records()


def sweep_program_plane_reference(workloads: Sequence[Workload] | Workload,
                                  npus: Iterable[NPUSpec | str]
                                  = ("NPU-D",),
                                  knob_grid=None) -> list[dict]:
    """The per-cell host oracle for ``sweep_program_plane``: one
    ``lowering.crossval_record`` (event-driven ``EventTimeline`` +
    closed-form ``evaluate``) per (workload, npu, knob) cell, same
    record order. It runs on the host whatever the session's device."""
    from repro_torch.core.lowering import crossval_record
    from repro_torch.core.policies import as_knob_tuple
    if isinstance(workloads, Workload):
        workloads = [workloads]
    npu_specs = [get_npu(n) if isinstance(n, str) else n for n in npus]
    grid = as_knob_tuple(knob_grid)
    return [crossval_record(wl, npu, knobs=kn, knob_idx=ki)
            for wl in workloads for npu in npu_specs
            for ki, kn in enumerate(grid)]


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


def sweep_fleet(scenario, knob_grid=None, **kw):
    """Fleet serving plane: simulate a chip fleet serving seeded
    request-arrival traces, one batched ``evaluate_batch`` call per
    epoch, with the online SLO governor switching ``PolicyKnobs`` and
    ``core.carbon`` rolling per-chip joules up to fleet kWh/CO2/cost.
    The guard plane rides along via ``guard=GuardPolicy(...)`` (watchdog
    + retries + NaN quarantine; a failed card call raises, it is never
    finished on the host) and ``checkpoint=<dir>``
    (crash-consistent epoch-granular snapshots with bit-identical
    resume). Thin re-export of ``repro_torch.core.fleet.sweep_fleet``
    (imported lazily — ``fleet`` builds on this module's substrate); see
    that module for the scenario/report data model."""
    from repro_torch.core.fleet import sweep_fleet as impl
    return impl(scenario, knob_grid, **kw)


def sweep_chaos(scenario, knob_grid=None, **kw):
    """Chaos plane: the fault-injection campaign — seeded chip/link
    fault timelines (``core.faults``) × fault severities × policies
    through the fleet simulator under the anti-thrash hysteresis
    governor, reporting worst-case SLO-constrained regret, recovery time
    after repair, and retune counts (vs the stateless thrash baseline).
    Accepts the guard plane's ``guard=`` / ``checkpoint=`` kwargs: a
    SIGKILLed campaign resumes from its checkpoint directory
    bit-identically. Thin re-export of
    ``repro_torch.core.fleet.sweep_chaos`` (imported lazily — ``fleet``
    builds on this module's substrate)."""
    from repro_torch.core.fleet import sweep_chaos as impl
    return impl(scenario, knob_grid, **kw)
