"""Fleet serving plane: a datacenter of simulated NPUs on top of the
batched sweep kernel.

The per-chip sweep evaluates static traces; production fleets see
diurnal, bursty, multi-tenant traffic where the idle structure — and
therefore the power-gating opportunity — is set by the *arrival
process* (Jouppi et al.'s TPU datacenter analysis; CompPow's
time-varying-utilization argument, PAPERS.md). This module simulates
that: seeded request-arrival traces drive time-varying workload mixes
across thousands of chips, an online SLO governor re-tunes
``PolicyKnobs`` per epoch, and ``core.carbon`` rolls per-chip joules up
to fleet kWh / CO2 / cost.

Design, layer by layer:

* **Arrivals** — ``ArrivalSpec`` + ``arrival_counts``: Poisson /
  diurnal / bursty generators following the ``core.perturb`` contract
  (explicit ``numpy.random.Generator``, fixed call order; each class
  owns its own ``(seed, class_index)`` stream so composed scenarios
  stay deterministic class by class), plus
  ``replay`` of recorded arrival timestamps binned with the
  continuous-batching rule of ``launch/serve.py`` (a request joins at
  the next epoch boundary).
* **Traffic variability** — ``perturb.severity_variants`` pre-builds
  one trace variant set per congestion level from the same
  ``severity_plan`` compositions as the jitter plane; each epoch picks
  its level from the fleet-wide demand (busier epoch → harsher
  variant), so epochs are genuinely time-varying while the variant
  *objects* stay identity-stable and the compile/stack caches stay
  warm.
* **One batched call per epoch** — every epoch evaluates its active
  (workload-mix × npu × policy × knob) grid through exactly ONE
  ``policies.evaluate_batch`` call (the ``sweep_grid`` kernel; on the
  card each call launches the occupancy kernel K1 once and the
  segmented-sum kernel K2 for every segmented sum), plus one calibration
  call before the first epoch. Perturbations preserve op counts, so
  every epoch's stack has the same shapes.
* **SLO governor** — the shared operator rule ``slo.retune_knobs``
  (also ``sweep.sweep_robustness``): deploy the energy-optimal knob,
  keep it while its load-inflated runtime meets ``slo_relax`` × the
  calibrated reference, otherwise re-tune to the cheapest feasible
  knob, falling back to the least-violating one. Violation accounting
  reuses ``slo.runtime_violation_rate``.
* **Energy & carbon** — busy energy is ``served invocations ×
  per-chip total_j × chips per invocation`` (the sweep's per-record
  energy semantics); idle chips burn ``PowerModel.idle_chip_w`` under
  ``NoPG`` and the deeply-gated ``idle_chip_gated_w()`` under ReGate
  policies; ``carbon.fleet_rollup`` turns the summed joules into
  facility kWh / kgCO2e / USD. Summary totals reconcile with the sum
  of per-record energies to float round-off (≤1e-9 relative — tested).

``sweep.sweep_fleet`` re-exports :func:`sweep_fleet`. Every entry
point takes ``device=`` where the JAX package takes ``backend=`` /
``jax_mesh=``: ``None`` resolves through the active ``SweepSession``
and otherwise means ``"cuda"``; ``"cpu"`` runs the kernels' plain
versions; ``"numpy"`` runs every call on the numpy batched engine
(``policies.evaluate_batch_numpy``). Nothing here falls back from one
to another. A campaign on the card stays on the card: under the guard
(``guard=``, or ``checkpoint=``, which arms ``GuardPolicy()``) its
failed calls are retried there and then raise ``guard.GuardError``. Only
a ``"cpu"`` campaign's guard may step down, to ``"numpy"``, and it
records the step as a ``failover`` event.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field, fields as dc_fields
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import session as _session
from repro_torch.core.backend import resolve_device
from repro_torch.core.carbon import FleetRollup, fleet_rollup
from repro_torch.core.faults import (FaultSpec, FaultTimeline,
                                     build_fault_timeline, fault_plan)
from repro_torch.core.guard import (CampaignCheckpoint, GuardPolicy,
                                    GuardedRunner, RunManifest, digest_of,
                                    maybe_kill)
from repro_torch.core.hw import NPUSpec, get_npu
from repro_torch.core.ici_topology import (lower_collectives, n_links,
                                           resolve_link_rates, topology_for)
from repro_torch.core.opgen import Workload
from repro_torch.core.perturb import (_require_rng, perturb_suite,
                                      severity_plan, severity_variants)
from repro_torch.core.policies import (POLICIES, BatchResult, PolicyKnobs,
                                       as_knob_tuple, evaluate_batch,
                                       evaluate_batch_numpy, knob_columns)
from repro_torch.core.power import COMPONENTS, PowerModel
from repro_torch.core.slo import (GovernorState, Hysteresis, retune_knobs,
                                  runtime_violation_rate)

ARRIVAL_KINDS = ("poisson", "diurnal", "bursty", "replay")


# --------------------------------------------------------------------------
# request-arrival traces
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ArrivalSpec:
    """One workload class's arrival process.

    ``poisson``  — homogeneous Poisson at ``rate_rps``.
    ``diurnal``  — Poisson with a sinusoidal day curve: rate(t) =
                   ``rate_rps`` × (1 + ``peak_frac`` ×
                   sin(2π (t + ``phase_s``) / ``period_s``)), clipped
                   at 0 (``peak_frac`` > 1 models overnight troughs
                   that go fully quiet).
    ``bursty``   — Poisson whose epoch rate is boosted ×``burst_factor``
                   with probability ``burst_prob`` per epoch (flash
                   crowds).
    ``replay``   — recorded arrival timestamps (``times_s``, seconds
                   from scenario start), binned with the
                   continuous-batching rule; consumes no random draws.

    Draw contract (the ``core.perturb`` discipline of explicit
    generators in a fixed call order): poisson/diurnal draw
    ``n_epochs`` Poisson variates, bursty draws ``n_epochs`` uniforms
    *then* ``n_epochs`` Poisson variates, replay draws none. The
    variate count is fixed, but the underlying bit-stream consumption
    of a Poisson variate is rate-dependent (rejection sampling), so
    trace isolation comes from ``sweep_fleet`` giving every class its
    own generator seeded ``(scenario.seed, class_index)`` — re-tuning
    one class's traffic can never move another class's trace.
    """

    kind: str = "poisson"
    rate_rps: float = 1.0
    peak_frac: float = 0.5
    period_s: float = 86400.0
    phase_s: float = 0.0
    burst_prob: float = 0.1
    burst_factor: float = 8.0
    times_s: Optional[tuple] = None

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r}; "
                             f"have {ARRIVAL_KINDS}")
        if self.kind == "replay":
            if self.times_s is None:
                raise ValueError("replay arrivals need times_s")
            object.__setattr__(self, "times_s",
                               tuple(float(t) for t in self.times_s))
        else:
            if not (math.isfinite(self.rate_rps) and self.rate_rps >= 0):
                raise ValueError(
                    f"rate_rps must be finite and >= 0, got "
                    f"{self.rate_rps!r}")
        if self.kind == "diurnal":
            if not (math.isfinite(self.period_s) and self.period_s > 0):
                raise ValueError(f"period_s must be > 0, got "
                                 f"{self.period_s!r}")
            if self.peak_frac < 0:
                raise ValueError(f"peak_frac must be >= 0, got "
                                 f"{self.peak_frac!r}")
        if self.kind == "bursty":
            if not 0.0 <= self.burst_prob <= 1.0:
                raise ValueError(f"burst_prob must be in [0, 1], got "
                                 f"{self.burst_prob!r}")
            if self.burst_factor < 1.0:
                raise ValueError(f"burst_factor must be >= 1, got "
                                 f"{self.burst_factor!r}")


def epoch_rates(spec: ArrivalSpec, n_epochs: int,
                epoch_s: float) -> np.ndarray:
    """Deterministic mean request rate (req/s) per epoch — the Poisson
    intensity before any stochastic draws (replay: the empirical
    per-epoch rate)."""
    if spec.kind == "replay":
        counts = bin_requests(np.asarray(spec.times_s), n_epochs, epoch_s)
        return counts / epoch_s
    t_mid = (np.arange(n_epochs) + 0.5) * epoch_s
    if spec.kind == "diurnal":
        mod = 1.0 + spec.peak_frac * np.sin(
            2.0 * np.pi * (t_mid + spec.phase_s) / spec.period_s)
        return spec.rate_rps * np.maximum(0.0, mod)
    return np.full(n_epochs, spec.rate_rps)


def arrival_counts(spec: ArrivalSpec, n_epochs: int, epoch_s: float,
                   rng: Optional[np.random.Generator] = None) \
        -> np.ndarray:
    """Per-epoch request counts (int64, shape (n_epochs,)).

    Stochastic kinds require an explicit ``numpy.random.Generator`` and
    honor the fixed-draw-count contract (see ``ArrivalSpec``); replay
    ignores ``rng`` entirely.
    """
    if n_epochs < 1:
        raise ValueError(f"n_epochs must be >= 1, got {n_epochs}")
    if spec.kind == "replay":
        return bin_requests(np.asarray(spec.times_s), n_epochs, epoch_s)
    _require_rng(rng)
    lam = epoch_rates(spec, n_epochs, epoch_s) * epoch_s
    if spec.kind == "bursty":
        boosted = rng.random(n_epochs) < spec.burst_prob
        lam = lam * np.where(boosted, spec.burst_factor, 1.0)
    return rng.poisson(lam).astype(np.int64)


def bin_requests(times_s: np.ndarray, n_epochs: int, epoch_s: float, *,
                 with_clamped: bool = False):
    """Bin arrival timestamps into serving epochs with the
    continuous-batching rule of ``launch/serve.py``: a request joins
    the batch at the *next* epoch boundary (an arrival strictly inside
    epoch e is served in epoch e+1; one exactly on a boundary joins the
    epoch that starts there). Arrivals in the final epoch clamp into
    the final epoch — the fleet has no epoch e+1 to defer to.

    That clamp used to be silent; with ``with_clamped=True`` the return
    is ``(counts, clamped)`` where ``clamped`` counts the arrivals
    whose next-boundary rule pointed at or past the horizon (i.e. they
    were folded back into the final epoch instead of deferring).
    ``sweep_fleet`` surfaces the total as
    ``FleetReport.clamped_requests``. Timestamps strictly past the
    window still raise.
    """
    t = np.asarray(times_s, np.float64)
    if t.size and (not np.isfinite(t).all() or (t < 0).any()):
        raise ValueError("replay times_s must be finite and >= 0")
    if t.size and (t > n_epochs * epoch_s).any():
        raise ValueError(
            f"replay times_s exceed the scenario window "
            f"({n_epochs} x {epoch_s}s)")
    raw = np.ceil(t / epoch_s).astype(np.int64)
    clamped = int((raw >= n_epochs).sum())
    idx = np.minimum(raw, n_epochs - 1)
    counts = np.bincount(idx, minlength=n_epochs).astype(np.int64)
    return (counts, clamped) if with_clamped else counts


# --------------------------------------------------------------------------
# scenario data model
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class WorkloadClass:
    """One tenant / traffic class: a workload trace (one *invocation* —
    e.g. a decode step over a batch) fed by an arrival process.
    ``requests_per_invocation`` converts request counts to invocation
    demand (a batch=8 decode trace serves 8 requests per invocation)."""

    name: str
    workload: Workload
    arrivals: ArrivalSpec
    requests_per_invocation: float = 1.0

    def __post_init__(self):
        if not (math.isfinite(self.requests_per_invocation)
                and self.requests_per_invocation > 0):
            raise ValueError(
                f"class {self.name!r}: requests_per_invocation must be "
                f"> 0, got {self.requests_per_invocation!r}")


@dataclass(frozen=True)
class FleetScenario:
    """A fleet simulation: classes × chips × policies × time window.

    ``severity_levels`` are the congestion levels traffic variability
    is drawn at (``perturb.severity_plan`` compositions, pre-built once
    via ``perturb.severity_variants``); each epoch selects the level
    whose demand quantile it falls in (single level → every epoch
    identical traces). ``slo_relax`` is the governor's relaxed-SLO
    factor over the calibrated clean reference runtime.
    """

    classes: tuple[WorkloadClass, ...]
    n_chips: int = 4096
    npu: NPUSpec | str = "NPU-D"
    policies: tuple[str, ...] = ("NoPG", "ReGate-HW", "ReGate-Full")
    duration_s: float = 86400.0
    epoch_s: float = 900.0
    slo_relax: float = 1.2
    seed: int = 0
    severity_levels: tuple[float, ...] = (0.0,)
    # graceful-degradation ladder, first rung: when a class's backlog
    # exceeds this multiple of its per-epoch capacity, the excess is
    # SHED (refused) instead of queued — inf (default) never sheds,
    # which keeps the backlog dynamics exactly as before
    shed_backlog_x: float = math.inf

    def __post_init__(self):
        object.__setattr__(self, "classes", tuple(self.classes))
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(self, "severity_levels",
                           tuple(float(s) for s in self.severity_levels))
        if not self.classes:
            raise ValueError("FleetScenario needs at least one class")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names: {names}")
        if not self.policies:
            raise ValueError("FleetScenario needs at least one policy")
        if not (math.isfinite(self.epoch_s) and self.epoch_s > 0):
            raise ValueError(f"epoch_s must be > 0, got {self.epoch_s!r}")
        if self.duration_s < self.epoch_s:
            raise ValueError("duration_s must cover at least one epoch")
        if self.n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {self.n_chips}")
        if self.slo_relax <= 0:
            raise ValueError(f"slo_relax must be > 0, got "
                             f"{self.slo_relax!r}")
        if not self.severity_levels:
            raise ValueError("severity_levels must be non-empty")
        if math.isnan(self.shed_backlog_x) or self.shed_backlog_x <= 0:
            raise ValueError(f"shed_backlog_x must be > 0 (inf = never "
                             f"shed), got {self.shed_backlog_x!r}")

    @property
    def n_epochs(self) -> int:
        return int(math.ceil(self.duration_s / self.epoch_s))


@dataclass
class FleetReport:
    """Everything ``sweep_fleet`` measured.

    ``records`` — one dict per (epoch, class, policy): the governor's
    chosen knob (full knob columns), demand/served/backlog invocations,
    allocated chips, busy/idle/total joules (summed over that class's
    chips), runtime and load-inflated effective runtime, the SLO bound,
    and the ``slo_violated`` / ``feasible_exists`` governor flags.
    ``epoch_summary`` — one dict per (epoch, policy) adding the
    unallocated-chip idle energy and fleet totals. ``summary`` — one
    dict per policy over the whole window, including the
    ``carbon.fleet_rollup`` fields; its ``total_j`` equals the sum of
    its records' ``total_j`` plus unallocated idle to float round-off.
    """

    n_epochs: int
    epoch_s: float
    n_chips: int
    npu: str
    policies: tuple[str, ...]
    class_names: tuple[str, ...]
    severity_levels: tuple[float, ...]
    severity_by_epoch: list[float]
    requests_total: int
    records: list[dict] = field(default_factory=list)
    epoch_summary: list[dict] = field(default_factory=list)
    summary: list[dict] = field(default_factory=list)
    # replay arrivals folded into the final epoch by the next-boundary
    # rule (see bin_requests) — surfaced, not silently clamped
    clamped_requests: int = 0
    clamped_by_class: dict = field(default_factory=dict)
    # chaos plane: present only when a fault timeline was injected
    fault_summary: Optional[dict] = None
    # guard plane: GuardReport.to_dict() when the run was guarded —
    # every retry / failover / quarantine escalation, with reasons
    guard: Optional[dict] = None
    # (workload variants, severity level) per epoch — populated only
    # with keep_epoch_inputs=True so tests can replay one epoch as a
    # hand-built sweep_grid/evaluate_batch call
    epoch_inputs: Optional[list] = None

    def policy_summary(self, policy: str) -> dict:
        for s in self.summary:
            if s["policy"] == policy:
                return s
        raise KeyError(policy)

    def rollup(self, policy: str) -> FleetRollup:
        return fleet_rollup(self.policy_summary(policy)["total_j"])

    # JSON round-trip for the guard plane's final checkpoint: every
    # field is plain python (floats survive bit-exactly via shortest
    # repr), EXCEPT epoch_inputs, which holds live Workload objects
    def to_dict(self) -> dict:
        if self.epoch_inputs is not None:
            raise ValueError(
                "FleetReport with epoch_inputs (live Workload objects) "
                "cannot be serialized to a checkpoint")
        d = {f.name: getattr(self, f.name) for f in dc_fields(self)}
        for name in ("policies", "class_names", "severity_levels"):
            d[name] = list(d[name])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FleetReport":
        kw = {f.name: d.get(f.name) for f in dc_fields(cls)}
        kw["policies"] = tuple(kw["policies"])
        kw["class_names"] = tuple(kw["class_names"])
        kw["severity_levels"] = tuple(float(s)
                                      for s in kw["severity_levels"])
        return cls(**kw)


# --------------------------------------------------------------------------
# the fleet simulator
# --------------------------------------------------------------------------

def _allocate_chips(n_chips: int, demand_chip_s: np.ndarray) \
        -> np.ndarray:
    """Largest-remainder apportionment of ``n_chips`` proportional to
    per-class demand chip-seconds. Zero-demand classes get zero;
    every positive-demand class gets at least one chip when enough
    chips exist (a tiny tenant sharded next to huge ones must not be
    starved to zero capacity — that would make its queue diverge no
    matter what knob the governor picks)."""
    demand_chip_s = np.asarray(demand_chip_s, np.float64)
    pos = demand_chip_s > 0.0
    n_pos = int(pos.sum())
    alloc = np.zeros(len(demand_chip_s), np.int64)
    if n_pos == 0:
        return alloc
    if n_chips <= n_pos:
        # not enough chips for one each: largest demands first
        order = np.argsort(-demand_chip_s, kind="stable")
        alloc[order[:n_chips]] += 1
        return alloc
    alloc[pos] = 1
    rest = n_chips - n_pos
    quota = rest * demand_chip_s / float(demand_chip_s.sum())
    extra = np.floor(quota).astype(np.int64)
    alloc += extra
    leftover = rest - int(extra.sum())
    if leftover > 0:
        order = np.argsort(-(quota - extra), kind="stable")
        alloc[order[:leftover]] += 1
    return alloc


def _severity_index(demand: np.ndarray, n_levels: int) -> np.ndarray:
    """Per-epoch severity-level index from fleet-wide demand: epochs
    are ranked into ``n_levels`` equal quantile bands (busiest band →
    harshest level). Deterministic; single level → all zeros."""
    if n_levels == 1:
        return np.zeros(len(demand), np.int64)
    order = np.argsort(np.argsort(demand, kind="stable"), kind="stable")
    return (order * n_levels // max(1, len(demand))).astype(np.int64)


# cross-call memo for faulted trace variants: value-keyed buckets on
# (class workloads, scenario seed, severity levels), each mapping
# (link-rate row bytes, level index) -> variant list — so replaying
# one timeline through several sweep_fleet calls (chaos campaign
# hysteresis + baseline runs, benchmark repetitions) returns the SAME
# Workload objects and the identity-cached compile/stack pipeline
# stays warm across calls; both levels clear wholesale at the cap
# (distinct link states per campaign number in the dozens)
_FAULT_VARIANTS: dict = {}
_FAULT_VARIANTS_CAP = 4096


def _idle_power_w(pm: PowerModel, policy: str) -> float:
    """Out-of-epoch-load idle power per chip: NoPG chips sit at full
    idle power, ReGate chips deep-idle with everything gateable gated,
    Ideal is the zero-leakage bound (paper §3 / §6.6 idle story)."""
    if policy == "NoPG":
        return pm.idle_chip_w
    if policy == "Ideal":
        return 0.0
    return pm.idle_chip_gated_w()


def sweep_fleet(scenario: FleetScenario, knob_grid=None, *,
                device=None,
                keep_epoch_inputs: bool = False,
                faults: Optional[FaultTimeline] = None,
                hysteresis: Optional[Hysteresis] = None,
                guard: Optional[GuardPolicy] = None,
                checkpoint=None) -> FleetReport:
    """Run the fleet simulation; see the module docstring for the
    model. ``knob_grid`` accepts a ``KnobGrid``, a flat sequence of
    ``PolicyKnobs``, or ``None`` (the single default point) —
    identical semantics to every other sweep entry point. ``device`` is
    where every epoch's ``evaluate_batch`` runs (``None``: the active
    ``SweepSession``'s, else ``"cuda"``; ``"numpy"``: the numpy batched
    engine). Deterministic: the same scenario (same seed) produces a
    bit-identical report.

    ``faults`` injects a ``core.faults.FaultTimeline`` (chaos plane):
    per epoch, ``chips_down`` shrinks the allocatable fleet (failover
    re-runs the largest-remainder apportionment over the survivors,
    backlog carries through the capacity dip), link faults re-lower
    every class's collectives onto fault-paced step schedules
    (``ici_topology.collective_schedule`` with the epoch's link-rate
    row, partition-resolved via ``resolve_link_rates``), the epoch's
    ``severity_hint`` escalates the traffic-severity ladder, and
    ``pg_fault`` epochs drop gated policies to their NoPG-equivalent
    evaluation (the degradation ladder's last rung: gating logic
    can't be trusted, so nothing gates and idle burns ungated). The
    all-clean timeline is an exact no-op. ``scenario.shed_backlog_x``
    (finite) adds the shed rung: backlog beyond that multiple of an
    epoch's capacity is refused, not queued.

    ``hysteresis`` switches the governor to the stateful anti-thrash
    rule (``slo.retune_knobs`` with a ``GovernorState`` per policy):
    knobs persist across epochs, retunes respect cooldown/backoff, and
    the per-policy retune count is bounded by the number of fault
    transitions in piecewise-constant scenarios.

    ``guard`` (a ``guard.GuardPolicy``; ``None`` resolves through the
    active ``SweepSession``) runs every batched call through the
    ``GuardedRunner`` — deadline watchdog, retry/backoff, the
    device's failover ladder (``backend.failover_rungs``: the card has
    no rung below it), NaN quarantine — and attaches the escalation log as
    ``report.guard``. ``checkpoint`` (a directory path) enables
    crash-consistent campaign checkpointing: atomic epoch-granular
    snapshots under a ``RunManifest``, so a killed run resumes from
    the last published epoch and yields a **bit-identical** final
    report (every stochastic input replays from explicit seeded
    streams; the loop state itself — backlog, governor state, records
    — round-trips exactly through JSON). A finished run's directory
    short-circuits to the stored final report.
    """
    knobs = as_knob_tuple(knob_grid)
    n_k = len(knobs)
    npu = get_npu(scenario.npu) if isinstance(scenario.npu, str) \
        else scenario.npu
    pols = scenario.policies
    classes = scenario.classes
    n_w, n_p = len(classes), len(pols)
    n_e, dt = scenario.n_epochs, float(scenario.epoch_s)
    pm = PowerModel(npu)
    idle_w = np.array([_idle_power_w(pm, p) for p in pols])

    ft = faults
    if ft is not None:
        if not isinstance(ft, FaultTimeline):
            raise ValueError(
                f"faults must be a core.faults.FaultTimeline, "
                f"got {type(ft)}")
        if int(ft.n_epochs) != n_e:
            raise ValueError(
                f"fault timeline covers {ft.n_epochs} epochs, scenario "
                f"has {n_e}")
        if int(ft.n_chips) != int(scenario.n_chips):
            raise ValueError(
                f"fault timeline was built for {ft.n_chips} chips, "
                f"scenario has {scenario.n_chips}")
    if hysteresis is not None and not isinstance(hysteresis, Hysteresis):
        raise ValueError(
            f"hysteresis must be a slo.Hysteresis, got {type(hysteresis)}")

    # --- guard plane: guarded runner + campaign checkpoint -----------
    if guard is None:
        guard = _session.resolve("guard")
    if guard is not None and not isinstance(guard, GuardPolicy):
        raise ValueError(
            f"guard must be a guard.GuardPolicy, got {type(guard)}")
    gp = guard
    ck = None
    if checkpoint is not None:
        if not isinstance(checkpoint, (str, os.PathLike)):
            raise ValueError(
                f"checkpoint must be a directory path (str or "
                f"os.PathLike), got {type(checkpoint).__name__}")
        if keep_epoch_inputs:
            raise ValueError(
                "checkpoint cannot be combined with keep_epoch_inputs "
                "(epoch inputs hold live Workload objects and are not "
                "serializable)")
        gp = guard if guard is not None else GuardPolicy()
        manifest = RunManifest(
            kind="fleet", seed=int(scenario.seed), n_epochs=n_e,
            backend=str(resolve_device(device)),
            knob_digest=digest_of(knobs),
            scenario_digest=digest_of((scenario, ft, hysteresis)),
            severity_levels=scenario.severity_levels, policies=pols)
        ck = CampaignCheckpoint(checkpoint, manifest, keep=2)
        fin = ck.load_final()
        if fin is not None:
            return FleetReport.from_dict(fin)
    runner = None
    if gp is not None:
        runner = GuardedRunner(gp, device=device, seed=int(scenario.seed))

    def _eval(wls, eval_pols_, step) -> BatchResult:
        if runner is not None:
            return runner.evaluate_batch(wls, (npu,), eval_pols_, knobs,
                                         step=step)
        if device == "numpy":
            return evaluate_batch_numpy(wls, (npu,), eval_pols_, knobs)
        return evaluate_batch(wls, (npu,), eval_pols_, knobs,
                              device=device)

    # --- arrivals: per-class counts, (W, E) --------------------------
    counts = np.zeros((n_w, n_e), np.int64)
    clamped_by_class: dict[str, int] = {}
    for ci, cls in enumerate(classes):
        rng = np.random.default_rng((int(scenario.seed), ci))
        counts[ci] = arrival_counts(cls.arrivals, n_e, dt, rng)
        if cls.arrivals.kind == "replay":
            _, ncl = bin_requests(np.asarray(cls.arrivals.times_s),
                                  n_e, dt, with_clamped=True)
            if ncl:
                clamped_by_class[cls.name] = ncl
    requests_total = int(counts.sum())
    rpi = np.array([c.requests_per_invocation for c in classes])
    wl_chips = np.array([max(1, c.workload.n_chips) for c in classes],
                        np.float64)

    # --- traffic variability: one variant set per severity level -----
    # With link faults anywhere in the window, ALL epochs (clean ones
    # too) run on topology-lowered traces, so faulted epochs differ
    # from clean ones purely by their link-rate pacing — and a
    # timeline with no link events changes nothing at all.
    base = [c.workload for c in classes]
    levels = scenario.severity_levels
    chaos_links = ft is not None and ft.has_link_faults
    if chaos_links:
        topos = [topology_for(max(1, wl.n_chips)) for wl in base]
        for cls, tp in zip(classes, topos):
            need = n_links(tp)
            if need > int(ft.n_links):
                raise ValueError(
                    f"fault timeline has {ft.n_links} links but class "
                    f"{cls.name!r} ({tp.kind}{tp.shape}) needs {need}")
        base = [lower_collectives(wl, tp)
                for wl, tp in zip(base, topos)]
    variants = severity_variants(base, levels, seed=scenario.seed)
    by_level = [variants[lv] for lv in levels]
    sev_ix = _severity_index(counts.sum(axis=0).astype(np.float64),
                             len(levels))
    if ft is not None and len(levels) > 1:
        # fault-state severity escalation: the epoch's severity hint
        # (0 clean, ~1 severe) lifts it at least that far up the
        # scenario's level ladder — clean epochs are untouched
        hint_ix = np.ceil(np.minimum(ft.severity_hint, 1.0)
                          * (len(levels) - 1)).astype(np.int64)
        sev_ix = np.maximum(sev_ix, hint_ix)
    # per-epoch faulted trace variants, cached by (link-rate row,
    # severity level) so flapping timelines revisit cached objects and
    # the identity-keyed compile/stack pipeline stays warm; a
    # value-keyed second level (_FAULT_VARIANTS) survives across
    # sweep_fleet calls, so a chaos campaign replaying the same
    # timeline (hysteresis run + thrash baseline, bench repetitions)
    # re-lowers and re-compiles each distinct link state only once
    fault_variants: dict = {}
    if chaos_links:
        # ONE value-keyed (hence Workload-hashing) lookup per call;
        # per-epoch lookups below then key on cheap bytes tuples only
        if len(_FAULT_VARIANTS) >= _FAULT_VARIANTS_CAP:
            _FAULT_VARIANTS.clear()
        shared = _FAULT_VARIANTS.setdefault(
            (tuple(c.workload for c in classes), int(scenario.seed),
             tuple(levels)), {})

    def epoch_workloads(e: int) -> list[Workload]:
        si = int(sev_ix[e])
        if not (chaos_links and ft.link_faulty(e)):
            return by_level[si]
        key = (ft.link_rates[e].tobytes(), si)
        wls = fault_variants.get(key)
        if wls is None:
            wls = shared.get(key)
        if wls is None:
            low = [lower_collectives(
                wl, tp, link_rates=resolve_link_rates(
                    ft.link_rates[e][:n_links(tp)], tp))
                for wl, tp in zip([c.workload for c in classes], topos)]
            # same (seed, stream=si, index) children as
            # severity_variants: a faulted epoch's jitter draws match
            # its clean sibling draw-for-draw, so the only delta is
            # the link pacing itself
            wls = perturb_suite(
                low, severity_plan(float(levels[si])),
                seed=scenario.seed, stream=si,
                names=[f"{wl.name}@sev{si}" for wl in low])
            if len(shared) >= _FAULT_VARIANTS_CAP:
                shared.clear()
            shared[key] = wls
        fault_variants[key] = wls
        return wls

    # --- governor calibration: clean-trace reference runtimes --------
    # (one extra batched call outside the epoch loop; the SLO bound per
    # (class, policy) is slo_relax x the fastest clean knob, fixed for
    # the whole window so the governor chases a stable target)
    cal: BatchResult = _eval(base, pols, 0)
    rt_cal = cal.runtime_s[:, 0, :, :]                    # (W, P, K)
    slo_bound = scenario.slo_relax * rt_cal.min(axis=2)   # (W, P)

    # --- pg-fault fallback: gated policies need the NoPG row ---------
    eval_pols = pols
    if ft is not None and ft.has_pg_faults and "NoPG" not in pols:
        eval_pols = pols + ("NoPG",)
    nopg_ix = eval_pols.index("NoPG") if "NoPG" in eval_pols else None

    # --- stateful governor: deployed knobs persist across epochs -----
    gov_states: Optional[list[GovernorState]] = None
    dep_now: Optional[np.ndarray] = None
    if hysteresis is not None:
        gov_states = [GovernorState.init(n_w, hysteresis) for _ in pols]
        cal_tot = np.zeros((n_w, n_p, n_k))
        for c in COMPONENTS:
            cal_tot += cal.static_j[c][:, 0] + cal.dynamic_j[c][:, 0]
        dep_now = np.argmin(cal_tot, axis=2)              # (W, P)

    report = FleetReport(
        n_epochs=n_e, epoch_s=dt, n_chips=scenario.n_chips,
        npu=npu.name, policies=pols,
        class_names=tuple(c.name for c in classes),
        severity_levels=levels,
        severity_by_epoch=[float(levels[i]) for i in sev_ix],
        requests_total=requests_total,
        clamped_requests=sum(clamped_by_class.values()),
        clamped_by_class=clamped_by_class,
        epoch_inputs=[] if keep_epoch_inputs else None)

    backlog = np.zeros((n_w, n_p))
    eff_hist = np.zeros((n_e, n_w, n_p))
    shed_on = math.isfinite(scenario.shed_backlog_x)

    # --- resume: restore the loop state from the latest snapshot -----
    # (everything NOT restored here — arrivals, severity indices, SLO
    # bounds, trace variants — is a deterministic recomputation from
    # the scenario seed, so replaying the remaining epochs is
    # bit-identical to never having been killed)
    start_e = 0
    if ck is not None:
        snap = ck.load_epoch()
        if snap is not None:
            e0 = int(snap["epoch"])
            if not 0 <= e0 < n_e:
                raise ValueError(
                    f"checkpoint epoch {e0} out of range for a "
                    f"{n_e}-epoch scenario")
            start_e = e0 + 1
            backlog[:] = np.asarray(snap["backlog"], np.float64)
            eff_hist[:e0 + 1] = np.asarray(snap["eff_hist"], np.float64)
            report.records[:] = snap["records"]
            report.epoch_summary[:] = snap["epoch_summary"]
            gov = snap.get("governor")
            if (gov is None) != (gov_states is None):
                raise ValueError(
                    "checkpoint governor state does not match the "
                    "requested hysteresis mode")
            if gov_states is not None:
                dep_now[:] = np.asarray(gov["dep_now"], np.int64)
                for st, d in zip(gov_states, gov["states"]):
                    st.since_retune[:] = np.asarray(d["since_retune"],
                                                    np.int64)
                    st.cooldown[:] = np.asarray(d["cooldown"], np.int64)
                    st.forced_streak[:] = np.asarray(d["forced_streak"],
                                                     np.int64)
                    st.retunes[:] = np.asarray(d["retunes"], np.int64)
            if runner is not None:
                runner.report.events[:] = snap.get("guard_events", [])

    for e in range(start_e, n_e):
        if ck is not None:
            maybe_kill("mid", e)
        wls = epoch_workloads(e)
        # ONE batched sweep call per epoch: the whole active
        # (workload-mix x npu x policy x knob) grid in one pass
        res: BatchResult = _eval(wls, eval_pols, e + 1)
        if keep_epoch_inputs:
            report.epoch_inputs.append((wls, float(levels[sev_ix[e]])))
        rt = res.runtime_s[:, 0, :, :]                    # (W, P', K)
        tot = np.zeros_like(rt)
        for c in COMPONENTS:
            tot += res.static_j[c][:, 0] + res.dynamic_j[c][:, 0]
        down = int(ft.chips_down[e]) if ft is not None else 0
        avail = max(0, scenario.n_chips - down)
        pg_now = ft is not None and bool(ft.pg_fault[e])
        link_now = chaos_links and ft.link_faulty(e)

        for pi, policy in enumerate(pols):
            # pg-fault ladder rung: a gated policy's power-gating
            # control logic is compromised this epoch — it runs (and
            # idles) at the ungated NoPG operating point
            pg_fb = pg_now and policy not in ("NoPG", "Ideal")
            src = nopg_ix if pg_fb else pi
            e_pk, r_pk = tot[:, src, :], rt[:, src, :]    # (W, K)
            idle_w_pi = pm.idle_chip_w if pg_fb else idle_w[pi]
            deployed = np.argmin(e_pk, axis=1) if dep_now is None \
                else dep_now[:, pi]
            demand_inv = counts[:, e] / rpi + backlog[:, pi]
            wi = np.arange(n_w)
            # allocation: proportional to demand chip-time at the
            # deployed knob (the governor re-tunes knobs after chips
            # are placed — placement reacts to demand, not to knobs);
            # failed/draining chips are out of the pool, so failover
            # re-apportions the survivors with the no-starvation floor
            dct = demand_inv * r_pk[wi, deployed] * wl_chips
            chips = _allocate_chips(avail, dct)
            # queueing inflation: load factor rho per knob; a class
            # past its capacity stretches completion proportionally
            with np.errstate(divide="ignore", invalid="ignore"):
                rho = demand_inv[:, None] * r_pk * wl_chips[:, None] \
                    / (chips[:, None] * dt)
            rho = np.where(demand_inv[:, None] > 0,
                           np.where(chips[:, None] > 0, rho, np.inf),
                           0.0)
            eff = r_pk * np.maximum(1.0, rho)             # (W, K)
            if gov_states is None:
                chosen = retune_knobs(e_pk, eff,
                                      slo_bound[:, pi][:, None],
                                      deployed=deployed)
            else:
                chosen = retune_knobs(e_pk, eff,
                                      slo_bound[:, pi][:, None],
                                      deployed=deployed,
                                      hysteresis=hysteresis,
                                      state=gov_states[pi])
                dep_now[:, pi] = chosen
            feas = eff <= slo_bound[:, pi][:, None]
            feas_any = feas.any(axis=1)
            eff_c = eff[wi, chosen]
            violated = eff_c > slo_bound[:, pi]
            eff_hist[e, :, pi] = eff_c
            # SLO-constrained regret: chosen knob's invocation energy
            # vs the cheapest feasible knob this epoch (cheapest
            # overall when nothing is feasible)
            opt_j = np.where(
                feas_any,
                np.min(np.where(feas, e_pk, np.inf), axis=1),
                e_pk.min(axis=1))
            regret = e_pk[wi, chosen] / np.maximum(opt_j, 1e-300) - 1.0
            # service: capacity at the chosen knob, backlog carries
            r_c = r_pk[wi, chosen]
            cap_inv = np.where(r_c > 0,
                               chips * dt / (r_c * wl_chips), 0.0)
            served = np.minimum(demand_inv, cap_inv)
            backlog[:, pi] = demand_inv - served
            shed = np.zeros(n_w)
            if shed_on:
                # degradation ladder, first rung: refuse backlog
                # beyond shed_backlog_x x this epoch's capacity
                limit = scenario.shed_backlog_x * cap_inv
                shed = np.maximum(0.0, backlog[:, pi] - limit)
                backlog[:, pi] -= shed
            busy_s = np.minimum(served * r_c * wl_chips, chips * dt)
            idle_s = np.maximum(0.0, chips * dt - busy_s)
            busy_j = served * e_pk[wi, chosen] * wl_chips
            idle_j = idle_w_pi * idle_s
            spare = avail - int(chips.sum())
            unalloc_j = idle_w_pi * spare * dt
            for ci, cls in enumerate(classes):
                report.records.append({
                    "epoch": e, "class": cls.name,
                    "workload": wls[ci].name, "npu": npu.name,
                    "policy": policy,
                    "severity": float(levels[sev_ix[e]]),
                    **knob_columns(knobs[chosen[ci]],
                                   int(chosen[ci])),
                    "deployed_knob_idx": int(deployed[ci]),
                    "requests": int(counts[ci, e]),
                    "demand_inv": float(demand_inv[ci]),
                    "served_inv": float(served[ci]),
                    "backlog_inv": float(backlog[ci, pi]),
                    "shed_inv": float(shed[ci]),
                    "chips": int(chips[ci]),
                    "runtime_s": float(r_c[ci]),
                    # the underlying sweep cell's per-chip energy at
                    # the chosen knob (one invocation) — ties each
                    # fleet record back to the direct sweep_grid
                    # record it was derived from
                    "inv_total_j": float(e_pk[ci, chosen[ci]]),
                    "inv_opt_j": float(opt_j[ci]),
                    "regret_frac": float(regret[ci]),
                    "eff_runtime_s": float(eff_c[ci]),
                    "slo_bound_s": float(slo_bound[ci, pi]),
                    "slo_violated": bool(violated[ci]),
                    "feasible_exists": bool(feas_any[ci]),
                    "retuned": bool(chosen[ci] != deployed[ci]),
                    "pg_fallback": bool(pg_fb),
                    "utilization": float(busy_s[ci]
                                         / max(chips[ci] * dt, 1e-300))
                    if chips[ci] else 0.0,
                    "busy_j": float(busy_j[ci]),
                    "idle_j": float(idle_j[ci]),
                    "total_j": float(busy_j[ci] + idle_j[ci]),
                })
            report.epoch_summary.append({
                "epoch": e, "policy": policy,
                "severity": float(levels[sev_ix[e]]),
                "requests": int(counts[:, e].sum()),
                "served_inv": float(served.sum()),
                "shed_inv": float(shed.sum()),
                "chips_active": int(chips.sum()),
                "chips_down": down,
                "chips_unallocated": spare,
                "pg_fallback": bool(pg_fb),
                "link_faulted": bool(link_now),
                "unallocated_idle_j": float(unalloc_j),
                "busy_j": float(busy_j.sum()),
                "idle_j": float(idle_j.sum() + unalloc_j),
                "total_j": float(busy_j.sum() + idle_j.sum()
                                 + unalloc_j),
                "violations": int(violated.sum()),
                "retunes": int((chosen != deployed).sum()),
            })

        # epoch boundary: publish the crash-consistent snapshot (async
        # write behind an atomic rename; shallow list copies suffice —
        # the loop only ever appends, never mutates, past records)
        if ck is not None and ((e + 1) % gp.checkpoint_every == 0
                               or e == n_e - 1):
            gov_snap = None
            if gov_states is not None:
                gov_snap = {
                    "dep_now": dep_now.tolist(),
                    "states": [
                        {"since_retune": st.since_retune.tolist(),
                         "cooldown": st.cooldown.tolist(),
                         "forced_streak": st.forced_streak.tolist(),
                         "retunes": st.retunes.tolist()}
                        for st in gov_states]}
            ck.save_epoch(e, {
                "epoch": e,
                "backlog": backlog.tolist(),
                "eff_hist": eff_hist[:e + 1].tolist(),
                "records": list(report.records),
                "epoch_summary": list(report.epoch_summary),
                "governor": gov_snap,
                "guard_events": list(runner.report.events),
            })

    # --- per-policy window totals + carbon roll-up -------------------
    for pi, policy in enumerate(pols):
        recs = [r for r in report.records if r["policy"] == policy]
        eps = [s for s in report.epoch_summary if s["policy"] == policy]
        total_j = math.fsum(r["total_j"] for r in recs) \
            + math.fsum(s["unallocated_idle_j"] for s in eps)
        ru = fleet_rollup(total_j)
        base_rt = np.broadcast_to(
            (slo_bound[:, pi] / scenario.slo_relax)[None, :],
            (n_e, n_w))
        rpi_of = {c.name: float(r) for c, r in zip(classes, rpi)}
        served_req = math.fsum(r["served_inv"] * rpi_of[r["class"]]
                               for r in recs)
        report.summary.append({
            "policy": policy,
            "requests_total": requests_total,
            "served_requests": served_req,
            "backlog_inv_final": float(backlog[:, pi].sum()),
            "busy_j": math.fsum(r["busy_j"] for r in recs),
            "idle_j": math.fsum(r["idle_j"] for r in recs)
            + math.fsum(s["unallocated_idle_j"] for s in eps),
            "total_j": total_j,
            "chip_kwh": ru.chip_kwh,
            "facility_kwh": ru.facility_kwh,
            "co2_kg": ru.co2_kg,
            "cost_usd": ru.cost_usd,
            "slo_violation_rate": runtime_violation_rate(
                eff_hist[:, :, pi], base_rt, scenario.slo_relax),
            "retunes": sum(s["retunes"] for s in eps),
            "j_per_request": total_j / max(1.0, served_req),
            "shed_inv_total": math.fsum(r["shed_inv"] for r in recs),
            "worst_regret_frac": max(
                (r["regret_frac"] for r in recs), default=0.0),
            "pg_fallback_epochs": sum(
                1 for s in eps if s["pg_fallback"]),
        })
    if ft is not None:
        af = ft.any_fault()
        report.fault_summary = {
            "n_transitions": int(ft.n_transitions),
            "faulted_epochs": int(af.sum()),
            "chip_fault_epochs": int((ft.chips_down > 0).sum()),
            "link_fault_epochs": int(
                (ft.link_rates != 1.0).any(axis=1).sum()),
            "pg_fault_epochs": int(ft.pg_fault.sum()),
            "chips_down_max": int(ft.chips_down.max()),
            "repair_epochs": ft.repair_epochs(),
        }
    if runner is not None:
        report.guard = runner.report.to_dict()
    if ck is not None:
        ck.save_final(report.to_dict())
        ck.close()
    return report


# --------------------------------------------------------------------------
# the chaos campaign runner
# --------------------------------------------------------------------------

def _recovery_times(report: FleetReport, timeline: FaultTimeline,
                    policy: str, regret_tol: float) -> list[int]:
    """Epochs-to-recover after each repair (fleet returns to fully
    clean): the first epoch at/after the repair where none of the
    policy's class records violates the SLO and every record's
    SLO-constrained regret is within ``regret_tol`` — i.e. the
    governor is back on (near-)optimal knobs with the queue drained
    enough to meet the bound. A window that never recovers is censored
    at the remaining epoch count.
    """
    ok = np.ones(report.n_epochs, bool)
    for r in report.records:
        if r["policy"] != policy:
            continue
        if r["slo_violated"] or r["regret_frac"] > regret_tol:
            ok[r["epoch"]] = False
    out = []
    for r0 in timeline.repair_epochs():
        rec = next((e for e in range(r0, report.n_epochs) if ok[e]),
                   None)
        out.append((rec - r0) if rec is not None
                   else report.n_epochs - r0)
    return out


def sweep_chaos(scenario: FleetScenario, knob_grid=None, *,
                fault_severities: Sequence[float] = (0.0, 1.0, 2.0),
                hysteresis: Optional[Hysteresis] = None,
                thrash_baseline: bool = True,
                recovery_regret_tol: float = 0.05,
                device=None,
                guard: Optional[GuardPolicy] = None,
                checkpoint=None) -> dict:
    """The chaos campaign: seeded fault scenarios × severities ×
    policies through the fleet simulator.

    For each severity the canonical ``faults.fault_plan`` spec is
    realized into a timeline seeded ``(scenario.seed, bits(severity))``
    (the severity's own float64 bit pattern, NOT its list position) —
    per-(chip, link) child streams inside — so scenarios never share
    or shift each other's fault draws: adding or removing a severity
    from the campaign leaves every other severity's timeline
    bit-identical, and ``sweep_fleet`` replays it
    under the anti-thrash hysteresis governor (each epoch still
    exactly one ``evaluate_batch`` call). With ``thrash_baseline``
    (default) every faulted scenario is also run under the stateless
    governor, the thrashing control the anti-thrash invariant is
    measured against.

    Returns ``{"summary": [per (severity, policy) rows], "reports",
    "baseline_reports", "timelines", ...}`` where each summary row
    carries the campaign metrics: worst/mean SLO-constrained regret,
    recovery time after repair (see ``_recovery_times``), retune
    counts vs the fault-transition bound and vs the thrash baseline,
    violation rate, shed volume, and energy/carbon totals.
    Deterministic: same scenario seed → bit-identical campaign.

    ``device`` / ``guard`` / ``checkpoint`` thread the device and the
    guard plane through every fleet run of the campaign (see
    ``sweep_fleet``). A chaos
    checkpoint directory holds a campaign-level ``RunManifest`` plus
    one sub-run checkpoint per (severity, governor) leg
    (``run<i>_hyst`` / ``run<i>_base``); a SIGKILLed campaign resumes
    mid-leg from that leg's last epoch snapshot, finished legs
    short-circuit to their stored final reports, and the summary rows
    are rebuilt deterministically — the resumed campaign is
    bit-identical to an uninterrupted one.
    """
    sevs = tuple(float(s) for s in fault_severities)
    if not sevs:
        raise ValueError("fault_severities must be non-empty")
    if len(set(sevs)) != len(sevs):
        raise ValueError(f"duplicate fault severities: {sevs}")
    if not (math.isfinite(recovery_regret_tol)
            and recovery_regret_tol >= 0):
        raise ValueError(f"recovery_regret_tol must be >= 0, got "
                         f"{recovery_regret_tol!r}")
    hys = hysteresis if hysteresis is not None else Hysteresis()
    if not isinstance(hys, Hysteresis):
        raise ValueError(f"hysteresis must be a slo.Hysteresis, "
                         f"got {type(hys)}")
    ck = None
    if checkpoint is not None:
        if not isinstance(checkpoint, (str, os.PathLike)):
            raise ValueError(
                f"checkpoint must be a directory path (str or "
                f"os.PathLike), got {type(checkpoint).__name__}")
        manifest = RunManifest(
            kind="chaos", seed=int(scenario.seed),
            n_epochs=scenario.n_epochs,
            backend=str(resolve_device(device)),
            knob_digest=digest_of(as_knob_tuple(knob_grid)),
            scenario_digest=digest_of((scenario, hys,
                                       bool(thrash_baseline))),
            severity_levels=scenario.severity_levels,
            fault_severities=sevs, policies=scenario.policies)
        ck = CampaignCheckpoint(checkpoint, manifest, keep=1)
    # the link plane covers the largest per-class topology; smaller
    # classes read a prefix of each epoch's link-rate row
    lmax = max(n_links(topology_for(max(1, c.workload.n_chips)))
               for c in scenario.classes)
    out: dict = {"fault_severities": sevs, "policies": scenario.policies,
                 "seed": int(scenario.seed), "hysteresis": hys,
                 "summary": [], "reports": {}, "baseline_reports": {},
                 "timelines": {}}
    for si, sev in enumerate(sevs):
        sev_key = int(np.float64(sev + 0.0).view(np.uint64))
        tl = build_fault_timeline(
            fault_plan(sev), n_epochs=scenario.n_epochs,
            n_chips=scenario.n_chips, n_links=lmax,
            seed=(int(scenario.seed), sev_key))
        sub_h = sub_b = None
        if ck is not None:
            sub_h = os.path.join(ck.dir, f"run{si}_hyst")
            sub_b = os.path.join(ck.dir, f"run{si}_base")
        rep = sweep_fleet(scenario, knob_grid, device=device,
                          faults=tl, hysteresis=hys,
                          guard=guard, checkpoint=sub_h)
        out["reports"][sev] = rep
        out["timelines"][sev] = tl
        base = None
        if thrash_baseline:
            base = sweep_fleet(scenario, knob_grid, device=device,
                               faults=tl, hysteresis=None, guard=guard,
                               checkpoint=sub_b)
            out["baseline_reports"][sev] = base
        for policy in scenario.policies:
            ps = rep.policy_summary(policy)
            recs = [r for r in rep.records if r["policy"] == policy]
            rts = _recovery_times(rep, tl, policy, recovery_regret_tol)
            row = {
                "fault_severity": sev, "policy": policy,
                "n_transitions": int(tl.n_transitions),
                "faulted_epochs": int(tl.any_fault().sum()),
                "retunes": int(ps["retunes"]),
                "worst_regret_frac": float(ps["worst_regret_frac"]),
                "mean_regret_frac": float(
                    np.mean([r["regret_frac"] for r in recs])),
                "slo_violation_rate": float(ps["slo_violation_rate"]),
                "recovery_epochs": rts,
                "recovery_epochs_max": max(rts, default=0),
                "shed_inv_total": float(ps["shed_inv_total"]),
                "pg_fallback_epochs": int(ps["pg_fallback_epochs"]),
                "total_j": float(ps["total_j"]),
                "j_per_request": float(ps["j_per_request"]),
            }
            if base is not None:
                row["baseline_retunes"] = int(
                    base.policy_summary(policy)["retunes"])
            out["summary"].append(row)
    return out
