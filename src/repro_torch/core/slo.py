"""SLO-constrained configuration search + cross-generation energy
efficiency (paper §3, Fig 2, Table 4).

The paper's methodology: profile each workload at the default batch on
the minimum number of NPU-D chips; 1/5 of that performance is the 1xSLO;
for every NPU generation, sweep (chips, batch) and keep the most
energy-efficient SLO-compliant configuration. We reproduce the sweep with
the op-level simulator: performance = tokens/s (train, decode) or
requests/s (prefill); energy efficiency = useful work per joule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core.hw import NPUS, get_npu
from repro_torch.core.opgen import Workload, llm_workload
from repro_torch.core.sweep import group_by, sweep


@dataclass(frozen=True)
class SweepPoint:
    npu: str
    n_chips: int
    batch: int
    perf: float           # work units / s (all chips together)
    energy_j: float       # J per workload invocation (all chips)
    work: float           # work units per invocation

    @property
    def efficiency(self) -> float:
        return self.work / self.energy_j  # work per J


def _work_units(phase: str, batch: int) -> float:
    if phase == "train":
        return batch * 4096.0          # tokens per step
    return float(batch)                # requests (prefill) / tokens (decode)


def _config_workloads(model: str, phase: str,
                      configs: list[tuple[int, int]]) -> list[Workload]:
    wls = []
    for n_chips, batch in configs:
        tp = min(n_chips, 8)
        dp = max(1, n_chips // tp)
        wls.append(llm_workload(model, phase, batch=batch, n_chips=n_chips,
                                tp=tp, dp=dp))
    return wls


def _points(recs: list[dict], configs: list[tuple[int, int]],
            phase: str, npu: str) -> list[SweepPoint]:
    out = []
    for (n_chips, batch), rec in zip(configs, recs):
        work = _work_units(phase, batch)
        out.append(SweepPoint(npu, n_chips, batch,
                              work / rec["runtime_s"],
                              rec["total_j"] * n_chips, work))
    return out


def _measure_batch(model: str, phase: str, npu: str,
                   configs: list[tuple[int, int]],
                   device=None) -> list[SweepPoint]:
    """Evaluate all (n_chips, batch) candidates through one batched
    sweep() call (one stacked trace, one set of array passes)."""
    wls = _config_workloads(model, phase, configs)
    recs = sweep(wls, npus=(npu,), policies=("NoPG",), device=device)
    return _points(recs, configs, phase, npu)


def _measure(model: str, phase: str, npu: str, n_chips: int,
             batch: int, device=None) -> SweepPoint:
    return _measure_batch(model, phase, npu, [(n_chips, batch)],
                          device)[0]


def hbm_fits(model: str, npu: str, n_chips: int, batch: int,
             phase: str) -> bool:
    """Coarse capacity check: weights (+optimizer for train) + KV cache."""
    from repro_torch.core.opgen import LLAMA
    c = LLAMA[model]
    n_params = c.L * (c.d * (c.d + 2 * c.Hkv * (c.d // c.H) + c.d)
                      + 3 * c.d * c.ff) + 2 * c.d * c.vocab
    spec = get_npu(npu)
    bytes_needed = n_params * (16.0 if phase == "train" else 2.0)
    if phase != "train":
        kv = c.L * batch * 4608 * 2 * c.Hkv * (c.d // c.H) * 2.0
        bytes_needed += kv
    return bytes_needed <= spec.hbm_gb * 1e9 * n_chips * 0.9


def runtime_violation_rate(runtimes, baselines,
                           slo_relax: float = 1.1) -> float:
    """Fraction of cells whose runtime exceeds ``slo_relax`` x baseline.

    The jitter-plane SLO metric (``sweep.sweep_robustness``): each
    perturbed cell's baseline is the clean-trace runtime of the same
    (workload, npu, policy, threshold) cell, so the rate measures how
    often jitter alone pushes a configuration past its relaxed SLO.
    Shapes must match element-for-element; empty input has rate 0.
    """
    if slo_relax <= 0:
        raise ValueError(f"slo_relax must be > 0, got {slo_relax}")
    r = np.asarray(runtimes, np.float64)
    b = np.asarray(baselines, np.float64)
    if r.shape != b.shape:
        raise ValueError(
            f"runtimes {r.shape} and baselines {b.shape} must match")
    if r.size == 0:
        return 0.0
    return float(np.mean(r > slo_relax * b))


@dataclass(frozen=True)
class Hysteresis:
    """Anti-thrash parameters for the stateful ``retune_knobs`` governor.

    ``cooldown_epochs``: minimum epochs between retunes of one row.
    ``min_improvement``: an opportunistic (deployed-still-feasible)
    retune needs the cheapest feasible knob to save at least this
    fraction of the deployed knob's energy. ``backoff_base`` /
    ``backoff_cap``: after each *forced* retune in an unbroken run of
    SLO violations the row's cooldown multiplies by ``backoff_base``
    (capped at ``backoff_cap`` epochs) — repeated violations mean the
    environment is flapping faster than retuning can help, so the
    governor backs off exponentially instead of chasing it.
    """

    cooldown_epochs: int = 2
    min_improvement: float = 0.02
    backoff_base: float = 2.0
    backoff_cap: int = 16

    def __post_init__(self):
        if not (isinstance(self.cooldown_epochs, (int, np.integer))
                and self.cooldown_epochs >= 0):
            raise ValueError(f"cooldown_epochs must be >= 0, "
                             f"got {self.cooldown_epochs!r}")
        if not (isinstance(self.min_improvement, (int, float))
                and np.isfinite(self.min_improvement)
                and 0.0 <= self.min_improvement < 1.0):
            raise ValueError(f"min_improvement must be in [0, 1), "
                             f"got {self.min_improvement!r}")
        if not (isinstance(self.backoff_base, (int, float))
                and np.isfinite(self.backoff_base)
                and self.backoff_base >= 1.0):
            raise ValueError(f"backoff_base must be >= 1, "
                             f"got {self.backoff_base!r}")
        if not (isinstance(self.backoff_cap, (int, np.integer))
                and self.backoff_cap >= 1):
            raise ValueError(f"backoff_cap must be >= 1, "
                             f"got {self.backoff_cap!r}")


@dataclass
class GovernorState:
    """Per-row mutable state threaded through epochs of stateful
    ``retune_knobs`` calls. ``retunes`` accumulates the per-row switch
    count (the anti-thrash metric)."""

    since_retune: np.ndarray   # epochs since the row last switched
    cooldown: np.ndarray       # current required gap before switching
    forced_streak: np.ndarray  # consecutive forced retunes (backoff)
    retunes: np.ndarray        # cumulative switches

    @classmethod
    def init(cls, n: int, hysteresis: "Hysteresis") -> "GovernorState":
        if not (isinstance(n, (int, np.integer)) and n >= 0):
            raise ValueError(f"n must be >= 0, got {n!r}")
        big = np.iinfo(np.int64).max // 2
        return cls(
            since_retune=np.full(n, big, np.int64),
            cooldown=np.full(n, int(hysteresis.cooldown_epochs),
                             np.int64),
            forced_streak=np.zeros(n, np.int64),
            retunes=np.zeros(n, np.int64))


def retune_knobs(energy, runtime, slo_runtime, deployed=None, *,
                 hysteresis: Optional[Hysteresis] = None,
                 state: Optional[GovernorState] = None) -> np.ndarray:
    """The SLO-constrained knob re-tune rule, vectorized over rows.

    This is the operator policy shared by the jitter plane
    (``sweep.sweep_robustness``) and the fleet governor
    (``fleet.sweep_fleet``): given per-row knob candidates with
    ``energy`` and ``runtime`` of shape (N, K) and an SLO runtime bound
    ``slo_runtime`` (broadcastable to (N, K)), keep the ``deployed``
    knob (default: the per-row energy argmin) while it meets the bound;
    once it violates, re-tune to the cheapest (lowest-energy) feasible
    knob; when no knob is feasible, fall back to the least-violating
    one (smallest runtime/bound ratio). Ties resolve to the lowest knob
    index. Returns the chosen knob index per row, shape (N,).

    With ``hysteresis`` (which then requires ``state`` and an explicit
    ``deployed``), the rule becomes the stateful anti-thrash governor:
    a row only switches when its cooldown has elapsed, forced switches
    (deployed violating) grow the cooldown exponentially while the
    violation streak lasts, and opportunistic switches additionally
    need a ``min_improvement`` energy saving. In a piecewise-constant
    environment the chosen knob is a fixed point of the stateless rule
    immediately after any switch (cheapest-feasible stays cheapest;
    least-violating stays least-violating), so the governor retunes at
    most once per fault transition. Stateless calls (``hysteresis=None``) are byte-for-byte
    the historical behavior.
    """
    e = np.asarray(energy, np.float64)
    r = np.asarray(runtime, np.float64)
    b = np.broadcast_to(np.asarray(slo_runtime, np.float64), r.shape)
    if e.shape != r.shape or e.ndim != 2:
        raise ValueError(
            f"energy {e.shape} and runtime {r.shape} must be equal 2-D")
    n = e.shape[0]
    rows = np.arange(n)
    if deployed is None:
        if hysteresis is not None:
            raise ValueError(
                "hysteresis requires an explicit deployed vector (the "
                "governor tracks what is currently running)")
        deployed = np.argmin(e, axis=1)
    deployed = np.asarray(deployed, np.int64)
    feas = r <= b
    any_feas = feas.any(axis=1)
    cheapest = np.argmin(np.where(feas, e, np.inf), axis=1)
    least_viol = np.argmin(r / np.maximum(b, 1e-300), axis=1)
    chosen = deployed.copy()
    need = ~feas[rows, deployed]
    chosen[need & any_feas] = cheapest[need & any_feas]
    chosen[need & ~any_feas] = least_viol[need & ~any_feas]
    if hysteresis is None:
        return chosen

    if state is None:
        raise ValueError("hysteresis requires a GovernorState "
                         "(GovernorState.init(n, hysteresis))")
    if state.since_retune.shape != (n,):
        raise ValueError(
            f"GovernorState is for {state.since_retune.shape[0]} rows, "
            f"got {n}")
    ready = state.since_retune >= state.cooldown
    # forced: deployed violates and the stateless target differs
    forced = need & ready & (chosen != deployed)
    # opportunistic: deployed feasible, cheapest feasible saves enough
    cheap_e = np.where(any_feas, e[rows, cheapest], np.inf)
    oppo = (~need & ready & (cheapest != deployed) & any_feas
            & (cheap_e <= (1.0 - hysteresis.min_improvement)
               * e[rows, deployed]))
    switch = forced | oppo
    target = np.where(need, chosen, cheapest)
    out = np.where(switch, target, deployed).astype(np.int64)
    # state update: streak counts back-to-back forced switches and
    # resets the moment the deployed knob is feasible again
    state.forced_streak = np.where(
        forced, state.forced_streak + 1,
        np.where(~need, 0, state.forced_streak))
    base_cd = max(1, int(hysteresis.cooldown_epochs))
    backoff = np.minimum(
        float(hysteresis.backoff_cap),
        base_cd * np.power(hysteresis.backoff_base,
                           np.minimum(state.forced_streak - 1, 40)))
    state.cooldown = np.where(
        forced, np.maximum(1, backoff.astype(np.int64)),
        np.where(oppo, int(hysteresis.cooldown_epochs),
                 state.cooldown))
    state.retunes = state.retunes + switch.astype(np.int64)
    state.since_retune = np.where(
        switch, 0, np.minimum(state.since_retune + 1,
                              np.iinfo(np.int64).max // 2))
    return out


def slo_sweep(model: str, phase: str, *, slo_relax: float = 5.0,
              gens=("NPU-A", "NPU-B", "NPU-C", "NPU-D", "NPU-E"),
              batches=(1, 4, 8, 32, 128, 512),
              chip_counts=(1, 2, 4, 8, 16, 32, 64),
              device=None) -> dict:
    """Returns {gen: best SweepPoint or None, "_slo": value}.

    ``device`` is where the one batched (config × generation)
    evaluation the search rides on runs (``None``: the session's
    device, as in ``sweep``).
    """
    # reference: default batch, minimum NPU-D chips that fit
    ref_batch = {"train": 32, "prefill": 4, "decode": 8}[phase]
    ref = None
    for n in chip_counts:
        if hbm_fits(model, "NPU-D", n, ref_batch, phase):
            ref = _measure(model, phase, "NPU-D", n, ref_batch, device)
            break
    if ref is None:
        return {"_slo": None}
    # per-chip normalized SLO (1/5 of reference performance per chip)
    slo_perf_per_chip = ref.perf / ref.n_chips / slo_relax

    out: dict = {"_slo": slo_perf_per_chip}
    # all generations ride ONE batched sweep: build each (chips, batch)
    # candidate workload once (instead of per generation) and evaluate
    # the full (config × generation) grid in a single stacked pass;
    # per-generation HBM-capacity filtering happens on the records.
    fits = {gen: {(n, b) for n in chip_counts for b in batches
                  if hbm_fits(model, gen, n, b, phase)} for gen in gens}
    union = [(n, b) for n in chip_counts for b in batches
             if any((n, b) in fits[gen] for gen in gens)]
    wls = _config_workloads(model, phase, union)
    recs = sweep(wls, npus=gens, policies=("NoPG",), device=device)
    by_gen = group_by(recs, "npu")  # workload-major order within each gen
    for gen in gens:
        gen_recs = by_gen.get((get_npu(gen).name,), [])
        best: Optional[SweepPoint] = None
        for cfg, pt in zip(union, _points(gen_recs, union, phase, gen)):
            if cfg not in fits[gen]:
                continue
            if pt.perf / pt.n_chips < slo_perf_per_chip:
                continue
            if best is None or pt.efficiency > best.efficiency:
                best = pt
        out[gen] = best
    return out
