"""Seeded fault injection + adversarial perturbation (jitter plane).

ReGate's HW idle-detection threshold is tuned against *smooth* idle
intervals; datacenter NPUs see bursty collectives, link flaps, and
stragglers. This module injects exactly that variability:

* **Perturbations** — pure trace -> trace transforms on a ``Workload``'s
  op columns, each driven by an explicit ``numpy.random.Generator`` (no
  global seed anywhere): burst arrival compression, link-degradation
  windows (rate cut for a stretch of the op stream), straggler chips
  pacing ring collectives, idle-interval fragmentation (one long gap
  becomes many short ones — the adversary of HW idle detection), and
  cycle-level clock jitter. A perturbed workload is an ordinary
  ``Workload``, so perturbed stacks compile and sweep through the
  batched ``_sweep_kernel`` unchanged.
* **Severity axis** — ``severity_plan`` maps a scalar severity in [0, 1+]
  onto a canonical composition of the five transforms (0 = identity);
  ``perturb_suite`` applies a plan across a workload list with
  deterministic per-workload child generators.
* **Adversarial ISA fuzzing** — ``adversarial_events`` generates
  pathological sparse programs (zero-length gaps, same-cycle bundle
  collisions, gaps exactly at the idle-detection window, window-straddling
  bursts, setpm during an exposed wake); ``differential_fuzz`` runs them
  through ``EventTimeline`` vs the ``VLIWTimeline`` cycle-stepper and
  demands exact equality — the jitter plane's executor hardening harness.

Determinism contract: every entry point takes either a ``Generator`` or
an integer seed; the same seed always reproduces the same perturbed
trace / fuzz corpus bit-for-bit (``tests/test_torch_perturb.py`` holds
it to the reference package's streams).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.isa import (EventTimeline, Instr, PMode, VLIWTimeline,
                            expand_events, merge_events, setpm)
from repro_torch.core.opgen import Op, Workload

# the per-op quantities that carry service time (and hence idle structure)
_CARRIERS = ("flops_sa", "flops_vu", "bytes_hbm", "bytes_ici")


def _require_rng(rng) -> np.random.Generator:
    if not isinstance(rng, np.random.Generator):
        raise TypeError(
            "perturbations require an explicit numpy.random.Generator "
            f"(got {type(rng).__name__}); pass numpy.random.default_rng("
            "seed) — global seeding is not supported")
    return rng


class Perturbation:
    """A pure, seeded transform on a workload's op columns.

    ``apply`` receives a dict of fresh per-op arrays (the ``_CARRIERS``
    plus ``count`` f8 and ``collective`` bool) and the explicit
    ``Generator``; it mutates/replaces columns and returns the dict.
    Implementations must draw from ``rng`` the same number of variates
    regardless of data values, so composed plans stay deterministic.
    """

    def apply(self, cols: dict[str, np.ndarray],
              rng: np.random.Generator) -> dict[str, np.ndarray]:
        raise NotImplementedError


@dataclass(frozen=True)
class BurstCompression(Perturbation):
    """Compress each maximal run of ICI-active ops by ``factor``.

    A run of L active ops keeps its leading ``ceil(L/factor)`` ops
    carrying traffic; the rest go silent and their bytes move onto the
    kept ops (equal per executed instance). Total wire bytes are
    conserved per run; the idle gaps between bursts get longer and the
    bursts denser — the bursty-arrival half of the jitter model.
    ``factor=1`` is the identity.
    """

    factor: float = 2.0

    def __post_init__(self):
        if not (math.isfinite(self.factor) and self.factor >= 1.0):
            raise ValueError(f"factor must be >= 1, got {self.factor}")

    def apply(self, cols, rng):
        _require_rng(rng)
        b, cnt = cols["bytes_ici"], cols["count"]
        active = b > 0
        if self.factor == 1.0 or not active.any():
            return cols
        out = b.copy()
        n = len(b)
        i = 0
        while i < n:
            if not active[i]:
                i += 1
                continue
            j = i
            while j < n and active[j]:
                j += 1
            run = slice(i, j)
            keep = max(1, math.ceil((j - i) / self.factor))
            total = float((b[run] * cnt[run]).sum())
            kept_instances = float(cnt[i:i + keep].sum())
            out[run] = 0.0
            out[i:i + keep] = total / kept_instances
            i = j
        cols["bytes_ici"] = out
        return cols


@dataclass(frozen=True)
class LinkDegradation(Perturbation):
    """Link-flap events: for ``n_events`` windows of the op stream the
    ICI link runs at ``rate`` of nominal, so the same payload takes
    ``1/rate`` longer on the wire (modeled as a bytes_ici stretch over
    the window). Window starts are drawn from ``rng``; windows may
    overlap (stacking multiplicatively, like consecutive flaps)."""

    rate: float = 0.5
    n_events: int = 2
    window_frac: float = 0.10

    def __post_init__(self):
        if not (0.0 < self.rate <= 1.0):
            raise ValueError(f"rate must be in (0, 1], got {self.rate}")
        if self.n_events < 0:
            raise ValueError(f"n_events must be >= 0, got {self.n_events}")
        if not (0.0 < self.window_frac <= 1.0):
            raise ValueError(
                f"window_frac must be in (0, 1], got {self.window_frac}")

    def apply(self, cols, rng):
        _require_rng(rng)
        b = cols["bytes_ici"]
        n = len(b)
        # fixed draw count regardless of data (determinism under
        # composition): always consume n_events starts
        starts = rng.integers(0, max(1, n), size=self.n_events)
        if n == 0 or self.rate == 1.0 or not (b > 0).any():
            return cols
        w = max(1, int(round(self.window_frac * n)))
        scale = np.ones(n)
        for s in starts:
            scale[int(s):int(s) + w] /= self.rate
        cols["bytes_ici"] = b * scale
        return cols


@dataclass(frozen=True)
class Straggler(Perturbation):
    """Straggler chips: ring collectives are paced by their slowest
    participant, so each affected collective op's wire time stretches by
    ``slowdown``. A fraction ``frac`` of the collective ops is hit
    (membership drawn from ``rng`` — a straggler hurts the collectives
    it participates in, not every one)."""

    slowdown: float = 1.5
    frac: float = 1.0

    def __post_init__(self):
        if not (math.isfinite(self.slowdown) and self.slowdown >= 1.0):
            raise ValueError(
                f"slowdown must be >= 1, got {self.slowdown}")
        if not (0.0 <= self.frac <= 1.0):
            raise ValueError(f"frac must be in [0, 1], got {self.frac}")

    def apply(self, cols, rng):
        _require_rng(rng)
        b = cols["bytes_ici"]
        draw = rng.random(len(b))  # fixed draw count (determinism)
        hit = cols["collective"] & (b > 0) & (draw < self.frac)
        cols["bytes_ici"] = np.where(hit, b * self.slowdown, b)
        return cols


@dataclass(frozen=True)
class ClockJitter(Perturbation):
    """Cycle-level clock jitter: each op's duration carriers (SA/VU flops,
    HBM/ICI bytes) all stretch by one multiplicative lognormal factor
    ``exp(sigma * z)`` with ``z ~ N(0, 1)`` clipped to ±4 — component
    ratios within an op are preserved, the op boundary wobbles."""

    sigma: float = 0.02

    def __post_init__(self):
        if not (math.isfinite(self.sigma) and self.sigma >= 0.0):
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")

    def apply(self, cols, rng):
        _require_rng(rng)
        n = len(cols["count"])
        z = np.clip(rng.standard_normal(n), -4.0, 4.0)
        if self.sigma == 0.0:
            return cols
        f = np.exp(self.sigma * z)
        for c in _CARRIERS:
            cols[c] = cols[c] * f
        return cols


@dataclass(frozen=True)
class IdleFragmentation(Perturbation):
    """Fragment op instances: ``count *= factor``, carriers ``/= factor``.

    Totals (flops x count, bytes x count) are conserved, but each
    executed instance — and its within-op idle slack — shrinks by
    ``factor``, so one long idle interval becomes ``factor`` short ones,
    each separately detected and separately paying the wake-up delay.
    This is the adversarial half of the jitter model for HW
    idle-detection: fragmentation drives per-instance slack down toward
    the detection window, where an aggressively small window gates
    every fragment (paying ``delay`` per wake for little gated time)
    while a conservative window skips them. A fraction ``frac`` of the
    multi-instance ops is hit (membership drawn from ``rng``).
    """

    factor: int = 4
    frac: float = 1.0

    def __post_init__(self):
        if int(self.factor) != self.factor or self.factor < 1:
            raise ValueError(
                f"factor must be an integer >= 1, got {self.factor}")
        if not (0.0 <= self.frac <= 1.0):
            raise ValueError(f"frac must be in [0, 1], got {self.frac}")

    def apply(self, cols, rng):
        _require_rng(rng)
        n = len(cols["count"])
        draw = rng.random(n)  # fixed draw count (determinism)
        if self.factor == 1:
            return cols
        busy = np.zeros(n, bool)
        for c in _CARRIERS:
            busy |= cols[c] > 0
        hit = busy & (draw < self.frac)
        f = float(self.factor)
        cols["count"] = np.where(hit, cols["count"] * f, cols["count"])
        for c in _CARRIERS:
            cols[c] = np.where(hit, cols[c] / f, cols[c])
        return cols


def severity_plan(severity: float) -> tuple[Perturbation, ...]:
    """Canonical severity axis for ``sweep.sweep_robustness``.

    Maps a scalar severity (0 = clean, 1 = severe; >1 allowed) onto a
    composition of all four transforms with monotonically harsher
    parameters. Severity 0 returns the empty plan (exact identity).
    """
    if not (math.isfinite(severity) and severity >= 0.0):
        raise ValueError(f"severity must be >= 0, got {severity}")
    if severity == 0.0:
        return ()
    s = float(severity)
    return (
        BurstCompression(factor=1.0 + 2.0 * s),
        LinkDegradation(rate=max(0.2, 1.0 - 0.6 * min(s, 1.0)),
                        n_events=1 + int(3 * s),
                        window_frac=min(1.0, 0.05 + 0.10 * s)),
        Straggler(slowdown=1.0 + 0.5 * s,
                  frac=min(1.0, 0.5 + 0.5 * s)),
        IdleFragmentation(factor=1 + int(round(32.0 * s * s)),
                          frac=min(1.0, 0.3 + 0.4 * s)),
        ClockJitter(sigma=0.05 * s),
    )


def fault_severity(chip_down_frac: float,
                   link_rates=None,
                   pg_fault: bool = False) -> float:
    """Map an epoch's fault state onto the ``severity_plan`` axis.

    The chaos plane (``core.faults``) keys its perturbation severity off
    the injected fault state rather than an exogenous knob: a drained or
    failing fleet runs the survivors hotter and burstier, and degraded
    or down links inject exactly the retransmission/pacing jitter
    ``LinkDegradation``/``Straggler`` model. Monotone in both inputs,
    0 for a clean epoch (so the clean path stays the exact identity),
    and continuous so the severity hint interpolates a scenario's
    ``severity_levels`` ladder sensibly.
    """
    f = float(chip_down_frac)
    if not (math.isfinite(f) and 0.0 <= f <= 1.0):
        raise ValueError(
            f"chip_down_frac must be in [0, 1], got {chip_down_frac}")
    s = 1.5 * f
    if link_rates is not None:
        lr = np.asarray(link_rates, np.float64)
        if lr.size:
            if not np.isfinite(lr).all() or (lr < 0).any() \
                    or (lr > 1).any():
                raise ValueError(
                    "link_rates must be finite and in [0, 1]")
            s += 2.0 * float((1.0 - lr).mean())
            if (lr <= 0.0).any():
                s += 0.5
    if pg_fault:
        s += 0.25
    return min(s, 3.0)


def perturb_workload(wl: Workload,
                     perturbations: Sequence[Perturbation],
                     rng: np.random.Generator, *,
                     name: Optional[str] = None) -> Workload:
    """Apply a perturbation plan to one workload: pure trace -> trace.

    Returns a NEW ``Workload`` (ops rebuilt from the transformed
    columns; ``matmul_dims``/``sram_demand`` structure kept) so the
    identity-cached compile/stack/sweep pipeline treats it as a
    distinct trace. The empty plan returns a renamed copy with
    bit-identical columns.
    """
    _require_rng(rng)
    cols = {
        "flops_sa": np.array([o.flops_sa for o in wl.ops], np.float64),
        "flops_vu": np.array([o.flops_vu for o in wl.ops], np.float64),
        "bytes_hbm": np.array([o.bytes_hbm for o in wl.ops], np.float64),
        "bytes_ici": np.array([o.bytes_ici for o in wl.ops], np.float64),
        "count": np.array([o.count for o in wl.ops], np.float64),
        "collective": np.array([o.collective for o in wl.ops], bool),
    }
    for p in perturbations:
        cols = p.apply(cols, rng)
    # direct positional construction — dataclasses.replace costs ~10x
    # per op and dominates suite-scale perturbation otherwise
    fs, fv, bh, bi = (cols["flops_sa"], cols["flops_vu"],
                      cols["bytes_hbm"], cols["bytes_ici"])
    ct = np.rint(cols["count"]).astype(np.int64)
    ops = tuple(
        Op(op.name, float(fs[i]), float(fv[i]), float(bh[i]),
           float(bi[i]), op.sram_demand, op.matmul_dims, int(ct[i]),
           op.collective)
        for i, op in enumerate(wl.ops))
    return Workload(name if name is not None else f"{wl.name}~jit",
                    wl.kind, ops, n_chips=wl.n_chips, note=wl.note)


def perturb_suite(workloads: Sequence[Workload],
                  perturbations: Sequence[Perturbation], *,
                  seed: int, stream: int = 0,
                  names: Optional[Sequence[str]] = None) \
        -> list[Workload]:
    """Apply one plan across a workload list.

    Each workload gets its own child generator derived from the seed
    tuple ``(seed, stream, index)`` (``numpy`` SeedSequence spawning),
    so results are independent of list length and order-stable —
    deleting workload 3 does not change workload 4's perturbation.
    ``stream`` separates severity levels (or repeats) sharing a seed.
    """
    out = []
    for i, wl in enumerate(workloads):
        rng = np.random.default_rng((int(seed), int(stream), i))
        nm = names[i] if names is not None else None
        out.append(perturb_workload(wl, perturbations, rng, name=nm))
    return out


def severity_variants(workloads: Sequence[Workload],
                      severities: Sequence[float], *,
                      seed: int) -> dict[float, list[Workload]]:
    """Pre-built trace variants per severity level — the fleet plane's
    traffic-variability hook (it lets
    fleet scenarios draw their variability from the same perturbation
    plans as the jitter plane).

    For each level ``severities[si]`` the whole workload list is run
    through ``severity_plan(level)`` with ``stream=si`` (children seeded
    ``(seed, si, workload_index)``), so a fleet epoch can select its
    congestion level by indexing the returned dict instead of
    re-perturbing per epoch — the variant *objects* are stable, which
    keeps the identity-cached stack/compile pipeline warm across
    epochs. Severity 0 yields renamed but bit-identical traces; every
    variant preserves op counts (stable stack shapes → the jitted sweep
    program is reused across all levels).
    """
    out: dict[float, list[Workload]] = {}
    for si, sev in enumerate(severities):
        sev = float(sev)
        if sev in out:
            raise ValueError(f"duplicate severity level {sev}")
        out[sev] = perturb_suite(
            list(workloads), severity_plan(sev), seed=seed, stream=si,
            names=[f"{wl.name}@sev{si}" for wl in workloads])
    return out


# --------------------------------------------------------------------------
# Adversarial ISA programs + differential fuzz harness
# --------------------------------------------------------------------------

# the fuzz machine: 1 SA (PE-granular gating), 2 VUs, HBM + ICI movers
FUZZ_UNITS = (("sa0", "sa"), ("vu0", "vu"), ("vu1", "vu"),
              ("dma0", "hbm"), ("ici0", "ici"))
FUZZ_KW = dict(n_sa=1, n_vu=2,
               extra_units={"dma0": "hbm", "ici0": "ici"},
               delay_keys={"sa": "sa_pe"},
               initial_modes={"vu1": PMode.ON})


def adversarial_events(rng: np.random.Generator, *, n_events: int = 40,
                       npu: str = "NPU-D") \
        -> tuple[list[tuple[int, dict[str, Instr]]], int]:
    """One pathological sparse program for the differential harness.

    Stresses every closed-form edge of ``EventTimeline._gap``:

    * zero-length gaps (back-to-back cycles) and same-cycle collisions
      (raw duplicate cycles, canonicalized via ``merge_events``);
    * gaps of exactly ``window - 1`` / ``window`` / ``window + 1`` per FU
      kind (the idle-detection boundary) and window-straddling bursts
      (repeated sub-window gaps, then one at the boundary);
    * wake-delay-sized latencies and setpm issued 1..delay-1 cycles after
      a wake — i.e. during the exposed wake window;
    * setpm on every FU family, both modes, random bitmaps.

    Returns ``(events, horizon)`` with ``events`` already canonical.
    """
    _require_rng(rng)
    probe = VLIWTimeline(npu=npu, **FUZZ_KW)
    kinds = sorted({k for _, k in FUZZ_UNITS})
    win = {k: probe._window(k) for k in kinds}
    dly = {k: probe._delay(k) for k in kinds}
    raw: list[tuple[int, dict[str, Instr]]] = []
    c = 0
    for _ in range(n_events):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        w, d = win[kind], dly[kind]
        # pathological gap menu: collisions (0), zero-length gaps (1),
        # the exact detection boundary, straddlers, wake-delay offsets
        gaps = (0, 1, 1, 2, w - 1, w, w + 1, max(1, w - 1), d,
                max(1, d - 1), d + 1, w + d, 3 * w + 7)
        c += int(gaps[int(rng.integers(0, len(gaps)))])
        b: dict[str, Instr] = {}
        for u, uk in FUZZ_UNITS:
            if rng.random() < 0.35:
                lat = (1, 2, 5, win[uk], dly[uk], dly[uk] + 1,
                       30)[int(rng.integers(0, 7))]
                b[u] = Instr("op", u, max(1, int(lat)))
        if rng.random() < 0.35:
            k2 = kinds[int(rng.integers(0, len(kinds)))]
            b["misc"] = setpm(
                k2, int(rng.integers(1, 4)),
                PMode.ON if rng.random() < 0.5 else PMode.OFF)
        if b:
            raw.append((c, b))
        if rng.random() < 0.25 and b:
            # setpm inside the exposed wake of whatever just dispatched:
            # 1..delay-1 cycles after the bundle
            k2 = kinds[int(rng.integers(0, len(kinds)))]
            off = 1 + int(rng.integers(0, max(1, dly[k2] - 1)))
            raw.append((c + off, {"misc": setpm(
                k2, int(rng.integers(1, 4)),
                PMode.OFF if rng.random() < 0.5 else PMode.ON)}))
    events = merge_events(raw)
    last = events[-1][0] if events else 0
    horizon = last + int(rng.integers(0, 2 * max(win.values())))
    return events, horizon


def _exec_mismatch(a, b) -> Optional[str]:
    if a.cycles != b.cycles:
        return f"cycles {a.cycles} != {b.cycles}"
    if a.stall_cycles != b.stall_cycles:
        return f"stalls {a.stall_cycles} != {b.stall_cycles}"
    if a.setpm_executed != b.setpm_executed:
        return f"setpm {a.setpm_executed} != {b.setpm_executed}"
    for fld in ("fu_on_cycles", "fu_gated_cycles", "wake_events"):
        if getattr(a, fld) != getattr(b, fld):
            return f"{fld} {getattr(a, fld)} != {getattr(b, fld)}"
    return None


def differential_fuzz(n_programs: int = 200, seed: int = 0, *,
                      n_events: int = 40, npu: str = "NPU-D") -> dict:
    """Differential fuzz: ``EventTimeline`` vs the ``VLIWTimeline``
    cycle-stepper on ``n_programs`` adversarial programs, each run with
    hardware auto-gating off and on.

    Raises ``AssertionError`` naming the seed / program index / first
    divergent counter on any mismatch (ExecResult counters are integers,
    so the check is exact). Returns corpus stats on success.
    """
    rng = np.random.default_rng(seed)
    stats = {"programs": 0, "runs": 0, "events": 0, "cycles": 0,
             "mismatches": 0, "seed": seed}
    for p in range(n_programs):
        events, horizon = adversarial_events(rng, n_events=n_events,
                                             npu=npu)
        stats["programs"] += 1
        stats["events"] += len(events)
        for hw_auto in (False, True):
            kw = dict(FUZZ_KW, hw_auto_gating=hw_auto,
                      initial_modes=dict(FUZZ_KW["initial_modes"]))
            ref = VLIWTimeline(npu=npu, **kw).run(
                expand_events(events, horizon))
            got = EventTimeline(npu=npu, **kw).run(events,
                                                   horizon=horizon)
            diff = _exec_mismatch(ref, got)
            if diff is not None:
                stats["mismatches"] += 1
                raise AssertionError(
                    f"executor divergence: seed={seed} program={p} "
                    f"hw_auto={hw_auto}: {diff}")
            stats["runs"] += 1
            stats["cycles"] += ref.cycles
    return stats


def main(argv=None) -> int:
    """CLI smoke entry: ``python -m repro_torch.core.perturb --fuzz N``."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fuzz", type=int, default=80,
                    help="number of adversarial programs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", type=int, default=40,
                    help="events per program")
    args = ap.parse_args(argv)
    stats = differential_fuzz(args.fuzz, args.seed, n_events=args.events)
    print(f"fuzz ok: {stats['programs']} programs, {stats['runs']} runs, "
          f"{stats['events']} events, {stats['cycles']} ref cycles, "
          f"0 mismatches (seed={stats['seed']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
