"""Seeded fault-injection timelines (chaos plane).

The jitter plane distorts *execution* (op columns); this module injects
*availability* faults — the failure modes the TPU datacenter literature
(Jouppi et al.) and LinkGuardian-style link telemetry report — as
explicit, seeded timelines the fleet simulator replays:

* **chip plane** — MTBF fail/repair cycles per chip plus scheduled
  maintenance drains: per epoch, how many chips are out of service and
  whether any failed chip took its power-gating control logic with it
  (a ``pg_fault`` epoch, during which gated policies must fall back to
  NoPG-equivalent behavior — the graceful-degradation ladder's last
  rung);
* **link plane** — per-ICI-link event traces (flap / degrade / down,
  each with a duration) in the ``ici_topology.collective_schedule``
  link-rate convention: 1 healthy, (0, 1) degraded, 0 down.

Stream discipline follows ``perturb.py`` exactly: every sampler takes
an explicit seed, each chip and each link gets its OWN child stream
(``np.random.default_rng((seed, plane, index))``), and each stream
draws a FIXED count of uniforms (2 per chip-epoch, 3 per link-epoch)
regardless of what the draws decide — so adding chips or links, or
changing one entity's spec, never shifts any other entity's fault
draws, and two timelines built from the same seed are bit-identical.

``fault_plan(severity)`` is the canonical severity axis (mirroring
``perturb.severity_plan``): 0 is the exact no-fault spec, larger values
shorten MTBFs, lengthen repairs, and raise link event rates. The
module is also a CLI (``python -m repro_torch.core.faults --fuzz N``) running
the faults-seeded differential fuzz: the adversarial ISA corpus of
``perturb.differential_fuzz``, but with each program's event count and
stream keyed off one epoch of a fault timeline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.perturb import fault_severity

__all__ = [
    "ChipFaultSpec", "LinkFaultSpec", "FaultSpec", "FaultTimeline",
    "fault_plan", "build_fault_timeline", "chaos_fuzz",
]


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _check_prob(name: str, v: float) -> None:
    _check(isinstance(v, (int, float)) and math.isfinite(v)
           and 0.0 <= v <= 1.0, f"{name} must be in [0, 1], got {v!r}")


def _check_epochs(name: str, v: int) -> None:
    _check(isinstance(v, (int, np.integer)) and v >= 1,
           f"{name} must be a positive integer epoch count, got {v!r}")


@dataclass(frozen=True)
class ChipFaultSpec:
    """Chip-level fault process.

    ``mtbf_epochs`` is the mean epochs between failures of ONE chip
    (per-epoch failure hazard ``1/mtbf``; ``inf`` disables failures).
    A failed chip is out for ``repair_epochs`` epochs.  Every
    ``drain_every`` epochs (0 disables) a maintenance drain takes
    ``drain_frac`` of the fleet out for ``drain_epochs`` — drains are
    scheduled, so they are deterministic, not drawn.  Each failure
    independently corrupts the chip's power-gating control logic with
    probability ``pg_fault_prob``; while any such chip is down the
    epoch is flagged ``pg_fault``.
    """

    mtbf_epochs: float = math.inf
    repair_epochs: int = 4
    drain_every: int = 0
    drain_frac: float = 0.0
    drain_epochs: int = 1
    pg_fault_prob: float = 0.0

    def __post_init__(self):
        _check(isinstance(self.mtbf_epochs, (int, float))
               and not math.isnan(self.mtbf_epochs)
               and self.mtbf_epochs > 0,
               f"mtbf_epochs must be > 0 (inf allowed), "
               f"got {self.mtbf_epochs!r}")
        _check_epochs("repair_epochs", self.repair_epochs)
        _check(isinstance(self.drain_every, (int, np.integer))
               and self.drain_every >= 0,
               f"drain_every must be >= 0, got {self.drain_every!r}")
        _check_prob("drain_frac", self.drain_frac)
        _check_epochs("drain_epochs", self.drain_epochs)
        _check_prob("pg_fault_prob", self.pg_fault_prob)


@dataclass(frozen=True)
class LinkFaultSpec:
    """Per-ICI-link event process (flap / degrade / down).

    Each healthy link draws, per epoch: a hard *down* (rate 0 for
    ``down_epochs``) with probability ``down_prob``; else a *degrade*
    (rate ``degrade_rate`` for ``degrade_epochs``); else a *flap* —
    a short outage (rate 0 for ``flap_epochs``, typically 1). An
    in-event link draws nothing new until it recovers (durations are
    deterministic, so the draw count per link-epoch is fixed anyway).
    """

    flap_prob: float = 0.0
    flap_epochs: int = 1
    degrade_prob: float = 0.0
    degrade_rate: float = 0.5
    degrade_epochs: int = 2
    down_prob: float = 0.0
    down_epochs: int = 4

    def __post_init__(self):
        _check_prob("flap_prob", self.flap_prob)
        _check_epochs("flap_epochs", self.flap_epochs)
        _check_prob("degrade_prob", self.degrade_prob)
        _check(isinstance(self.degrade_rate, (int, float))
               and math.isfinite(self.degrade_rate)
               and 0.0 < self.degrade_rate < 1.0,
               f"degrade_rate must be in (0, 1), "
               f"got {self.degrade_rate!r}")
        _check_epochs("degrade_epochs", self.degrade_epochs)
        _check_prob("down_prob", self.down_prob)
        _check_epochs("down_epochs", self.down_epochs)


@dataclass(frozen=True)
class FaultSpec:
    """A chip-plane plus link-plane fault process."""

    chip: ChipFaultSpec = field(default_factory=ChipFaultSpec)
    link: LinkFaultSpec = field(default_factory=LinkFaultSpec)

    def __post_init__(self):
        if not isinstance(self.chip, ChipFaultSpec):
            raise ValueError(
                f"chip must be a ChipFaultSpec, got {type(self.chip)}")
        if not isinstance(self.link, LinkFaultSpec):
            raise ValueError(
                f"link must be a LinkFaultSpec, got {type(self.link)}")


def fault_plan(severity: float) -> FaultSpec:
    """Canonical fault-severity axis for ``sweep_chaos`` (the chaos
    analogue of ``perturb.severity_plan``).

    Maps a scalar severity (0 = clean, 1 = severe; >1 allowed) onto a
    ``FaultSpec`` with monotonically harsher parameters: shorter chip
    MTBF, longer repairs, scheduled drains from severity 1 up, and
    rising link flap/degrade/down rates. Severity 0 returns the exact
    no-fault spec (all probabilities zero, infinite MTBF).
    """
    if not (isinstance(severity, (int, float))
            and math.isfinite(severity) and severity >= 0.0):
        raise ValueError(f"severity must be >= 0, got {severity!r}")
    if severity == 0.0:
        return FaultSpec()
    s = float(severity)
    return FaultSpec(
        chip=ChipFaultSpec(
            mtbf_epochs=max(16.0, 600.0 / s),
            repair_epochs=2 + int(round(2.0 * min(s, 4.0))),
            drain_every=24 if s >= 1.0 else 0,
            drain_frac=min(0.5, 0.05 * s),
            drain_epochs=2,
            pg_fault_prob=min(1.0, 0.25 * s)),
        link=LinkFaultSpec(
            flap_prob=min(1.0, 0.03 * s),
            flap_epochs=1,
            degrade_prob=min(1.0, 0.02 * s),
            degrade_rate=max(0.25, 1.0 - 0.5 * min(s, 1.0)),
            degrade_epochs=2,
            down_prob=min(1.0, 0.01 * s),
            down_epochs=3))


@dataclass(frozen=True)
class FaultTimeline:
    """A realized fault timeline over ``n_epochs`` epochs.

    ``chips_down[e]`` counts chips out of service (failed + draining,
    capped at ``n_chips``); ``link_rates[e]`` is the ``(n_links,)``
    link-rate row for epoch ``e`` in the ``collective_schedule``
    convention; ``pg_fault[e]`` flags epochs where a failed chip's
    power-gating logic is corrupted; ``severity_hint[e]`` is the
    ``perturb.fault_severity`` value of the epoch's fault state (0 on
    clean epochs).
    """

    n_epochs: int
    n_chips: int
    n_links: int
    chips_down: np.ndarray       # (E,) int64
    link_rates: np.ndarray       # (E, L) float64 in [0, 1]
    pg_fault: np.ndarray         # (E,) bool
    severity_hint: np.ndarray    # (E,) float64

    def __post_init__(self):
        _check_epochs("n_epochs", self.n_epochs)
        _check(isinstance(self.n_chips, (int, np.integer))
               and self.n_chips >= 1,
               f"n_chips must be >= 1, got {self.n_chips!r}")
        _check(isinstance(self.n_links, (int, np.integer))
               and self.n_links >= 0,
               f"n_links must be >= 0, got {self.n_links!r}")
        e, l = int(self.n_epochs), int(self.n_links)
        cd = np.asarray(self.chips_down)
        _check(cd.shape == (e,), f"chips_down must have shape ({e},), "
               f"got {cd.shape}")
        _check(bool((cd >= 0).all() and (cd <= self.n_chips).all()),
               f"chips_down must be in [0, n_chips={self.n_chips}]")
        lr = np.asarray(self.link_rates)
        _check(lr.shape == (e, l), f"link_rates must have shape "
               f"({e}, {l}), got {lr.shape}")
        _check(bool(np.isfinite(lr).all() and (lr >= 0).all()
                    and (lr <= 1).all()),
               "link_rates must be finite and in [0, 1]")
        pg = np.asarray(self.pg_fault)
        _check(pg.shape == (e,) and pg.dtype == np.bool_,
               f"pg_fault must be a ({e},) bool array")
        sh = np.asarray(self.severity_hint)
        _check(sh.shape == (e,) and bool(np.isfinite(sh).all()
                                         and (sh >= 0).all()),
               f"severity_hint must be a finite ({e},) array >= 0")

    @classmethod
    def empty(cls, n_epochs: int, n_chips: int,
              n_links: int = 0) -> "FaultTimeline":
        """The all-clean timeline (exact no-op for ``sweep_fleet``)."""
        e, l = int(n_epochs), int(n_links)
        return cls(e, int(n_chips), l,
                   chips_down=np.zeros(e, np.int64),
                   link_rates=np.ones((e, l), np.float64),
                   pg_fault=np.zeros(e, np.bool_),
                   severity_hint=np.zeros(e, np.float64))

    @property
    def has_chip_faults(self) -> bool:
        return bool(self.chips_down.any())

    @property
    def has_link_faults(self) -> bool:
        return bool((self.link_rates != 1.0).any())

    @property
    def has_pg_faults(self) -> bool:
        return bool(self.pg_fault.any())

    def link_faulty(self, e: int) -> bool:
        return bool((self.link_rates[e] != 1.0).any())

    def any_fault(self) -> np.ndarray:
        """(E,) bool: epoch has any chip, link, or pg fault."""
        return ((self.chips_down > 0) | self.pg_fault
                | (self.link_rates != 1.0).any(axis=1))

    @property
    def n_transitions(self) -> int:
        """Distinct fault-state transitions: epoch boundaries where the
        (chips_down, link_rates row, pg_fault) state changes, counting
        entry into epoch 0 if it is already faulted. The anti-thrash
        bound: a hysteresis governor retunes at most once per
        transition in a piecewise-constant environment."""
        cd, pg, lr = self.chips_down, self.pg_fault, self.link_rates
        n = 1 if self.any_fault()[0] else 0
        for e in range(1, int(self.n_epochs)):
            if (cd[e] != cd[e - 1] or pg[e] != pg[e - 1]
                    or (lr[e] != lr[e - 1]).any()):
                n += 1
        return n

    def repair_epochs(self) -> list[int]:
        """Epochs where the fleet returns to fully clean after at least
        one faulted epoch — the recovery-time measurement anchors."""
        af = self.any_fault()
        return [e for e in range(1, int(self.n_epochs))
                if af[e - 1] and not af[e]]


def _check_seed(seed) -> tuple:
    """Timeline seeds are ints or int tuples — the spawnable key form
    ``np.random.default_rng`` hashes via SeedSequence. A Generator is
    rejected by name: child streams must be derived per (chip, link)
    from the key, not split off one shared stream (that would break
    the independent-streams contract)."""
    if isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        return (int(seed),)
    if isinstance(seed, tuple) and seed and all(
            isinstance(s, (int, np.integer)) and not isinstance(s, bool)
            for s in seed):
        return tuple(int(s) for s in seed)
    raise ValueError(
        f"seed must be an int or a non-empty tuple of ints (a "
        f"np.random.Generator is not accepted here: per-(chip, link) "
        f"child streams are keyed off the seed), got {seed!r}")


# stream-plane tags: (seed, plane, index) keys one child Generator per
# entity, so chip i's draws never depend on how many links exist and
# link j's draws never depend on any other link's spec or state
_PLANE_CHIP, _PLANE_LINK, _PLANE_FUZZ = 0, 1, 3


def build_fault_timeline(spec: FaultSpec, *, n_epochs: int,
                         n_chips: int, n_links: int = 0,
                         seed=0) -> FaultTimeline:
    """Realize a ``FaultSpec`` into a seeded ``FaultTimeline``.

    Draw contract (the ``perturb.py`` discipline): chip ``i`` draws
    exactly ``2*n_epochs`` uniforms from ``default_rng((*seed, 0, i))``
    (failure draw + pg-corruption draw per epoch) and link ``j`` draws
    exactly ``3*n_epochs`` from ``default_rng((*seed, 1, j))`` (down /
    degrade / flap per epoch), ALWAYS — whether or not the entity is
    mid-event and regardless of any spec parameter. Durations and
    drains are deterministic. Hence: same seed => bit-identical
    timeline, and each entity's trace is invariant to every other
    entity and to ``n_chips``/``n_links`` growth.
    """
    if not isinstance(spec, FaultSpec):
        raise ValueError(f"spec must be a FaultSpec, got {type(spec)}")
    _check_epochs("n_epochs", n_epochs)
    _check(isinstance(n_chips, (int, np.integer)) and n_chips >= 1,
           f"n_chips must be >= 1, got {n_chips!r}")
    _check(isinstance(n_links, (int, np.integer)) and n_links >= 0,
           f"n_links must be >= 0, got {n_links!r}")
    key = _check_seed(seed)
    e_n, c_n, l_n = int(n_epochs), int(n_chips), int(n_links)
    cs, ls = spec.chip, spec.link

    # chip plane — bulk-draw each chip's full uniform budget up front
    # (fixed call sequence), then scan the fail/repair state over epochs
    u_fail = np.empty((c_n, e_n))
    u_pg = np.empty((c_n, e_n))
    for i in range(c_n):
        rng = np.random.default_rng((*key, _PLANE_CHIP, i))
        u_fail[i] = rng.random(e_n)
        u_pg[i] = rng.random(e_n)
    p_fail = 0.0 if math.isinf(cs.mtbf_epochs) \
        else min(1.0, 1.0 / cs.mtbf_epochs)
    rem = np.zeros(c_n, np.int64)          # epochs of repair remaining
    pg_live = np.zeros(c_n, np.bool_)      # pg logic corrupted while down
    n_drain = int(round(cs.drain_frac * c_n))
    chips_down = np.zeros(e_n, np.int64)
    pg_fault = np.zeros(e_n, np.bool_)
    for e in range(e_n):
        fails = (rem == 0) & (u_fail[:, e] < p_fail)
        rem[fails] = int(cs.repair_epochs)
        pg_live[fails] = u_pg[fails, e] < cs.pg_fault_prob
        draining = (cs.drain_every > 0 and n_drain > 0 and e > 0
                    and (e % cs.drain_every) < cs.drain_epochs)
        down = int((rem > 0).sum()) + (n_drain if draining else 0)
        chips_down[e] = min(down, c_n)
        pg_fault[e] = bool((pg_live & (rem > 0)).any())
        rem = np.maximum(rem - 1, 0)

    # link plane — same shape: 3 bulk draws per link, then a state scan
    u_down = np.empty((l_n, e_n))
    u_deg = np.empty((l_n, e_n))
    u_flap = np.empty((l_n, e_n))
    for j in range(l_n):
        rng = np.random.default_rng((*key, _PLANE_LINK, j))
        u_down[j] = rng.random(e_n)
        u_deg[j] = rng.random(e_n)
        u_flap[j] = rng.random(e_n)
    link_rates = np.ones((e_n, l_n))
    if l_n:
        l_rem = np.zeros(l_n, np.int64)
        l_rate = np.ones(l_n)
        for e in range(e_n):
            free = l_rem == 0
            dn = free & (u_down[:, e] < ls.down_prob)
            dg = free & ~dn & (u_deg[:, e] < ls.degrade_prob)
            fl = free & ~dn & ~dg & (u_flap[:, e] < ls.flap_prob)
            l_rem[dn], l_rate[dn] = int(ls.down_epochs), 0.0
            l_rem[dg], l_rate[dg] = (int(ls.degrade_epochs),
                                     float(ls.degrade_rate))
            l_rem[fl], l_rate[fl] = int(ls.flap_epochs), 0.0
            link_rates[e] = np.where(l_rem > 0, l_rate, 1.0)
            l_rem = np.maximum(l_rem - 1, 0)

    hint = np.array([
        fault_severity(chips_down[e] / c_n, link_rates[e],
                       pg_fault=bool(pg_fault[e]))
        for e in range(e_n)])
    return FaultTimeline(e_n, c_n, l_n, chips_down=chips_down,
                         link_rates=link_rates, pg_fault=pg_fault,
                         severity_hint=hint)


def chaos_fuzz(n_programs: int = 50, seed: int = 0, *,
               n_events: int = 40, npu: str = "NPU-D") -> dict:
    """Faults-seeded differential ISA fuzz.

    Same exact-agreement harness as ``perturb.differential_fuzz``
    (``EventTimeline`` vs ``VLIWTimeline``, hardware auto-gating off
    and on) but the corpus is steered by a fault timeline: program
    ``p`` runs on its own child stream ``(seed, 3, p)`` with its event
    count inflated by epoch ``p``'s ``severity_hint`` — faultier
    epochs fuzz with denser pathological programs, biasing the corpus
    toward the irregular idle structure faulted schedules produce.
    Raises ``AssertionError`` on any divergence; returns corpus stats.
    """
    from repro_torch.core import perturb as pt
    if not (isinstance(n_programs, (int, np.integer)) and n_programs >= 1):
        raise ValueError(f"n_programs must be >= 1, got {n_programs!r}")
    key = _check_seed(seed)
    tl = build_fault_timeline(
        fault_plan(2.0), n_epochs=int(n_programs), n_chips=64,
        n_links=16, seed=(*key, _PLANE_FUZZ))
    stats = {"programs": 0, "runs": 0, "events": 0, "cycles": 0,
             "faulted_programs": int(tl.any_fault().sum()),
             "mismatches": 0, "seed": seed}
    for p in range(int(n_programs)):
        rng = np.random.default_rng((*key, _PLANE_FUZZ, p))
        n_ev = int(round(n_events * (1.0 + tl.severity_hint[p])))
        events, horizon = pt.adversarial_events(rng, n_events=n_ev,
                                                npu=npu)
        stats["programs"] += 1
        stats["events"] += len(events)
        for hw_auto in (False, True):
            kw = dict(pt.FUZZ_KW, hw_auto_gating=hw_auto,
                      initial_modes=dict(pt.FUZZ_KW["initial_modes"]))
            ref = pt.VLIWTimeline(npu=npu, **kw).run(
                pt.expand_events(events, horizon))
            got = pt.EventTimeline(npu=npu, **kw).run(events,
                                                      horizon=horizon)
            diff = pt._exec_mismatch(ref, got)
            if diff is not None:
                stats["mismatches"] += 1
                raise AssertionError(
                    f"executor divergence: seed={seed} program={p} "
                    f"hw_auto={hw_auto}: {diff}")
            stats["runs"] += 1
            stats["cycles"] += ref.cycles
    return stats


def main(argv=None) -> int:
    """CLI smoke entry: ``python -m repro_torch.core.faults --fuzz N``."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fuzz", type=int, default=40,
                    help="number of fault-seeded adversarial programs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", type=int, default=40,
                    help="base events per program (scaled by fault "
                         "severity)")
    args = ap.parse_args(argv)
    stats = chaos_fuzz(args.fuzz, args.seed, n_events=args.events)
    print(f"chaos fuzz ok: {stats['programs']} programs "
          f"({stats['faulted_programs']} fault-steered), "
          f"{stats['runs']} runs, {stats['events']} events, "
          f"{stats['cycles']} ref cycles, 0 mismatches "
          f"(seed={stats['seed']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
