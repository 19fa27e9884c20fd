"""NPU power-management ISA extension + VLIW timeline executors (paper §4.2).

``setpm`` (set power mode) — paper Fig 14:
  * variant 1 (SRAM): ``setpm %start, %end, sram, <mode>`` — gates a
    contiguous address range, per 4 KB segment;
  * variants 2/3 (FUs): ``setpm <fu_bitmap>, <sa|vu|hbm|ici>, <mode>`` —
    the bitmap (register or immediate) selects multiple units at once so a
    single misc-slot instruction reconfigures several FUs in one cycle.

Two executors share one machine model (per-FU power state, the
"power-gated component is a structural hazard" rule, per-cycle static
accounting):

* ``VLIWTimeline`` — the cycle-stepper reference: one bundle per cycle,
  O(cycles). Reproduces the paper's Fig 15 example and anchors the
  property tests.
* ``EventTimeline`` — the event-driven (interval-based) executor for
  workload-scale programs: the program is a SPARSE list of
  ``(cycle, bundle)`` events; gaps between events are closed-form
  (idle-detection crossings computed analytically per FU), so cost is
  O(events), not O(cycles). It equals the cycle-stepper exactly on the
  microbenchmarks and on sampled workload-scale programs (see
  ``expand_events``; ``tests/test_torch_isa_passes.py``).

Workload-scale programs come out of ``repro_torch.core.lowering``; energy at
that scale cross-validates against the closed-form engine in
``repro_torch.core.policies``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.hw import NPUSpec, get_npu


class PMode(enum.Enum):
    AUTO = "auto"
    ON = "on"
    OFF = "off"
    SLEEP = "sleep"  # SRAM only


@dataclass(frozen=True)
class Instr:
    """One VLIW slot operation."""
    opcode: str               # push | pop | vadd | vmul | dma | sync | setpm
    unit: str                 # "sa0".."vu3" | "dma0" | "ici0" | "misc"
    latency: int = 1
    # setpm fields (paper Fig 14)
    pm_fu_type: Optional[str] = None    # sa | vu | sram | hbm | ici
    pm_bitmap: int = 0                  # which FU instances
    pm_mode: Optional[PMode] = None
    pm_range: Optional[tuple[int, int]] = None  # sram [start, end) bytes


def setpm(fu_type: str, bitmap: int, mode: PMode,
          sram_range: Optional[tuple[int, int]] = None) -> Instr:
    return Instr("setpm", "misc", 1, pm_fu_type=fu_type, pm_bitmap=bitmap,
                 pm_mode=mode, pm_range=sram_range)


def unit_index(name: str) -> int:
    """Bitmap index of a FU instance: its trailing digits ("vu2" -> 2,
    "dma0"/"dma" -> 0)."""
    i = len(name)
    while i > 0 and name[i - 1].isdigit():
        i -= 1
    return int(name[i:]) if i < len(name) else 0


@dataclass
class FUState:
    kind: str            # sa | vu | hbm | ici
    powered: bool = True
    mode: PMode = PMode.AUTO
    ready_at: int = 0    # cycle when wake-up completes
    busy_until: int = 0
    idle_since: int = 0
    on_cycles: int = 0
    gated_cycles: int = 0
    wake_events: int = 0


@dataclass
class ExecResult:
    cycles: int
    fu_on_cycles: dict[str, int]
    fu_gated_cycles: dict[str, int]
    stall_cycles: int
    setpm_executed: int
    wake_events: dict[str, int]

    def static_energy_units(self, leak_off: float = 0.03) -> float:
        """Static energy in (power-unit x cycles), one unit per FU."""
        e = 0.0
        for k in self.fu_on_cycles:
            e += self.fu_on_cycles[k] + leak_off * self.fu_gated_cycles[k]
        return e


# gating-parameter table keys per FU kind (paper Table 3)
DELAY_KEYS = {"sa": "sa_full", "vu": "vu", "hbm": "hbm", "ici": "ici"}


def scaled_delay(g, key: str, delay_scale: float = 1.0) -> int:
    """Integer wake delay under the §6.5 ``delay_scale`` knob.

    The single rounding rule shared by the executors and the batched
    program-plane kernel (``repro_torch.core.program_plane``): both sides must
    land on the SAME integer or machine times diverge. ``scale=1.0``
    reproduces the raw Table 3 value exactly."""
    return int(round(g.on_off_delay[key] * delay_scale))


def scaled_window(g, key: str, delay_scale: float = 1.0,
                  window_scale: float = 1.0) -> int:
    """Integer idle-detection window under the delay/window knobs.

    ``delay_scale`` rides through the BET (the closed-form engine's
    convention: window = BET x detection_window_frac, and the knob
    scales BETs with the delays); ``window_scale`` scales only the
    window. The 8-cycle floor and the int truncation reproduce the
    unscaled executor formula bit-for-bit at scales of 1.0."""
    return max(8, int(g.bet[key] * delay_scale
                      * g.detection_window_frac * window_scale))


class VLIWTimeline:
    """Cycle-stepper reference executor. Each cycle may issue one bundle
    (a dict unit->Instr, plus at most one misc-slot setpm)."""

    def __init__(self, npu: NPUSpec | str = "NPU-D", n_sa: int = 2,
                 n_vu: int = 2, hw_auto_gating: bool = True,
                 extra_units: Optional[dict[str, str]] = None,
                 delay_keys: Optional[dict[str, str]] = None,
                 initial_modes: Optional[dict[str, PMode]] = None,
                 delay_scale: float = 1.0, window_scale: float = 1.0):
        """``extra_units``: name -> kind for units beyond the SA/VU files
        (e.g. {"dma0": "hbm", "ici0": "ici"}). ``delay_keys`` overrides
        the kind -> gating-table key map (e.g. sa -> "sa_pe" when the
        SA gates at PE granularity). ``initial_modes``: per-unit initial
        power mode — software-managed units start in ON (hardware
        idle-detection disabled; setpm drives them). ``delay_scale`` /
        ``window_scale`` apply the §6.5 sensitivity knobs with the
        integer rounding of ``scaled_delay`` / ``scaled_window`` (the
        program-plane kernel uses the identical integers)."""
        self.npu = get_npu(npu) if isinstance(npu, str) else npu
        self.fus: dict[str, FUState] = {}
        for i in range(n_sa):
            self.fus[f"sa{i}"] = FUState("sa")
        for i in range(n_vu):
            self.fus[f"vu{i}"] = FUState("vu")
        for name, kind in (extra_units or {}).items():
            self.fus[name] = FUState(kind)
        for name, mode in (initial_modes or {}).items():
            self.fus[name].mode = mode
        self.hw_auto = hw_auto_gating
        self.g = self.npu.gating
        self.delay_keys = dict(DELAY_KEYS)
        if delay_keys:
            self.delay_keys.update(delay_keys)
        self.delay_scale = float(delay_scale)
        self.window_scale = float(window_scale)
        self._stalls = 0
        self._n_setpm = 0

    def _delay(self, kind: str) -> int:
        return scaled_delay(self.g, self.delay_keys[kind],
                            self.delay_scale)

    def _window(self, kind: str) -> int:
        return scaled_window(self.g, self.delay_keys[kind],
                             self.delay_scale, self.window_scale)

    # ------------------------------------------------------------------
    # one-bundle machine step (shared by both executors)
    # ------------------------------------------------------------------

    def _step(self, bundle: dict[str, Instr], t: int) -> int:
        """Execute one bundle at machine time ``t``; returns the new
        machine time (t + 1 + any dispatch stall)."""
        # 1) apply setpm from the misc slot (takes effect this cycle)
        m = bundle.get("misc")
        if m is not None and m.opcode == "setpm":
            self._n_setpm += 1
            for name, fu in self.fus.items():
                if fu.kind != m.pm_fu_type:
                    continue
                if not (m.pm_bitmap >> unit_index(name)) & 1:
                    continue
                fu.mode = m.pm_mode
                if m.pm_mode == PMode.OFF:
                    fu.powered = False
                elif m.pm_mode == PMode.ON and not fu.powered:
                    fu.powered = True
                    fu.ready_at = t + self._delay(fu.kind)
                    fu.wake_events += 1

        # 2) structural hazards: wait for every referenced unit
        need = [i for u, i in bundle.items() if u != "misc"]
        start = t
        for ins in need:
            fu = self.fus.get(ins.unit)
            if fu is None:
                continue
            if not fu.powered:  # auto-wake on dispatch
                if fu.mode == PMode.OFF:
                    # sw said OFF: dispatch overrides (hazard + wake)
                    pass
                fu.powered = True
                fu.ready_at = max(t, fu.busy_until) + self._delay(fu.kind)
                fu.wake_events += 1
            start = max(start, fu.ready_at, fu.busy_until)
        self._stalls += start - t

        # 3) issue
        for ins in need:
            fu = self.fus.get(ins.unit)
            if fu is None:
                continue
            fu.busy_until = start + ins.latency
            fu.idle_since = fu.busy_until
        t = start + 1

        # 4) hardware auto idle-detection gating
        if self.hw_auto:
            for fu in self.fus.values():
                if (fu.powered and fu.mode == PMode.AUTO
                        and t - fu.idle_since >= self._window(fu.kind)
                        and fu.busy_until <= t):
                    fu.powered = False

        # 5) accounting
        for fu in self.fus.values():
            if fu.powered:
                fu.on_cycles += 1
            else:
                fu.gated_cycles += 1
        return t

    def _finish(self, t: int) -> ExecResult:
        end = max([t] + [f.busy_until for f in self.fus.values()])
        for fu in self.fus.values():  # drain accounting
            extra = end - t
            if fu.powered:
                fu.on_cycles += extra
            else:
                fu.gated_cycles += extra
        return ExecResult(
            cycles=end,
            fu_on_cycles={k: f.on_cycles for k, f in self.fus.items()},
            fu_gated_cycles={k: f.gated_cycles for k, f in self.fus.items()},
            stall_cycles=self._stalls,
            setpm_executed=self._n_setpm,
            wake_events={k: f.wake_events for k, f in self.fus.items()},
        )

    def run(self, bundles: Iterable[dict[str, Instr]]) -> ExecResult:
        self._stalls = 0
        self._n_setpm = 0
        t = 0
        for bundle in bundles:
            t = self._step(bundle, t)
        return self._finish(t)


class EventTimeline(VLIWTimeline):
    """Event-driven executor: processes only the cycles that carry an
    instruction and jumps over the empty stretches in closed form.

    The program is a sorted list of ``(cycle_index, bundle)`` events —
    semantically identical to the dense program that has ``bundle`` at
    that index and an empty bundle everywhere else (``expand_events``
    materializes exactly that program for the equality tests). Gap
    handling replicates the cycle-stepper's per-cycle semantics: a
    powered AUTO unit crosses its idle-detection window at
    ``max(idle_since + window, busy_until)`` and is accounted gated from
    that cycle on, so the two executors agree cycle-for-cycle.
    """

    def _gap(self, n: int, t: int) -> None:
        """Advance through ``n`` empty cycles starting at machine time
        ``t`` (closed form; mutates FU accounting/state)."""
        for fu in self.fus.values():
            if not fu.powered:
                fu.gated_cycles += n
            elif not (self.hw_auto and fu.mode == PMode.AUTO):
                fu.on_cycles += n
            else:
                # first empty cycle accounts at t+1, last at t+n; the FU
                # counts gated from the cycle it crosses the window
                g = max(fu.idle_since + self._window(fu.kind),
                        fu.busy_until)
                on = min(max(g - t - 1, 0), n)
                fu.on_cycles += on
                if n > on:
                    fu.gated_cycles += n - on
                    fu.powered = False

    def run(self, events: Iterable[tuple[int, dict[str, Instr]]],
            horizon: Optional[int] = None) -> ExecResult:
        self._stalls = 0
        self._n_setpm = 0
        t = 0
        prev = -1
        for idx, bundle in events:
            if idx <= prev:
                raise ValueError(
                    f"events must be strictly increasing (got {idx} "
                    f"after {prev})")
            gap = idx - prev - 1
            if gap:
                self._gap(gap, t)
                t += gap
            t = self._step(bundle, t)
            prev = idx
        if horizon is not None and horizon > prev + 1:
            tail = horizon - prev - 1
            self._gap(tail, t)
            t += tail
        return self._finish(t)


def merge_events(events: Iterable[tuple[int, dict[str, Instr]]]) \
        -> list[tuple[int, dict[str, Instr]]]:
    """Canonicalize a raw event list into a valid sparse program: sort by
    cycle and merge same-cycle events into one bundle.

    On a slot collision (two instructions for the same unit — or two
    misc-slot setpms — at the same cycle) the later entry wins, the VLIW
    rule for double-written slots. The result satisfies ``EventTimeline``'s
    strictly-increasing contract, so pathological generators (the
    ``repro_torch.core.perturb`` fuzz harness) can emit colliding raw streams
    and still produce a well-formed program.
    """
    merged: dict[int, dict[str, Instr]] = {}
    for cycle, bundle in events:
        merged.setdefault(int(cycle), {}).update(bundle)
    return sorted(merged.items())


# power-mode codes for the columnar event form (``events_to_arrays``) —
# the batched program-plane kernel consumes these
PM_NONE, PM_ON, PM_OFF, PM_AUTO = 0, 1, 2, 3
_PM_CODE = {PMode.ON: PM_ON, PMode.OFF: PM_OFF, PMode.AUTO: PM_AUTO}


def events_to_arrays(events: Iterable[tuple[int, dict[str, Instr]]],
                     units: tuple[str, ...]) -> dict[str, np.ndarray]:
    """Columnar form of a sparse event program for the batched kernel.

    ``units`` fixes the unit-axis order. Returns int64/int8 arrays:

    * ``cycle`` (E,)    — event cycle indices, strictly increasing;
    * ``lat``   (E, U)  — per-unit issue latency, 0 where the bundle
      does not reference the unit;
    * ``pm``    (E, U)  — misc-slot setpm effect on each unit
      (``PM_NONE``/``PM_ON``/``PM_OFF``/``PM_AUTO``), decoded from the
      fu-type + bitmap addressing exactly like the executors.

    SRAM range setpms have no FU-state footprint in the timeline machine
    (no unit of kind "sram" exists) and are rejected: the program plane
    accounts SRAM analytically (``lowering.sram_band_gating``).
    """
    events = list(events)
    uix = {u: i for i, u in enumerate(units)}
    kind = {u: ("hbm" if u.startswith("dma") else
                "ici" if u.startswith("ici") else u[:2]) for u in units}
    cycle = np.empty(len(events), np.int64)
    lat = np.zeros((len(events), len(units)), np.int64)
    pm = np.zeros((len(events), len(units)), np.int8)
    prev = -1
    for e, (idx, bundle) in enumerate(events):
        if idx <= prev:
            raise ValueError(
                f"events must be strictly increasing (got {idx} "
                f"after {prev})")
        prev = idx
        cycle[e] = idx
        for slot, ins in bundle.items():
            if slot == "misc":
                if ins.opcode != "setpm":
                    continue
                if ins.pm_range is not None:
                    raise ValueError(
                        "range setpm has no timeline unit; SRAM gating "
                        "is analytic (sram_band_gating)")
                code = _PM_CODE[ins.pm_mode]
                for u, i in uix.items():
                    if (kind[u] == ins.pm_fu_type
                            and (ins.pm_bitmap >> unit_index(u)) & 1):
                        pm[e, i] = code
            elif slot in uix:
                lat[e, uix[slot]] = ins.latency
    return {"cycle": cycle, "lat": lat, "pm": pm}


def expand_events(events: Iterable[tuple[int, dict[str, Instr]]],
                  horizon: Optional[int] = None) \
        -> list[dict[str, Instr]]:
    """Dense bundle list equivalent to a sparse event program (the
    reference cycle-stepper's input for the equality tests)."""
    events = list(events)
    length = max([horizon or 0] + [i + 1 for i, _ in events])
    dense: list[dict[str, Instr]] = [{} for _ in range(length)]
    for idx, bundle in events:
        dense[idx] = bundle
    return dense


def fig15_program(n_periods: int = 4, *, with_setpm: bool,
                  push_cycles: int = 8, vadd_cycles: int = 1,
                  n_sa: int = 2, n_vu: int = 2) -> list[dict[str, Instr]]:
    """The paper's Fig 15 pattern: 2 SAs push for 8 cycles each (staggered),
    VUs post-process for ~2 cycles out of every 16; the compiler setpm-gates
    the VUs in the 10-cycle holes."""
    bundles: list[dict[str, Instr]] = []
    vu_mask = (1 << n_vu) - 1
    for p in range(n_periods):
        for i in range(push_cycles):
            b: dict[str, Instr] = {
                "sa0": Instr("push", "sa0", 1),
            }
            if i == 0 and with_setpm and p > 0:
                b["misc"] = setpm("vu", vu_mask, PMode.ON)  # pre-wake
            bundles.append(b)
        for i in range(push_cycles):
            b = {"sa1": Instr("push", "sa1", 1)}
            if i < 2:  # VUs consume the SA0 outputs
                b[f"vu{i % n_vu}"] = Instr("vadd", f"vu{i % n_vu}",
                                           vadd_cycles)
            if i == 2 and with_setpm:
                b["misc"] = setpm("vu", vu_mask, PMode.OFF)
            bundles.append(b)
    return bundles
