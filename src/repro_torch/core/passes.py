"""Compiler passes for software-managed power gating (paper §4.3).

Runs after instruction scheduling and SRAM allocation:

* ``analyze_vu_idleness``  — distances (cycles) between consecutive
  instructions in each VU slot; a DMA between two VU instructions makes the
  distance effectively infinite (HBM latency >> VU BET).
* ``analyze_sram_lifetimes`` — per-4KB-segment idle intervals from buffer
  (start, end, addr, size) lifetimes out of the allocator.
* ``instrument_setpm`` — BET-based policy: gate an interval iff it is
  longer than BET *and* longer than 2x the on/off delay; insert
  ``setpm off`` at interval start and ``setpm on`` ``delay`` cycles before
  the next use so the wake-up is hidden.

Both passes are linear in program length (paper §4.4).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.hw import NPUSpec, SRAM_SEGMENT_BYTES, get_npu
from repro_torch.core.isa import Instr, PMode, scaled_delay, setpm, unit_index

INF = float("inf")


@dataclass(frozen=True)
class SlotUse:
    """One scheduled use of a functional-unit slot."""
    cycle: int
    unit: str          # e.g. "vu0"
    opcode: str = "op"
    duration: int = 1


@dataclass(frozen=True)
class IdleInterval:
    unit: str
    start: int         # first idle cycle
    end: float         # first busy cycle again (inf = never)
    # a DMA issues inside the interval: the HBM round-trip dominates, so
    # the gate decision treats the length as unbounded even though the
    # wake still has to land before ``end`` (paper §4.3)
    unbounded: bool = False

    @property
    def length(self) -> float:
        return self.end - self.start


def analyze_vu_idleness(uses: list[SlotUse],
                        dma_cycles: Optional[list[int]] = None,
                        horizon: Optional[int] = None,
                        include_leading: bool = False) \
        -> dict[str, list[IdleInterval]]:
    """Idle intervals per VU slot. ``dma_cycles``: cycles at which a DMA
    issues — an interval containing one is marked ``unbounded`` (the DMA
    latency dominates the gate decision). ``include_leading`` also emits
    the [0, first_use) interval, which the workload-scale lowering needs
    to mirror the policy engine's merged-gap accounting."""
    dma_cycles = sorted(dma_cycles or [])
    by_unit: dict[str, list[SlotUse]] = {}
    for u in sorted(uses, key=lambda s: s.cycle):
        by_unit.setdefault(u.unit, []).append(u)
    out: dict[str, list[IdleInterval]] = {}
    for unit, us in by_unit.items():
        ivs = []
        if include_leading and us and us[0].cycle > 0:
            ivs.append(IdleInterval(unit, 0, us[0].cycle))
        for a, b in zip(us, us[1:]):
            start = a.cycle + a.duration
            end: float = b.cycle
            if end <= start:
                continue
            unbounded = any(start <= d < end for d in dma_cycles)
            ivs.append(IdleInterval(unit, start, end, unbounded=unbounded))
        if horizon is not None and us:
            tail = us[-1].cycle + us[-1].duration
            if horizon > tail:
                ivs.append(IdleInterval(unit, tail, horizon))
        out[unit] = ivs
    return out


@dataclass(frozen=True)
class BufferLifetime:
    """Output of the SRAM allocation pass for one buffer."""
    start_cycle: int
    end_cycle: int
    addr: int
    size: int


def analyze_sram_lifetimes(bufs: list[BufferLifetime], sram_bytes: int,
                           horizon: int) -> list[tuple[int, list]]:
    """Per-segment busy intervals -> [(segment_index, [(start, end), ...])].
    Segments with no buffer at all have an empty list (always idle)."""
    n_seg = sram_bytes // SRAM_SEGMENT_BYTES
    seg_busy: list[list[tuple[int, int]]] = [[] for _ in range(n_seg)]
    for b in bufs:
        s0 = b.addr // SRAM_SEGMENT_BYTES
        s1 = (b.addr + b.size - 1) // SRAM_SEGMENT_BYTES
        for s in range(s0, min(s1 + 1, n_seg)):
            seg_busy[s].append((b.start_cycle, b.end_cycle))
    out = []
    for s in range(n_seg):
        ivs = sorted(seg_busy[s])
        merged: list[tuple[int, int]] = []
        for st, en in ivs:
            if merged and st <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], en))
            else:
                merged.append((st, en))
        out.append((s, merged))
    return out


@dataclass(frozen=True)
class SetpmPlacement:
    cycle: int
    instr: Instr
    reason: str


def should_gate(interval_len, bet: int, delay: int):
    """Paper §4.3: gate iff idle > BET AND idle > 2x on/off delay.

    Accepts a scalar (returns bool) or a numpy array of interval
    lengths (returns a bool mask) — the one definition of the rule for
    both the per-interval passes and the vectorized segment-band path.
    """
    return (interval_len > bet) & (interval_len > 2 * delay)


def instrument_setpm(vu_idle: dict[str, list[IdleInterval]],
                     npu: NPUSpec | str = "NPU-D", fu_type: str = "vu",
                     bet_key: Optional[str] = None,
                     delay_key: Optional[str] = None,
                     delay_scale: float = 1.0) -> list[SetpmPlacement]:
    """BET-based setpm insertion for one FU family (default VU). Adjacent
    slots gated by the same interval share one setpm via the fu bitmap
    (paper: one misc slot per cycle, bitmap amortizes). ``bet_key`` /
    ``delay_key`` override the Table-3 row (default: the fu type);
    ``delay_scale`` applies the §6.5 knob — BETs scale with the delays
    (the closed-form engine's convention) and the pre-wake placement
    uses the integer delay the scaled executor wakes with
    (``isa.scaled_delay``), so the hidden-wake alignment is preserved
    at every scale."""
    npu = get_npu(npu) if isinstance(npu, str) else npu
    bet = npu.gating.bet[bet_key or fu_type] * delay_scale
    delay = scaled_delay(npu.gating, delay_key or fu_type, delay_scale)
    # group intervals by (start, end) so one bitmap covers multiple units
    groups: dict[tuple, int] = {}
    for unit, ivs in vu_idle.items():
        idx = unit_index(unit)
        for iv in ivs:
            profitable = should_gate(iv.length, bet, delay)
            # a DMA-unbounded interval still needs room for the wake to
            # land strictly after the gate — below that, gating would
            # invert the off/on sequence and expose the full delay
            if profitable or (iv.unbounded and iv.length > delay):
                key = (iv.start, iv.end, profitable)
                groups[key] = groups.get(key, 0) | (1 << idx)
    out = []
    for (start, end, profitable), bitmap in sorted(groups.items()):
        reason = (f"idle {end - start:.0f} > bet {bet:g}" if profitable
                  else "dma-unbounded idle")
        out.append(SetpmPlacement(
            int(start), setpm(fu_type, bitmap, PMode.OFF), reason))
        if end != INF:
            wake_at = int(end) - delay
            out.append(SetpmPlacement(
                wake_at, setpm(fu_type, bitmap, PMode.ON),
                "pre-wake (hidden delay)"))
    return out


def sram_setpm_plan(seg_intervals: list[tuple[int, list]], horizon: int,
                    npu: NPUSpec | str = "NPU-D") -> list[SetpmPlacement]:
    """Whole-range OFF setpm for segments never used plus gap gating for
    segments with long dead intervals. Contiguous segment ranges collapse
    into single range-setpm instructions (paper Fig 14 variant 1)."""
    npu = get_npu(npu) if isinstance(npu, str) else npu
    bet = npu.gating.bet["sram_off"]
    delay = npu.gating.on_off_delay["sram_off"]
    dead: list[int] = [s for s, ivs in seg_intervals if not ivs]
    out: list[SetpmPlacement] = []
    # collapse contiguous dead segments into ranges
    i = 0
    while i < len(dead):
        j = i
        while j + 1 < len(dead) and dead[j + 1] == dead[j] + 1:
            j += 1
        lo = dead[i] * SRAM_SEGMENT_BYTES
        hi = (dead[j] + 1) * SRAM_SEGMENT_BYTES
        out.append(SetpmPlacement(
            0, setpm("sram", 0, PMode.OFF, (lo, hi)), "never used"))
        i = j + 1
    # per-segment gaps
    for s, ivs in seg_intervals:
        if not ivs:
            continue
        for (a_s, a_e), (b_s, _) in zip(ivs, ivs[1:]):
            if should_gate(b_s - a_e, bet, delay):
                rng = (s * SRAM_SEGMENT_BYTES, (s + 1) * SRAM_SEGMENT_BYTES)
                out.append(SetpmPlacement(
                    a_e, setpm("sram", 0, PMode.OFF, rng), "dead interval"))
                out.append(SetpmPlacement(
                    b_s - delay, setpm("sram", 0, PMode.ON, rng), "pre-wake"))
        tail = ivs[-1][1]
        if should_gate(horizon - tail, bet, delay):
            rng = (s * SRAM_SEGMENT_BYTES, (s + 1) * SRAM_SEGMENT_BYTES)
            out.append(SetpmPlacement(
                tail, setpm("sram", 0, PMode.OFF, rng), "tail dead"))
    return out
