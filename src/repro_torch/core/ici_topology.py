"""Topology-level ICI traffic model (jitter plane).

The workload generators emit each collective as ONE op carrying its total
per-chip wire bytes — a smooth, coarse idle-interval structure that
flatters idle-detection gating. Real collectives run as step schedules
over a chip topology: an all-reduce on an N-chip ring is 2(N-1)
send/receive steps, a 2-D mesh runs a ring phase per axis. This module
lowers collective ops onto such schedules so the ICI busy/idle timeline
seen by the policy engine has the step-level granularity the perturbation
engine (``repro_torch.core.perturb``) then distorts.

Topology shapes follow the production mesh convention: small
jobs run a single ring over ``n_chips``; larger jobs a near-square 2-D
mesh (the production ``(16, 16)`` "data" x "model" shape, factored down
to the job size). Everything stays on the ``opgen`` trace plane: the
lowered workload compiles through ``compile_trace`` / ``stack_traces``
and rides the batched sweep kernels unchanged.

Each schedule step is a wire transfer followed by its local staging
work — the HBM read/write of the chunk and (for reduce steps) the VU
add — so the ICI sits genuinely idle between transfers and the lowered
timeline has the step-granular busy/idle alternation the detection
model gates on. Total wire bytes are conserved exactly (NoPG ICI
dynamic energy is invariant); the staging traffic is *added* — the
algorithmic overhead a single fused collective op idealizes away.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.hw import NPUSpec, get_npu
from repro_torch.core.opgen import (Op, Workload, compile_trace, segmented_gaps)


@dataclass(frozen=True)
class Topology:
    """A chip interconnect shape: ``("ring", (N,))`` or
    ``("mesh2d", (rows, cols))`` (torus links along each axis)."""

    kind: str                      # "ring" | "mesh2d"
    shape: tuple[int, ...]

    def __post_init__(self):
        if self.kind not in ("ring", "mesh2d"):
            raise ValueError(f"unknown topology kind {self.kind!r}")
        want = 1 if self.kind == "ring" else 2
        if len(self.shape) != want or any(s < 1 for s in self.shape):
            raise ValueError(
                f"{self.kind} topology needs {want} positive dims, "
                f"got {self.shape}")

    @property
    def n_chips(self) -> int:
        return math.prod(self.shape)


def topology_for(n_chips: int, kind: Optional[str] = None) -> Topology:
    """Default topology for an ``n_chips`` job.

    Follows the production mesh conventions: up to 8 chips is a single
    ring (one ICI ring per pod slice); beyond that, the most-square 2-D
    factorization — 256 chips gives the production ``(16, 16)`` mesh.
    """
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    if kind is None:
        kind = "ring" if n_chips <= 8 else "mesh2d"
    if kind == "ring":
        return Topology("ring", (n_chips,))
    r = 1
    for cand in range(math.isqrt(n_chips), 0, -1):
        if n_chips % cand == 0:
            r = cand
            break
    return Topology("mesh2d", (r, n_chips // r))


def n_links(topo: Topology) -> int:
    """Number of directed ICI links in a topology's fault plane.

    Ring of ``n`` chips: ``n`` wrap-around links (chip ``i`` → ``i+1``),
    none when ``n == 1``. 2-D mesh ``(r, c)``: a torus ring per column
    along axis 0 (``r`` links each, ``c`` rings) and per row along
    axis 1 — degenerate axes (size 1) contribute none. The link index
    order is the contract ``collective_schedule`` link-event traces are
    written in: axis-0 rings first (ring-major: ``col*r + pos``), then
    axis-1 (``row*c + pos``).
    """
    if topo.kind == "ring":
        n = topo.shape[0]
        return n if n > 1 else 0
    r, c = topo.shape
    return (r * c if r > 1 else 0) + (r * c if c > 1 else 0)


def _axis_rings(topo: Topology) -> list[list[np.ndarray]]:
    """Per schedule axis, the list of link-index arrays of its parallel
    rings (the ``n_links`` layout). Degenerate axes get no rings."""
    if topo.kind == "ring":
        n = topo.shape[0]
        return [[np.arange(n)] if n > 1 else []]
    r, c = topo.shape
    base = r * c if r > 1 else 0
    ax0 = [j * r + np.arange(r) for j in range(c)] if r > 1 else []
    ax1 = [base + i * c + np.arange(c) for i in range(r)] if c > 1 \
        else []
    return [ax0, ax1]


def _ring_pacing(rates: np.ndarray) -> float:
    """Wire-time stretch of one ring step under per-link rates.

    Every chip forwards its chunk one hop per step, so the step is
    paced by the slowest transfer. A healthy link at ``rate`` takes
    ``1/rate`` of nominal; a down link (rate 0) forces its chunk the
    long way around — store-and-forward over every surviving link of
    the ring (the ring-detour reroute), which is only possible while
    the ring has a single cut. Two simultaneous down links partition
    the ring; no schedule exists, so that raises.
    """
    down = rates <= 0.0
    nd = int(down.sum())
    if nd == 0:
        return float(1.0 / rates.min())
    if nd >= 2:
        raise ValueError(
            f"ring partitioned: {nd} links down simultaneously (a ring "
            f"detour survives one cut; resolve the trace with "
            f"resolve_link_rates first)")
    return float((1.0 / rates[~down]).sum())


def resolve_link_rates(link_rates: np.ndarray, topo: Topology, *,
                       floor: float = 0.05) -> np.ndarray:
    """Make a link-event trace schedulable: within each ring, keep only
    the first (lowest-index) down link down and lift any further down
    links to ``floor`` — LinkGuardian-style, the retransmission/FEC
    path catches the later faults at a crawl before they hard-down, so
    the ring keeps a single cut and the detour reroute stays valid.
    Accepts ``(L,)`` or ``(S, L)`` traces; returns a float64 copy.
    """
    if not (0.0 < floor <= 1.0):
        raise ValueError(f"floor must be in (0, 1], got {floor}")
    r = np.array(link_rates, np.float64, copy=True)
    flat = r.reshape(1, -1) if r.ndim == 1 else r
    for rings in _axis_rings(topo):
        for ring in rings:
            sub = flat[:, ring]
            down = sub <= 0.0
            extra = down & (np.cumsum(down, axis=1) > 1)
            sub[extra] = floor
            flat[:, ring] = sub
    return r


def schedule_kind(op_name: str) -> str:
    """Collective algorithm implied by an op's name (the workload
    generators' naming convention: ``ar_*``/``*_allreduce`` ring
    all-reduce, ``*alltoall``/``*a2a`` all-to-all, ``ag_*``/
    ``*allgather`` all-gather)."""
    n = op_name.lower()
    if "alltoall" in n or "a2a" in n:
        return "all_to_all"
    if "allgather" in n or n.startswith("ag_") or "_ag" in n:
        return "all_gather"
    return "all_reduce"


def _phase_steps(kind: str, n: int) -> int:
    """Ring steps for one phase over ``n`` participants."""
    if n <= 1:
        return 0
    if kind == "all_reduce":
        return 2 * (n - 1)          # reduce-scatter + all-gather
    return n - 1                    # all-gather / all-to-all


def collective_schedule(kind: str, topo: Topology,
                        link_rates: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """Per-step fractions of a collective op's total per-chip wire bytes.

    Ring: equal steps (``2(N-1)`` for all-reduce, ``N-1`` otherwise).
    2-D mesh: a ring phase along each axis; each axis-``n`` step carries
    ``1/n`` of the buffer, so phase weights are proportional to
    ``steps/n`` and the fractions are normalized to sum to exactly 1.
    Degenerate axes (size 1) contribute no steps; a 1-chip topology has
    no schedule (empty array).

    ``link_rates`` injects a measured link-event trace (LinkGuardian
    style): shape ``(n_links(topo),)`` — or ``(S, n_links)`` for a
    per-step trace — with rate 1 for a healthy link, a value in (0, 1)
    for a degraded one, and 0 for a down link. Each step's weight is
    stretched by the worst ``_ring_pacing`` over that axis's parallel
    rings (slowest transfer paces the step; down links detour the long
    way around the ring), and the result is normalized by the *clean*
    weight sum — an all-ones trace reproduces the clean fractions
    exactly, and fractions under faults sum to >1, the wire-time
    inflation the timeline inherits. Two down links in one ring
    partition it: ``ValueError`` (pre-clean the trace with
    ``resolve_link_rates`` when that must not happen).
    """
    if kind not in ("all_reduce", "all_gather", "all_to_all"):
        raise ValueError(f"unknown collective kind {kind!r}")
    axes = topo.shape if topo.kind == "mesh2d" else (topo.n_chips,)
    weights: list[float] = []
    step_axis: list[int] = []
    for ai, n in enumerate(axes):
        k = _phase_steps(kind, n)
        weights.extend([1.0 / n] * k)
        step_axis.extend([ai] * k)
    w = np.asarray(weights, np.float64)
    if w.size == 0 or link_rates is None:
        return w / w.sum() if w.size else w
    rates = np.asarray(link_rates, np.float64)
    nl = n_links(topo)
    if rates.ndim == 1:
        rates = np.broadcast_to(rates, (w.size, rates.shape[0]))
    if rates.ndim != 2 or rates.shape != (w.size, nl):
        raise ValueError(
            f"link_rates must have shape ({nl},) or ({w.size}, {nl}) "
            f"for {topo.kind}{topo.shape} {kind}, got "
            f"{np.asarray(link_rates).shape}")
    if not np.isfinite(rates).all() or (rates < 0).any() \
            or (rates > 1).any():
        raise ValueError("link_rates must be finite and in [0, 1]")
    rings = _axis_rings(topo)
    clean_sum = w.sum()
    out = w.copy()
    for s in range(w.size):
        pace = max(_ring_pacing(rates[s][ring])
                   for ring in rings[step_axis[s]])
        out[s] *= pace
    return out / clean_sum


def lower_collectives(wl: Workload, topo: Optional[Topology] = None, *,
                      staging: bool = True,
                      link_rates: Optional[np.ndarray] = None
                      ) -> Workload:
    """Expand each collective op into its topology step schedule.

    Pure trace -> trace: returns a NEW ``Workload`` (name suffixed
    ``+topo``) whose collective ops are replaced by per-step pairs —
    the wire transfer (``name/s<j>``, ``bytes_ici`` split by
    ``collective_schedule``) and its local staging op (``name/c<j>``:
    HBM read+write of the chunk, plus the VU reduction add on
    all-reduce steps) during which the ICI idles. Non-collective ops
    pass through untouched. Per-chip wire bytes are conserved exactly
    per op; ``staging=False`` drops the staging ops (pure byte split,
    timeline-equivalent to the fused op). Workloads on one chip (or a
    degenerate topology) are returned re-wrapped but otherwise
    unchanged.

    ``link_rates`` (a ``collective_schedule`` link-event trace) makes
    the step split non-uniform and inflates total wire time by the
    fault pacing; the lowered name gains a ``!`` so faulted variants
    never alias clean ones in identity caches or reports.
    """
    if topo is None:
        topo = topology_for(max(1, wl.n_chips))
    out: list[Op] = []
    for op in wl.ops:
        kind = schedule_kind(op.name)
        frac = (collective_schedule(kind, topo, link_rates)
                if op.collective and op.bytes_ici > 0 else np.zeros(0))
        if frac.size <= 1:
            out.append(op)
            continue
        for j, f in enumerate(frac):
            step = op.bytes_ici * float(f)
            out.append(replace(op, name=f"{op.name}/s{j}",
                               bytes_ici=step))
            if staging:
                out.append(replace(
                    op, name=f"{op.name}/c{j}", bytes_ici=0.0,
                    collective=False, bytes_hbm=2.0 * step,
                    flops_vu=(0.5 * step
                              if kind == "all_reduce" else 0.0)))
    suffix = "+topo" if link_rates is None else "+topo!"
    return Workload(f"{wl.name}{suffix}", wl.kind, tuple(out),
                    n_chips=wl.n_chips,
                    note=f"{wl.note} [{topo.kind}{topo.shape}]".strip())


def ici_busy_idle(wl: Workload, npu: NPUSpec | str = "NPU-D") -> dict:
    """Per-op ICI busy/idle timeline of a workload on one NPU.

    Uses the compiled ``TraceArrays`` service times (the exact arrays the
    policy engine sweeps over): returns ``{"busy_s", "dur_s", "idle_s",
    "gaps_s"}`` where ``busy_s``/``dur_s`` are per-op (count-folded) ICI
    busy time and op duration, ``idle_s`` the per-op ICI idle time, and
    ``gaps_s`` the merged idle-gap lengths (one per ICI-active op plus a
    trailing gap) — the intervals the idle-detection model gates on.
    """
    from repro_torch.core.policies import trace_times
    npu = get_npu(npu) if isinstance(npu, str) else npu
    tr = compile_trace(wl)
    tt = trace_times(tr, npu)
    busy = tt["ici"] * tr.count
    dur = tt["dur"] * tr.count
    idle = np.where(tt["ici"] > 0, 0.0, dur)
    offsets = np.array([0, tr.n_ops], np.int64)
    gaps, _ = segmented_gaps(tt["ici"] > 0, idle, offsets)
    return {"busy_s": busy, "dur_s": dur, "idle_s": idle, "gaps_s": gaps}
