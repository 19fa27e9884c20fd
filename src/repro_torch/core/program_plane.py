"""Batched program plane: software-managed gating on arrays.

The software-managed half of ReGate (§5.3/Fig 14: compiler-placed
``setpm`` driving the VU, plus SRAM segment bands), for every
(workload, npu, knob) cell at once:

* ``build_program_arrays`` compiles each lowered program
  (``lowering.lower_workload`` SlotUse timelines + the §4.3
  ``instrument_setpm`` placements, merged by ``lowering.build_events``)
  into a ``ProgramArrays`` stack — concatenated per-event columns
  (cycle index, per-unit issue latencies, per-unit setpm effects) with
  ``offsets``/``seg_ids`` per the ``opgen.StackedTrace`` convention.
  Instrumentation is placed once per unique ``delay_scale``: window and
  leak knob points sharing a delay scale share event streams.
* The executor runs one row per (workload, npu, unique knob triple):
  the lock-step event executor of ``repro_torch.kernels.program_exec``
  (``EventTimeline``'s closed-form gap handling plus the bundle step —
  setpm, structural hazards with auto-wake, issue, idle-detection window
  crossing — on integers, with the cross-unit stall coupling). On a CUDA
  device ``_run_streams`` hands it the ragged stack as it is (one upload
  of the unique streams, ``_upload_streams``), one launch of the
  hand-written kernel B7 for all rows, which reads each stream once for
  the rows that share it. On the CPU (``_run_dense``) ``_pack_dense``
  gathers the stack into the reference's dense ``(E, R[, U])`` layout,
  padded with ``cycle = -1`` events that change no state, and
  ``_run_kernel`` runs the kernel's plain version on it. The results
  equal the per-cell ``EventTimeline``'s exactly. The BET/window knobs
  enter as per-row integer delay/window parameters computed by the same
  ``isa.scaled_delay`` / ``isa.scaled_window`` helpers the executors use.
* ``program_plane_batch`` assembles the full cube: kernel outputs, the
  closed-form intra-op VU burst fold and the SRAM band analysis (both
  once per unique knob pair, on the host), and the closed-form
  ``ReGate-Full`` policy side via one ``evaluate_batch`` call on the same
  device. ``sweep_program_plane`` (``repro_torch.core.sweep``) is a thin
  wrapper emitting one ``lowering.plane_record`` per cell.

On a mesh with a ``"wl"`` dim (``parallel.dist.sweep_mesh``; the JAX
package's GSPMD row sharding) the executor's rows are split over that
dim: the row axis is padded to a multiple of its size with inert rows
(an empty stream, horizon 0), each rank uploads only the streams its
rows run and executes them through B7's stream entry -- one launch a
call on a card -- and the int64 outputs are all-gathered in row order,
so every rank holds every row. The mesh applies to the executor only:
the policy side's ``evaluate_batch`` resolves its own session mesh.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import session
from repro_torch.core.backend import get_backend
from repro_torch.core.hw import NPUSpec, get_npu, with_sa_width
from repro_torch.core.isa import (events_to_arrays, scaled_delay,
                                  scaled_window)
from repro_torch.core.lowering import (COMP_OF_UNIT, REGATE_FULL_TIMELINE,
                                       UNIT_OF, LoweredProgram, build_events,
                                       instrument_program, lower_workload,
                                       plane_record, sram_band_gating)
from repro_torch.core.opgen import Workload
from repro_torch.core.policies import (BatchResult, PolicyKnobs,
                                       _component_policies,
                                       _fine_grained_vu_vec, evaluate_batch,
                                       knob_pairs)
from repro_torch.kernels.program_exec import (program_exec,
                                              program_exec_streams)

# fixed kernel unit order; component order follows UNIT_OF
UNITS = tuple(u for u, _ in UNIT_OF.values())          # sa0 vu0 dma0 ici0
COMPS = tuple(COMP_OF_UNIT[u] for u in UNITS)          # sa  vu  hbm  ici
# gating-table key per unit under the ReGate-Full machine (the
# delay_keys override in REGATE_FULL_TIMELINE: SA wakes at PE grain)
_TABLE_KEY = {"sa": "sa_pe", "vu": "vu", "hbm": "hbm", "ici": "ici"}
_KEYS = tuple(_TABLE_KEY[c] for c in COMPS)
# initial power modes (mode codes: 0 AUTO, 1 ON, 2 OFF): the
# software-managed VU starts ON, everything else under hw detection
_MODE0 = tuple(1 if UNITS[i] in REGATE_FULL_TIMELINE["initial_modes"]
               else 0 for i in range(len(UNITS)))


@dataclass
class ProgramArrays:
    """Ragged columnar stack of instrumented event programs.

    Stream ``s`` owns rows ``offsets[s]:offsets[s+1]`` of the
    concatenated event columns (the ``StackedTrace`` convention);
    ``seg_ids`` is the equivalent per-event stream id."""
    units: tuple[str, ...]
    cycle: np.ndarray          # (N,)  event cycle indices, int64
    lat: np.ndarray            # (N,U) per-unit issue latency (0 unused)
    pm: np.ndarray             # (N,U) setpm effect codes (isa.PM_*)
    offsets: np.ndarray        # (S+1,)
    horizon: np.ndarray        # (S,)
    setpm_vu: np.ndarray       # (S,) §4.3 placement count (VU)

    @property
    def n_streams(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    @property
    def seg_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_streams, dtype=np.int64),
                         self.lengths)


# per-(program, delay_scale) columnar event stream, FIFO-bounded like
# the instrumentation cache (strong prog ref keeps the id valid)
_STREAM_CACHE: dict[tuple[int, float], tuple[LoweredProgram, dict]] = {}
_STREAM_CACHE_MAX = 256


def _stream_arrays(prog: LoweredProgram, dscale: float) -> dict:
    key = (id(prog), float(dscale))
    hit = _STREAM_CACHE.get(key)
    if hit is not None and hit[0] is prog:
        return hit[1]
    placements = instrument_program(prog, delay_scale=dscale)
    events = build_events(prog, placements)
    arr = events_to_arrays(events, UNITS)
    arr["horizon"] = int(prog.horizon)
    arr["setpm_vu"] = float(len(placements))
    if len(_STREAM_CACHE) >= _STREAM_CACHE_MAX:
        _STREAM_CACHE.pop(next(iter(_STREAM_CACHE)))
    _STREAM_CACHE[key] = (prog, arr)
    return arr


def build_program_arrays(progs: Sequence[LoweredProgram],
                         dscales: Sequence[float]) -> ProgramArrays:
    """Stack one instrumented event stream per (program, delay_scale)
    pair into a ragged ``ProgramArrays``."""
    streams = [_stream_arrays(p, d) for p, d in zip(progs, dscales)]
    lengths = np.array([len(s["cycle"]) for s in streams], np.int64)
    offsets = np.zeros(len(streams) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    u = len(UNITS)
    return ProgramArrays(
        units=UNITS,
        cycle=np.concatenate([s["cycle"] for s in streams])
        if streams else np.zeros(0, np.int64),
        lat=np.concatenate([s["lat"] for s in streams])
        if streams else np.zeros((0, u), np.int64),
        pm=np.concatenate([s["pm"] for s in streams])
        if streams else np.zeros((0, u), np.int8),
        offsets=offsets,
        horizon=np.array([s["horizon"] for s in streams], np.int64),
        setpm_vu=np.array([s["setpm_vu"] for s in streams], np.float64))


# --------------------------------------------------------------------------
# the batched executor
# --------------------------------------------------------------------------

def _pack_dense(pa: ProgramArrays, stream_of_row: np.ndarray,
                window: np.ndarray, delay: np.ndarray,
                horizon: np.ndarray) -> dict:
    """Gather the ragged stack into the kernel's dense (E, R[, U])
    layout; padded events carry cycle -1 (the in-kernel no-op mask)."""
    u = len(pa.units)
    lens = pa.lengths[stream_of_row]
    r = len(stream_of_row)
    e_max = int(lens.max()) if r else 0
    cycle = np.full((e_max, r), -1, np.int64)
    lat = np.zeros((e_max, r, u), np.int64)
    pm = np.zeros((e_max, r, u), np.int8)
    for ri, s in enumerate(stream_of_row):
        lo, hi = pa.offsets[s], pa.offsets[s + 1]
        n = hi - lo
        cycle[:n, ri] = pa.cycle[lo:hi]
        lat[:n, ri] = pa.lat[lo:hi]
        pm[:n, ri] = pa.pm[lo:hi]
    return {"cycle": cycle, "lat": lat, "pm": pm,
            "delay": delay.astype(np.int64),
            "window": window.astype(np.int64),
            "mode0": np.broadcast_to(
                np.array(_MODE0, np.int64), (r, u)).copy(),
            "horizon": horizon.astype(np.int64)}


def _run_kernel(data: dict, device) -> dict[str, np.ndarray]:
    """Execute the packed event stack on ``device`` (a CUDA device runs
    B7, one launch; the CPU its plain version); returns host numpy
    outputs per row."""
    dev = get_backend(device).device
    out = program_exec({k: torch.from_numpy(np.ascontiguousarray(v))
                        .to(dev) for k, v in data.items()})
    return {k: v.cpu().numpy() for k, v in out.items()}


def _run_dense(pa: ProgramArrays, stream_of_row: np.ndarray,
               window: np.ndarray, delay: np.ndarray, horizon: np.ndarray,
               device) -> dict[str, np.ndarray]:
    """The CPU route: the reference's dense stack through
    ``_run_kernel``."""
    return _run_kernel(_pack_dense(pa, stream_of_row, window, delay,
                                   horizon), device)


def _upload_streams(pa: ProgramArrays, stream_of_row: np.ndarray,
                    window: np.ndarray, delay: np.ndarray,
                    horizon: np.ndarray, device) -> tuple:
    """The ragged stack's columns, each row's stream and the per-row
    parameters on ``device``: the arguments of ``program_exec_streams``.
    Each stream is copied once, however many rows run it."""
    dev = get_backend(device).device

    def put(a, dtype=np.int64):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    r, u = delay.shape
    streams = {"cycle": put(pa.cycle), "lat": put(pa.lat),
               "pm": put(pa.pm, np.int8), "offsets": put(pa.offsets)}
    rows = {"delay": put(delay), "window": put(window),
            "mode0": put(np.broadcast_to(np.array(_MODE0, np.int64),
                                         (r, u))),
            "horizon": put(horizon)}
    return streams, put(stream_of_row), rows


def _run_streams(pa: ProgramArrays, stream_of_row: np.ndarray,
                 window: np.ndarray, delay: np.ndarray, horizon: np.ndarray,
                 device) -> dict[str, np.ndarray]:
    """Execute the ragged stack on ``device`` through B7's stream entry
    (on a CUDA device one launch, no dense stack); returns host numpy
    outputs per row."""
    out = program_exec_streams(*_upload_streams(
        pa, stream_of_row, window, delay, horizon, device))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _shard_rows(pa: ProgramArrays, stream_of_row: np.ndarray,
                window: np.ndarray, delay: np.ndarray, horizon: np.ndarray,
                size: int, index: int) -> tuple:
    """Shard ``index`` of ``size`` of the executor's rows, padded to a
    multiple of ``size`` with inert rows (an empty stream, horizon 0,
    zero delays and windows): ``_run_streams``' arguments over a stack
    of only the streams those rows run, each once, in first-use order."""
    r = len(stream_of_row)
    per = -(-r // size) if r else 0
    lo, hi = index * per, min(r, (index + 1) * per)
    rows = np.arange(lo, max(lo, hi))
    n_pad = per - len(rows)
    used, local = np.unique(stream_of_row[rows], return_inverse=True) \
        if len(rows) else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    # the empty stream for the padding rows goes last
    lens = np.append(pa.lengths[used], 0) if n_pad else pa.lengths[used]
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    take = np.concatenate([np.arange(pa.offsets[s], pa.offsets[s + 1])
                           for s in used]) if len(used) \
        else np.zeros(0, np.int64)
    u = len(pa.units)
    sub = ProgramArrays(
        units=pa.units, cycle=pa.cycle[take], lat=pa.lat[take],
        pm=pa.pm[take], offsets=offsets,
        horizon=np.append(pa.horizon[used], 0) if n_pad
        else pa.horizon[used],
        setpm_vu=np.append(pa.setpm_vu[used], 0.0) if n_pad
        else pa.setpm_vu[used])
    sor = np.concatenate([local.reshape(-1).astype(np.int64),
                          np.full(n_pad, len(used), np.int64)])
    zeros = np.zeros((n_pad, u), np.int64)
    return (sub, sor, np.concatenate([window[rows], zeros]),
            np.concatenate([delay[rows], zeros]),
            np.concatenate([horizon[rows], np.zeros(n_pad, np.int64)]))


def _run_rows_mesh(pa: ProgramArrays, stream_of_row: np.ndarray,
                   window: np.ndarray, delay: np.ndarray,
                   horizon: np.ndarray, device, mesh) \
        -> dict[str, np.ndarray]:
    """The executor with its rows split over the mesh's ``"wl"`` dim: this
    rank's shard (``_shard_rows``) through B7's stream entry on
    ``device``, then every shard's outputs gathered in row order; host
    numpy outputs per row, the padding dropped."""
    bk = get_backend(device)
    size = int(bk.mesh_axis_sizes(mesh)["wl"])
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh it was given")
    local = _shard_rows(pa, stream_of_row, window, delay, horizon, size,
                        int(mesh.get_local_rank("wl")))
    out = program_exec_streams(*_upload_streams(*local, device))
    out = bk.all_gather(out, mesh, "wl")
    r = len(stream_of_row)
    return {k: v[:r].cpu().numpy() for k, v in out.items()}


def _plane_rows(workloads: Sequence[Workload],
                npu_specs: Sequence[NPUSpec], triples: list[tuple]) -> tuple:
    """One kernel row per (workload, npu, unique knob triple), in that
    order: the lowered programs and delay scales of the distinct event
    streams, each row's stream, its per-unit integer delays and windows,
    and its horizon. Lowering and streams are identity-cached."""
    w_n, a_n, t_n = len(workloads), len(npu_specs), len(triples)
    stream_index: dict[tuple, int] = {}
    progs: list[LoweredProgram] = []
    dscales: list[float] = []
    stream_of_row = np.empty(w_n * a_n * t_n, np.int64)
    window = np.empty((w_n * a_n * t_n, len(UNITS)), np.int64)
    delay = np.empty_like(window)
    horizon = np.empty(w_n * a_n * t_n, np.int64)
    for wi, wl in enumerate(workloads):
        for ai, npu in enumerate(npu_specs):
            for ti, (saw, dsc, wsc) in enumerate(triples):
                npu_eff = with_sa_width(npu, saw)
                prog = lower_workload(wl, npu_eff)
                skey = (id(prog), float(dsc))
                si = stream_index.get(skey)
                if si is None:
                    si = len(progs)
                    stream_index[skey] = si
                    progs.append(prog)
                    dscales.append(float(dsc))
                ri = (wi * a_n + ai) * t_n + ti
                stream_of_row[ri] = si
                horizon[ri] = prog.horizon
                g = npu_eff.gating
                for ui, key in enumerate(_KEYS):
                    delay[ri, ui] = scaled_delay(g, key, dsc)
                    window[ri, ui] = scaled_window(g, key, dsc, wsc)
    return progs, dscales, stream_of_row, window, delay, horizon


# --------------------------------------------------------------------------
# the batched plane: cube assembly + records
# --------------------------------------------------------------------------

@dataclass
class ProgramPlaneBatch:
    """The full (workload x npu x knob) program-plane cube.

    Executor-side arrays are indexed (W, A, T) over the unique knob
    triples; ``records()`` expands to the full knob axis via ``inv``
    and assembles one ``lowering.plane_record`` per cell."""
    workloads: tuple[str, ...]
    npus: tuple[NPUSpec, ...]
    knob_grid: tuple[PolicyKnobs, ...]
    triples: list[tuple]
    inv: np.ndarray                       # (K,) knob -> triple index
    cycles: np.ndarray                    # (W, A, T) int64
    stall_cycles: np.ndarray              # (W, A, T) int64
    n_events: np.ndarray                  # (W, A, T) int64
    gated_cycles: dict[str, np.ndarray]   # comp -> (W, A, T) float64
    wake_events: dict[str, np.ndarray]    # comp -> (W, A, T) float64
    setpm_isa: dict[str, np.ndarray]      # vu/sram -> (W, A, T)
    policy: BatchResult = field(repr=False)

    def records(self) -> list[dict]:
        """Flat records, workload-major then NPU then knob index — the
        sweep convention, one record per (workload, npu, knob) cell."""
        recs = []
        pol = self.policy
        for wi, wl in enumerate(self.workloads):
            for ai, npu in enumerate(self.npus):
                for ki, knobs in enumerate(self.knob_grid):
                    ti = int(self.inv[ki])
                    c = (wi, ai, ti)
                    recs.append(plane_record(
                        wl, npu, knobs, ki,
                        prog={
                            "cycles": int(self.cycles[c]),
                            "n_events": int(self.n_events[c]),
                            "stall_cycles": int(self.stall_cycles[c]),
                            "gated_cycles": {
                                k: float(v[c])
                                for k, v in self.gated_cycles.items()},
                            "wake_events": {
                                k: float(v[c])
                                for k, v in self.wake_events.items()},
                            "setpm_isa": {
                                k: float(v[c])
                                for k, v in self.setpm_isa.items()}},
                        policy={
                            "runtime_s":
                                float(pol.runtime_s[wi, ai, 0, ki]),
                            "gated_s": {
                                k: float(v[wi, ai, 0, ki])
                                for k, v in pol.gated_s.items()},
                            "setpm_by": {
                                k: float(v[wi, ai, 0, ki])
                                for k, v in pol.setpm_by.items()}}))
        return recs


def program_plane_batch(workloads: Sequence[Workload] | Workload,
                        npus: Iterable[NPUSpec | str] = ("NPU-D",),
                        knob_grid: Optional[Sequence[PolicyKnobs]] = None,
                        *, device=None, mesh=None) -> ProgramPlaneBatch:
    """Evaluate the program plane for every (workload, npu, knob) cell
    through the batched executor + the closed-form folds.

    Matches the per-cell ``lowering.crossval_record`` record-for-record:
    executor integers exactly, closed-form folds bit-identically (same
    host functions), the policy side within ``evaluate_batch``'s
    ≤1e-9 of per-cell ``evaluate``.

    ``device`` is where the executor and the policy side run: ``None``
    resolves through the active ``SweepSession`` and otherwise means
    ``"cuda"`` — with no card that raises. On a CUDA device the executor
    is one launch of kernel B7 on the ragged stack; ``device="cpu"`` runs
    its plain version on the dense one.

    ``mesh`` (``None``: the session's) with a ``"wl"`` dim splits the
    executor's rows over that dim, every rank of it making this same
    call (see the module's docstring); the executor integers equal the
    unsharded run's exactly. The policy side resolves its own mesh."""
    if isinstance(workloads, Workload):
        workloads = [workloads]
    workloads = list(workloads)
    npu_specs = [get_npu(n) if isinstance(n, str) else n for n in npus]
    grid = tuple(knob_grid) if knob_grid is not None else (PolicyKnobs(),)
    # no card for "cuda": raise before the host work
    run = _run_streams if get_backend(device).device.type == "cuda" \
        else _run_dense
    if mesh is None:
        mesh = session.resolve("mesh")
    if mesh is not None and "wl" in get_backend(device).mesh_axis_sizes(
            mesh):
        run = functools.partial(_run_rows_mesh, mesh=mesh)

    triples, inv = knob_pairs(grid)
    w_n, a_n, t_n = len(workloads), len(npu_specs), len(triples)
    progs, dscales, stream_of_row, window, delay, horizon = _plane_rows(
        workloads, npu_specs, triples)
    pa = build_program_arrays(progs, dscales)
    out = run(pa, stream_of_row, window, delay, horizon, device)

    shape = (w_n, a_n, t_n)
    cycles = out["cycles"].reshape(shape)
    stalls = out["stall_cycles"].reshape(shape)
    gated_u = out["gated"].reshape(shape + (len(UNITS),))
    wakes_u = out["wakes"].reshape(shape + (len(UNITS),))
    n_events = pa.lengths[stream_of_row].reshape(shape)

    gated = {c: gated_u[..., ui].astype(np.float64)
             for ui, c in enumerate(COMPS)}
    wakes = {c: wakes_u[..., ui].astype(np.float64)
             for ui, c in enumerate(COMPS)}
    setpm_isa = {"vu": pa.setpm_vu[stream_of_row].reshape(shape).copy(),
                 "sram": np.zeros(shape)}
    gated["sram"] = np.zeros(shape)

    # closed-form folds, once per unique (workload, npu, triple) —
    # identical host calls to execute_program's, so bit-identical; the
    # SRAM band analysis is window-independent, so it further dedups to
    # one call per (program, delay_scale)
    pol_vu = _component_policies("ReGate-Full")["vu"]
    sram_memo: dict[tuple[int, float], dict] = {}
    for wi, wl in enumerate(workloads):
        for ai, npu in enumerate(npu_specs):
            for ti, (saw, dsc, wsc) in enumerate(triples):
                npu_eff = with_sa_width(npu, saw)
                prog = lower_workload(wl, npu_eff)
                kn = PolicyKnobs(delay_scale=dsc, window_scale=wsc,
                                 sa_width=saw)
                fv = _fine_grained_vu_vec(
                    prog.tm, prog.tr, npu_eff, pol_vu, 1.0,
                    npu_eff.gating.leak_off_logic, kn)
                gated["vu"][wi, ai, ti] = (
                    gated["vu"][wi, ai, ti]
                    + fv["gated_s"] * npu_eff.freq_hz)
                setpm_isa["vu"][wi, ai, ti] += fv["setpm"]
                wakes["vu"][wi, ai, ti] += fv["wakes"]
                skey = (id(prog), float(dsc))
                sb = sram_memo.get(skey)
                if sb is None:
                    sb = sram_band_gating(prog, delay_scale=dsc)
                    sram_memo[skey] = sb
                gated["sram"][wi, ai, ti] = (
                    sb["gated_segcycles"] / max(1, sb["n_segments"]))
                setpm_isa["sram"][wi, ai, ti] = sb["setpm"]

    policy = evaluate_batch(workloads, npu_specs, ("ReGate-Full",),
                            grid, device=device)
    return ProgramPlaneBatch(
        workloads=tuple(wl.name for wl in workloads),
        npus=tuple(npu_specs), knob_grid=grid, triples=triples,
        inv=inv, cycles=cycles, stall_cycles=stalls, n_events=n_events,
        gated_cycles=gated, wake_events=wakes, setpm_isa=setpm_isa,
        policy=policy)
