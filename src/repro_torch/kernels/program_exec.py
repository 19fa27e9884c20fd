"""The program plane's lock-step event executor — CUDA kernel B7.

Replaces the JAX package's carry-only ``lax.scan`` over the event axis
(``src/repro/core/backend.py:218`` ``JaxBackend.scan``) with the body
``src/repro/core/program_plane.py:182-278`` (``_kernel_body``: the
closed-form ``gap_account`` and the bundle ``step``; ``_full_body``: the
tail gap to the horizon and the drain), which XLA compiled into one
device program. Eager PyTorch would launch some 60 small ops an event;
a stream of the paper suite runs to ~3 300 events. The kernel, its bound
and its design are in ``csrc/program_plane.cu``; in short: a warp steps
the rows that share one event stream, a lane per (row, unit), reading
the stream once through a ring of bulk copies into shared memory, so
the time is the longest row's chain of dependent steps, not its bytes.

Two entries reach the one kernel:

* ``program_exec_streams(streams, stream_of_row, rows)`` takes the
  ragged event streams as ``program_plane.ProgramArrays`` holds them:
  ``cycle`` ``(N,)`` int64 (``-1`` marks a padded event, which changes
  no state), ``lat`` ``(N, U)`` int64 issue latencies (0 where the
  bundle does not use the unit), ``pm`` ``(N, U)`` int8 setpm effects
  (1 ON, 2 OFF, 3 AUTO) and ``offsets`` ``(S + 1,)`` int64 (stream ``s``
  owns events ``offsets[s]:offsets[s + 1]``); per row its stream
  ``stream_of_row`` ``(R,)`` int64 and ``rows``: ``delay``, ``window``,
  ``mode0`` ``(R, U)`` int64 (mode codes 0 AUTO, 1 ON, 2 OFF) and
  ``horizon`` ``(R,)`` int64.
* ``program_exec(data)`` takes the reference's dense packing
  (``program_plane._pack_dense``): ``cycle`` ``(E, R)``, ``lat`` and
  ``pm`` ``(E, R, U)`` and the same per-row arrays; on a card it runs
  each row as a stream of its own, cut at its last real event.

Everything is integer: the results are exact. Both launch the kernel for
CUDA tensors and evaluate their plain versions (``program_exec_plain``,
the reference's dense body; ``program_exec_streams_plain``, the same on
the streams packed dense by ``pack_streams``) for CPU tensors; nothing
else selects between them, and a kernel that fails to build or launch
raises. ``program_exec.launches`` counts kernel launches of both.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the machine's unit count the kernel is compiled for (csrc b7::U):
#: the program plane's sa0, vu0, dma0, ici0
KERNEL_UNITS = 4
#: the outputs, per row: ``(R,)`` or ``(R, U)`` int64
OUTPUTS = ("cycles", "stall_cycles", "on", "gated", "wakes",
           "setpm_executed")
_PER_UNIT = ("on", "gated", "wakes")
_EVENT_KEYS = ("cycle", "lat", "pm")
_ROW_KEYS = ("delay", "window", "mode0", "horizon")
# the kernel's bulk copies move whole groups of this many events (16
# bytes of setpm codes): the wrapper pads the columns to a multiple
_EVENT_ALIGN = 4


def _check(data: dict) -> tuple[int, int, int]:
    """Shapes, dtypes and one device for the whole packed stack;
    returns ``(E, R, U)``."""
    missing = [k for k in _EVENT_KEYS + _ROW_KEYS if k not in data]
    if missing:
        raise ValueError(f"program_exec: missing {missing}")
    cycle, delay = data["cycle"], data["delay"]
    if cycle.dim() != 2 or delay.dim() != 2:
        raise ValueError(f"program_exec: cycle {tuple(cycle.shape)} must "
                         f"be (E, R) and delay {tuple(delay.shape)} (R, U)")
    (e, r), u = cycle.shape, delay.shape[1]
    want = {"cycle": ((e, r), torch.int64), "lat": ((e, r, u), torch.int64),
            "pm": ((e, r, u), torch.int8), "delay": ((r, u), torch.int64),
            "window": ((r, u), torch.int64), "mode0": ((r, u), torch.int64),
            "horizon": ((r,), torch.int64)}
    for k, (shape, dtype) in want.items():
        a = data[k]
        if tuple(a.shape) != shape or a.dtype != dtype \
                or a.device != cycle.device:
            raise ValueError(
                f"program_exec[{k}]: want {dtype} {shape} on "
                f"{cycle.device}, got {a.dtype} {tuple(a.shape)} on "
                f"{a.device}")
    return e, r, u


def _gap_account(st: dict, n: torch.Tensor, window: torch.Tensor) -> dict:
    """Closed-form ``EventTimeline._gap(n, t)`` on every row: a powered
    AUTO unit crosses its idle-detection window mid-gap and counts gated
    from there."""
    powered, auto = st["powered"], st["mode"] == 0
    g = torch.maximum(st["idle"] + window, st["busy"])
    n_u = n[:, None]
    on_gap = torch.minimum(torch.clamp(g - st["t"][:, None] - 1, min=0), n_u)
    on_add = torch.where(powered, torch.where(auto, on_gap, n_u), 0)
    gate_add = n_u - on_add
    crossed = auto & powered & (gate_add > 0)
    return dict(st, powered=powered & ~crossed, on=st["on"] + on_add,
                gated=st["gated"] + gate_add, t=st["t"] + n)


def _step(st: dict, cyc: torch.Tensor, lat: torch.Tensor, pm: torch.Tensor,
          delay: torch.Tensor, window: torch.Tensor) -> dict:
    """One event of every row: the gap since the row's last event, then
    the bundle (setpm first, dispatch wake, issue at the latest ready or
    busy unit, post-issue idle detection). A padded event (cycle -1)
    leaves the row's state as it was."""
    valid = cyc >= 0
    g1 = _gap_account(st, torch.clamp(cyc - st["prev"] - 1, min=0), window)
    t1 = g1["t"]
    t1_u = t1[:, None]
    # the misc-slot setpm applies first: it takes effect this cycle
    powered, mode = g1["powered"], g1["mode"]
    ready, wakes = g1["ready"], g1["wakes"]
    is_on, is_off, is_auto = pm == 1, pm == 2, pm == 3
    wake_pm = is_on & ~powered
    ready = torch.where(wake_pm, t1_u + delay, ready)
    wakes = wakes + wake_pm
    powered = (powered | wake_pm) & ~is_off
    mode = torch.where(is_on, 1, torch.where(
        is_off, 2, torch.where(is_auto, 0, mode)))
    nsetpm_add = (pm > 0).any(dim=1)
    # structural hazards: a dispatch wakes a gated unit, and the bundle
    # waits for every unit it uses to be ready and free
    ref = lat > 0
    wake_d = ref & ~powered
    ready = torch.where(wake_d, torch.maximum(t1_u, g1["busy"]) + delay,
                        ready)
    wakes = wakes + wake_d
    powered = powered | wake_d
    need = torch.where(ref, torch.maximum(ready, g1["busy"]), 0)
    start = torch.maximum(t1, need.amax(dim=1))
    busy = torch.where(ref, start[:, None] + lat, g1["busy"])
    idle = torch.where(ref, busy, g1["idle"])
    t2 = start + 1
    t2_u = t2[:, None]
    # hardware idle detection at the post-issue cycle
    gate4 = (powered & (mode == 0) & (t2_u - idle >= window)
             & (busy <= t2_u))
    powered = powered & ~gate4
    new = dict(t=t2, prev=cyc, powered=powered, mode=mode, ready=ready,
               busy=busy, idle=idle, on=g1["on"] + powered,
               gated=g1["gated"] + ~powered, wakes=wakes,
               stalls=g1["stalls"] + (start - t1),
               nsetpm=g1["nsetpm"] + nsetpm_add)
    v_u = valid[:, None]
    return {k: torch.where(valid if v.dim() == 1 else v_u, v, st[k])
            for k, v in new.items()}


def program_exec_plain(data: dict) -> dict:
    """Plain PyTorch version of B7: the reference's ``_kernel_body`` and
    ``_full_body`` as a Python loop over the event axis, every row at
    once. Same inputs and outputs as ``program_exec``."""
    _, r, u = _check(data)
    delay, window = data["delay"], data["window"]
    dev = delay.device
    i8 = torch.int64
    zeros = torch.zeros((r, u), dtype=i8, device=dev)
    st = dict(t=torch.zeros(r, dtype=i8, device=dev),
              prev=torch.full((r,), -1, dtype=i8, device=dev),
              powered=torch.ones((r, u), dtype=torch.bool, device=dev),
              mode=data["mode0"].clone(), ready=zeros, busy=zeros,
              idle=zeros, on=zeros, gated=zeros, wakes=zeros,
              stalls=torch.zeros(r, dtype=i8, device=dev),
              nsetpm=torch.zeros(r, dtype=i8, device=dev))
    for e in range(data["cycle"].shape[0]):
        st = _step(st, data["cycle"][e], data["lat"][e], data["pm"][e],
                   delay, window)
    st = _gap_account(
        st, torch.clamp(data["horizon"] - st["prev"] - 1, min=0), window)
    end = torch.maximum(st["t"], st["busy"].amax(dim=1)) if u \
        else st["t"].clone()
    extra = (end - st["t"])[:, None]
    return {"cycles": end, "stall_cycles": st["stalls"],
            "on": st["on"] + torch.where(st["powered"], extra, 0),
            "gated": st["gated"] + torch.where(st["powered"], 0, extra),
            "wakes": st["wakes"], "setpm_executed": st["nsetpm"]}


def row_extent(cycle: torch.Tensor) -> torch.Tensor:
    """Per row, one past the index of its last real event (``cycle >=
    0``) of a dense ``(E, R)`` stack. Past it every event is padding, a
    no-op by definition, so a row's stream ends there."""
    e = cycle.shape[0]
    idx = torch.arange(1, e + 1, dtype=torch.int64, device=cycle.device)
    return torch.where(cycle >= 0, idx[:, None], 0).amax(dim=0) if e \
        else torch.zeros(cycle.shape[1], dtype=torch.int64,
                         device=cycle.device)


def _check_streams(streams: dict, stream_of_row: torch.Tensor,
                   rows: dict) -> tuple[int, int, int, int]:
    """Shapes, dtypes and one device for the ragged entry; returns
    ``(N, S, R, U)``."""
    missing = [k for k in _EVENT_KEYS + ("offsets",) if k not in streams] \
        + [k for k in _ROW_KEYS if k not in rows]
    if missing:
        raise ValueError(f"program_exec_streams: missing {missing}")
    cycle, delay = streams["cycle"], rows["delay"]
    if cycle.dim() != 1 or delay.dim() != 2 or stream_of_row.dim() != 1:
        raise ValueError(
            f"program_exec_streams: cycle {tuple(cycle.shape)} must be (N,), "
            f"delay {tuple(delay.shape)} (R, U), stream_of_row "
            f"{tuple(stream_of_row.shape)} (R,)")
    n, (r, u) = cycle.shape[0], delay.shape
    s = streams["offsets"].shape[0] - 1
    if s < 0:
        raise ValueError("program_exec_streams: offsets must hold S + 1 "
                         "entries")
    want = {"cycle": ((n,), torch.int64), "lat": ((n, u), torch.int64),
            "pm": ((n, u), torch.int8), "offsets": ((s + 1,), torch.int64),
            "stream_of_row": ((r,), torch.int64),
            "delay": ((r, u), torch.int64), "window": ((r, u), torch.int64),
            "mode0": ((r, u), torch.int64), "horizon": ((r,), torch.int64)}
    given = {**streams, **rows, "stream_of_row": stream_of_row}
    for k, (shape, dtype) in want.items():
        a = given[k]
        if tuple(a.shape) != shape or a.dtype != dtype \
                or a.device != cycle.device:
            raise ValueError(
                f"program_exec_streams[{k}]: want {dtype} {shape} on "
                f"{cycle.device}, got {a.dtype} {tuple(a.shape)} on "
                f"{a.device}")
    off = streams["offsets"]
    bad = (off[1:] < off[:-1]).any() | (off[0] < 0) | (off[-1] > n)
    if r:
        bad = bad | (stream_of_row < 0).any() | (stream_of_row >= s).any()
    if bool(bad):
        raise ValueError("program_exec_streams: offsets must rise from 0 "
                         "to at most N, and every row name a stream")
    return n, s, r, u


def pack_streams(streams: dict, stream_of_row: torch.Tensor,
                 rows: dict) -> dict:
    """The ragged streams gathered into the dense ``(E, R[, U])`` stack of
    ``program_exec``, the layout of ``program_plane._pack_dense``: row
    ``r`` holds its stream's events from index 0, then ``cycle = -1``
    padding (``lat`` and ``pm`` 0) up to the longest row's length."""
    _, _, r, _ = _check_streams(streams, stream_of_row, rows)
    off = streams["offsets"]
    dev = off.device
    lens = (off[1:] - off[:-1])[stream_of_row]
    e_max = int(lens.max()) if r else 0
    ev = torch.arange(e_max, dtype=torch.int64, device=dev)[:, None]
    valid = ev < lens[None, :]
    idx = torch.where(valid, off[stream_of_row][None, :] + ev, 0)
    return {"cycle": torch.where(valid, streams["cycle"][idx], -1),
            "lat": torch.where(valid[..., None], streams["lat"][idx], 0),
            "pm": torch.where(valid[..., None], streams["pm"][idx], 0),
            **{k: rows[k] for k in _ROW_KEYS}}


def program_exec_streams_plain(streams: dict, stream_of_row: torch.Tensor,
                               rows: dict) -> dict:
    """Plain PyTorch version of the ragged entry: the streams packed dense
    (``pack_streams``), then ``program_exec_plain``."""
    return program_exec_plain(pack_streams(streams, stream_of_row, rows))


def _launch(streams: dict, stream_of_row: torch.Tensor, rows: dict,
            r: int, u: int) -> dict:
    """One launch of B7 on CUDA tensors: the rows grouped into one task
    per stream (a stable sort by stream), the columns padded to a
    multiple of ``_EVENT_ALIGN`` events and 16-byte aligned."""
    dev = streams["cycle"].device
    if u != KERNEL_UNITS:
        raise ValueError(f"program_exec: the kernel is built for "
                         f"{KERNEL_UNITS} units, got {u}")
    out = {k: torch.zeros((r, u) if k in _PER_UNIT else (r,),
                          dtype=torch.int64, device=dev) for k in OUTPUTS}
    if r == 0:  # a zero-size grid is a launch error
        return out
    cols = {k: streams[k].contiguous() for k in _EVENT_KEYS}
    pad = -cols["cycle"].shape[0] % _EVENT_ALIGN
    for k in _EVENT_KEYS:
        if pad:
            fill = torch.full((pad,) + cols[k].shape[1:],
                              -1 if k == "cycle" else 0,
                              dtype=cols[k].dtype, device=dev)
            cols[k] = torch.cat([cols[k], fill])
        if cols[k].data_ptr() % 16:
            cols[k] = cols[k].clone()
    order = torch.argsort(stream_of_row, stable=True)
    used, counts = torch.unique_consecutive(stream_of_row[order],
                                            return_counts=True)
    task_rows = torch.zeros(used.shape[0] + 1, dtype=torch.int64,
                            device=dev)
    torch.cumsum(counts, 0, out=task_rows[1:])
    ev_lo, ev_hi = streams["offsets"][used], streams["offsets"][used + 1]
    ins = {k: rows[k].contiguous() for k in _ROW_KEYS}
    lib = _build.load("program_plane")
    with torch.cuda.device(dev):
        err = lib.program_exec_launch(
            *(cols[k].data_ptr() for k in _EVENT_KEYS),
            ev_lo.data_ptr(), ev_hi.data_ptr(), task_rows.data_ptr(),
            order.data_ptr(), used.shape[0],
            *(ins[k].data_ptr() for k in _ROW_KEYS),
            *(out[k].data_ptr() for k in OUTPUTS),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "program_exec")
    program_exec.launches += 1
    return out


def program_exec_streams(streams: dict, stream_of_row: torch.Tensor,
                         rows: dict) -> dict:
    """Execute ragged event streams, row ``r`` on stream
    ``stream_of_row[r]`` (see the module's docstring); returns
    ``OUTPUTS`` as ``program_exec`` does, on the streams' device."""
    if streams["cycle"].device.type != "cuda":
        return program_exec_streams_plain(streams, stream_of_row, rows)
    _, _, r, u = _check_streams(streams, stream_of_row, rows)
    return _launch(streams, stream_of_row, rows, r, u)


def program_exec(data: dict) -> dict:
    """Execute a dense packed event stack (``(E, R[, U])``, see the
    module's docstring); returns ``OUTPUTS``: ``cycles``,
    ``stall_cycles``, ``setpm_executed`` ``(R,)`` and ``on``, ``gated``,
    ``wakes`` ``(R, U)``, all int64, on the stack's device. On a card
    each row is a stream of its own up to its last real event."""
    _, r, u = _check(data)
    if data["cycle"].device.type != "cuda":
        return program_exec_plain(data)
    return _launch(*_dense_as_streams(data), r, u)


def _dense_as_streams(data: dict) -> tuple[dict, torch.Tensor, dict]:
    """A dense stack as ``program_exec_streams``' arguments: row ``r`` is
    stream ``r``, its events up to its last real one (``row_extent``)."""
    cycle = data["cycle"]
    dev = cycle.device
    extent = row_extent(cycle)
    keep = torch.arange(cycle.shape[0], device=dev)[None, :] \
        < extent[:, None]
    offsets = torch.zeros(cycle.shape[1] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(extent, 0, out=offsets[1:])
    streams = {"cycle": cycle.t()[keep],
               "lat": data["lat"].transpose(0, 1)[keep],
               "pm": data["pm"].transpose(0, 1)[keep], "offsets": offsets}
    return streams, torch.arange(cycle.shape[1], device=dev), \
        {k: data[k] for k in _ROW_KEYS}


program_exec.launches = 0
