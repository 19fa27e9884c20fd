"""The program plane's lock-step event executor — CUDA kernel B7.

Replaces the JAX package's carry-only ``lax.scan`` over the event axis
(``src/repro/core/backend.py:218`` ``JaxBackend.scan``) with the body
``src/repro/core/program_plane.py:182-278`` (``_kernel_body``: the
closed-form ``gap_account`` and the bundle ``step``; ``_full_body``: the
tail gap to the horizon and the drain), which XLA compiled into one
device program. Eager PyTorch would launch some 60 small ops an event;
a stream of the paper suite runs to ~3 300 events. The kernel, its bound
and its design are in ``csrc/program_plane.cu``; in short: one thread
per row keeps the row's whole ``(unit,)`` machine state in registers and
walks the row's events in order, so the time is the longest row's chain
of dependent steps, not its bytes.

The data is the reference's dense packing (``program_plane._pack_dense``):
``cycle`` ``(E, R)`` int64 (``-1`` marks a padded event, which changes no
state), ``lat`` ``(E, R, U)`` int64 issue latencies (0 where the bundle
does not use the unit), ``pm`` ``(E, R, U)`` int8 setpm effects (1 ON,
2 OFF, 3 AUTO), and per row ``delay``, ``window``, ``mode0`` ``(R, U)``
int64 (mode codes 0 AUTO, 1 ON, 2 OFF) and ``horizon`` ``(R,)`` int64.
Everything is integer: the results are exact.

``program_exec`` launches the kernel for CUDA tensors and evaluates
``program_exec_plain`` for CPU tensors; nothing else selects between
them, and a kernel that fails to build or launch raises.
``program_exec.launches`` counts kernel launches.
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
    0``): the kernel's loop bound. Past it every event is padding, a
    no-op by definition, so a row stops there."""
    e = cycle.shape[0]
    idx = torch.arange(1, e + 1, dtype=torch.int64, device=cycle.device)
    return torch.where(cycle >= 0, idx[:, None], 0).amax(dim=0) if e \
        else torch.zeros(cycle.shape[1], dtype=torch.int64,
                         device=cycle.device)


def program_exec(data: dict) -> dict:
    """Execute a dense packed event stack (``(E, R[, U])``, see the
    module's docstring); returns ``OUTPUTS``: ``cycles``,
    ``stall_cycles``, ``setpm_executed`` ``(R,)`` and ``on``, ``gated``,
    ``wakes`` ``(R, U)``, all int64, on the stack's device."""
    _, r, u = _check(data)
    dev = data["cycle"].device
    if dev.type != "cuda":
        return program_exec_plain(data)
    if u != KERNEL_UNITS:
        raise ValueError(f"program_exec: the kernel is built for "
                         f"{KERNEL_UNITS} units, got {u}")
    out = {k: torch.zeros((r, u) if k in _PER_UNIT else (r,),
                          dtype=torch.int64, device=dev) for k in OUTPUTS}
    if r == 0:  # a zero-size grid is a launch error
        return out
    ins = {k: data[k].contiguous() for k in _EVENT_KEYS + _ROW_KEYS}
    # the kernel reads an event's 4 latencies as two 16-byte loads and
    # its 4 setpm codes as one 4-byte load
    for k, align in (("lat", 16), ("pm", 4)):
        if ins[k].data_ptr() % align:
            ins[k] = ins[k].clone()
    extent = row_extent(ins["cycle"])
    lib = _build.load("program_plane")
    with torch.cuda.device(dev):
        err = lib.program_exec_launch(
            *(ins[k].data_ptr() for k in _EVENT_KEYS + _ROW_KEYS),
            extent.data_ptr(), r, *(out[k].data_ptr() for k in OUTPUTS),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "program_exec")
    program_exec.launches += 1
    return out


program_exec.launches = 0
