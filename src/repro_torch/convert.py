"""Rebuild the port's state from plain numpy arrays and dicts.

The state a sweep consumes is the compiled trace stack, the NPU spec and
the knob grid; the state a model consumes is its parameter tree. These
functions rebuild the port's objects from another implementation's
objects dumped to plain data (``dataclasses.asdict``, attribute reads,
``np.asarray`` per leaf on the other side — nothing here sees a foreign
object). With them a trace built elsewhere can be pushed through the
port's sweep kernel, and weights drawn elsewhere through the port's
model, so a difference in the inputs and a difference in the computation
show up separately.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.hw import GatingParams, NPUSpec
from repro_torch.core.opgen import StackedTrace, TraceArrays
from repro_torch.core.policies import PolicyKnobs

_F8_COLS = ("flops_sa", "flops_vu", "bytes_hbm", "bytes_ici",
            "sram_demand", "count")
_BOOL_COLS = ("collective", "has_mm")
_I8_COLS = ("mm_m", "mm_k", "mm_n")


def stacked_trace_from_numpy(cols: Mapping[str, np.ndarray],
                             names: Sequence[str],
                             offsets) -> StackedTrace:
    """A ``StackedTrace`` from concatenated per-op columns.

    ``cols`` holds one ``(N,)`` array per column — float64 ``flops_sa``,
    ``flops_vu``, ``bytes_hbm``, ``bytes_ici``, ``sram_demand``,
    ``count``; bool ``collective``, ``has_mm``; integer ``mm_m``,
    ``mm_k``, ``mm_n`` (1 where ``has_mm`` is False). ``names`` are the
    workload names, one per segment, and ``offsets`` ``(W+1,)`` the op
    ranges. The result is not entered into the stacking cache.
    """
    offsets = np.asarray(offsets, np.int64)
    names = tuple(names)
    if offsets.ndim != 1 or len(offsets) != len(names) + 1:
        raise ValueError(f"offsets must be ({len(names) + 1},), got shape "
                         f"{offsets.shape}")
    n = int(offsets[-1]) if len(offsets) else 0
    if len(offsets) and (offsets[0] != 0 or (np.diff(offsets) < 0).any()):
        raise ValueError("offsets must start at 0 and never decrease")
    c: dict[str, np.ndarray] = {}
    for keys, dtype in ((_F8_COLS, np.float64), (_BOOL_COLS, bool),
                        (_I8_COLS, np.int64)):
        for k in keys:
            a = np.array(cols[k], dtype)  # a copy the stack owns
            if a.shape != (n,):
                raise ValueError(f"column {k!r}: expected shape ({n},), "
                                 f"got {a.shape}")
            c[k] = a
    traces = []
    for w in range(len(names)):
        lo, hi = int(offsets[w]), int(offsets[w + 1])
        traces.append(TraceArrays(
            n_ops=hi - lo,
            names=tuple(f"op{i}" for i in range(hi - lo)),
            **{k: c[k][lo:hi] for k in _F8_COLS + _BOOL_COLS + _I8_COLS}))
    lengths = np.diff(offsets)
    return StackedTrace(
        traces=tuple(traces), names=names, n_ops=n, offsets=offsets,
        seg_ids=np.repeat(np.arange(len(names), dtype=np.int64), lengths),
        **{k: c[k] for k in _F8_COLS + _BOOL_COLS})


def npu_from_dict(d: Mapping) -> NPUSpec:
    """An ``NPUSpec`` from its ``dataclasses.asdict`` form (the nested
    ``gating`` entry is a dict of ``GatingParams`` fields)."""
    d = dict(d)
    gating = d.pop("gating", None)
    if gating is not None:
        gating = dict(gating)
        for table in ("on_off_delay", "bet"):
            gating[table] = dict(gating[table])
        d["gating"] = GatingParams(**gating)
    return NPUSpec(**d)


def knob_grid_from_dicts(rows: Sequence[Mapping]) -> tuple[PolicyKnobs, ...]:
    """A flat knob grid from one dict of ``PolicyKnobs`` fields per
    knob point."""
    return tuple(PolicyKnobs(**dict(r)) for r in rows)


def params_from_numpy(tree: Any, *, device="cuda",
                      dtype: torch.dtype = torch.float32) -> Any:
    """A parameter tree of tensors on ``device`` from nested dicts of
    numpy arrays, e.g. the JAX package's parameters dumped leaf by leaf
    with ``np.asarray``. Floating leaves become ``dtype``; other leaves
    keep their own type. ``device`` defaults to the card, as every entry
    point of the port does; with no card that raises, and
    ``device="cpu"`` builds the tree on the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "parameter tree on the CPU")
    return _tree_from_numpy(tree, device, dtype)


def _tree_from_numpy(tree: Any, device: torch.device,
                     dtype: torch.dtype) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        # numpy has no bf16: widen first (exact), then round once
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)
    return torch.from_numpy(a.copy()).to(device)


def train_state_from_numpy(tree: Mapping, *, device="cuda",
                           moment_dtype: torch.dtype = torch.float32):
    """A ``repro_torch.train.steps.TrainState`` on ``device`` from the
    JAX package's ``TrainState`` dumped to numpy: ``{"params": tree,
    "opt_state": {"m": tree, "v": tree, "step": int, ["ef": tree]},
    "step": int}``, each leaf an ``np.asarray`` of the reference's. The
    params become float32 leaves that require grad, ``m`` and ``v``
    ``moment_dtype``, ``ef`` float32, the steps int32 0-d tensors — so
    both packages run the same steps from the same state. ``device``
    defaults to the card and raises without one."""
    from repro_torch.models.param import train_params
    from repro_torch.train.steps import TrainState
    params = train_params(params_from_numpy(tree["params"], device=device))
    device = torch.device(device)
    opt = tree["opt_state"]
    step = lambda x: torch.tensor(int(np.asarray(x)), dtype=torch.int32,  # noqa
                                  device=device)
    new_opt = {k: _tree_from_numpy(opt[k], device, moment_dtype)
               for k in ("m", "v")}
    new_opt["step"] = step(opt["step"])
    if "ef" in opt:
        new_opt["ef"] = _tree_from_numpy(opt["ef"], device, torch.float32)
    return TrainState(params=params, opt_state=new_opt, step=step(tree["step"]))
