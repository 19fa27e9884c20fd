"""Session-scoped sweep configuration.

``SweepSession`` is one configuration layer for the sweep substrate::

    with SweepSession(device="cpu"):
        recs = sweep_grid(suite, grid=grid)   # rides the session

A session is a *layer*: fields left at ``UNSET`` inherit from the
enclosing session (ultimately the root session, which holds the
process-wide defaults). Sessions nest and restore the previous state on
exit, exception-safe.

The port's session carries three fields:

* ``device``: where the sweep kernel's tensors live. It stands where the
  JAX package's session has ``backend``, ``jax_mesh`` and
  ``sa_occupancy_impl`` — in the port the device alone decides the route
  (a CUDA tensor goes through the hand-written kernels, a CPU tensor
  through their plain versions). The root value is ``None``, which every
  entry point reads as ``"cuda"``.
* ``gating_cache_size``: applied on ``__enter__`` through
  ``sa_gating.set_gating_cache_size`` (the LRU itself stays the single
  source of truth) and the previous size restored on ``__exit__``. The
  root holds ``UNSET`` for it, so it resolves to ``None``.
* ``guard``: a ``guard.GuardPolicy`` (or ``None``, the root's value)
  that the campaign entry points (``fleet.sweep_fleet`` /
  ``fleet.sweep_chaos``) pick up when their ``guard=`` argument is left
  unset, scoping the guard plane's watchdog / failover / quarantine
  machinery like the device.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import torch


class _Unset:
    """Sentinel: 'inherit this field from the enclosing session'."""

    _instance: Optional["_Unset"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - repr cosmetics
        return "<inherit>"


UNSET = _Unset()

_FIELDS = ("device", "gating_cache_size", "guard")


def _check_device(value: Any) -> Any:
    if value is not None:
        torch.device(value)  # raises on a malformed device string
    return value


def _check_guard(value: Any) -> Any:
    if value is None:
        return value
    from repro_torch.core.guard import GuardPolicy
    if not isinstance(value, GuardPolicy):
        raise ValueError(f"guard must be a guard.GuardPolicy or None, "
                         f"got {type(value)}")
    return value


class SweepSession:
    """One configuration layer for the sweep substrate.

    ``device`` defaults to ``UNSET`` (inherit); otherwise anything
    ``torch.device`` accepts, or ``None`` for the default (``"cuda"``).
    ``gating_cache_size`` defaults to ``UNSET`` (leave the LRU alone);
    otherwise a size accepted by ``sa_gating.set_gating_cache_size``
    (``None`` = unbounded). ``guard`` defaults to ``UNSET``; otherwise a
    ``guard.GuardPolicy`` or ``None``. Use as a context manager;
    re-entering an already-active session raises.
    """

    def __init__(self, device: Any = UNSET,
                 gating_cache_size: Any = UNSET, guard: Any = UNSET):
        if device is not UNSET:
            _check_device(device)
        if guard is not UNSET:
            _check_guard(guard)
        self.device = device
        self.gating_cache_size = gating_cache_size
        self.guard = guard
        self._active = False
        self._prev_cache: Any = UNSET

    def __repr__(self) -> str:
        parts = [f"{f}={getattr(self, f)!r}" for f in _FIELDS
                 if getattr(self, f) is not UNSET]
        return f"SweepSession({', '.join(parts)})"

    def __enter__(self) -> "SweepSession":
        if self._active:
            raise RuntimeError("SweepSession is not re-entrant; "
                               "construct a new one per `with` block")
        _stack().append(self)
        self._active = True
        if self.gating_cache_size is not UNSET:
            from repro_torch.core import sa_gating
            self._prev_cache = sa_gating.set_gating_cache_size(
                self.gating_cache_size)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = _stack()
        if not self._active or stack[-1] is not self:
            raise RuntimeError(
                "SweepSession exited out of order (not the innermost "
                "active session)")
        if self._prev_cache is not UNSET:
            from repro_torch.core import sa_gating
            sa_gating.set_gating_cache_size(self._prev_cache)
            self._prev_cache = UNSET
        stack.pop()
        self._active = False


# -----------------------------------------------------------------------
# the session stack: [root, outer, ..., innermost]
# -----------------------------------------------------------------------

def _root() -> SweepSession:
    """The process-wide defaults layer (what ``set_root`` mutates). The
    gating-cache size stays UNSET here: sessions scope the LRU by save
    and restore, not by resolution."""
    s = SweepSession(device=None, guard=None)
    s._active = True  # the root never exits
    return s


_LOCAL = threading.local()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = [_ROOT]
        _LOCAL.stack = st
    return st


_ROOT = _root()


def resolve(field: str) -> Any:
    """Innermost non-UNSET value for ``field`` (walks the stack down to
    the root, which always holds a concrete value)."""
    if field not in _FIELDS:
        raise KeyError(f"unknown session field {field!r}; have {_FIELDS}")
    for layer in reversed(_stack()):
        v = getattr(layer, field)
        if v is not UNSET:
            return v
    return None  # gating_cache_size: the root holds UNSET by design


def current() -> dict:
    """Resolved view of the active session state (one value per field)."""
    return {f: resolve(f) for f in _FIELDS}


def set_root(**fields: Any) -> dict:
    """Mutate the root (process-default) layer; returns the previous
    root values. An active session that pins the same field still
    shadows the new root value until it exits."""
    prev = {}
    for name, value in fields.items():
        if name not in _FIELDS:
            raise KeyError(f"unknown session field {name!r}; "
                           f"have {_FIELDS}")
        if name == "device":
            _check_device(value)
        elif name == "guard":
            _check_guard(value)
        prev[name] = getattr(_ROOT, name)
        setattr(_ROOT, name, value)
    return prev
