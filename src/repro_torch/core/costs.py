"""What one step of the port costs a device, counted as the port runs it:
the counterpart of the JAX package's ``core/hlo.py``, which reads the
same quantities off XLA's compiled text.

``CostCounter`` is a ``TorchDispatchMode``. Under a mesh it sees the local
ops DTensor runs on each device's shards (it declines the DTensor-level
call, so DTensor unwraps it and dispatches the shard's ops through the
mode), and it skips the fake ops DTensor's sharding propagation runs on
global shapes. Per device it counts:

* ``flops`` -- dot FLOPs: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and
  convolutions, 2 x output elements x contracted length;
* ``memory_bytes`` -- input plus output bytes of every eager op that is
  not a view, on the local shard. This is what the unfused port really
  moves, op by op; it is NOT XLA's fusion-level estimate that
  ``hlo.analyze`` makes (a fused elementwise chain there is charged its
  output once, here every op of it its operands and result);
* ``collective_bytes`` -- operand bytes of each ``c10d_functional``
  collective, by type under ``hlo.COLLECTIVES``' names;
* ``dots`` -- the number of dot ops.

A hand-written kernel is invisible to a dispatch mode (a ctypes launch),
so every wrapper of one (B2, B3, B4, B5, B9, B10) reports its own formula
through ``kernel(name, flops, nbytes)`` -- live score pairs for the
attention kernels, the chunk scan for the SSD ones -- and the ops inside
that block (a plain version's, or the wrapper's own allocations) are not
counted. Where the model runs a kernel's plain form instead (a CPU
tensor), it calls it through ``as_kernel``, which counts the kernel's
formula in its place, and the backward kernel's for the backward through
it. A step therefore counts the same on the CPU (plain forms), under
fake tensors (the wrappers return shaped outputs, no launch) and on the
card (kernels), and the counter changes nothing of what runs.

With ``track_memory`` the counter also follows every storage the step
allocates (local shards, fake or real) and keeps the peak of the live
bytes, ``peak_bytes``, over ``base_bytes`` of tensors made before it
(``track``).
"""
from __future__ import annotations

import contextlib
import functools
import math
import weakref
from dataclasses import dataclass, field
from typing import Iterable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
        _aten.baddbmm.default, _aten.convolution.default}
#: allocate without writing: no bytes moved
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}
_COLLECTIVE_OF = (("all_gather", "all-gather"),
                  ("reduce_scatter", "reduce-scatter"),
                  ("all_reduce", "all-reduce"),
                  ("all_to_all", "all-to-all"),
                  ("broadcast", "collective-permute"),
                  ("permute", "collective-permute"))


@dataclass
class HloCosts:
    """Per-device costs of a step (``hlo.HloCosts``' fields)."""
    flops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: dict = field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    dots: int = 0
    #: the FLOPs the hand kernels' formulas reported, and how many times
    #: each kernel was called
    kernel_flops: float = 0.0
    kernels: dict = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree) -> list:
    """The tensors among an op's arguments or results (flat, or in one
    level of lists and tuples, as aten's schemas have them)."""
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(func, args, out) -> float:
    """2 x output elements x contracted length of a dot op."""
    if func is _aten.convolution.default:
        # (input, weight, ...): each output element sums C_in / groups x
        # the kernel window's products, the weight's dims past the first
        return 2.0 * out.numel() * math.prod(args[1].shape[1:])
    if func is _aten.mm.default:
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2.0 * m * n * k
    if func is _aten.addmm.default:
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2.0 * m * n * k
    if func is _aten.bmm.default:
        (b, m, k), n = args[0].shape, args[1].shape[2]
        return 2.0 * b * m * n * k
    (b, m, k), n = args[1].shape, args[2].shape[2]  # baddbmm
    return 2.0 * b * m * n * k


_ACTIVE: list = []


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


@contextlib.contextmanager
def kernel(name: str, flops: float, nbytes: float):
    """A hand kernel's call: its formula's ``flops`` and ``nbytes`` go to
    the active counter (unless an enclosing kernel already counted this
    work), and the ops inside the block are not counted."""
    c = _ACTIVE[-1] if _ACTIVE else None
    if c is not None and c.counting():
        c.add_kernel(name, flops, nbytes)
    with uncounted():
        yield


def as_kernel(name: str, cost, fn, args: tuple, backward=None):
    """``fn(*args)``, a hand kernel's plain form run where the kernel is
    not (a CPU tensor), counted as the kernel: the active counter adds
    ``cost()``, the kernel's ``(flops, bytes)``, under ``name`` and none
    of the ops inside. ``backward = (name, cost)``: the ops of the
    backward through the call are not counted either, and the backward
    kernel's formula is added once when the backward reaches it. Without
    a counter this is ``fn(*args)``."""
    c = _ACTIVE[-1] if _ACTIVE else None
    if c is None or not c.counting():
        return fn(*args)
    with kernel(name, *cost()):
        out = fn(*args)
    if backward is not None:
        c.quiet_backward(out, args, *backward)
    return out


def counted(name: str, cost):
    """Decorator of a hand kernel's wrapper: while a counter is active
    each call is a ``kernel(name, *cost(*args, **kwargs))`` block."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            with kernel(name, *cost(*args, **kwargs)):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def uncounted():
    """Ops inside the block are not counted (a formula's own arithmetic);
    their outputs are still tracked."""
    c = _ACTIVE[-1] if _ACTIVE else None
    if c is None:
        yield
        return
    c._suspend += 1
    try:
        yield
    finally:
        c._suspend -= 1


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (no data: a dry run's)."""
    return isinstance(t, FakeTensor)


def _propagating(counter: "CostCounter", meta_fn):
    """DTensor's sharding propagator's output-metadata pass, wrapped: the
    fake ops it runs on global shapes inside are neither counted nor
    tracked."""
    @functools.wraps(meta_fn)
    def wrapper(*args, **kwargs):
        counter._prop += 1
        try:
            return meta_fn(*args, **kwargs)
        finally:
            counter._prop -= 1
    return wrapper


class CostCounter(TorchDispatchMode):
    """Counts a step's per-device costs (``costs``) and, with
    ``track_memory``, the peak of its live local bytes (``peak_bytes``).
    Use as a context manager around the step."""

    def __init__(self, track_memory: bool = True):
        super().__init__()
        self.costs = HloCosts()
        self.track_memory = track_memory
        self._suspend = 0
        self._prop = 0
        #: autograd nodes whose backward ops a formula counts
        self._quiet: set = set()
        self._live: dict = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.base_bytes = 0

    def counting(self) -> bool:
        return self._suspend == 0 and self._prop == 0

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand kernel, counted by its formula."""
        c = self.costs
        c.flops += float(flops)
        c.memory_bytes += float(nbytes)
        c.kernel_flops += float(flops)
        c.kernels[name] = c.kernels.get(name, 0) + 1

    def quiet_backward(self, out, inputs, name: str, cost) -> None:
        """The backward through a plain form (``as_kernel``): the autograd
        nodes between ``out`` and ``inputs`` run uncounted, and ``cost()``
        is counted once as kernel ``name`` when the first of them runs."""
        outs = [t for t in _tensors(out if isinstance(out, (list, tuple))
                                    else (out,)) if t.grad_fn is not None]
        if not outs:
            return
        stop = {t.grad_fn for t in _tensors(inputs)}
        todo = [t.grad_fn for t in outs]
        while todo:
            n = todo.pop()
            if n is None or n in stop or n in self._quiet \
                    or type(n).__name__ == "AccumulateGrad":
                continue
            self._quiet.add(n)
            todo.extend(f for f, _ in n.next_functions)
        flops, nbytes = cost()
        done = []

        def first(_grads):
            if not done:
                done.append(True)
                self.add_kernel(name, flops, nbytes)
        for t in outs:
            t.grad_fn.register_prehook(first)

    # ---------------------------------------------------------- memory
    def track(self, tensors: Iterable) -> int:
        """Count ``tensors`` (plain or DTensor: their local shards) as
        live from now on, each storage once. Returns the bytes added."""
        added = 0
        for t in tensors:
            added += self._hold(t)
        self.base_bytes += added
        return added

    def _hold(self, t) -> int:
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor):
            return 0
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return 0
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)
        return n

    def _release(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -------------------------------------------------------- dispatch
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        self._saved_meta = SP._propagate_tensor_meta_non_cached
        SP._propagate_tensor_meta_non_cached = _propagating(
            self, self._saved_meta)
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            SP._propagate_tensor_meta_non_cached = self._saved_meta

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":  # metadata queries: no work
            return func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        if any(type(t) is _dtensor_type() for t in ins):
            return NotImplemented  # DTensor unwraps; its local ops come back
        out = func(*args, **kwargs)
        if self._prop:
            return out
        if self._suspend == 0 and not (
                self._quiet
                and torch._C._current_autograd_node() in self._quiet):
            self._count(func, args, ins, out)
        if self.track_memory:
            for t in _tensors(out if isinstance(out, (list, tuple))
                              else (out,)):
                self._hold(t)
        return out

    def _count(self, func, args, ins, out) -> None:
        c = self.costs
        name = func.name()
        if name.startswith("_c10d_functional") \
                or name.startswith("c10d_functional"):
            for key, kind in _COLLECTIVE_OF:
                if key in name:
                    c.collective_bytes[kind] += sum(_nbytes(t) for t in ins)
                    break
            return
        if func in DOTS:
            c.dots += 1
            c.flops += dot_flops(func, args, out)
        if func.is_view or func in _NO_TRAFFIC:
            return
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        c.memory_bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
