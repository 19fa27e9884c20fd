"""Device meshes and process groups: the port's counterpart of the JAX
package's ``parallel/jax_compat.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims
(``"data"``, ``"model"``, and ``"pod"`` across pods); sharded tensors are
``DTensor``s on it. Everything the model, the launchers and the dry run
need from that surface goes through this module:

* ``make_mesh(shape, axes, device_type)`` -- ``init_device_mesh`` over
  the world's ranks (a default process group must exist:
  ``single_process_world`` or ``fake_world`` make one);
* ``use_mesh(mesh)`` / ``current_mesh()`` -- the mesh that sharding
  constraints (``sharding.constrain``) and the shard-local kernel calls
  act on, ``None`` when unset (single device: every constraint is a
  no-op, as in the JAX package without a mesh);
* ``mesh_axis_sizes(mesh)`` -- ``{axis: size}``;
* ``fake_world(n)`` -- a process group of ``n`` ranks that moves no data
  (``torch.testing``'s fake backend, this process as rank 0), for dry
  runs under fake tensors;
* ``single_process_world(device_type)`` -- a real one-rank group, for a
  ``(1, 1)`` mesh without a launcher;
* ``spmd_world(rank, world_size, init_method, device_type)`` -- this
  process as one rank of a real world: NCCL where every rank has a card
  of its own, gloo otherwise -- on the CPU, and where ranks share a card
  (NCCL refuses two ranks on one GPU; gloo reduces and gathers CUDA
  tensors through the host);
* ``sweep_mesh(wl, knob, device_type)`` -- the power plane's mesh
  (``jax_compat.sweep_mesh``'s counterpart): ``("wl",)`` when only the
  op axis is split, ``("wl", "knob")`` otherwise;
* ``local_map(fn, args, in_placements, out_placements)`` -- ``fn`` on the
  local shards of DTensor arguments placed as asked, its outputs wrapped
  back as DTensors (``shard_map``'s counterpart; a ctypes kernel launch
  takes plain tensors);
* ``sum_over_groups(t, groups)`` -- inside such a region, the sum of
  every rank's plain ``t`` over process groups (a ``psum`` in a
  ``shard_map`` body).
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import sys
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda", *,
              timeout_s: Optional[float] = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group's ranks (row-major, as ``jax.make_mesh``);
    ``timeout_s`` as in ``sweep_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in rank")
    kw = {}
    if timeout_s is not None:
        kw["backend_override"] = {a: _group_options(timeout_s)
                                  for a in axes}
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes), **kw)


def sweep_mesh(wl: int = 1, knob: int = 1, *, device_type: str = "cuda",
               timeout_s: Optional[float] = None):
    """The power plane's mesh, dims named the way
    ``policies.evaluate_batch`` dispatches on them:

    * ``wl`` -- splits the stacked per-op axis (each rank sums its ops,
      a ``psum`` over the dim completes every op-axis sum);
    * ``knob`` -- splits the unique widths, the knob triples and the knob
      grid.

    ``("wl",)`` when ``knob == 1 and wl > 1``; ``("wl", "knob")``
    otherwise, the degenerate ``(1, 1)`` included. ``wl * knob`` ranks of
    the default process group, row-major. ``timeout_s``, where given, is
    each dim's process-group timeout: a collective that some rank never
    joins then raises after that long instead of waiting torch's default
    (30 minutes for gloo)."""
    if knob == 1 and wl > 1:
        shape, axes = (int(wl),), ("wl",)
    else:
        shape, axes = (int(wl), int(knob)), ("wl", "knob")
    return make_mesh(shape, axes, device_type, timeout_s=timeout_s)


def _group_options(timeout_s: float):
    """``init_device_mesh``'s per-dim override that gives a dim's group
    the default group's backend and ``timeout_s``."""
    backend = dist.get_backend()
    opts = dist.ProcessGroupNCCL.Options() if backend == "nccl" \
        else dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=float(timeout_s))
    return backend, opts


def parse_mesh(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """A mesh given on a command line: ``"2x1"`` (dims ``data``,
    ``model``; three numbers add ``pod`` in front) or ``"data=2,model=1"``.
    Returns ``(shape, axes)``."""
    text = text.strip()
    if "=" in text:
        pairs = [p.split("=") for p in text.split(",") if p]
        return (tuple(int(v) for _, v in pairs),
                tuple(k.strip() for k, _ in pairs))
    shape = tuple(int(v) for v in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}
    if len(shape) not in names:
        raise ValueError(f"mesh {text!r}: want 'DxM', 'PxDxM' or "
                         f"'data=D,model=M'")
    return shape, names[len(shape)]


_MESH: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh inside the block (``None``: none)."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    """The current mesh, or ``None`` when unset."""
    return _MESH.get()


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis_name: size}`` of a mesh (``{}`` for ``None``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks that communicates nothing,
    this process as rank 0, destroyed on exit. Collectives return their
    inputs' shapes without moving data: for dry runs under fake
    tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists already")
    dist.init_process_group("fake", store=FakeStore(), world_size=int(n),
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def single_process_world(device_type: str = "cuda"):
    """A real one-rank default process group (NCCL for ``"cuda"``, gloo
    otherwise) over an in-process store, destroyed on exit; an existing
    group is used as it is."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def world_backend(device_type: str, world_size: int) -> str:
    """The collective backend of a world of ``world_size`` ranks on
    ``device_type``: NCCL when each rank has a card of its own, gloo on
    the CPU and when ranks share a card."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@contextlib.contextmanager
def spmd_world(rank: int, world_size: int, init_method: str,
               device_type: str = "cuda", timeout_s: float = 300.0):
    """This process as rank ``rank`` of a ``world_size``-rank default
    process group at ``init_method`` (``"tcp://localhost:<port>"``),
    destroyed on exit. On ``"cuda"`` the rank's current device is card
    ``rank % device_count`` -- card 0 for every rank on a one-card
    machine -- set before the group exists, and the backend is
    ``world_backend``'s. ``timeout_s`` bounds every collective of the
    default group."""
    if dist.is_initialized():
        raise RuntimeError("a process group exists already")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        world_backend(device_type, world_size), init_method=init_method,
        rank=int(rank), world_size=int(world_size),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor. Cheap on the single-device path: a plain
    tensor is none, and none exists before DTensor's module is loaded."""
    if type(x) is torch.Tensor:
        return False
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_map(fn: Callable, args: Sequence, in_placements: Sequence,
              out_placements: Sequence, *, grad_placements=None):
    """Run ``fn`` on plain tensors: each DTensor argument redistributed to
    its ``in_placements`` entry and taken by its local shard (a ``None``
    entry: the argument is passed as it is), every tensor ``fn`` returns
    wrapped as a DTensor with the matching ``out_placements`` entry
    (``None``: returned as it is). ``grad_placements``, where given, is
    the placements each local shard's gradient takes (default: the
    argument's own). The result is differentiable; with no mesh in play
    (no DTensor argument) ``fn`` is called on the arguments directly."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    local = []
    for i, (a, pl) in enumerate(zip(args, in_placements)):
        if pl is None or not isinstance(a, DTensor):
            local.append(a)
            continue
        a = a.redistribute(mesh, tuple(pl))
        gp = None if grad_placements is None else grad_placements[i]
        local.append(a.to_local(grad_placements=None if gp is None
                                else tuple(gp)))
    out = fn(*local)
    single = not isinstance(out, (tuple, list))
    outs = (out,) if single else tuple(out)
    wrapped = tuple(
        o if pl is None or not isinstance(o, torch.Tensor)
        else DTensor.from_local(o, mesh, tuple(pl), run_check=False)
        for o, pl in zip(outs, out_placements))
    return wrapped[0] if single else wrapped


def sum_over_groups(t, groups: Sequence):
    """The sum of every rank's plain ``t`` over each process group of
    ``groups`` in turn: a functional all-reduce each (which the cost
    counter counts), not differentiable. Every rank of a group issues the
    same calls in the same order."""
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
    return t
