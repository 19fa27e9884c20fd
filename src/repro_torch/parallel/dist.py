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
* ``local_map(fn, args, in_placements, out_placements)`` -- ``fn`` on the
  local shards of DTensor arguments placed as asked, its outputs wrapped
  back as DTensors (``shard_map``'s counterpart; a ctypes kernel launch
  takes plain tensors).
"""
from __future__ import annotations

import contextlib
import contextvars
import sys
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group's ranks (row-major, as ``jax.make_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in rank")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


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
