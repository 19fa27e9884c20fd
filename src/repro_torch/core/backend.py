"""The array substrate of the batched sweep plane: float64 / int64
PyTorch tensors on one device.

``TorchBackend(device)`` is what ``policies._sweep_kernel`` computes
on. Its contract:

* ``asarray`` / ``to_numpy`` — transfer in and out with the dtype
  discipline of the sweep (float32 widens to float64, integers to
  int64, bool stays bool);
* ``segment_sum(data, seg_ids, num_segments, starts=None)`` — sorted-id
  segmented sum over the last axis, any leading batch axes, fixed add
  order (``repro_torch.kernels.segment_sum``);
* ``segment_starts`` — the range bounds of a sorted id vector, computed
  once per vector and handed back to ``segment_sum``;
* ``sa_occupancy(...)`` — the SA PE-occupancy pass with the unique
  widths as a batch axis (``repro_torch.kernels.sa_occupancy``);
* ``block()`` — wait for the device, so wall-clock timings are honest;
* ``mesh_axis_sizes(mesh)``, ``psum(t, mesh, axis)``,
  ``all_gather(tree, mesh, axis)`` — the collective surface of the
  sharded sweep (the JAX package's ``shard_map`` contract): an
  all-reduce over one dim's process group, and a gather of every rank's
  leading-axis shard in rank order (``all_gather(..., tiled=True)``).
  ``TorchBackend.collectives`` counts the collectives this process
  issued, which the guard compares across ranks.

The device alone selects the route: on a CUDA device both passes launch
the hand-written kernels, on the CPU they evaluate the kernels' plain
versions. There is no other switch.

Ragged gap merging (``opgen.segmented_gaps``) has data-dependent shapes;
``gap_index`` builds the equivalent fixed-shape structure on the host
once per stack — each op is assigned the id of the idle-gap chunk that
owns it, so the gap *values* become a plain ``segment_sum`` over per-op
idle time and the per-knob threshold masking keeps one shape for the
whole knob batch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import session
# the modules, not their functions: kernels.sa_occupancy imports
# core.sa_gating, so either package may be the first one imported
from repro_torch.kernels import sa_occupancy as _k1
from repro_torch.kernels import segment_sum as _k2


class TorchBackend:
    """Float64 tensors on ``device`` (``"cuda"``, ``"cuda:1"``, ``"cpu"``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(self.device)!r} requested but "
                f"torch.cuda.is_available() is False; pass device='cpu' "
                f"to run the kernels' plain versions on the host")
        self.name = f"torch-{self.device}"

    def asarray(self, x) -> torch.Tensor:
        a = np.asarray(x)
        if a.dtype.kind == "f":
            a = a.astype(np.float64)
        elif a.dtype.kind in "iu":
            a = a.astype(np.int64)
        elif a.dtype.kind != "b":
            raise TypeError(f"unsupported dtype {a.dtype} for the sweep "
                            f"substrate")
        return torch.tensor(a, device=self.device)

    @staticmethod
    def to_numpy(x: torch.Tensor) -> np.ndarray:
        return x.detach().cpu().numpy()

    @staticmethod
    def segment_sum(data, seg_ids, num_segments: int, starts=None):
        return _k2.segment_sum(data, seg_ids, num_segments, starts)

    @staticmethod
    def segment_starts(seg_ids, num_segments: int):
        return _k2.segment_starts(seg_ids, num_segments)

    @staticmethod
    def sa_occupancy(mm_m, mm_k, mm_n, saw, weight_load_cycles=None):
        return _k1.sa_occupancy(mm_m, mm_k, mm_n, saw, weight_load_cycles)

    def block(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the collectives of the sharded sweep -----------------------------
    collectives = 0  # issued by this process, over every mesh

    @staticmethod
    def mesh_axis_sizes(mesh) -> dict[str, int]:
        from repro_torch.parallel.dist import mesh_axis_sizes
        return mesh_axis_sizes(mesh)

    @staticmethod
    def psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
        """The sum of every rank's ``t`` over the mesh dim ``axis``, on
        every rank of it (in place: ``t`` is this call's own)."""
        import torch.distributed as dist
        t = t.contiguous()
        dist.all_reduce(t, group=mesh.get_group(axis))
        TorchBackend.collectives += 1
        return t

    @staticmethod
    def all_gather(tree, mesh, axis: str):
        """Every rank's leading-axis shard of each tensor of ``tree`` (a
        tensor or nested dicts of them, the same structure and shapes on
        every rank), concatenated along dim 0 in the rank order of the
        mesh dim ``axis``. The leaves are packed into one buffer per
        dtype, so a tree costs one collective per dtype."""
        import torch.distributed as dist
        group = mesh.get_group(axis)
        n = dist.get_world_size(group)
        leaves: list[torch.Tensor] = []
        _leaves(tree, leaves)
        out: list = [None] * len(leaves)
        by_dtype: dict = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = [leaves[i].reshape(leaves[i].shape[0],
                                      math.prod(leaves[i].shape[1:]))
                    for i in idx]
            widths = [f.shape[1] for f in flat]
            buf = torch.cat(flat, dim=1).contiguous()
            parts = [torch.empty_like(buf) for _ in range(n)]
            dist.all_gather(parts, buf, group=group)
            TorchBackend.collectives += 1
            full = torch.cat(parts, dim=0)
            for i, piece in zip(idx, torch.split(full, widths, dim=1)):
                shape = leaves[i].shape
                out[i] = piece.contiguous().reshape(
                    n * shape[0], *shape[1:])
        return _rebuild(tree, iter(out))


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    else:
        if tree.dim() == 0:
            raise ValueError("all_gather: a 0-d tensor has no shard axis")
        out.append(tree)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return next(it)


_BACKENDS: dict[str, TorchBackend] = {}


def resolve_device(device=None):
    """``device`` as every entry point reads it: ``None`` resolves
    through the active ``SweepSession`` and, with nothing set there,
    means ``"cuda"``."""
    if device is None:
        device = session.resolve("device")
    return "cuda" if device is None else device


def get_backend(device=None) -> TorchBackend:
    """The backend for ``device`` (``resolve_device``) — a CUDA device
    raises on a machine with no card."""
    key = str(torch.device(resolve_device(device)))
    bk = _BACKENDS.get(key)
    if bk is None:
        bk = _BACKENDS[key] = TorchBackend(key)
    return bk


def failover_rungs(device=None, mesh=None) \
        -> tuple[tuple[str, object], ...]:
    """The guard plane's downgrade ladder for a requested (device, mesh):
    each rung is ``(rung_name, mesh)``. A mesh (``mesh``, or with
    ``None`` the session's, consulted unless the device is ``"numpy"``)
    puts the rung ``("mesh", mesh)`` first: the sharded sweep on the
    requested device, every rank its shard. A CUDA device's ladder then
    holds that device alone: a campaign asked of the card runs on the
    card -- sharded, then unsharded on each rank's own card -- or raises
    ``guard.GuardError``, and never moves to the kernels' plain versions
    on the host. A ``"cpu"`` request falls from ``"cpu"`` (the same
    ``_sweep_kernel`` on the plain versions) to ``"numpy"``
    (``policies.evaluate_batch_numpy``, the independent engine); a
    ``"numpy"`` request has nowhere to fall, so its ladder is just
    itself. ``None`` resolves as in ``get_backend``
    (``resolve_device``)."""
    device = resolve_device(device)
    if device == "numpy":
        return (("numpy", None),)
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise KeyError(f"no failover ladder for device {str(dev)!r}; the "
                       f"port runs on 'cuda', 'cpu' or 'numpy'")
    if mesh is None:
        mesh = session.resolve("mesh")
    head = (("mesh", mesh),) if mesh is not None else ()
    if dev.type == "cuda":
        return head + ((str(dev), None),)
    return head + (("cpu", None), ("numpy", None))


# --------------------------------------------------------------------------
# fixed-shape gap indexing (host-side; replaces data-dependent reduceat)
# --------------------------------------------------------------------------

def gap_index(active: np.ndarray, offsets: np.ndarray) \
        -> tuple[np.ndarray, np.ndarray]:
    """Fixed-shape equivalent of ``opgen.segmented_gaps``'s chunking.

    Returns ``(chunk_of_op, gap_seg)``: each op's owning idle-gap chunk
    id (N,), and each chunk's segment id (G,). Chunks are delimited
    exactly like ``segmented_gaps`` — a bound after every active op and
    at every segment start, so idle runs never merge across workload
    boundaries and empty segments own zero chunks. With this index the
    per-chunk gap values are ``segment_sum(idle, chunk_of_op, G)`` and
    per-(segment, knob) masked merges are ``segment_sum`` over
    ``gap_seg``.

    Depends only on the activity *pattern* (which ops use the
    component), not on service times, so one index per (stack,
    component) serves every NPU generation.
    """
    offsets = np.asarray(offsets, np.int64)
    n_seg = len(offsets) - 1
    idx = np.flatnonzero(active)
    bounds = np.union1d(offsets[:-1], idx + 1)
    if bounds.size == 0:  # no ops and no segments
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    n = len(active)
    chunk_of_op = np.searchsorted(bounds, np.arange(n), side="right") - 1
    gap_seg = np.minimum(np.searchsorted(offsets, bounds, side="right") - 1,
                         max(n_seg - 1, 0))
    return chunk_of_op.astype(np.int64), gap_seg.astype(np.int64)
