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
* ``block()`` — wait for the device, so wall-clock timings are honest.

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


def failover_rungs(device=None) -> tuple[tuple[str, object], ...]:
    """The guard plane's downgrade ladder for a requested device: each
    rung is ``(rung_name, None)`` (the second slot is where the JAX
    package's ladder carries a mesh; the port has none). A CUDA device's
    ladder is that device alone: a campaign asked of the card runs on the
    card or raises ``guard.GuardError``, and never moves to the kernels'
    plain versions on the host. A ``"cpu"`` request falls from ``"cpu"``
    (the same ``_sweep_kernel`` on the plain versions) to ``"numpy"``
    (``policies.evaluate_batch_numpy``, the independent engine); a
    ``"numpy"`` request has nowhere to fall, so its ladder is just
    itself. ``None`` resolves as in ``get_backend``
    (``resolve_device``)."""
    device = resolve_device(device)
    if device == "numpy":
        return (("numpy", None),)
    dev = torch.device(device)
    if dev.type == "cuda":
        return ((str(dev), None),)
    if dev.type == "cpu":
        return (("cpu", None), ("numpy", None))
    raise KeyError(f"no failover ladder for device {str(dev)!r}; the "
                   f"port runs on 'cuda', 'cpu' or 'numpy'")


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
