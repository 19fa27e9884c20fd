"""Fault-tolerant checkpointing: async save, atomic publish, restore.

The JAX package's ``repro.checkpoint.manager`` in PyTorch's idiom:

* **Atomicity** — a checkpoint is written into ``step_<N>.tmp`` and
  published with ``os.replace`` to ``step_<N>``; a crash mid-save never
  corrupts the latest restorable state. A ``manifest.json`` inside the
  step dir carries the step, the flattened key paths, dtypes and shapes,
  and the caller's extras (the data pipeline's state), and is written
  last.
* **Async** — ``save`` copies every leaf to host memory synchronously
  (``.cpu()`` of a copy, before the next step can change the leaf in
  place) and writes the files on a background thread, overlapping the
  next training step; ``wait`` joins before the next save, before a
  restore or at exit, and raises an error of the background write.
* **Retention** — keeps the newest ``keep`` checkpoints, deleting older
  ones only after a successful publish.
* **Restore** — into the structure of a target tree (nested dicts,
  lists, tuples and dataclasses such as ``TrainState``, with tensor,
  array or scalar leaves), checking every leaf's shape; each leaf lands
  on ``device`` (or the target leaf's device) in the target leaf's dtype,
  with its ``requires_grad``.
* **Elastic resharding** — a DTensor leaf is saved whole (its shards
  gathered; in a process group only rank 0 writes, and ``save`` is a
  collective every rank calls). On restore a leaf lands as a DTensor on
  ``mesh`` with its entry of ``placements`` (a tree of the target's
  structure), or, for a DTensor target leaf, on that leaf's own mesh and
  placements: each device keeps its slice of the leaf it read whole. A
  checkpoint saved on one mesh restores onto another, or onto one
  device.

Leaves are stored whole (numpy ``.npy``); bf16, which numpy cannot hold,
is stored as float32 (exact) and the manifest keeps ``bfloat16``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree, prefix: str = "") -> list:
    """``(key path, leaf)`` pairs; dict keys sorted, as the reference's
    ``jax.tree`` order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _flatten(getattr(tree, f.name), f"{prefix}{f.name}/")
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten(x, f"{prefix}{i}/")
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        vals = {f.name: _unflatten(getattr(tree, f.name), leaves)
                for f in dataclasses.fields(tree)}
        return dataclasses.replace(tree, **vals)
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def _flatten_placements(target, placements, prefix: str = "") -> list:
    """``(key path, placements)`` of a placements tree that mirrors
    ``target``'s structure down to its tensor leaves, where it holds a
    tuple of DTensor placements; ``_flatten``'s key paths."""
    if placements is None:
        return []
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return [kv for f in dataclasses.fields(target)
                for kv in _flatten_placements(
                    getattr(target, f.name), getattr(placements, f.name),
                    f"{prefix}{f.name}/")]
    if isinstance(target, dict):
        return [kv for k in sorted(target) for kv in _flatten_placements(
            target[k], placements.get(k), f"{prefix}{k}/")]
    if isinstance(target, (list, tuple)):
        return [kv for i, x in enumerate(target) for kv in
                _flatten_placements(x, placements[i], f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tuple(placements))]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A numpy copy of one leaf that the caller's later in-place updates
    cannot reach, and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(leaf, DTensor):  # a collective: every rank gathers
            leaf = leaf.detach().full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy(), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extras: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot now, write in background (unless blocking). In a
        process group every rank calls it (DTensor leaves are gathered)
        and rank 0 writes; a blocking save ends at a barrier, so that
        every rank may restore from it at once."""
        self.wait()
        host_leaves = [(key, *_to_host(leaf)) for key, leaf in
                       _flatten(state)]
        extras = dict(extras or {})
        if dist.is_initialized() and dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest = {"step": step, "extras": extras, "leaves": []}
                for i, (key, arr, dtype) in enumerate(host_leaves):
                    np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                    manifest["leaves"].append(
                        {"key": key, "file": f"leaf_{i}.npy",
                         "shape": list(arr.shape), "dtype": dtype})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced at next wait()
                self._error = e

        if blocking:
            _write()
            if dist.is_initialized():
                dist.barrier()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, step: Optional[int] = None,
                device=None, placements: Any = None,
                mesh=None) -> tuple[Any, dict]:
        """Restore into the structure of ``target_tree``. A tensor leaf
        lands on ``device`` (default: the target leaf's) in the target
        leaf's dtype, with its ``requires_grad``; a numpy or scalar leaf
        comes back as a numpy array. With ``placements`` (a tree of
        ``target_tree``'s structure, a tuple of DTensor placements at each
        tensor leaf) and ``mesh``, each leaf becomes a DTensor on
        ``mesh``; a DTensor target leaf without them keeps its own mesh
        and placements. Returns (state, extras)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}

        from torch.distributed.tensor import DTensor, distribute_tensor
        placed = dict(_flatten_placements(target_tree, placements))
        leaves = []
        for key, tgt in _flatten(target_tree):
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint {step} missing leaf {key!r}")
            arr = np.load(os.path.join(cdir, entry["file"]))
            if tuple(arr.shape) != tuple(np.shape(tgt)):
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != "
                    f"target {tuple(np.shape(tgt))}")
            pl, on = placed.get(key), mesh
            if pl is None and isinstance(tgt, DTensor):
                pl, on = tuple(tgt.placements), tgt.device_mesh
            if isinstance(tgt, torch.Tensor):
                dev = device if device is not None else (
                    on.device_type if pl is not None else tgt.device)
                t = torch.from_numpy(arr).to(device=dev, dtype=tgt.dtype)
                if pl is not None:
                    t = distribute_tensor(t, on, pl, src_data_rank=None)
                leaves.append(t.requires_grad_(tgt.requires_grad))
            else:
                leaves.append(arr)
        state = _unflatten(target_tree, iter(leaves))
        return state, manifest.get("extras", {})
