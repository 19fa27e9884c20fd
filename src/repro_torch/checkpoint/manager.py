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

Leaves are stored whole (numpy ``.npy``); bf16, which numpy cannot hold,
is stored as float32 (exact) and the manifest keeps ``bfloat16``. Where
the reference takes a tree of shardings and places each leaf on a mesh
(elastic resharding), the port takes one ``device``: restoring onto a
mesh waits for the parallel slice (ROADMAP A9).
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


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A numpy copy of one leaf that the caller's later in-place updates
    cannot reach, and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
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
        """Snapshot now, write in background (unless blocking)."""
        self.wait()
        host_leaves = [(key, *_to_host(leaf)) for key, leaf in
                       _flatten(state)]
        extras = dict(extras or {})

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
                device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``target_tree``. A tensor leaf
        lands on ``device`` (default: the target leaf's) in the target
        leaf's dtype, with its ``requires_grad``; a numpy or scalar leaf
        comes back as a numpy array. Returns (state, extras)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}

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
            if isinstance(tgt, torch.Tensor):
                t = torch.from_numpy(arr).to(
                    device=tgt.device if device is None else device,
                    dtype=tgt.dtype)
                leaves.append(t.requires_grad_(tgt.requires_grad))
            else:
                leaves.append(arr)
        state = _unflatten(target_tree, iter(leaves))
        return state, manifest.get("extras", {})
