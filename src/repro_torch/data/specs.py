"""Input specifications per (architecture x shape) cell.

The JAX package's ``repro.data.specs`` in PyTorch's idiom. ``batch_specs``
returns a ``TensorSpec`` (shape, dtype) — in place of
``jax.ShapeDtypeStruct`` — for every model input, allocating nothing;
``make_batch`` materializes the same structure with deterministic
synthetic data. The draws are the reference's, from the same
``numpy.random.default_rng`` calls in the same order, so the numbers are
equal bit for bit; as tensors, integer inputs are widened to int64, the
port's index dtype (the values are the same).

Modality frontends are stubs, as in the reference: audio cells feed
precomputed frame embeddings, vision cells precomputed patch embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


#: each input's logical axes for the sharding rules (the JAX package's
#: dry run's ``BATCH_AXES``)
BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "seq", None),
    "patches": ("batch", None, None),
    "cache_len": (),
}


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one input, allocating nothing. ``dtype`` is the
    reference's: torch.int32 for token-like inputs (materialized as
    int64 tensors, see the module docstring), torch.bfloat16 for
    embeddings."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                batch_override: int | None = None) -> dict:
    """Abstract input tree for train/prefill cells (decode: the new
    token and the cache length)."""
    B = batch_override if batch_override is not None else shape.global_batch
    S = shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), i32),
                "cache_len": TensorSpec((), i32)}
    if cfg.frontend == "audio":
        out = {"frames": TensorSpec((B, S, cfg.frontend_dim),
                                    torch.bfloat16)}
        if shape.kind == "train":
            out["labels"] = TensorSpec((B, S), i32)
        return out
    if cfg.frontend == "vision":
        text = S - cfg.frontend_seq
        out = {
            "patches": TensorSpec((B, cfg.frontend_seq, cfg.frontend_dim),
                                  torch.bfloat16),
            "tokens": TensorSpec((B, text), i32),
        }
        if shape.kind == "train":
            out["labels"] = TensorSpec((B, text), i32)
        return out
    out = {"tokens": TensorSpec((B, S), i32)}
    if shape.kind == "train":
        out["labels"] = TensorSpec((B, S), i32)
    return out


def make_batch(cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0,
               batch_override: int | None = None, device="cuda") -> dict:
    """Concrete synthetic batch matching ``batch_specs``, on ``device``
    (the card unless told otherwise)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the "
                           "batch on the CPU")
    rng = np.random.default_rng(seed)
    specs = batch_specs(cfg, shape, batch_override)
    out = {}
    for name, s in specs.items():
        if name == "cache_len":
            out[name] = np.asarray(shape.seq_len // 2, np.int32)
        elif s.dtype == torch.int32:
            hi = cfg.vocab_size if name in ("tokens", "labels") else 2
            out[name] = rng.integers(0, hi, size=s.shape, dtype=np.int32)
        else:
            out[name] = rng.standard_normal(size=s.shape).astype(np.float32)
    return to_tensors(out, specs, device)


def to_tensors(arrays: dict, specs: dict, device) -> dict:
    """Numpy inputs as tensors on ``device``: integer inputs int64, the
    others the spec's dtype."""
    out = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.array(a))
        dtype = torch.int64 if specs[name].dtype == torch.int32 \
            else specs[name].dtype
        out[name] = t.to(device=device, dtype=dtype)
    return out

