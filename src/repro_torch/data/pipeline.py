"""Deterministic, resumable synthetic token pipeline.

The JAX package's ``repro.data.pipeline`` in PyTorch's idiom. Every batch
is a pure function of (seed, step), drawn by the reference's own
``numpy.random.default_rng((seed, step))`` calls in its order, so the
numbers equal the reference's bit for bit (``arrays``); a resume needs
only the integer step from the checkpoint manifest, and a re-issued batch
is bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.specs import batch_specs, to_tensors


@dataclass
class SyntheticDataset:
    cfg: ArchConfig
    shape: ShapeConfig
    seed: int = 0
    batch_override: int | None = None
    #: where ``batch`` puts its tensors: the card unless told otherwise
    device: Any = "cuda"

    def arrays(self, step: int) -> dict:
        """The batch of ``step`` as numpy arrays: int32 tokens / labels
        (labels are the tokens shifted left, the last 0), float32
        embeddings."""
        rng = np.random.default_rng((self.seed, step))
        specs = batch_specs(self.cfg, self.shape, self.batch_override)
        out = {}
        # generate tokens FIRST so labels can be their shift
        order = sorted(specs, key=lambda k: (k != "tokens", k))
        tokens = None
        for name in order:
            s = specs[name]
            if name == "cache_len":
                out[name] = np.asarray(self.shape.seq_len // 2, np.int32)
            elif name == "tokens":
                tokens = rng.integers(0, self.cfg.vocab_size, size=s.shape,
                                      dtype=np.int32)
                out[name] = tokens
            elif name == "labels":
                if tokens is not None and tokens.shape == s.shape:
                    lbl = np.roll(tokens, -1, axis=-1)
                    lbl[..., -1] = 0
                else:
                    lbl = rng.integers(0, self.cfg.vocab_size, size=s.shape,
                                       dtype=np.int32)
                out[name] = lbl
            else:
                out[name] = rng.standard_normal(size=s.shape).astype(
                    np.float32)
        return out

    def batch(self, step: int, device=None) -> dict:
        """The batch of ``step`` as tensors on ``device`` (default: the
        dataset's): int64 tokens / labels, embeddings in the spec's
        dtype."""
        device = torch.device(self.device if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make the dataset with "
                               "device='cpu'")
        return to_tensors(self.arrays(step),
                          batch_specs(self.cfg, self.shape,
                                      self.batch_override), device)

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": step}
