"""Serve steps: the prefill and decode step functions a server calls.

The JAX package's ``make_train_step`` (microbatched gradients, gradient
compression, AdamW) is the training slice and waits for ROADMAP A8.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def make_serve_step(cfg: ArchConfig, *, dtype=torch.bfloat16) -> Callable:
    """Returns serve_step(params, cache, batch) -> (logits, cache); the
    cache is updated in place (``model.decode_step``)."""

    def serve_step(params, cache, batch):
        return M.decode_step(params, cache, batch, cfg, dtype=dtype)

    return serve_step


def make_prefill_step(cfg: ArchConfig, *, dtype=torch.bfloat16) -> Callable:
    """Returns prefill_step(params, batch, cache=None) -> (last_logits,
    cache) (``model.prefill_step``)."""

    def prefill_step(params, batch, cache=None):
        return M.prefill_step(params, batch, cfg, dtype=dtype, cache=cache)

    return prefill_step
