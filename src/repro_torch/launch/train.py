"""Fault-tolerant training driver.

The JAX package's ``repro.launch.train`` in PyTorch's idiom:

* **Checkpoint/restart** — async ``CheckpointManager`` with atomic
  publish; on start, resumes from the latest step (the data pipeline's
  state rides in the manifest, so the token stream continues
  bit-exactly, and the step is deterministic on a device — B9 and every
  sum of the port's own in a fixed order — so the resumed losses equal an
  uninterrupted run's bit for bit).
* **Straggler mitigation** — a per-step wall-time EWMA; a step slower
  than ``straggler_factor`` x EWMA is logged and counted.
* **Failure injection** — ``--fail-at-step N`` raises mid-run; rerunning
  the same command resumes from the last checkpoint.

Runs on the card unless ``--device`` (``TrainLoopConfig.device``) says
otherwise: there every attention layer (causal, sliding-window, prefix-LM
or bidirectional, and multi-head latent attention at q/k head dim 192
with v 128) is kernel B3 forward and kernel B9 backward, and every SSD
layer kernel B5 forward and kernel B10 backward -- every family: dense,
SSD, hybrid, vision, audio and MoE (the dispatch and its backward plain
PyTorch, the same bits run to run). The reduced deepseek's MLA head dims
(24, 16) are not among B9's, so it trains on the CPU; its published
widths hold 236 B parameters, more than one card (``chip_smoke.py``
trains them cut to 3 layers and 16 routed experts through this loop's
pieces).
* **Sharding** -- ``--rules`` names one of the JAX package's rule
  variants (``parallel.sharding.RULE_VARIANTS``: baseline, seq_parallel,
  kv_seq, moe_replicated); without a mesh a variant changes nothing, as
  in the reference. ``--mesh`` (``1x1``, ``data=2,model=1``, ...) trains
  on a ``DeviceMesh``: the state's leaves are DTensors placed by the
  rules, every rank holds its shards, the batch is sharded over
  ``data``, the MoE layers dispatch as the reference's do on a mesh --
  the whole group's capacity and drops, as on one device
  (``blocks._moe_gspmd``; ``blocks.MOE_SHARD_MAP`` on, which no flag
  sets, takes the per-shard ``_moe_smap``) -- and a checkpoint restores
  onto whatever mesh the run has (elastic resharding). A one-device
  mesh needs no launcher (the run makes its own one-rank process
  group); a larger one runs under ``torchrun`` (or
  any launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT``), one process per device.

Run (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen2.5-3b --steps 20 --ckpt-dir /tmp/ckpt --checkpoint-every 5
Run (the card, full width):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --full --seq-len 2048 --global-batch 2 --microbatches 2 --steps 4
  (also --arch mamba2-780m; hymba-1.5b with --seq-len 4096, past its
  window of 2 048; paligemma-3b, whose --seq-len counts its 256 image
  patches; hubert-xlarge with --seq-len 1500 frames --global-batch 4;
  granite-moe-1b-a400m)
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_arch
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.models import registry
from repro_torch.models.param import init_params, train_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.dist import (make_mesh, parse_mesh,
                                       single_process_world, use_mesh)
from repro_torch.parallel.sharding import RULE_VARIANTS, use_rules
from repro_torch.train.steps import (TrainState, make_train_step,
                                     place_batch, place_state)

RULES = tuple(RULE_VARIANTS)


@dataclass
class TrainLoopConfig:
    arch: str = "qwen2.5-3b"
    reduced: bool = True
    steps: int = 20
    seq_len: int = 64
    global_batch: int = 8
    microbatches: int = 1
    ckpt_dir: str = ""
    checkpoint_every: int = 10
    keep: int = 3
    seed: int = 0
    lr: float = 3e-4
    straggler_factor: float = 2.0
    fail_at_step: int = -1
    grad_compression: str | None = None
    rules: str = "baseline"
    #: a mesh to train on (``parallel.dist.parse_mesh``), or "" for none
    mesh: str = ""
    log_every: int = 1
    #: where the run's state and batches live: the card unless told
    #: otherwise
    device: str = "cuda"


def run(cfg_loop: TrainLoopConfig,
        on_step: Optional[Callable[[int, dict, float], None]] = None
        ) -> dict:
    """Train ``cfg_loop.steps`` steps (from the latest checkpoint, if
    any). ``on_step(step, metrics, seconds)``, if given, is called after
    each step (its metrics are 0-d tensors). Returns ``{"losses",
    "stragglers", "final_loss", "step_s"}``."""
    if cfg_loop.rules not in RULES:
        raise ValueError(f"rules {cfg_loop.rules!r}: want one of {RULES}")
    device = torch.device(cfg_loop.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device "
                           "cpu) to train on the CPU")
    if not cfg_loop.mesh:
        with use_rules(RULE_VARIANTS[cfg_loop.rules]):
            return _run(cfg_loop, on_step, device, None)
    shape, axes = parse_mesh(cfg_loop.mesh)
    with _world(math.prod(shape), device.type):
        mesh = make_mesh(shape, axes, device.type)
        with use_mesh(mesh), use_rules(RULE_VARIANTS[cfg_loop.rules]):
            return _run(cfg_loop, on_step, device, mesh)


@contextlib.contextmanager
def _world(n: int, device_type: str):
    """The process group a mesh of ``n`` devices needs: the existing one,
    a one-rank group of this process for ``n == 1``, or one made from the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ...)."""
    if dist.is_initialized() or n == 1:
        with single_process_world(device_type):
            yield
        return
    if int(os.environ.get("WORLD_SIZE", "1")) != n:
        raise RuntimeError(f"a mesh of {n} devices needs {n} processes: "
                           f"run under torchrun --nproc-per-node {n}")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    try:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        yield
    finally:
        dist.destroy_process_group()


def _run(cfg_loop: TrainLoopConfig, on_step, device, mesh) -> dict:
    """``run``'s loop, on ``mesh`` when one is given (the mesh and the
    rules are current)."""
    from repro_torch.parallel.sharding import current_rules
    rules = current_rules()
    arch = get_arch(cfg_loop.arch)
    cfg = arch.reduced() if cfg_loop.reduced else arch
    shape = ShapeConfig("train_custom", cfg_loop.seq_len,
                        cfg_loop.global_batch, "train")
    opt = AdamWConfig(lr_peak=cfg_loop.lr, warmup_steps=2,
                      total_steps=max(10, cfg_loop.steps))
    data = SyntheticDataset(cfg, shape, seed=cfg_loop.seed, device=device)
    step_fn = make_train_step(
        cfg, opt, microbatches=cfg_loop.microbatches,
        grad_compression=cfg_loop.grad_compression)

    ckpt = CheckpointManager(cfg_loop.ckpt_dir, keep=cfg_loop.keep) \
        if cfg_loop.ckpt_dir else None

    gen = torch.Generator(device=device).manual_seed(cfg_loop.seed)
    params = train_params(init_params(registry.param_specs(cfg), gen,
                                      device))
    state = TrainState.create(params, opt,
                              grad_compression=cfg_loop.grad_compression)
    if mesh is not None:
        state = place_state(state, cfg, rules, mesh)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, extras = ckpt.restore(state)
        start_step = int(extras.get("data_state", {}).get("step", 0))
        print(f"[train] resumed from checkpoint step {start_step}")

    ewma = None
    stragglers = 0
    losses, step_s = [], []
    try:
        for step in range(start_step, cfg_loop.steps):
            if step == cfg_loop.fail_at_step:
                raise RuntimeError(f"[train] injected failure at step {step}")
            t0 = time.time()
            batch = data.batch(step)
            if mesh is not None:
                batch = place_batch(batch, rules, mesh,
                                    cfg_loop.microbatches)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            if ewma is None:
                ewma = dt
            if dt > cfg_loop.straggler_factor * ewma and step > start_step:
                stragglers += 1
                print(f"[train] step {step}: STRAGGLER {dt:.3f}s "
                      f"(ewma {ewma:.3f}s) — deterministic batch would be "
                      f"re-issued on a spare")
            ewma = 0.9 * ewma + 0.1 * dt
            losses.append(loss)
            step_s.append(dt)
            if on_step is not None:
                on_step(step, metrics, dt)
            if step % cfg_loop.log_every == 0:
                print(f"[train] step {step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            if (ckpt is not None and cfg_loop.checkpoint_every > 0
                    and (step + 1) % cfg_loop.checkpoint_every == 0):
                ckpt.save(step + 1, state,
                          extras={"data_state": data.state(step + 1),
                                  "arch": cfg.name})
    except BaseException:
        # a save issued before the failure is published before the caller
        # can resume from the directory, and leaves no writer behind
        if ckpt is not None:
            ckpt.wait()
        raise
    if ckpt is not None:
        ckpt.save(cfg_loop.steps, state,
                  extras={"data_state": data.state(cfg_loop.steps),
                          "arch": cfg.name}, blocking=True)
    return {"losses": losses, "stragglers": stragglers,
            "final_loss": losses[-1] if losses else None, "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    for f in ("arch", "ckpt_dir", "grad_compression", "rules", "device",
              "mesh"):
        ap.add_argument(f"--{f.replace('_', '-')}", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    for f in ("steps", "seq_len", "global_batch", "microbatches",
              "checkpoint_every", "seed", "fail_at_step", "log_every"):
        ap.add_argument(f"--{f.replace('_', '-')}", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = TrainLoopConfig()
    for k, v in vars(args).items():
        if v is not None:
            setattr(cfg, k, v)
    out = run(cfg)
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"stragglers={out['stragglers']}")


if __name__ == "__main__":
    main()
