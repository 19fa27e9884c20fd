"""Sweep launcher: the paper suite × every NPU generation × every policy ×
a knob grid in one ``sweep_grid`` call, on one device or sharded over a
mesh of ``torch.distributed`` ranks.

    python -m repro_torch.launch.sweep [--device cpu] [--grid small]
    torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --mesh 1x2

``--mesh WLxKNOB`` is ``parallel.dist.sweep_mesh(WL, KNOB)``: ``WL``
ranks split the stacked op axis, ``KNOB`` the widths, triples and knobs.
Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank joins the world
(``parallel.dist.spmd_world``: NCCL where each rank has a card, gloo on
the CPU or where ranks share one), runs the same call and gets the whole
cube; a mesh of one rank needs no launcher. Rank 0 prints one JSON line
(cells, wall, the mesh, the world's backend, ReGate-Full's mean saving)
and, with ``--json PATH``, writes the cube's fields there as ``.npz``.
Runs on the card unless ``--device cpu``, as every entry point does.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

# §6.5's sensitivity grid (240 knobs) × SA width × detection window: the
# 3 600 knobs of chip_smoke.py's sweep_full
GRIDS = {
    "full": dict(delay_scale=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
                 leak_off_logic=(0.01, 0.03, 0.1, 0.2, 0.4),
                 leak_sram_sleep=(0.1, 0.25, 0.4, 0.6),
                 leak_sram_off=(0.002, 0.02),
                 sa_width=(None, 32, 64, 128, 256),
                 window_scale=(0.5, 1.0, 2.0)),
    "small": dict(delay_scale=(0.5, 1.0, 2.0), sa_width=(None, 256)),
}


def parse_sweep_mesh(text: str) -> tuple[int, int]:
    """``"WLxKNOB"`` (``"1x2"``, ``"2x1"``) as ``(wl, knob)``."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                  for p in parts):
        raise ValueError(f"mesh {text!r}: want 'WLxKNOB', e.g. '1x2'")
    return int(parts[0]), int(parts[1])


def main(argv=None) -> dict:
    from repro_torch.core.backend import resolve_device
    from repro_torch.core.hw import NPUS
    from repro_torch.core.opgen import paper_suite
    from repro_torch.core.policies import POLICIES
    from repro_torch.core.sweep import sweep_grid
    from repro_torch.parallel.dist import (single_process_world, spmd_world,
                                           sweep_mesh)
    import torch.distributed as dist
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' (the kernels' plain "
                         "versions)")
    ap.add_argument("--mesh", default=None, metavar="WLxKNOB",
                    help="shard the sweep over a sweep_mesh(WL, KNOB)")
    ap.add_argument("--grid", choices=sorted(GRIDS), default="full")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="rank 0 writes the cube's fields to PATH (.npz)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    dev_type = torch.device(device).type
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    shape = parse_sweep_mesh(args.mesh) if args.mesh else None
    if world > 1 and (shape is None or shape[0] * shape[1] != world):
        raise SystemExit(f"{world} ranks: pass --mesh WLxKNOB with WL * "
                         f"KNOB = {world}")
    if world > 1:
        ctx = spmd_world(rank, world, "env://", dev_type)
    elif shape is not None:
        ctx = single_process_world(dev_type)
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        mesh = None if shape is None else sweep_mesh(*shape,
                                                     device_type=dev_type)
        backend = dist.get_backend() if mesh is not None else None
        t0 = time.perf_counter()
        res = sweep_grid(paper_suite(), npus=tuple(NPUS), policies=POLICIES,
                         as_records=False, device=device, mesh=mesh,
                         **GRIDS[args.grid])
        wall = time.perf_counter() - t0
    total = sum(res.static_j.values()) + sum(res.dynamic_j.values())
    nopg, full = POLICIES.index("NoPG"), POLICIES.index("ReGate-Full")
    saving = float(np.mean(1.0 - total[:, :, full] / total[:, :, nopg]))
    out = {"cells": int(res.runtime_s.size), "cube": list(res.shape),
           "grid": args.grid, "device": device, "world": world,
           "mesh": list(shape) if shape else None, "backend": backend,
           "wall_s": wall, "regate_full_mean_saving": saving}
    if rank == 0:
        print(json.dumps(out), flush=True)
        if args.json:
            fields = {"runtime_s": res.runtime_s}
            for f in ("static_j", "dynamic_j", "wake_events", "gated_s",
                      "setpm_by"):
                for c, a in getattr(res, f).items():
                    fields[f"{f}/{c}"] = a
            np.savez(args.json, **fields)
    return out


if __name__ == "__main__":
    main()
