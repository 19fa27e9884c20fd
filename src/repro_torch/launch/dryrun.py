"""Multi-pod dry run: every (architecture x input shape) cell's step on
the production mesh of a fake world, counted, to prove it fits and to
draw its roofline terms.

The JAX package lowers and compiles each cell for 256 or 512 fabricated
host devices and reads XLA's memory analysis and HLO. The port runs the
step itself, once, as rank 0 of a fake process group of 256 (``(16,
16)``) or 512 (``(2, 16, 16)``) ranks that moves no data: the state and
the batch are fake DTensors (no storage) placed by the sharding rules,
the hand kernels' wrappers return outputs of the right shape without
launching, and a ``core.costs.CostCounter`` counts the step's per-device
FLOPs, bytes and collective bytes (the kernels by their formulas) and
the peak of its live local bytes. The roofline terms are drawn for the
H100 SXM's public figures (``core.hw.H100_SXM``): they are modeled, not
measured. The wall the cell took stands where the reference reports
lower and compile seconds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k [--multi-pod] [--rules baseline] [--out DIR] \\
      [--moe gspmd|shard_map]    # the MoE dispatch on the mesh: gspmd,
                                 # the reference's default, or per shard
      [--attention triangle] [--segments]  # the JAX package's hill-climbs
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``--attention triangle`` and ``--segments`` set the JAX package's toggles
(``models.common.ATTENTION_VARIANT``, ``models.model.
STATIC_WINDOW_SEGMENTS``) for the cell, as the reference's dry run does.
Under the reference, the triangle cuts XLA's chunked attention from the
whole (q x kv) rectangle to the live blocks, and the segments let it do so
in hymba's sliding-window layers. The port's step attends through kernel
B3, whose counted cost is already its live pairs (``live_pairs``) under
every mask, and its layers already take Python-int windows: both toggles
leave the cell's counted terms as they are.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      get_arch, list_archs)
from repro_torch.core.costs import CostCounter
from repro_torch.core.hw import TARGET, RooflineTarget
from repro_torch.core.roofline import model_flops_estimate, report_from_costs
from repro_torch.data.specs import BATCH_AXES, batch_specs
from repro_torch.launch.mesh import (make_production_mesh, mesh_desc,
                                     n_chips, production_shape)
from repro_torch.models import blocks, registry
from repro_torch.models import model as M
from repro_torch.models.param import tree_leaves, tree_with_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.dist import fake_world, make_mesh, use_mesh
from repro_torch.parallel.sharding import (RULE_VARIANTS, ShardingRules,
                                           act_pspec, local_shape,
                                           param_pspec, spec_placements,
                                           use_rules)
from repro_torch.train.steps import TrainState, make_prefill_step, \
    make_serve_step, make_train_step

SERVE_DTYPE = torch.bfloat16

# Microbatch counts size the per-layer residuals (the JAX package's table,
# sized for a 16 GB device; kept so that the cells are the same steps).
# Moment dtype bf16 where fp32 optimizer state alone would blow the budget.
_TRAIN_OVERRIDES = {
    "deepseek-v2-236b": dict(moment_dtype=torch.bfloat16, microbatches=8,
                             accum_dtype=torch.bfloat16),
    "qwen3-32b": dict(moment_dtype=torch.float32, microbatches=8),
    "qwen2.5-14b": dict(moment_dtype=torch.float32, microbatches=8),
    "qwen2.5-3b": dict(moment_dtype=torch.float32, microbatches=4),
    "qwen1.5-4b": dict(moment_dtype=torch.float32, microbatches=4),
    "hymba-1.5b": dict(moment_dtype=torch.float32, microbatches=4),
    "hubert-xlarge": dict(moment_dtype=torch.float32, microbatches=4),
    "mamba2-780m": dict(moment_dtype=torch.float32, microbatches=4),
    "paligemma-3b": dict(moment_dtype=torch.float32, microbatches=2),
    "granite-moe-1b-a400m": dict(moment_dtype=torch.float32, microbatches=1),
}


def train_overrides(arch: str) -> dict:
    ov = dict(_TRAIN_OVERRIDES.get(
        arch, dict(moment_dtype=torch.float32, microbatches=1)))
    ov.setdefault("remat", "full")
    ov.setdefault("accum_dtype", torch.float32)
    return ov


def rules_for(cell_kind: str, rules_name: str) -> ShardingRules:
    if rules_name != "auto":
        return RULE_VARIANTS[rules_name]
    # decode cells shard the KV cache along kv_seq (flash-decoding);
    # train/prefill use the baseline FSDP x TP table
    return RULE_VARIANTS["kv_seq" if cell_kind == "decode"
                         else "baseline"]


def cache_axes(cfg: ArchConfig, entry=None) -> tuple:
    """Logical axes for one layer-cache entry (pre-stacking)."""
    if cfg.family == "ssm":
        conv_axes = (("batch", None, "ssm_inner"),
                     ("batch", None, None), ("batch", None, None))
        return (conv_axes, ("batch", "heads", None, None))
    if cfg.family == "hybrid":
        kv = (("batch", "kv_seq", "kv_heads", None),) * 2
        conv_axes = (("batch", None, "ssm_inner"),
                     ("batch", None, None), ("batch", None, None))
        return (kv, (conv_axes, ("batch", "heads", None, None)))
    if cfg.mla:
        return (("batch", "kv_seq", None), ("batch", "kv_seq", None))
    return (("batch", "kv_seq", "kv_heads", None),) * 2


#: the dense layer's cache axes beside an MLA stack (deepseek's ``dense0``)
DENSE0_AXES = (("batch", "kv_seq", None), ("batch", "kv_seq", None))


# ---------------------------------------------------------------------------
# fake inputs on the mesh
# ---------------------------------------------------------------------------

class _Args:
    """Fake DTensors made for a step, and their local bytes (the
    argument bytes a device holds), counted from the resolved specs."""

    def __init__(self, mesh, device):
        self.mesh, self.device = mesh, device
        self.sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.bytes = 0
        self.tensors = []

    def leaf(self, shape, dtype, spec, *, grad=False):
        from torch.distributed.tensor import DTensor
        loc = local_shape(spec, shape, self.sizes)
        t = torch.empty(loc, dtype=dtype, device=self.device)
        self.bytes += math.prod(loc) * t.element_size()
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        d = DTensor.from_local(t, self.mesh,
                               spec_placements(spec, self.mesh),
                               run_check=False, shape=torch.Size(shape),
                               stride=stride)
        if grad:
            d.requires_grad_()
        self.tensors.append(d)
        return d

    def params(self, cfg: ArchConfig, rules, dtype=None, grad=False):
        specs = registry.param_specs(cfg)
        vals = {}
        for path, s in tree_leaves(specs):
            dt = dtype if dtype is not None and s.dtype.is_floating_point \
                else s.dtype
            vals[path] = self.leaf(
                s.shape, dt, param_pspec(rules, s.axes, s.shape, self.sizes),
                grad=grad)
        return tree_with_leaves(specs, vals)

    def batch(self, cfg, shape, rules, batch_override=None):
        out = {}
        for k, s in batch_specs(cfg, shape, batch_override).items():
            if k == "cache_len":
                continue
            dt = torch.int64 if not s.dtype.is_floating_point else s.dtype
            out[k] = self.leaf(s.shape, dt, act_pspec(
                rules, BATCH_AXES[k], s.shape, self.sizes))
        return out

    def cache(self, cfg, B, Smax, rules, dtype):
        L = registry.n_scanned_layers(cfg)

        def build(struct, axes, lead):
            if not isinstance(struct[1], torch.dtype):
                return tuple(build(s, a, lead) for s, a in zip(struct, axes))
            shape, dt = struct
            full = (*lead, *shape)
            ax = (None,) * len(lead) + tuple(axes)
            return self.leaf(full, dt, act_pspec(rules, ax, full,
                                                 self.sizes))

        out = {"layers": build(M.layer_cache_struct(cfg, B, Smax, dtype),
                               cache_axes(cfg), (L,))}
        if cfg.moe and cfg.moe.first_dense_layers:
            out["dense0"] = build(M.mla_cache_struct(cfg, B, Smax, dtype),
                                  DENSE0_AXES, ())
        return out


def _moment_tree(params, args: _Args, rules, cfg, dtype):
    specs = dict(tree_leaves(registry.param_specs(cfg)))
    vals = {path: args.leaf(p.shape, dtype, param_pspec(
        rules, specs[path].axes, specs[path].shape, args.sizes))
        for path, p in tree_leaves(params)}
    return tree_with_leaves(params, vals)


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh, rules, *,
               device="cpu", microbatches=None, remat=None,
               moment_dtype=None, accum_dtype=None, grad_compression=None,
               dtype=torch.bfloat16):
    """The cell's step as a thunk over fake inputs placed on ``mesh`` (make
    it under ``FakeTensorMode``), and its ``_Args`` (the argument bytes).
    Train: ``make_train_step`` on a ``TrainState`` of float32 parameters
    and ``moment_dtype`` moments; prefill: the prefill step (an encoder's
    inference forward); decode: one ``serve_step`` against a full cache
    (``cache_len`` = its last slot), the weights in ``SERVE_DTYPE``."""
    ov = train_overrides(cfg.name)
    for k, v in (("microbatches", microbatches), ("remat", remat),
                 ("moment_dtype", moment_dtype),
                 ("accum_dtype", accum_dtype)):
        if v is not None:
            ov[k] = v
    args = _Args(mesh, device)
    kind = shape.kind
    if kind == "train":
        opt = AdamWConfig(moment_dtype=ov["moment_dtype"])
        step = make_train_step(cfg, opt, microbatches=ov["microbatches"],
                               remat=ov["remat"],
                               accum_dtype=ov["accum_dtype"],
                               grad_compression=grad_compression,
                               dtype=dtype)
        params = args.params(cfg, rules, grad=True)
        mom = [_moment_tree(params, args, rules, cfg, ov["moment_dtype"])
               for _ in range(2)]
        opt_state = {"m": mom[0], "v": mom[1],
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
        if grad_compression == "int8":
            opt_state["ef"] = _moment_tree(params, args, rules, cfg,
                                           torch.float32)
        state = TrainState(params, opt_state,
                           torch.zeros((), dtype=torch.int32, device=device))
        args.bytes += 8  # the two int32 step counters
        args.tensors += [opt_state["step"], state.step]
        batch = args.batch(cfg, shape, rules)
        return (lambda: step(state, batch)), args, ov
    params = args.params(cfg, rules, dtype=SERVE_DTYPE)
    if kind == "prefill":
        batch = args.batch(cfg, shape, rules)
        if cfg.encoder_only:
            def enc():
                with torch.no_grad():
                    return M.forward(params, batch, cfg, remat="none",
                                     dtype=SERVE_DTYPE)[0]
            return enc, args, ov
        step = make_prefill_step(cfg, dtype=SERVE_DTYPE)

        def pre():
            with torch.no_grad():
                return step(params, batch)
        return pre, args, ov
    B, Smax = shape.global_batch, shape.seq_len
    cache = args.cache(cfg, B, Smax, rules, SERVE_DTYPE)
    batch = args.batch(cfg, shape, rules)
    batch["cache_len"] = Smax - 1  # a Python int: no device bytes
    step = make_serve_step(cfg, dtype=SERVE_DTYPE)

    def dec():
        with torch.no_grad():
            return step(params, cache, batch)
    return dec, args, ov


def count_step(cfg: ArchConfig, shape: ShapeConfig, mesh, rules, **kw):
    """Build the cell's step on fake inputs and run it once under a
    ``CostCounter``: returns ``(counter, args, overrides)``. Needs a
    process group whose world is the mesh's (``fake_world``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh), \
            use_rules(rules), implicit_replication():
        run, args, ov = build_step(cfg, shape, mesh, rules, **kw)
        counter = CostCounter()
        counter.track(args.tensors)
        with counter:
            out = run()
            del out, run
    return counter, args, ov


def _failing_op(e: BaseException) -> str:
    """The op an exception names, where it names one: the op DTensor could
    not shard (its sharding propagation's message names it), else the
    first aten op named."""
    import re
    m = re.search(r"Sharding propagation failed for ([\w.]+)", str(e)) \
        or re.search(r"(aten\.[\w.]+|c10d_functional\.[\w.]+)", str(e))
    return m.group(1) if m else ""


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules_name: str = "auto", out_dir: str = "results/dryrun",
             grad_compression=None, remat_override=None,
             attention: str = "baseline", segments: bool = False,
             moe: str = "gspmd", tag: str = "", n_layers=None,
             mesh_shape=None, target: RooflineTarget = TARGET,
             shape: Optional[ShapeConfig] = None, microbatches=None,
             dump: bool = True) -> dict:
    """One cell: status, GiB a device, the three roofline terms on
    ``target``, dominant, RF, ``flops_ratio``, notes and the wall. Opens a
    fake world of the mesh's size unless a process group exists (then the
    mesh must fit it). ``n_layers`` cuts the depth (the tests' reduced
    cells), ``mesh_shape`` replaces the production mesh (axes ``data``,
    ``model``, and ``pod`` in front for three dims), ``shape`` the named
    shape (``shape_name`` then labels it). ``attention`` and ``segments``
    set the hill-climb toggles for the cell (``models.model.hillclimb``);
    the cell records both."""
    import torch.distributed as dist
    M.check_attention_variant(attention)
    cfg = get_arch(arch)
    if n_layers is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=int(n_layers))
    shape = SHAPES[shape_name] if shape is None else shape
    support = get_arch(arch).supported_shapes().get(shape_name, "ok")
    if mesh_shape is None:
        mshape, axes = production_shape(multi_pod=multi_pod)
    else:
        mshape = tuple(mesh_shape)
        axes = {2: ("data", "model"),
                3: ("pod", "data", "model")}[len(mshape)]
    cell_id = f"{arch}-{shape_name}" + (f"-{tag}" if tag else "")
    world = contextlib.nullcontext() if dist.is_initialized() \
        else fake_world(math.prod(mshape))
    with world:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu") \
            if mesh_shape is None else make_mesh(mshape, axes, "cpu")
        mdesc = mesh_desc(mesh)
        result: dict = {"arch": arch, "shape": shape_name, "mesh": mdesc,
                        "chips": n_chips(mesh), "status": "ok", "tag": tag,
                        "layers": cfg.n_layers, "moe": moe,
                        "attention": attention, "segments": bool(segments)}
        if support != "ok":
            result["status"] = support
            if dump:
                _dump(result, out_dir, multi_pod, cell_id)
            print(f"[dryrun] {cell_id} on {mdesc}: {support}")
            return result
        rules = rules_for(shape.kind, rules_name)
        t0 = time.time()
        try:
            with blocks.moe_dispatch(moe), M.hillclimb(attention, segments):
                counter, args, ov = count_step(
                    cfg, shape, mesh, rules, remat=remat_override,
                    grad_compression=grad_compression,
                    microbatches=microbatches)
            wall = time.time() - t0
            note = "encoder-only: prefill runs the inference forward" \
                if shape.kind == "prefill" and cfg.encoder_only else ""
            if shape.kind == "decode":
                note = "decode: one step against a full cache"
            rep = report_from_costs(
                counter.costs, arch=arch, shape=shape_name, mesh=mdesc,
                n_chips=n_chips(mesh),
                model_flops=model_flops_estimate(cfg, shape),
                bytes_per_device=counter.peak_bytes, target=target,
                notes=note)
            result.update(rep.to_json())
            gib = counter.peak_bytes / 2 ** 30
            result.update(
                rules=rules.name, wall_s=wall,
                argument_bytes=args.bytes,
                argument_bytes_tracked=counter.base_bytes,
                peak_bytes=counter.peak_bytes,
                hbm_gb_per_device=gib,
                fits=counter.peak_bytes <= target.hbm_gb * 1e9,
                kernels=dict(counter.costs.kernels),
                dots=counter.costs.dots,
                microbatches=ov["microbatches"] if shape.kind == "train"
                else None)
            print(f"[dryrun] {cell_id} on {mdesc}: OK "
                  f"{gib:.2f} GiB/dev"
                  f"{'' if result['fits'] else ' (does not fit)'}, "
                  f"compute {rep.compute_s*1e3:.1f} ms, "
                  f"memory {rep.memory_s*1e3:.1f} ms, "
                  f"collective {rep.collective_s*1e3:.1f} ms, "
                  f"dominant={rep.dominant}, RF={rep.roofline_fraction:.2f} "
                  f"(wall {wall:.0f}s)")
        except Exception as e:  # noqa: BLE001 -- a cell's failure is data
            op = _failing_op(e)
            result["status"] = f"FAIL: {type(e).__name__}: " + (
                f"{op}: " if op else "") + str(e)[:300]
            result["failing_op"] = op
            result["traceback"] = traceback.format_exc()[-4000:]
            print(f"[dryrun] {cell_id} on {mdesc}: FAILED "
                  f"{type(e).__name__}: {str(e)[:200]}")
    if dump:
        _dump(result, out_dir, multi_pod, cell_id)
    return result


def _dump(result: dict, out_dir: str, multi_pod: bool, cell_id: str):
    d = os.path.join(out_dir, "multipod" if multi_pod else "singlepod")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{cell_id}.json"), "w") as f:
        json.dump(result, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="auto")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--attention", default="baseline",
                    choices=["baseline", "triangle"])
    ap.add_argument("--segments", action="store_true",
                    help="static-window layer segments (hymba hill-climb)")
    # the MoE dispatch on the mesh: gspmd (the reference's default, the
    # whole group's capacity and drops) or shard_map (per data shard)
    ap.add_argument("--moe", default="gspmd",
                    choices=["gspmd", "shard_map"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s) for a in archs for s in shapes]
    failures = 0
    shape, axes = production_shape(multi_pod=args.multi_pod)
    with fake_world(math.prod(shape)):
        for a, s in cells:
            r = run_cell(a, s, multi_pod=args.multi_pod,
                         rules_name=args.rules, out_dir=args.out,
                         grad_compression=args.grad_compression,
                         remat_override=args.remat,
                         attention=args.attention, segments=args.segments,
                         moe=args.moe, tag=args.tag)
            if str(r.get("status", "")).startswith("FAIL"):
                failures += 1
    print(f"[dryrun] done: {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
