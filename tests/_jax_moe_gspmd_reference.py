"""The JAX package's default MoE dispatch on a mesh (GSPMD's partitioning
of ``_moe_group``, ``MOE_SHARD_MAP`` off), for
``tests/test_torch_moe_gspmd.py``: run as a script in a child process with
4 XLA host devices (the device count must be set before jax starts, never
in a pytest worker).

    python tests/_jax_moe_gspmd_reference.py moe INPUTS.npz OUT.npz
    python tests/_jax_moe_gspmd_reference.py train CF OUT.npz

``moe``: ``moe_fwd`` of the reduced granite-moe-1b-a400m (its capacity
factor from the inputs) on the inputs' weights and x, without a mesh and
on each of the (1, 2), (2, 1) and (2, 2) meshes: y, aux, and the kept
(token, slot) assignments -- ``_moe_group``'s routing lines (top-k, the
rank cumsum, the capacity) jitted on the same mesh, over moe_fwd's
groups, as (B, S, K) booleans. ``train``: the reduced
granite-moe-1b-a400m at capacity factor ``CF``, its state from PRNG key 0
(written as ``init/...``), then 3 steps of its jitted train step (2
microbatches, float32) without a mesh and on the (1, 2) and (2, 1) meshes,
state and batch sharded by the baseline rules: each run's losses and
final parameters (``<mesh>/...``, ``none`` unsharded).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import ShapeConfig, get_arch  # noqa: E402
from repro.data.pipeline import SyntheticDataset  # noqa: E402
from repro.models import blocks, registry  # noqa: E402
from repro.models.common import rms_norm  # noqa: E402
from repro.models.param import init_params, is_spec  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.parallel.jax_compat import make_mesh, set_mesh  # noqa: E402
from repro.parallel.sharding import (RULE_VARIANTS, act_pspec,  # noqa: E402
                                     constrain, param_pspec, use_rules)
from repro.train.steps import TrainState, make_train_step  # noqa: E402

ARCH = "granite-moe-1b-a400m"
MOE_MESHES = ((1, 2), (2, 1), (2, 2))
TRAIN_MESHES = ((1, 2), (2, 1))
STEPS, SEQ, BATCH, MICRO, DATA_SEED = 3, 32, 4, 2, 1
OPT = dict(warmup_steps=2, total_steps=10)
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
RULES = RULE_VARIANTS["baseline"]


def config(capacity_factor: float):
    base = get_arch(ARCH).reduced()
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=float(capacity_factor)))


def mesh_of(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=jax.devices()[:math.prod(shape)])


def flat(tree, prefix: str) -> dict:
    """``{prefix/a/b: array}`` of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def kept(p, x, cfg):
    """(B, S, K) bool: the assignments ``_moe_group`` keeps, over
    ``moe_fwd``'s sequence-chunk groups (its lines, in its order)."""
    mo = cfg.moe
    B, S, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    G = min(mo.group_size, B * S)
    gs = max(1, G // B)
    if S % gs != 0:
        gs = 1
    nc = S // gs
    E, K = mo.n_experts, mo.top_k
    tok = h.reshape(B, nc, gs, D).transpose(1, 0, 2, 3) \
        .reshape(nc, B * gs, D)

    def group(t):
        t = constrain(t, "batch", None)
        probs = jax.nn.softmax(t.astype(jnp.float32) @ p["router"], axis=-1)
        _, topk_idx = jax.lax.top_k(probs, K)
        flat_e = topk_idx.reshape(-1)
        sel = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(sel, axis=0) - sel) * sel, axis=-1)
        C = max(8, int(math.ceil(t.shape[0] * K * mo.capacity_factor
                                 / E / 8.0)) * 8)
        return (pos < C).reshape(t.shape[0], K)

    keep = jax.vmap(group)(tok)                       # (nc, B * gs, K)
    return keep.reshape(nc, B, gs, K).transpose(1, 0, 2, 3) \
        .reshape(B, S, K)


def moe(inputs: str) -> dict:
    with np.load(inputs) as f:
        arrs = {k: f[k] for k in f.files}
    cfg = config(arrs.pop("capacity_factor"))
    x = jnp.asarray(arrs.pop("x"))
    p = {k: jnp.asarray(v) for k, v in arrs.items()}
    blocks.MOE_SHARD_MAP["enabled"] = False

    def fwd(p, x):
        y, aux = blocks.moe_fwd(p, x, cfg)
        return y, aux, kept(p, x, cfg)

    out = {}
    for ms in (None,) + MOE_MESHES:
        tag = "none" if ms is None else "x".join(map(str, ms))
        if ms is None:
            y, aux, k = jax.jit(fwd)(p, x)
        else:
            with set_mesh(mesh_of(ms)), use_rules(RULES):
                y, aux, k = jax.jit(fwd)(p, x)
        out[f"{tag}/y"] = np.asarray(y)
        out[f"{tag}/aux"] = np.asarray(aux)
        out[f"{tag}/kept"] = np.asarray(k)
    return out


def train(capacity_factor: str) -> dict:
    cfg = config(float(capacity_factor))
    opt = AdamWConfig(**OPT)
    specs = registry.param_specs(cfg)
    state0 = TrainState.create(init_params(specs, jax.random.PRNGKey(0)),
                               opt)
    data = SyntheticDataset(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                            seed=DATA_SEED)
    out = {**flat(state0.params, "init/params"),
           **flat({k: v for k, v in state0.opt_state.items()
                   if k != "step"}, "init/opt_state")}
    blocks.MOE_SHARD_MAP["enabled"] = False
    for ms in (None,) + TRAIN_MESHES:
        tag = "none" if ms is None else "x".join(map(str, ms))
        step = make_train_step(cfg, opt, microbatches=MICRO,
                               dtype=jnp.float32)
        st = state0
        if ms is None:
            jitted = jax.jit(step)
            run = lambda s, b: jitted(s, b)  # noqa: E731
        else:
            mesh = mesh_of(ms)
            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            p_ps = jax.tree.map(lambda s: param_pspec(
                RULES, s.axes, s.shape, sizes), specs, is_leaf=is_spec)
            st_ps = TrainState(params=p_ps, opt_state={
                "m": p_ps, "v": p_ps, "step": P()}, step=P())
            b_ps = {k: act_pspec(RULES, BATCH_AXES[k], v.shape, sizes)
                    for k, v in data.batch(0).items()}
            with set_mesh(mesh), use_rules(RULES):
                jitted = jax.jit(step, in_shardings=(st_ps, b_ps),
                                 out_shardings=(st_ps, None))

            def run(s, b, mesh=mesh, jitted=jitted):
                with set_mesh(mesh), use_rules(RULES):
                    return jitted(s, b)
        losses = []
        for i in range(STEPS):
            st, m = run(st, data.batch(i))
            losses.append(float(m["loss"]))
        out[f"{tag}/losses"] = np.array(losses)
        out.update(flat(st.params, f"{tag}/params"))
    return out


if __name__ == "__main__":
    task, arg, path = sys.argv[1:]
    np.savez(path, **(moe(arg) if task == "moe" else train(arg)))
