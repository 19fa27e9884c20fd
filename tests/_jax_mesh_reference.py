"""The JAX package on a mesh of 2 host devices, for
``tests/test_torch_parallel.py``: run as a script in a child process (the
device count must be set before jax starts, never in a pytest worker).

    python tests/_jax_mesh_reference.py train ARCH OUT.npz
    python tests/_jax_mesh_reference.py moe INPUTS.npz OUT.npz

``train``: the reduced ``ARCH``'s state from PRNG key 0 (written as
``init/...``), then 3 steps of its jitted train step (2 microbatches,
float32, ``MOE_SHARD_MAP`` on) on each of the (1, 2) and (2, 1) meshes,
state and batch sharded by the baseline rules, and for an MoE arch once
without a mesh: each run's losses and final parameters (``<mesh>/...``, mesh ``none``
for the unsharded run). ``moe``: ``moe_fwd`` of the reduced
granite-moe-1b-a400m (its capacity factor from the inputs) on the inputs'
weights and x, on each mesh with ``MOE_SHARD_MAP`` on (the shard-mapped
dispatch, ``_moe_group_smap``) and without a mesh: y and aux.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import ShapeConfig, get_arch  # noqa: E402
from repro.data.pipeline import SyntheticDataset  # noqa: E402
from repro.models import blocks, registry  # noqa: E402
from repro.models.param import init_params, is_spec  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.parallel.jax_compat import make_mesh, set_mesh  # noqa: E402
from repro.parallel.sharding import (RULE_VARIANTS, act_pspec,  # noqa: E402
                                     param_pspec, use_rules)
from repro.train.steps import TrainState, make_train_step  # noqa: E402

MESHES = ((1, 2), (2, 1))
STEPS, SEQ, BATCH, MICRO, DATA_SEED = 3, 32, 4, 2, 1
OPT = dict(warmup_steps=2, total_steps=10)
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
              "frames": ("batch", "seq", None),
              "patches": ("batch", None, None)}


def flat(tree, prefix: str) -> dict:
    """``{prefix/a/b: array}`` of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def train(arch: str) -> dict:
    cfg = get_arch(arch).reduced()
    opt = AdamWConfig(**OPT)
    specs = registry.param_specs(cfg)
    state0 = TrainState.create(init_params(specs, jax.random.PRNGKey(0)),
                               opt)
    data = SyntheticDataset(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                            seed=DATA_SEED)
    out = {**flat(state0.params, "init/params"),
           **flat({k: v for k, v in state0.opt_state.items()
                   if k != "step"}, "init/opt_state")}
    rules = RULE_VARIANTS["baseline"]
    blocks.MOE_SHARD_MAP["enabled"] = True
    # the unsharded run is compared with where the MoE path's aux differs
    for ms in ((None,) if cfg.moe else ()) + MESHES:
        tag = "none" if ms is None else "x".join(map(str, ms))
        step = make_train_step(cfg, opt, microbatches=MICRO,
                               dtype=jnp.float32)
        st = state0
        if ms is None:
            jitted = jax.jit(step)
            run = lambda s, b: jitted(s, b)  # noqa: E731
        else:
            mesh = make_mesh(ms, ("data", "model"))
            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            p_ps = jax.tree.map(lambda s: param_pspec(
                rules, s.axes, s.shape, sizes), specs, is_leaf=is_spec)
            st_ps = TrainState(params=p_ps, opt_state={
                "m": p_ps, "v": p_ps, "step": P()}, step=P())
            b0 = data.batch(0)
            b_ps = {k: act_pspec(rules, BATCH_AXES[k], v.shape, sizes)
                    for k, v in b0.items()}
            with set_mesh(mesh), use_rules(rules):
                jitted = jax.jit(step, in_shardings=(st_ps, b_ps),
                                 out_shardings=(st_ps, None))

            def run(s, b, mesh=mesh, jitted=jitted):
                with set_mesh(mesh), use_rules(rules):
                    return jitted(s, b)
        losses = []
        for i in range(STEPS):
            st, m = run(st, data.batch(i))
            losses.append(float(m["loss"]))
        out[f"{tag}/losses"] = np.array(losses)
        out.update(flat(st.params, f"{tag}/params"))
    return out


def moe(inputs: str) -> dict:
    with np.load(inputs) as f:
        arrs = {k: f[k] for k in f.files}
    base = get_arch("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=float(arrs.pop("capacity_factor"))))
    x = jnp.asarray(arrs.pop("x"))
    p = {k: jnp.asarray(v) for k, v in arrs.items()}
    out = {}
    blocks.MOE_SHARD_MAP["enabled"] = True
    for ms in (None,) + MESHES:
        tag = "none" if ms is None else "x".join(map(str, ms))
        if ms is None:
            y, aux = jax.jit(lambda p, x: blocks.moe_fwd(p, x, cfg))(p, x)
        else:
            mesh = make_mesh(ms, ("data", "model"))
            with set_mesh(mesh), use_rules(RULE_VARIANTS["baseline"]):
                y, aux = jax.jit(lambda p, x: blocks.moe_fwd(p, x, cfg))(
                    p, x)
        out[f"{tag}/y"] = np.asarray(y)
        out[f"{tag}/aux"] = np.asarray(aux)
    return out


if __name__ == "__main__":
    task, *args = sys.argv[1:]
    result = train(args[0]) if task == "train" else moe(args[0])
    np.savez(args[-1], **result)
