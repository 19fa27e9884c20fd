"""Workers of ``tests/test_torch_parallel.py``: each runs as one rank of a
2-process gloo world on the CPU (``run_world``) and writes what rank 0
gathers to an ``.npz`` file. Imports only ``repro_torch``."""
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESHES = ((1, 2), (2, 1))
STEPS = 3
SEQ, BATCH, MICRO = 32, 4, 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def setup(arch: str):
    """A reduced config's float32 state from seed 0, its AdamW, data and
    train step (2 microbatches, float32 compute)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, train_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainState, make_train_step
    cfg = get_arch(arch).reduced()
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    data = SyntheticDataset(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                            seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = TrainState.create(train_params(init_params(
        registry.param_specs(cfg), gen, "cpu")), opt)
    step = make_train_step(cfg, opt, microbatches=MICRO,
                           dtype=torch.float32)
    return cfg, state, data, step


def train(arch: str, mesh=None, rules=None, init=None):
    """STEPS steps, on ``mesh`` when given, from ``setup`` (or from the
    JAX package's state in the ``.npz`` at ``init``: ``setup_from``):
    (losses, {path: array})."""
    from repro_torch.models.param import tree_leaves
    from repro_torch.train.steps import place_batch, place_state
    cfg, state, data, step = setup(arch) if init is None \
        else setup_from(arch, init)
    if mesh is not None:
        state = place_state(state, cfg, rules, mesh)
    losses = []
    for i in range(STEPS):
        b = data.batch(i)
        if mesh is not None:
            b = place_batch(b, rules, mesh, MICRO)
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    leaves = {"/".join(k): (v.full_tensor() if mesh is not None else v)
              .detach().numpy() for k, v in tree_leaves(state.params)}
    return losses, leaves


def unflatten(arrays: dict, prefix: str) -> dict:
    """The nested dict of ``{prefix/a/b: array}`` entries (the JAX
    package's trees as ``tests/_jax_mesh_reference.py`` writes them)."""
    out: dict = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        *path, leaf = k[len(prefix) + 1:].split("/")
        d = out
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = v
    return out


def setup_from(arch: str, path: str):
    """``setup``'s pieces, the state the JAX package's (its ``init/``
    entries in the ``.npz`` at ``path``) and the data from seed 1, as
    ``tests/_jax_mesh_reference.py`` trains."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data.pipeline import SyntheticDataset
    cfg, _, _, step = setup(arch)
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files if k.startswith("init/")}
    opt = unflatten(arrays, "init/opt_state")
    state = train_state_from_numpy(
        {"params": unflatten(arrays, "init/params"),
         "opt_state": {**opt, "step": 0}, "step": 0}, device="cpu")
    data = SyntheticDataset(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                            seed=1, device="cpu")
    return cfg, state, data, step


def moe_inputs(arch: str):
    """A reduced MoE layer's weights and a (4, 32, D) input, float32."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import blocks
    from repro_torch.models.param import init_params
    cfg = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(1)
    p = init_params(blocks.moe_specs(cfg), gen, "cpu")
    x = torch.randn((4, 32, cfg.d_model), generator=gen)
    return cfg, p, x


def _place(tree, specs, rules, mesh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.sharding import param_placements
    return {k: distribute_tensor(v, mesh, param_placements(rules, specs[k],
                                                           mesh),
                                 src_data_rank=None)
            for k, v in tree.items()}


def task_train(rank, arch, shape, init=None):
    from repro_torch.models import blocks
    from repro_torch.parallel import make_mesh, use_mesh, use_rules
    from repro_torch.parallel.sharding import RULE_VARIANTS
    rules = RULE_VARIANTS["baseline"]
    blocks.MOE_SHARD_MAP["enabled"] = True
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    with use_mesh(mesh), use_rules(rules):
        losses, leaves = train(arch, mesh, rules, init)
    return {"losses": np.array(losses), **leaves}


def moe_inputs_from(path: str):
    """The reduced granite-moe-1b-a400m with the capacity factor, weights
    and x of the ``.npz`` at ``path`` (float32)."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    with np.load(path) as f:
        arrs = {k: f[k] for k in f.files}
    base = get_arch("granite-moe-1b-a400m").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=float(arrs.pop("capacity_factor"))))
    x = torch.from_numpy(arrs.pop("x"))
    return cfg, {k: torch.from_numpy(v) for k, v in arrs.items()}, x


def task_moe(rank, arch, inputs=None):
    """``moe_fwd`` on each mesh (the per-shard dispatch), y and aux, on
    ``moe_inputs(arch)`` or the inputs in the ``.npz`` at ``inputs``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models import blocks
    from repro_torch.parallel import make_mesh, use_mesh, use_rules
    from repro_torch.parallel.sharding import RULE_VARIANTS, act_placements
    from torch.distributed.tensor.experimental import implicit_replication
    rules = RULE_VARIANTS["baseline"]
    cfg, p, x = moe_inputs(arch) if inputs is None \
        else moe_inputs_from(inputs)
    specs = blocks.moe_specs(cfg)
    out = {}
    blocks.MOE_SHARD_MAP["enabled"] = True
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        with use_mesh(mesh), use_rules(rules), implicit_replication():
            pd = _place(p, specs, rules, mesh)
            xd = distribute_tensor(x, mesh, act_placements(
                rules, ("batch", "seq", "embed"), x.shape, mesh),
                src_data_rank=None)
            y, aux = blocks.moe_fwd(pd, xd, cfg)
        tag = "x".join(map(str, shape))
        out[f"{tag}:y"] = y.full_tensor().numpy()
        out[f"{tag}:aux"] = aux.full_tensor().numpy()
    return out


def task_ckpt(rank, arch, directory):
    """Save a state on (1, 2); restore it onto (2, 1) (a fresh state's
    structure, placed there) and gather what landed."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.param import tree_leaves
    from repro_torch.parallel import make_mesh, use_mesh, use_rules
    from repro_torch.parallel.sharding import RULE_VARIANTS
    from repro_torch.train.steps import place_state
    rules = RULE_VARIANTS["baseline"]
    cfg, state, data, step = setup(arch)
    a = make_mesh((1, 2), ("data", "model"), "cpu")
    with use_mesh(a), use_rules(rules):
        st = place_state(state, cfg, rules, a)
        st, _ = step(st, place_batch_on(data.batch(0), rules, a, MICRO))
        cm = CheckpointManager(directory)
        cm.save(1, st, extras={"mesh": "1x2"}, blocking=True)
    b = make_mesh((2, 1), ("data", "model"), "cpu")
    _, fresh, _, _ = setup(arch)
    target = place_state(fresh, cfg, rules, b)
    got, extras = CheckpointManager(directory).restore(target)
    out = {}
    for k, v in tree_leaves(got.params):
        assert tuple(v.placements) == tuple(
            dict(tree_leaves(target.params))[k].placements)
        out["params/" + "/".join(k)] = v.detach().full_tensor().numpy()
    for name in ("m", "v"):
        for k, v in tree_leaves(got.opt_state[name]):
            out[f"{name}/" + "/".join(k)] = v.full_tensor().numpy()
    out["extras_mesh"] = np.array(extras["mesh"])
    return out


def place_batch_on(batch, rules, mesh, microbatches):
    from repro_torch.train.steps import place_batch
    return place_batch(batch, rules, mesh, microbatches)


def _worker(rank, world, port, task, args, path):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = globals()[f"task_{task}"](rank, *args)
        if rank == 0:
            np.savez(path, **out)
    finally:
        dist.destroy_process_group()


def run_world(task: str, args: tuple, path: str, world: int = 2) -> dict:
    """Run ``task_<task>(rank, *args)`` on ``world`` gloo ranks; returns
    what rank 0 wrote."""
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, task, args, path))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert codes == [0] * world, codes
    with np.load(path) as f:
        return {k: f[k] for k in f.files}
