"""Workers of ``tests/test_torch_parallel.py`` and
``tests/test_torch_moe_gspmd.py``: each runs as one rank of a gloo world
on the CPU (``run_world``; 2 processes, 4 for a (2, 2) mesh) and writes
what rank 0 gathers to an ``.npz`` file. Imports only ``repro_torch``."""
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


def task_moe_dispatch(rank, inputs, shape):
    """``moe_fwd`` on ``shape`` (a mesh of the whole world) under each
    dispatch, ``gspmd`` and ``shard_map``, on the inputs in the ``.npz``
    at ``inputs``: y, aux, the top-k experts every rank routed to
    (``moe_route``'s) and the assignments its dispatch kept
    (``moe_slots``'), each (B, S, K) over the whole batch, every data
    shard's rows in place."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import blocks
    from repro_torch.parallel import make_mesh, use_mesh, use_rules
    from repro_torch.parallel.sharding import RULE_VARIANTS, act_placements
    rules = RULE_VARIANTS["baseline"]
    cfg, p, x = moe_inputs_from(inputs)
    specs = blocks.moe_specs(cfg)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    route, slots, logged = blocks.moe_route, blocks.moe_slots, {}

    def logging_route(tok, router, top_k):
        out = route(tok, router, top_k)
        logged["experts"].append(out[2])
        return out

    def logging_slots(flat_e, *args):
        pos, keep = slots(flat_e, *args)
        logged["kept"].append(keep.view(logged["experts"][-1].shape))
        return pos, keep

    B, S, _ = x.shape
    out = {}
    blocks.moe_route, blocks.moe_slots = logging_route, logging_slots
    try:
        for mode in ("gspmd", "shard_map"):
            logged.update(experts=[], kept=[])
            with use_mesh(mesh), use_rules(rules), implicit_replication(), \
                    blocks.moe_dispatch(mode), torch.no_grad():
                pd = _place(p, specs, rules, mesh)
                xd = distribute_tensor(x, mesh, act_placements(
                    rules, ("batch", "seq", "embed"), x.shape, mesh),
                    src_data_rank=None)
                y, aux = blocks.moe_fwd(pd, xd, cfg)
            out[f"{mode}:y"] = y.full_tensor().numpy()
            out[f"{mode}:aux"] = aux.full_tensor().numpy()
            for name, parts in logged.items():
                t = torch.cat(parts)                   # (nc, B_loc gs, K)
                nc = t.shape[0]
                b_loc = t.shape[1] * nc // S
                t = t.reshape(nc, b_loc, S // nc, -1).transpose(0, 1) \
                    .reshape(b_loc, S, -1)
                shards = [None] * dist.get_world_size()
                dist.all_gather_object(shards, (mesh.get_local_rank("data"),
                                                t.numpy()))
                rows = [None] * shape[0]
                for d, r in shards:
                    rows[d] = r
                out[f"{mode}:{name}"] = np.concatenate(rows)
    finally:
        blocks.moe_route, blocks.moe_slots = route, slots
    return out


def task_launch_train(rank, arch, mesh_text, ckpt_dir):
    """``launch.train.run`` on ``mesh_text`` (``parse_mesh``), its train
    step in float32 compute: 3 steps of the reduced ``arch`` from the
    checkpoint in ``ckpt_dir`` (the run saves its last state there), the
    data from seed 1, as ``tests/_jax_moe_gspmd_reference.py`` trains.
    Returns the losses and how often each MoE mesh path ran."""
    import functools
    from repro_torch.launch import train as launch_train
    from repro_torch.models import blocks
    from repro_torch.train import steps
    launch_train.make_train_step = functools.partial(
        steps.make_train_step, dtype=torch.float32)
    calls = {"gspmd": 0, "smap": 0}
    paths = {"gspmd": blocks._moe_gspmd, "smap": blocks._moe_smap}

    def counted(name):
        def f(*a, **k):
            calls[name] += 1
            return paths[name](*a, **k)
        return f

    blocks._moe_gspmd, blocks._moe_smap = counted("gspmd"), counted("smap")
    try:
        out = launch_train.run(launch_train.TrainLoopConfig(
            arch=arch, steps=STEPS, seq_len=SEQ, global_batch=BATCH,
            microbatches=MICRO, ckpt_dir=ckpt_dir, seed=1, mesh=mesh_text,
            device="cpu", log_every=STEPS, checkpoint_every=0))
    finally:
        blocks._moe_gspmd, blocks._moe_smap = paths["gspmd"], paths["smap"]
    return {"losses": np.array(out["losses"]),
            "gspmd_calls": np.array(calls["gspmd"]),
            "smap_calls": np.array(calls["smap"])}


def task_thread_backward(rank, arch, shape):
    """One microbatch's loss of the reduced ``arch`` on ``shape`` under
    remat "full", its backward run twice: in this thread, and in a new
    thread, which starts without the mesh and rules context variables,
    as the autograd engine's device thread does for a CUDA tensor (the
    engine carries torch's own thread state over, DTensor's implicit
    replication among it: the thread sets that one itself). Returns both
    runs' gradients, gathered."""
    import threading
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_leaves
    from repro_torch.parallel import make_mesh, use_mesh, use_rules
    from repro_torch.parallel.sharding import RULE_VARIANTS
    from repro_torch.train.steps import place_batch, place_state
    from torch.distributed.tensor.experimental import implicit_replication
    rules = RULE_VARIANTS["baseline"]
    cfg, state, data, _ = setup(arch)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    out = {}
    with use_mesh(mesh), use_rules(rules), implicit_replication():
        state = place_state(state, cfg, rules, mesh)
        batch = place_batch(data.batch(0), rules, mesh)
        leaves = dict(tree_leaves(state.params))
        for where in ("same", "thread"):
            for p in leaves.values():
                p.grad = None
            loss, _ = M.loss_fn(state.params, batch, cfg, remat="full",
                                dtype=torch.float32)
            if where == "same":
                loss.backward()
            else:
                errors = []

                def run():
                    try:
                        with implicit_replication():
                            loss.backward()
                    except BaseException as e:  # noqa: BLE001
                        errors.append(e)
                t = threading.Thread(target=run)
                t.start()
                t.join()
                if errors:
                    raise errors[0]
            for k, p in leaves.items():
                out[f"{where}/" + "/".join(k)] = \
                    p.grad.full_tensor().numpy()
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
