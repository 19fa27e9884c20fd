"""The port on a mesh, in a 2-process gloo world on the CPU, float32
(``tests/_torch_parallel_child.py``): a reduced qwen2.5-3b and a reduced
granite-moe-1b-a400m train 3 steps on the (1, 2) and (2, 1) meshes, and
their losses and every parameter leaf are held to the single-device run
(1e-5 relative; a zero-initialized leaf whose gradient is rounding noise
-- qwen's key bias, which softmax cannot see -- to 1e-2, as
``tests/_torch_train_common.py`` holds such leaves); the MoE layer's
per-shard dispatch against the single-device dispatch (<= 2e-4 max abs,
``tests/test_moe_dispatch.py``'s bar, with the same routing: no drops at
these sizes); and a checkpoint saved on (1, 2) restored bit for bit onto
(2, 1) and onto one device (``tests/test_elastic_resharding.py``'s
case). Each world is its own pair of processes: the pytest worker never
holds a process group.

Against the JAX package on the same meshes (``tests/_jax_mesh_reference.py``,
a child with 2 XLA host devices): both archs train 3 steps from the
reference's state on its data, and the port's losses and parameter
leaves are held to the reference's sharded run by
``tests/_torch_train_common.py``'s bars (loss 1e-5 relative, leaves 1e-4
relative L2, the zero-initialized ones 1e-2); the MoE layer's mesh path
against the reference's shard-mapped dispatch (``_moe_group_smap``) at
capacity factor 2 (no drops) and 1, where each data shard's capacity
(8 slots for its 16 tokens, against 16 for a whole group's 32) drops
other assignments than one device would. One semantic differs on
purpose: the reference's ``_moe_group_smap`` returns each data shard's
own aux under a replicated out-spec it does not check, so on the (2, 1)
mesh its loss and router move off its own unsharded run (3e-4 relative
on the loss, 2.7e-4 relative L2 on the router after 3 steps); the port
averages aux's factors over the data shards, which is the one-device
aux. There the port is held to the reference's unsharded run, and the
reference's gap to it is asserted to stand."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parallel_child as child  # noqa: E402

LEAF_RTOL = 1e-5
NOISE_LEAVES = {"layers/attn/bk"}  # zero-initialized, zero true gradient
NOISE_RTOL = 1e-2


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


REF_CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_jax_mesh_reference.py")
REF_LOSS_RTOL, REF_LEAF_TOL, REF_ZERO_INIT_TOL = 1e-5, 1e-4, 1e-2
MOE_ATOL = 2e-4  # tests/test_moe_dispatch.py's bar


def _start_reference(args: tuple, path: str):
    """``tests/_jax_mesh_reference.py args path`` started in a child."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    src = os.path.join(os.path.dirname(os.path.dirname(REF_CHILD)), "src")
    env.update(PYTHONPATH=src, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, REF_CHILD, *args, path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish_reference(proc, path: str) -> dict:
    """What the child wrote, once it has ended."""
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _reference(args: tuple, path: str) -> dict:
    return _finish_reference(_start_reference(args, path), path)


REF_ARCHS = ("qwen2.5-3b", "granite-moe-1b-a400m")


@pytest.fixture(scope="module")
def reference_training(tmp_path_factory):
    """Per arch, the reference's runs (``_jax_mesh_reference.py train``)
    and the ``.npz`` holding them: both archs' children start at the
    first call, side by side, and each is read once."""
    procs, runs = {}, {}

    def get(arch):
        if not procs:
            d = tmp_path_factory.mktemp("ref")
            for a in REF_ARCHS:
                path = str(d / f"{a}.npz")
                procs[a] = (_start_reference(("train", a), path), path)
        if arch not in runs:
            proc, path = procs[arch]
            runs[arch] = (_finish_reference(proc, path), path)
        return runs[arch]
    yield get
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("shape", child.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_sharded_training_matches_the_references_mesh_run(
        arch, shape, reference_training, tmp_path):
    ref, path = reference_training(arch)
    tag = "x".join(map(str, shape))
    got = child.run_world("train", (arch, shape, path),
                          str(tmp_path / "out.npz"))
    want = tag
    if arch.startswith("granite") and shape[0] > 1:
        # the reference's own mesh run moves off its unsharded one there
        # (its aux is the data shard's): held to the unsharded run
        want = "none"
        assert _rel(ref[f"{tag}/losses"], ref["none/losses"]) > 1e-4
        assert _rel(ref[f"{tag}/params/layers/moe/router"],
                    ref["none/params/layers/moe/router"]) > 1e-4
    np.testing.assert_allclose(got["losses"], ref[f"{want}/losses"],
                               rtol=REF_LOSS_RTOL, atol=0)
    zero_init = {k[len("init/params/"):] for k, v in ref.items()
                 if k.startswith("init/params/") and not v.any()}
    for k, leaf in ref.items():
        if not k.startswith(f"{want}/params/"):
            continue
        name = k[len(f"{want}/params/"):]
        tol = REF_ZERO_INIT_TOL if name in zero_init else REF_LEAF_TOL
        assert _rel(got[name], leaf) <= tol, (name, _rel(got[name], leaf))


@pytest.mark.parametrize("capacity_factor", [2.0, 1.0],
                         ids=["no_drops", "drops"])
def test_moe_mesh_path_matches_the_references_shard_map(capacity_factor,
                                                        tmp_path):
    from repro_torch.models import blocks
    cfg, p, x = child.moe_inputs("granite-moe-1b-a400m")
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, capacity_factor=np.array(capacity_factor),
             x=x.numpy(), **{k: v.numpy() for k, v in p.items()})
    ref = _reference(("moe", inputs), str(tmp_path / "ref.npz"))
    got = child.run_world("moe", ("granite-moe-1b-a400m", inputs),
                          str(tmp_path / "out.npz"))
    cfg, p, x = child.moe_inputs_from(inputs)
    with torch.no_grad():
        y, aux = blocks.moe_fwd(p, x, cfg)
    assert np.abs(y.numpy() - ref["none/y"]).max() <= MOE_ATOL
    assert abs(float(aux) - float(ref["none/aux"])) <= MOE_ATOL
    for shape in child.MESHES:
        tag = "x".join(map(str, shape))
        assert np.abs(got[f"{tag}:y"] - ref[f"{tag}/y"]).max() <= MOE_ATOL
        # aux: the reference's mesh value where data is not sharded, its
        # one-device value where it is (module docstring)
        want = ref[f"{tag}/aux"] if shape[0] == 1 else ref["none/aux"]
        assert abs(float(got[f"{tag}:aux"]) - float(want)) <= MOE_ATOL, tag
    if capacity_factor < 2:  # per-shard capacity drops other assignments
        assert np.abs(ref["2x1/y"] - ref["none/y"]).max() > 1e-3


@pytest.mark.parametrize("shape", child.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m"])
def test_sharded_training_matches_one_device(arch, shape, tmp_path):
    ref_losses, ref_leaves = child.train(arch)
    got = child.run_world("train", (arch, shape), str(tmp_path / "out.npz"))
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=LEAF_RTOL,
                               atol=0)
    for k, want in ref_leaves.items():
        tol = NOISE_RTOL if k in NOISE_LEAVES else LEAF_RTOL
        assert _rel(got[k], want) <= tol, k


def test_moe_mesh_path_matches_the_single_device_dispatch(tmp_path):
    from repro_torch.models import blocks
    arch = "granite-moe-1b-a400m"
    cfg, p, x = child.moe_inputs(arch)
    with torch.no_grad():
        y, aux = blocks.moe_fwd(p, x, cfg)
    got = child.run_world("moe", (arch,), str(tmp_path / "out.npz"))
    for shape in child.MESHES:
        tag = "x".join(map(str, shape))
        assert np.abs(got[f"{tag}:y"] - y.numpy()).max() <= 2e-4, tag
        assert abs(float(got[f"{tag}:aux"]) - float(aux)) <= 2e-4, tag


def test_checkpoint_reshards_across_meshes(tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.param import tree_leaves
    arch = "qwen2.5-3b"
    got = child.run_world("ckpt", (arch, str(tmp_path / "ck")),
                          str(tmp_path / "out.npz"))
    assert str(got["extras_mesh"]) == "1x2"
    _, fresh, _, _ = child.setup(arch)
    one, extras = CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    assert extras == {"mesh": "1x2"}
    n = 0
    for k, v in tree_leaves(one.params):
        assert v.requires_grad and v.device.type == "cpu"
        np.testing.assert_array_equal(got["params/" + "/".join(k)],
                                      v.detach().numpy())
        n += 1
    for name in ("m", "v"):
        for k, v in tree_leaves(one.opt_state[name]):
            np.testing.assert_array_equal(got[f"{name}/" + "/".join(k)],
                                          v.numpy())
    assert n == len(list(tree_leaves(fresh.params)))
    # the restored state is the trained one, not the fresh target's
    assert any(not np.array_equal(v.detach().numpy(), w.detach().numpy())
               for (_, v), (_, w) in zip(tree_leaves(one.params),
                                         tree_leaves(fresh.params)))


def test_restore_places_leaves_by_a_placements_tree(tmp_path):
    """``restore(target, placements=tree, mesh=mesh)``: every tensor leaf
    of a plain target lands as a DTensor with its entry's placements (a
    one-rank world of this process, destroyed with the block)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel.dist import make_mesh, single_process_world
    from repro_torch.train.steps import TrainState
    g = torch.Generator().manual_seed(0)
    st = TrainState({"w": torch.randn((4, 2), generator=g),
                     "b": torch.zeros(2)},
                    {"m": {"w": torch.ones(4, 2), "b": torch.ones(2)},
                     "step": torch.tensor(3, dtype=torch.int32)},
                    torch.tensor(3, dtype=torch.int32))
    cm = CheckpointManager(str(tmp_path))
    with single_process_world("cpu"):
        cm.save(1, st, blocking=True)
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        rep = (Replicate(), Replicate())
        pl = TrainState({"w": rep, "b": rep},
                        {"m": {"w": rep, "b": rep}, "step": rep}, rep)
        got, _ = cm.restore(st, placements=pl, mesh=mesh)
        for a, b in ((got.params["w"], st.params["w"]),
                     (got.opt_state["m"]["b"], st.opt_state["m"]["b"]),
                     (got.step, st.step)):
            assert isinstance(a, DTensor) and tuple(a.placements) == rep
            assert torch.equal(a.full_tensor(), b)
    assert not dist.is_initialized()
