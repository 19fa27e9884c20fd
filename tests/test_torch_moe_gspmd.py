"""The port's default MoE dispatch on a mesh (``blocks._moe_gspmd``,
GSPMD's semantics) against the JAX package's default on the same mesh
(``_moe_group`` partitioned by XLA, ``MOE_SHARD_MAP`` off), on the CPU in
float32.

The reference runs in a child with 4 XLA host devices
(``tests/_jax_moe_gspmd_reference.py``); the port in gloo worlds of 2
processes for the (1, 2) and (2, 1) meshes and of 4 for (2, 2)
(``tests/_torch_parallel_child.py``; the pytest worker never holds a
process group).

* The reduced granite-moe-1b-a400m's ``moe_fwd`` on (4, 32, D) inputs,
  at capacity factor 2 (no drops) and 1 (drops): y within 2e-4 max abs
  (``tests/test_moe_dispatch.py``'s bar) of the reference's mesh run and
  of the port's own single-device dispatch, aux within 1e-6 relative, and
  the kept (token, slot) assignments -- those the ranks' dispatches kept
  (``blocks.moe_slots``), and the whole group's capacity rule over the
  experts they routed to -- equal to the reference's. At capacity factor
  1 the shard-mapped dispatch (``_moe_smap``) keeps other assignments on
  a data-sharded mesh (a data shard's 16 tokens get 8 slots an expert
  where the whole group's 32 get 16: the per-shard rule over the same
  experts), and its y moves off: the semantics this path restores.
* ``launch.train``'s loop on (1, 2) and (2, 1), 3 steps of the reduced
  granite from the reference's initial state (a checkpoint the loop
  resumes from) on its data, its train step in float32: through
  ``_moe_gspmd`` and never ``_moe_smap``, and held to the reference's
  jitted sharded train step by ``tests/_torch_train_common.py``'s bars (loss
  1e-5 relative, leaves 1e-4 relative L2, zero-initialized leaves 1e-2).
  The training runs at the reduced config's own capacity factor 2: at 1,
  the reference's (2, 1) run itself moves off its unsharded one by
  4.7e-4 relative on its second loss, its first loss equal
  (``_jax_moe_gspmd_reference.py train 1.0``: a routing decision
  flipped by reduction-order noise), so no fixed bar between two
  implementations holds there; the forward at capacity factor 1 is the
  first bullet's.
* A layer's recompute under remat "full" sees its forward's mesh and
  rules: a backward run on a thread of its own (which, like the autograd
  engine's device thread for CUDA tensors, does not inherit the context
  variables) gives the same gradients bit for bit as one run on the
  calling thread, on (2, 1) and (1, 2).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parallel_child as child  # noqa: E402

ARCH = "granite-moe-1b-a400m"
REF_CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_jax_moe_gspmd_reference.py")
MESHES = ((1, 2), (2, 1), (2, 2))
TRAIN_MESHES = {(1, 2): "1x2", (2, 1): "data=2,model=1"}
MOE_ATOL = 2e-4  # tests/test_moe_dispatch.py's bar
AUX_RTOL = 1e-6
LOSS_RTOL, LEAF_TOL, ZERO_INIT_TOL = 1e-5, 1e-4, 1e-2
TRAIN_CF = 2.0  # the reduced config's own capacity factor


def _start_reference(args: tuple, path: str):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(REF_CHILD)), "src"),
        JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, REF_CHILD, *args, path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish_reference(proc, path: str) -> dict:
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def kept_of(experts, cfg, n_shards: int):
    """(B, S, K) bool: the assignments of ``experts`` (B, S, K) that a
    capacity rule keeps over ``moe_fwd``'s groups, each group's tokens
    split into ``n_shards`` data shards of B / n_shards rows that each
    rank and count alone (1: the whole group, as on one device)."""
    mo = cfg.moe
    B, S, K = experts.shape
    G = min(mo.group_size, B * S)
    gs = max(1, G // B)
    if S % gs != 0:
        gs = 1
    nc, b = S // gs, B // n_shards
    from repro_torch.models.blocks import moe_capacity
    C = moe_capacity(b * gs, cfg)
    out = np.zeros_like(experts, dtype=bool)
    for d in range(n_shards):
        rows = experts[d * b:(d + 1) * b]             # (b, S, K)
        grp = rows.reshape(b, nc, gs, K).transpose(1, 0, 2, 3) \
            .reshape(nc, b * gs * K)
        sel = grp[..., None] == np.arange(mo.n_experts)
        pos = (np.cumsum(sel, axis=1) - sel)[sel].reshape(grp.shape)
        keep = (pos < C).reshape(nc, b, gs, K).transpose(1, 0, 2, 3)
        out[d * b:(d + 1) * b] = keep.reshape(b, S, K)
    return out


@pytest.fixture(scope="module")
def dispatch_runs(tmp_path_factory):
    """Per capacity factor: the inputs' config, the reference's runs,
    the port's single-device y and aux, and each mesh's port run; made at
    the first call for both capacity factors, the reference's children
    side by side."""
    d = tmp_path_factory.mktemp("moe")
    cfg, p, x = child.moe_inputs(ARCH)
    procs = {}
    for cf in (2.0, 1.0):
        inputs = str(d / f"inputs_{cf}.npz")
        np.savez(inputs, capacity_factor=np.array(cf), x=x.numpy(),
                 **{k: v.numpy() for k, v in p.items()})
        procs[cf] = (inputs, _start_reference(("moe", inputs),
                                              str(d / f"ref_{cf}.npz")))
    runs = {}
    try:
        for cf, (inputs, proc) in procs.items():
            c, pc, xc = child.moe_inputs_from(inputs)
            from repro_torch.models import blocks
            with torch.no_grad():
                y, aux = blocks.moe_fwd(pc, xc, c)
            meshes = {}
            for shape in MESHES:
                tag = "x".join(map(str, shape))
                meshes[shape] = child.run_world(
                    "moe_dispatch", (inputs, shape),
                    str(d / f"port_{cf}_{tag}.npz"), world=shape[0] * shape[1])
            ref = _finish_reference(proc, str(d / f"ref_{cf}.npz"))
            runs[cf] = (c, ref, y.numpy(), float(aux), meshes)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return runs


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("capacity_factor", [2.0, 1.0],
                         ids=["no_drops", "drops"])
def test_gspmd_dispatch_matches_the_references_mesh_run(
        capacity_factor, shape, dispatch_runs):
    cfg, ref, y1, aux1, meshes = dispatch_runs[capacity_factor]
    tag = "x".join(map(str, shape))
    got = meshes[shape]
    y = got["gspmd:y"]
    assert np.abs(y - ref[f"{tag}/y"]).max() <= MOE_ATOL
    assert np.abs(y - y1).max() <= MOE_ATOL
    want_aux = float(ref[f"{tag}/aux"])
    assert abs(float(got["gspmd:aux"]) - want_aux) <= AUX_RTOL * want_aux
    assert abs(aux1 - want_aux) <= AUX_RTOL * want_aux
    kept = got["gspmd:kept"]
    np.testing.assert_array_equal(kept, ref[f"{tag}/kept"])
    np.testing.assert_array_equal(kept_of(got["gspmd:experts"], cfg, 1),
                                  kept)
    if capacity_factor < 2:  # drops happen, and are the whole group's
        assert (~kept).sum() > 0


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_map_drops_other_slots_at_capacity_factor_1(shape,
                                                          dispatch_runs):
    cfg, ref, y1, _, meshes = dispatch_runs[1.0]
    tag = "x".join(map(str, shape))
    got = meshes[shape]
    # the same experts chosen; a data shard's capacity keeps others
    np.testing.assert_array_equal(got["shard_map:experts"],
                                  got["gspmd:experts"])
    smap_kept = got["shard_map:kept"]
    np.testing.assert_array_equal(
        kept_of(got["shard_map:experts"], cfg, shape[0]), smap_kept)
    differ = int((smap_kept != ref[f"{tag}/kept"]).sum())
    assert differ > 0
    assert np.abs(got["shard_map:y"] - ref[f"{tag}/y"]).max() > 1e-3
    assert np.abs(got["gspmd:y"] - ref[f"{tag}/y"]).max() <= MOE_ATOL


@pytest.fixture(scope="module")
def reference_training(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_train")
    path = str(d / "train.npz")
    return _finish_reference(_start_reference(("train", str(TRAIN_CF)),
                                              path), path)


@pytest.mark.parametrize("shape", list(TRAIN_MESHES),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_launch_train_on_a_mesh_matches_the_references_gspmd_run(
        shape, reference_training, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.param import tree_leaves
    ref = reference_training
    tag = "x".join(map(str, shape))
    init = str(tmp_path / "ref.npz")
    np.savez(init, **{k: v for k, v in ref.items()
                      if k.startswith("init/")})
    _, state, _, _ = child.setup_from(ARCH, init)
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(0, state, blocking=True)
    got = child.run_world("launch_train", (ARCH, TRAIN_MESHES[shape], ckpt),
                          str(tmp_path / "out.npz"))
    # the default dispatch on a mesh is GSPMD's, never the shard-mapped one
    assert int(got["gspmd_calls"]) > 0 and int(got["smap_calls"]) == 0
    np.testing.assert_allclose(got["losses"], ref[f"{tag}/losses"],
                               rtol=LOSS_RTOL, atol=0)
    _, fresh, _, _ = child.setup(ARCH)
    final, _ = CheckpointManager(ckpt).restore(fresh)
    assert int(final.step) == child.STEPS
    zero_init = {k[len("init/params/"):] for k, v in ref.items()
                 if k.startswith("init/params/") and not v.any()}
    leaves = dict(tree_leaves(final.params))
    n = 0
    for k, want in ref.items():
        if not k.startswith(f"{tag}/params/"):
            continue
        name = k[len(f"{tag}/params/"):]
        tol = ZERO_INIT_TOL if name in zero_init else LEAF_TOL
        leaf = leaves[tuple(name.split("/"))].detach().numpy()
        assert _rel(leaf, want) <= tol, (name, _rel(leaf, want))
        n += 1
    assert n == len(leaves)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_backward_on_another_thread_recomputes_on_the_mesh(shape,
                                                             tmp_path):
    got = child.run_world("thread_backward", (ARCH, shape),
                          str(tmp_path / "out.npz"))
    same = {k[len("same/"):]: v for k, v in got.items()
            if k.startswith("same/")}
    assert same
    for k, v in same.items():
        np.testing.assert_array_equal(got[f"thread/{k}"], v, err_msg=k)
