"""The port's sharding rules against the JAX package's: every arch's
parameter specs, the dry run's batch and cache axes, under the four rule
variants on the (16, 16), (2, 16, 16), (4, 2) and (1, 1) meshes -- the
resolved specs equal as tuples. Then the DTensor side: placements of a
resolved spec (pod-major over ``("pod", "data")``), ``constrain`` as a
no-op without rules or a mesh and a redistribution with both (in a fake
world of 4 ranks, destroyed after the test), and ``gather_params``."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_arch as ref_arch  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models.param import is_spec  # noqa: E402
from repro.parallel import sharding as ref  # noqa: E402

from repro_torch.configs.base import SHAPES, get_arch, list_archs  # noqa
from repro_torch.data.specs import BATCH_AXES, batch_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.param import tree_leaves  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (4, 2): ("data", "model"), (1, 1): ("data", "model")}
VARIANTS = ("baseline", "seq_parallel", "kv_seq", "moe_replicated")


def _mesh_shapes():
    return [dict(zip(axes, shape)) for shape, axes in MESHES.items()]


def _ref_leaves(tree):
    import jax
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]


def test_variants_are_the_references():
    assert tuple(sharding.RULE_VARIANTS) == tuple(ref.RULE_VARIANTS)
    for name, r in ref.RULE_VARIANTS.items():
        p = sharding.RULE_VARIANTS[name]
        assert p.param_rules == r.param_rules, name
        assert p.act_rules == r.act_rules, name


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_resolve_as_the_reference(arch, variant):
    ours = dict(tree_leaves(registry.param_specs(get_arch(arch))))
    theirs = _ref_leaves(ref_registry.param_specs(ref_arch(arch)))
    assert len(ours) == len(theirs)
    p_rules, r_rules = sharding.RULE_VARIANTS[variant], \
        ref.RULE_VARIANTS[variant]
    n = 0
    for path, s in theirs:
        key = tuple(k.key for k in path)
        mine = ours[key]
        assert (mine.shape, mine.axes) == (tuple(s.shape), tuple(s.axes))
        for ms in _mesh_shapes():
            want = tuple(ref.param_pspec(r_rules, s.axes, s.shape, ms))
            got = sharding.param_pspec(p_rules, mine.axes, mine.shape, ms)
            assert got == want, (key, ms, got, want)
            n += 1
    assert n == 4 * len(theirs)


def _reference_dryrun_names():
    """``BATCH_AXES`` and ``cache_axes`` of the JAX package's dry run, read
    from its source: importing that module sets ``XLA_FLAGS`` for 512
    devices, which a test process must not."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    tree = ast.parse(src)
    ns: dict = {"ArchConfig": object}  # its annotation's name
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "BATCH_AXES" for t in node.targets)) \
                or (isinstance(node, ast.FunctionDef)
                    and node.name == "cache_axes"):
            exec(compile(ast.Module([node], []), "dryrun", "exec"), ns)
    return ns["BATCH_AXES"], ns["cache_axes"]


def test_batch_and_cache_axes_are_the_references():
    ref_batch, ref_cache = _reference_dryrun_names()
    assert BATCH_AXES == ref_batch
    for arch in list_archs():
        assert dryrun.cache_axes(get_arch(arch)) == \
            ref_cache(ref_arch(arch), None), arch


def _cache_leaves(struct, axes):
    if not isinstance(struct[1], torch.dtype):
        for s, a in zip(struct, axes):
            yield from _cache_leaves(s, a)
    else:
        yield struct[0], axes


@pytest.mark.parametrize("variant", VARIANTS)
def test_batch_and_cache_specs_resolve_as_the_reference(variant):
    p_rules, r_rules = sharding.RULE_VARIANTS[variant], \
        ref.RULE_VARIANTS[variant]
    n = 0
    for arch in list_archs():
        cfg, rcfg = get_arch(arch), ref_arch(arch)
        for name, shape in SHAPES.items():
            if cfg.supported_shapes()[name] != "ok":
                continue
            specs = batch_specs(cfg, shape)
            for k, s in specs.items():
                for ms in _mesh_shapes():
                    want = tuple(ref.act_pspec(r_rules, BATCH_AXES[k],
                                               s.shape, ms))
                    assert sharding.act_pspec(
                        p_rules, BATCH_AXES[k], s.shape, ms) == want
                    n += 1
            if shape.kind != "decode":
                continue
            L = registry.n_scanned_layers(cfg)
            struct = M.layer_cache_struct(cfg, shape.global_batch,
                                          shape.seq_len, torch.bfloat16)
            for sh, ax in _cache_leaves(struct, dryrun.cache_axes(cfg)):
                full, axes = (L, *sh), (None, *ax)
                for ms in _mesh_shapes():
                    want = tuple(ref.act_pspec(r_rules, axes, full, ms))
                    assert sharding.act_pspec(p_rules, axes, full, ms) \
                        == want, (arch, full, ms)
                    n += 1
            assert rcfg.name == cfg.name
    assert n > 300


def test_spec_placements_are_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel.dist import fake_world, make_mesh
    with fake_world(512):
        mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), "cpu")
        assert sharding.spec_placements((("pod", "data"), "model"), mesh) \
            == (Shard(0), Shard(0), Shard(1))
        assert sharding.spec_placements((None, "model"), mesh) \
            == (Replicate(), Replicate(), Shard(1))
        assert sharding.spec_placements((), mesh) == (Replicate(),) * 3
        assert sharding.local_shape((("pod", "data"), "model"), (64, 32, 7),
                                    {"pod": 2, "data": 16, "model": 16}) \
            == (2, 2, 7)


def test_constrain_is_a_no_op_without_rules_or_mesh():
    x = torch.ones(4, 8)
    assert sharding.constrain(x, "batch", None) is x
    with sharding.use_rules(sharding.RULE_VARIANTS["baseline"]):
        assert sharding.constrain(x, "batch", None) is x
        assert sharding.current_rules().name == "baseline"
    assert sharding.current_rules() is None


def test_constrain_and_gather_on_a_mesh():
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.parallel.dist import (current_mesh, fake_world,
                                           make_mesh, use_mesh)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        x = distribute_tensor(torch.ones(8, 6), mesh,
                              (Replicate(), Replicate()), src_data_rank=None)
        with sharding.use_rules(sharding.RULE_VARIANTS["baseline"]):
            assert sharding.constrain(x, "batch", None) is x  # no mesh
            with use_mesh(mesh):
                assert current_mesh() is mesh
                y = sharding.constrain(x, "batch", "vocab")
                assert isinstance(y, DTensor)
                assert tuple(y.placements) == (Shard(0), Shard(1))
                assert y.to_local().shape == (4, 3)
                z = sharding.constrain(y, "batch", "embed")  # embed: None
                assert tuple(z.placements) == (Shard(0), Replicate())
                w = distribute_tensor(torch.ones(8, 6), mesh,
                                      (Shard(0), Shard(1)),
                                      src_data_rank=None)
                g = sharding.gather_params({"a": {"w": w}})["a"]["w"]
                assert tuple(g.placements) == (Replicate(), Shard(1))
        assert current_mesh() is None
    assert not dist.is_initialized()
