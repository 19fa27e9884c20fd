"""The port's cost counter and dry run against the JAX package's HLO
analysis, on the CPU.

* The counter's FLOPs of a reduced prefill step (S 256, so that the
  reference takes its dense ``plain_attention``) against
  ``repro.core.hlo.analyze`` of the reference's jitted step: hubert-xlarge
  (bidirectional) within 1 %; qwen2.5-3b within 1 % once the causal
  mask's dead pairs, which the reference's dense attention computes and
  B3's count skips (4 B H D a pair), are added back.
* The per-device argument bytes of a reduced train step on the (2, 2) and
  (4, 1) meshes against the reference's
  ``compiled.memory_analysis().argument_size_in_bytes``, taken in a child
  process with 4 host devices (the dry run's XLA flag must be set before
  jax starts, and never in a pytest worker): equal but for the port's
  int64 token and label ids (4 more bytes an id).
* The dry run's cells of each family at full width and 2 layers (one
  microbatch) on the (16, 16) fake mesh: ok, fitting 80 GB, the argument
  bytes the resolved specs give, the hand kernels' calls -- the MoE
  archs under both dispatches, GSPMD's (the default, as the
  reference's ``--moe``) and the shard-mapped one, at train_4k and at
  the serving cells; statuses equal the reference's
  ``supported_shapes``; the hill-climb toggles (``--attention
  triangle``, ``--segments``) give the baseline's terms.
* A real step on a one-rank (1, 1) CPU mesh counts the FLOPs of the same
  step under fake tensors (1e-9).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core.costs import CostCounter  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel.dist import fake_world, make_mesh  # noqa: E402
from repro_torch.parallel.sharding import RULE_VARIANTS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFILL = ShapeConfig("prefill_small", 256, 2, "prefill")
TRAIN = ShapeConfig("train_small", 64, 8, "train")


def _reference_prefill_flops(arch: str) -> float:
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_arch as ref_arch
    from repro.core import hlo
    from repro.data.specs import batch_specs
    from repro.models import model as RM
    from repro.models import registry
    from repro.models.param import is_spec
    from repro.train.steps import make_prefill_step
    cfg = ref_arch(arch).reduced()
    specs = registry.param_specs(cfg)
    p_sds = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating)
        else s.dtype), specs, is_leaf=is_spec)
    if cfg.encoder_only:
        def fn(params, batch):
            return RM.forward(params, batch, cfg, remat="none",
                              dtype=jnp.bfloat16)[0]
    else:
        fn = make_prefill_step(cfg, remat="none", dtype=jnp.bfloat16)
    text = jax.jit(fn).lower(p_sds, batch_specs(cfg, PREFILL)) \
        .compile().as_text()
    return hlo.analyze(text).flops


def _port_prefill_flops(arch: str) -> float:
    from repro_torch.data.specs import make_batch
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params
    cfg = get_arch(arch).reduced()
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.bfloat16)
    batch = make_batch(cfg, PREFILL, seed=0, device="cpu")
    counter = CostCounter(track_memory=False)
    with torch.no_grad(), counter:
        if cfg.encoder_only:
            M.forward(params, batch, cfg, remat="none")
        else:
            M.prefill_step(params, batch, cfg)
    return counter.costs.flops, counter.costs.kernels, cfg


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2.5-3b"])
def test_counter_against_the_hlo_analyzer(arch):
    got, kernels, cfg = _port_prefill_flops(arch)
    assert kernels == {"B3": cfg.n_layers}
    want = _reference_prefill_flops(arch)
    B, S, H, D = PREFILL.global_batch, PREFILL.seq_len, cfg.n_heads, \
        cfg.head_dim
    if not cfg.encoder_only:  # the dense reference's dead causal pairs
        got += 4.0 * B * H * D * (S * (S - 1) // 2) * cfg.n_layers
    assert abs(got - want) <= 0.01 * want, (got, want, got / want - 1)


_MEMORY_CHILD = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import ShapeConfig, get_arch
    from repro.data.specs import batch_specs
    from repro.models import registry
    from repro.models.param import is_spec, tree_sds
    from repro.optim.adamw import AdamWConfig
    from repro.parallel.jax_compat import make_mesh, set_mesh
    from repro.parallel.sharding import (RULE_VARIANTS, act_pspec,
                                         param_pspec, use_rules)
    from repro.train.steps import TrainState, make_train_step
    BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                  "frames": ("batch", "seq", None),
                  "patches": ("batch", None, None), "cache_len": ()}
    arch = sys.argv[1]
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig("train_small", 64, 8, "train")
    rules = RULE_VARIANTS["baseline"]
    out = {}
    for ms in ((2, 2), (4, 1)):
        mesh = make_mesh(ms, ("data", "model"))
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        with set_mesh(mesh), use_rules(rules):
            step = make_train_step(cfg, AdamWConfig(), microbatches=1,
                                   remat="full")
            specs = registry.param_specs(cfg)
            p_ps = jax.tree.map(lambda s: param_pspec(
                rules, s.axes, s.shape, sizes), specs, is_leaf=is_spec)
            p_sds = tree_sds(specs)
            mom = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                s.shape, jnp.float32), p_sds)
            st_sds = TrainState(params=p_sds, opt_state={
                "m": mom, "v": mom,
                "step": jax.ShapeDtypeStruct((), jnp.int32)},
                step=jax.ShapeDtypeStruct((), jnp.int32))
            st_ps = TrainState(params=p_ps, opt_state={
                "m": p_ps, "v": p_ps, "step": P()}, step=P())
            b_sds = batch_specs(cfg, shape)
            b_ps = {k: act_pspec(rules, BATCH_AXES[k], s.shape, sizes)
                    for k, s in b_sds.items()}
            jitted = jax.jit(step, in_shardings=(st_ps, b_ps),
                             out_shardings=(st_ps, None),
                             donate_argnums=(0,))
            mem = jitted.lower(st_sds, b_sds).compile().memory_analysis()
            ids = sum(int(jnp.prod(jnp.array(
                [d // (sizes["data"] if i == 0 else 1)
                 for i, d in enumerate(s.shape)])))
                for k, s in b_sds.items() if s.dtype == jnp.int32)
            out["x".join(map(str, ms))] = [mem.argument_size_in_bytes, ids]
    print("ARGS", json.dumps(out))
""")


def _reference_argument_bytes(arch: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _MEMORY_CHILD, arch],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=ROOT)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("ARGS ")), None)
    assert line is not None, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(line[5:])


def _port_argument_bytes(arch: str, ms) -> int:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_arch(arch).reduced()
    rules = RULE_VARIANTS["baseline"]
    with fake_world(4):
        mesh = make_mesh(ms, ("data", "model"), "cpu")  # outside fake mode
        with FakeTensorMode(allow_non_fake_inputs=True):
            _, args, _ = dryrun.build_step(
                cfg, TRAIN, mesh, rules, microbatches=1, moment_dtype=torch.float32,
                accum_dtype=torch.float32)
    return args.bytes


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "mamba2-780m"])
def test_argument_bytes_are_the_references(arch):
    ref = _reference_argument_bytes(arch)
    for ms in ((2, 2), (4, 1)):
        want, ids = ref["x".join(map(str, ms))]
        # the port's token and label ids are int64: 4 more bytes an id
        assert _port_argument_bytes(arch, ms) == want + 4 * ids, ms


FAMILY_CELLS = [("qwen2.5-3b", "gspmd"), ("mamba2-780m", "gspmd"),
                ("hymba-1.5b", "gspmd"), ("paligemma-3b", "gspmd"),
                ("hubert-xlarge", "gspmd"),
                ("granite-moe-1b-a400m", "shard_map"),
                ("deepseek-v2-236b", "shard_map"),
                ("granite-moe-1b-a400m", "gspmd"),
                ("deepseek-v2-236b", "gspmd")]


@pytest.mark.parametrize("arch,moe", FAMILY_CELLS)
def test_reduced_dry_run_cells(arch, moe):
    r = dryrun.run_cell(arch, "train_4k", n_layers=2, microbatches=1,
                        moe=moe, dump=False)
    assert r["status"] == "ok", r.get("traceback", r["status"])
    assert r["mesh"] == "data=16xmodel=16" and r["chips"] == 256
    assert r["fits"] and 0 < r["hbm_gb_per_device"] < 80
    assert r["argument_bytes"] == r["argument_bytes_tracked"]
    assert 0 < r["flops_ratio"] <= 1.05
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    cfg = get_arch(arch)
    lead = 1 if cfg.moe and cfg.moe.first_dense_layers else 0
    want = {}
    if cfg.family != "ssm":  # forward, remat's recompute, backward
        want.update(B3=2 * 2, B9=2)
    if cfg.ssm is not None:
        want.update(B5=2 * (2 - lead), B10=2 - lead)
    assert r["kernels"] == want


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_dry_run_cells(shape):
    r = dryrun.run_cell("qwen2.5-3b", shape, n_layers=2, dump=False)
    assert r["status"] == "ok", r.get("traceback", r["status"])
    assert r["kernels"] == ({"B3": 2} if shape == "prefill_32k"
                            else {"B4": 2})
    assert r["rules"] == ("baseline" if shape == "prefill_32k"
                          else "kv_seq")


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("moe", ["gspmd", "shard_map"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-236b"])
def test_moe_serving_dry_run_cells(arch, moe, shape):
    r = dryrun.run_cell(arch, shape, n_layers=2, moe=moe, dump=False)
    assert r["status"] == "ok", r.get("traceback", r["status"])
    assert r["moe"] == moe and r["fits"]
    if shape == "prefill_32k":
        assert r["kernels"] == {"B3": 2}
    else:  # MLA decodes in its absorbed form, no B4
        assert r["kernels"] == ({} if get_arch(arch).mla else {"B4": 2})


def test_the_moe_dispatch_defaults_to_gspmd(tmp_path):
    """As the reference's ``--moe``: the CLI and ``run_cell`` take GSPMD's
    whole-group dispatch unless told otherwise."""
    import inspect
    assert inspect.signature(dryrun.run_cell).parameters["moe"].default \
        == "gspmd"
    assert dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                        "decode_32k", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "singlepod"
              / "granite-moe-1b-a400m-decode_32k.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["moe"] == "gspmd"
    assert r["kernels"] == {"B4": 24}


def test_statuses_are_the_references():
    from repro.configs.base import get_arch as ref_arch
    from repro_torch.configs.base import list_archs
    for arch in list_archs():
        assert get_arch(arch).supported_shapes() \
            == ref_arch(arch).supported_shapes(), arch
    r = dryrun.run_cell("hubert-xlarge", "decode_32k", dump=False)
    assert r["status"] == "SKIP(encoder-only: no decode step)"


TERMS = ("compute_s", "memory_s", "collective_s", "flops", "peak_bytes",
         "argument_bytes", "kernels", "dots", "status", "fits")


@functools.lru_cache(maxsize=None)
def _baseline_cell(arch: str, n_layers: int) -> dict:
    """The baseline cell (no toggle), after a first cell of the arch: the
    first cell a process counts reads a few bytes more (a lazily made
    scalar), whatever its toggles."""
    dryrun.run_cell(arch, "train_4k", n_layers=n_layers, dump=False)
    return dryrun.run_cell(arch, "train_4k", n_layers=n_layers, dump=False)


@pytest.mark.parametrize("arch,n_layers,attention,segments", [
    ("hymba-1.5b", 5, "triangle", True), ("hymba-1.5b", 5, "baseline", True),
    ("hymba-1.5b", 5, "triangle", False), ("qwen2.5-3b", 2, "triangle",
                                           False)])
def test_hillclimb_toggles_give_the_baselines_terms(arch, n_layers,
                                                    attention, segments):
    """The JAX package's hill-climbs (``--attention triangle``,
    ``--segments``) give cells with status ok and the baseline's counted
    terms: B3's cost is already its live pairs, and the port's layers
    already take Python-int windows. hymba at 5 layers has sliding layers
    (1 and 3) beside global ones. The toggles are restored after the
    cell, and the cell records them."""
    base = _baseline_cell(arch, n_layers)
    r = dryrun.run_cell(arch, "train_4k", n_layers=n_layers, dump=False,
                        attention=attention, segments=segments)
    assert r["status"] == "ok", r.get("traceback", r["status"])
    assert (r["attention"], r["segments"]) == (attention, segments)
    assert {k: r[k] for k in TERMS} == {k: base[k] for k in TERMS}
    assert common.ATTENTION_VARIANT == {"impl": "baseline"}
    assert M.STATIC_WINDOW_SEGMENTS == {"enabled": False}


def test_the_cli_takes_the_toggles(tmp_path):
    """``--attention triangle --segments`` writes a cell with status ok,
    tagged as the reference tags a cell (``--tag``)."""
    assert dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                        "--attention", "triangle", "--segments", "--tag",
                        "hill", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "singlepod" / "mamba2-780m-long_500k-hill.json") \
            as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["tag"] == "hill"
    assert (r["attention"], r["segments"]) == ("triangle", True)
    with pytest.raises(ValueError, match="attention"):
        dryrun.run_cell("qwen2.5-3b", "train_4k", attention="square",
                        dump=False)


def test_the_cli_writes_a_cell(tmp_path):
    assert dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    with open(tmp_path / "singlepod" / "mamba2-780m-long_500k.json") as f:
        r = json.load(f)
    assert r["status"] == "ok" and r["kernels"] == {}
    assert r["target"] == "h100-sxm"


def test_a_real_step_counts_what_the_fake_one_does():
    """A reduced qwen2.5-3b train step on a one-rank (1, 1) CPU mesh, run
    for real and under fake tensors: the same FLOPs and kernel calls."""
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, train_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.dist import single_process_world, use_mesh
    from repro_torch.parallel.sharding import use_rules
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         place_batch, place_state)
    from repro_torch.data.pipeline import SyntheticDataset
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_arch("qwen2.5-3b").reduced()
    rules = RULE_VARIANTS["baseline"]
    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        fake, _, _ = dryrun.count_step(cfg, TRAIN, mesh, rules,
                                       microbatches=2,
                                       moment_dtype=torch.float32,
                                       accum_dtype=torch.float32)
    opt = AdamWConfig()
    with single_process_world("cpu"):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with use_mesh(mesh), use_rules(rules), implicit_replication():
            state = place_state(TrainState.create(train_params(init_params(
                registry.param_specs(cfg), torch.Generator().manual_seed(0),
                "cpu")), opt), cfg, rules, mesh)
            batch = place_batch(SyntheticDataset(cfg, TRAIN, device="cpu")
                                .batch(0), rules, mesh, 2)
            step = make_train_step(cfg, opt, microbatches=2, remat="full")
            real = CostCounter(track_memory=False)
            with real:
                step(state, batch)
    assert real.costs.kernels == fake.costs.kernels == {"B3": 2 * 2 * 2,
                                                        "B9": 2 * 2}
    assert abs(real.costs.flops - fake.costs.flops) \
        <= 1e-9 * fake.costs.flops
    assert real.costs.dots == fake.costs.dots
