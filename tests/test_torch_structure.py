"""Structure of the port: what it may import, where a library call that
does a kernel's job (a scatter-add, fused attention) may appear, and that
it needs neither ``nvcc`` nor a card to be imported.
"""
import ast
import importlib
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
AB = ROOT / "chip_ab.py"
K2_PROBE = ROOT / "chip_k2_readahead.py"
WINDOW_PROBE = ROOT / "chip_profiler_window.py"
B7_VARIANTS = ROOT / "chip_b7_variants.py"
ATTN_BITS = ROOT / "chip_attention_bits.py"
EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
# the gloo workers of tests/test_torch_parallel.py and
# tests/test_torch_sweep_mesh.py import the port alone
PARALLEL_CHILD = ROOT / "tests" / "_torch_parallel_child.py"
MESH_CHILDREN = [ROOT / "tests" / "_torch_sweep_mesh_child.py",
                 ROOT / "tests" / "_torch_guard_resume_child.py"]
# the twins of examples/ (every file of examples_torch/ is checked)
POWER_EXAMPLES = ("power_gating_study", "fleet_day", "chaos_day")
PY_FILES = sorted(PKG.rglob("*.py")) + [SMOKE, AB, K2_PROBE, WINDOW_PROBE,
                                         B7_VARIANTS, ATTN_BITS,
                                         PARALLEL_CHILD] + MESH_CHILDREN \
    + EXAMPLES

FOREIGN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)", re.MULTILINE)
# one PyTorch call that does a kernel's job: never on the CUDA path
LIBRARY_CALLS = {"index_add_", "index_add", "scatter_add", "scatter_add_",
                 "segment_reduce", "bincount", "compile",
                 "scaled_dot_product_attention", "flash_attention_forward",
                 "multi_head_attention_forward"}

MODULES = ["repro_torch", "repro_torch.convert", "repro_torch.configs.base",
           "repro_torch.core", "repro_torch.core.hw",
           "repro_torch.core.power", "repro_torch.core.opgen",
           "repro_torch.core.sa_gating", "repro_torch.core.session",
           "repro_torch.core.backend", "repro_torch.core.policies",
           "repro_torch.core.sweep", "repro_torch.core.isa",
           "repro_torch.core.passes", "repro_torch.core.lowering",
           "repro_torch.core.program_plane", "repro_torch.core.perturb",
           "repro_torch.core.ici_topology", "repro_torch.core.carbon",
           "repro_torch.core.slo", "repro_torch.core.faults",
           "repro_torch.core.guard", "repro_torch.core.fleet",
           "repro_torch.kernels.program_exec",
           "repro_torch.kernels._build",
           "repro_torch.kernels.sa_occupancy",
           "repro_torch.kernels.segment_sum", "repro_torch.configs",
           "repro_torch.configs.qwen2_5_3b", "repro_torch.kernels.ref",
           "repro_torch.kernels.flash_attention",
           "repro_torch.kernels.decode_attention",
           "repro_torch.kernels.ssd_scan", "repro_torch.kernels.ops",
           "repro_torch.kernels.gated_matmul",
           "repro_torch.models.param", "repro_torch.models.common",
           "repro_torch.models.blocks", "repro_torch.models.registry",
           "repro_torch.models.model", "repro_torch.train.steps",
           "repro_torch.launch.serve",
           "repro_torch.kernels.flash_attention_bwd", "repro_torch.optim",
           "repro_torch.optim.adamw", "repro_torch.optim.compression",
           "repro_torch.data", "repro_torch.data.specs",
           "repro_torch.data.pipeline", "repro_torch.checkpoint",
           "repro_torch.checkpoint.manager", "repro_torch.train",
           "repro_torch.launch.train", "repro_torch.parallel",
           "repro_torch.parallel.dist", "repro_torch.parallel.sharding",
           "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
           "repro_torch.core.costs", "repro_torch.core.roofline"]
CONFIG_FILES = ["deepseek_v2_236b", "granite_moe_1b", "hubert_xlarge",
                "hymba_1_5b", "mamba2_780m", "paligemma_3b", "qwen1_5_4b",
                "qwen2_5_14b", "qwen2_5_3b", "qwen3_32b"]


def _run(code_or_path, *, cwd=None, env_extra=None, script=False):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "PYTHONPATH")}
    env.update(PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    cmd = [sys.executable] + ([str(code_or_path)] if script
                              else ["-c", code_or_path])
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_slice_modules_exist():
    for rel in ("__init__.py", "convert.py", "configs/base.py",
                "core/__init__.py", "core/hw.py", "core/power.py",
                "core/opgen.py", "core/sa_gating.py", "core/session.py",
                "core/backend.py", "core/policies.py", "core/sweep.py",
                "kernels/_build.py", "kernels/sa_occupancy.py",
                "kernels/segment_sum.py", "kernels/csrc/power_plane.cu",
                "kernels/ref.py", "kernels/ops.py",
                "kernels/flash_attention.py", "kernels/decode_attention.py",
                "kernels/csrc/attention.cu", "kernels/ssd_scan.py",
                "kernels/csrc/ssd_scan.cu", "kernels/gated_matmul.py",
                "kernels/csrc/gated_matmul.cu", "core/isa.py",
                "core/passes.py", "core/lowering.py",
                "core/program_plane.py", "core/perturb.py",
                "core/ici_topology.py", "core/carbon.py", "core/slo.py",
                "kernels/program_exec.py", "kernels/csrc/program_plane.cu",
                "core/faults.py", "core/guard.py", "core/fleet.py",
                "models/param.py",
                "models/common.py", "models/blocks.py", "models/registry.py",
                "models/model.py", "train/steps.py", "launch/serve.py",
                "kernels/flash_attention_bwd.py",
                "kernels/csrc/attention_bwd.cu", "optim/__init__.py",
                "optim/adamw.py", "optim/compression.py", "data/__init__.py",
                "data/specs.py", "data/pipeline.py",
                "checkpoint/__init__.py", "checkpoint/manager.py",
                "train/__init__.py", "launch/train.py",
                "parallel/__init__.py", "parallel/dist.py",
                "parallel/sharding.py", "launch/mesh.py",
                "launch/dryrun.py", "core/costs.py", "core/roofline.py",
                "launch/sweep.py",
                *(f"configs/{c}.py" for c in CONFIG_FILES)):
        assert (PKG / rel).is_file(), rel
    assert SMOKE.is_file()
    assert [p.name for p in EXAMPLES] == sorted(
        ["quickstart.py", "serve_batched.py", "train_e2e.py",
         *(f"{n}.py" for n in POWER_EXAMPLES)])


@pytest.mark.parametrize("path", PY_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PY_FILES])
def test_no_jax_and_no_reference_package_imports(path):
    hits = FOREIGN_IMPORT.findall(path.read_text())
    assert not hits, (path, hits)


@pytest.mark.parametrize("first", ["repro_torch.core",
                                   "repro_torch.core.fleet",
                                   "repro_torch.core.guard",
                                   "repro_torch.kernels.sa_occupancy",
                                   "repro_torch.kernels.segment_sum",
                                   "repro_torch.kernels.gated_matmul",
                                   "repro_torch.kernels.program_exec",
                                   "repro_torch.core.program_plane",
                                   "repro_torch.launch.serve",
                                   "repro_torch.launch.train"])
def test_imports_with_nvcc_absent(first):
    """Every module imports with no ``nvcc`` reachable and pulls in
    neither jax nor the reference package, whichever sub-package is
    imported first (``core.backend`` and ``kernels`` import each
    other)."""
    code = (f"import sys, shutil, importlib\n"
            f"assert shutil.which('nvcc') is None\n"
            f"importlib.import_module({first!r})\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m == 'jax' or "
            f"m.startswith('jax.') or m == 'repro' or "
            f"m.startswith('repro.')]\n"
            f"assert not bad, bad\n"
            f"from repro_torch.kernels import _build\n"
            f"assert _build._LIBS == {{}}\n")
    proc = _run(code, env_extra={"PATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]


# the host-numpy functions that may call np.bincount
HOST_BINCOUNT = {"_host_columns", "_batch_ctx", "bin_requests"}


def test_library_scatter_adds_only_in_plain_versions():
    """``index_add_`` & co. appear in the package only inside a kernel's
    plain version (``*_plain``); ``np.bincount`` only in host-side numpy
    (trace preparation, the numpy batched engine's context, binning
    arrival timestamps), never on tensors."""
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        spans = [(n.lineno, n.end_lineno, n.name) for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Attribute)
                    and node.attr in LIBRARY_CALLS):
                continue
            owners = [name for lo, hi, name in spans
                      if lo <= node.lineno <= hi]
            base = node.value.id if isinstance(node.value, ast.Name) else ""
            if node.attr == "bincount" and base == "np":
                assert owners and owners[-1] in HOST_BINCOUNT, \
                    (path, node.lineno)
                continue
            assert owners and owners[-1].endswith("_plain"), \
                (path.name, node.lineno, node.attr, owners)


CUDA_SOURCES = {
    "power_plane.cu": (("sa_occupancy_launch", "segment_sum_launch"),
                       ("src/repro/kernels/sa_occupancy.py",
                        "jax.ops.segment_sum")),
    "attention.cu": (("flash_attention_launch", "decode_attention_launch"),
                     ("src/repro/kernels/flash_attention.py",
                      "src/repro/kernels/decode_attention.py")),
    "attention_bwd.cu": (("flash_attention_bwd_launch",),
                         ("src/repro/models/common.py:281-300",)),
    "ssd_scan.cu": (("ssd_scan_launch", "ssd_scan_bf16_launch"),
                    ("src/repro/kernels/ssd_scan.py",)),
    "gated_matmul.cu": (("gated_matmul_launch",),
                        ("src/repro/kernels/gated_matmul.py",)),
    "program_plane.cu": (("program_exec_launch",),
                         ("src/repro/core/backend.py:218",
                          "src/repro/core/program_plane.py:182-278")),
}
# the one atomic the sources may hold: B2's integer count of executed
# tiles (integer adds commute, so the count is exact); no float atomics
ATOMICS = {"gated_matmul.cu": ["tiles_run"]}


@pytest.mark.parametrize("source", sorted(CUDA_SOURCES))
def test_cuda_source_says_what_it_replaces(source):
    cu = (PKG / "kernels" / "csrc" / source).read_text()
    launchers, replaced = CUDA_SOURCES[source]
    for name in launchers:
        assert f'extern "C" int {name}' in cu
    for ref in replaced:
        assert ref in cu
    assert "torch/extension.h" not in cu
    assert re.findall(r"atomicAdd\(\s*(\w+)\s*,", cu) \
        == ATOMICS.get(source, [])
    assert cu.count("atomicAdd") == len(ATOMICS.get(source, []))
    assert cu.count("cudaGetLastError()") >= len(launchers)
    # every source is a library of its own with its own flags
    from repro_torch.kernels import _build
    assert any(lib.source.name == source
               for lib in _build.LIBRARIES.values())


def test_cpu_tensors_never_reach_the_kernels():
    import numpy as np
    from repro_torch.core.opgen import paper_suite
    from repro_torch.kernels import _build
    from repro_torch.kernels.sa_occupancy import sa_occupancy
    from repro_torch.kernels.segment_sum import segment_sum
    sweep = importlib.import_module("repro_torch.core.sweep").sweep
    k1, k2, libs = sa_occupancy.launches, segment_sum.launches, \
        dict(_build._LIBS)
    recs = sweep(paper_suite()[12:14], device="cpu")
    assert recs and all(np.isfinite(r["total_j"]) for r in recs)
    assert (sa_occupancy.launches, segment_sum.launches) == (k1, k2)
    assert _build._LIBS == libs  # nothing was built or loaded


def _assert_binding_declares_every_argument(source, launcher, bind,
                                            others=()):
    """ctypes passes an undeclared argument as a 32-bit int and would cut
    a pointer: every parameter of the C launcher has an argtype of its
    C type (``others``: the library's other launchers, which ``bind``
    declares too)."""
    import ctypes
    cu = (PKG / "kernels" / "csrc" / source).read_text()
    sig = cu[cu.index(f'extern "C" int {launcher}('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    fake = type("Fake", (), {name: type("F", (), {})()
                             for name in (launcher, *others)})
    bind(fake)
    types = getattr(fake, launcher).argtypes
    assert len(types) == len(params)
    scalars = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
               "float": ctypes.c_float, "double": ctypes.c_double}
    for t, decl in zip(types, params):
        want = ctypes.c_void_p if "*" in decl \
            else scalars[decl.split()[0]]
        assert t is want, decl
    assert getattr(fake, launcher).restype is ctypes.c_int


SSD_LAUNCHERS = ("ssd_scan_launch", "ssd_scan_bf16_launch",
                 "ssd_scan_bf16_occupancy")


def test_ssd_binding_declares_every_argument():
    from repro_torch.kernels import _build
    _assert_binding_declares_every_argument(
        "ssd_scan.cu", "ssd_scan_launch", _build._bind_ssd_scan,
        others=SSD_LAUNCHERS[1:])


@pytest.mark.parametrize("launcher", SSD_LAUNCHERS[1:])
def test_ssd_bf16_binding_declares_every_argument(launcher):
    from repro_torch.kernels import _build
    _assert_binding_declares_every_argument(
        "ssd_scan.cu", launcher, _build._bind_ssd_scan,
        others=[n for n in SSD_LAUNCHERS if n != launcher])


def test_program_exec_binding_declares_every_argument():
    from repro_torch.kernels import _build
    _assert_binding_declares_every_argument(
        "program_plane.cu", "program_exec_launch", _build._bind_program_plane)


def test_gated_matmul_binding_declares_every_argument():
    from repro_torch.kernels import _build
    _assert_binding_declares_every_argument(
        "gated_matmul.cu", "gated_matmul_launch", _build._bind_gated_matmul)


@pytest.mark.parametrize("source,launcher,other,bind", [
    ("power_plane.cu", "segment_sum_launch", "sa_occupancy_launch",
     "_bind_power_plane"),
    ("power_plane.cu", "sa_occupancy_launch", "segment_sum_launch",
     "_bind_power_plane"),
    ("attention.cu", "decode_attention_launch", "flash_attention_launch",
     "_bind_attention"),
    ("attention.cu", "flash_attention_launch", "decode_attention_launch",
     "_bind_attention"),
    ("attention_bwd.cu", "flash_attention_bwd_launch", None,
     "_bind_attention_bwd")])
def test_binding_declares_every_argument(source, launcher, other, bind):
    from repro_torch.kernels import _build
    _assert_binding_declares_every_argument(
        source, launcher, getattr(_build, bind),
        others=() if other is None else (other,))


def test_fmad_off_only_where_bits_are_promised():
    from repro_torch.kernels import _build
    assert "-fmad=false" in _build.LIBRARIES["power_plane"].flags
    assert "-fmad=false" not in _build.LIBRARIES["attention"].flags
    assert "-fmad=false" not in _build.LIBRARIES["attention_bwd"].flags
    assert "-fmad=false" not in _build.LIBRARIES["ssd_scan"].flags
    assert "-fmad=false" not in _build.LIBRARIES["gated_matmul"].flags
    assert all("arch=compute_90a,code=sm_90a" in lib.flags
               for lib in _build.LIBRARIES.values())


def test_chip_smoke_fails_without_a_card():
    proc = _run(SMOKE, cwd=ROOT, script=True,
                env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "FAILED" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds the script and nothing else of the
    repo there is no program to drive."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _global_kernels() -> set:
    """The names of every ``__global__`` function under ``csrc/``."""
    names = set()
    for cu in (PKG / "kernels" / "csrc").glob("*.cu"):
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", cu.read_text()))
    return names


@pytest.mark.parametrize("script", [SMOKE, AB, B7_VARIANTS],
                         ids=lambda p: p.name)
def test_profiled_kernel_names_are_defined(script):
    """Every kernel name a script looks up in the profiler is a
    ``__global__`` of ``csrc/``: a stale name would read 0 µs with no
    error."""
    looked_up = set(re.findall(r"[\"'](\w+_kernel)[\"']",
                               script.read_text()))
    if script == SMOKE:
        assert {"flash_attention_bf16_kernel", "flash_attention_kernel",
                "program_exec_kernel",
                "decode_attention_kernel",
                "decode_attention_combine_kernel", "ssd_scan_kernel",
                "ssd_chunk_cb_kernel", "ssd_scan_bf16_kernel",
                "gated_matmul_bf16_kernel",
                "gated_matmul_f32_kernel", "attention_bwd_delta_kernel",
                "attention_bwd_dkdv_kernel", "attention_bwd_reduce_kernel",
                "attention_bwd_dq_kernel", "attention_bwd_dkdv_bf16_kernel",
                "attention_bwd_dq_bf16_kernel"} <= looked_up
    assert looked_up <= _global_kernels(), looked_up - _global_kernels()


def test_bf16_kernels_share_the_tensor_core_header(tmp_path, monkeypatch):
    """The bf16 kernels take ldmatrix / mma.sync / TMA from one header,
    and a library older than that header is rebuilt."""
    from repro_torch.kernels import _build
    csrc = PKG / "kernels" / "csrc"
    header = csrc / "mma_bf16.cuh"
    for source in ("attention.cu", "attention_bwd.cu", "gated_matmul.cu",
                   "ssd_scan.cu", "ssd_scan_bwd.cu"):
        cu = (csrc / source).read_text()
        assert '#include "mma_bf16.cuh"' in cu
        assert "asm" not in cu  # every PTX instruction is in the header
    assert "cp.async.bulk.tensor" in header.read_text()
    build, inc = tmp_path / "build", tmp_path / "csrc"
    build.mkdir()
    inc.mkdir()
    shutil.copy(header, inc / header.name)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "CSRC", inc)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    t = max(lib.source.stat().st_mtime
            for lib in _build.LIBRARIES.values()) + 100.0
    for name in _build.LIBRARIES:
        _build.library_path(name).write_bytes(b"")
        os.utime(_build.library_path(name), (t, t))
    for header_time, stale in ((t - 50.0, set()),
                               (t + 50.0, set(_build.LIBRARIES))):
        os.utime(inc / header.name, (header_time, header_time))
        assert set(_build._stale()) == stale


def _function_source(path, name) -> str:
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(path.read_text(), fn)


def test_b7_card_path_builds_no_dense_stack():
    """On a card ``program_plane_batch`` hands B7 the ragged streams:
    its card route packs nothing dense and reaches the stream entry,
    and the one kernel's source reads streams, not an (E, R, U) stack."""
    core = PKG / "core" / "program_plane.py"
    for name in ("_run_streams", "_upload_streams"):
        body = _function_source(core, name)
        assert "_pack_dense" not in body and "program_exec(" not in body
    assert "program_exec_streams(" in _function_source(core, "_run_streams")
    batch = _function_source(core, "program_plane_batch")
    assert re.search(r'_run_streams if .*"cuda"', batch.replace("\\\n", ""))
    cu = (PKG / "kernels" / "csrc" / "program_plane.cu").read_text()
    assert cu.count("__global__") == 1
    assert "extent" not in cu and "ev_lo" in cu


def test_b7_ring_takes_its_bulk_copies_from_the_shared_header():
    """B7's ring fills shared memory by the header's 1-D bulk copies on
    its mbarriers; the source itself holds no PTX."""
    csrc = PKG / "kernels" / "csrc"
    cu = (csrc / "program_plane.cu").read_text()
    assert '#include "mma_bf16.cuh"' in cu and "asm" not in cu
    for helper in ("bulk_load_1d(", "mbar_wait(", "mbar_expect_tx(",
                   "mbar_init("):
        assert helper in cu, helper
    assert "cp.async.bulk.shared::cluster.global" in \
        (csrc / "mma_bf16.cuh").read_text()


def test_fleet_leaves_its_device_only_through_the_guard():
    """No fallback hides the device: ``fleet`` names no device of its
    own and calls the batched sweep only in ``_eval``, which hands the
    call to the guard's ladder when one is armed; the ladder is
    ``backend.failover_rungs`` (the card's has no rung below it), and
    the guard records every retry and step down."""
    fleet_src = (PKG / "core" / "fleet.py").read_text()
    tree = ast.parse(fleet_src)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    named = [n.value for n in ast.walk(tree)
             if isinstance(n, ast.Constant) and id(n) not in docs
             and n.value in ("cpu", "cuda")]
    assert not named, named
    spans = [(n.lineno, n.end_lineno, n.name) for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)]
    callers = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("evaluate_batch",
                                     "evaluate_batch_numpy"):
            # the innermost function holding the call
            callers.add(max((lo, name) for lo, hi, name in spans
                            if lo <= node.lineno <= hi)[1])
    assert callers == {"_eval"}, callers
    body = _function_source(PKG / "core" / "fleet.py", "_eval")
    assert body.index("runner.evaluate_batch") < body.index("evaluate_batch(")
    guard_src = (PKG / "core" / "guard.py").read_text()
    run = _function_source(PKG / "core" / "guard.py", "evaluate_batch")
    assert '"failover"' in run and '"retry"' in run
    assert "failover_rungs(device, mesh)" in guard_src


PLAIN_ROUTES = ("_plain", "plain_attention", "flash_attention_jax",
                "scaled_dot_product_attention")


def test_card_training_attention_is_the_hand_kernels():
    """On the card ``attention`` trains through ``KernelAttention``, whose
    forward is B3 and backward B9: no plain form, no library attention
    and no autograd through a plain version on that route (which a dry
    run's fake tensors take too); the CPU route is the plain forms, as
    the reference's."""
    common = PKG / "models" / "common.py"
    tree = ast.parse(common.read_text())
    cls = next(n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef) and n.name == "KernelAttention")
    body = ast.get_source_segment(common.read_text(), cls)
    assert "flash_attention_kernel(" in body and "return_lse=True" in body
    assert "flash_attention_bwd(" in body
    assert not any(r in body for r in PLAIN_ROUTES)
    attn = _function_source(common, "attention")
    card = attn[attn.index(
        'if q.device.type == "cuda" or costs.is_fake(q):'):
                attn.index("def plain(q, k, v):")]
    assert "KernelAttention.apply(" in card
    assert not any(r in card for r in PLAIN_ROUTES)
    bwd = _function_source(PKG / "kernels" / "flash_attention_bwd.py",
                           "flash_attention_bwd")
    after = bwd[bwd.index('if q.device.type != "cuda":'):]
    after = after[after.index("\n    ") + 1:]
    after = after[after.index("\n    if"):]  # past the CPU branch
    assert "_plain" not in after and "_build.load(" in after


def test_mla_training_on_the_card_raises_before_any_work():
    """Since B9 takes (192, 128), ``mla_fwd`` raises nothing under grad:
    it attends through ``attention``, which on the card reaches
    ``KernelAttention`` (B3 forward, B9 backward) at MLA's head dims; what
    still raises before any work is ``attention`` under grad at a pair of
    head dims outside B9's ``HEAD_DIM_PAIRS``, before
    ``KernelAttention.apply``."""
    from repro_torch.kernels.flash_attention_bwd import HEAD_DIM_PAIRS
    body = _function_source(PKG / "models" / "blocks.py", "mla_fwd")
    assert "raise" not in body and "is_grad_enabled" not in body
    assert body.index("mla_qkv(") < body.index("attention(q, k, v, ") \
        < body.index('p["wo"]')
    assert (192, 128) in HEAD_DIM_PAIRS
    attn = _function_source(PKG / "models" / "common.py", "attention")
    refuse = attn.index("if (D, Dv) not in B9_HEAD_DIM_PAIRS:")
    assert attn.index("torch.is_grad_enabled()") < refuse \
        < attn.index("raise NotImplementedError", refuse) \
        < attn.index("KernelAttention.apply(")


def test_ssd_training_on_the_card_raises_before_any_work():
    """``ssd_fwd`` on the card with grad enabled reaches ``KernelSSD``
    (B5 forward, B10 backward) and no plain scan; the raw wrappers, which
    have no autograd of their own, still refuse a gradient before any
    work (``_build.check_no_grad``) -- ``KernelSSD`` calls them with grad
    off. ``ssd_fwd``'s scan on plain tensors is ``_ssd_scan_any`` (on a
    mesh, each device's shards go through it)."""
    body = _function_source(PKG / "models" / "blocks.py", "_ssd_scan_any")
    card = body[body.index('if x.device.type == "cuda" or costs.is_fake(x):'):
                body.index("    nh = x.shape[2]")]
    assert "torch.is_grad_enabled()" in card
    assert card.index("KernelSSD.apply(") < card.index("ssd_scan(")
    assert "_plain" not in card and "_ssd_chunk_scan" not in card
    assert "raise NotImplementedError" not in body
    fn = _function_source(PKG / "models" / "blocks.py", "backward")
    assert "ssd_scan_bwd(" in fn
    for source, fn in (("flash_attention.py", "flash_attention"),
                       ("decode_attention.py", "decode_attention"),
                       ("ssd_scan.py", "ssd_scan"),
                       ("ssd_scan_bwd.py", "ssd_scan_bwd"),
                       ("gated_matmul.py", "gated_matmul_p"),
                       ("flash_attention_bwd.py", "flash_attention_bwd")):
        body = _function_source(PKG / "kernels" / source, fn)
        assert body.index("_build.check_no_grad(") < body.index(
            "_build.load("), source
