"""The power plane across ranks: the sharded sweep and the row-sharded
program plane of ``repro_torch`` in gloo worlds on the CPU
(``tests/_torch_sweep_mesh_child.py``), held to the JAX package's numpy
engine and to the port's one-device run. Mirrors
``tests/test_multidevice_sweep.py`` (8 XLA host devices there, a 4-rank
world here) and ``tests/test_backend_jax.py``'s mesh tests.

* The sweep on ``paper_suite()[:4]`` × NPU-B, NPU-E × every policy × 18
  knobs (9 width / delay triples) over the meshes ``(4,) ("knob",)``,
  ``(2, 2) ("wl", "knob")``, ``(4, 1)`` and ``(2,) ("wl",)`` -- 4 ranks
  divide neither the 18 knobs, the 9 triples, the 3 widths nor the ops,
  so every axis pads: records ≤1e-9 from the reference's
  ``sweep(..., backend="numpy")``; the knob-only mesh equal to the
  one-device run bit for bit (every op is elementwise, a gather, K1 or
  K2 row by row); with ``"wl"`` the op-axis sums are partial sums
  reduced across ranks, and a rerun on the same mesh is bit-identical;
  every rank of a mesh returns the same whole cube.
* The program plane's executor rows (5 workloads × 2 NPUs × 4 triples =
  40, which 3 ranks do not divide) over a 3-rank ``("wl",)`` mesh: every
  executor integer equal to the one-device run and to the reference's
  ``sweep_program_plane(backend="numpy")``.
* In this process: a one-rank ``(1, 1)`` mesh equal to the unsharded run
  bit for bit, and ``device="numpy"`` with a mesh refused.

Each world is spawned once and runs all its cases; the pytest worker
holds a process group only inside the one-rank test's block."""
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_sweep_mesh_child as child  # noqa: E402
from _sweep_equiv import assert_records_match  # noqa: E402
from repro.core import opgen as r_opgen  # noqa: E402
from repro.core.policies import POLICIES as R_POLICIES  # noqa: E402
from repro.core.policies import KnobGrid as RKnobGrid  # noqa: E402
from repro_torch.core.policies import (POLICIES, BatchResult,  # noqa: E402
                                       evaluate_batch)

r_sweep = importlib.import_module("repro.core.sweep")
PLANE_EXACT = ("prog_", "n_events", "stall_", "wakes_prog", "setpm_prog")
SWEEP_TAGS = [tag for tag, _, _ in child.SWEEP_MESHES]


def _load(out_dir, tag, rank) -> dict:
    with np.load(os.path.join(out_dir, f"{tag}.rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def _cube(arrays: dict, like: BatchResult) -> BatchResult:
    groups = {}
    for k, a in arrays.items():
        if "/" in k:
            f, c = k.split("/")
            groups.setdefault(f, {})[c] = a
    return BatchResult(workloads=like.workloads, npus=like.npus,
                       policies=like.policies, knob_grid=like.knob_grid,
                       runtime_s=arrays["runtime_s"], **groups)


def _same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


@pytest.fixture(scope="module")
def sweep_world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sweep_mesh"))
    codes = child.run_world("sweep", (out,), world=4)
    assert codes == [0] * 4, codes
    return out


@pytest.fixture(scope="module")
def one_device():
    wls, grid = child.sweep_inputs()
    return evaluate_batch(wls, child.NPUS, POLICIES, grid, device="cpu")


@pytest.fixture(scope="module")
def reference_records():
    grid = r_sweep.knob_product(delay_scale=(0.25, 1.0, 4.0),
                                leak_off_logic=(0.03, 0.2),
                                sa_width=(None, 256, 64))
    return r_sweep.sweep(r_opgen.paper_suite()[:4], child.NPUS, R_POLICIES,
                         grid, backend="numpy")


def _members(tag) -> list:
    shape = dict((t, s) for t, s, _ in child.SWEEP_MESHES)[tag]
    return list(range(int(np.prod(shape))))


@pytest.mark.parametrize("tag", SWEEP_TAGS)
def test_mesh_sweep_matches_the_reference(tag, sweep_world, one_device,
                                          reference_records):
    got = _cube(_load(sweep_world, tag, 0), one_device)
    assert got.shape == one_device.shape
    assert_records_match(reference_records, got.records())


@pytest.mark.parametrize("tag", SWEEP_TAGS)
def test_every_rank_returns_the_whole_cube(tag, sweep_world):
    first = _load(sweep_world, tag, 0)
    for rank in _members(tag)[1:]:
        assert _same_arrays(first, _load(sweep_world, tag, rank)), rank
    for rank in range(len(_members(tag)), 4):
        assert not os.path.exists(
            os.path.join(sweep_world, f"{tag}.rank{rank}.npz"))


def test_knob_mesh_equals_the_one_device_run_bit_for_bit(sweep_world,
                                                         one_device):
    got = _load(sweep_world, "knob4", 0)
    assert _same_arrays(got, child.cube_arrays(one_device))


def test_wl_mesh_rerun_is_bit_identical(sweep_world, one_device):
    a = _load(sweep_world, "wl2xknob2", 0)
    assert _same_arrays(a, _load(sweep_world, "wl2xknob2.again", 0))
    # the partial sums are reduced across ranks: not bincount's bits, but
    # within the contract of the one-device run
    want = child.cube_arrays(one_device)
    for k, v in want.items():
        err = np.abs(a[k] - v) / np.maximum(1e-30, np.abs(v))
        assert float(err.max()) <= 1e-9, k


def test_one_rank_mesh_equals_the_unsharded_run(one_device):
    """A ``(1, 1)`` mesh on a one-rank world of this process: the sharded
    program's collectives over one rank change no bit."""
    import torch.distributed as dist
    from repro_torch.parallel.dist import single_process_world, sweep_mesh
    wls, grid = child.sweep_inputs()
    with single_process_world("cpu"):
        mesh = sweep_mesh(1, 1, device_type="cpu")
        assert mesh.mesh_dim_names == ("wl", "knob")
        got = evaluate_batch(wls, child.NPUS, POLICIES, grid, device="cpu",
                             mesh=mesh)
    assert not dist.is_initialized()
    assert _same_arrays(child.cube_arrays(got),
                        child.cube_arrays(one_device))


def test_sweep_mesh_dims():
    from repro_torch.parallel.dist import fake_world, sweep_mesh
    with fake_world(8):
        assert sweep_mesh(wl=8, device_type="cpu").mesh_dim_names == ("wl",)
        assert sweep_mesh(8, 1, device_type="cpu").mesh_dim_names == ("wl",)
        for wl, knob in ((1, 8), (2, 4), (1, 1)):
            m = sweep_mesh(wl, knob, device_type="cpu")
            assert m.mesh_dim_names == ("wl", "knob")
            assert tuple(m.shape) == (wl, knob)


def test_numpy_device_refuses_a_mesh():
    from repro_torch.core.sweep import sweep
    wls = child.sweep_inputs()[0][:1]
    with pytest.raises(ValueError, match="mesh"):
        evaluate_batch(wls, device="numpy", mesh=object())
    with pytest.raises(ValueError, match="mesh"):
        sweep(wls, device="numpy", mesh=object())


def test_a_session_mesh_is_not_read_by_a_numpy_campaign():
    """A numpy campaign inside a mesh session stays valid (the session's
    mesh is consulted only off ``"numpy"``)."""
    from repro_torch.core import session
    from repro_torch.core.backend import failover_rungs
    from repro_torch.core.fleet import sweep_fleet
    sc, grid = child.fleet_scenario()
    with session.SweepSession(mesh=object()):
        assert failover_rungs("numpy") == (("numpy", None),)
        rep = sweep_fleet(sc, grid, device="numpy")
    assert rep.guard is None and len(rep.records) > 0


@pytest.fixture(scope="module")
def plane_world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("plane_mesh"))
    codes = child.run_world("plane", (out,), world=3)
    assert codes == [0] * 3, codes
    return out


def _plane_records(got, ref):
    assert len(got) == len(ref)
    for x, y in zip(ref, got):
        assert set(x) == set(y)
        for k in x:
            a, b = x[k], y[k]
            if a is None or isinstance(a, str):
                assert a == b, (k, a, b)
            elif k.startswith(PLANE_EXACT):
                assert float(a) == float(b), (k, a, b)
            else:
                assert abs(float(a) - float(b)) \
                    <= 1e-9 * max(1.0, abs(float(a))), (k, a, b)


def test_row_sharded_program_plane_is_exact(plane_world):
    from repro_torch.core.program_plane import program_plane_batch
    wls, grid = child.plane_inputs()
    one = program_plane_batch(wls, child.PLANE_NPUS, grid.product(),
                              device="cpu")
    assert one.cycles.size == 40
    want = {"cycles": one.cycles, "stall_cycles": one.stall_cycles,
            "n_events": one.n_events}
    for f in ("gated_cycles", "wake_events", "setpm_isa"):
        for c, a in getattr(one, f).items():
            want[f"{f}/{c}"] = a
    records = []
    for rank in range(3):
        got = _load(plane_world, "plane", rank)
        assert _same_arrays(got, want), rank
        with open(os.path.join(plane_world, f"plane.rank{rank}.json")) as f:
            meta = json.load(f)
        assert meta["records"] == json.loads(json.dumps(one.records()))
        records.append(meta["records"])
    ref = r_sweep.sweep_program_plane(
        r_opgen.paper_suite()[:5], npus=child.PLANE_NPUS,
        knob_grid=RKnobGrid(delay_scale=(1.0, 4.0),
                            window_scale=(1.0, 0.5)),
        backend="numpy")
    _plane_records(records[0], ref)


def test_sweep_launcher_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.sweep --mesh
    1x2`` on the CPU: a 2-rank gloo world whose cube is the one-process
    launcher's, bit for bit (a knob-only mesh)."""
    import subprocess
    import sys
    from repro_torch.launch import sweep as launcher
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    got = tmp_path / "mesh.npz"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.sweep",
         "--device", "cpu", "--grid", "small", "--mesh", "1x2",
         "--json", str(got)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("{")][0])
    assert (line["world"], line["mesh"], line["backend"]) \
        == (2, [1, 2], "gloo")
    one = launcher.main(["--device", "cpu", "--grid", "small", "--json",
                         str(tmp_path / "one.npz")])
    assert line["cells"] == one["cells"] == 17 * 5 * 5 * 6
    with np.load(got) as a, np.load(tmp_path / "one.npz") as b:
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in b.files)
    with pytest.raises(ValueError, match="WLxKNOB"):
        launcher.parse_sweep_mesh("2")
