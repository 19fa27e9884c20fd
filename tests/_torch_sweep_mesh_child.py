"""Workers of ``tests/test_torch_sweep_mesh.py`` and the mesh tests of
``tests/test_torch_guard.py``: each runs as one rank of a gloo world on
the CPU (``run_world``) and writes what it computed to files of its own
under the run's directory (``<tag>.rank<r>.npz`` / ``.json``). Imports
only ``repro_torch``; the tasks import it once their rank has joined the
world, after ``REPRO_GUARD_KILL`` is set where a task arms it."""
import gc
import json
import os
import socket
import threading
import time

import numpy as np
import torch
import torch.multiprocessing as mp

NPUS = ("NPU-B", "NPU-E")
# (tag, mesh shape, dims) in a 4-rank world; "wl2" leaves ranks 2 and 3
# out of its mesh
SWEEP_MESHES = (("knob4", (4,), ("knob",)),
                ("wl2xknob2", (2, 2), ("wl", "knob")),
                ("wl4xknob1", (4, 1), ("wl", "knob")),
                ("wl2", (2,), ("wl",)))
PLANE_NPUS = ("NPU-B", "NPU-D")
GROUP_TIMEOUT_S = 60.0
FLEET_EPOCHS = 8
STUB_TIMEOUT_S = 5.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sweep_inputs():
    """``tests/test_multidevice_sweep.py``'s sweep: 4 workloads, 9 width /
    delay triples, 18 knobs."""
    from repro_torch.core.opgen import paper_suite
    from repro_torch.core.sweep import knob_product
    grid = knob_product(delay_scale=(0.25, 1.0, 4.0),
                        leak_off_logic=(0.03, 0.2),
                        sa_width=(None, 256, 64))
    return paper_suite()[:4], grid


def plane_inputs():
    """``tests/test_multidevice_sweep.py``'s program plane: 5 workloads ×
    2 NPUs × 4 triples = 40 executor rows."""
    from repro_torch.core.opgen import paper_suite
    from repro_torch.core.policies import KnobGrid
    return paper_suite()[:5], KnobGrid(delay_scale=(1.0, 4.0),
                                       window_scale=(1.0, 0.5))


def fleet_scenario():
    """An 8-epoch fleet (``tests/test_torch_guard.py``'s scenario over a
    longer window) and a 3-knob grid, which a 2-rank knob dim pads."""
    from repro_torch.core.fleet import (ArrivalSpec, FleetScenario,
                                        WorkloadClass)
    from repro_torch.core.opgen import llm_workload
    from repro_torch.core.policies import KnobGrid
    wl = llm_workload("llama3-8b", "decode", batch=8, n_chips=8, tp=8)
    sc = FleetScenario(
        classes=(WorkloadClass(
            "decode", wl,
            ArrivalSpec("diurnal", rate_rps=12.0, period_s=1800.0),
            requests_per_invocation=8),),
        n_chips=16, npu="NPU-D", policies=("NoPG", "ReGate-Full"),
        duration_s=FLEET_EPOCHS * 600.0, epoch_s=600.0, seed=11,
        severity_levels=(0.0, 1.0))
    return sc, KnobGrid(window_scale=(0.5, 1.0, 2.0))


def cube_arrays(res) -> dict:
    """A ``BatchResult``'s cubes as flat ``npz`` entries."""
    out = {"runtime_s": res.runtime_s}
    for f in ("static_j", "dynamic_j", "wake_events", "gated_s",
              "setpm_by"):
        for c, a in getattr(res, f).items():
            out[f"{f}/{c}"] = a
    return out


def report_json(report) -> str:
    return json.dumps(report.to_dict(), sort_keys=True)


def _save(out_dir, tag, rank, arrays=None, obj=None):
    base = os.path.join(out_dir, f"{tag}.rank{rank}")
    if arrays is not None:
        np.savez(base + ".npz", **arrays)
    if obj is not None:
        with open(base + ".json", "w") as f:
            json.dump(obj, f, sort_keys=True)


def task_sweep(rank, out_dir):
    """Every mesh of ``SWEEP_MESHES``, and the 2 × 2 mesh a second time."""
    from repro_torch.core.policies import POLICIES, evaluate_batch
    from repro_torch.parallel.dist import make_mesh
    wls, grid = sweep_inputs()
    for tag, shape, axes in SWEEP_MESHES:
        mesh = make_mesh(shape, axes, "cpu", timeout_s=GROUP_TIMEOUT_S)
        if mesh.get_coordinate() is None:
            continue
        runs = 2 if tag == "wl2xknob2" else 1
        for i in range(runs):
            res = evaluate_batch(wls, NPUS, POLICIES, grid, device="cpu",
                                 mesh=mesh)
            _save(out_dir, tag if i == 0 else f"{tag}.again", rank,
                  cube_arrays(res))


def task_plane(rank, out_dir):
    """The program plane's rows over a 3-rank ``("wl",)`` mesh."""
    from repro_torch.core.program_plane import program_plane_batch
    from repro_torch.kernels.program_exec import program_exec
    from repro_torch.parallel.dist import sweep_mesh
    wls, grid = plane_inputs()
    mesh = sweep_mesh(wl=3, device_type="cpu", timeout_s=GROUP_TIMEOUT_S)
    b = program_plane_batch(wls, PLANE_NPUS, grid.product(), device="cpu",
                            mesh=mesh)
    arrays = {"cycles": b.cycles, "stall_cycles": b.stall_cycles,
              "n_events": b.n_events}
    for f in ("gated_cycles", "wake_events", "setpm_isa"):
        for c, a in getattr(b, f).items():
            arrays[f"{f}/{c}"] = a
    _save(out_dir, "plane", rank, arrays,
          {"records": b.records(), "launches": program_exec.launches})


def task_guard(rank, out_dir):
    """The guard on a (1, 2) knob mesh: a stub runner that fails on rank 1
    alone at attempt 0, after its collectives; the 8-epoch fleet plain
    and guarded; the chaos campaign with a checkpoint; then a stub that
    fails on rank 1 before its collectives, which strands rank 0's."""
    from repro_torch.core.backend import failover_rungs
    from repro_torch.core.fleet import sweep_fleet
    from repro_torch.core.guard import GuardedRunner, GuardPolicy
    from repro_torch.core.policies import POLICIES, evaluate_batch
    from repro_torch.parallel.dist import sweep_mesh
    import _torch_guard_resume_child as resume
    mesh = sweep_mesh(1, 2, device_type="cpu", timeout_s=GROUP_TIMEOUT_S)
    wls, grid = sweep_inputs()
    calls = []

    def after(rung, workloads, npus, policies, knobs, mesh=None):
        calls.append(rung)
        res = evaluate_batch(workloads, npus, policies, knobs, device="cpu",
                             mesh=mesh)
        if rank == 1 and len(calls) == 1:
            raise RuntimeError("injected fault on rank 1")
        return res

    runner = GuardedRunner(
        GuardPolicy(max_retries=2, backoff_base_s=0.001), seed=5,
        rungs=failover_rungs("cpu", mesh), runner=after)
    res = runner.evaluate_batch(wls[:2], NPUS, POLICIES, grid, step=3)
    _save(out_dir, "stub_after", rank, cube_arrays(res),
          {"events": runner.report.events, "calls": calls})

    sc, fgrid = fleet_scenario()
    plain = sweep_fleet(sc, fgrid, device="cpu", mesh=mesh)
    guarded = sweep_fleet(sc, fgrid, device="cpu", mesh=mesh,
                          guard=GuardPolicy(timeout_s=300.0))
    _save(out_dir, "fleet", rank,
          obj={"plain": report_json(plain), "guarded": report_json(guarded)})

    out = resume.campaign(os.path.join(out_dir, "chaos_ck"), "cpu", mesh)
    _save(out_dir, "chaos", rank, obj=out)

    stranded = sweep_mesh(1, 2, device_type="cpu",
                          timeout_s=2 * STUB_TIMEOUT_S)
    calls.clear()

    def before(rung, workloads, npus, policies, knobs, mesh=None):
        calls.append(rung)
        if rank == 1 and len(calls) == 1:
            raise RuntimeError("injected fault on rank 1")
        return evaluate_batch(workloads, npus, policies, knobs,
                              device="cpu", mesh=mesh)

    runner = GuardedRunner(
        GuardPolicy(timeout_s=STUB_TIMEOUT_S, max_retries=2,
                    backoff_base_s=0.001), seed=5,
        rungs=failover_rungs("cpu", stranded), runner=before)
    res = runner.evaluate_batch(wls[:2], NPUS, POLICIES, grid, step=4)
    _save(out_dir, "stub_before", rank, cube_arrays(res),
          {"events": runner.report.events, "calls": calls})
    # rank 0's abandoned attempt still waits in the stranded collective,
    # which its group's timeout ends: leave the world only after that
    del runner
    gc.collect()
    t0 = time.monotonic()
    for t in threading.enumerate():
        if t is not threading.main_thread():
            t.join(4 * STUB_TIMEOUT_S)
    print(f"rank {rank}: workers joined after "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def task_chaos(rank, out_dir, ckdir):
    """The checkpointed chaos campaign on a (1, 2) knob mesh, from (or
    resuming) ``ckdir``."""
    from repro_torch.parallel.dist import sweep_mesh
    import _torch_guard_resume_child as resume
    mesh = sweep_mesh(1, 2, device_type="cpu", timeout_s=GROUP_TIMEOUT_S)
    _save(out_dir, "chaos_resumed", rank,
          obj=resume.campaign(ckdir, "cpu", mesh))


def _worker(rank, world, port, task, args, kill):
    if kill:
        os.environ["REPRO_GUARD_KILL"] = kill
    else:
        os.environ.pop("REPRO_GUARD_KILL", None)
    torch.set_num_threads(1)
    from repro_torch.parallel.dist import spmd_world
    with spmd_world(rank, world, f"tcp://localhost:{port}", "cpu",
                    timeout_s=GROUP_TIMEOUT_S):
        globals()[f"task_{task}"](rank, *args)


def run_world(task: str, args: tuple, world: int, kill: str = "",
              timeout_s: float = 240.0) -> list:
    """Run ``task_<task>(rank, *args)`` on ``world`` gloo ranks, each with
    ``REPRO_GUARD_KILL`` set to ``kill``; returns the ranks' exit codes
    (a rank still running after ``timeout_s`` is killed: ``None``)."""
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, task, args, kill))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    return codes
