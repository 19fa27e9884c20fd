#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the batched power-plane sweep,
``repro_torch.core.sweep.sweep_grid`` → ``policies.evaluate_batch`` →
``_sweep_kernel`` — on the card at the size the repo calls real
(``paper_suite()`` × 5 NPU generations × 5 policies × a 3 600-point knob
grid = 1.53 M cells), builds the hand-written CUDA kernels from the
sources in the checkout, holds each kernel against its plain PyTorch
version, and shows by the wrappers' launch counts that the sweep really
went through them. It has no CPU route: no card, a failed build, a
failed launch or a failed comparison each end the run with a non-zero
exit code. Every phase prints one JSON line; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float64 rate outside the tensor cores (half the 67 TFLOP/s
# float32 rate). Bounds are stated against these whatever the card's
# power limit is; the limit is printed beside them.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 33.5e12

K1_SOURCE = "src/repro_torch/kernels/csrc/power_plane.cu"
# §6.5 sensitivity grid (240 knobs) × SA width × detection window = 3 600
FULL_GRID = dict(
    delay_scale=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
    leak_off_logic=(0.01, 0.03, 0.1, 0.2, 0.4),
    leak_sram_sleep=(0.1, 0.25, 0.4, 0.6),
    leak_sram_off=(0.002, 0.02),
    sa_width=(None, 32, 64, 128, 256),
    window_scale=(0.5, 1.0, 2.0),
)
RECORD_GRID = (dict(), dict(delay_scale=2.0), dict(delay_scale=4.0),
               dict(leak_off_logic=0.2, leak_sram_sleep=0.4,
                    leak_sram_off=0.02))


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` on the card: CUDA events
    around ``reps`` back-to-back calls, after a warm-up. For a kernel
    shorter than the host's launch time this is the launch rate through
    the wrapper, which is what the sweep pays."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_sweep(run_full) -> dict:
    """Where one steady sweep spends its time, by ``torch.profiler``:
    wall seconds, the card's busy share, the device time of the two
    hand kernels and the largest other kernels. A diagnostic: a
    profiler that cannot trace the card is reported, not fatal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = run_full()
        rows = []
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            if us > 0:
                rows.append((evt.key, float(us), int(evt.count)))
    except Exception as e:  # diagnostic phase: record and go on
        return {"error": f"{type(e).__name__}: {e}"}
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) * 1e-6
    hand = {name: {"device_us_total": us, "launches": cnt,
                   "device_us_per_launch": us / cnt}
            for name, us, cnt in rows
            if "sa_occupancy_kernel" in name or "segment_sum_kernel" in name}
    return {"wall_s_profiled": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall if wall else None,
            "device_kernels": len(rows), "hand_kernels": hand,
            "top": [{"name": n[:80], "device_us": us, "count": c}
                    for n, us, c in rows[:8]]}


def max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max())


def main() -> int:
    try:
        import numpy as np
        import torch
        from repro_torch.core.backend import get_backend
        from repro_torch.core.hw import NPUS, get_npu
        from repro_torch.core.opgen import paper_suite, stack_traces
        from repro_torch.core.policies import (POLICIES, KnobGrid,
                                               PolicyKnobs, _host_columns,
                                               _knob_arrays)
        from repro_torch.core.sweep import sweep, sweep_grid
        from repro_torch.kernels import _build
        from repro_torch.kernels.sa_occupancy import (sa_occupancy,
                                                      sa_occupancy_plain)
        from repro_torch.kernels.segment_sum import (segment_starts,
                                                     segment_sum,
                                                     segment_sum_plain)
    except ImportError as e:
        fail(f"cannot import the port (run from the root of a checkout): "
             f"{e}", 2)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script has no CPU "
             "route", 2)
    dev = torch.device("cuda")
    f8 = torch.float64

    # ---- 1. device ------------------------------------------------------
    card = smi_line()
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.BUILD_INFO.get("seconds"),
         library=str(_build.build_dir() / _build.LIB_NAME),
         ptxas=[ln for ln in _build.BUILD_INFO.get("log", "").splitlines()
                if "registers" in ln or "Compiling entry" in ln])

    # ---- 3. kernels vs their plain versions -----------------------------
    suite = paper_suite()
    st = stack_traces(suite)
    bk = get_backend(dev)
    npu_d = get_npu("NPU-D")
    host, _ = _host_columns(st, npu_d)
    full_knobs = KnobGrid(**FULL_GRID).product()
    karr = _knob_arrays(full_knobs, npu_d, bk)
    saw_main = karr["saw_unique"]                  # what the sweep passes
    n_pairs = int(karr["pair_saw_idx"].shape[0])
    mm = [bk.asarray(host["op"][k]) for k in ("mm_m", "mm_k", "mm_n")]
    n_ops = int(mm[0].shape[0])

    # K1: bit for bit against the plain version, on the card
    k1_err = 0.0
    k1_cases = 0
    rng = np.random.default_rng(0)

    def k1_check(m, k, n, saw, wlc):
        nonlocal k1_err, k1_cases
        got = sa_occupancy(m, k, n, saw, wlc)
        want = sa_occupancy_plain(m, k, n, saw, wlc)
        torch.cuda.synchronize()
        for key in want:
            check(got[key].shape == want[key].shape
                  and got[key].dtype == f8,
                  f"sa_occupancy[{key}]: shape/dtype {got[key].shape} "
                  f"{got[key].dtype} vs {want[key].shape}")
            k1_err = max(k1_err, max_abs(got[key], want[key]))
            check(torch.equal(got[key], want[key]),
                  f"sa_occupancy[{key}] differs from its plain version "
                  f"(n={m.shape[0]}, saw={saw}, wlc={wlc})")
        k1_cases += 1

    five_widths = torch.tensor([32.0, 64.0, 128.0, 256.0, 512.0],
                               dtype=f8, device=dev)
    for saw in (saw_main, five_widths, 128.0):
        for wlc in (None, 0.0):
            k1_check(*mm, saw, wlc)
    for n in (1, 255, 257):
        dims = [torch.tensor(rng.integers(1, hi, n).astype(np.float64),
                             device=dev) for hi in (5000, 600, 5000)]
        for saw in (five_widths, 8.0):
            for wlc in (None, 0.0):
                k1_check(*dims, saw, wlc)
    empty = torch.zeros(0, dtype=f8, device=dev)
    before = sa_occupancy.launches
    e = sa_occupancy(empty, empty, empty, five_widths)
    check(all(v.shape == (5, 0) for v in e.values())
          and sa_occupancy.launches == before,
          "sa_occupancy on an empty op stream must not launch")

    # K2: same bits as the CPU plain version, same bits run to run, and
    # within rounding of the (atomic) plain version on the card
    seg_ids = bk.asarray(host["op"]["seg_ids"])
    chunk_hbm = bk.asarray(host["op"]["chunk_hbm"])
    gap_hbm = bk.asarray(host["gap_seg"]["hbm"])
    w = st.n_segments
    n_gaps = int(gap_hbm.shape[0])
    holes = np.sort(rng.choice(np.arange(3, 37), 700, replace=True))
    k2_id_sets = {
        "seg_ids": (seg_ids, w),
        "chunk_hbm": (chunk_hbm, n_gaps),
        "gap_seg_hbm": (gap_hbm, w),
        # empty segments at the head (0-2), in the middle and at the
        # tail (37-39)
        "holes": (torch.tensor(holes[holes % 5 != 0], device=dev), 40),
    }
    k2_err_card = 0.0
    k2_err_cpu = 0.0
    k2_cases = 0
    for name, (ids, num) in k2_id_sets.items():
        for batch in (1, 6, n_pairs):
            shape = (ids.shape[0],) if batch == 1 \
                else (batch, ids.shape[0])
            data = torch.tensor(rng.uniform(1e-9, 1e3, shape), device=dev)
            got = segment_sum(data, ids, num)
            again = segment_sum(data, ids, num,
                                segment_starts(ids, num))
            on_card = segment_sum_plain(data, ids, num)
            on_cpu = segment_sum_plain(data.cpu(), ids.cpu(), num).to(dev)
            torch.cuda.synchronize()
            check(got.shape == on_cpu.shape and got.dtype == f8,
                  f"segment_sum[{name}, B={batch}]: shape/dtype")
            k2_err_cpu = max(k2_err_cpu, max_abs(got, on_cpu))
            k2_err_card = max(k2_err_card, max_abs(got, on_card))
            check(torch.equal(got, on_cpu),
                  f"segment_sum[{name}, B={batch}] differs from the plain "
                  f"version evaluated on the CPU")
            check(torch.equal(got, again),
                  f"segment_sum[{name}, B={batch}]: two runs differ")
            check(torch.allclose(got, on_card, rtol=1e-12, atol=0.0),
                  f"segment_sum[{name}, B={batch}] differs from the plain "
                  f"version on the card beyond rtol=1e-12")
            k2_cases += 1
    before = segment_sum.launches
    z = segment_sum(torch.zeros((3, 0), dtype=f8, device=dev),
                    torch.zeros(0, dtype=torch.int64, device=dev), 4)
    check(z.shape == (3, 4) and float(z.abs().sum()) == 0.0
          and segment_sum.launches == before,
          "segment_sum on empty data must return zeros without a launch")

    # timings at the shapes the sweep gives the kernels
    k1_shape = {"n": n_ops, "S": int(saw_main.shape[0])}
    k1_ms = event_ms(lambda: sa_occupancy(*mm, saw_main), 200)
    k1_plain_ms = event_ms(lambda: sa_occupancy_plain(*mm, saw_main), 50)
    k1_elems = k1_shape["n"] * k1_shape["S"]
    k1_bytes = 8 * (3 * k1_shape["n"] + k1_shape["S"] + 5 * k1_elems)
    k1_ops = 45 * k1_elems  # adds, multiplies, divisions, floor, min/max
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S,
                   k1_ops / FP64_FLOPS_PER_S) * 1e3

    k2_shapes = []
    for name, (ids, num), batch in (
            ("ops->workloads, per triple", k2_id_sets["seg_ids"], n_pairs),
            ("gaps->workloads, per triple", k2_id_sets["gap_seg_hbm"],
             n_pairs),
            ("ops->gap chunks, per width", k2_id_sets["chunk_hbm"],
             k1_shape["S"]),
            ("ops->workloads, per width", k2_id_sets["seg_ids"],
             k1_shape["S"])):
        n = int(ids.shape[0])
        data = torch.tensor(rng.uniform(1e-9, 1e3, (batch, n)), device=dev)
        stt = segment_starts(ids, num)
        lib_out = torch.zeros(batch, num, dtype=f8, device=dev)
        nbytes = 8 * (batch * (n + num) + num + 1)
        nops = batch * n
        k2_shapes.append({
            "what": name, "B": batch, "n": n, "num_segments": num,
            "ms": event_ms(lambda: segment_sum(data, ids, num, stt), 100),
            "plain_ms": event_ms(
                lambda: segment_sum_plain(data, ids, num), 30),
            "library_ms": event_ms(
                lambda: lib_out.zero_().index_add_(-1, ids, data), 30),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            nops / FP64_FLOPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= nops / FP64_FLOPS_PER_S else "operations"})
    emit("kernels", card=card, k1_cases=k1_cases, k2_cases=k2_cases,
         k1={"shape": k1_shape, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
             "bound_ms": k1_bound, "max_abs_err": k1_err},
         k2={"shapes": k2_shapes, "max_abs_err_vs_cpu_plain": k2_err_cpu,
             "max_abs_err_vs_card_plain": k2_err_card})

    # ---- 4. sweep_full: the main path at full size ----------------------
    npus = tuple(NPUS)
    shape = (len(suite), len(npus), len(POLICIES), len(full_knobs))
    n_cells = shape[0] * shape[1] * shape[2] * shape[3]

    def run_full():
        t = time.perf_counter()
        res = sweep_grid(suite, npus=npus, policies=POLICIES,
                         as_records=False, **FULL_GRID)
        bk.block()
        return res, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    sa_occupancy.launches = 0
    segment_sum.launches = 0
    res1, t_first = run_full()
    launches = {"sa_occupancy": sa_occupancy.launches,
                "segment_sum": segment_sum.launches}
    res2, t_second = run_full()
    res3, t_third = run_full()
    t_steady = min(t_second, t_third)
    check(res1.shape == shape, f"cube shape {res1.shape} != {shape}")
    check(launches["sa_occupancy"] > 0 and launches["segment_sum"] > 0,
          f"the sweep did not launch both kernels: {launches}")
    total = {}
    for res in (res1, res2):
        tot = np.zeros(shape)
        for field in ("static_j", "dynamic_j", "wake_events", "gated_s",
                      "setpm_by"):
            for c, arr in getattr(res, field).items():
                check(arr.shape == shape and bool(np.isfinite(arr).all()),
                      f"{field}[{c}]: wrong shape or non-finite values")
                check(np.array_equal(arr, getattr(res1, field)[c]),
                      f"{field}[{c}]: a second run is not bit-identical")
                if field in ("static_j", "dynamic_j"):
                    tot += arr
        check(bool(np.isfinite(res.runtime_s).all())
              and np.array_equal(res.runtime_s, res1.runtime_s),
              "runtime_s: non-finite or not bit-identical across runs")
        total[id(res)] = tot
    tot = total[id(res1)]
    i_nopg, i_ideal = POLICIES.index("NoPG"), POLICIES.index("Ideal")
    check(bool((tot[:, :, i_ideal, :] <= tot[:, :, i_nopg, :]).all()),
          "Ideal spends more energy than NoPG in some cell")
    check(bool((res1.runtime_s > 0).all()), "non-positive runtime")
    emit("sweep_full", card=card, cube=list(shape), cells=n_cells,
         knobs=len(full_knobs), unique_triples_per_npu=n_pairs,
         wall_s_first=t_first, wall_s_steady=t_steady,
         cells_per_s_steady=n_cells / t_steady, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         bit_identical_rerun=True)

    emit("profile", **profile_sweep(run_full))

    # ---- 5. sweep_records: card vs the plain versions on the CPU ---------
    grid = [PolicyKnobs(**kw) for kw in RECORD_GRID]
    t0 = time.perf_counter()
    on_card = sweep(suite, npus, POLICIES, grid)
    t_card = time.perf_counter() - t0
    on_cpu = sweep(suite, npus, POLICIES, grid, device="cpu")
    check(len(on_card) == len(on_cpu) == len(suite) * 5 * 5 * 4,
          "record count")
    worst = 0.0
    n_exact = 0
    differing = set()
    for a, b in zip(on_cpu, on_card):
        check(set(a) == set(b), "record fields differ")
        same = True
        for k, va in a.items():
            vb = b[k]
            if isinstance(va, (str, type(None))) or k == "knob_idx":
                check(va == vb, f"record order/metadata differs: {k} "
                                f"{va!r} {vb!r}")
                continue
            rel = abs(va - vb) / max(1e-30, abs(va), abs(vb))
            worst = max(worst, rel)
            if va != vb:
                same = False
                differing.add(k)
        n_exact += same
    check(worst <= 1e-9, f"card vs CPU records differ by {worst} > 1e-9")
    emit("sweep_records", records=len(on_card), max_rel_err=worst,
         records_bit_identical=n_exact,
         fields_not_bit_identical=sorted(differing), wall_s_card=t_card)

    # ---- the kernels line, the card, the verdict ------------------------
    main_k2 = k2_shapes[0]
    kernels = [
        {"name": "sa_occupancy", "route": "cuda", "source": K1_SOURCE,
         "replaces": "src/repro/kernels/sa_occupancy.py:83",
         "launches": launches["sa_occupancy"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S
         >= k1_ops / FP64_FLOPS_PER_S else "operations",
         "library_ms": None, "shape": k1_shape,
         "tolerance": "torch.equal with the plain version on the card"},
        {"name": "segment_sum", "route": "cuda", "source": K1_SOURCE,
         "replaces": "src/repro/core/backend.py:203",
         "launches": launches["segment_sum"],
         "max_abs_err": k2_err_card, "ms": main_k2["ms"],
         "plain_ms": main_k2["plain_ms"], "bound_ms": main_k2["bound_ms"],
         "bound_by": main_k2["bound_by"],
         "library_ms": main_k2["library_ms"],
         "shape": {k: main_k2[k] for k in ("what", "B", "n",
                                           "num_segments")},
         "max_abs_err_vs_cpu_plain": k2_err_cpu,
         "tolerance": "torch.equal with the plain version on the CPU; "
                      "rtol 1e-12 with the (atomic) plain version on the "
                      "card"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
