#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in the checkout
(one ``nvcc`` per source, all started together), holds each kernel
against its plain PyTorch version, and drives the port's paths on the
card, showing by the wrappers' launch counts (set to 0 just before each
path, read just after) that each path really went through its kernels:

* the batched power-plane sweep, ``repro_torch.core.sweep.sweep_grid`` →
  ``policies.evaluate_batch`` → ``_sweep_kernel`` (kernels K1
  ``sa_occupancy``, K2 ``segment_sum``), at the size the repo calls real:
  ``paper_suite()`` × 5 NPU generations × 5 policies × a 3 600-point
  knob grid = 1.53 M cells;
* ``repro_torch.core.evaluate_all`` (all five policies of one workload
  through ``evaluate_batch``, K1 and K2) for each of the 17 paper-suite
  workloads on NPU-D, held to the host engine ``evaluate`` within 1e-9;
* the gated matmul ``repro_torch.kernels.ops.gated_matmul`` (kernel B2,
  which skips all-zero weight tiles) at the gate/up projection of
  qwen2.5-3b at serve_full's prefill, x (8192, 2048) and w (2048,
  11 008), bf16 dense and with the paper's N-, K- and both-underutilized
  zero patterns, and float32 dense; the count of executed tiles is held
  exactly to what the zero pattern leaves;
* the program plane, ``repro_torch.core.sweep.sweep_program_plane`` →
  ``program_plane.program_plane_batch`` (the lowered, setpm-instrumented
  programs through kernel B7 ``program_exec``, one launch a call, and the
  ReGate-Full policy side through ``evaluate_batch``, K1 and K2): the
  paper suite × NPU-B, NPU-D × 8 knobs on the card against the CPU
  (272 records, bit for bit), and at full width the paper suite × all
  five NPUs × 6 delay × 3 window scales (1 530 executor rows on 510
  event streams, up to 3 280 events each; the card path hands B7 the
  ragged streams, each read once for the 3 rows that share it), with B7
  held to its plain version through both its entries;
* serving qwen2.5-3b at full width (36 layers, d_model 2048, vocab
  151 936; random weights from a seed), ``repro_torch.launch.serve.
  Server`` → ``prefill_prompts`` / ``step`` (kernels B3
  ``flash_attention`` at prefill, B4 ``decode_attention`` at every decode
  step): batch 4, a 2048-token prompt, 32 generated tokens, checked
  against a full forward and, cut to 2 layers in float32, against the
  CPU;
* serving mamba2-780m at full width (48 SSD layers, d_model 1536, 48
  heads of 64, d_state 128, vocab 50 280), the same ``Server`` entry
  points (kernel B5 ``ssd_scan`` on every layer of the prefill; a decode
  step is the plain recurrent update and launches no kernel), the same
  batch, prompt and checks.

It has no CPU route: no card, a failed build, a failed launch or a
failed comparison each end the run with a non-zero exit code. Every
phase prints one JSON line; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}
"""
from __future__ import annotations

import itertools
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
# and the dense bf16 tensor-core rate, and float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

# B3's kernel per input type, as the profiler names it
B3_KERNELS = {"bfloat16": "flash_attention_bf16_kernel",
              "float32": "flash_attention_kernel"}
# B4's two kernels, both launched by every wrapper call: the split pass
# and the combine of the splits
B4_KERNELS = ("decode_attention_kernel", "decode_attention_combine_kernel")
# B3 bf16 vs its plain version at the prefill's shape, as one relative L2
# over the whole output. The kernel rounds the probabilities to bf16
# before P·V (the plain version keeps them in float32); the outputs there
# have a median size of ~0.03, so the flat 2e-2 allclose alone would not
# see a fault of that size. On the H100 the kernel reads 2.1e-3, as does
# the plain version with p rounded to bf16 (7 mantissa bits); the control,
# p rounded to 3 bits (a deliberately wrong rounding), reads 2.0e-2 and
# must land above the limit (PERF.md).
B3_REL_L2_BF16 = 6e-3
B3_CONTROL_BITS = 3
# B4 bf16 vs its plain version, likewise as one relative L2 over the
# whole output. Both sum in float32 and round the same value to bf16 once,
# so they differ only where the two float32 sums straddle a rounding
# boundary; at ~2 080 random slots the outputs have a median size of
# ~0.03 and the flat 2e-2 allclose is as large as a typical value. The
# limit is one bf16 rounding of every output, 2^-9 / sqrt(3). The
# control, the plain version with its last split dropped (what a combine
# that lost a split would give), must land above it.
B4_REL_L2_BF16 = 1.1e-3
# B5's kernels per input type, as the profiler names them: a bf16 call
# launches two, C·Bᵀ once per (batch, chunk, group), then the scan
B5_KERNELS = {"bfloat16": ("ssd_chunk_cb_kernel", "ssd_scan_bf16_kernel"),
              "float32": ("ssd_scan_kernel",)}
# B5 bf16 vs its plain version at the model's inputs, as one relative L2
# over y and one over the final state. Every float32 operand of the
# kernel's products (the carried state, S, x·dt·w) enters the tensor
# cores as a bf16 hi/lo pair, ~2^-16 relative: on the H100 the kernel
# reads 2.7e-6 (y) and 3.8e-6 (state). The plain version with its state
# rounded to bf16 (7 mantissa bits) after every chunk reads 4.3e-5 and
# 1.7e-3, so the limit sees a state kept in bf16; the control, the state
# rounded to 3 bits (a deliberately wrong rounding), reads 7.2e-4 and
# 2.6e-2 and must land above it (PERF.md).
B5_REL_L2_BF16 = 1e-4
B5_CONTROL_BITS = 3
K1_SOURCE = "src/repro_torch/kernels/csrc/power_plane.cu"
ATTN_SOURCE = "src/repro_torch/kernels/csrc/attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
GM_SOURCE = "src/repro_torch/kernels/csrc/gated_matmul.cu"
PP_SOURCE = "src/repro_torch/kernels/csrc/program_plane.cu"
# the program plane's card-vs-CPU grid, benchmarks/perf_program_plane.py's:
# 4 BET/window points x 2 leak points on NPU-B and NPU-D (272 records)
PP_RECORD_NPUS = ("NPU-B", "NPU-D")
PP_RECORD_GRID = dict(delay_scale=(1.0, 4.0), window_scale=(1.0, 0.5),
                      leak_off_logic=(None, 0.1))
# the program plane at full width: every NPU x the §6.5 delay axis x the
# detection-window axis at the native SA width (18 unique triples, 1 530
# executor rows for the 17 workloads)
PP_FULL_GRID = dict(delay_scale=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
                    window_scale=(0.5, 1.0, 2.0))
# one event of a stream: its cycle (8 bytes), four issue latencies (32)
# and four setpm codes (4); per stream its offset (8); per row: delay,
# window, mode0 (3 x 4 x 8), horizon and its stream (16) in, cycles,
# stalls, setpm (24) and on, gated, wakes (3 x 4 x 8) out. B7 reads each
# stream once; the bound the dense stack set counted every row's copy
B7_EVENT_BYTES = 44
B7_STREAM_BYTES = 8
B7_ROW_BYTES = 3 * 4 * 8 + 16 + 24 + 3 * 4 * 8
SERVE_ARCH = "qwen2.5-3b"
SSM_ARCH = "mamba2-780m"
# per served arch: the published widths (layers, d_model, vocab), the
# kernel each layer launches at prefill and at every decode step, and the
# limit on the bf16 decode-vs-forward relative L2 (below)
SERVE_PATHS = {
    SERVE_ARCH: {"widths": (36, 2048, 151936), "prefill": "flash_attention",
                 "step": "decode_attention", "rel_l2_bf16": 0.05},
    SSM_ARCH: {"widths": (48, 1536, 50280), "prefill": "ssd_scan",
               "step": None, "rel_l2_bf16": 0.25},
}
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 2048, 32
# decode steps vs one full forward. A wrong head or group map, cache slot,
# conv tail or rope position, or a state not carried, gives a relative L2
# error of order 1. In float32 (the same weights before their bf16 cast)
# the two paths differ only in the order of float32 sums: the hard limit.
# In bf16 they also round in other places (the decode step's 4-row matmuls
# against the forward's 8 316-row ones, B4 vs B3): qwen2.5-3b stays near
# 0.02; in mamba2-780m the carried SSM state accumulates that rounding
# noise, 0.03 after one step growing to 0.13 after 31 on the H100 while
# the float32 gap stays below 5e-5 (PERF.md), so its bf16 limit is 0.25.
SERVE_REL_L2_TOL_F32 = 1e-3
# card vs CPU in float32, 2 layers: the same arithmetic in another order,
# on logits of size below 1
PARITY_ATOL = 1e-4
# B5 vs its plain version, both on the card, scaled by the largest value
# (tests/test_kernels.py's scaled atol in float32): float32 sums in another
# order; bf16 inputs are the same bf16 values on both sides, but their
# larger products leave more rounding in the float32 sums
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-3}
# B2 vs its plain version, both on the card: the tolerances of
# tests/test_kernels.py, atol = tol * max|plain| + 1e-5, rtol = tol.
# float32: true float32 FMAs summed in another order; bf16: the same
# products in float32, the output rounded to bf16 on each side
GM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# GM_CASES of tests/test_kernels.py: (M, K, N, zero_cols, zero_rows)
GM_CASES = ((128, 128, 128, 0, 0), (256, 256, 512, 256, 0),
            (384, 512, 256, 0, 256), (128, 256, 384, 128, 128),
            (512, 128, 128, 0, 0))
# gated_matmul_full: qwen2.5-3b's gate/up projection at serve_full's
# prefill, x (batch * prompt, d_model) and w (d_model, d_ff), 128-tiles;
# (name, zero_cols, zero_rows, dtype): paper Fig 10 cases 2 and 3
GM_FULL = (SERVE_BATCH * SERVE_PROMPT, 2048, 11008)
GM_FULL_CASES = (("dense", 0, 0, "bfloat16"),
                 ("n_underutilized", 5504, 0, "bfloat16"),
                 ("k_underutilized", 0, 1024, "bfloat16"),
                 ("both", 5504, 1024, "bfloat16"),
                 ("dense_float32", 0, 0, "float32"))
# K2's long-row case, its segment lengths: the first is longer than the
# kernel's largest staging window (12 sub-tiles of 1 024 elements)
K2_LONG_ROW = (30000, 5, 20000)
# evaluate_all on the card vs the host engine, every EnergyReport field
EVAL_ALL_RTOL = 1e-9
# SSD_CASES of tests/test_kernels.py: (BH, S, P, N)
SSD_CASES = ((2, 256, 64, 32), (4, 256, 32, 16), (1, 512, 64, 64))
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


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = getattr(evt, "self_cuda_time_total", 0.0)
    return float(us)


def profile_run(run, hand_kernels: tuple[str, ...], top: int = 8) -> dict:
    """Where one run spends its time, by ``torch.profiler``: wall
    seconds (``run()`` returns them), the card's busy share, the device
    time and launches of the hand kernels, the largest kernels, and the
    PyTorch ops that launched the most device time. Busy time and
    launches count device-side events only (kernels, copies, sets): an
    op's ``self_device_time`` repeats its kernels' time. A diagnostic: a
    profiler that cannot trace the card is reported, not fatal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            wall = run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = [(evt.key, _device_us(evt), int(evt.count),
                   getattr(evt, "device_type", None) == DeviceType.CUDA)
                  for evt in prof.key_averages() if _device_us(evt) > 0]
    except Exception as e:  # diagnostic phase: record and go on
        return {"error": f"{type(e).__name__}: {e}"}
    rows = sorted((r[:3] for r in events if r[3]), key=lambda r: -r[1])
    ops = sorted((r[:3] for r in events if not r[3]), key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) * 1e-6
    hand = {name: {"device_us_total": us, "launches": cnt,
                   "device_us_per_launch": us / cnt}
            for name, us, cnt in rows
            if any(h in name for h in hand_kernels)}
    return {"wall_s_profiled": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall if wall else None,
            "device_kernels": len(rows),
            "device_launches": sum(r[2] for r in rows),
            "hand_kernels": hand,
            "top": [{"name": n[:80], "device_us": us, "count": c}
                    for n, us, c in rows[:top]],
            "top_ops": [{"name": n[:60], "device_us": us, "count": c}
                        for n, us, c in ops[:top]]}


# the profiler keeps only the device records whose time stamps fall in
# its window, and on the H100 CUPTI's stamps have come out up to 3.6 ms
# before the host's clock (chip_profiler_window.py), so a burst of short
# kernels at the window's start was lost in part or in full: every
# profile waits this long before the first call and after the last one
# has finished
PROFILE_PAD_S = 0.05
# a profile that still returns no record of a kernel the calls launched
# is taken again, this many times in all, before the run fails
PROFILE_ATTEMPTS = 3


def kernel_device_us(fn, names=None, reps: int = 5) -> float:
    """Mean device microseconds of one call of ``fn`` in the kernels
    ``names`` (a name, or a tuple of the names of every kernel the call
    launches, each once a call; None: every kernel, copy and set the call
    puts on the card, for a library call whose kernels are not ours to
    name), over ``reps`` calls, by ``torch.profiler``: a short kernel is
    timed by its device time, not by events around wrapper calls, which
    measure the host's issue rate. A call that launches two kernels reads
    the time of both. A named kernel's time is its mean over the launches
    the profiler recorded, in a window padded by ``PROFILE_PAD_S`` on both
    sides: on the H100 a window that held only the calls has lost the
    records of some or all of them (PERF.md)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        if names is None:
            us = [_device_us(e) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
            if sum(us) > 0:
                return sum(us) / reps
            missing = ["any device"]
            continue
        wanted = (names,) if isinstance(names, str) else tuple(names)
        hits = {name: [(_device_us(e), int(e.count))
                       for e in prof.key_averages() if name in e.key]
                for name in wanted}
        missing = [name for name, rec in hits.items() if not rec]
        if not missing:
            return sum(sum(us for us, _ in rec) / sum(n for _, n in rec)
                       for rec in hits.values())
    fail(f"the profiler saw no {missing} launch in {PROFILE_ATTEMPTS} "
         f"profiles of {reps} calls")


def max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max())


# ---- the sweep's kernel K2 ---------------------------------------------------

def k2_timing_shapes(bk, host, n_segments: int, n_pairs: int,
                     n_widths: int) -> list:
    """The four shapes the sweep gives K2, as ``(what, ids,
    num_segments, rows)``: the op and gap streams of the paper suite on
    one NPU into workload segments, per knob pair or per SA width, and
    the ops into idle-gap chunks per width."""
    seg_ids = bk.asarray(host["op"]["seg_ids"])
    gap_hbm = bk.asarray(host["gap_seg"]["hbm"])
    chunk_hbm = bk.asarray(host["op"]["chunk_hbm"])
    return [("ops->workloads, per triple", seg_ids, n_segments, n_pairs),
            ("gaps->workloads, per triple", gap_hbm, n_segments, n_pairs),
            ("ops->gap chunks, per width", chunk_hbm, int(gap_hbm.shape[0]),
             n_widths),
            ("ops->workloads, per width", seg_ids, n_segments, n_widths)]


def k2_port_shapes(dev) -> list:
    """``k2_timing_shapes`` built from scratch by the port on the import
    path (NPU-D, the paper suite, ``FULL_GRID``), for a script that times
    K2 without running the sweep."""
    from repro_torch.core.backend import get_backend
    from repro_torch.core.hw import get_npu
    from repro_torch.core.opgen import paper_suite, stack_traces
    from repro_torch.core.policies import (KnobGrid, _host_columns,
                                           _knob_arrays)
    st = stack_traces(paper_suite())
    bk = get_backend(dev)
    npu = get_npu("NPU-D")
    host, _ = _host_columns(st, npu)
    karr = _knob_arrays(KnobGrid(**FULL_GRID).product(), npu, bk)
    return k2_timing_shapes(bk, host, st.n_segments,
                            int(karr["pair_saw_idx"].shape[0]),
                            int(karr["saw_unique"].shape[0]))


def time_k2(shapes, rng) -> list:
    """K2 at ``shapes`` (``k2_timing_shapes``) on uniform data from
    ``rng``: the wrapper's ``ms``, its device µs a call, the plain
    version, one ``index_add_`` and the bound."""
    import torch
    from repro_torch.kernels.segment_sum import (segment_starts, segment_sum,
                                                 segment_sum_plain)
    out = []
    for name, ids, num, batch in shapes:
        dev = ids.device
        n = int(ids.shape[0])
        data = torch.tensor(rng.uniform(1e-9, 1e3, (batch, n)), device=dev)
        stt = segment_starts(ids, num)
        lib_out = torch.zeros(batch, num, dtype=torch.float64, device=dev)
        nbytes = 8 * (batch * (n + num) + num + 1)
        nops = batch * n
        out.append({
            "what": name, "B": batch, "n": n, "num_segments": num,
            "ms": event_ms(lambda: segment_sum(data, ids, num, stt), 100),
            "device_us": kernel_device_us(
                lambda: segment_sum(data, ids, num, stt),
                "segment_sum_kernel", reps=20),
            "plain_ms": event_ms(
                lambda: segment_sum_plain(data, ids, num), 30),
            "library_ms": event_ms(
                lambda: lib_out.zero_().index_add_(-1, ids, data), 30),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            nops / FP64_FLOPS_PER_S) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= nops / FP64_FLOPS_PER_S else "operations"})
    return out


# ---- the serving path: kernels B3 / B4 and qwen2.5-3b ---------------------

def attn_tolerance(dtype) -> float:
    """Kernel vs plain version, both on the card: float32 differs only in
    the order of float32 sums; a bf16 output may differ by one rounding
    step of a value near 1. The tolerances of tests/test_kernels.py."""
    import torch
    return {torch.float32: 2e-5, torch.bfloat16: 2e-2}[dtype]


def b3_bound(B, S, H, Hkv, D, dtype) -> tuple[float, str]:
    """Least time for causal self-attention over S tokens: q, k, v read
    and the output written once; the live (causal) score entries S(S+1)/2
    per (batch, head) at 2 D operations each for QK and for PV."""
    import torch
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = el * (2 * B * S * H * D + 2 * B * S * Hkv * D)
    flops = 4 * B * H * D * S * (S + 1) / 2
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def b4_bound(B, n_live, H, Hkv, D, dtype) -> tuple[float, str]:
    """Least time for one query per head against ``n_live`` cache slots:
    the live K and V rows read once, q read and the output written."""
    import torch
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = el * (2 * B * n_live * Hkv * D + 2 * B * H * D)
    flops = 4 * B * H * D * n_live
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def b4_rel_l2_gate(q, kc, vc, cache_len: int, got, what: str) -> dict:
    """B4 bf16's whole-output relative L2 to its plain version, held to
    ``B4_REL_L2_BF16``, beside its control: the plain version over every
    split but the last, which must exceed the limit."""
    from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                      decode_splits)
    n_split, split_len = decode_splits(cache_len + 1)
    check(n_split > 1, f"{what}: one split has no last split to drop")
    want = decode_attention_plain(q, kc, vc, cache_len)
    gate = {"rel_l2": b3_rel_l2(got, want),
            "median_abs_plain": float(want.float().abs().median()),
            "control_rel_l2": {"last_split_dropped": b3_rel_l2(
                decode_attention_plain(q, kc, vc,
                                       (n_split - 1) * split_len - 1),
                want)},
            "limit_rel_l2": B4_REL_L2_BF16}
    check(gate["rel_l2"] <= B4_REL_L2_BF16,
          f"{what}: relative L2 {gate['rel_l2']} > {B4_REL_L2_BF16}")
    ctrl = gate["control_rel_l2"]["last_split_dropped"]
    check(ctrl > B4_REL_L2_BF16,
          f"{what}: the control (the last split dropped) has relative L2 "
          f"{ctrl} <= {B4_REL_L2_BF16}: the limit cannot see a lost split")
    return gate


def b4_boundary_lengths() -> set:
    """cache_len values whose live slots end on, or one before or after,
    the first two split boundaries of B4's schedule."""
    from repro_torch.kernels.decode_attention import SPLIT_LEN
    return {k * SPLIT_LEN - 1 + d for k in (1, 2) for d in (-1, 0, 1)}


def check_attention_kernels(dev) -> dict:
    """B3 and B4 against their plain versions on the card, bf16 and
    float32, at the ragged and edge cases of the serving path."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (TILE, flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    err = {"b3": {}, "b4": {}}
    cases = {"b3": 0, "b4": 0}
    rel = {}  # B4 bf16's relative L2 gate at the serving cache length
    D, Hkv = 128, 2
    for dtype in (torch.bfloat16, torch.float32):
        tol = attn_tolerance(dtype)
        dn = str(dtype).split(".")[-1]
        for S in (1, 17, 128, 2047, 2048, 2049):
            for groups in (1, 8):
                H = Hkv * groups
                q, k, v = (rnd((2, S, h, D), dtype) for h in (H, Hkv, Hkv))
                n_qt = -(-S // TILE)
                tiles = torch.zeros((2, H, n_qt), dtype=torch.int32,
                                    device=dev)
                got = flash_attention(q, k, v, tiles_loaded=tiles)
                want = flash_attention_plain(q, k, v)
                torch.cuda.synchronize()
                what = f"flash_attention[{dn}, S={S}, groups={groups}]"
                check(got.shape == want.shape and got.dtype == dtype,
                      f"{what}: shape/dtype")
                e = max_abs(got.float(), want.float())
                err["b3"][dn] = max(err["b3"].get(dn, 0.0), e)
                check(torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol), f"{what}: differs by {e}")
                # causal: query tile t loads key tiles 0..t and no more
                want_tiles = torch.arange(1, n_qt + 1, dtype=torch.int32,
                                          device=dev).expand(2, H, n_qt)
                check(torch.equal(tiles, want_tiles),
                      f"{what}: loaded tiles {tiles[0, 0].tolist()}")
                cases["b3"] += 1
        Smax = 2080  # the serving cache: not a multiple of B4's split
        # and lengths on and next to split boundaries (n_live = clen + 1);
        # D 64 gives float32 the lane layout of bf16 at D 128
        for clen, groups, Db in itertools.product(
                sorted({0, 1, 511, 512, Smax - 1} | b4_boundary_lengths()),
                (1, 8), (D, 64)):
            H = Hkv * groups
            q = rnd((2, 1, H, Db), dtype)
            kc, vc = rnd((2, Smax, Hkv, Db), dtype), \
                rnd((2, Smax, Hkv, Db), dtype)
            want = decode_attention_plain(q, kc, vc, clen)
            live = kc[:, :clen + 1].clone(), vc[:, :clen + 1].clone()
            kc[:, clen + 1:] = float("nan")  # must never be read
            vc[:, clen + 1:] = float("nan")
            got = decode_attention(q, kc, vc, clen)
            again = decode_attention(q, kc, vc, clen)
            torch.cuda.synchronize()
            what = (f"decode_attention[{dn}, len={clen}, groups={groups}, "
                    f"D={Db}]")
            check(torch.equal(got, again),
                  f"{what}: a second call is not bit-identical")
            e = max_abs(got.float(), want.float())
            err["b4"][dn] = max(err["b4"].get(dn, 0.0), e)
            check(bool(torch.isfinite(got).all()),
                  f"{what}: read a slot past cache_len")
            check(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol), f"{what}: differs by {e}")
            if dtype == torch.bfloat16 and clen == Smax - 1 and Db == D:
                rel[f"len={clen}, groups={groups}"] = b4_rel_l2_gate(
                    q, *live, clen, got, what)
            cases["b4"] += 1
    # tiles past the diagonal are never loaded: poison every key the
    # causal loop bound cuts (Sq=130 needs key tiles 0..2, keys < 192)
    q = rnd((1, 130, 2, D), torch.bfloat16)
    k, v = (rnd((1, 300, 1, D), torch.bfloat16) for _ in range(2))
    want = flash_attention_plain(q, k, v)
    k[:, 192:], v[:, 192:] = float("nan"), float("nan")
    got = flash_attention(q, k, v)
    check(bool(torch.isfinite(got).all())
          and torch.allclose(got.float(), want.float(), atol=2e-2,
                             rtol=2e-2),
          "flash_attention loaded a key tile past the diagonal")
    # a zero-sized batch: empty results, no launch
    b3, b4 = flash_attention.launches, decode_attention.launches
    z3 = flash_attention(q[:0], q[:0, :, :1], q[:0, :, :1])
    z4 = decode_attention(q[:0, :1], k[:0], v[:0], 5)
    check(z3.shape == (0, 130, 2, D) and z4.shape == (0, 1, 2, D)
          and (flash_attention.launches, decode_attention.launches)
          == (b3, b4), "a zero-sized batch must not launch")
    return {"cases": cases, "max_abs_err": err, "b4_bf16_rel_l2": rel}


def b3_rounded_p(q, k, v, bits: int):
    """Causal B3 with the unnormalized probabilities ``exp(s - max)``
    rounded to nearest at ``bits`` stored mantissa bits before P·V, the
    row sum taken from the unrounded float32 values: at 7 bits what the
    bf16 kernel does, at fewer a deliberately wrong rounding."""
    import torch
    H, Hkv, D = q.shape[2], k.shape[2], q.shape[3]
    k, v = (t.repeat_interleave(H // Hkv, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    i = torch.arange(s.shape[-1], device=q.device)
    s.masked_fill_(i[None, :] > i[:s.shape[-2], None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    l = p.sum(dim=-1, keepdim=True).transpose(1, 2)
    drop = 23 - bits
    p = ((p.view(torch.int32) + (1 << (drop - 1)))
         & ~((1 << drop) - 1)).view(torch.float32)
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l).to(q.dtype)


def b3_rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over the whole output, in float32."""
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def time_b3(q, k, v) -> dict:
    """B3 at the shapes the main path gives it, beside its bound, its
    plain version and one library call of the same function. bf16 is
    also held to ``B3_REL_L2_BF16``, beside its control."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    err = max_abs(got.float(), want.float())
    check(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"flash_attention at the model's shapes differs by {err}")
    accuracy = {"rel_l2": b3_rel_l2(got, want),
                "max_row_rel_l2": float(rel_l2(got, want).max()),
                "median_abs_plain": float(want.float().abs().median())}
    del got
    if q.dtype == torch.bfloat16:
        accuracy["control_rel_l2"] = {
            f"p_{bits}_bits": b3_rel_l2(b3_rounded_p(q, k, v, bits), want)
            for bits in (7, B3_CONTROL_BITS)}
        accuracy["limit_rel_l2"] = B3_REL_L2_BF16
        check(accuracy["rel_l2"] <= B3_REL_L2_BF16,
              f"flash_attention (bf16) at the model's shapes: relative L2 "
              f"{accuracy['rel_l2']} > {B3_REL_L2_BF16}")
        ctrl = accuracy["control_rel_l2"][f"p_{B3_CONTROL_BITS}_bits"]
        check(ctrl > B3_REL_L2_BF16,
              f"the control (p at {B3_CONTROL_BITS} mantissa bits) has "
              f"relative L2 {ctrl} <= {B3_REL_L2_BF16}: the limit cannot "
              f"see a rounding fault")
    del want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
    except TypeError:  # a torch without enable_gqa: repeat the KV heads
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (kt, vt))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kr, vr, is_causal=True)
    bound, by = b3_bound(B, S, H, Hkv, D, q.dtype)
    return {"shape": {"q": list(q.shape), "kv": list(k.shape),
                      "dtype": str(q.dtype)},
            "max_abs_err": err, **accuracy,
            "ms": event_ms(lambda: flash_attention(q, k, v), 10),
            "device_us": kernel_device_us(
                lambda: flash_attention(q, k, v),
                B3_KERNELS[str(q.dtype).split(".")[-1]]),
            "plain_ms": event_ms(lambda: flash_attention_plain(q, k, v), 3,
                                 warmup=1),
            "library_ms": event_ms(lib, 10),
            "bound_ms": bound, "bound_by": by}


def time_b4(q, kc, vc, cache_len: int) -> dict:
    """B4 at the shapes the main path gives it (one layer's cache),
    beside its bound, its plain version and one library call of the same
    function (by events and by its device time); bf16 is also held to
    ``B4_REL_L2_BF16``, beside its control."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      decode_splits)
    B, _, H, D = q.shape
    Hkv = kc.shape[2]
    got = decode_attention(q, kc, vc, cache_len)
    again = decode_attention(q, kc, vc, cache_len)
    want = decode_attention_plain(q, kc, vc, cache_len)
    err = max_abs(got.float(), want.float())
    check(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"decode_attention at the model's shapes differs by {err}")
    check(torch.equal(got, again), "decode_attention at the model's "
          "shapes: a second call is not bit-identical")
    accuracy = {} if q.dtype != torch.bfloat16 else b4_rel_l2_gate(
        q, kc, vc, cache_len, got, "decode_attention (bf16) at the "
        "model's shapes")
    n_split, split_len = decode_splits(cache_len + 1)
    qt = q.transpose(1, 2)
    kt, vt = (c[:, :cache_len + 1].transpose(1, 2) for c in (kc, vc))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True)
    except TypeError:
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (kt, vt))
        lib = lambda: F.scaled_dot_product_attention(qt, kr, vr)  # noqa
    bound, by = b4_bound(B, cache_len + 1, H, Hkv, D, q.dtype)
    return {"shape": {"q": list(q.shape), "cache": list(kc.shape),
                      "cache_len": cache_len, "dtype": str(q.dtype),
                      "n_split": n_split, "split_len": split_len},
            "max_abs_err": err, **accuracy, "bit_identical_rerun": True,
            "ms": event_ms(lambda: decode_attention(q, kc, vc, cache_len),
                           50),
            "device_us": kernel_device_us(
                lambda: decode_attention(q, kc, vc, cache_len), B4_KERNELS),
            "plain_ms": event_ms(
                lambda: decode_attention_plain(q, kc, vc, cache_len), 10),
            "library_ms": event_ms(lib, 50),
            "library_device_us": kernel_device_us(lib),
            "bound_ms": bound, "bound_by": by}


# ---- the SSD path: kernel B5 and mamba2-780m --------------------------------

def b5_bound(B, S, H, P, G, N, dtype) -> tuple[float, str]:
    """Least time for the SSD scan: x, B, C, dt and A read once, y
    (float32) and the final state written once; the sequential form's
    4 P N operations per token and head at the peak for x's type."""
    import torch
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = el * (B * S * H * P + 2 * B * S * G * N) + 4 * (
        B * S * H + H + B * S * H * P + B * H * P * N)
    flops = 4 * P * N * B * S * H
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def scaled_err(got, want) -> float:
    """max |got - want| over max |want|, float32."""
    return max_abs(got.float(), want.float()) / (
        float(want.float().abs().max()) + 1e-6)


def _ssd_ref(x, dt, A, B, C):
    """``ref_ssd`` (the sequential recurrence) in the wrapper's layout:
    (batch, head) folded, groups repeated to heads; x widened to float32
    (the same values), since ``ref_ssd`` returns y in x's dtype."""
    from repro_torch.kernels.ref import ref_ssd
    Bz, S, H, P = x.shape
    rep = H // B.shape[2]

    def fold(t):
        t = t.repeat_interleave(rep, dim=2) if t.shape[2] != H else t
        return t.permute(0, 2, 1, 3).reshape(Bz * H, S, t.shape[-1])

    y, h = ref_ssd(fold(x.float()), dt.permute(0, 2, 1).reshape(Bz * H, S),
                   A.reshape(Bz * H), fold(B), fold(C))
    return (y.reshape(Bz, H, S, P).permute(0, 2, 1, 3),
            h.reshape(Bz, H, P, -1))


def check_ssd_kernel(dev) -> dict:
    """B5 against its plain version on the card: the SSD_CASES shapes of
    tests/test_kernels.py, the serving shape, ragged S, G = 2 and the
    reduced widths, bf16 and float32, the bf16 route's ring and tiling
    boundaries and an unaligned x, the final state written into a cache
    slice; a strong-decay case (A = -16, dt ~ 10: a mask after exp
    would give inf * 0 = NaN) against ``ref_ssd``, whose sequential sums
    keep cum_last - cum_j exact where the plain version's parallel
    cumsum at |cum| ~ 1e4 does not."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(Bz, S, H, P, G, N, dtype, strong=False):
        x = rnd((Bz, S, H * P)).to(dtype).view(Bz, S, H, P)
        if strong:
            dt = 10.0 + 0.1 * torch.rand((Bz, S, H), generator=gen,
                                         device=dev)
            A = torch.full((H,), -16.0, device=dev)
        else:
            dt = F.softplus(rnd((Bz, S, H)))
            A = -torch.exp(1.5 * torch.rand((H,), generator=gen, device=dev))
        bc = rnd((Bz, S, 2 * G * N)).to(dtype)  # B and C: strided views
        return (x, dt, A.expand(Bz, H), bc[..., :G * N].view(Bz, S, G, N),
                bc[..., G * N:].view(Bz, S, G, N))

    err = {"float32": 0.0, "bfloat16": 0.0}
    cases = []

    def one(what, args, strong=False):
        dn = str(args[0].dtype).split(".")[-1]
        Bz, S, H, P = args[0].shape
        N = args[3].shape[-1]
        # the state into the middle slice of a cache-like buffer
        buf = torch.full((3, Bz, H, P, N), 7.0, device=dev)
        y, h = ssd_scan(*args, out_state=buf[1])
        want = _ssd_ref(*args) if strong else ssd_scan_plain(*args)
        torch.cuda.synchronize()
        ey, eh = scaled_err(y, want[0]), scaled_err(h, want[1])
        check(h.data_ptr() == buf[1].data_ptr()
              and bool((buf[0] == 7.0).all() and (buf[2] == 7.0).all()),
              f"ssd_scan[{what}]: the state went outside out_state")
        check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
              f"ssd_scan[{what}]: non-finite output")
        check(y.dtype == h.dtype == torch.float32
              and y.shape == args[0].shape, f"ssd_scan[{what}]: shape/dtype")
        check(max(ey, eh) <= SSD_TOL[dn],
              f"ssd_scan[{what}, {dn}]: scaled error y {ey}, state {eh} > "
              f"{SSD_TOL[dn]}")
        err[dn] = max(err[dn], ey, eh)
        cases.append(what)

    for BH, S, P, N in SSD_CASES:
        one(f"SSD_CASES BH={BH} S={S} P={P} N={N}",
            inputs(BH, S, 1, P, 1, N, torch.float32))
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        one(f"serving {dn}", inputs(4, 2048, 48, 64, 1, 128, dtype))
        for S in (1, 17, 255, 2049):
            one(f"ragged S={S} {dn}", inputs(2, S, 8, 64, 1, 128, dtype))
        one(f"G=2 {dn}", inputs(2, 300, 8, 64, 2, 128, dtype))
        one(f"reduced widths {dn}", inputs(2, 77, 8, 16, 1, 16, dtype))
        one(f"strong decay {dn}", inputs(2, 255, 8, 64, 1, 128, dtype,
                                          strong=True), strong=True)
    # the bf16 route's tiling: whole chunks filling the two-stage ring and
    # wrapping it (1, 2, 3 chunks), the other head and state dims, and an
    # x at an odd offset, which TMA cannot take and the wrapper copies
    for S in (64, 128, 192):
        one(f"ring S={S} bfloat16", inputs(2, S, 8, 64, 1, 128,
                                           torch.bfloat16))
    one("P=32 N=64 bfloat16", inputs(2, 200, 8, 32, 1, 64, torch.bfloat16))
    x, *rest = inputs(2, 130, 8, 64, 1, 128, torch.bfloat16)
    x = torch.cat([x.flatten(2), x.flatten(2)[..., :1]], dim=2)[..., 1:]
    one("x at an odd offset bfloat16", (x.view(2, 130, 8, 64), *rest))
    before = ssd_scan.launches
    z = inputs(1, 5, 8, 64, 1, 128, torch.bfloat16)
    y0, h0 = ssd_scan(*(t[:0] for t in z))
    check(y0.shape == (0, 5, 8, 64) and h0.shape == (0, 8, 64, 128)
          and ssd_scan.launches == before, "a zero-sized batch must not "
                                           "launch")
    return {"cases": len(cases), "scaled_err": err, "tolerance": SSD_TOL}


def b5_rounded_state(x, dt, A, B, C, bits: int):
    """The plain version's chunked form (``ssd_scan_plain``, groups one
    per head block) with the carried state rounded to nearest at ``bits``
    stored mantissa bits after every chunk: at 7 bits what a state kept
    in bf16 would give, at fewer a deliberately wrong rounding. Returns y
    and the final state, float32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import CHUNK, NEG_INF
    Bz, S, H, P = x.shape
    N, rep = B.shape[-1], H // B.shape[2]
    nc = -(-S // CHUNK)
    pad = nc * CHUNK - S
    xf, Bf, Cf = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    drop = 23 - bits

    def rnd(t):
        return ((t.view(torch.int32) + (1 << (drop - 1)))
                & ~((1 << drop) - 1)).view(torch.float32)

    h = torch.zeros((Bz, H, P, N), device=x.device)
    iq = torch.arange(CHUNK, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]
    ys = []
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        xq, dtq = xf[:, sl], dtf[:, sl]
        Bq, Cq = (t[:, sl].repeat_interleave(rep, dim=2) for t in (Bf, Cf))
        cum = torch.cumsum(dtq * A.float()[:, None, :], dim=1)
        lmat = torch.exp(torch.where(
            causal, cum[:, :, None, :] - cum[:, None, :, :],
            torch.full((), NEG_INF, device=x.device)))
        dx = dtq[..., None] * xq
        y = torch.einsum("bijh,bijh,bjhp->bihp",
                         torch.einsum("bihn,bjhn->bijh", Cq, Bq), lmat, dx)
        y += torch.einsum("bihn,bhpn,bih->bihp", Cq, h, torch.exp(cum))
        s_chunk = torch.einsum("bjhn,bjhp,bjh->bhpn", Bq, dx,
                               torch.exp(cum[:, -1:, :] - cum))
        h = rnd(h * torch.exp(cum[:, -1, :])[:, :, None, None] + s_chunk)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def time_b5(x, dt, A, Bm, Cm) -> dict:
    """B5 at the shapes the main path gives it, beside its bound and its
    plain version. No single PyTorch call computes the SSD scan, so there
    is no library time. bf16 is also held to ``B5_REL_L2_BF16`` beside its
    control, and its scan kernel to one wave of resident blocks."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    Bz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y, h = ssd_scan(x, dt, A, Bm, Cm)
    yw, hw = ssd_scan_plain(x, dt, A, Bm, Cm)
    dn = str(x.dtype).split(".")[-1]
    ey, eh = scaled_err(y, yw), scaled_err(h, hw)
    check(max(ey, eh) <= SSD_TOL[dn], f"ssd_scan at the model's shapes: "
                                      f"scaled error {ey}, {eh}")
    accuracy = {"rel_l2": {"y": b3_rel_l2(y, yw), "state": b3_rel_l2(h, hw)}}
    max_abs_err = max(max_abs(y, yw), max_abs(h, hw))
    del y, h
    if x.dtype == torch.bfloat16:
        ctrl = {}
        for bits in (7, B5_CONTROL_BITS):
            yc, hc = b5_rounded_state(x, dt, A, Bm, Cm, bits)
            ctrl[f"state_{bits}_bits"] = {"y": b3_rel_l2(yc, yw),
                                          "state": b3_rel_l2(hc, hw)}
            del yc, hc
        accuracy["control_rel_l2"] = ctrl
        accuracy["limit_rel_l2"] = B5_REL_L2_BF16
        worst = max(accuracy["rel_l2"].values())
        check(worst <= B5_REL_L2_BF16,
              f"ssd_scan (bf16) at the model's shapes: relative L2 "
              f"{accuracy['rel_l2']} > {B5_REL_L2_BF16}")
        c3 = min(ctrl[f"state_{B5_CONTROL_BITS}_bits"].values())
        check(c3 > B5_REL_L2_BF16,
              f"the control (the state at {B5_CONTROL_BITS} mantissa bits) "
              f"has relative L2 {c3} <= {B5_REL_L2_BF16}: the limit cannot "
              f"see a rounding fault")
        from repro_torch.kernels.ssd_scan import bf16_occupancy
        occ = bf16_occupancy(P, N)
        occ["blocks"] = Bz * H
        occ["sms"] = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        occ["waves"] = -(-occ["blocks"] // (occ["blocks_per_sm"]
                                            * occ["sms"]))
        check(occ["waves"] == 1, f"ssd_scan_bf16_kernel at the model's "
                                 f"shapes: not one wave of resident blocks "
                                 f"({occ})")
        accuracy["occupancy"] = occ
    del yw, hw
    bound, by = b5_bound(Bz, S, H, P, G, N, x.dtype)
    run = lambda: ssd_scan(x, dt, A, Bm, Cm)  # noqa: E731
    return {"shape": {"x": list(x.shape), "B": list(Bm.shape),
                      "dtype": str(x.dtype)},
            "max_abs_err": max_abs_err, "scaled_err": max(ey, eh),
            **accuracy,
            "ms": event_ms(run, 20),
            "device_us": kernel_device_us(run, B5_KERNELS[dn]),
            "plain_ms": event_ms(lambda: ssd_scan_plain(x, dt, A, Bm, Cm),
                                 3, warmup=1),
            "library_ms": None,
            "library_note": "no single PyTorch call computes the SSD scan",
            "bound_ms": bound, "bound_by": by}


def ssd_model_shapes(srv, prompts) -> dict:
    """B5 on the inputs layer 0 of the full mamba2 model gives it: the
    prompt's x, dt, A, B, C (B/C per group, not repeated)."""
    import torch
    from repro_torch.models import blocks
    from repro_torch.models.common import rms_norm
    from repro_torch.models.model import _layer
    cfg = srv.cfg
    p0 = _layer(srv.params["layers"], 0)["ssd"]
    toks = torch.tensor(prompts, dtype=torch.int64, device="cuda")
    h = rms_norm(srv.params["embed"][toks], p0["ln"], cfg.norm_eps)
    x, _, dt, Bm, Cm, _ = blocks._ssd_inputs(p0, h, cfg)
    A = -torch.exp(p0["A_log"].float()).expand(x.shape[0], -1)
    return time_b5(x, dt, A, Bm, Cm)


# ---- the gated matmul: kernel B2 ---------------------------------------------

def gm_bound(M, K, N, live, bk, bn, dtype) -> tuple[float, str]:
    """Least time for the gated product: 2 M bk bn operations per live
    weight tile; x, the live w tiles and the output moved once."""
    import torch
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = el * (M * K + live * bk * bn + M * N)
    flops = 2 * M * bk * bn * live
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def gm_compare(got, want, what: str) -> float:
    """Hard allclose of B2 against its plain version (GM_TOL); returns
    the max absolute error."""
    import torch
    dn = str(want.dtype).split(".")[-1]
    tol = GM_TOL[dn]
    g, w = got.float(), want.float()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"gated_matmul[{what}]: shape/dtype {tuple(got.shape)} "
          f"{got.dtype} vs {tuple(want.shape)} {want.dtype}")
    e = max_abs(g, w)
    check(bool(torch.isfinite(g).all()), f"gated_matmul[{what}]: non-finite")
    check(torch.allclose(g, w, rtol=tol,
                         atol=tol * float(w.abs().max()) + 1e-5),
          f"gated_matmul[{what}, {dn}]: differs from its plain version by "
          f"{e}")
    return e


def check_gated_matmul_kernel(dev) -> dict:
    """B2 against its plain version on the card, float32 and bf16: the
    GM_CASES with their zero columns and rows, every block instance on a
    random bitmap, and a hand-made bitmap that drops nonzero tiles (x
    NaN in a dropped K tile: never loaded); the executed-tile count
    exactly, every case."""
    import itertools

    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gated_matmul import (BLOCKS, gated_matmul_p,
                                                  gated_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"float32": 0.0, "bfloat16": 0.0}
    cases = []

    def one(what, x, w, bitmap, **blocks):
        dn = str(x.dtype).split(".")[-1]
        bm = blocks.get("bm", 128)
        gated_matmul_p.tiles_run.zero_()
        got = gated_matmul_p(x, w, bitmap, **blocks)
        torch.cuda.synchronize()
        tiles = int(gated_matmul_p.tiles_run)
        want_tiles = (x.shape[0] // bm) * int((bitmap != 0).sum())
        check(tiles == want_tiles, f"gated_matmul[{what}, {dn}]: ran "
                                   f"{tiles} tiles, want {want_tiles}")
        want = gated_matmul_plain(x, w, bitmap, **blocks)
        err[dn] = max(err[dn], gm_compare(got, want, f"{what}, {dn}"))
        cases.append(f"{what} {dn}")
        return got

    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        for M, K, N, zn, zk in GM_CASES:
            x, w = rnd(M, K), rnd(K, N)
            if zn:
                w[:, N - zn:] = 0.0
            if zk:
                w[K - zk:] = 0.0
            one(f"GM_CASES {(M, K, N, zn, zk)}", x, w,
                ops.tile_nonzero_bitmap(w, 128, 128))
        for bm, bn, bk in itertools.product(BLOCKS, BLOCKS, BLOCKS):
            x, w = rnd(256, 384), rnd(384, 256)
            bitmap = (torch.rand((384 // bk, 256 // bn), generator=gen,
                                 device=dev) > 0.4).to(torch.int32)
            one(f"blocks {(bm, bn, bk)}", x, w, bitmap, bm=bm, bn=bn, bk=bk)
        x, w = rnd(256, 384), rnd(384, 512)
        x[:, 128:256] = float("nan")  # K tile 1: dropped everywhere
        bitmap = torch.tensor([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 0]],
                              dtype=torch.int32, device=dev)
        got = one("hand bitmap", x, w, bitmap)
        x[:, 128:256] = 0.0
        dense = gated_matmul_plain(x, w, torch.ones_like(bitmap))
        check(max_abs(got[:, 128:256].float(), dense[:, 128:256].float())
              > 1.0, "gated_matmul: the hand bitmap's 0 over nonzero "
                     "weights did not drop them")
    before = gated_matmul_p.launches
    z = gated_matmul_p(x[:0], w, bitmap)
    check(z.shape == (0, 512) and gated_matmul_p.launches == before,
          "gated_matmul on zero rows must not launch")
    refused = False
    try:
        gated_matmul_p(x, w, bitmap, bm=32, bn=128, bk=128)
    except ValueError:
        refused = True
    check(refused, "gated_matmul: a block size the kernel is not built "
                   "for must raise on the card")
    return {"cases": len(cases), "max_abs_err": err, "tolerance": GM_TOL}


def gated_matmul_full(card: str) -> dict:
    """The B2 path at full width: ``ops.gated_matmul`` on qwen2.5-3b's
    gate/up projection at serve_full's prefill, in the GM_FULL_CASES
    patterns. The run that counts launches is one call per case; then
    each case is checked against the plain version and timed beside its
    bound, its plain version and ``torch.matmul`` on the same operands
    (the same function with nothing skipped; float32 with TF32 off)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gated_matmul import (gated_matmul_p,
                                                  gated_matmul_plain)
    M, K, N = GM_FULL
    bt = 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    x32 = torch.randn((M, K), generator=gen, device="cuda")
    w32 = torch.randn((K, N), generator=gen, device="cuda")
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    xs = {dn: x32.to(dt) for dn, dt in dtypes.items()}
    ws, live = {}, {}
    for name, zn, zk, dn in GM_FULL_CASES:
        w = w32.to(dtypes[dn], copy=True)
        if zn:
            w[:, N - zn:] = 0.0
        if zk:
            w[K - zk:] = 0.0
        ws[name] = w
        live[name] = ((K - zk) // bt) * ((N - zn) // bt)
    del x32, w32

    # the path: one call per case, counts set to 0 just before
    reset_launches()
    gated_matmul_p.tiles_run.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiles = {}
    for name, _, _, dn in GM_FULL_CASES:
        before = int(gated_matmul_p.tiles_run)
        out = ops.gated_matmul(xs[dn], ws[name])
        tiles[name] = int(gated_matmul_p.tiles_run) - before  # synced
        check(out.shape == (M, N) and out.dtype == dtypes[dn]
              and bool(torch.isfinite(out).all()),
              f"gated_matmul_full[{name}]: shape/dtype/finite")
        del out
    wall = time.perf_counter() - t0
    launches = read_launches()
    want_launches = expected_launches("gated_matmul", len(GM_FULL_CASES))
    check(launches == want_launches,
          f"gated_matmul_full launched {launches}, want {want_launches}")
    for name, _, _, _ in GM_FULL_CASES:
        check(tiles[name] == (M // bt) * live[name],
              f"gated_matmul_full[{name}]: ran {tiles[name]} tiles, want "
              f"{(M // bt) * live[name]}")

    cases = {}
    for name, zn, zk, dn in GM_FULL_CASES:
        x, w, dt = xs[dn], ws[name], dtypes[dn]
        bitmap = ops.tile_nonzero_bitmap(w, bt, bt)
        check(int(bitmap.sum()) == live[name],
              f"gated_matmul_full[{name}]: the bitmap marks "
              f"{int(bitmap.sum())} live tiles, want {live[name]}")
        got = gated_matmul_p(x, w, bitmap)
        want = gated_matmul_plain(x, w, bitmap)
        err = gm_compare(got, want, f"full {name}")
        scale = float(want.float().abs().max())
        del got, want
        kern = ("gated_matmul_bf16_kernel" if dt == torch.bfloat16
                else "gated_matmul_f32_kernel")
        bound, by = gm_bound(M, K, N, live[name], bt, bt, dt)
        cases[name] = {
            "dtype": dn, "zero_cols": zn, "zero_rows": zk,
            "live_weight_tiles": live[name], "tiles_run": tiles[name],
            "max_abs_err": err, "max_abs_plain": scale,
            "ms": event_ms(lambda: gated_matmul_p(x, w, bitmap), 10),
            "ms_with_bitmap": event_ms(lambda: ops.gated_matmul(x, w), 10),
            "device_us": kernel_device_us(
                lambda: gated_matmul_p(x, w, bitmap), kern),
            "plain_ms": event_ms(lambda: gated_matmul_plain(x, w, bitmap),
                                 3, warmup=1),
            "library_ms": event_ms(lambda: torch.matmul(x, w), 10),
            "bound_ms": bound, "bound_by": by}
        cases[name]["ms_over_bound"] = cases[name]["ms"] / bound
    dense_ms = cases["dense"]["ms"]
    for name, rec in cases.items():
        if rec["dtype"] == "bfloat16":
            rec["ms_ratio_to_dense"] = rec["ms"] / dense_ms
    return {"card": card, "shape": {"x": [M, K], "w": [K, N],
                                    "blocks": [bt, bt, bt]},
            "launches": launches, "wall_s_path": wall, "cases": cases,
            "tolerance": GM_TOL}


def evaluate_all_phase(card: str, suite) -> dict:
    """``evaluate_all(wl, "NPU-D")`` on the card (K1, K2) for every
    paper-suite workload, against the host engine ``evaluate`` for each
    policy: every EnergyReport field within EVAL_ALL_RTOL relative."""
    from repro_torch.core import evaluate, evaluate_all
    from repro_torch.core.policies import POLICIES
    from repro_torch.core.power import COMPONENTS
    reset_launches()
    t0 = time.perf_counter()
    on_card = [evaluate_all(wl, "NPU-D") for wl in suite]
    wall_card = time.perf_counter() - t0
    launches = read_launches()
    check(launches["sa_occupancy"] > 0 and launches["segment_sum"] > 0
          and all(v == 0 for k, v in launches.items()
                  if k not in ("sa_occupancy", "segment_sum")),
          f"evaluate_all launched {launches}")
    t0 = time.perf_counter()
    on_host = [{p: evaluate(wl, "NPU-D", p) for p in POLICIES}
               for wl in suite]
    wall_host = time.perf_counter() - t0
    worst, n = 0.0, 0
    for wl, got, want in zip(suite, on_card, on_host):
        check(list(got) == list(POLICIES), "evaluate_all: policies")
        for p in POLICIES:
            a, b = got[p], want[p]
            check((a.workload, a.policy, a.npu) == (b.workload, b.policy,
                                                    b.npu),
                  f"evaluate_all[{wl.name}/{p}]: labels")
            vals = [(a.runtime_s, b.runtime_s),
                    (a.setpm_count, b.setpm_count)]
            for f in ("static_j", "dynamic_j", "wake_events", "gated_s",
                      "setpm_by"):
                vals += [(getattr(a, f)[c], getattr(b, f)[c])
                         for c in COMPONENTS]
            for va, vb in vals:
                worst = max(worst, abs(va - vb) / max(1e-30, abs(va),
                                                      abs(vb)))
            n += 1
    check(worst <= EVAL_ALL_RTOL, f"evaluate_all on the card vs evaluate: "
                                  f"{worst} > {EVAL_ALL_RTOL}")
    return {"card": card, "npu": "NPU-D", "workloads": len(suite),
            "reports": n, "launches": launches, "wall_s_card": wall_card,
            "wall_s_host_evaluate": wall_host, "max_rel_err": worst,
            "tolerance_rel": EVAL_ALL_RTOL}


def program_plane_records(card: str, suite) -> dict:
    """``sweep_program_plane`` on the card (B7 once a call, K1 and K2 for
    the policy side) against the same call on the CPU (B7's plain
    version): the same 272 records in the same order, every field bit
    for bit — the executor's integers and the host folds exactly, the
    policy side as the sweep's own card-vs-CPU records — and a second
    card call bit-identical to the first."""
    from repro_torch.core.policies import KnobGrid
    from repro_torch.core.sweep import sweep_program_plane
    grid = KnobGrid(**PP_RECORD_GRID)
    reset_launches()
    t0 = time.perf_counter()
    on_card = sweep_program_plane(suite, PP_RECORD_NPUS, grid)
    wall_card = time.perf_counter() - t0
    launches = read_launches()
    check(launches["program_exec"] == 1 and launches["sa_occupancy"] > 0
          and launches["segment_sum"] > 0
          and all(v == 0 for k, v in launches.items() if k not in
                  ("program_exec", "sa_occupancy", "segment_sum")),
          f"sweep_program_plane launched {launches}")
    again = sweep_program_plane(suite, PP_RECORD_NPUS, grid)
    t0 = time.perf_counter()
    on_cpu = sweep_program_plane(suite, PP_RECORD_NPUS, grid, device="cpu")
    wall_cpu = time.perf_counter() - t0
    n = len(suite) * len(PP_RECORD_NPUS) * len(grid.product())
    check(len(on_card) == len(on_cpu) == len(again) == n,
          f"program plane record count {len(on_card)}, want {n}")
    exact = ("prog_", "n_events", "stall_", "wakes_prog", "setpm_prog")
    worst, n_fields = 0.0, 0
    for a, b, c in zip(on_cpu, on_card, again):
        check(list(a) == list(b) == list(c), "program plane record fields")
        for k, va in a.items():
            if k.startswith(exact):
                check(type(va) is type(b[k]) and va == b[k],
                      f"program plane executor field {k}: card {b[k]!r} "
                      f"vs CPU {va!r}")
            elif isinstance(va, float):
                worst = max(worst, abs(va - b[k])
                            / max(1e-30, abs(va), abs(b[k])))
            n_fields += 1
        check(a == b, f"program plane record {a['workload']}/{a['npu']}/"
                      f"{a['knob_idx']}: card differs from the CPU")
        check(b == c, f"program plane record {b['workload']}/{b['npu']}/"
                      f"{b['knob_idx']}: a second card call differs")
    return {"card": card, "records": n, "fields_compared": n_fields,
            "npus": list(PP_RECORD_NPUS), "knobs": len(grid.product()),
            "launches": launches, "max_rel_err": worst,
            "bit_identical_to_cpu": True, "bit_identical_rerun": True,
            "wall_s_card": wall_card, "wall_s_cpu": wall_cpu}


def sm_clock_max_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def program_plane_full(card: str, suite) -> dict:
    """The program plane at full width: ``sweep_program_plane`` over the
    paper suite x every NPU x ``PP_FULL_GRID`` from cold caches, with
    its launches (B7 exactly once) and its wall split into the host
    preparation (lowering; instrumentation and event streams), the
    executor call (``_run_streams``: the unique streams and the per-row
    parameters to the card, ``upload_s`` of it, B7, the outputs back) and
    the rest (the closed-form folds, the policy side through
    ``evaluate_batch``, the records), each timed inside that one call.
    Then B7 on the very arguments that call uploaded: through the stream
    entry and, on the same streams packed dense, the dense entry, each
    held ``torch.equal`` to its plain version on the CPU and on the
    card, the stream entry also on a second call; timed through the
    stream entry by CUDA events and by its device time."""
    import numpy as np
    import torch
    from repro_torch.core import lowering
    from repro_torch.core import program_plane as pp
    from repro_torch.core.hw import NPUS
    from repro_torch.core.policies import KnobGrid
    from repro_torch.core.sweep import sweep_program_plane
    from repro_torch.kernels.program_exec import (pack_streams, program_exec,
                                                  program_exec_plain,
                                                  program_exec_streams)

    grid = KnobGrid(**PP_FULL_GRID)
    spent, uploaded = {}, []

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            spent[name] = time.perf_counter() - t
            if name == "upload_s":
                uploaded.append((a[0], out))
            return out
        return run

    steps = {"lowering_s": pp._plane_rows,
             "instrument_and_streams_s": pp.build_program_arrays,
             "upload_s": pp._upload_streams, "executor_s": pp._run_streams}
    lowering._LOWER_CACHE.clear()
    lowering._INSTR_CACHE.clear()
    pp._STREAM_CACHE.clear()
    try:
        for name, fn in steps.items():
            setattr(pp, fn.__name__, timed(name, fn))
        reset_launches()
        t0 = time.perf_counter()
        recs = sweep_program_plane(suite, tuple(NPUS), grid)
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        for fn in steps.values():
            setattr(pp, fn.__name__, fn)
    check(launches["program_exec"] == 1,
          f"sweep_program_plane launched program_exec "
          f"{launches['program_exec']} times, want 1")
    check(launches["sa_occupancy"] > 0 and launches["segment_sum"] > 0,
          f"sweep_program_plane's policy side launched {launches}")
    check(len(uploaded) == 1, f"the card path uploaded {len(uploaded)} "
                              f"times, want once")
    n = len(suite) * len(NPUS) * len(grid.product())
    check(len(recs) == n, f"{len(recs)} records, want {n}")
    for r in recs:
        check(r["prog_cycles"] > 0 and all(
            np.isfinite(v) for v in r.values() if isinstance(v, float)),
            f"record {r['workload']}/{r['npu']}: non-finite or empty")
        check(all(0.0 <= r[f"gated_frac_prog_{c}"] <= 1.0
                  for c in ("sa", "vu", "hbm", "ici", "sram")),
              f"record {r['workload']}/{r['npu']}: gated fraction out of "
              f"[0, 1]")
    pa, args = uploaded[0]
    streams, stream_of_row, rows = args
    bytes_to_card = sum(v.nbytes for v in
                        [*streams.values(), stream_of_row, *rows.values()])
    cpu = ({k: v.cpu() for k, v in streams.items()}, stream_of_row.cpu(),
           {k: v.cpu() for k, v in rows.items()})
    n_rows = int(stream_of_row.shape[0])
    got = program_exec_streams(*args)
    again = program_exec_streams(*args)
    dense = pack_streams(*args)
    got_dense = program_exec(dense)
    t0 = time.perf_counter()
    want = program_exec_plain(pack_streams(*cpu))
    plain_cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_card = program_exec_plain(dense)
    torch.cuda.synchronize()
    plain_card_s = time.perf_counter() - t0
    err = 0
    for k, v in want.items():
        check(got[k].shape == v.shape and got[k].dtype == torch.int64,
              f"program_exec[{k}]: shape/dtype {tuple(got[k].shape)} "
              f"{got[k].dtype}")
        err = max(err, int((got[k].cpu() - v).abs().max()) if v.numel()
                  else 0)
        check(torch.equal(got[k].cpu(), v),
              f"program_exec[{k}] differs from its plain version on the CPU")
        check(torch.equal(got[k], want_card[k]),
              f"program_exec[{k}] differs from its plain version on the "
              f"card")
        check(torch.equal(got[k], again[k]),
              f"program_exec[{k}]: two calls differ")
        check(torch.equal(got_dense[k], want_card[k]),
              f"program_exec[{k}]: the dense entry differs from the plain "
              f"version")
    ms = event_ms(lambda: program_exec_streams(*args), 20, warmup=2)
    device_us = kernel_device_us(lambda: program_exec_streams(*args),
                                 "program_exec_kernel")
    e_max = int(dense["cycle"].shape[0])
    per_row = pa.lengths[cpu[1].numpy()]
    used = np.unique(cpu[1].numpy())
    real = int((dense["cycle"] >= 0).sum())
    stream_events = int(pa.lengths[used].sum())
    chain = int(per_row.max()) if n_rows else 0
    bytes_ = (B7_EVENT_BYTES * stream_events + B7_STREAM_BYTES * len(used)
              + B7_ROW_BYTES * n_rows)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    row_copies_ms = (B7_EVENT_BYTES * real + B7_ROW_BYTES * n_rows) \
        / HBM_BYTES_PER_S * 1e3
    clock = sm_clock_max_hz()
    chain_ms = chain / clock * 1e3
    dense_bytes = int(sum(v.nbytes for v in dense.values()))
    del got, again, dense, got_dense, want_card, args, streams, rows
    torch.cuda.empty_cache()
    prep = spent["lowering_s"] + spent["instrument_and_streams_s"]
    return {"card": card, "workloads": len(suite), "npus": len(NPUS),
            "knobs": len(grid.product()), "rows": n_rows, "E": e_max,
            "U": int(pa.lat.shape[1]), "streams": int(pa.n_streams),
            "real_events": real, "stream_events": stream_events,
            "bytes_to_card": bytes_to_card,
            "dense_stack_bytes": dense_bytes,
            "records": n, "launches": launches,
            "wall_s_sweep_program_plane": wall, "host_prep_s": prep,
            "executor_s": spent["executor_s"],
            "rest_s": wall - prep - spent["executor_s"],
            "split_s": spent, "host_prep_share": prep / wall,
            "kernel_ms": ms, "kernel_device_us": device_us,
            "ns_per_step": device_us * 1e3 / chain if chain else None,
            "kernel_share_of_wall": device_us * 1e-6 / wall,
            "plain_ms_cpu": plain_cpu_s * 1e3,
            "plain_ms_card": plain_card_s * 1e3,
            "max_abs_err": err, "bytes": bytes_, "bytes_bound_ms": bytes_ms,
            "bytes_bound_ms_row_copies": row_copies_ms,
            "chain_steps": chain, "sm_clock_max_hz": clock,
            "chain_bound_ms": chain_ms,
            "bound_ms": max(bytes_ms, chain_ms),
            "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
            "tolerance": "torch.equal with the plain version on the CPU "
                         "and on the card, every row, through the stream "
                         "and the dense entry; bit-identical on a second "
                         "call"}


def rel_l2(got, want):
    """Per row ||got - want|| / ||want|| over the last axis, float32."""
    d = (got.float() - want.float()).norm(dim=-1)
    return d / want.float().norm(dim=-1).clamp_min(1e-30)


def _wrappers() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gated_matmul import gated_matmul_p
    from repro_torch.kernels.program_exec import program_exec
    from repro_torch.kernels.sa_occupancy import sa_occupancy
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"sa_occupancy": sa_occupancy, "segment_sum": segment_sum,
            "flash_attention": flash_attention,
            "decode_attention": decode_attention, "ssd_scan": ssd_scan,
            "gated_matmul": gated_matmul_p, "program_exec": program_exec}


def reset_launches() -> None:
    for k in _wrappers().values():
        k.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, k in _wrappers().items()}


def expected_launches(kernel, n: int) -> dict:
    """Every wrapper's count when only ``kernel`` launched, ``n`` times."""
    return {name: (n if name == kernel else 0) for name in _wrappers()}


def serve_full(card: str, arch: str):
    """A serving path at full width: ``Server(arch, reduced=False)`` on
    the card, batch 4, a 2048-token prompt, 32 generated tokens. Returns
    (the phase's record, the server, the prompts)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as M

    path = SERVE_PATHS[arch]
    t0 = time.perf_counter()
    srv = Server(arch, reduced=False, batch=SERVE_BATCH,
                 max_seq=SERVE_PROMPT + SERVE_TOKENS, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cfg = srv.cfg
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == path["widths"],
          f"not the full-width config: {cfg}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    srv.generate(prompts[:, :64], 2)  # warm-up: library handles, loads

    logits = []  # each step's last-position logits, kept on the card

    def recording(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            logits.append(out[0][:, -1].float())
            return out
        return wrapped

    plain_steps = (srv.prefill, srv.decode)
    srv.prefill, srv.decode = recording(srv.prefill), recording(srv.decode)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = srv.prefill_prompts(prompts)  # returns host tokens: synced
    t_prefill = time.perf_counter() - t0
    per_prefill = read_launches()
    toks, step_s, per_step = [tok], [], []
    for _ in range(SERVE_TOKENS - 1):
        before = read_launches()
        t1 = time.perf_counter()
        tok = srv.step(tok)
        step_s.append(time.perf_counter() - t1)
        after = read_launches()
        per_step.append({k: after[k] - before[k] for k in after})
        toks.append(tok)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    gen = np.stack(toks, axis=1)
    L = cfg.n_layers
    want_prefill = expected_launches(path["prefill"], L)
    want_step = expected_launches(path["step"], L)
    check(per_prefill == want_prefill,
          f"prefill launched {per_prefill}, want {want_prefill}")
    check(all(p == want_step for p in per_step),
          f"decode steps launched {per_step}, want {want_step} each")
    check(gen.shape == (SERVE_BATCH, SERVE_TOKENS)
          and bool(((gen >= 0) & (gen < cfg.vocab_padded)).all()),
          "generated tokens out of [0, vocab_padded)")
    check(all(bool(torch.isfinite(x).all()) for x in logits),
          "non-finite logits")

    # decode-vs-forward: step t's logits against one forward over the
    # prompt and the tokens generated so far, at the same position
    seq = torch.tensor(np.concatenate([prompts, gen[:, :-1]], axis=1),
                       dtype=torch.int64, device="cuda")
    full, _ = M.forward(srv.params, {"tokens": seq}, cfg)
    rel = torch.stack([rel_l2(logits[t], full[:, SERVE_PROMPT - 1 + t])
                       for t in range(SERVE_TOKENS)])
    abs_err = max(max_abs(logits[t], full[:, SERVE_PROMPT - 1 + t].float())
                  for t in range(SERVE_TOKENS))
    agree = float(torch.stack([
        (logits[t].argmax(-1) == full[:, SERVE_PROMPT - 1 + t].argmax(-1))
        .float().mean() for t in range(SERVE_TOKENS)]).mean())
    scale = float(full[:, SERVE_PROMPT - 1:].float().abs().max())
    del full
    check(float(rel.max()) <= path["rel_l2_bf16"],
          f"decode vs forward (bf16): relative L2 {float(rel.max())} > "
          f"{path['rel_l2_bf16']}")
    f32 = decode_vs_forward_f32(cfg, prompts)
    check(f32["max_rel_l2"] <= SERVE_REL_L2_TOL_F32,
          f"decode vs forward (float32): relative L2 {f32['max_rel_l2']} > "
          f"{SERVE_REL_L2_TOL_F32}")
    srv.prefill, srv.decode = plain_steps
    decode_s = sum(step_s)
    rec = {"card": card, "arch": arch, "layers": L,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
           "tokens": SERVE_TOKENS, "init_s": t_init,
           "prefill_s": t_prefill,
           "decode_ms_per_step": 1e3 * decode_s / len(step_s),
           "decode_ms_per_step_min": 1e3 * min(step_s),
           "decode_tokens_per_s": SERVE_BATCH * len(step_s) / decode_s,
           "prompt_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / t_prefill,
           "end_to_end_tokens_per_s":
               SERVE_BATCH * SERVE_TOKENS / (t_prefill + decode_s),
           "peak_memory_bytes": peak, "launches": launches,
           "launches_per_prefill": per_prefill,
           "launches_per_step": per_step[0],
           "decode_vs_forward": {
               "max_rel_l2": float(rel.max()),
               "mean_rel_l2": float(rel.mean()),
               "rel_l2_per_step": [float(r) for r in rel.max(dim=-1).values],
               "max_abs_err": abs_err, "max_abs_logit": scale,
               "argmax_agreement": agree, "tolerance_rel_l2":
                   path["rel_l2_bf16"]},
           "decode_vs_forward_f32": f32}
    return rec, srv, prompts


def decode_vs_forward_f32(cfg, prompts) -> dict:
    """The served model's weights before their bf16 cast (the server's
    seed 0), in float32: prefill, SERVE_TOKENS - 1 decode steps on its own
    argmax tokens, then one forward over the prompt and those tokens;
    every step's logits against the forward's at the same position."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params
    f32 = torch.float32
    params = init_params(registry.param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    B, S = prompts.shape
    toks = torch.tensor(prompts, dtype=torch.int64, device="cuda")
    cache = M.init_cache(cfg, B, S + SERVE_TOKENS, f32, device="cuda")
    last, cache = M.prefill_step(params, {"tokens": toks}, cfg, dtype=f32,
                                 cache=cache)
    steps = [last[:, -1]]
    for t in range(SERVE_TOKENS - 1):
        lg, cache = M.decode_step(params, cache, {
            "tokens": steps[-1].argmax(-1)[:, None], "cache_len": S + t},
            cfg, dtype=f32)
        steps.append(lg[:, -1])
    seq = torch.cat([toks, torch.stack([x.argmax(-1) for x in steps[:-1]],
                                       dim=1)], dim=1)
    del cache
    full, _ = M.forward(params, {"tokens": seq}, cfg, dtype=f32)
    rel = torch.stack([rel_l2(steps[t], full[:, S - 1 + t])
                       for t in range(SERVE_TOKENS)])
    return {"max_rel_l2": float(rel.max()), "mean_rel_l2": float(rel.mean()),
            "rel_l2_per_step": [float(r) for r in rel.max(dim=-1).values],
            "tolerance_rel_l2": SERVE_REL_L2_TOL_F32}


def model_shape_kernels(srv, prompts) -> dict:
    """B3 and B4 on the inputs one layer of the full model gives them:
    layer 0's q, k, v over the prompt, and its cache after the run."""
    import torch
    from repro_torch.models import blocks
    from repro_torch.models.common import rms_norm
    from repro_torch.models.model import _layer
    cfg = srv.cfg
    p0 = _layer(srv.params["layers"], 0)["attn"]
    toks = torch.tensor(prompts, dtype=torch.int64, device="cuda")
    h = rms_norm(srv.params["embed"][toks], p0["ln"], cfg.norm_eps)
    q, k, v = blocks._qkv(p0, h, cfg,
                          torch.arange(prompts.shape[1], device="cuda"))
    b3 = time_b3(q, k, v)
    del q, k, v, h
    clen = srv.cache_len - 1  # the last step's new token
    last = torch.tensor(prompts[:, :1], dtype=torch.int64, device="cuda")
    hq = rms_norm(srv.params["embed"][last], p0["ln"], cfg.norm_eps)
    qd, _, _ = blocks._qkv(p0, hq, cfg,
                           torch.full((1,), clen, device="cuda"))
    kc, vc = (c[0] for c in srv.cache["layers"])
    b4 = time_b4(qd, kc, vc, clen)
    return {"flash_attention": b3, "decode_attention": b4}


def profile_serve(srv, prompts, hand: tuple[str, ...]) -> dict:
    """One prefill and four decode steps under the profiler, each its
    own window: busy share, top device ops, launches; ``hand`` names the
    hand kernels of the path."""
    import torch
    state = {}

    def prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["tok"] = srv.prefill_prompts(prompts)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def decode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            state["tok"] = srv.step(state["tok"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return {"arch": srv.cfg.name,
            "prefill": profile_run(prefill, hand, top=10),
            "decode_4_steps": profile_run(decode, hand, top=10)}


def serve_parity(arch: str) -> dict:
    """``arch`` at full width cut to 2 layers, float32, the same weights
    and tokens on the card (the hand kernels) and on the CPU (their plain
    forms): prefill of a ragged 200-token prompt and 4 decode steps,
    teacher-forced with the CPU's tokens. For mamba2 the CPU runs the
    prompt as one chunk of 200 (the JAX package's rule) and B5 as chunks
    of 64 with a ragged last one: the check also shows that the result
    does not depend on the chunk."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    path = SERVE_PATHS[arch]
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    params = init_params(registry.param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    on = {"cuda": params, "cpu": tree_map(lambda t: t.cpu(), params)}
    B, S0, n = 2, 200, 4
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S0))
    prefill = make_prefill_step(cfg, dtype=torch.float32)
    decode = make_serve_step(cfg, dtype=torch.float32)

    def run(device, feed):
        cache = M.init_cache(cfg, B, S0 + n + 1, torch.float32,
                             device=device)
        logits, cache = prefill(on[device], {"tokens": torch.tensor(
            prompts, device=device)}, cache=cache)
        out = [logits[:, -1].float().cpu()]
        for t in range(n):
            tok = feed[t] if feed is not None else out[-1].argmax(-1)
            logits, cache = decode(on[device], cache, {
                "tokens": tok[:, None].to(device), "cache_len": S0 + t})
            out.append(logits[:, -1].float().cpu())
        return out

    t0 = time.perf_counter()
    want = run("cpu", None)
    t_cpu = time.perf_counter() - t0
    feed = [w.argmax(-1) for w in want]
    reset_launches()
    got = run("cuda", feed)
    launches = read_launches()
    want_launches = expected_launches(path["prefill"], cfg.n_layers)
    if path["step"] is not None:
        want_launches[path["step"]] = cfg.n_layers * n
    check(launches == want_launches,
          f"serve_parity launches {launches}, want {want_launches}")
    err = max(max_abs(g, w) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    rel = max(float(rel_l2(g, w).max()) for g, w in zip(got, want))
    clear = same = 0
    for g, w in zip(got, want):
        top2 = w.topk(2, dim=-1).values
        ok = (top2[:, 0] - top2[:, 1]) > 2 * PARITY_ATOL
        clear += int(ok.sum())
        same += int((g.argmax(-1) == w.argmax(-1))[ok].sum())
    check(err <= PARITY_ATOL, f"serve_parity: card vs CPU logits differ by "
                              f"{err} > {PARITY_ATOL}")
    check(same == clear, f"serve_parity: {clear - same} clear tokens differ")
    return {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": "float32", "batch": B,
            "prompt": S0, "decode_steps": n, "launches": launches,
            "max_abs_err": err, "max_rel_l2": rel, "max_abs_logit": scale,
            "tolerance_abs": PARITY_ATOL, "tokens_clear": clear,
            "tokens_equal": same, "wall_s_cpu": t_cpu}


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
    # float32 products in full float32 (the parity phase compares with
    # the CPU); these are PyTorch's defaults for matmul, stated here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device ------------------------------------------------------
    card = smi_line()
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    for name in _build.LIBRARIES:  # the first load builds them all at once
        _build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds={k: v.get("seconds")
                       for k, v in _build.BUILD_INFO.items()},
         libraries=[str(_build.library_path(k)) for k in _build.LIBRARIES],
         ptxas=[ln for v in _build.BUILD_INFO.values()
                for ln in v.get("log", "").splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln])

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
        # rows longer than one staging window: segment 0 alone spans
        # several, so its running sum is carried across them
        "long_rows": (torch.tensor(np.repeat(np.arange(3), K2_LONG_ROW),
                                   device=dev), 3),
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
    k1_device_us = kernel_device_us(lambda: sa_occupancy(*mm, saw_main),
                                    "sa_occupancy_kernel")
    # the launch floor: the device time of the smallest kernel PyTorch
    # launches, a one-element add, beside K1's
    one = torch.ones(1, device=dev)
    one_out = torch.empty_like(one)
    launch_floor_us = kernel_device_us(
        lambda: torch.add(one, 1.0, out=one_out))

    k2_shapes = time_k2(k2_timing_shapes(bk, host, st.n_segments, n_pairs,
                                         k1_shape["S"]), rng)
    attn = check_attention_kernels(dev)
    ssd = check_ssd_kernel(dev)
    b2 = check_gated_matmul_kernel(dev)
    emit("kernels", card=card, k1_cases=k1_cases, k2_cases=k2_cases,
         b3_b4=attn, b5=ssd, b2=b2,
         k1={"shape": k1_shape, "kernel_ms": k1_ms, "plain_ms": k1_plain_ms,
             "bound_ms": k1_bound, "max_abs_err": k1_err,
             "device_us": k1_device_us,
             "launch_floor_device_us": launch_floor_us},
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

    emit("profile", **profile_run(lambda: run_full()[1],
                                  ("sa_occupancy_kernel",
                                   "segment_sum_kernel")))

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

    # ---- 5b. evaluate_all: the policy engine's batched entry -------------
    emit("evaluate_all", **evaluate_all_phase(card, suite))

    # ---- 5c. the program plane: B7 with the policy side ------------------
    emit("program_plane_records", **program_plane_records(card, suite))
    ppf = program_plane_full(card, suite)
    emit("program_plane_full", **ppf)

    # ---- 5d. gated_matmul_full: kernel B2 at qwen2.5-3b's width ----------
    gm = gated_matmul_full(card)
    emit("gated_matmul_full", **gm)
    torch.cuda.empty_cache()

    # ---- 6. serve_full: the serving path at full width ------------------
    serve_rec, srv, prompts = serve_full(card, SERVE_ARCH)
    emit("serve_full", **serve_rec)
    shapes = model_shape_kernels(srv, prompts)
    emit("kernels_model_shapes", card=card, arch=SERVE_ARCH, **shapes)
    emit("profile_serve", **profile_serve(
        srv, prompts, (*B3_KERNELS.values(), *B4_KERNELS)))
    del srv
    torch.cuda.empty_cache()

    # ---- 7. serve_parity: card vs CPU, full width, 2 layers, float32 ----
    emit("serve_parity", **serve_parity(SERVE_ARCH))

    # ---- 8. serve_ssm_full: mamba2-780m at full width -------------------
    ssm_rec, srv, prompts = serve_full(card, SSM_ARCH)
    emit("serve_ssm_full", **ssm_rec)
    b5 = ssd_model_shapes(srv, prompts)
    emit("kernels_model_shapes", card=card, arch=SSM_ARCH, ssd_scan=b5)
    emit("profile_serve", **profile_serve(srv, prompts,
                                          B5_KERNELS["bfloat16"]))
    del srv
    torch.cuda.empty_cache()

    # ---- 9. serve_ssm_parity: card vs CPU, full width, 2 layers ----------
    emit("serve_ssm_parity", **serve_parity(SSM_ARCH))

    # ---- the kernels line, the card, the verdict ------------------------
    main_k2 = k2_shapes[0]
    kernels = [
        {"name": "sa_occupancy", "route": "cuda", "source": K1_SOURCE,
         "replaces": "src/repro/kernels/sa_occupancy.py:83",
         "launches": launches["sa_occupancy"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S
         >= k1_ops / FP64_FLOPS_PER_S else "operations",
         "library_ms": None, "shape": k1_shape, "device_us": k1_device_us,
         "launch_floor_device_us": launch_floor_us,
         "tolerance": "torch.equal with the plain version on the card"},
        {"name": "segment_sum", "route": "cuda", "source": K1_SOURCE,
         "replaces": "src/repro/core/backend.py:203",
         "launches": launches["segment_sum"],
         "max_abs_err": k2_err_card, "ms": main_k2["ms"],
         "device_us": main_k2["device_us"],
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
    for name, key, replaces in (
            ("flash_attention", "b3",
             "src/repro/kernels/flash_attention.py:83"),
            ("decode_attention", "b4",
             "src/repro/kernels/decode_attention.py:74")):
        t = shapes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE,
            "replaces": replaces,
            "launches": serve_rec["launches"][name],
            "max_abs_err": max(t["max_abs_err"],
                               attn["max_abs_err"][key]["bfloat16"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_us": t["device_us"],
            "shape": t["shape"],
            "max_abs_err_float32": attn["max_abs_err"][key]["float32"],
            "tolerance": "allclose with the plain version on the card: "
                         "atol = rtol = 2e-2 (bf16), 2e-5 (float32)"
                         + ("; bit-identical on a second call"
                            if name == "decode_attention" else "")})
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
        "replaces": "src/repro/kernels/ssd_scan.py:79",
        "launches": ssm_rec["launches"]["ssd_scan"],
        "max_abs_err": b5["max_abs_err"], "ms": b5["ms"],
        "plain_ms": b5["plain_ms"], "bound_ms": b5["bound_ms"],
        "bound_by": b5["bound_by"], "library_ms": None,
        "library_note": b5["library_note"], "device_us": b5["device_us"],
        "shape": b5["shape"], "scaled_err_cases": ssd["scaled_err"],
        "rel_l2": b5["rel_l2"], "control_rel_l2": b5["control_rel_l2"],
        "occupancy": b5["occupancy"],
        "tolerance": "max |kernel - plain| / max |plain| <= 2e-3 (bf16 "
                     "inputs), 1e-4 (float32), y and state each; the "
                     "strong-decay cases against ref_ssd; bf16 at the "
                     f"model's inputs relative L2 <= {B5_REL_L2_BF16}, y "
                     "and state each"})
    d = gm["cases"]["dense"]
    kernels.append({
        "name": "gated_matmul", "route": "cuda", "source": GM_SOURCE,
        "replaces": "src/repro/kernels/gated_matmul.py:58",
        "launches": gm["launches"]["gated_matmul"],
        "max_abs_err": max(d["max_abs_err"], b2["max_abs_err"]["bfloat16"]),
        "ms": d["ms"], "device_us": d["device_us"],
        "plain_ms": d["plain_ms"], "library_ms": d["library_ms"],
        "library_note": "torch.matmul on the same operands (skips nothing)",
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "shape": {"x": gm["shape"]["x"], "w": gm["shape"]["w"],
                  "dtype": "torch.bfloat16", "pattern": "dense"},
        "tiles_run": d["tiles_run"],
        "max_abs_err_float32": max(
            gm["cases"]["dense_float32"]["max_abs_err"],
            b2["max_abs_err"]["float32"]),
        "tolerance": "allclose with the plain version on the card: atol = "
                     "tol * max|plain| + 1e-5, rtol = tol, tol 2e-2 (bf16), "
                     "1e-4 (float32); tiles_run exact"})
    kernels.append({
        "name": "program_exec", "route": "cuda", "source": PP_SOURCE,
        "replaces": "src/repro/core/backend.py:218",
        "launches": ppf["launches"]["program_exec"],
        "max_abs_err": ppf["max_abs_err"], "ms": ppf["kernel_ms"],
        "device_us": ppf["kernel_device_us"],
        "plain_ms": ppf["plain_ms_card"],
        "plain_ms_cpu": ppf["plain_ms_cpu"], "bound_ms": ppf["bound_ms"],
        "bound_by": ppf["bound_by"], "bytes_bound_ms": ppf["bytes_bound_ms"],
        "bytes_bound_ms_row_copies": ppf["bytes_bound_ms_row_copies"],
        "chain_bound_ms": ppf["chain_bound_ms"], "library_ms": None,
        "library_note": "none exists: no PyTorch call runs the event "
                        "executor",
        "shape": {k: ppf[k] for k in ("E", "rows", "U", "streams",
                                      "real_events", "stream_events")},
        "ns_per_step": ppf["ns_per_step"],
        "tolerance": ppf["tolerance"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
