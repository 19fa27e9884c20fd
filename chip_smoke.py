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
* the fleet plane, ``repro_torch.core.fleet.sweep_fleet`` → one
  ``policies.evaluate_batch`` a 900 s epoch (K1 once and K2 the same count
  in each of the 97 calls), at ``benchmarks/perf_fleet.py``'s day, none
  of it cut: 4 tenant classes on 4 096 NPU-D chips, 96 epochs, 3 policies
  × 24 knobs, over a million requests — bit-identical on a rerun, its
  first 8 epochs against the CPU and its calibration call against the
  numpy batched engine within 1e-9; the chaos campaign ``sweep_chaos``
  over a severity-1 fault timeline; the guard plane (a guarded day with
  zero events, then a card rung that raises once, one that sleeps past
  its deadline, one whose library does not load and one that returns a
  NaN, each with exactly its events; the card's ladder has no rung
  below it, so the second and third raise ``GuardError``), and a
  checkpointed campaign in a child process killed at an epoch boundary
  and mid-epoch, resumed bit for bit. These run last, after every
  profiled phase;
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
  batch, prompt and checks;
* serving hymba-1.5b at full width (32 hybrid layers: attention beside
  an SSD branch, 29 of them sliding over a 2 048-token window; B3 with
  the window and B5 on every layer of the prefill, B4 with the window at
  every step) over a 4 096-token prompt, and paligemma-3b (18 layers,
  head dim 256; B3 with a 256-patch bidirectional prefix, B4 at every
  step) behind its 256 zero patch embeddings; hubert-xlarge's encoder
  forward (48 layers, head dim 80, bidirectional B3) over 4 x 1 500
  seeded frames; each, cut to 2 layers (hymba 4) in float32, against
  the CPU. B3 and B4 are also held to their plain versions with every
  new mask and head dim, B3's loaded tiles to the mask's count;
* serving granite-moe-1b-a400m at full width (24 layers of GQA attention
  and 32 routed experts top-8; B3 at prefill, B4 at every step) and
  deepseek-v2-236b at every published width cut to 3 layers (its leading
  dense layer and 2 MoE layers of 160 routed and 2 shared experts, top-6,
  multi-head latent attention: B3 at q/k head dim 192 and v 128 at
  prefill, the absorbed decode plain), the same batch, prompt and checks
  (decode vs forward and card vs CPU over the tokens routed alike by
  both runs; deepseek's parity with 16 routed experts); B3 at (192, 128)
  held to its plain version on its own (``kernels.b3_mla``);
* training the MoE families at full width through the port's training
  path (bf16 on float32 masters, remat "full", 2 x 2 048 tokens in 2
  microbatches, 4 steps): granite-moe-1b-a400m, all 24 layers, through
  ``launch.train.run`` (exactly 96 B3 and 48 B9 a step), and
  deepseek-v2-236b at every published width cut to 3 layers and 16
  routed experts to fit one card, through the pieces ``run`` uses (12 B3
  and 6 B9 a step: multi-head latent attention's backward, B9 at q/k 192
  and v 128, held to its plain version in ``kernels.b9_mla``); each
  beside its card-vs-CPU parity in float32 with the same routing on both
  sides, two backward passes of a granite microbatch bit for bit, a
  profiled deepseek step, and a bit-exact resume on reduced granite;
* training granite-moe-1b-a400m on meshes through ``launch.train.run``
  under its default MoE dispatch, GSPMD's (the whole group's capacity
  and drops, as on one device): a one-rank ``(1, 1)`` mesh whose losses
  and launches equal the unsharded run's bit for bit, then a ``(2, 1)``
  data mesh of 2 ranks on this card (gloo; ``chip_smoke.py
  --moe-mesh-rank``, 2 x 2 048 tokens in one microbatch) whose first
  step routes every token alike with the unsharded run of that path and
  whose losses stay close to it, each rank launching B3 and B9; the same
  mesh under the shard-mapped dispatch, whose per-shard capacity routes
  otherwise, beside it;
* arrival-driven serving, ``repro_torch.launch.serve.serve_arrivals``:
  qwen2.5-3b at full width behind a seeded Poisson trace (20 s in 5 s
  epochs, batch 4), and a child process on the card sent SIGTERM
  mid-trace, which must drain the wave in flight and write its report;
* training on a mesh (``launch.train.run`` with ``mesh="1x1"``: the
  state DTensors on a one-card ``DeviceMesh`` under the baseline rules)
  at train_full's settings, 3 steps whose losses equal train_full's bit
  for bit, exactly 144 B3 and 72 B9 a step; one more step counted by
  ``core.costs.CostCounter`` with the kernels launched, against the dry
  run of the same cell under fake tensors (``launch.dryrun``, in a child
  process that sees no card): the same FLOPs, its memory prediction
  within 25 % of the measured peak, its roofline beside the step's
  measured busy time; and the production dry run of deepseek-v2-236b at
  all 60 layers on the (16, 16) fake mesh (the same child, started after
  the build on a core this process gives up while it runs, so that it
  overlaps the card's phases and takes no core from them), whose per-device
  argument bytes must be the local shards the resolved specs give;
* the power plane across ranks (after the guard phases): sweep_full's
  cube on a one-rank ``(1, 1)`` mesh of an NCCL world in this process,
  bit for bit; then ONE 2-rank world on this card (gloo over CUDA
  tensors: NCCL refuses two ranks on one GPU), spawned once as two
  child processes (``chip_smoke.py --mesh-rank``), runs through the
  entry points a user calls ``sweep_grid`` on sweep_full's cube over a
  ``(1, 2)`` knob mesh (bit for bit sweep_full's) and a ``(2,)`` wl mesh
  (≤1e-9: the op-axis sums are reduced across ranks),
  ``sweep_program_plane`` on program_plane_full's 1 530 rows split over
  the wl mesh (every executor integer equal), and ``sweep_fleet`` on
  fleet_parity's 8 epochs over the knob mesh, plain and guarded (≤1e-9,
  zero guard events); each rank launches K1, K2 and, on the program
  plane, B7 once. Two ranks on one card show correctness and the
  collectives' cost, not a speedup.

It has no CPU route: no card, a failed build, a failed launch or a
failed comparison each end the run with a non-zero exit code. Every
phase prints one JSON line; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}
"""
from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
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
# B9's kernels per input type, as the profiler names them; a call
# launches all four of its type once: the rowsum pre-pass, dK/dV per
# query head, the group's sum, dQ (bf16 on the tensor cores, float32 on
# the CUDA cores)
B9_KERNELS = {"bfloat16": ("attention_bwd_delta_kernel",
                           "attention_bwd_dkdv_bf16_kernel",
                           "attention_bwd_reduce_kernel",
                           "attention_bwd_dq_bf16_kernel"),
              "float32": ("attention_bwd_delta_kernel",
                          "attention_bwd_dkdv_kernel",
                          "attention_bwd_reduce_kernel",
                          "attention_bwd_dq_kernel")}
# B9 float32 vs its plain version (float32 on the CPU, the same inputs):
# |kernel - plain| <= tol (max(max|plain|, 1) + |plain|); the inputs are
# of size ~1, and dq, dk of a one-token sequence are exactly 0
B9_TOL_F32 = 1e-4
# B9 bf16 vs its plain version (float32 throughout on the same bf16
# inputs, rounded to bf16 once), as one relative L2 over each of dq, dk,
# dv. The kernel multiplies on the tensor cores: P and dS are rounded to
# bf16 in registers as the operands of P^T dO, dS^T Q and dS K (as B3
# rounds P for P V), every sum is float32. On the H100 at the training
# shape the kernel reads 3.21e-3 / 3.16e-3 / 2.55e-3 (dq / dk / dv), as
# does the plain version with P and dS rounded to bf16 (7 mantissa bits):
# 3.21e-3 / 3.16e-3 / 2.54e-3. The limit is 2.5 times that; the control,
# P and dS rounded to 3 bits (a deliberately wrong rounding), reads
# 3.78e-2 / 3.77e-2 / 2.66e-2 and must land above it (PERF.md).
B9_REL_L2_BF16 = 8e-3
B9_CONTROL_BITS = 3
B9_SOURCE = "src/repro_torch/kernels/csrc/attention_bwd.cu"
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
HYBRID_ARCH = "hymba-1.5b"
VLM_ARCH = "paligemma-3b"
AUDIO_ARCH = "hubert-xlarge"
MOE_ARCH = "granite-moe-1b-a400m"
MLA_ARCH = "deepseek-v2-236b"
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 2048, 32
# per served arch: the published widths (layers, d_model, vocab), the
# kernels each layer launches at prefill and at every decode step, the
# limit on the bf16 decode-vs-forward relative L2 (below), the text
# prompt's length (hymba's is twice its 2 048-token window, so its 29
# sliding layers skip key tiles; paligemma's follows its 256 patches) and
# the layers its card-vs-CPU parity phase keeps (hymba cut to 2 layers
# would have only global ones: at 4, layer 1 slides between the global
# 0, 2 and 3 -- cut from 5 in PR 31, where the run passed its time)
SERVE_PATHS = {
    SERVE_ARCH: {"widths": (36, 2048, 151936), "prefill": "flash_attention",
                 "step": "decode_attention", "rel_l2_bf16": 0.05,
                 "prompt": SERVE_PROMPT, "parity_layers": 2,
                 "parity_prompt": 200},
    SSM_ARCH: {"widths": (48, 1536, 50280), "prefill": "ssd_scan",
               "step": None, "rel_l2_bf16": 0.25, "prompt": SERVE_PROMPT,
               "parity_layers": 2, "parity_prompt": 200},
    # the SSD half carries its state's bf16 rounding as mamba2's does;
    # its parity prompt is longer than the window, so layers 1 and 3
    # slide there too
    HYBRID_ARCH: {"widths": (32, 1600, 32001),
                  "prefill": ("flash_attention", "ssd_scan"),
                  "step": "decode_attention", "rel_l2_bf16": 0.25,
                  "prompt": 4096, "parity_layers": 4,
                  "parity_prompt": 2112},
    VLM_ARCH: {"widths": (18, 2048, 257216), "prefill": "flash_attention",
               "step": "decode_attention", "rel_l2_bf16": 0.05,
               "prompt": SERVE_PROMPT, "parity_layers": 2,
               "parity_prompt": 200},
    AUDIO_ARCH: {"widths": (48, 1280, 504), "prefill": "flash_attention",
                 "step": None, "parity_layers": 2},
    MOE_ARCH: {"widths": (24, 1024, 49155), "prefill": "flash_attention",
               "step": "decode_attention", "rel_l2_bf16": 0.05,
               "prompt": SERVE_PROMPT, "parity_layers": 2,
               "parity_prompt": 200},
    # 236 B parameters do not fit one card: the published widths, cut to
    # 3 layers (the leading dense layer and 2 MoE layers of 160 routed
    # experts), 9.3 B parameters; its decode step launches no hand kernel
    # (the absorbed MLA decode is plain). Its parity phase also cuts the
    # routed experts to 16 (top-6 and the 2 shared kept): 160 at full
    # width are 21 GB of float32 on the host
    MLA_ARCH: {"widths": (3, 5120, 102400), "layers": 3,
               "prefill": "flash_attention", "step": None,
               "rel_l2_bf16": 0.05, "prompt": SERVE_PROMPT,
               "parity_layers": 2, "parity_prompt": 200,
               "parity_moe": {"n_experts": 16}},
}
# MoE routing: two runs of one model can route a token to other experts
# where its K-th and (K+1)-th router probabilities lie within their
# rounding. The parity and decode-vs-forward checks compare the tokens
# whose routing (experts, in slot order, and the capacity drops) is the
# same in both runs, in every layer, at the token's position and -- in
# float32 -- at every earlier position of its row; in float32 a routing
# difference where the reference's top K + 1 probabilities are more than
# this far apart fails the phase
ROUTE_MARGIN_F32 = 1e-5
# encode_audio_full: hubert-xlarge over 30 s of audio at 50 frames a
# second, batch 4; the bf16 control of B3 at its inputs (time_b3)
AUDIO_FRAMES = 1500
AUDIO_CONTROL_BITS = 1
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
    """One phase's JSON line, with ``t_s``: seconds since the script
    started (the run's budget)."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - T_START}), flush=True)


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
# is taken again, this many times in all, each with twice the calls;
# then the calls are timed by CUDA events instead (the guide's fallback),
# and the miss is recorded in PROFILER_FALLBACKS, which the kernels line
# carries
PROFILE_ATTEMPTS = 4
PROFILER_FALLBACKS: list = []


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
    calls = reps
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        if names is None:
            us = [_device_us(e) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
            if sum(us) > 0:
                return sum(us) / calls
            missing = ["any device"]
        else:
            wanted = (names,) if isinstance(names, str) else tuple(names)
            hits = {name: [(_device_us(e), int(e.count))
                           for e in prof.key_averages() if name in e.key]
                    for name in wanted}
            missing = [name for name, rec in hits.items() if not rec]
            if not missing:
                return sum(sum(us for us, _ in rec) / sum(n for _, n in rec)
                           for rec in hits.values())
        calls *= 2
        time.sleep(0.2)
    us = 1e3 * event_ms(fn, reps)
    PROFILER_FALLBACKS.append({"kernels": missing, "calls_profiled": calls,
                               "event_us": us})
    return us


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


def b3_bound(B, S, H, Hkv, D, dtype, live=None, Dv=None,
             Sk=None) -> tuple[float, str]:
    """Least time for attention of S queries over ``Sk`` keys (S by
    default: self-attention): q, k, v read and the output written once;
    the live score entries per (batch, head) -- ``live``, or the causal
    S(S+1)/2 -- at 2 D operations each for QK and 2 Dv for PV (``Dv``,
    v's head dim, defaults to D)."""
    import torch
    Dv = D if Dv is None else Dv
    Sk = S if Sk is None else Sk
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = el * (B * S * H * (D + Dv) + B * Sk * Hkv * (D + Dv))
    live = S * (S + 1) / 2 if live is None else live
    flops = 2 * B * H * (D + Dv) * live
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


def b4_rel_l2_gate(q, kc, vc, cache_len: int, got, what: str,
                   window=None) -> dict:
    """B4 bf16's whole-output relative L2 to its plain version, held to
    ``B4_REL_L2_BF16``, beside its control: the plain version over every
    split but the last (with a window, the window shortened as much, so
    it still starts at the same slot), which must exceed the limit."""
    from repro_torch.kernels.decode_attention import (decode_attention_plain,
                                                      decode_splits,
                                                      live_slots)
    n_live, n_pre, first = live_slots(cache_len, window)
    n_split, split_len = decode_splits(n_live, first, n_pre)
    check(n_split > 1, f"{what}: one split has no last split to drop")
    want = decode_attention_plain(q, kc, vc, cache_len, window=window)
    cut = n_live - (n_split - 1) * split_len  # the last split's slots
    gate = {"rel_l2": b3_rel_l2(got, want),
            "median_abs_plain": float(want.float().abs().median()),
            "control_rel_l2": {"last_split_dropped": b3_rel_l2(
                decode_attention_plain(
                    q, kc, vc, cache_len - cut,
                    window=None if window is None else window - cut),
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


# B3 / B4 with the masks and head dims the hymba, paligemma and hubert
# paths give them: (name, B, S, H, Hkv, D, causal, window, prefix)
B3_MASK_CASES = (
    ("window_2048_s4096_d64", 1, 4096, 25, 5, 64, True, 2048, 0),
    ("window_below_a_tile", 1, 700, 8, 2, 64, True, 40, 0),
    ("window_not_a_multiple_of_64", 1, 700, 8, 2, 64, True, 100, 0),
    ("prefix_256_s2304_d256", 1, 2304, 8, 1, 256, True, None, 256),
    ("prefix_not_a_multiple_of_64", 1, 600, 8, 1, 256, True, None, 70),
    ("bidirectional_s1500_d80", 1, 1500, 16, 16, 80, False, None, 0),
    ("window_and_prefix", 1, 1000, 8, 2, 64, True, 300, 130))
# B4 with a window at cache lengths below, at and above it (the live
# slots fewer than, as many as and cut by the window), D 256, G 8
B4_WINDOW = 1000
B4_WINDOW_LENGTHS = (500, B4_WINDOW - 1, B4_WINDOW, 2335)
# B3 and B9 at a query offset (query row i at position q_offset + i, as a
# chunk of a prefill behind earlier keys): (name, B, Sq, Sk, H, Hkv, D,
# mask) at offsets 0, 1, 64 and 1 000 under causal order, a window, a
# prefix and both, and bidirectional
OFFSET_CASES = (
    ("offset_0_causal", 2, 300, 300, 4, 2, 64, dict(q_offset=0)),
    ("offset_1_prefix_d256", 1, 299, 300, 8, 1, 256,
     dict(q_offset=1, prefix_len=70)),
    ("offset_64_window", 2, 236, 300, 4, 2, 64,
     dict(q_offset=64, window=100)),
    ("offset_64_bidirectional_d80", 1, 200, 300, 4, 2, 80,
     dict(q_offset=64, causal=False)),
    ("offset_1000_causal", 1, 100, 1100, 4, 2, 128, dict(q_offset=1000)),
    ("offset_1000_window_prefix", 1, 100, 1101, 4, 1, 128,
     dict(q_offset=1000, window=300, prefix_len=64)))
# chunked prefill at qwen2.5-3b's widths: the second 1 024 tokens of a
# 2 048-token prompt against the whole prompt's K / V, (B, Sq, Sk, H, Hkv,
# D, q_offset); B3 is timed at the serving batch beside sdpa under the
# same boolean mask, B9 at batch 1 (its plain version runs on the host)
CHUNKED_PREFILL = (SERVE_BATCH, 1024, 2048, 16, 2, 128, 1024)


def check_attention_masks(dev) -> dict:
    """B3 with a sliding window, a prefix, both, and bidirectional at
    head dims 64, 80 and 256 (``B3_MASK_CASES``), at query offsets
    (``OFFSET_CASES``; the chunked prefill ``CHUNKED_PREFILL`` also timed,
    ``time_b3``), and B4 with a window at
    D 256 and G 8 (``B4_WINDOW_LENGTHS``), against their plain versions on
    the card: float32 allclose 2e-5; bf16 the allclose 2e-2 and one
    relative L2 over the output held to ``B3_REL_L2_BF16`` /
    ``B4_REL_L2_BF16``, each beside its control above the limit; B3's
    ``tiles_loaded`` equal to the mask's count (``live_tiles``), B4 no
    slot outside the live ones read (NaN there) and a second call
    bit-identical."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      decode_splits,
                                                      live_slots)
    from repro_torch.kernels.flash_attention import (TILE, flash_attention,
                                                     flash_attention_plain,
                                                     live_tiles)
    from repro_torch.kernels.ref import decode_live
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def b3_case(q, k, v, mask: dict, what: str) -> dict:
        B, Sq, H, _ = q.shape
        Sk = k.shape[1]
        want_tiles = live_tiles(Sq, Sk, device=dev, **mask)
        tiles = torch.zeros((B, H, -(-Sq // TILE)), dtype=torch.int32,
                            device=dev)
        got = flash_attention(q, k, v, tiles_loaded=tiles, **mask)
        want = flash_attention_plain(q, k, v, **mask)
        torch.cuda.synchronize()
        tol = attn_tolerance(q.dtype)
        e = max_abs(got.float(), want.float())
        check(torch.allclose(got.float(), want.float(), atol=tol,
                             rtol=tol), f"{what}: differs by {e}")
        check(torch.equal(tiles, want_tiles.expand(B, H, -1)),
              f"{what}: loaded tiles {tiles[0, 0].tolist()}, the mask "
              f"allows {want_tiles.tolist()}")
        rec = {"max_abs_err": e, "tiles_loaded": int(tiles[0, 0].sum())}
        if Sq == Sk:
            rec["tiles_causal"] = (-(-Sq // TILE)) * (-(-Sq // TILE) + 1) \
                // 2
        if q.dtype == torch.bfloat16:
            rec["rel_l2"] = b3_rel_l2(got, want)
            rec["control_rel_l2"] = {f"p_{bits}_bits": b3_rel_l2(
                b3_rounded_p(q, k, v, bits, **mask), want)
                for bits in (7, B3_CONTROL_BITS)}
            check(rec["rel_l2"] <= B3_REL_L2_BF16,
                  f"{what}: relative L2 {rec['rel_l2']} > "
                  f"{B3_REL_L2_BF16}")
            ctrl = rec["control_rel_l2"][f"p_{B3_CONTROL_BITS}_bits"]
            check(ctrl > B3_REL_L2_BF16,
                  f"{what}: the control has relative L2 {ctrl} <= "
                  f"{B3_REL_L2_BF16}")
        return rec

    out = {"b3": {}, "b4": {}, "b3_offset": {}}
    for name, B, S, H, Hkv, D, causal, window, prefix in B3_MASK_CASES:
        mask = dict(causal=causal, window=window, prefix_len=prefix)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            q, k, v = (rnd((B, S, h, D), dtype) for h in (H, Hkv, Hkv))
            out["b3"][f"{name}/{dn}"] = b3_case(
                q, k, v, mask, f"flash_attention[{name}, {dn}]")
            del q, k, v
    for name, B, Sq, Sk, H, Hkv, D, mask in OFFSET_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            q = rnd((B, Sq, H, D), dtype)
            k, v = rnd((B, Sk, Hkv, D), dtype), rnd((B, Sk, Hkv, D), dtype)
            out["b3_offset"][f"{name}/{dn}"] = b3_case(
                q, k, v, mask, f"flash_attention[{name}, {dn}]")
            del q, k, v
    B, Sq, Sk, H, Hkv, D, off = CHUNKED_PREFILL
    q = rnd((B, Sq, H, D), torch.bfloat16)
    k, v = (rnd((B, Sk, Hkv, D), torch.bfloat16) for _ in range(2))
    out["chunked_prefill"] = time_b3(q, k, v, q_offset=off)
    del q, k, v
    torch.cuda.empty_cache()
    H, Hkv, D, Smax = 8, 1, 256, 2336
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        q = rnd((4, 1, H, D), dtype)
        kc, vc = rnd((4, Smax, Hkv, D), dtype), rnd((4, Smax, Hkv, D), dtype)
        for clen in B4_WINDOW_LENGTHS:
            what = f"decode_attention[window {B4_WINDOW}, len={clen}, {dn}]"
            kw = dict(window=B4_WINDOW)
            want = decode_attention_plain(q, kc, vc, clen, **kw)
            dead = ~decode_live(Smax, clen, device=dev, **kw)
            pk, pv = kc.clone(), vc.clone()
            pk[:, dead], pv[:, dead] = float("nan"), float("nan")
            got = decode_attention(q, pk, pv, clen, **kw)
            again = decode_attention(q, pk, pv, clen, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, again),
                  f"{what}: a second call is not bit-identical")
            check(bool(torch.isfinite(got).all()),
                  f"{what}: read a slot outside the window")
            e = max_abs(got.float(), want.float())
            tol = attn_tolerance(dtype)
            check(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol), f"{what}: differs by {e}")
            n_live, n_pre, first = live_slots(clen, **kw)
            rec = {"max_abs_err": e, "live_slots": n_live,
                   "first_slot": first,
                   "n_split": decode_splits(n_live, first, n_pre)[0]}
            if dtype == torch.bfloat16:
                rec.update(b4_rel_l2_gate(q, kc, vc, clen, got, what, **kw))
            out["b4"][f"len={clen}/{dn}"] = rec
            del pk, pv
    return out


# B3 at multi-head latent attention's head dims (q/k 192 = nope 128 +
# rope 64, v 128 a view of stride 256 into the kv_b product, as mla_fwd
# makes them): (B, S, H), causal; and deepseek-v2's prefill shape
B3_MLA_CASES = ((2, 1, 4, True), (2, 17, 4, True), (1, 130, 8, False),
                (2, 700, 4, True), (1, 2049, 2, True), (1, 300, 4, False))
B3_MLA_SHAPE = (SERVE_BATCH, SERVE_PROMPT, 128)


# the reduced deepseek-v2's MLA head dims (nope 16 + rope 8, v 16), which
# B3 and B9 take with q / k zero-padded to 32 columns: (B, S, H, causal),
# ragged S, causal or not; timed at the serving batch and prompt with the
# reduced config's 4 heads (B3) and at one training sequence (B9)
MLA_REDUCED_DIMS = (16, 8, 16)
MLA_REDUCED_CASES = ((2, 1, 4, True), (2, 300, 4, True), (1, 130, 8, False),
                     (2, 1000, 4, True), (1, 2049, 4, True))
MLA_REDUCED_B3_SHAPE = (SERVE_BATCH, SERVE_PROMPT, 4)
MLA_REDUCED_B9_SHAPE = (1, SERVE_PROMPT, 4, True)


def mla_attention_inputs(gen, B, S, H, dtype, dev, dims=(128, 64, 128)):
    """Random q (B, S, H, nope + rope), k (its last rope columns one
    vector broadcast over the heads) and v (B, S, H, v), a strided view
    into a (nope + v)-wide product, laid out as ``blocks.mla_qkv`` makes
    them; ``dims`` = (nope, rope, v), deepseek-v2's published ones by
    default."""
    import torch
    nope, rope, dv = dims
    q = torch.randn((B, S, H, nope + rope), generator=gen,
                    device=dev).to(dtype)
    kv = torch.randn((B, S, H, nope + dv), generator=gen,
                     device=dev).to(dtype)
    kr = torch.randn((B, S, 1, rope), generator=gen, device=dev).to(dtype)
    k = torch.cat([kv[..., :nope], kr.expand(B, S, H, rope)], dim=-1)
    return q, k, kv[..., nope:]


def check_b3_mla(dev) -> dict:
    """B3 at (D, Dv) = (192, 128) (``B3_MLA_CASES``) and at the reduced
    config's (24, 16) (``MLA_REDUCED_CASES``; q and k padded to 32 columns
    on the way in) against its plain version on the card, float32
    (allclose 2e-5) and bf16 (allclose 2e-2 and relative L2 <=
    ``B3_REL_L2_BF16`` beside its 3-bit control): v read in place through
    its stride (no copy), ``tiles_loaded`` equal to the mask's count, a
    second call bit-identical; then timed at deepseek-v2's prefill and at
    ``MLA_REDUCED_B3_SHAPE`` (``time_b3``: bound, plain, ``sdpa`` and its
    backend)."""
    import torch
    from repro_torch.kernels.flash_attention import (TILE, flash_attention,
                                                     flash_attention_plain,
                                                     for_kernel, live_tiles)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"cases": {}, "reduced_cases": {}}
    cases = [("cases", (128, 64, 128), c) for c in B3_MLA_CASES] + [
        ("reduced_cases", MLA_REDUCED_DIMS, c) for c in MLA_REDUCED_CASES]
    for key, dims, (B, S, H, causal) in cases:
        pair = (dims[0] + dims[1], dims[2])
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            what = f"flash_attention[{pair}, S={S}, causal={causal}, {dn}]"
            q, k, v = mla_attention_inputs(gen, B, S, H, dtype, dev, dims)
            check(for_kernel(v) is v, f"{what}: v was copied")
            tiles = torch.zeros((B, H, -(-S // TILE)), dtype=torch.int32,
                                device=dev)
            got = flash_attention(q, k, v, causal=causal, tiles_loaded=tiles)
            again = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (B, S, H, pair[1])
                  and got.dtype == dtype, f"{what}: shape/dtype")
            check(torch.equal(got, again),
                  f"{what}: a second call is not bit-identical")
            tol = attn_tolerance(dtype)
            e = max_abs(got.float(), want.float())
            check(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol), f"{what}: differs by {e}")
            want_tiles = live_tiles(S, S, causal=causal, device=dev)
            check(torch.equal(tiles, want_tiles.expand(B, H, -1)),
                  f"{what}: loaded tiles {tiles[0, 0].tolist()}, the mask "
                  f"allows {want_tiles.tolist()}")
            rec = {"max_abs_err": e, "tiles_loaded": int(tiles[0, 0].sum())}
            if dtype == torch.bfloat16 and S >= 64:
                rec["rel_l2"] = b3_rel_l2(got, want)
                rec["control_rel_l2"] = {f"p_{bits}_bits": b3_rel_l2(
                    b3_rounded_p(q, k, v, bits, causal=causal), want)
                    for bits in (7, B3_CONTROL_BITS)}
                check(rec["rel_l2"] <= B3_REL_L2_BF16,
                      f"{what}: relative L2 {rec['rel_l2']} > "
                      f"{B3_REL_L2_BF16}")
                ctrl = rec["control_rel_l2"][f"p_{B3_CONTROL_BITS}_bits"]
                check(ctrl > B3_REL_L2_BF16,
                      f"{what}: the control has relative L2 {ctrl} <= "
                      f"{B3_REL_L2_BF16}")
            out[key][f"B={B},S={S},H={H},causal={causal}/{dn}"] = rec
    B, S, H = B3_MLA_SHAPE
    q, k, v = mla_attention_inputs(gen, B, S, H, torch.bfloat16, dev)
    out["model_shape"] = time_b3(q, k, v)
    del q, k, v
    B, S, H = MLA_REDUCED_B3_SHAPE
    q, k, v = mla_attention_inputs(gen, B, S, H, torch.bfloat16, dev,
                                   MLA_REDUCED_DIMS)
    out["reduced_shape"] = time_b3(q, k, v)
    del q, k, v
    torch.cuda.empty_cache()
    return out


def b3_rounded_p(q, k, v, bits: int, causal=True, window=None,
                 prefix_len=0, q_offset=0):
    """B3 (its mask: ``ref.attention_mask``) with the unnormalized
    probabilities ``exp(s - max)`` rounded to nearest at ``bits`` stored
    mantissa bits before P·V, the row sum taken from the unrounded
    float32 values: at 7 bits what the bf16 kernel does, at fewer a
    deliberately wrong rounding."""
    import torch
    from repro_torch.kernels.ref import attention_mask
    H, Hkv, D = q.shape[2], k.shape[2], q.shape[3]
    if Hkv != H:
        k, v = (t.repeat_interleave(H // Hkv, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    s.masked_fill_(~attention_mask(
        s.shape[-2], s.shape[-1], causal=causal, window=window,
        prefix_len=prefix_len, q_offset=q_offset, device=q.device),
        float("-inf"))
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


def time_b3(q, k, v, causal=True, window=None, prefix_len=0,
            control_bits=B3_CONTROL_BITS, q_offset=0) -> dict:
    """B3 at the shapes the main path gives it, with its mask, beside its
    bound (the live pairs alone), its plain version and one library call
    of the same function (``sdpa``: causal by its flag, another mask as
    the same boolean mask; the backend it took named by its kernels).
    bf16 is also held to ``B3_REL_L2_BF16``, beside its control (p at
    ``control_bits`` mantissa bits), which must read above the limit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.ref import attention_mask
    B, S, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    mask = dict(causal=causal, window=window, prefix_len=prefix_len)
    if q_offset:
        mask["q_offset"] = q_offset
    got = flash_attention(q, k, v, **mask)
    want = flash_attention_plain(q, k, v, **mask)
    err = max_abs(got.float(), want.float())
    check(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"flash_attention at the model's shapes differs by {err}")
    accuracy = {"rel_l2": b3_rel_l2(got, want),
                "max_row_rel_l2": float(rel_l2(got, want).max()),
                "median_abs_plain": float(want.float().abs().median())}
    del got
    if q.dtype == torch.bfloat16:
        accuracy["control_rel_l2"] = {
            f"p_{bits}_bits": b3_rel_l2(b3_rounded_p(q, k, v, bits, **mask),
                                        want)
            for bits in sorted({7, B3_CONTROL_BITS, control_bits})}
        accuracy["limit_rel_l2"] = B3_REL_L2_BF16
        check(accuracy["rel_l2"] <= B3_REL_L2_BF16,
              f"flash_attention (bf16) at the model's shapes: relative L2 "
              f"{accuracy['rel_l2']} > {B3_REL_L2_BF16}")
        ctrl = accuracy["control_rel_l2"][f"p_{control_bits}_bits"]
        check(ctrl > B3_REL_L2_BF16,
              f"the control (p at {control_bits} mantissa bits) has "
              f"relative L2 {ctrl} <= {B3_REL_L2_BF16}: the limit cannot "
              f"see a rounding fault")
    del want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ok = attention_mask(S, k.shape[1], device=q.device, **mask)
    live = int(ok.sum())
    # sdpa's is_causal aligns the diagonal at the top left: self-attention
    plain_causal = causal and window is None and prefix_len == 0 \
        and q_offset == 0 and S == k.shape[1]
    sdpa = dict(is_causal=True) if plain_causal else \
        dict(attn_mask=None if bool(ok.all()) else ok)
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True, **sdpa)
    except TypeError:  # a torch without enable_gqa: repeat the KV heads
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (kt, vt))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kr, vr, **sdpa)
    bound, by = b3_bound(B, S, H, Hkv, D, q.dtype, live, Dv=Dv,
                         Sk=k.shape[1])
    run = lambda: flash_attention(q, k, v, **mask)  # noqa: E731
    return {"shape": {"q": list(q.shape), "kv": list(k.shape),
                      **({"v": list(v.shape)} if Dv != D else {}),
                      "dtype": str(q.dtype), **mask},
            "live_pairs": live, "max_abs_err": err, **accuracy,
            "ms": event_ms(run, 10),
            "device_us": kernel_device_us(
                run, B3_KERNELS[str(q.dtype).split(".")[-1]]),
            "plain_ms": event_ms(
                lambda: flash_attention_plain(q, k, v, **mask), 3, warmup=1),
            "library_ms": event_ms(lib, 10),
            "library_device_us": kernel_device_us(lib),
            "library_kernels": device_kernel_names(lib),
            "library_call": "scaled_dot_product_attention("
                            + ("is_causal=True" if plain_causal else
                               "attn_mask=<the same boolean mask>")
                            + ", enable_gqa=True)",
            "bound_ms": bound, "bound_by": by}


def device_kernel_names(fn, top: int = 3, reps: int = 5) -> list:
    """The names of the device kernels ``reps`` calls of ``fn`` run,
    longest first (which backend a library call took); a diagnostic:
    [] if ``PROFILE_ATTEMPTS`` profiles all lost their records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        rows = sorted(((e.key, _device_us(e)) for e in prof.key_averages()
                       if getattr(e, "device_type", None)
                       == DeviceType.CUDA), key=lambda r: -r[1])
        if rows:
            return [n[:100] for n, _ in rows[:top]]
    return []


def time_b4(q, kc, vc, cache_len: int, window=None) -> dict:
    """B4 at the shapes the main path gives it (one layer's cache, its
    window), beside its bound (the live slots alone), its plain version
    and one library call of the same function (``sdpa`` over the live
    slots; by events and by its device time); bf16 is also held to
    ``B4_REL_L2_BF16``, beside its control."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain,
                                                      decode_splits,
                                                      live_slots)
    B, _, H, D = q.shape
    Hkv = kc.shape[2]
    got = decode_attention(q, kc, vc, cache_len, window=window)
    again = decode_attention(q, kc, vc, cache_len, window=window)
    want = decode_attention_plain(q, kc, vc, cache_len, window=window)
    err = max_abs(got.float(), want.float())
    check(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"decode_attention at the model's shapes differs by {err}")
    check(torch.equal(got, again), "decode_attention at the model's "
          "shapes: a second call is not bit-identical")
    accuracy = {} if q.dtype != torch.bfloat16 else b4_rel_l2_gate(
        q, kc, vc, cache_len, got, "decode_attention (bf16) at the "
        "model's shapes", window=window)
    n_live, n_pre, first = live_slots(cache_len, window)
    n_split, split_len = decode_splits(n_live, first, n_pre)
    qt = q.transpose(1, 2)
    kt, vt = (c[:, first:cache_len + 1].transpose(1, 2) for c in (kc, vc))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True)
    except TypeError:
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in (kt, vt))
        lib = lambda: F.scaled_dot_product_attention(qt, kr, vr)  # noqa
    bound, by = b4_bound(B, n_live, H, Hkv, D, q.dtype)
    run = lambda: decode_attention(q, kc, vc, cache_len,  # noqa: E731
                                   window=window)
    return {"shape": {"q": list(q.shape), "cache": list(kc.shape),
                      "cache_len": cache_len, "window": window,
                      "live_slots": n_live, "dtype": str(q.dtype),
                      "n_split": n_split, "split_len": split_len},
            "max_abs_err": err, **accuracy, "bit_identical_rerun": True,
            "ms": event_ms(run, 50),
            "device_us": kernel_device_us(run, B4_KERNELS),
            "plain_ms": event_ms(
                lambda: decode_attention_plain(q, kc, vc, cache_len,
                                               window=window), 10),
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
    """B5 on the inputs layer 0 of the full mamba2 (or hymba: its SSD
    half) model gives it: the prompt's x, dt, A, B, C (B/C per group,
    not repeated)."""
    import torch
    from repro_torch.models import blocks
    from repro_torch.models.common import rms_norm
    from repro_torch.models.model import _layers
    cfg = srv.cfg
    p0 = _layers(srv.params["layers"], cfg.n_layers)[0]
    p0 = p0["mix"]["ssd"] if cfg.family == "hybrid" else p0["ssd"]
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


def program_plane_full(card: str, suite, keep=None) -> dict:
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
    stream entry by CUDA events and by its device time. ``keep``, where
    given, receives the records, the row count and the wall, which the
    mesh phases are held to."""
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
    if keep is not None:
        keep.update(program_plane_full=recs, program_plane_wall_s=wall,
                    program_plane_rows=int(stream_of_row.shape[0]))
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


# ---- the fleet, chaos and guard planes --------------------------------------

# benchmarks/perf_fleet.py's knob grid: 4 window x 3 delay x 2 leak = 24
FLEET_GRID = dict(window_scale=(0.25, 0.5, 1.0, 2.0),
                  delay_scale=(1.0, 2.0, 4.0), leak_off_logic=(None, 0.2))
FLEET_DAY_S = 86400.0
FLEET_MIN_REQUESTS = 1_000_000
# fleet_parity's cut: the first 8 epochs of the day, card against CPU
FLEET_PARITY_S = 8 * 900.0
# the profile window of fleet_full: a few epochs
FLEET_PROFILE_S = 4 * 900.0
# benchmarks/perf_chaos.py's campaign: one faulted severity, no baseline
CHAOS_SEVERITY = 1.0
# benchmarks/perf_guard.py: a deadline far above any epoch's wall
GUARD_TIMEOUT_S = 600.0
# the injected faults: a deadline the wedged rung sleeps well past
GUARD_SHORT_TIMEOUT_S = 0.25
GUARD_WEDGE_S = 1.0
RESUME_CHILD = os.path.join("tests", "_torch_guard_resume_child.py")
RESUME_KILLS = ("boundary:2", "mid:3")
FLEET_RTOL = 1e-9


def fleet_day(duration_s: float = FLEET_DAY_S):
    """The fleet day of ``benchmarks/perf_fleet.py:38-66`` with the
    port's classes: diurnal chat decode and prefill, a bursty 70B tier,
    steady DLRM on 4 096 NPU-D chips, 3 policies, 96 epochs of 900 s,
    severity levels 0 / 0.5 / 1, seed 7 (``duration_s`` cuts the day)."""
    from repro_torch.core.fleet import (ArrivalSpec, FleetScenario,
                                        WorkloadClass)
    from repro_torch.core.opgen import dlrm_workload, llm_workload
    diurnal = dict(rate_rps=10.0, peak_frac=0.9, period_s=86400.0,
                   phase_s=-21600.0)
    classes = (
        WorkloadClass("chat-decode",
                      llm_workload("llama3-8b", "decode", batch=8),
                      ArrivalSpec("diurnal", **diurnal),
                      requests_per_invocation=8),
        WorkloadClass("chat-prefill",
                      llm_workload("llama3-8b", "prefill", batch=1,
                                   seq=4096),
                      ArrivalSpec("diurnal", **diurnal)),
        WorkloadClass("research-70b",
                      llm_workload("llama3-70b", "decode", batch=4,
                                   n_chips=8, tp=8),
                      ArrivalSpec("bursty", rate_rps=1.5, burst_prob=0.15,
                                  burst_factor=8.0),
                      requests_per_invocation=4),
        WorkloadClass("ranking-dlrm", dlrm_workload("M"),
                      ArrivalSpec("poisson", rate_rps=3.0),
                      requests_per_invocation=1024))
    return FleetScenario(
        classes=classes, n_chips=4096, npu="NPU-D",
        policies=("NoPG", "ReGate-HW", "ReGate-Full"),
        duration_s=duration_s, epoch_s=900.0, slo_relax=1.2, seed=7,
        severity_levels=(0.0, 0.5, 1.0))


def tree_rel(ref, got, what: str) -> float:
    """Two reports as plain values (``to_dict()``) under the port's one
    rule (``guard.tree_max_rel``): the same keys and lengths, every
    str / bool / int / None equal, every float within ``FLEET_RTOL``
    relative. Returns the worst relative deviation."""
    from repro_torch.core.guard import GuardError, tree_max_rel
    try:
        return tree_max_rel(ref, got, FLEET_RTOL)
    except GuardError as e:
        fail(f"{what}{e}")


def cube_rel(ref, got, what: str) -> float:
    """Two ``BatchResult`` cubes, field by field (``guard.cube_max_rel``):
    finite, within ``FLEET_RTOL``. Returns the worst relative deviation."""
    from repro_torch.core.guard import GuardError, cube_max_rel
    try:
        return cube_max_rel(ref, got, FLEET_RTOL)
    except GuardError as e:
        fail(f"{what}: {e}")


def cubes_equal(a, b) -> bool:
    import numpy as np
    from repro_torch.core.guard import _result_fields
    return all(np.array_equal(x, y) for (_, x), (_, y)
               in zip(_result_fields(a), _result_fields(b)))


class PerCall:
    """Counts K1 / K2 launches and the wall of every ``evaluate_batch``
    call the fleet plane makes (``fleet._eval``'s), by wrapping the name
    ``repro_torch.core.fleet`` calls; restored on exit."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.core import fleet
        from repro_torch.kernels.sa_occupancy import sa_occupancy
        from repro_torch.kernels.segment_sum import segment_sum
        self._real = real = fleet.evaluate_batch

        def counted(*a, **k):
            k1, k2 = sa_occupancy.launches, segment_sum.launches
            t0 = time.perf_counter()
            res = real(*a, **k)
            self.calls.append((sa_occupancy.launches - k1,
                               segment_sum.launches - k2,
                               time.perf_counter() - t0))
            return res
        fleet.evaluate_batch = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import fleet
        fleet.evaluate_batch = self._real

    def k2_per_call(self, what: str, n_calls: int) -> int:
        """Every call launched K1 once and K2 the same number of times,
        and there were ``n_calls`` calls: K2's count a call."""
        check(len(self.calls) == n_calls,
              f"{what}: {len(self.calls)} evaluate_batch calls, want "
              f"{n_calls}")
        k2 = self.calls[0][1]
        check(k2 > 0 and all(c[0] == 1 and c[1] == k2
                             for c in self.calls),
              f"{what}: K1/K2 launches differ between calls: "
              f"{sorted(set(c[:2] for c in self.calls))}")
        return k2

    def split(self) -> dict:
        s = sorted(c[2] for c in self.calls)
        return {"calls_s_total": sum(s), "call_s_median": s[len(s) // 2],
                "call_s_min": s[0], "call_s_max": s[-1]}


def fleet_launches_ok(launches: dict, n_calls: int, k2: int, what: str):
    check(launches == {**expected_launches("sa_occupancy", n_calls),
                       "segment_sum": k2 * n_calls},
          f"{what} launched {launches}, want K1 {n_calls} and K2 "
          f"{k2} x {n_calls}")


def fleet_full(card: str, dev="cuda") -> tuple[dict, object]:
    """The fleet day on the card, nothing cut: a first run with its
    launches counted call by call (K1 once and K2 the same count in every
    one of the 97 ``evaluate_batch`` calls), two more runs bit-identical
    to it (the steady wall their min), the same day on the numpy batched
    engine beside it (its wall; its report within 1e-9, decisions
    identical), and a profile window of a few epochs. Returns (the
    phase's record, the first report)."""
    import torch
    from repro_torch.core.fleet import sweep_fleet
    from repro_torch.core.policies import KnobGrid
    sc, grid = fleet_day(), KnobGrid(**FLEET_GRID)
    n_calls = sc.n_epochs + 1
    with PerCall() as pc:
        reset_launches()
        t0 = time.perf_counter()
        first = sweep_fleet(sc, grid, device=dev)
        wall_first = time.perf_counter() - t0
        launches = read_launches()
    k2 = pc.k2_per_call("fleet_full", n_calls)
    fleet_launches_ok(launches, n_calls, k2, "fleet_full")
    check(first.requests_total >= FLEET_MIN_REQUESTS,
          f"fleet_full: {first.requests_total} requests < "
          f"{FLEET_MIN_REQUESTS}")
    ref = first.to_dict()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = sweep_fleet(sc, grid, device=dev)
        walls.append(time.perf_counter() - t0)
        check(again.to_dict() == ref,
              "fleet_full: a second run is not bit-identical")
    t0 = time.perf_counter()
    on_host = sweep_fleet(sc, grid, device="numpy")
    wall_numpy = time.perf_counter() - t0
    worst = tree_rel(on_host.to_dict(), ref, "fleet_full card vs numpy")
    short = fleet_day(FLEET_PROFILE_S)

    def run_short():
        t = time.perf_counter()
        sweep_fleet(short, grid, device=dev)
        if str(dev).startswith("cuda"):
            torch.cuda.synchronize()
        return time.perf_counter() - t

    run_short()
    prof = profile_run(run_short, ("sa_occupancy_kernel",
                                   "segment_sum_kernel"))
    steady = min(walls)
    return {"card": card, "classes": len(sc.classes),
            "n_chips": sc.n_chips, "epochs": sc.n_epochs,
            "policies": len(sc.policies), "knobs": len(grid.product()),
            "requests_total": first.requests_total,
            "evaluate_batch_calls": n_calls, "launches": launches,
            "k1_per_call": 1, "k2_per_call": k2,
            "wall_s_first": wall_first, "wall_s_steady": steady,
            "epochs_per_s": sc.n_epochs / steady,
            "first_run": pc.split(),
            "wall_s_numpy_engine": wall_numpy,
            "max_rel_err_vs_numpy_engine": worst,
            "bit_identical_rerun": True,
            "profile_epochs": short.n_epochs, "profile": prof}, first


def fleet_parity(card: str, dev="cuda", keep=None) -> dict:
    """The fleet day cut to its first 8 epochs, on the card against the
    CPU (every integer and flag — arrivals, severity indices, chosen and
    deployed knobs, retunes, allocations — equal, every float ≤1e-9), and
    the calibration call on the card against the numpy batched engine
    (≤1e-9). ``keep``, where given, receives the card's report and wall,
    which the mesh phases are held to."""
    from repro_torch.core.fleet import sweep_fleet
    from repro_torch.core.hw import get_npu
    from repro_torch.core.policies import (KnobGrid, evaluate_batch,
                                           evaluate_batch_numpy)
    sc, grid = fleet_day(FLEET_PARITY_S), KnobGrid(**FLEET_GRID)
    t0 = time.perf_counter()
    on_card = sweep_fleet(sc, grid, device=dev)
    wall_card = time.perf_counter() - t0
    if keep is not None:
        keep.update(fleet_parity=on_card, fleet_parity_wall_s=wall_card)
    t0 = time.perf_counter()
    on_cpu = sweep_fleet(sc, grid, device="cpu")
    wall_cpu = time.perf_counter() - t0
    worst = tree_rel(on_cpu.to_dict(), on_card.to_dict(),
                     "fleet_parity card vs CPU")
    base = [c.workload for c in sc.classes]
    npu = (get_npu(sc.npu),)
    cal = evaluate_batch(base, npu, sc.policies, grid, device=dev)
    ora = evaluate_batch_numpy(base, npu, sc.policies, grid)
    cal_worst = cube_rel(ora, cal, "fleet_parity calibration vs numpy")
    return {"card": card, "epochs": sc.n_epochs,
            "cut": f"duration_s {FLEET_PARITY_S:g} of {FLEET_DAY_S:g}",
            "records": len(on_card.records),
            "retunes": sum(r["retuned"] for r in on_card.records),
            "max_rel_err_vs_cpu": worst, "decisions_identical": True,
            "calibration_cells": int(ora.runtime_s.size),
            "calibration_max_rel_err_vs_numpy": cal_worst,
            "wall_s_card": wall_card, "wall_s_cpu": wall_cpu}


def chaos_full(card: str, dev="cuda") -> dict:
    """``benchmarks/perf_chaos.py``'s campaign with the port's classes:
    the fleet day under a seeded fault timeline of severity 1 (chip
    failures, drains, pg faults, link flaps / degrades / downs), the
    hysteresis governor, no thrash baseline; the timeline must realize
    faults, every call launch K1 once and K2 the same count, and a rerun
    be bit-identical."""
    from repro_torch.core.fleet import sweep_chaos
    from repro_torch.core.policies import KnobGrid
    sc, grid = fleet_day(), KnobGrid(**FLEET_GRID)
    kw = dict(fault_severities=(CHAOS_SEVERITY,), thrash_baseline=False,
              device=dev)
    n_calls = sc.n_epochs + 1
    with PerCall() as pc:
        reset_launches()
        t0 = time.perf_counter()
        camp = sweep_chaos(sc, grid, **kw)
        wall_first = time.perf_counter() - t0
        launches = read_launches()
    k2 = pc.k2_per_call("chaos_full", n_calls)
    fleet_launches_ok(launches, n_calls, k2, "chaos_full")
    rep, tl = camp["reports"][CHAOS_SEVERITY], camp["timelines"][
        CHAOS_SEVERITY]
    check(bool(tl.any_fault().any()) and tl.has_link_faults,
          "chaos_full: the severity-1 timeline realized no faults")
    t0 = time.perf_counter()
    again = sweep_chaos(sc, grid, **kw)
    wall_second = time.perf_counter() - t0
    check(again["reports"][CHAOS_SEVERITY].to_dict() == rep.to_dict()
          and again["summary"] == camp["summary"],
          "chaos_full: a rerun is not bit-identical")
    fs = rep.fault_summary
    return {"card": card, "fault_severity": CHAOS_SEVERITY,
            "epochs": sc.n_epochs, "launches": launches,
            "k2_per_call": k2, "wall_s_first": wall_first,
            "wall_s_second": wall_second, "first_run": pc.split(),
            "faulted_epochs": fs["faulted_epochs"],
            "link_fault_epochs": fs["link_fault_epochs"],
            "pg_fault_epochs": fs["pg_fault_epochs"],
            "chip_fault_epochs": fs["chip_fault_epochs"],
            "fault_transitions": fs["n_transitions"],
            "retunes": {r["policy"]: r["retunes"] for r in camp["summary"]},
            "bit_identical_rerun": True}


def guard_faults(dev="cuda") -> dict:
    """Four faults injected into the card rung at the resume child's
    size, each held to exactly the events it must give. The card's
    ladder has no rung below it, so nothing here may reach the host: a
    rung that raises once (one ``retry``, the card's result); a rung that
    sleeps past a short deadline (``GuardError`` naming the timeout, no
    attempt off the card); a rung whose library does not load
    (``GuardError`` at once, no retry, no launch); a rung that poisons
    one cell with NaN (one ``quarantine`` and its ``oracle_recheck``, the
    cell patched from the numpy batched engine, the survivors within
    1e-9 of it)."""
    from repro_torch.core import guard
    from repro_torch.core.backend import failover_rungs
    from repro_torch.core.guard import GuardedRunner, GuardError, GuardPolicy
    from repro_torch.core.opgen import llm_workload
    from repro_torch.core.policies import (KnobGrid, evaluate_batch,
                                           evaluate_batch_numpy)
    from repro_torch.kernels.sa_occupancy import sa_occupancy
    wls = [llm_workload("llama2-13b", "decode", batch=8, n_chips=8, tp=8)]
    args = (wls, ("NPU-D",), ("NoPG", "ReGate-Full"),
            tuple(KnobGrid(window_scale=(0.5, 1.0)).product()))
    rungs = failover_rungs(dev)
    card = rungs[0][0]
    check(rungs == ((card, None),),
          f"guard: the card's ladder is {rungs}, want the card alone")
    default = GuardedRunner._default_runner
    want_card = evaluate_batch(*args, device=dev)
    oracle = evaluate_batch_numpy(*args)
    out = {}

    def kinds(runner):
        return [(e["kind"], e["rung"], e.get("next_rung"))
                for e in runner.report.events]

    state = {"n": 0}

    def raises_once(rung, *a):
        state["n"] += 1
        if state["n"] == 1:
            raise RuntimeError("injected: transient launch failure")
        return default(rung, *a)

    r = GuardedRunner(GuardPolicy(max_retries=2, backoff_base_s=0.01),
                      rungs=rungs, runner=raises_once, seed=7)
    t0 = time.perf_counter()
    got = r.evaluate_batch(*args, step=1)
    out["raises_once"] = {"events": kinds(r),
                          "seconds": time.perf_counter() - t0}
    check(kinds(r) == [("retry", card, None)],
          f"guard raises_once: events {kinds(r)}")
    check(cubes_equal(want_card, got),
          "guard raises_once: the result is not the card's")

    calls = []

    def wedged(rung, *a):
        calls.append(rung)
        time.sleep(GUARD_WEDGE_S)   # abandoned; launches nothing
        return None

    r = GuardedRunner(GuardPolicy(timeout_s=GUARD_SHORT_TIMEOUT_S,
                                  max_retries=0),
                      rungs=rungs, runner=wedged, seed=7)
    t0 = time.perf_counter()
    try:
        r.evaluate_batch(*args, step=2)
        raised = ""
    except GuardError as e:
        raised = str(e)
    out["wedged"] = {"raised": raised, "events": kinds(r), "calls": calls,
                     "seconds": time.perf_counter() - t0}
    check("timeout" in raised and calls == [card] and kinds(r) == [],
          f"guard wedged: raised {raised!r}, calls {calls}, events "
          f"{kinds(r)}; want GuardError on the card alone")
    time.sleep(GUARD_WEDGE_S)  # the abandoned attempt ends

    real_warm = guard._warm_device

    def no_library(d):
        raise OSError("injected: the power-plane library does not load")

    guard._warm_device = no_library
    k1 = sa_occupancy.launches
    r = GuardedRunner(GuardPolicy(max_retries=2), device=dev, seed=7)
    t0 = time.perf_counter()
    try:
        r.evaluate_batch(*args, step=3)
        raised = ""
    except GuardError as e:
        raised = str(e)
    finally:
        guard._warm_device = real_warm
    out["unprepared"] = {"raised": raised, "events": kinds(r),
                         "seconds": time.perf_counter() - t0}
    check("could not be prepared" in raised and kinds(r) == []
          and sa_occupancy.launches == k1,
          f"guard unprepared: raised {raised!r}, events {kinds(r)}; want "
          f"GuardError at once with no retry and no launch")

    def poisons(rung, *a):
        import dataclasses
        res = default(rung, *a)
        rt = res.runtime_s.copy()
        rt[0, 0, 1, 0] = float("nan")
        return dataclasses.replace(res, runtime_s=rt)

    r = GuardedRunner(GuardPolicy(), rungs=rungs, runner=poisons, seed=7)
    t0 = time.perf_counter()
    got = r.evaluate_batch(*args, step=4)
    out["poisons"] = {"events": kinds(r),
                      "seconds": time.perf_counter() - t0}
    ev = r.report.events
    check(kinds(r) == [("quarantine", card, None),
                       ("oracle_recheck", card, None)]
          and ev[0]["cell"] == [0, 0, 1, 0],
          f"guard poisons: events {kinds(r)}")
    check(got.runtime_s[0, 0, 1, 0] == oracle.runtime_s[0, 0, 1, 0],
          "guard poisons: the cell is not the numpy engine's")
    out["poisons"]["survivors_max_rel_err"] = cube_rel(
        oracle, got, "guard poisons: vs the numpy engine")
    return out


def guard_full(card: str, plain, k2: int, dev="cuda") -> dict:
    """The fleet day under ``GuardPolicy(timeout_s=600)``: bit-identical
    to the plain run with zero guard events and the same launches, its
    overhead timed against plain runs in turns (plain, guarded, guarded,
    plain), then the injected faults (``guard_faults``)."""
    from repro_torch.core.fleet import sweep_fleet
    from repro_torch.core.guard import GuardPolicy
    from repro_torch.core.policies import KnobGrid
    sc, grid = fleet_day(), KnobGrid(**FLEET_GRID)
    pol = GuardPolicy(timeout_s=GUARD_TIMEOUT_S)
    want = plain.to_dict()
    want.pop("guard")
    walls = {"plain": [], "guarded": []}
    launches = None
    for kind in ("plain", "guarded", "guarded", "plain"):
        guard = pol if kind == "guarded" else None
        reset_launches()
        t0 = time.perf_counter()
        rep = sweep_fleet(sc, grid, device=dev, guard=guard)
        walls[kind].append(time.perf_counter() - t0)
        got = rep.to_dict()
        if guard is None:
            check(got == plain.to_dict(),
                  "guard_full: a plain run is not bit-identical")
            continue
        launches = launches or read_launches()
        check(rep.guard is not None and rep.guard["events"] == [],
              f"guard_full: a clean guarded run on the card recorded "
              f"events: {rep.guard and rep.guard['events'][:3]}")
        got.pop("guard")
        check(got == want,
              "guard_full: the guarded run differs from the plain run")
    fleet_launches_ok(launches, sc.n_epochs + 1, k2, "guard_full")
    t0 = time.perf_counter()
    faults = guard_faults(dev)
    return {"card": card, "timeout_s": GUARD_TIMEOUT_S,
            "launches": launches, "events": 0,
            "order": "plain, guarded, guarded, plain",
            "wall_s_plain": walls["plain"],
            "wall_s_guarded": walls["guarded"],
            "overhead": min(walls["guarded"]) / min(walls["plain"]) - 1.0,
            "bit_identical_to_plain": True, "injected": faults,
            "injected_s": time.perf_counter() - t0}


def guard_resume(card: str, dev="cuda") -> dict:
    """``tests/_torch_guard_resume_child.py``'s chaos campaign on the card
    in a child process (which imports only ``repro_torch``), SIGKILLed by
    the guard's own hook at an epoch boundary and mid-epoch, then resumed
    from its checkpoint: the result must equal an uninterrupted card run
    of the same campaign bit for bit."""
    import importlib.util
    import shutil
    import signal
    import tempfile
    child = os.path.join(HERE, RESUME_CHILD)
    check(os.path.isfile(child), f"{RESUME_CHILD} is missing")
    spec = importlib.util.spec_from_file_location("_resume_child", child)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    scratch = os.path.join(HERE, "build", "chip_smoke_guard_resume")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    env = {k: v for k, v in os.environ.items() if k != "REPRO_GUARD_KILL"}
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(HERE, "src"),
                                         os.path.dirname(child)])

    def launch(ckdir, out, kill=None):
        e = dict(env, REPRO_GUARD_KILL=kill) if kill else env
        return subprocess.run([sys.executable, child, ckdir, out, str(dev)],
                              env=e, capture_output=True, text=True,
                              timeout=600)

    try:
        t0 = time.perf_counter()
        want = json.dumps(mod.campaign(os.path.join(tmp, "ref"), str(dev)),
                          sort_keys=True)
        ref_s = time.perf_counter() - t0
        runs = {}
        for kill in RESUME_KILLS:
            ck = os.path.join(tmp, kill.replace(":", "_"))
            out = os.path.join(tmp, kill.replace(":", "_") + ".json")
            t0 = time.perf_counter()
            died = launch(ck, out, kill)
            killed_s = time.perf_counter() - t0
            check(died.returncode == -signal.SIGKILL
                  and not os.path.exists(out),
                  f"guard_resume {kill}: the child was not killed "
                  f"(rc {died.returncode}): {died.stderr[-2000:]}")
            phase, _, e = kill.partition(":")
            if phase == "boundary":
                check(os.path.exists(os.path.join(
                    ck, "run0_hyst", f"epoch_{e}.json")),
                    f"guard_resume {kill}: no snapshot of epoch {e}")
            t0 = time.perf_counter()
            resumed = launch(ck, out)
            resumed_s = time.perf_counter() - t0
            check(resumed.returncode == 0,
                  f"guard_resume {kill}: the resumed child failed: "
                  f"{resumed.stderr[-2000:]}")
            with open(out) as f:
                check(f.read() == want, f"guard_resume {kill}: the "
                      f"resumed result differs from an uninterrupted run")
            runs[kill] = {"killed_s": killed_s, "resumed_s": resumed_s,
                          "bit_identical": True}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"card": card, "device": str(dev), "uninterrupted_s": ref_s,
            "kills": runs}


# ---- the power plane across ranks -------------------------------------------

# one 2-rank world spawned once for every mesh phase: both ranks on the
# one card, so the world is gloo over CUDA tensors (NCCL refuses two ranks
# on one GPU); the card's one-device results it is held to are the ones
# sweep_full, program_plane_full and fleet_parity already computed
MESH_WORLD = 2
MESH_DIR = os.path.join(HERE, "build", "chip_smoke_mesh")
MESH_TIMEOUT_S = 300
MESH_GROUP_TIMEOUT_S = 120.0
MESH_RTOL = 1e-9
# the executor's integers in a program-plane record (held exactly)
PLANE_EXACT = ("prog_", "n_events", "stall_", "wakes_prog", "setpm_prog")
MESH_KERNELS = ("sa_occupancy", "segment_sum", "program_exec")


def _mesh_save(out_dir: str, tag: str, rank: int, arrays=None,
               obj=None) -> None:
    import numpy as np
    base = os.path.join(out_dir, f"{tag}.rank{rank}")
    if arrays is not None:
        np.savez(base + ".npz", **arrays)
    if obj is not None:
        with open(base + ".json.part", "w") as f:
            json.dump(obj, f, sort_keys=True)
        os.replace(base + ".json.part", base + ".json")


def cube_arrays(res) -> dict:
    """A ``BatchResult``'s cubes as flat ``npz`` entries."""
    from repro_torch.core.guard import _result_fields
    return dict(_result_fields(res))


def mesh_child(rank: int, world: int, port: int, out_dir: str,
               device: str) -> int:
    """One rank of the mesh phases' world (``chip_smoke.py --mesh-rank``):
    joins the world, then on a ``(1, world)`` knob mesh and a
    ``(world,)`` wl mesh runs sweep_full's cube (twice on each: a first
    and a steady call), program_plane_full's rows (wl mesh) and
    fleet_parity's 8 epochs plain and guarded (knob mesh), through the
    entry points a user calls. Writes each result and its walls and
    launch counts under ``out_dir``."""
    import torch
    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.fleet import sweep_fleet
    from repro_torch.core.guard import GuardPolicy
    from repro_torch.core.hw import NPUS
    from repro_torch.core.opgen import paper_suite
    from repro_torch.core.policies import POLICIES, KnobGrid
    from repro_torch.core.sweep import sweep_grid, sweep_program_plane
    from repro_torch.parallel.dist import (spmd_world, sweep_mesh,
                                           world_backend)
    t_start = time.perf_counter()
    dev_type = torch.device(device).type
    meta = {"rank": rank, "world": world,
            "backend": world_backend(dev_type, world)}

    def timed(fn):
        reset_launches()
        issued = TorchBackend.collectives
        t0 = time.perf_counter()
        out = fn()
        if dev_type == "cuda":
            torch.cuda.synchronize()
        return out, {"wall_s": time.perf_counter() - t0,
                     "collectives": TorchBackend.collectives - issued,
                     "launches": {k: v for k, v in read_launches().items()
                                  if k in MESH_KERNELS}}

    with spmd_world(rank, world, f"tcp://localhost:{port}", dev_type,
                    timeout_s=MESH_GROUP_TIMEOUT_S):
        meta["joined_s"] = time.perf_counter() - t_start
        meshes = {"knob": sweep_mesh(1, world, device_type=dev_type,
                                     timeout_s=MESH_GROUP_TIMEOUT_S),
                  "wl": sweep_mesh(world, 1, device_type=dev_type,
                                   timeout_s=MESH_GROUP_TIMEOUT_S)}
        suite = paper_suite()
        for tag, mesh in meshes.items():
            t0 = time.perf_counter()
            runs = []
            for _ in range(2):
                res, rec = timed(lambda: sweep_grid(
                    suite, npus=tuple(NPUS), policies=POLICIES,
                    as_records=False, device=device, mesh=mesh,
                    **FULL_GRID))
                runs.append(rec)
            meta[f"sweep_{tag}"] = {"runs": runs,
                                    "seconds": time.perf_counter() - t0}
            _mesh_save(out_dir, f"sweep_{tag}", rank, cube_arrays(res))
        t0 = time.perf_counter()
        recs, rec = timed(lambda: sweep_program_plane(
            suite, tuple(NPUS), KnobGrid(**PP_FULL_GRID), device=device,
            mesh=meshes["wl"]))
        meta["plane"] = {**rec, "seconds": time.perf_counter() - t0}
        _mesh_save(out_dir, "plane_records", rank, obj=recs)
        t0 = time.perf_counter()
        sc, grid = fleet_day(FLEET_PARITY_S), KnobGrid(**FLEET_GRID)
        plain, rec = timed(lambda: sweep_fleet(sc, grid, device=device,
                                               mesh=meshes["knob"]))
        guarded, grec = timed(lambda: sweep_fleet(
            sc, grid, device=device, mesh=meshes["knob"],
            guard=GuardPolicy(timeout_s=GUARD_TIMEOUT_S)))
        meta["fleet"] = {**rec, "guarded": grec,
                         "seconds": time.perf_counter() - t0}
        _mesh_save(out_dir, "fleet", rank,
                   obj={"plain": plain.to_dict(),
                        "guarded": guarded.to_dict()})
    meta["seconds"] = time.perf_counter() - t_start
    _mesh_save(out_dir, "meta", rank, obj=meta)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh_world(device: str = "cuda") -> dict:
    """Spawn the ``MESH_WORLD`` ranks (``mesh_child``), wait for them and
    return each rank's ``meta`` record and the world's wall. A rank that
    fails or outlives ``MESH_TIMEOUT_S`` fails the run."""
    import shutil
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src"), os.environ.get("PYTHONPATH", "")]
    ).rstrip(os.pathsep))
    env.pop("REPRO_GUARD_KILL", None)
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(MESH_WORLD):
        log = open(os.path.join(MESH_DIR, f"rank{r}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), str(MESH_WORLD), str(port), MESH_DIR, device],
            cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        _CHILDREN.append(p)
        procs.append(p)
        logs.append(log)
    deadline = time.monotonic() + MESH_TIMEOUT_S
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    wall = time.perf_counter() - t0
    for p in procs:  # a rank past its time; the dry-run child runs on
        if p.poll() is None:
            p.kill()
            p.wait()
    for log in logs:
        log.close()
    if codes != [0] * MESH_WORLD:
        tails = []
        for r in range(MESH_WORLD):
            with open(os.path.join(MESH_DIR, f"rank{r}.log")) as f:
                tails.append(f"rank {r}: " + f.read()[-1500:])
        fail(f"the mesh world failed (exit codes {codes}): "
             + " | ".join(tails))
    metas = []
    for r in range(MESH_WORLD):
        with open(os.path.join(MESH_DIR, f"meta.rank{r}.json")) as f:
            metas.append(json.load(f))
    return {"metas": metas, "wall_s": wall}


def _mesh_load(tag: str, rank: int, json_: bool = False):
    import numpy as np
    base = os.path.join(MESH_DIR, f"{tag}.rank{rank}")
    if json_:
        with open(base + ".json") as f:
            return json.load(f)
    with np.load(base + ".npz") as f:
        return {k: f[k] for k in f.files}


def _arrays_rel(want: dict, got: dict) -> float:
    import numpy as np
    check(want.keys() == got.keys(), "cube fields differ")
    worst = 0.0
    for k, a in want.items():
        b = got[k]
        check(a.shape == b.shape and bool(np.isfinite(b).all()),
              f"{k}: shape {b.shape} or non-finite values")
        worst = max(worst, float((np.abs(a - b) / np.maximum(
            1e-30, np.maximum(np.abs(a), np.abs(b)))).max(initial=0.0)))
    return worst


def _arrays_equal(a: dict, b: dict) -> bool:
    import numpy as np
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _rank_launches(metas, key: str, sub=None) -> dict:
    out = {}
    for m in metas:
        rec = m[key] if sub is None else m[key][sub]
        out[f"rank{m['rank']}"] = rec["launches"]
    return out


def _launched_on_every_rank(launches: dict, kernels, what: str,
                            exact=None) -> None:
    for rank, counts in launches.items():
        for k in kernels:
            n = counts[k]
            check(n > 0 if exact is None else n == exact,
                  f"{what}: {rank} launched {k} {n} times")


def mesh_launches(kernel: str, sweep_m: dict, plane_m: dict,
                  fleet_m: dict) -> dict:
    """``kernel``'s launches on each rank of the mesh phases."""
    out = {f"sweep_mesh:{tag}": {r: c[kernel] for r, c in
                                 sweep_m[tag]["launches"].items()}
           for tag in ("knob", "wl")}
    out["sweep_mesh:nccl_one_rank"] = {
        "rank0": sweep_m["nccl_one_rank"]["launches"][kernel]}
    out["program_plane_mesh"] = {r: c[kernel] for r, c in
                                 plane_m["launches"].items()}
    out["fleet_mesh"] = {r: c[kernel] for r, c in
                         fleet_m["launches"].items()}
    return out


def nccl_one_rank_sweep(card: str, full_res, dev) -> dict:
    """sweep_full's cube on a one-rank ``(1, 1)`` mesh of an in-process
    NCCL world, the path a world with a card for each rank takes: the
    sharded program with its collectives over one rank, bit for bit the
    unsharded cube."""
    import torch
    from repro_torch.core.hw import NPUS
    from repro_torch.core.opgen import paper_suite
    from repro_torch.core.policies import POLICIES
    from repro_torch.core.sweep import sweep_grid
    from repro_torch.parallel.dist import single_process_world, sweep_mesh
    import torch.distributed as dist
    with single_process_world("cuda"):
        backend = dist.get_backend()
        mesh = sweep_mesh(1, 1, device_type="cuda",
                          timeout_s=MESH_GROUP_TIMEOUT_S)
        reset_launches()
        t0 = time.perf_counter()
        res = sweep_grid(paper_suite(), npus=tuple(NPUS), policies=POLICIES,
                         as_records=False, device=dev, mesh=mesh,
                         **FULL_GRID)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches().items()
                    if k in MESH_KERNELS}
    check(backend == "nccl", f"the one-rank world's backend is {backend}")
    check(_arrays_equal(cube_arrays(full_res), cube_arrays(res)),
          "the (1, 1) NCCL mesh's cube differs from sweep_full's")
    _launched_on_every_rank({"rank0": launches},
                            ("sa_occupancy", "segment_sum"),
                            "the (1, 1) NCCL mesh")
    return {"backend": backend, "mesh": [1, 1], "wall_s": wall,
            "launches": launches, "bit_identical": True}


def mesh_phases(card: str, held: dict, dev="cuda") -> tuple[dict, dict,
                                                            dict]:
    """The three mesh phases from one world (``run_mesh_world``), each held
    to the one-device result this run already holds (``held``: the
    sweep_full cube and its steady wall, program_plane_full's records
    and wall, fleet_parity's card report and wall). Returns the
    ``sweep_mesh``, ``program_plane_mesh`` and ``fleet_mesh`` records."""
    from repro_torch.core.guard import GuardError, tree_max_rel
    t0 = time.perf_counter()
    nccl = nccl_one_rank_sweep(card, held["sweep_full"], dev)
    nccl_s = time.perf_counter() - t0
    world = run_mesh_world(str(dev))
    metas = world["metas"]
    common = {"card": card, "world": MESH_WORLD,
              "backend": metas[0]["backend"],
              "world_wall_s": world["wall_s"],
              "joined_s": [m["joined_s"] for m in metas],
              "rank_seconds": [m["seconds"] for m in metas]}
    check(metas[0]["backend"] == "gloo",
          f"two ranks on one card run {metas[0]['backend']}, want gloo")

    # ---- sweep_mesh: the knob-only mesh bit for bit, the wl mesh ≤1e-9
    want = cube_arrays(held["sweep_full"])
    sweep = {"nccl_one_rank": {**nccl, "seconds": nccl_s}}
    for tag in ("knob", "wl"):
        got = [_mesh_load(f"sweep_{tag}", r) for r in range(MESH_WORLD)]
        check(all(_arrays_equal(got[0], g) for g in got[1:]),
              f"sweep_mesh {tag}: the ranks' cubes differ")
        rel = _arrays_rel(want, got[0])
        same = _arrays_equal(want, got[0])
        if tag == "knob":
            check(same, "sweep_mesh: the knob-only mesh's cube differs "
                        "from sweep_full's")
        check(rel <= MESH_RTOL, f"sweep_mesh {tag}: {rel} > {MESH_RTOL}")
        launches = {f"rank{m['rank']}": m[f"sweep_{tag}"]["runs"][0][
            "launches"] for m in metas}
        if str(dev).startswith("cuda"):
            _launched_on_every_rank(launches, ("sa_occupancy", "segment_sum"),
                                    f"sweep_mesh {tag}")
        runs = [m[f"sweep_{tag}"]["runs"] for m in metas]
        sweep[tag] = {
            "mesh": [1, MESH_WORLD] if tag == "knob" else [MESH_WORLD],
            "max_rel_err": rel, "bit_identical": same,
            "wall_s_first": [r[0]["wall_s"] for r in runs],
            "wall_s_steady": [r[1]["wall_s"] for r in runs],
            "collectives": [r[1]["collectives"] for r in runs],
            "seconds": [m[f"sweep_{tag}"]["seconds"] for m in metas],
            "launches": launches}
    sweep_rec = {**common, **sweep,
                 "one_device_wall_s_steady": held["sweep_full_wall_s"]}

    # ---- program_plane_mesh: the executor's integers exact
    want_recs = held["program_plane_full"]
    got = [_mesh_load("plane_records", r, json_=True)
           for r in range(MESH_WORLD)]
    check(all(g == got[0] for g in got[1:]),
          "program_plane_mesh: the ranks' records differ")
    check(len(got[0]) == len(want_recs),
          f"program_plane_mesh: {len(got[0])} records, want "
          f"{len(want_recs)}")
    n_exact, worst = 0, 0.0
    for a, b in zip(want_recs, got[0]):
        check(set(a) == set(b), "program_plane_mesh: record fields differ")
        for k, va in a.items():
            vb = b[k]
            if va is None or isinstance(va, str):
                check(va == vb, f"program_plane_mesh: {k} {va!r} {vb!r}")
            elif k.startswith(PLANE_EXACT):
                check(float(va) == float(vb),
                      f"program_plane_mesh: executor integer {k} "
                      f"{va!r} != {vb!r} ({a['workload']}/{a['npu']})")
                n_exact += 1
            else:
                worst = max(worst, abs(float(va) - float(vb))
                            / max(1.0, abs(float(va))))
    check(worst <= MESH_RTOL, f"program_plane_mesh: {worst} > {MESH_RTOL}")
    launches = _rank_launches(metas, "plane")
    if str(dev).startswith("cuda"):
        _launched_on_every_rank(launches, ("program_exec",),
                                "program_plane_mesh", exact=1)
        _launched_on_every_rank(launches, ("sa_occupancy", "segment_sum"),
                                "program_plane_mesh")
    plane_rec = {**common, "mesh": [MESH_WORLD], "records": len(got[0]),
                 "rows": held["program_plane_rows"],
                 "rows_per_rank": -(-held["program_plane_rows"]
                                    // MESH_WORLD),
                 "executor_integers_equal": n_exact,
                 "records_bit_identical": got[0] == want_recs,
                 "max_rel_err": worst,
                 "wall_s": [m["plane"]["wall_s"] for m in metas],
                 "collectives": [m["plane"]["collectives"] for m in metas],
                 "seconds": [m["plane"]["seconds"] for m in metas],
                 "one_device_wall_s": held["program_plane_wall_s"],
                 "launches": launches}

    # ---- fleet_mesh: ≤1e-9 of fleet_parity's card report; the guarded
    # run logs no event
    want_rep = held["fleet_parity"].to_dict()
    got = [_mesh_load("fleet", r, json_=True) for r in range(MESH_WORLD)]
    check(all(g == got[0] for g in got[1:]),
          "fleet_mesh: the ranks' reports differ")
    plain, guarded = got[0]["plain"], got[0]["guarded"]
    try:
        worst = tree_max_rel(want_rep, plain, MESH_RTOL)
    except GuardError as e:
        fail(f"fleet_mesh vs fleet_parity: {e}")
    events = (guarded.get("guard") or {}).get("events")
    check(events == [], f"fleet_mesh: the clean guarded mesh run logged "
                        f"{events}")
    core = {k: v for k, v in guarded.items() if k != "guard"}
    check(core == {k: v for k, v in plain.items() if k != "guard"},
          "fleet_mesh: the guarded report differs from the plain one")
    launches = _rank_launches(metas, "fleet")
    if str(dev).startswith("cuda"):
        _launched_on_every_rank(launches, ("sa_occupancy", "segment_sum"),
                                "fleet_mesh")
    fleet_rec = {**common, "mesh": [1, MESH_WORLD],
                 "epochs": held["fleet_parity"].n_epochs,
                 "records": len(plain["records"]), "max_rel_err": worst,
                 "bit_identical": plain == json.loads(json.dumps(want_rep)),
                 "guard_events": 0,
                 "wall_s": [m["fleet"]["wall_s"] for m in metas],
                 "collectives": [m["fleet"]["collectives"] for m in metas],
                 "wall_s_guarded": [m["fleet"]["guarded"]["wall_s"]
                                    for m in metas],
                 "seconds": [m["fleet"]["seconds"] for m in metas],
                 "one_device_wall_s": held["fleet_parity_wall_s"],
                 "launches": launches,
                 "launches_guarded": _rank_launches(metas, "fleet",
                                                    "guarded")}
    return sweep_rec, plane_rec, fleet_rec


def rel_l2(got, want):
    """Per row ||got - want|| / ||want|| over the last axis, float32."""
    d = (got.float() - want.float()).norm(dim=-1)
    return d / want.float().norm(dim=-1).clamp_min(1e-30)


def _wrappers() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.kernels.gated_matmul import gated_matmul_p
    from repro_torch.kernels.program_exec import program_exec
    from repro_torch.kernels.sa_occupancy import sa_occupancy
    from repro_torch.kernels.segment_sum import segment_sum
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd
    return {"sa_occupancy": sa_occupancy, "segment_sum": segment_sum,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "decode_attention": decode_attention, "ssd_scan": ssd_scan,
            "ssd_scan_bwd": ssd_scan_bwd, "gated_matmul": gated_matmul_p,
            "program_exec": program_exec}


def reset_launches() -> None:
    for k in _wrappers().values():
        k.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, k in _wrappers().items()}


def expected_launches(kernel, n: int) -> dict:
    """Every wrapper's count when only ``kernel`` (a name, a tuple of
    names, or None) launched, ``n`` times each."""
    kernels = (kernel,) if isinstance(kernel, str) else tuple(kernel or ())
    return {name: (n if name in kernels else 0) for name in _wrappers()}


def image_slots(cfg) -> int:
    """The cache slots a vision arch's patches take before the text."""
    return cfg.frontend_seq if cfg.frontend == "vision" else 0


def frontend_batch(cfg, B: int, device, gen=None) -> dict:
    """The non-token inputs of an arch's forward: a vision arch's patch
    embeddings, zeros as its server feeds them (or seeded from ``gen``),
    an audio arch's frame embeddings, seeded from ``gen``; {} otherwise."""
    import torch
    if cfg.frontend == "vision":
        shape = (B, cfg.frontend_seq, cfg.frontend_dim)
        return {"patches": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device) if gen is None else
                torch.randn(shape, generator=gen, device=device)}
    if cfg.frontend == "audio":
        return {"frames": torch.randn((B, AUDIO_FRAMES, cfg.frontend_dim),
                                      generator=gen, device=device)}
    return {}


class RouteLog:
    """While active (a ``with`` block), the routing of every
    ``blocks.moe_fwd`` call: the router's probabilities and top-K experts
    of each dispatched group, kept as the tensors the call made (no copy
    and no sync inside the run). ``tables()`` turns them, after the run,
    into one host table per call (a training pass logs the forward's and
    remat's recompute's), over the call's (B, S) tokens:
    ``experts`` (B, S, K) in slot order, ``kept`` (B, S, K) (the
    capacity rule over each group's flat (token, slot) order), ``top``
    (B, S, K + 1) the largest probabilities, sorted. ``kept`` is what
    the dispatch decided (``blocks.moe_slots``' keep, logged beside the
    routing); on one device that is the capacity rule over each group's
    flat (token, slot) order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import blocks
        self._orig = blocks.moe_fwd, blocks.moe_route, blocks.moe_slots
        fwd, route, slots = self._orig
        groups = []

        def logged_route(tok, router, top_k):
            out = route(tok, router, top_k)
            groups.append([out[0].detach(), out[2], None])
            return out

        def logged_slots(flat_e, *args):
            pos, keep = slots(flat_e, *args)
            groups[-1][2] = keep.view(*groups[-1][1].shape)
            return pos, keep

        def logged_fwd(p, x, cfg):
            groups.clear()
            out = fwd(p, x, cfg)
            self.calls.append((tuple(x.shape), cfg,
                               [tuple(g) for g in groups]))
            return out

        blocks.moe_fwd, blocks.moe_route, blocks.moe_slots = \
            logged_fwd, logged_route, logged_slots
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks.moe_fwd, blocks.moe_route, blocks.moe_slots = self._orig

    def tables(self) -> list:
        out = route_tables(self.calls)
        self.calls.clear()
        return out


def route_tables(calls, rule: bool = False) -> list:
    """``RouteLog``'s tables of ``calls``, each ``((B, S, ·), cfg,
    [(probs (n, G, E), idx (n, G, K), keep (n, G, K)), ...])`` over a
    call's groups: ``kept`` the logged keep, or with ``rule`` the
    capacity rule over each group's G tokens."""
    import torch
    from repro_torch.models.blocks import moe_capacity
    out = []
    for (B, S, _), cfg, groups in calls:
        K, E = cfg.moe.top_k, cfg.moe.n_experts
        probs = torch.cat([torch.as_tensor(g[0]) for g in groups])
        idx = torch.cat([torch.as_tensor(g[1]) for g in groups])
        nc, G = idx.shape[:2]
        if rule:
            flat = idx.reshape(nc, G * K)
            sel = torch.nn.functional.one_hot(flat, E)
            pos = (sel.cumsum(dim=1) - sel).gather(-1, flat[..., None])
            kept = (pos[..., 0] < moe_capacity(G, cfg)).view(nc, G, K)
        else:
            kept = torch.cat([torch.as_tensor(g[2]) for g in groups])
        top = probs.sort(dim=-1, descending=True).values[..., :K + 1]

        def tokens(t):  # (nc, B * gs, ·) -> (B, S, ·)
            return t.reshape(nc, B, S // nc, -1).transpose(0, 1) \
                .reshape(B, S, -1).cpu().numpy()

        out.append({"experts": tokens(idx), "kept": tokens(kept),
                    "top": tokens(top)})
    return out


def route_diff(want: list, got: list, f32: bool) -> dict:
    """Two runs' routing, layer by layer (lists of ``RouteLog`` tables
    over the same (B, S) tokens): the (token, slot) differences in the
    experts and in the drops. ``differs`` (B, S): a token routed otherwise
    in some layer. A difference is *first* where neither the token nor an
    earlier one of its row differed in an earlier layer: later ones follow
    from it (the token's own hidden state, or its context's keys, have
    moved). ``min_margin_first``: the smallest gap between adjacent top K
    + 1 probabilities of ``want`` at a first expert difference -- what
    rounding had to overcome; in float32 one above ``ROUTE_MARGIN_F32``
    fails the phase."""
    import numpy as np
    differs = np.zeros(want[0]["experts"].shape[:2], bool)
    n_exp = n_drop = n_first = 0
    margin = None
    for w, g in zip(want, got):
        e = w["experts"] != g["experts"]
        d = w["kept"] != g["kept"]
        n_exp += int(e.sum())
        n_drop += int(d.sum())
        first = e.any(-1) & ~np.logical_or.accumulate(differs, axis=1)
        n_first += int(first.sum())
        if first.any():
            gaps = (-np.diff(w["top"][first], axis=-1)).min(axis=-1)
            margin = min(float(gaps.min()), margin if margin is not None
                         else float("inf"))
        differs |= e.any(-1) | d.any(-1)
    if f32:
        check(margin is None or margin <= ROUTE_MARGIN_F32,
              f"routing differs first where the top probabilities are "
              f"{margin} > {ROUTE_MARGIN_F32} apart: not a rounding tie")
    return {"expert_slot_diffs": n_exp, "drop_slot_diffs": n_drop,
            "tokens_differing": int(differs.sum()),
            "tokens_differing_first": n_first,
            "min_margin_first": margin, "differs": differs,
            "dropped_slots_want": int(sum((~w["kept"]).sum()
                                          for w in want)),
            "dropped_slots_got": int(sum((~g["kept"]).sum()
                                         for g in got))}


def routed_alike(diff: dict, positions: list, context: bool):
    """(len(positions), B) bool: the compared logits whose token -- and,
    with ``context``, every earlier token of its row -- was routed alike
    in both runs (``route_diff``'s ``differs``)."""
    import numpy as np
    d = diff["differs"]
    if context:
        d = np.logical_or.accumulate(d, axis=1)
    return ~d[:, positions].T


def route_record(diff: dict, alike) -> dict:
    """``route_diff`` and ``routed_alike`` for a phase's record."""
    return {k: v for k, v in diff.items() if k != "differs"} | {
        "logits_compared": int(alike.sum()),
        "logits_excluded": int((~alike).sum())}


def serve_full(card: str, arch: str):
    """A serving path at full width: ``Server(arch, reduced=False)`` on
    the card (deepseek cut in depth, ``SERVE_PATHS``), batch 4, the arch's
    prompt (a vision arch's 256 zero patch embeddings before it), 32
    generated tokens. For an MoE arch the decode-vs-forward checks compare
    the tokens routed alike in both runs (``RouteLog``). Returns (the
    phase's record, the server, the prompts)."""
    import contextlib

    import numpy as np
    import torch
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as M
    from repro_torch.models import registry

    path = SERVE_PATHS[arch]
    prompt = path["prompt"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    srv = Server(arch, reduced=False, n_layers=path.get("layers"),
                 batch=SERVE_BATCH,
                 max_seq=image_slots(get_cfg(arch)) + prompt + SERVE_TOKENS,
                 seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated()
    cfg = srv.cfg
    n_img = image_slots(cfg)
    routes = RouteLog() if cfg.moe else contextlib.nullcontext()
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size) == path["widths"],
          f"not the full-width config: {cfg}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_BATCH, prompt), dtype=np.int32)
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
    with routes:  # keeps the router's tensors: no copy, no sync
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
    # prompt and the tokens generated so far, at the same position. An
    # MoE prefill of 2 048 tokens groups them 1 024 at a time and drops
    # assignments past an expert's capacity, where a forward over 2 079
    # positions groups each position's B tokens alone (the reference's
    # rule): the check takes an untimed second run on the prompt cut to
    # 2 047 tokens, whose prefill groups as the forward does
    dvf_prompts, dvf_gen, route_rec = prompts, gen, {}
    if cfg.moe:
        timed = routes.tables()
        n_moe = len(timed) // SERVE_TOKENS
        route_rec["prefill_dropped_slots"] = int(sum(
            (~t["kept"]).sum() for t in timed[:n_moe]))
        route_rec["prefill_slots"] = int(sum(t["kept"].size
                                             for t in timed[:n_moe]))
        dvf_prompts = prompts[:, :prompt - 1]
        logits.clear()
        with routes:
            dvf_gen = [srv.prefill_prompts(dvf_prompts)]
            for _ in range(SERVE_TOKENS - 1):
                dvf_gen.append(srv.step(dvf_gen[-1]))
        dvf_gen = np.stack(dvf_gen, axis=1)
        decoded = moe_decode_routes(routes.tables(), SERVE_TOKENS)
    seq = torch.tensor(np.concatenate([dvf_prompts, dvf_gen[:, :-1]],
                                      axis=1),
                       dtype=torch.int64, device="cuda")
    with torch.no_grad(), routes:
        full, _ = M.forward(srv.params, {
            "tokens": seq, **frontend_batch(cfg, SERVE_BATCH, "cuda")}, cfg)
    last = n_img + dvf_prompts.shape[1] - 1
    alike = torch.ones((SERVE_TOKENS, SERVE_BATCH), dtype=torch.bool)
    if cfg.moe:  # bf16: a token's own routing (its context's flips dilute)
        diff = route_diff(routes.tables(), decoded, False)
        ok = routed_alike(diff, list(range(last, last + SERVE_TOKENS)),
                          context=False)
        alike = torch.from_numpy(ok)
        route_rec["routing"] = route_record(diff, ok)
        check(bool(alike.any()), "decode vs forward (bf16): no token was "
              "routed alike in both runs")
    rel = torch.stack([rel_l2(logits[t], full[:, last + t])
                       for t in range(SERVE_TOKENS)]).cpu()
    abs_err = max(max_abs(logits[t][alike[t].to(logits[t].device)],
                          full[:, last + t][alike[t].to(full.device)]
                          .float()) for t in range(SERVE_TOKENS))
    agree = float(torch.stack([
        (logits[t].argmax(-1) == full[:, last + t].argmax(-1))
        .float().mean() for t in range(SERVE_TOKENS)]).mean())
    scale = float(full[:, last:].float().abs().max())
    del full
    torch.cuda.empty_cache()
    rel_all, rel = rel, torch.where(alike, rel, 0.0)
    check(float(rel.max()) <= path["rel_l2_bf16"],
          f"decode vs forward (bf16): relative L2 {float(rel.max())} > "
          f"{path['rel_l2_bf16']}")
    f32 = decode_vs_forward_f32(cfg, dvf_prompts)
    check(f32["max_rel_l2"] <= SERVE_REL_L2_TOL_F32,
          f"decode vs forward (float32): relative L2 {f32['max_rel_l2']} > "
          f"{SERVE_REL_L2_TOL_F32}")
    srv.prefill, srv.decode = plain_steps
    decode_s = sum(step_s)
    rec = {"card": card, "arch": arch, "layers": L,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           **({"reduced": f"depth: {get_cfg(arch).n_layers} -> {L} layers "
                          f"(published widths)"}
              if L != get_cfg(arch).n_layers else {}),
           "params": registry.count_params(cfg),
           "batch": SERVE_BATCH, "prompt": prompt, "image_slots": n_img,
           "tokens": SERVE_TOKENS, "init_s": t_init,
           "peak_memory_bytes_init": peak_init,
           "prefill_s": t_prefill,
           "decode_ms_per_step": 1e3 * decode_s / len(step_s),
           "decode_ms_per_step_min": 1e3 * min(step_s),
           "decode_tokens_per_s": SERVE_BATCH * len(step_s) / decode_s,
           "prompt_tokens_per_s": SERVE_BATCH * (n_img + prompt)
           / t_prefill,
           "end_to_end_tokens_per_s":
               SERVE_BATCH * SERVE_TOKENS / (t_prefill + decode_s),
           "peak_memory_bytes": peak, "launches": launches,
           "launches_per_prefill": per_prefill,
           "launches_per_step": per_step[0],
           "decode_vs_forward": {
               "max_rel_l2": float(rel.max()),
               "mean_rel_l2": float(rel[alike].mean()),
               "rel_l2_per_step": [float(r) for r in rel.max(dim=-1).values],
               **({"max_rel_l2_all_tokens": float(rel_all.max())}
                  if cfg.moe else {}),
               "max_abs_err": abs_err, "max_abs_logit": scale,
               "argmax_agreement": agree, "tolerance_rel_l2":
                   path["rel_l2_bf16"], "prompt": dvf_prompts.shape[1],
               **route_rec},
           "decode_vs_forward_f32": f32}
    return rec, srv, prompts


def tensor_leaves(tree) -> list:
    """The tensors of a nested dict / tuple / list, in order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in tensor_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    return [] if tree is None else [tree]


def hillclimb_prefill(srv, prompts) -> dict:
    """The served model's prefill (``models.model.forward(prefill=True)``
    on the server's weights and prompts) under both of the JAX package's
    hill-climb toggles (``hillclimb("triangle", segments=True)``) against
    the same prefill with neither: the last logits and every cache leaf
    ``torch.equal``, one B3 and one B5 a layer, and each B3 call's
    ``tiles_loaded`` (B3's wrapper called with a counter by the model's
    attention) equal to the mask's count (``live_tiles``). On the card
    the triangle is B3's own tile walk and the segments pass each layer
    the window the uniform loop does, so the toggles change no bit."""
    import torch
    from repro_torch.kernels.flash_attention import TILE, live_tiles
    from repro_torch.models import common
    from repro_torch.models import model as M
    cfg = srv.cfg
    batch = {"tokens": torch.tensor(prompts, dtype=torch.int64,
                                    device="cuda")}

    def prefill():
        with torch.no_grad():
            out = M.forward(srv.params, batch, cfg, prefill=True)
        torch.cuda.synchronize()
        return out

    base_last, base_cache = prefill()
    real = common.flash_attention_kernel
    tiles = {"loaded": 0, "live": 0, "mismatched": 0, "calls": 0}

    def with_tiles(q, k, v, **kw):
        B, Sq, H, _ = q.shape
        got = torch.zeros((B, H, -(-Sq // TILE)), dtype=torch.int32,
                          device=q.device)
        out = real(q, k, v, tiles_loaded=got, **kw)
        mask = {key: kw[key] for key in ("causal", "window", "prefix_len",
                                         "q_offset") if key in kw}
        want = live_tiles(Sq, k.shape[1], device=q.device, **mask)
        tiles["calls"] += 1
        tiles["loaded"] += int(got.sum())
        tiles["live"] += int(want.sum()) * B * H
        tiles["mismatched"] += int((got != want).sum())
        return out

    common.flash_attention_kernel = with_tiles
    reset_launches()
    try:
        with M.hillclimb("triangle", segments=True):
            last, cache = prefill()
    finally:
        common.flash_attention_kernel = real
    launches = read_launches()
    want = expected_launches(SERVE_PATHS[cfg.name]["prefill"], cfg.n_layers)
    check(launches == want, f"hill-climb prefill launched {launches}, "
                            f"want {want}")
    check(tiles["mismatched"] == 0 and tiles["loaded"] == tiles["live"],
          f"hill-climb prefill: B3 loaded tiles other than the mask's "
          f"{tiles}")
    ours, theirs = tensor_leaves(cache), tensor_leaves(base_cache)
    check(len(ours) == len(theirs) and torch.equal(last, base_last)
          and all(torch.equal(a, b) for a, b in zip(ours, theirs)),
          "hill-climb prefill: the logits or the cache differ from the "
          "baseline prefill's")
    return {"toggles": {"attention": "triangle", "segments": True},
            "segments": M.segments(cfg), "launches": launches,
            "tiles": tiles, "logits_and_cache_equal": True,
            "cache_leaves": len(ours)}


def hillclimb_train_step(path: dict) -> dict:
    """hymba at full width, one training step's loss and gradients (the
    microbatch loop of ``make_train_step``, remat "full") on the first
    batch of ``SyntheticDataset`` (seed 0) at ``path``'s shape, from
    ``init_params`` (seed 0), with neither toggle and then under both
    (``hillclimb("triangle", segments=True)``): the loss and every
    gradient leaf ``torch.equal``, each run exactly ``train_launches``."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import (init_params, train_params,
                                          tree_leaves)
    from repro_torch.train.steps import _split_microbatches
    cfg = train_cfg(HYBRID_ARCH)
    n_mb = path["microbatches"]
    batch = SyntheticDataset(cfg, ShapeConfig(
        "train_custom", path["seq_len"], path["global_batch"], "train"),
        seed=0, device="cuda").batch(0)
    params = train_params(init_params(
        registry.param_specs(cfg), torch.Generator(device="cuda")
        .manual_seed(0), "cuda"))
    leaves = list(tree_leaves(params))
    want = train_launches(cfg, n_mb)

    def step():
        for _, p in leaves:
            p.grad = None
        reset_launches()
        total = torch.zeros((), device="cuda")
        for mb in _split_microbatches(batch, n_mb):
            loss, _ = M.loss_fn(params, mb, cfg, remat="full")
            (loss * (1.0 / n_mb)).backward()
            total = total + loss.detach() * (1.0 / n_mb)
        torch.cuda.synchronize()
        launches = read_launches()
        check(launches == want, f"hill-climb train step launched "
                                f"{launches}, want {want}")
        return total, {name: None if p.grad is None else p.grad.clone()
                       for name, p in leaves}, launches

    t0 = time.perf_counter()
    base_loss, base_grads, _ = step()
    with M.hillclimb("triangle", segments=True):
        loss, grads, launches = step()
    for _, p in leaves:
        p.grad = None
    same = [p for p in grads if (grads[p] is None) != (base_grads[p] is None)
            or (grads[p] is not None
                and not torch.equal(grads[p], base_grads[p]))]
    check(len(grads) == len(leaves) and torch.equal(loss, base_loss)
          and not same, f"hill-climb train step: loss {float(loss)} vs "
          f"{float(base_loss)}, gradient leaves differing: {same[:5]} of "
          f"{len(grads)}")
    rec = {"toggles": {"attention": "triangle", "segments": True},
           "loss": float(loss), "loss_equal": True,
           "grad_leaves_equal": len(grads), "launches": launches,
           "seconds": time.perf_counter() - t0}
    del params, leaves, grads, base_grads
    torch.cuda.empty_cache()
    return rec


def moe_decode_routes(tables: list, n_steps: int) -> list:
    """A served run's ``RouteLog`` tables (the prefill's calls, then each
    of its ``n_steps - 1`` decode steps', a call an MoE layer) as one
    table a layer over the prompt and the decoded positions."""
    import numpy as np
    L = len(tables) // n_steps
    return [{k: np.concatenate([tables[t * L + layer][k]
                                for t in range(n_steps)], axis=1)
             for k in tables[0]} for layer in range(L)]


def get_cfg(arch: str, **kw):
    """The full-width config of ``arch``, with ``kw`` replaced."""
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch), **kw)


def decode_vs_forward_f32(cfg, prompts) -> dict:
    """The served model's weights before their bf16 cast (the server's
    seed 0), in float32: prefill, SERVE_TOKENS - 1 decode steps on its own
    argmax tokens, then one forward over the prompt and those tokens;
    every step's logits against the forward's at the same position. For
    an MoE arch only the logits whose row was routed alike in both runs up
    to that position are held to the limit (``route_diff``)."""
    import contextlib

    import torch
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params
    f32 = torch.float32
    params = init_params(registry.param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    B, S = prompts.shape
    n_img = image_slots(cfg)
    extra = frontend_batch(cfg, B, "cuda")
    toks = torch.tensor(prompts, dtype=torch.int64, device="cuda")
    cache = M.init_cache(cfg, B, n_img + S + SERVE_TOKENS, f32,
                         device="cuda")
    decoded, forward = (RouteLog(), RouteLog()) if cfg.moe else \
        (contextlib.nullcontext(), contextlib.nullcontext())
    with torch.no_grad():
        with decoded:
            last, cache = M.prefill_step(params, {"tokens": toks, **extra},
                                         cfg, dtype=f32, cache=cache)
            steps = [last[:, -1]]
            for t in range(SERVE_TOKENS - 1):
                lg, cache = M.decode_step(params, cache, {
                    "tokens": steps[-1].argmax(-1)[:, None],
                    "cache_len": n_img + S + t}, cfg, dtype=f32)
                steps.append(lg[:, -1])
        seq = torch.cat([toks, torch.stack([x.argmax(-1)
                                            for x in steps[:-1]], dim=1)],
                        dim=1)
        del cache
        with forward:
            full, _ = M.forward(params, {"tokens": seq, **extra}, cfg,
                                dtype=f32)
    rel = torch.stack([rel_l2(steps[t], full[:, n_img + S - 1 + t])
                       for t in range(SERVE_TOKENS)]).cpu()
    del full, params
    torch.cuda.empty_cache()
    route_rec = {}
    if cfg.moe:
        diff = route_diff(forward.tables(),
                          moe_decode_routes(decoded.tables(), SERVE_TOKENS),
                          True)
        alike = routed_alike(diff, list(range(n_img + S - 1,
                                              n_img + S - 1 + SERVE_TOKENS)),
                             context=True)
        route_rec = {"routing": route_record(diff, alike),
                     "max_rel_l2_all_tokens": float(rel.max())}
        check(bool(alike.any()), "decode vs forward (float32): no row was "
              "routed alike in both runs")
        rel = torch.where(torch.from_numpy(alike), rel, 0.0)
    return {"max_rel_l2": float(rel.max()), "mean_rel_l2": float(rel.mean()),
            "rel_l2_per_step": [float(r) for r in rel.max(dim=-1).values],
            "tolerance_rel_l2": SERVE_REL_L2_TOL_F32, **route_rec}


def attn_layer(cfg) -> int:
    """The layer whose attention the model-shape timings take: layer 0,
    or for a sliding-window arch its first windowed layer."""
    from repro_torch.models import registry
    glob = set(registry.global_layer_indices(cfg))
    return min(i for i in range(cfg.n_layers) if i not in glob) \
        if cfg.sliding_window else 0


def layer_attention_inputs(srv, prompts, layer: int):
    """q, k, v and the attention mask (``flash_attention``'s keywords)
    one layer of the full model computes over the prompt (for paligemma
    behind its zero patches, for hubert over frames)."""
    import torch
    from repro_torch.models import blocks, registry
    from repro_torch.models.common import rms_norm
    from repro_torch.models.model import _layers, embed_inputs
    cfg = srv.cfg
    stack = ([srv.params["dense0"]] if "dense0" in srv.params else []) + \
        _layers(srv.params["layers"], registry.n_scanned_layers(cfg))
    p = stack[layer]
    p = p["mix"]["attn"] if cfg.family == "hybrid" else p["attn"]
    B = prompts.shape[0]
    batch = {"tokens": torch.tensor(prompts, dtype=torch.int64,
                                    device="cuda"),
             **frontend_batch(cfg, B, "cuda",
                              None if cfg.frontend != "audio" else
                              torch.Generator(device="cuda").manual_seed(0))}
    with torch.no_grad():
        x, prefix = embed_inputs(srv.params, batch, cfg)
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        pos = torch.arange(x.shape[1], device="cuda")
        if cfg.mla:  # q/k 192, v 128: a view into the kv_b product
            q, k, v, _ = blocks.mla_qkv(p, h, cfg, pos)
        else:
            q, k, v = blocks._qkv(p, h, cfg, pos)
    window = None
    warr = registry.window_array(cfg, x.shape[1])
    if warr is not None and int(warr[layer]) < x.shape[1]:
        window = int(warr[layer])
    return p, q, k, v, dict(causal=not cfg.encoder_only, window=window,
                            prefix_len=prefix)


def model_shape_kernels(srv, prompts) -> dict:
    """B3 and B4 on the inputs one layer of the full model gives them
    (``attn_layer``): its q, k, v over the prompt with its mask, and its
    cache after the run with its window. MLA (deepseek: layer 0 is its
    dense0) has no B4: its decode is the plain absorbed form."""
    import torch
    from repro_torch.models import blocks
    from repro_torch.models.common import rms_norm
    cfg = srv.cfg
    layer = attn_layer(cfg)
    p, q, k, v, mask = layer_attention_inputs(srv, prompts, layer)
    b3 = time_b3(q, k, v, **mask)
    b3["layer"] = layer
    del q, k, v
    if cfg.mla:
        torch.cuda.empty_cache()
        return {"flash_attention": b3}
    clen = srv.cache_len - 1  # the last step's new token
    last = torch.tensor(prompts[:, :1], dtype=torch.int64, device="cuda")
    hq = rms_norm(srv.params["embed"][last], p["ln"], cfg.norm_eps)
    qd, _, _ = blocks._qkv(p, hq, cfg,
                           torch.full((1,), clen, device="cuda"))
    kv = srv.cache["layers"]
    if cfg.family == "hybrid":
        kv = kv[0]
    kc, vc = (c[layer] for c in kv)
    b4 = time_b4(qd, kc, vc, clen, window=mask["window"])
    b4["layer"] = layer
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


def serve_parity(arch: str, reduced: bool = False,
                 attention: str = "baseline", segments: bool = False
                 ) -> dict:
    """``arch`` at full width cut to ``SERVE_PATHS``' parity layers (2;
    hymba 4) -- or, with ``reduced``, its reduced config whole (deepseek's
    MLA at head dims (24, 16)) -- float32, the same weights and tokens on
    the card (the hand kernels) and on the CPU (their plain forms), under
    the hill-climb toggles ``attention`` / ``segments`` on both sides
    (``models.model.hillclimb``: with the triangle, the CPU's prefill
    attention past its chunk threshold is ``flash_attention_triangle``,
    counted; the card's is B3 either way): prefill of a ragged
    prompt (200 tokens; hymba 2 112, past its window; paligemma behind 256
    seeded patch embeddings) and 4 decode steps, teacher-forced with the
    CPU's tokens. For mamba2 the CPU runs the prompt as one chunk of 200
    (the JAX package's rule) and B5 as chunks of 64 with a ragged last
    one: the check also shows that the result does not depend on the
    chunk. The encoder (hubert) has no decode: its forward over 1 500
    seeded frames is compared instead (``encode_parity``). deepseek keeps
    16 of its routed experts (``parity_moe``); for an MoE arch the logits
    of rows routed otherwise by the two devices are left out
    (``route_diff``: a difference must be a rounding tie)."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import common
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, tree_map
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    path = SERVE_PATHS[arch]
    cfg = get_arch(arch).reduced() if reduced \
        else get_cfg(arch, n_layers=path["parity_layers"])
    if "parity_moe" in path and not reduced:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **path["parity_moe"]))
    params = init_params(registry.param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(1),
                         "cuda")
    on = {"cuda": params, "cpu": tree_map(lambda t: t.cpu(), params)}
    B, S0, n = 2, path["parity_prompt"], 4
    n_img = image_slots(cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S0))
    extra = frontend_batch(cfg, B, "cuda",
                           torch.Generator(device="cuda").manual_seed(2))
    prefill = make_prefill_step(cfg, dtype=torch.float32)
    decode = make_serve_step(cfg, dtype=torch.float32)

    def run(device, feed, log):
        cache = M.init_cache(cfg, B, n_img + S0 + n + 1, torch.float32,
                             device=device)
        with log:
            logits, cache = prefill(on[device], {
                "tokens": torch.tensor(prompts, device=device),
                **{k: t.to(device) for k, t in extra.items()}}, cache=cache)
            out = [logits[:, -1].float().cpu()]
            for t in range(n):
                tok = feed[t] if feed is not None else out[-1].argmax(-1)
                logits, cache = decode(on[device], cache, {
                    "tokens": tok[:, None].to(device),
                    "cache_len": n_img + S0 + t})
                out.append(logits[:, -1].float().cpu())
        return out

    logs = {d: RouteLog() if cfg.moe else contextlib.nullcontext()
            for d in ("cpu", "cuda")}
    triangle = common.flash_attention_triangle
    triangles = []

    def counted_triangle(*a, **kw):
        triangles.append(a[0].device.type)
        return triangle(*a, **kw)
    common.flash_attention_triangle = counted_triangle
    try:
        with M.hillclimb(attention, segments):
            t0 = time.perf_counter()
            want = run("cpu", None, logs["cpu"])
            t_cpu = time.perf_counter() - t0
            feed = [w.argmax(-1) for w in want]
            reset_launches()
            got = run("cuda", feed, logs["cuda"])
            launches = read_launches()
    finally:
        common.flash_attention_triangle = triangle
    check("cuda" not in triangles, "serve_parity: the card ran the plain "
          "triangle")
    alike, route_rec = None, {}
    if cfg.moe:
        diff = route_diff(*(moe_decode_routes(logs[d].tables(), n + 1)
                            for d in ("cpu", "cuda")), True)
        alike = routed_alike(diff, list(range(n_img + S0 - 1,
                                              n_img + S0 + n)), context=True)
        route_rec = {"routing": route_record(diff, alike)}
        if "parity_moe" in path and not reduced:
            route_rec["reduced"] = (
                f"routed experts {get_cfg(arch).moe.n_experts} -> "
                f"{cfg.moe.n_experts} (top-{cfg.moe.top_k} and "
                f"{cfg.moe.n_shared_experts} shared kept): 160 at full "
                f"width are 21 GB of float32 on the host")
    want_launches = expected_launches(path["prefill"], cfg.n_layers)
    if path["step"] is not None:
        want_launches[path["step"]] = cfg.n_layers * n
    check(launches == want_launches,
          f"serve_parity launches {launches}, want {want_launches}")
    return {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "dtype": "float32", "batch": B,
            "prompt": S0, "image_slots": n_img, "decode_steps": n,
            **({"config": "reduced", "mla_head_dims": [
                cfg.mla.nope_head_dim + cfg.mla.rope_head_dim,
                cfg.mla.v_head_dim]} if reduced and cfg.mla else {}),
            **({"attention": attention, "segments": segments,
                "triangle_calls_cpu": len(triangles)}
               if (attention, segments) != ("baseline", False) else {}),
            "launches": launches, **route_rec,
            **parity_verdict(got, want, "serve_parity", alike),
            "wall_s_cpu": t_cpu}


def parity_verdict(got, want, what: str, alike=None) -> dict:
    """Card vs CPU logits (lists of tensors, last axis the vocab): the
    largest difference, held to ``PARITY_ATOL``, and every token whose
    CPU top-2 margin exceeds twice that equal. ``alike``: (len(got), B)
    bool numpy, the rows compared (an MoE arch's rows routed alike); the
    others are left out."""
    if alike is not None:
        import torch
        check(bool(alike.any()), f"{what}: no row was routed alike")
        keep = [torch.from_numpy(a) for a in alike]
        got = [g[k] for g, k in zip(got, keep)]
        want = [w[k] for w, k in zip(want, keep)]
    err = max(max_abs(g, w) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want if w.numel())
    rel = max(float(rel_l2(g, w).max()) for g, w in zip(got, want)
              if w.numel())
    clear = same = 0
    for g, w in zip(got, want):
        top2 = w.topk(2, dim=-1).values
        ok = (top2[..., 0] - top2[..., 1]) > 2 * PARITY_ATOL
        clear += int(ok.sum())
        same += int((g.argmax(-1) == w.argmax(-1))[ok].sum())
    check(err <= PARITY_ATOL, f"{what}: card vs CPU logits differ by "
                              f"{err} > {PARITY_ATOL}")
    check(same == clear, f"{what}: {clear - same} clear tokens differ")
    return {"max_abs_err": err, "max_rel_l2": rel, "max_abs_logit": scale,
            "tolerance_abs": PARITY_ATOL, "tokens_clear": clear,
            "tokens_equal": same}


def audio_encoder(layers=None, dtype=None):
    """hubert-xlarge at full width (``layers`` to cut its depth), random
    weights from seed 0 on the card (bf16 unless ``dtype``), and its
    batch: ``SERVE_BATCH`` x ``AUDIO_FRAMES`` frame embeddings seeded
    on the card. Returns (cfg, params, batch)."""
    import torch
    from repro_torch.models import registry
    from repro_torch.models.param import cast_tree, init_params
    cfg = get_cfg(AUDIO_ARCH) if layers is None \
        else get_cfg(AUDIO_ARCH, n_layers=layers)
    params = init_params(registry.param_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if dtype is not None:
        params = cast_tree(params, dtype)
    batch = frontend_batch(cfg, SERVE_BATCH, "cuda",
                           torch.Generator(device="cuda").manual_seed(0))
    return cfg, params, batch


def encode_audio_full(card: str) -> tuple[dict, object, object]:
    """The encoder's path at full width: ``models.model.forward(...,
    prefill=False)`` under ``torch.no_grad()`` for hubert-xlarge, 48
    layers, batch 4 x 1 500 frames (30 s of audio at 50 frames a second),
    bf16: exactly one B3 launch a layer, bidirectional at head dim 80.
    Wall seconds a forward (the first, then the best of two more), peak
    memory, finite logits of the right shape. Returns (the record, a
    stand-in server for ``model_shape_kernels``' B3 half)."""
    import types

    import numpy as np
    import torch
    from repro_torch.models import model as M
    cfg, params, batch = audio_encoder(dtype=torch.bfloat16)
    check((cfg.n_layers, cfg.d_model, cfg.vocab_size)
          == SERVE_PATHS[AUDIO_ARCH]["widths"],
          f"not the full-width config: {cfg}")
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        if i == 0:
            reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = M.forward(params, batch, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            launches = read_launches()
    want = expected_launches("flash_attention", cfg.n_layers)
    check(launches == want, f"encode_audio_full launched {launches}, want "
                            f"{want}")
    check(tuple(logits.shape) == (SERVE_BATCH, AUDIO_FRAMES,
                                  cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()),
          f"encoder logits {tuple(logits.shape)} or not finite")
    rec = {"card": card, "arch": AUDIO_ARCH, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "batch": SERVE_BATCH, "frames": AUDIO_FRAMES,
           "forward_s_first": walls[0], "forward_s": min(walls[1:]),
           "frames_per_s": SERVE_BATCH * AUDIO_FRAMES / min(walls[1:]),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "logits_abs_max": float(logits.float().abs().max())}
    srv = types.SimpleNamespace(cfg=cfg, params=params)
    return rec, srv, np.zeros((SERVE_BATCH, AUDIO_FRAMES), np.int64)


def encode_once(enc) -> float:
    """Wall seconds of one bf16 forward of ``enc`` (``encode_audio_full``'s
    stand-in server) over its seeded frames."""
    import torch
    from repro_torch.models import model as M
    batch = frontend_batch(enc.cfg, SERVE_BATCH, "cuda",
                           torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        M.forward(enc.params, batch, enc.cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def encode_parity() -> dict:
    """hubert-xlarge at full width cut to 2 layers, float32, the same
    weights and frames on the card and on the CPU: one forward, the
    logits of every frame compared (``parity_verdict``)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_map
    cfg, params, batch = audio_encoder(layers=2)
    t0 = time.perf_counter()
    with torch.no_grad():
        want, _ = M.forward(tree_map(lambda t: t.cpu(), params),
                            {k: t.cpu() for k, t in batch.items()}, cfg,
                            dtype=torch.float32)
    t_cpu = time.perf_counter() - t0
    reset_launches()
    with torch.no_grad():
        got, _ = M.forward(params, batch, cfg, dtype=torch.float32)
    launches = read_launches()
    want_launches = expected_launches("flash_attention", cfg.n_layers)
    check(launches == want_launches,
          f"encode_parity launches {launches}, want {want_launches}")
    return {"arch": AUDIO_ARCH, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "dtype": "float32", "batch": SERVE_BATCH, "frames": AUDIO_FRAMES,
            "launches": launches,
            **parity_verdict([got.float().cpu()], [want.float()],
                             "encode_parity"),
            "wall_s_cpu": t_cpu}


# ---- training: kernel B9 and qwen2.5-3b ------------------------------------

TRAIN_ARCH = "qwen2.5-3b"
# train_full: bf16 compute on float32 master weights, AdamW, remat
# "full" (launch.train's), one card
TRAIN_FULL = dict(seq_len=2048, global_batch=2, microbatches=2, steps=4)
# the card's attention backward at the training shape (one microbatch)
B9_MODEL_SHAPE = (1, 2048, 16, 2, 128)
# card vs CPU, float32, qwen2.5-3b cut to 2 layers (train_parity)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4      # relative L2, every gradient leaf
TRAIN_PARAM_TOL = 1e-5     # relative L2, every parameter leaf, 3 steps
# a leaf initialized to zero (qwen's q, k, v biases) has no value but its
# three updates, so its relative L2 is the updates' own: AdamW's first
# steps (eps 1e-8) are sign-like on the components with gradients near
# eps (RoPE's lowest frequencies, ~1e-7), where two float32 summation
# orders differ by ~1e-9; the CPU tests read up to 5.1e-3 for the k bias
# between the port and the JAX package (tests/test_torch_train.py,
# ROADMAP Queue C). Those leaves are held to this limit instead.
TRAIN_ZERO_INIT_TOL = 1e-2
# the families' training paths at full width (launch.train.run, remat
# "full", 4 steps): phase name, arch, the loop's shape. hymba at 4 096
# tokens, so that its 29 sliding layers slide (window 2 048); paligemma's
# seq_len counts its 256 patch embeddings (1 792 text tokens); hubert's
# 1 500 frames are 30 s of audio
TRAIN_PATHS = (
    ("train_ssm_full", SSM_ARCH, dict(seq_len=2048, global_batch=2,
                                      microbatches=2, steps=4)),
    ("train_hybrid_full", HYBRID_ARCH, dict(seq_len=4096, global_batch=2,
                                            microbatches=2, steps=4)),
    ("train_vlm_full", VLM_ARCH, dict(seq_len=2048, global_batch=2,
                                      microbatches=2, steps=4)),
    ("train_audio_full", AUDIO_ARCH, dict(seq_len=AUDIO_FRAMES,
                                          global_batch=4, microbatches=2,
                                          steps=4)))
# the training paths profiled one step each (profile_train): the two that
# run B10, and deepseek's, the one that runs B9 at (192, 128); a profile
# of a step with ~10-20 k launches costs tens of host seconds
PROFILED_TRAIN = (SSM_ARCH, HYBRID_ARCH, MLA_ARCH)
# the depth a profiled step is cut to (PR 31, where the whole run passed
# its time: ~10-25 host seconds saved a profile); the per-call device
# times of the hand kernels are those of the full-depth step, the busy
# time a step that of the layers kept. hymba at 8 layers keeps sliding
# layers (global 0, 4 and 7)
PROFILE_TRAIN_LAYERS = {TRAIN_ARCH: 12, SSM_ARCH: 12, HYBRID_ARCH: 8}
# the MoE families' training paths at full width (train_moe_full,
# train_mla_full): 2 x 2 048 tokens in 2 microbatches, remat "full", 4
# steps. granite-moe-1b-a400m has all 24 layers; deepseek-v2-236b its
# published widths cut to fit one card (TRAIN_CUT)
TRAIN_MOE_PATHS = (
    ("train_moe_full", MOE_ARCH, dict(seq_len=2048, global_batch=2,
                                      microbatches=2, steps=4)),
    ("train_mla_full", MLA_ARCH, dict(seq_len=2048, global_batch=2,
                                      microbatches=2, steps=4)))
# the configs a training path cuts from the published one, and why:
# deepseek-v2-236b at 3 of 60 layers (the leading dense layer and 2 MoE
# layers, as serve_mla_full) and 16 of 160 routed experts (top-6 and the 2
# shared experts kept): 2.535 B parameters, ~41 GB of float32 masters,
# gradients and AdamW's two moments; 160 experts would be 9.33 B, ~149 GB
TRAIN_CUT = {MLA_ARCH: dict(n_layers=3, moe=dict(n_experts=16),
                            reduced="depth 60 -> 3 layers (dense0 + 2 MoE), "
                                    "routed experts 160 -> 16 (top-6 and "
                                    "2 shared kept)")}
# train_parity's cut per arch (2 layers at full width and a batch of 2 by
# default). The SSD archs at 64 tokens: one chunk on both sides, where the
# CPU's chunk rule (the reference's: one chunk of S up to 256) and B5 /
# B10's chunk of 64 agree. Over several chunks the two float32 chunkings
# alone (the CPU against itself in chunks of 64 reads the same) move
# A_log's gradient and, through AdamW's sign-like first steps, mamba2's
# tied embedding past the limits below -- the differences of cumsums of
# size ~100-1000 in float32 (tests/test_torch_ssd_bwd.py); the kernels
# phase holds B10 over many chunks. hymba at 4
# layers (0, 2, 3 global; 1 sliding) with its window cut to 32 so
# that the sequence slides past it; paligemma's 256 patches and 32 text
# tokens, one sequence (its CPU leg, 257 k-entry logits, is the longest)
TRAIN_PARITY = {
    # granite at train_parity's defaults; deepseek's leading dense layer
    # and 1 MoE layer of 16 routed experts at 64 tokens, and one step:
    # three steps' leaf copies of a 5 120-wide, 102 400-vocab model would
    # hold ~40 GB on the host
    MLA_ARCH: dict(seq_len=64, batch=1, steps=1,
                   config=dict(moe=dict(n_experts=16)),
                   reduced="depth 60 -> 2 (dense0 + 1 MoE layer), routed "
                           "experts 160 -> 16"),
    SSM_ARCH: dict(seq_len=64),
    HYBRID_ARCH: dict(seq_len=64, config=dict(n_layers=4,
                                              sliding_window=32),
                      reduced="depth 32 -> 4, sliding window 2048 -> 32"),
    VLM_ARCH: dict(seq_len=288, batch=1),
    AUDIO_ARCH: dict(seq_len=200),
}

# B10, the SSD scan's backward
SSD_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
# its four kernels, each launched once a call: the chunk-local pass, the
# state walks, the chunk gradients, the group and chunk sums
B10_KERNELS = ("ssd_bwd_chunk_kernel", "ssd_bwd_walk_kernel",
               "ssd_bwd_grad_kernel", "ssd_bwd_group_kernel")
# (B, S, nh, hd, G, N) at the training paths' shapes (one microbatch)
B10_MODEL_SHAPES = {SSM_ARCH: (1, 2048, 48, 64, 1, 128),
                    HYBRID_ARCH: (1, 4096, 50, 64, 1, 16)}
# (name, shape, strong decay, with the final state's gradient): a ragged S
# with G = 2, the strong-decay case, the state's gradient (which seeds the
# reverse state walk) at mamba2's shape and the ragged one, and 128 chunks
# at hymba's widths (the longest state walks)
B10_CASES = (("ragged_g2", (2, 1000, 4, 32, 2, 64), False, False),
             ("strong_decay", (2, 130, 4, 16, 2, 16), True, False),
             ("mamba2_dstate", (1, 2048, 48, 64, 1, 128), False, True),
             ("ragged_g2_dstate", (2, 1000, 4, 32, 2, 64), False, True),
             ("long_128_chunks", (1, 8192, 50, 64, 1, 16), False, False))
# B10 vs its plain version (autograd through B5's plain version on the
# CPU copies, float32): max |kernel - plain| / max |plain| per gradient;
# dA alone at 1e-3. dA sums dt da over every position of a head, each da
# a sum of differences of float32 cumsums of size ~10-1000 with heavy
# cancellation: on the H100 it read up to 7.8e-5 of max |dA| from the
# plain version (ragged S, bf16; this script's kernels phase), and
# on the CPU the plain version and the reference each sit ~1e-4 from a
# float64 recurrence (tests/test_torch_ssd_bwd.py)
B10_SCALED_TOL = {"dx": 1e-4, "ddt": 1e-4, "dA": 1e-3, "dB": 1e-4,
                  "dC": 1e-4}
# B10 bf16: dx, dB, dC come back in bf16 from float32 sums, so they read
# as one bf16 rounding of the plain version's (1.66e-3 to 1.69e-3 on the
# H100, as does the plain version rounded to bf16); the limit is about
# twice that, and the
# control, the plain version's gradients rounded to 3 mantissa bits, must
# read above it. ddt and dA are float32 on both routes (B10_SCALED_TOL).
B10_REL_L2_BF16 = 4e-3
B10_CONTROL_BITS = 3
# B9 at the new families' training shapes (one microbatch): hymba's
# sliding layers (window 2 048 at 4 096 tokens, D 64, 25 / 5 heads),
# paligemma's prefix (256 patches, 2 048 positions, D 256, 8 / 1), hubert's
# encoder (bidirectional, 2 x 1 500 frames, D 80, 16 / 16)
B9_MASK_SHAPES = (
    ("hymba_window", HYBRID_ARCH, (1, 4096, 25, 5, 64), True, 2048, 0),
    ("paligemma_prefix_d256", VLM_ARCH, (1, 2048, 8, 1, 256), True, None,
     256),
    ("hubert_bidirectional_d80", AUDIO_ARCH, (2, AUDIO_FRAMES, 16, 16, 80),
     False, None, 0))


# B9 at multi-head latent attention's (D, Dv) = (192, 128)
# (kernels.b9_mla), (B, S, H, causal) with Hkv = H: deepseek-v2's training
# microbatch (train_mla_full's), a ragged S, one token, and one
# bidirectional case. Heads are independent, so the plain version on the
# CPU is held to the first B9_MLA_PLAIN_HEADS heads: an eighth of the
# microbatch's host work
B9_MLA_CASES = ((1, 2048, 128, True), (2, 1000, 8, True), (2, 1, 4, True),
                (1, 300, 8, False))
B9_MLA_SHAPE = B9_MLA_CASES[0]
B9_MLA_PLAIN_HEADS = 16


def b9_bound(B, S, H, Hkv, D, dtype, live=None, Dv=None, Sk=None
             ) -> tuple[float, str]:
    """Least time for the attention backward of S queries over ``Sk``
    keys (S by default): q, k, v, o, do and lse read once, dq, dk, dv
    written once (q, k, dq, dk at head dim D; v, o, do, dv at ``Dv``, D by
    default); five matmuls over the live score entries -- ``live`` per
    (batch, head) (a mask's live pairs), the causal S(S+1)/2 by default --
    q k^T, dS^T Q and dS K at 2 D operations an entry, dO V^T and P^T dO at
    2 Dv."""
    import torch
    Dv = D if Dv is None else Dv
    Sk = S if Sk is None else Sk
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = el * (B * S * H + B * Sk * Hkv) * (2 * D + 2 * Dv) \
        + 4 * B * H * S
    live = S * (S + 1) / 2 if live is None else live
    flops = 2 * B * H * (3 * D + 2 * Dv) * live
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def b9_close_f32(got, want) -> bool:
    import torch
    got, want = got.float().cpu(), want.float()
    tol = B9_TOL_F32 * (max(float(want.abs().max()), 1.0) + want.abs())
    return bool(((got - want).abs() <= tol).all())


def check_attention_bwd_kernel(dev) -> dict:
    """B9 against its plain version (on the CPU copies of the same
    inputs), float32 and bf16, at the training shape and at ragged
    sequence lengths with head dims 128 and 64; B3's lse against the
    plain version's; a second call bit-identical. At the training shape
    bf16 is also held to ``B9_REL_L2_BF16`` beside its control, and both
    dtypes are timed beside the bound, the plain version (on the CPU) and
    the backward of one ``scaled_dot_product_attention``."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd, flash_attention_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [B9_MODEL_SHAPE] + [(2, S, 16, 2, D) for D in (128, 64)
                                for S in (1, 63, 65, 257, 1000)]
    out = {"cases": 0, "max_abs_err": {}, "lse_max_abs_err": 0.0,
           "bf16_rel_l2_max": 0.0, "model_shape": {}}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for B, S, H, Hkv, D in cases:
            q, k, v, do = (torch.randn(s, generator=gen, device=dev)
                           .to(dtype) for s in ((B, S, H, D), (B, S, Hkv, D),
                                                (B, S, Hkv, D), (B, S, H, D)))
            o, lse = flash_attention(q, k, v, return_lse=True)
            got = flash_attention_bwd(q, k, v, o, lse, do)
            again = flash_attention_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            what = f"flash_attention_bwd[{dn}, {(B, S, H, Hkv, D)}]"
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what}: a second call is not bit-identical")
            cpu = [t.cpu() for t in (q, k, v, o, lse, do)]
            _, lse_plain = flash_attention_plain(*cpu[:3], return_lse=True)
            e = max_abs(lse.cpu(), lse_plain)
            out["lse_max_abs_err"] = max(out["lse_max_abs_err"], e)
            check(torch.allclose(lse.cpu(), lse_plain, atol=1e-4, rtol=1e-5),
                  f"{what}: B3's lse differs from the plain version's by {e}")
            t0 = time.perf_counter()
            want = flash_attention_bwd_plain(*cpu)
            plain_s = time.perf_counter() - t0
            rels = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                check(g.shape == w.shape and g.dtype == dtype
                      and bool(torch.isfinite(g).all()),
                      f"{what}: {name} shape, dtype or finiteness")
                e = max_abs(g.float().cpu(), w.float())
                out["max_abs_err"][dn] = max(out["max_abs_err"].get(dn, 0.0),
                                             e)
                if dtype == torch.float32:
                    check(b9_close_f32(g, w), f"{what}: {name} differs by {e}")
                elif S > 1:  # a one-token dq, dk is 0: noise on both sides
                    rels[name] = b3_rel_l2(g.cpu(), w)
                    check(rels[name] <= B9_REL_L2_BF16,
                          f"{what}: {name} relative L2 {rels[name]} > "
                          f"{B9_REL_L2_BF16}")
            if rels:
                out["bf16_rel_l2_max"] = max(out["bf16_rel_l2_max"],
                                             *rels.values())
            out["cases"] += 1
            if (B, S, H, Hkv, D) == B9_MODEL_SHAPE:
                rec = time_b9(q, k, v, o, lse, do)
                rec["plain_ms"] = plain_s * 1e3
                rec["rel_l2"] = rels
                if dtype == torch.bfloat16:
                    # the plain version with P and dS rounded: bf16's
                    # rounding (7 bits), then the control
                    ctrl = {}
                    for bits in (7, B9_CONTROL_BITS):
                        alt = flash_attention_bwd_plain(*cpu, p_bits=bits,
                                                        ds_bits=bits)
                        ctrl[f"p_ds_{bits}_bits"] = {
                            name: b3_rel_l2(a, w) for name, a, w
                            in zip(("dq", "dk", "dv"), alt, want)}
                    rec["control_rel_l2"] = ctrl
                    rec["limit_rel_l2"] = B9_REL_L2_BF16
                    low = min(ctrl[f"p_ds_{B9_CONTROL_BITS}_bits"].values())
                    check(low > B9_REL_L2_BF16,
                          f"the control (P and dS at {B9_CONTROL_BITS} "
                          f"mantissa bits) reads {ctrl} <= "
                          f"{B9_REL_L2_BF16}: the limit cannot see a "
                          f"rounding fault")
                out["model_shape"][dn] = rec
            del q, k, v, do, o, lse, got, again, want, cpu
    return out


def time_b9(q, k, v, o, lse, do) -> dict:
    """B9 at the training shape beside its bound and the backward of one
    causal GQA ``scaled_dot_product_attention`` on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    try:
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        lib_in = (qt, kt, vt)
    except TypeError:  # a torch without enable_gqa: repeat the KV heads
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1).detach()
                  .requires_grad_() for t in (kt, vt))
        lib_out = F.scaled_dot_product_attention(qt, kr, vr, is_causal=True)
        lib_in = (qt, kr, vr)
    dot = do.transpose(1, 2)
    bound, by = b9_bound(B, S, H, Hkv, D, q.dtype)
    call = lambda: flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
    return {"shape": {"q": list(q.shape), "kv": list(k.shape),
                      "dtype": str(q.dtype)},
            "ms": event_ms(call, 10),
            "device_us": kernel_device_us(
                call, B9_KERNELS[str(q.dtype).split(".")[-1]]),
            "library_ms": event_ms(lambda: torch.autograd.grad(
                lib_out, lib_in, dot, retain_graph=True), 10),
            "library_note": "the backward of one causal GQA "
                            "scaled_dot_product_attention",
            "bound_ms": bound, "bound_by": by}


def b10_bound(B, S, H, P, G, N, dtype) -> tuple[float, str]:
    """Least time for the SSD scan's backward: x, dt, A, B, C and dy read
    once, dx, ddt, dA, dB, dC written once; the chunked form's products
    per (batch, head) and chunk of 64 -- the causal half of the chunk's
    C B^T, dy x^T and the three products that read it back (3 N + 2 P
    per pair), and five P N Q products (the entering state's recompute,
    C's and B's state terms, dH B, the state gradient's update) -- at
    the peak for x's type."""
    import torch
    Q = 64
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = 2 * el * (B * S * H * P + 2 * B * S * G * N) + 4 * (
        2 * B * S * H + 2 * B * H + B * S * H * P)
    chunks = -(-S // Q)
    fmas = B * H * chunks * (Q * (Q + 1) // 2 * (3 * N + 2 * P)
                             + 5 * P * N * Q)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S, 2 * fmas / peak
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def b10_inputs(gen, shape, dtype, dev, strong=False, state=False):
    """x, dt, A, B, C, dy, dstate at ``shape`` (B, S, nh, hd, G, N): dt a
    softplus of a normal draw and A in [-16, -1] (mamba2's init range), or,
    with ``strong``, dt ~ 10 and A = -16 (nothing survives a step); dstate
    a normal draw with ``state``, else None."""
    import torch
    import torch.nn.functional as F
    Bz, S, H, P, G, N = shape
    x = torch.randn((Bz, S, H, P), generator=gen, device=dev).to(dtype)
    if strong:
        dt = 10.0 + 0.1 * torch.rand((Bz, S, H), generator=gen, device=dev)
        A = torch.full((H,), -16.0, device=dev).expand(Bz, H)
    else:
        dt = F.softplus(torch.randn((Bz, S, H), generator=gen, device=dev))
        A = -(1.0 + 15.0 * torch.rand((H,), generator=gen,
                                      device=dev)).expand(Bz, H)
    B, C = ((0.3 * torch.randn((Bz, S, G, N), generator=gen, device=dev))
            .to(dtype) for _ in range(2))
    dy = torch.randn((Bz, S, H, P), generator=gen, device=dev)
    dstate = torch.randn((Bz, H, P, N), generator=gen, device=dev) \
        if state else None
    return x, dt, A, B, C, dy, dstate


def check_ssd_bwd_kernel(dev) -> dict:
    """B10 against its plain version (on the CPU copies of the same
    inputs, float32): at mamba2's and hymba's training shapes and
    ``B10_CASES``, float32 and bf16: every gradient
    within ``B10_SCALED_TOL`` of its largest value (the bf16 route's
    float32 outputs ddt, dA too), bf16 dx, dB, dC within
    ``B10_REL_L2_BF16`` relative L2 beside the control; a second call
    bit-identical. At the model shapes also timed beside its bound and
    the plain version, in all and kernel by kernel (device µs)."""
    import torch
    from repro_torch.kernels.flash_attention_bwd import _round_bits
    from repro_torch.kernels.ssd_scan_bwd import (ssd_scan_bwd,
                                                  ssd_scan_bwd_plain)
    gen = torch.Generator(device=dev).manual_seed(10)
    cases = [(a, shape, False, False) for a, shape in
             B10_MODEL_SHAPES.items()] + list(B10_CASES)
    out = {"cases": {}, "max_abs_err": {}, "model_shapes": {}}
    for name, shape, strong, state in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            what = f"ssd_scan_bwd[{name}, {dn}]"
            args = b10_inputs(gen, shape, dtype, dev, strong, state)
            got = ssd_scan_bwd(*args)
            again = ssd_scan_bwd(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{what}: a second call is not bit-identical")
            cpu = [None if t is None else t.cpu().float()
                   if t.dtype == torch.bfloat16 else t.cpu() for t in args]
            t0 = time.perf_counter()
            want = ssd_scan_bwd_plain(*cpu)
            plain_s = time.perf_counter() - t0
            rec = {"scaled_err": {}, "rel_l2": {}}
            for gname, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                   want):
                check(g.shape == w.shape and bool(torch.isfinite(g).all()),
                      f"{what}: {gname} shape or finiteness")
                g = g.float().cpu()
                out["max_abs_err"][dn] = max(out["max_abs_err"].get(dn, 0.0),
                                             max_abs(g, w))
                rec["rel_l2"][gname] = b3_rel_l2(g, w)
                if strong and gname == "dA":  # exp(-160) = 0: A moves nothing
                    check(float(g.abs().max()) == 0.0
                          and float(w.abs().max()) == 0.0,
                          f"{what}: dA is not 0 where nothing decays late")
                    continue
                if dtype == torch.bfloat16 and gname in ("dx", "dB", "dC"):
                    check(rec["rel_l2"][gname] <= B10_REL_L2_BF16,
                          f"{what}: {gname} relative L2 "
                          f"{rec['rel_l2'][gname]} > {B10_REL_L2_BF16}")
                    continue
                rec["scaled_err"][gname] = scaled_err(g, w)
                check(rec["scaled_err"][gname] <= B10_SCALED_TOL[gname],
                      f"{what}: {gname} scaled error "
                      f"{rec['scaled_err'][gname]} > {B10_SCALED_TOL[gname]}")
            if dtype == torch.bfloat16:
                ctrl = {f"grads_{bits}_bits": {
                    gname: b3_rel_l2(_round_bits(w, bits), w)
                    for gname, w in zip(("dx", "dB", "dC"),
                                        (want[0], want[3], want[4]))}
                    for bits in (7, B10_CONTROL_BITS)}
                rec["control_rel_l2"] = ctrl
                low = min(ctrl[f"grads_{B10_CONTROL_BITS}_bits"].values())
                check(low > B10_REL_L2_BF16,
                      f"{what}: the control reads {low} <= "
                      f"{B10_REL_L2_BF16}: the limit cannot see it")
            if name in B10_MODEL_SHAPES:
                bound, by = b10_bound(*shape, dtype)
                run = lambda: ssd_scan_bwd(*args)  # noqa: E731
                rec.update({"shape": {"x": list(args[0].shape),
                                      "B": list(args[3].shape),
                                      "dtype": str(dtype)},
                            "ms": event_ms(run, 5, warmup=1),
                            "device_us": kernel_device_us(run, B10_KERNELS),
                            "kernel_device_us": {
                                k: kernel_device_us(run, k)
                                for k in B10_KERNELS},
                            "plain_ms": plain_s * 1e3,
                            "plain_note": "the plain version on the CPU "
                                          "copies of the inputs",
                            "library_ms": None,
                            "library_note": "none exists: no PyTorch call "
                                            "computes the SSD scan or its "
                                            "backward",
                            "bound_ms": bound, "bound_by": by})
                out["model_shapes"].setdefault(name, {})[dn] = rec
            out["cases"][f"{name}/{dn}"] = rec
            del args, got, again, want, cpu
    return out


def b9_masked_case(q, k, v, do, mask: dict, what: str, timed: bool,
                   plain_heads=None) -> dict:
    """B9 on the card under ``mask`` against its plain version on the CPU
    copies (of the first ``plain_heads`` heads only, where given: heads
    are independent when H = Hkv): float32 within ``B9_TOL_F32``; bf16
    relative L2 within ``B9_REL_L2_BF16`` in each of dq, dk, dv (S > 1)
    beside the control (P and dS at ``B9_CONTROL_BITS``); B3's lse within
    1e-4 of the plain version's; a second call bit-identical. With
    ``timed`` also the times beside the live-pair bound and the backward
    of one ``scaled_dot_product_attention`` under the same mask -- causal
    order by its ``is_causal`` flag, another mask as the same boolean mask
    -- or its error, where ``sdpa`` refuses the inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd, flash_attention_bwd_plain)
    from repro_torch.kernels.ref import attention_mask
    B, S, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dtype = q.dtype
    o, lse = flash_attention(q, k, v, return_lse=True, **mask)
    got = flash_attention_bwd(q, k, v, o, lse, do, **mask)
    again = flash_attention_bwd(q, k, v, o, lse, do, **mask)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: a second call is not bit-identical")
    for name, g, t in zip(("dq", "dk", "dv"), got, (q, k, v)):
        check(g.shape == t.shape and g.dtype == dtype
              and bool(torch.isfinite(g).all()),
              f"{what}: {name} shape, dtype or finiteness")
    hs = H if plain_heads is None else min(H, plain_heads)
    cpu = [t[:, :, :hs].cpu() for t in (q, k, v, o)]
    cpu[3:] = [cpu[3], lse[:, :hs].cpu(), do[:, :, :hs].cpu()]
    _, lse_plain = flash_attention_plain(*cpu[:3], return_lse=True, **mask)
    rec = {"max_abs_err": 0.0, "rel_l2": {},
           "lse_max_abs_err": max_abs(cpu[4], lse_plain)}
    check(torch.allclose(cpu[4], lse_plain, atol=1e-4, rtol=1e-5),
          f"{what}: B3's lse differs from the plain version's by "
          f"{rec['lse_max_abs_err']}")
    if hs < H:
        rec["heads_compared"] = hs
    t0 = time.perf_counter()
    want = flash_attention_bwd_plain(*cpu, **mask)
    plain_s = time.perf_counter() - t0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g[:, :, :hs].cpu()
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 max_abs(g.float(), w.float()))
        if dtype == torch.float32:
            check(b9_close_f32(g, w), f"{what}: {name} differs by "
                                      f"{rec['max_abs_err']}")
        elif S > 1:  # a one-token dq, dk is 0: noise on both sides
            rec["rel_l2"][name] = b3_rel_l2(g, w)
            check(rec["rel_l2"][name] <= B9_REL_L2_BF16,
                  f"{what}: {name} relative L2 {rec['rel_l2'][name]} > "
                  f"{B9_REL_L2_BF16}")
    if dtype == torch.bfloat16 and S > 1:
        ctrl = {}
        # the 7-bit reading (bf16's own rounding) at the timed shapes only
        for bits in (7, B9_CONTROL_BITS) if timed else (B9_CONTROL_BITS,):
            alt = flash_attention_bwd_plain(*cpu, p_bits=bits, ds_bits=bits,
                                            **mask)
            ctrl[f"p_ds_{bits}_bits"] = {
                name: b3_rel_l2(a, w)
                for name, a, w in zip(("dq", "dk", "dv"), alt, want)}
            del alt
        rec["control_rel_l2"] = ctrl
        low = min(ctrl[f"p_ds_{B9_CONTROL_BITS}_bits"].values())
        check(low > B9_REL_L2_BF16, f"{what}: the control reads {low} <= "
                                    f"{B9_REL_L2_BF16}")
    del got, again, want, cpu
    if not timed:
        return rec
    ok = attention_mask(S, Sk, device=q.device, **mask)
    live = int(ok.sum())
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    # a causal mask by sdpa's own flag (its fastest form: self-attention,
    # the diagonal at the top left), another as the same boolean mask,
    # none where every pair is live
    causal_only = mask.get("causal") and mask.get("window") is None \
        and not mask.get("prefix_len") and not mask.get("q_offset") \
        and S == Sk
    sdpa = dict(is_causal=True) if causal_only else dict(
        attn_mask=None if bool(ok.all()) else ok)
    lib, lib_rec = None, {}
    try:
        try:
            lib_out = F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa)
            lib_in = (qt, kt, vt)
        except TypeError:  # a torch without enable_gqa: repeat the heads
            kr, vr = (t.repeat_interleave(H // Hkv, dim=1).detach()
                      .requires_grad_() for t in (kt, vt))
            lib_out = F.scaled_dot_product_attention(qt, kr, vr, **sdpa)
            lib_in = (qt, kr, vr)
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib_in, dot, retain_graph=True)
        lib_rec = {"library_ms": event_ms(lib, 5, warmup=2),
                   "library_kernels": device_kernel_names(lib)}
    except RuntimeError as e:
        lib_rec = {"library_ms": None,
                   "library_error": f"{type(e).__name__}: {e}"[:300]}
    bound, by = b9_bound(B, S, H, Hkv, D, dtype, live, Dv=Dv, Sk=Sk)
    call = lambda: flash_attention_bwd(q, k, v, o, lse, do,  # noqa: E731
                                       **mask)
    rec.update({"shape": {"q": list(q.shape), "kv": list(k.shape),
                          "v": list(v.shape), "dtype": str(dtype), **mask},
                "live_pairs": live, "ms": event_ms(call, 5, warmup=2),
                "device_us": kernel_device_us(
                    call, B9_KERNELS[str(dtype).split(".")[-1]]),
                "plain_ms": plain_s * 1e3,
                "plain_note": f"the plain version on the CPU copies of "
                              f"{hs} of the {H} heads",
                **lib_rec,
                "library_note": "the backward of one "
                                "scaled_dot_product_attention under the "
                                "same mask (causal by its flag)",
                "bound_ms": bound, "bound_by": by})
    del lib
    return rec


def check_b9_masks(dev) -> dict:
    """B9 under B3's ``B3_MASK_CASES`` -- a sliding window, a prefix,
    both, bidirectional attention, at head dims 64, 80 and 256 -- and at
    ``OFFSET_CASES``' query offsets, in both dtypes (``b9_masked_case``);
    timed at the new families' training shapes (``B9_MASK_SHAPES``) and
    at ``CHUNKED_PREFILL``'s offset (batch 1) in bf16."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(9)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = {"cases": {}, "model_shapes": {}, "offset_cases": {}}
    for name, B, S, H, Hkv, D, causal, window, prefix in B3_MASK_CASES:
        mask = dict(causal=causal, window=window, prefix_len=prefix)
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            q, do = rnd((B, S, H, D), dtype), rnd((B, S, H, D), dtype)
            k, v = rnd((B, S, Hkv, D), dtype), rnd((B, S, Hkv, D), dtype)
            out["cases"][f"{name}/{dn}"] = b9_masked_case(
                q, k, v, do, mask, f"flash_attention_bwd[{name}, {dn}]",
                False)
            del q, k, v, do
    for name, B, Sq, Sk, H, Hkv, D, mask in OFFSET_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            q, do = rnd((B, Sq, H, D), dtype), rnd((B, Sq, H, D), dtype)
            k, v = rnd((B, Sk, Hkv, D), dtype), rnd((B, Sk, Hkv, D), dtype)
            out["offset_cases"][f"{name}/{dn}"] = b9_masked_case(
                q, k, v, do, mask, f"flash_attention_bwd[{name}, {dn}]",
                False)
            del q, k, v, do
    _, Sq, Sk, H, Hkv, D, off = CHUNKED_PREFILL
    q, do = (rnd((1, Sq, H, D), torch.bfloat16) for _ in range(2))
    k, v = (rnd((1, Sk, Hkv, D), torch.bfloat16) for _ in range(2))
    out["chunked_prefill"] = b9_masked_case(
        q, k, v, do, dict(q_offset=off), "flash_attention_bwd[chunked "
        "prefill]", True)
    del q, k, v, do
    for name, arch, (B, S, H, Hkv, D), causal, window, prefix \
            in B9_MASK_SHAPES:
        mask = dict(causal=causal, window=window, prefix_len=prefix)
        dtype = torch.bfloat16
        q, do = rnd((B, S, H, D), dtype), rnd((B, S, H, D), dtype)
        k, v = rnd((B, S, Hkv, D), dtype), rnd((B, S, Hkv, D), dtype)
        out["model_shapes"][name] = {"arch": arch, **b9_masked_case(
            q, k, v, do, mask, f"flash_attention_bwd[{name}]", True)}
        del q, k, v, do
        torch.cuda.empty_cache()
    return out


def check_b9_mla(dev) -> dict:
    """B9 at multi-head latent attention's (D, Dv) = (192, 128) on
    ``mla_attention_inputs`` (v a stride-256 view, as ``blocks.mla_qkv``
    makes it), ``B9_MLA_CASES``, and at the reduced config's (24, 16)
    (``MLA_REDUCED_CASES``, v a stride-32 view), in both dtypes, each
    through ``b9_masked_case`` with the plain version on the first
    ``B9_MLA_PLAIN_HEADS`` heads; timed at deepseek-v2's training
    microbatch and at ``MLA_REDUCED_B9_SHAPE``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(27)
    out = {"cases": {}, "model_shape": {}, "max_abs_err": {},
           "lse_max_abs_err": 0.0, "reduced_cases": {},
           "reduced_shape": {}, "reduced_max_abs_err": {}}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        cases = [("", (128, 64, 128), c, B9_MLA_SHAPE) for c in
                 B9_MLA_CASES] + [("reduced_", MLA_REDUCED_DIMS, c,
                                   MLA_REDUCED_B9_SHAPE) for c in
                                  MLA_REDUCED_CASES + (MLA_REDUCED_B9_SHAPE,)]
        for key, dims, (B, S, H, causal), timed in cases:
            pair = (dims[0] + dims[1], dims[2])
            q, k, v = mla_attention_inputs(gen, B, S, H, dtype, dev, dims)
            do = torch.randn((B, S, H, pair[1]), generator=gen,
                             device=dev).to(dtype)
            model = (B, S, H, causal) == timed
            rec = b9_masked_case(
                q, k, v, do, dict(causal=causal, window=None, prefix_len=0),
                f"flash_attention_bwd[{pair}, {(B, S, H)}, "
                f"causal={causal}, {dn}]", model,
                plain_heads=B9_MLA_PLAIN_HEADS)
            out[f"{key}cases"][f"B={B},S={S},H={H},causal={causal}/{dn}"] \
                = rec
            errs = out[f"{key}max_abs_err"]
            errs[dn] = max(errs.get(dn, 0.0), rec["max_abs_err"])
            out["lse_max_abs_err"] = max(out["lse_max_abs_err"],
                                         rec["lse_max_abs_err"])
            if model:
                out["reduced_shape" if key else "model_shape"][dn] = rec
            del q, k, v, do
            torch.cuda.empty_cache()
    return out


def _numpy_train_state(params) -> dict:
    """A parameter tree as the JAX package's ``TrainState`` dumped to
    numpy (zero moments, step 0): what ``convert.train_state_from_numpy``
    takes."""
    import numpy as np
    from repro_torch.models.param import tree_map
    p = tree_map(lambda t: t.detach().cpu().numpy(), params)
    zeros = tree_map(np.zeros_like, p)
    return {"params": p, "opt_state": {"m": zeros, "v": zeros, "step": 0},
            "step": 0}


def cut_config(cfg, cut: dict):
    """``cfg`` with the fields of ``cut`` replaced; ``cut["moe"]``'s
    fields replace those of ``cfg.moe``."""
    import dataclasses
    cut = dict(cut)
    if "moe" in cut:
        cut["moe"] = dataclasses.replace(cfg.moe, **cut["moe"])
    return dataclasses.replace(cfg, **cut)


def train_cfg(arch: str):
    """The config a training path trains: the published one, cut by
    ``TRAIN_CUT`` where it has an entry."""
    from repro_torch.configs import get_arch
    cut = {k: v for k, v in TRAIN_CUT.get(arch, {}).items()
           if k != "reduced"}
    return cut_config(get_arch(arch), cut)


def host_peak_rss_bytes() -> int:
    """This process's peak resident set so far (Linux counts KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _leaf_rel(a, b) -> float:
    import torch
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / a.norm().clamp_min(1e-30))


def train_parity(card: str, arch: str = TRAIN_ARCH,
                 reduced: bool = False) -> dict:
    """``arch`` at full width cut to ``TRAIN_PARITY``'s depth (qwen2.5-3b:
    2 layers) -- or, with ``reduced``, its reduced config whole at
    ``TRAIN_PARITY``'s defaults (deepseek's MLA at head dims (24, 16)) --
    float32, from one ``train_state_from_numpy`` state on the
    card (B3 / B5 forward, B9 / B10 backward) and on the CPU (their plain
    forms): the loss and every gradient leaf of one backward, then 3
    ``make_train_step`` steps (``TRAIN_PARITY``'s ``steps``): losses and
    every parameter leaf after them. An MoE arch's routing is recorded on
    both sides (``RouteLog``) and must be the same: a difference fails the
    phase with the reference's top-(K+1) probability gap where it first
    shows."""
    import contextlib

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step

    cut = {} if reduced else TRAIN_PARITY.get(arch, {})
    cfg = get_arch(arch).reduced() if reduced else cut_config(
        get_arch(arch), {"n_layers": 2, **cut.get("config", {})})
    n_steps = cut.get("steps", 3)
    dump = _numpy_train_state(init_params(
        registry.param_specs(cfg), torch.Generator().manual_seed(2), "cpu"))
    zero_init = {p for p, a in tree_leaves(dump["params"]) if not a.any()}
    opt = AdamWConfig(total_steps=10, warmup_steps=2)
    shape = ShapeConfig("train_parity", cut.get("seq_len", 128),
                        cut.get("batch", 2), "train")
    side, routes = {}, {}
    reset_launches()
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        st = train_state_from_numpy(dump, device=dev)
        if dev == "cpu":  # the last leg: the host's two dumped trees go
            dump = None
        data = SyntheticDataset(cfg, shape, seed=3, device=dev)
        log = RouteLog() if cfg.moe else contextlib.nullcontext()
        with log:
            loss, _ = M.loss_fn(st.params, data.batch(0), cfg,
                                dtype=torch.float32)
            loss.backward()
            grads = {path: None if p.grad is None
                     else p.grad.detach().cpu()
                     for path, p in tree_leaves(st.params)}
            step = make_train_step(cfg, opt, dtype=torch.float32)
            losses = []
            for i in range(n_steps):
                st, m = step(st, data.batch(i))
                losses.append(float(m["loss"]))
        if cfg.moe:
            routes[dev] = log.tables()
        side[dev] = {"loss0": float(loss.detach()), "grads": grads,
                     "losses": losses,
                     "params": {path: p.detach().cpu()
                                for path, p in tree_leaves(st.params)},
                     "seconds": time.perf_counter() - t0}
        if dev == "cuda":
            launches = read_launches()
        del st, data, loss, grads
    route_rec = {}
    if cfg.moe:
        diff = route_diff(routes["cpu"], routes["cuda"], True)
        route_rec = {"routing": {k: v for k, v in diff.items()
                                 if k != "differs"}}
        check(diff["expert_slot_diffs"] == 0 and diff["drop_slot_diffs"] == 0,
              f"train_parity[{arch}]: the card routes otherwise than the "
              f"CPU: {route_rec['routing']}")
    card_, cpu_ = side["cuda"], side["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
        [card_["loss0"], *card_["losses"]], [cpu_["loss0"], *cpu_["losses"]]))
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"train_parity: card vs CPU loss differs by {loss_rel} relative")
    grad_rel = {"/".join(p): _leaf_rel(cpu_["grads"][p], g)
                for p, g in card_["grads"].items() if g is not None}
    check({"/".join(p) for p, g in card_["grads"].items() if g is None}
          == {"/".join(p) for p, g in cpu_["grads"].items() if g is None},
          "train_parity: the card and the CPU reach different leaves")
    worst_grad = max(grad_rel.values())
    check(worst_grad <= TRAIN_GRAD_TOL,
          f"train_parity[{arch}]: a gradient leaf differs by {worst_grad} "
          f"relative L2: {grad_rel}")
    param_rel = {p: _leaf_rel(cpu_["params"][p], t)
                 for p, t in card_["params"].items()}
    for p, r in param_rel.items():
        tol = TRAIN_ZERO_INIT_TOL if p in zero_init else TRAIN_PARAM_TOL
        check(r <= tol, f"train_parity: parameter leaf {p} differs by {r} "
                        f"relative L2 after {n_steps} steps (limit {tol})")
    # 1 backward and the steps, each layer's forward twice (remat "full")
    want = train_launches(cfg, 1 + n_steps)
    check(launches == want, f"train_parity launches {launches} != {want}")
    return {"card": card, "arch": arch, "layers": cfg.n_layers,
            "d_model": cfg.d_model,
            "reduced": "the reduced config" if reduced
            else cut.get("reduced", "depth"),
            "seq_len_batch": [shape.seq_len, shape.global_batch],
            "loss_max_rel": loss_rel, "grad_max_rel_l2": worst_grad,
            "param_max_rel_l2": max(r for p, r in param_rel.items()
                                    if p not in zero_init),
            "param_rel_l2_zero_init": {"/".join(p): param_rel[p]
                                       for p in sorted(zero_init)},
            "losses_card": [card_["loss0"], *card_["losses"]],
            "losses_cpu": [cpu_["loss0"], *cpu_["losses"]],
            "launches_card": launches, "steps": n_steps, **route_rec,
            "params": registry.count_params(cfg),
            "host_peak_rss_bytes": host_peak_rss_bytes(),
            "seconds": {d: side[d]["seconds"] for d in side},
            "tolerance": {"loss_rel": TRAIN_LOSS_RTOL,
                          "grad_rel_l2": TRAIN_GRAD_TOL,
                          "param_rel_l2": TRAIN_PARAM_TOL,
                          "param_rel_l2_zero_init": TRAIN_ZERO_INIT_TOL}}


def train_resume(card: str, arch: str = TRAIN_ARCH) -> dict:
    """``launch.train.run`` on the card, ``arch``'s reduced config, 8
    steps with a checkpoint every 2: uninterrupted; failed at step 5
    (the injected ``RuntimeError`` and nothing else); resumed from the
    step-4 checkpoint. The resumed run's last 3 losses must equal the
    uninterrupted run's bit for bit (``tests/test_system.py:21-32`` on
    the card). Every hand kernel of the arch's training path (B3 / B9,
    B5 / B10) must have launched."""
    import shutil
    import tempfile
    from repro_torch.launch.train import TrainLoopConfig, run
    scratch = os.path.join(HERE, "build", "chip_smoke_train_resume")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    try:
        cfg = TrainLoopConfig(arch=arch, steps=8, ckpt_dir=tmp,
                              checkpoint_every=2, log_every=100,
                              device="cuda")
        reset_launches()
        t0 = time.perf_counter()
        full = run(TrainLoopConfig(**{**vars(cfg), "ckpt_dir": ""}))
        full_s = time.perf_counter() - t0
        launches = read_launches()
        try:
            run(TrainLoopConfig(**{**vars(cfg), "fail_at_step": 5}))
        except RuntimeError as e:
            check("injected failure at step 5" in str(e),
                  f"train_resume: the failed run raised {e!r}")
        else:
            fail("train_resume: the run with fail_at_step=5 did not raise")
        resumed = run(cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(math.isfinite(x) for x in full["losses"]),
          f"train_resume: non-finite losses {full['losses']}")
    check(len(resumed["losses"]) == 4,
          f"train_resume: resumed {len(resumed['losses'])} steps, not 4")
    check(resumed["losses"][-3:] == full["losses"][-3:],
          f"train_resume: resumed losses {resumed['losses'][-3:]} != "
          f"uninterrupted {full['losses'][-3:]}")
    from repro_torch.configs import get_arch
    need = [k for k, n in train_launches(get_arch(arch).reduced(), 1).items()
            if n]
    check(all(launches[k] > 0 for k in need),
          f"train_resume[{arch}] did not launch each of {need}: {launches}")
    return {"card": card, "arch": arch, "reduced": True,
            "losses_full": full["losses"], "losses_resumed":
            resumed["losses"], "bit_identical_tail": True,
            "launches_uninterrupted": launches, "wall_s_uninterrupted": full_s}


def train_launches(cfg, passes: int) -> dict:
    """Every wrapper's count for ``passes`` training passes (a microbatch's
    forward and backward) of ``cfg`` under remat "full": each attention
    layer B3 twice (the forward and remat's recompute) and B9 once; each
    SSD layer B5 twice and B10 once; the hybrid's layers both."""
    L = cfg.n_layers
    want = expected_launches(None, 0)
    if cfg.family != "ssm":
        want["flash_attention"] = 2 * L * passes
        want["flash_attention_bwd"] = L * passes
    if cfg.ssm is not None:
        want["ssd_scan"] = 2 * L * passes
        want["ssd_scan_bwd"] = L * passes
    return want


def train_steps(cfg, path: dict, on_step) -> dict:
    """``launch.train.run``'s loop on a config of its own (``TRAIN_CUT``:
    ``TrainLoopConfig`` names an arch and takes no config), from the same
    pieces -- ``init_params`` from seed 0 on the card, ``TrainState.create``,
    ``SyntheticDataset`` (seed 0), ``make_train_step`` (remat "full") --
    with the same clock around each step and its loss. Returns
    ``{"losses", "step_s"}``."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, train_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainState, make_train_step
    opt = AdamWConfig(lr_peak=3e-4, warmup_steps=2,
                      total_steps=max(10, path["steps"]))
    data = SyntheticDataset(cfg, ShapeConfig(
        "train_custom", path["seq_len"], path["global_batch"], "train"),
        seed=0, device="cuda")
    step_fn = make_train_step(cfg, opt, microbatches=path["microbatches"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = TrainState.create(train_params(init_params(
        registry.param_specs(cfg), gen, "cuda")), opt)
    losses, step_s = [], []
    for step in range(path["steps"]):
        t0 = time.time()
        state, metrics = step_fn(state, data.batch(step))
        loss = float(metrics["loss"])  # waits for the step
        dt = time.time() - t0
        losses.append(loss)
        step_s.append(dt)
        on_step(step, metrics, dt)
    return {"losses": losses, "step_s": step_s}


def train_full(card: str, arch: str = TRAIN_ARCH, path=None) -> dict:
    """``launch.train.run`` on ``arch`` at full width, all its layers
    (deepseek-v2-236b: ``train_steps`` on ``TRAIN_CUT``'s config): bf16
    compute on float32 master weights, AdamW, ``path`` (default
    ``TRAIN_FULL``). Each step must launch exactly ``train_launches``
    (qwen2.5-3b: B3 36 x 2 x 2 times -- the forward and remat's
    recompute, per microbatch -- and B9 36 x 2 times), and nothing
    else. tokens/s counts every position (a vision arch's patches too;
    an audio arch's are frames); the MFU counts the parameters a token
    passes through (an MoE arch's top-k experts, not its whole bank)."""
    import torch
    from repro_torch.launch.train import TrainLoopConfig, run
    from repro_torch.models import registry
    path = dict(TRAIN_FULL if path is None else path)
    cfg = train_cfg(arch)
    L, M = cfg.n_layers, path["microbatches"]
    want = train_launches(cfg, M)
    per_step = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prev = read_launches()

    def on_step(step, metrics, seconds):
        nonlocal prev
        now = read_launches()
        per_step.append({k: now[k] - prev[k] for k in now})
        prev = now

    t0 = time.perf_counter()
    if arch in TRAIN_CUT:
        out = train_steps(cfg, path, on_step)
    else:
        out = run(TrainLoopConfig(arch=arch, reduced=False, device="cuda",
                                  log_every=1, **path), on_step=on_step)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in out["losses"]),
          f"train_full: non-finite losses {out['losses']}")
    for i, got in enumerate(per_step):
        check(got == want, f"train_full step {i}: launches {got} != {want}")
    n_params = registry.count_params(cfg)
    n_active = registry.count_params(cfg, active_only=True)
    tokens = path["global_batch"] * path["seq_len"]
    steady = min(out["step_s"][1:])
    return {"card": card, "arch": arch, "layers": L,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            **({"reduced": TRAIN_CUT[arch]["reduced"]}
               if arch in TRAIN_CUT else {}),
            **({"experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k}
               if cfg.moe else {}),
            "params": n_params, "params_active": n_active, **path,
            "remat": "full", "dtype": "bfloat16",
            "losses": out["losses"], "step_s": out["step_s"],
            "first_step_s": out["step_s"][0], "steady_s_per_step": steady,
            "tokens_per_s": tokens / steady,
            "mfu": 6 * n_active * tokens / steady / BF16_FLOPS_PER_S,
            "mfu_note": "6 x active parameters x tokens a step over the "
                        "step, against 989 TFLOP/s (bf16 dense)",
            "peak_memory_bytes": peak, "launches": launches,
            "launches_per_step": per_step[0], "wall_s": wall,
            **({"frames_per_s": tokens / steady}
               if cfg.frontend == "audio" else {}),
            **({"text_tokens_per_s": path["global_batch"] * (
                path["seq_len"] - cfg.frontend_seq) / steady}
               if cfg.frontend == "vision" else {})}


def profile_train(hand: tuple[str, ...], arch: str = TRAIN_ARCH,
                  path=None) -> dict:
    """One warm ``train_step`` of ``arch`` at full width on ``path``
    (default ``TRAIN_FULL``, ``train_full``'s configuration), cut to
    ``PROFILE_TRAIN_LAYERS``' depth where it has an entry, under the
    profiler: busy share, top device ops, the hand kernels' device time a
    launch."""
    import gc

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, train_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import TrainState, make_train_step
    import dataclasses
    gc.collect()
    torch.cuda.empty_cache()
    path = TRAIN_FULL if path is None else path
    cfg = train_cfg(arch)
    full_layers = cfg.n_layers
    if arch in PROFILE_TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=PROFILE_TRAIN_LAYERS[arch])
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {"st": TrainState.create(train_params(init_params(
        registry.param_specs(cfg), gen, "cuda")), opt)}
    step = make_train_step(cfg, opt, microbatches=path["microbatches"])
    data = SyntheticDataset(cfg, ShapeConfig(
        "train_full", path["seq_len"], path["global_batch"], "train"),
        device="cuda")

    def one(i=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["st"], m = step(state["st"], data.batch(i))
        float(m["loss"])
        return time.perf_counter() - t0

    one(0)  # warm-up
    rec = profile_run(one, hand, top=10)
    rec["layers"] = cfg.n_layers
    if cfg.n_layers != full_layers:
        rec["reduced"] = f"depth {full_layers} -> {cfg.n_layers} layers"
    del state["st"]
    gc.collect()
    torch.cuda.empty_cache()
    hand = rec.get("hand_kernels", {})
    for key, names in (("b9", B9_KERNELS["bfloat16"]), ("b10", B10_KERNELS)):
        us = [next((v["device_us_per_launch"] for name, v in hand.items()
                    if k in name), None) for k in names]
        rec[f"{key}_device_us_per_call"] = sum(us) if None not in us \
            else None
    if rec.get("device_busy_s"):
        rec["b9_share_of_busy"] = sum(
            v["device_us_total"] for name, v in hand.items()
            if "attention_bwd" in name) * 1e-6 / rec["device_busy_s"]
    return rec


# ---- the parallel and analysis slice (A9a) --------------------------------
DRYRUN_DIR = os.path.join(HERE, "build", "chip_smoke_dryrun")
# train_mesh: train_full's cell on a one-card mesh, 3 steps
MESH_STEPS = 3
# the dry runs, each in a child process: train_full's cell on a (1, 1)
# fake mesh, and deepseek-v2-236b's production cell at all 60 layers
DRY_RUNS = {
    "card": dict(arch=TRAIN_ARCH, shape_name="train_card",
                 shape=("train_card", TRAIN_FULL["seq_len"],
                        TRAIN_FULL["global_batch"], "train"),
                 mesh_shape=(1, 1),
                 microbatches=TRAIN_FULL["microbatches"]),
    "production": dict(arch=MLA_ARCH, shape_name="train_4k"),
}
DRY_RUN_TIMEOUT_S = 900
DRYRUN_FLOPS_RTOL = 1e-9
FLOPS_RATIO_RANGE = (0.5, 1.05)
MEMORY_BAND = 0.25  # predicted peak within 25 % of the measured one
# one child runs the cells in turn on one core of its own, which this
# process gives up while the child lives: the card's host-bound phases
# keep the other cores to themselves
_DRY_RUN_CHILD = """
import json, os, sys, time
core = int(sys.argv[2])
if core >= 0:
    os.sched_setaffinity(0, {core})
import torch
torch.set_num_threads(1)  # fake tensors compute nothing
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import run_cell
for name, kw in json.loads(sys.argv[1]).items():
    if "shape" in kw:
        kw["shape"] = ShapeConfig(*kw["shape"])
    if "mesh_shape" in kw:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    t0 = time.perf_counter()
    r = run_cell(dump=False, **kw)
    r["child_wall_s"] = time.perf_counter() - t0
    out = os.path.join(sys.argv[3], name + ".json")
    with open(out + ".part", "w") as f:
        json.dump(r, f, default=str)
    os.replace(out + ".part", out)
"""
_CHILDREN: list = []
#: this process's cores and threads before the child took a core
_MAIN_CORES: list = []


def _stop_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


atexit.register(_stop_children)


def _set_cores(cores) -> None:
    """Pin every thread of this process to ``cores``."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cores)
        except OSError:  # a thread that has ended
            pass


def start_dry_runs() -> dict:
    """Start ``DRY_RUNS`` in one child process that sees no card (a fake
    world on the CPU: nothing there touches the card), the cells in
    turn, each cell's JSON in ``DRYRUN_DIR`` as it ends. With 4 cores or
    more the child takes the last one and this process's threads leave
    it (``finish_dry_run`` gives it back). Returns the child's record."""
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(HERE, "src"),
                    os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    for name in DRY_RUNS:
        out = os.path.join(DRYRUN_DIR, f"{name}.json")
        if os.path.exists(out):
            os.remove(out)
    cores = sorted(os.sched_getaffinity(0))
    core = -1
    if len(cores) >= 4:
        import torch
        core = cores[-1]
        _MAIN_CORES[:] = [cores, torch.get_num_threads()]
        _set_cores(set(cores[:-1]))
        torch.set_num_threads(min(_MAIN_CORES[1], len(cores) - 1))
    log = open(os.path.join(DRYRUN_DIR, "child.log"), "w")
    p = subprocess.Popen([sys.executable, "-c", _DRY_RUN_CHILD,
                          json.dumps(DRY_RUNS), str(core), DRYRUN_DIR],
                         cwd=HERE, env=env, stdout=log,
                         stderr=subprocess.STDOUT)
    _CHILDREN.append(p)
    return {"process": p, "log": log, "core": core,
            "started": time.perf_counter()}


def finish_dry_run(child: dict, name: str) -> dict:
    """One cell's JSON from the dry-run child, waiting for the cell; once
    the child has ended, this process has its cores back."""
    p, log = child["process"], child["log"]
    out = os.path.join(DRYRUN_DIR, f"{name}.json")
    t0 = time.perf_counter()
    deadline = child["started"] + DRY_RUN_TIMEOUT_S
    while not os.path.exists(out) and p.poll() is None \
            and time.perf_counter() < deadline:
        time.sleep(0.5)
    if not os.path.exists(out) or name == list(DRY_RUNS)[-1]:
        try:  # the last cell's child is about to exit
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    if p.poll() is not None and _MAIN_CORES:
        import torch
        _set_cores(set(_MAIN_CORES[0]))
        torch.set_num_threads(_MAIN_CORES[1])
        _MAIN_CORES.clear()
    waited = time.perf_counter() - t0
    log.flush()
    with open(log.name) as f:
        tail = f.read()[-3000:]
    check(os.path.exists(out),
          f"dry run {name}: exit {p.poll()}: {tail}")
    with open(out) as f:
        rec = json.load(f)
    rec["waited_s"] = waited
    rec["child_core"] = child["core"]
    check(rec["status"] == "ok",
          f"dry run {name}: {rec['status']} {rec.get('traceback', '')}")
    return rec


def mesh_step_probe(hand: tuple[str, ...]) -> dict:
    """train_full's cell on a one-card (1, 1) mesh, through the pieces
    ``run`` uses: a warm step, one counted by ``CostCounter`` (the kernels
    launched: the formulas they report stand for them), and one under
    the profiler (the device's busy time)."""
    import gc

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.costs import CostCounter
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, train_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.dist import (make_mesh, single_process_world,
                                           use_mesh)
    from repro_torch.parallel.sharding import RULE_VARIANTS, use_rules
    from repro_torch.train.steps import (TrainState, make_train_step,
                                         place_batch, place_state)
    path = TRAIN_FULL
    cfg = train_cfg(TRAIN_ARCH)
    rules = RULE_VARIANTS["baseline"]
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    with single_process_world("cuda"):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        with use_mesh(mesh), use_rules(rules):
            gen = torch.Generator(device="cuda").manual_seed(0)
            st = {"st": place_state(TrainState.create(train_params(
                init_params(registry.param_specs(cfg), gen, "cuda")), opt),
                cfg, rules, mesh)}
            step = make_train_step(cfg, opt,
                                   microbatches=path["microbatches"])
            data = SyntheticDataset(cfg, ShapeConfig(
                "train_card", path["seq_len"], path["global_batch"],
                "train"), device="cuda")

            def one(i):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b = place_batch(data.batch(i), rules, mesh,
                                path["microbatches"])
                st["st"], m = step(st["st"], b)
                float(m["loss"])
                return time.perf_counter() - t0

            one(0)
            counter = CostCounter(track_memory=False)
            with counter:
                counted_s = one(1)
            prof = profile_run(lambda: one(2), hand)
            del st["st"]
    gc.collect()
    torch.cuda.empty_cache()
    c = counter.costs
    return {"counted_flops": c.flops, "counted_memory_bytes": c.memory_bytes,
            "counted_collective_bytes": c.collective_bytes,
            "counted_kernels": c.kernels, "counted_dots": c.dots,
            "counted_step_s": counted_s,
            "device_busy_s": prof.get("device_busy_s"),
            "wall_s_profiled": prof.get("wall_s_profiled"),
            "device_idle_share": prof.get("device_idle_share"),
            "profile_error": prof.get("error")}


def train_mesh(card: str, full: dict) -> dict:
    """``launch.train.run`` on a one-card ``DeviceMesh`` (``mesh="1x1"``,
    rules baseline): train_full's arch, settings and seed, ``MESH_STEPS``
    steps. The losses must equal train_full's first ones bit for bit and
    each step launch exactly ``train_launches`` (144 B3, 72 B9); s/step
    and peak memory beside train_full's."""
    import torch
    from repro_torch.launch.train import TrainLoopConfig, run
    path = dict(TRAIN_FULL, steps=MESH_STEPS)
    cfg = train_cfg(TRAIN_ARCH)
    want = train_launches(cfg, path["microbatches"])
    per_step = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prev = read_launches()

    def on_step(step, metrics, seconds):
        nonlocal prev
        now = read_launches()
        per_step.append({k: now[k] - prev[k] for k in now})
        prev = now

    t0 = time.perf_counter()
    out = run(TrainLoopConfig(arch=TRAIN_ARCH, reduced=False, device="cuda",
                              log_every=1, mesh="1x1", rules="baseline",
                              **path), on_step=on_step)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(out["losses"] == full["losses"][:MESH_STEPS],
          f"train_mesh: losses {out['losses']} != train_full's "
          f"{full['losses'][:MESH_STEPS]}")
    for i, got in enumerate(per_step):
        check(got == want, f"train_mesh step {i}: launches {got} != {want}")
    steady = min(out["step_s"][1:])
    return {"card": card, "arch": TRAIN_ARCH, "mesh": "1x1",
            "rules": "baseline", **path, "losses": out["losses"],
            "losses_equal_train_full": True, "step_s": out["step_s"],
            "steady_s_per_step": steady,
            "train_full_steady_s_per_step": full["steady_s_per_step"],
            "peak_memory_bytes": peak,
            "train_full_peak_memory_bytes": full["peak_memory_bytes"],
            "launches_per_step": per_step[0], "wall_s": wall}


def dryrun_card(card: str, mesh_rec: dict, probe: dict, fake: dict) -> dict:
    """The dry run of train_mesh's cell on a (1, 1) fake mesh beside the
    measured run: the FLOPs counted on the card with the kernels launched
    equal the fake count (``DRYRUN_FLOPS_RTOL``), ``flops_ratio`` in
    ``FLOPS_RATIO_RANGE``, the predicted peak within ``MEMORY_BAND`` of
    ``torch.cuda.max_memory_allocated``; the roofline's step time (the
    H100 SXM's public figures) beside the measured busy time."""
    rel = abs(probe["counted_flops"] - fake["flops"]) / fake["flops"]
    check(rel <= DRYRUN_FLOPS_RTOL,
          f"dryrun_card: counted {probe['counted_flops']} FLOPs on the "
          f"card, {fake['flops']} under fake tensors")
    check(probe["counted_kernels"] == fake["kernels"],
          f"dryrun_card: kernels {probe['counted_kernels']} on the card, "
          f"{fake['kernels']} under fake tensors")
    lo, hi = FLOPS_RATIO_RANGE
    check(lo < fake["flops_ratio"] <= hi,
          f"dryrun_card: flops_ratio {fake['flops_ratio']}")
    measured = mesh_rec["peak_memory_bytes"]
    mem_rel = (fake["peak_bytes"] - measured) / measured
    check(abs(mem_rel) <= MEMORY_BAND,
          f"dryrun_card: predicted {fake['peak_bytes']} B, measured "
          f"{measured} B")
    return {"card": card, "arch": fake["arch"], "mesh": fake["mesh"],
            "flops_counted_card": probe["counted_flops"],
            "flops_fake": fake["flops"], "flops_rel_diff": rel,
            "kernels": fake["kernels"], "dots_card": probe["counted_dots"],
            "dots_fake": fake["dots"],
            "memory_bytes_counted_card": probe["counted_memory_bytes"],
            "memory_bytes_fake": fake["memory_bytes"],
            "flops_ratio": fake["flops_ratio"],
            "predicted_peak_gib": fake["peak_bytes"] / 2 ** 30,
            "measured_peak_gib": measured / 2 ** 30,
            "peak_rel_diff": mem_rel,
            "roofline_step_time_s": fake["step_time_s"],
            "roofline_terms_s": {k: fake[k] for k in
                                 ("compute_s", "memory_s", "collective_s")},
            "dominant": fake["dominant"],
            "roofline_fraction": fake["roofline_fraction"],
            "measured_busy_s": probe["device_busy_s"],
            "measured_step_s": probe["wall_s_profiled"],
            "measured_idle_share": probe["device_idle_share"],
            "target": fake["target"], "dry_run_wall_s": fake["wall_s"],
            "dry_run_child_wall_s": fake["child_wall_s"],
            "modeled": "roofline terms drawn for the H100 SXM's public "
                       "figures (989 TFLOP/s bf16, 3.35 TB/s, 900 GB/s)"}


def production_argument_bytes(cfg, rules_name: str = "baseline") -> int:
    """The per-device argument bytes of ``cfg``'s train_4k step on the
    (16, 16) mesh from the resolved specs alone: each parameter's local
    shard in float32 and its two moments in the cell's moment dtype, the
    token and label ids' local rows (int64), the two int32 step
    counters."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.data.specs import BATCH_AXES, batch_specs
    from repro_torch.launch.dryrun import train_overrides
    from repro_torch.models import registry
    from repro_torch.models.param import tree_leaves
    from repro_torch.parallel.sharding import (RULE_VARIANTS, act_pspec,
                                               local_shape, param_pspec)
    sizes = {"data": 16, "model": 16}
    rules = RULE_VARIANTS[rules_name]
    mom = torch.empty((), dtype=train_overrides(cfg.name)[
        "moment_dtype"]).element_size()
    total = 8
    for _, s in tree_leaves(registry.param_specs(cfg)):
        n = math.prod(local_shape(param_pspec(rules, s.axes, s.shape, sizes),
                                  s.shape, sizes))
        total += n * (4 + 2 * mom)
    for k, s in batch_specs(cfg, SHAPES["train_4k"]).items():
        n = math.prod(local_shape(act_pspec(rules, BATCH_AXES[k], s.shape,
                                            sizes), s.shape, sizes))
        total += n * (8 if not s.dtype.is_floating_point else 2)
    return total


def dryrun_production(card: str, rec: dict) -> dict:
    """deepseek-v2-236b's train_4k cell at all 60 layers on the (16, 16)
    fake mesh, the MoE dispatch the default (``--moe gspmd``, the
    reference's): ok, and its per-device argument bytes
    (the fake shards the counter holds) equal to the local shards the
    resolved specs give (``production_argument_bytes``)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(MLA_ARCH)
    want = production_argument_bytes(cfg)
    check(rec["layers"] == cfg.n_layers == 60,
          f"dryrun_production: {rec['layers']} layers")
    check(rec["argument_bytes_tracked"] == rec["argument_bytes"] == want,
          f"dryrun_production: argument bytes {rec['argument_bytes']} "
          f"(held {rec['argument_bytes_tracked']}), the specs give {want}")
    return {"card": card, "arch": MLA_ARCH, "shape": "train_4k",
            "mesh": rec["mesh"], "chips": rec["chips"],
            "layers": rec["layers"], "moe": rec["moe"],
            "status": rec["status"], "argument_bytes": want,
            "gib_per_device": rec["hbm_gb_per_device"],
            "fits_80gb": rec["fits"],
            "terms_s": {k: rec[k] for k in ("compute_s", "memory_s",
                                            "collective_s")},
            "collective_bytes": rec["collective_bytes"],
            "dominant": rec["dominant"], "step_time_s": rec["step_time_s"],
            "roofline_fraction": rec["roofline_fraction"],
            "flops_ratio": rec["flops_ratio"], "kernels": rec["kernels"],
            "microbatches": rec["microbatches"], "target": rec["target"],
            "dry_run_wall_s": rec["wall_s"],
            "child_wall_s": rec["child_wall_s"],
            "waited_s": rec["waited_s"], "child_core": rec["child_core"],
            "modeled": "for the H100 SXM's public figures, not measured"}


def moe_backward_bits(card: str, arch: str = MOE_ARCH,
                      seq_len: int = 2048) -> dict:
    """Two backward passes of one microbatch (1 x ``seq_len`` tokens) of
    ``arch`` at full width on the card, as a training step takes it (bf16
    compute on float32 masters, remat "full"): every gradient leaf must be
    bit-identical. The MoE combine's backward is an accumulating
    ``index_put_`` into the expert outputs, whose order CUDA does not fix;
    its only repeated indices are the dropped slots', whose gradients are
    exactly 0, so the sums are exact in any order."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import (init_params, train_params,
                                          tree_leaves)
    torch.cuda.empty_cache()
    cfg = train_cfg(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = train_params(init_params(registry.param_specs(cfg), gen,
                                      "cuda"))
    batch = SyntheticDataset(cfg, ShapeConfig("bits", seq_len, 1, "train"),
                             seed=0, device="cuda").batch(0)
    leaves = [p for _, p in tree_leaves(params)]
    grads, losses = [], []
    t0 = time.perf_counter()
    with RouteLog() as log:
        for _ in range(2):
            for p in leaves:
                p.grad = None
            loss, _ = M.loss_fn(params, batch, cfg)
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append([None if p.grad is None else p.grad.clone()
                          for p in leaves])
    seconds = time.perf_counter() - t0
    tables = log.tables()
    differ = [path for (path, _), a, b in zip(tree_leaves(params), *grads)
              if not ((a is None and b is None) or torch.equal(a, b))]
    check(not differ, f"moe_backward_bits[{arch}]: two backward passes "
                      f"differ in {len(differ)} leaves: {differ[:5]}")
    check(losses[0] == losses[1] and math.isfinite(losses[0]),
          f"moe_backward_bits[{arch}]: losses {losses}")
    out = {"card": card, "arch": arch, "layers": cfg.n_layers,
           "tokens": seq_len, "leaves": len(leaves),
           "leaves_bit_identical": len(leaves) - len(differ),
           "loss": losses[0], "seconds": seconds,
           # each pass logs every MoE layer's forward and remat's recompute
           "dropped_slots_per_pass": int(sum(
               (~t["kept"]).sum() for t in tables)) // 2,
           "slots_per_pass": int(sum(t["kept"].size for t in tables)) // 2}
    del params, grads, leaves, batch
    torch.cuda.empty_cache()
    return out


# train_moe_mesh (A9c): granite-moe-1b-a400m trained on meshes through
# launch.train under its default MoE dispatch, GSPMD's (the whole group's
# capacity and drops): (a) a one-rank (1, 1) mesh at train_moe_full's path
# for MESH_STEPS steps; (b) a (2, 1) data mesh of 2 ranks on the one card
# (gloo through the host), beside the unsharded run of MOE_MESH_PATH and a
# float32 forward of its first batch on both, whose routings are held
# together; (c) the same mesh under shard_map, its first step. MOE_MESH_PATH
# is train_moe_full's 2 x 2 048 tokens in one microbatch: a data shard's
# one sequence cannot split into 2
MOE_MESH_PATH = dict(seq_len=2048, global_batch=2, microbatches=1, steps=2)
MOE_MESH_DIR = os.path.join(HERE, "build", "chip_smoke_moe_mesh")
MOE_MESH_TIMEOUT_S = 420
# (b)'s losses against the unsharded run's, relative. Only bf16's reduce
# order separates the two: a rank's matmuls over 2 048 rows round otherwise
# than the unsharded run's over 4 096, which flips top-k choices at near
# ties (the float32 forward routes alike but for ties) and moves the mean
# over 4 096 tokens by far less than a capacity rule that keeps other
# slots: shard_map's moves the first loss past this (PERF.md, train_moe_mesh)
MOE_MESH_LOSS_RTOL = 1e-4


def _host_calls(calls) -> list:
    """``RouteLog`` calls with their tensors copied to the host."""
    return [(shape, cfg, [tuple(t.cpu() for t in g) for g in groups])
            for shape, cfg, groups in calls]


def moe_train_run(path: dict, mesh: str = "", routes: bool = False):
    """``launch.train.run`` on granite-moe-1b-a400m at full width, ``path``
    (``TrainLoopConfig``'s shape and steps), on ``mesh`` ("" for none):
    losses, s/step, peak memory and every wrapper's launches a step; with
    ``routes`` also the routing of the first step's MoE calls (``RouteLog``
    calls on the host: each call's routing and the dispatch's keep)."""
    import torch
    from repro_torch.launch.train import TrainLoopConfig, run
    per_step, first = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prev = read_launches()
    log = RouteLog() if routes else contextlib.nullcontext()

    def on_step(step, metrics, seconds):
        nonlocal prev
        now = read_launches()
        per_step.append({k: now[k] - prev[k] for k in now})
        prev = now
        if routes:
            if step == 0:
                first.extend(_host_calls(log.calls))
            log.calls.clear()

    t0 = time.perf_counter()
    with log:
        out = run(TrainLoopConfig(arch=MOE_ARCH, reduced=False,
                                  device="cuda", log_every=path["steps"],
                                  mesh=mesh, **path), on_step=on_step)
    wall = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in out["losses"]),
          f"train_moe_mesh: non-finite losses {out['losses']} ({mesh})")
    rec = {"losses": out["losses"], "step_s": out["step_s"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches_per_step": per_step, "wall_s": wall}
    torch.cuda.empty_cache()
    return (rec, first) if routes else rec


def moe_f32_routes(mesh=None) -> list:
    """The routing of a float32 forward of MOE_MESH_PATH's first batch on
    launch.train's initial weights (seed 0), on ``mesh`` (a DeviceMesh,
    the baseline rules) or on one card: ``RouteLog`` calls on the host.
    Its rounding is float32's, so two runs' routings differ only at ties
    (``route_diff`` with ``f32``)."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params, train_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.dist import use_mesh
    from repro_torch.parallel.sharding import RULE_VARIANTS, use_rules
    from repro_torch.train.steps import (TrainState, place_batch,
                                         place_state)
    cfg = train_cfg(MOE_ARCH)
    rules = RULE_VARIANTS["baseline"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = TrainState.create(train_params(init_params(
        registry.param_specs(cfg), gen, "cuda")), AdamWConfig())
    batch = SyntheticDataset(cfg, ShapeConfig(
        "train_custom", MOE_MESH_PATH["seq_len"],
        MOE_MESH_PATH["global_batch"], "train"), seed=0,
        device="cuda").batch(0)
    ctx = contextlib.nullcontext() if mesh is None else \
        contextlib.ExitStack()
    with ctx, torch.no_grad(), RouteLog() as log:
        if mesh is not None:
            for c in (use_mesh(mesh), use_rules(rules),
                      implicit_replication()):
                ctx.enter_context(c)
            state = place_state(state, cfg, rules, mesh)
            batch = place_batch(batch, rules, mesh)
        M.loss_fn(state.params, batch, cfg, remat="none",
                  dtype=torch.float32)
        calls = _host_calls(log.calls)
    del state, batch
    torch.cuda.empty_cache()
    return calls


def _save_calls(out_dir: str, tag: str, rank: int, calls) -> None:
    import numpy as np
    arrays = {}
    for i, (_, _, groups) in enumerate(calls):
        for j, name in enumerate(("probs", "idx", "keep")):
            arrays[f"{i}/{name}"] = np.concatenate(
                [g[j].numpy() for g in groups])
    _mesh_save(out_dir, tag, rank, arrays)


@contextlib.contextmanager
def gloo_list_all_gathers():
    """Inside the block, a functional all-gather of a CUDA tensor over a
    gloo group (DTensor's Shard -> Replicate: FSDP's gather of a layer's
    weights) runs as ``dist.all_gather``'s list form, then a
    concatenation. torch 2.11's gloo ends the process with a segmentation
    fault in the tensor form (``all_gather_into_tensor``) on CUDA
    tensors, float32 and bf16 alike, where it takes the list form
    (``TorchBackend.all_gather``) and the all-reduce and reduce-scatter
    DTensor also issues (PERF.md, train_moe_mesh). Other tensors
    and groups keep torch's own path."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    names = [n for n in ("all_gather_tensor", "all_gather_single")
             if hasattr(funcol, n)]
    orig = {n: getattr(funcol, n) for n in names}

    def listed(name):
        def gather(t, gather_dim, group, tag=""):
            pg = group.get_group(0) if type(group).__name__ == "DeviceMesh" \
                else group[0].get_group(group[1]) \
                if isinstance(group, tuple) else group
            if not (t.is_cuda and isinstance(pg, dist.ProcessGroup)
                    and dist.get_backend(pg) == "gloo"):
                return orig[name](t, gather_dim, group, tag)
            parts = [torch.empty_like(t) for _ in range(pg.size())]
            dist.all_gather(parts, t.contiguous(), group=pg)
            return funcol._maybe_wrap_tensor(torch.cat(parts, gather_dim))
        return gather

    for n in names:
        setattr(funcol, n, listed(n))
    try:
        yield
    finally:
        for n in names:
            setattr(funcol, n, orig[n])


def moe_mesh_child(rank: int, world: int, port: int, out_dir: str) -> int:
    """One rank of train_moe_mesh's (2, 1) world (``chip_smoke.py
    --moe-mesh-rank``): joins the world, then ``moe_train_run`` at
    MOE_MESH_PATH on the data mesh under gspmd and ``moe_f32_routes`` on
    it, then shard_map's first step. Writes each run's record, and the
    routing and keep of its first step (and of the float32 forward) over
    this rank's tokens, under ``out_dir``."""
    from repro_torch.models import blocks
    from repro_torch.parallel.dist import (make_mesh, spmd_world,
                                           world_backend)
    t_start = time.perf_counter()
    meta = {"rank": rank, "world": world,
            "backend": world_backend("cuda", world)}
    mesh_text = f"data={world},model=1"
    with spmd_world(rank, world, f"tcp://localhost:{port}", "cuda",
                    timeout_s=MESH_GROUP_TIMEOUT_S), gloo_list_all_gathers():
        meta["joined_s"] = time.perf_counter() - t_start
        mesh = make_mesh((world, 1), ("data", "model"), "cuda")
        for mode in ("gspmd", "shard_map"):
            path = MOE_MESH_PATH if mode == "gspmd" \
                else dict(MOE_MESH_PATH, steps=1)
            with blocks.moe_dispatch(mode):
                rec, calls = moe_train_run(path, mesh_text, True)
                if mode == "gspmd":
                    t0 = time.perf_counter()
                    _save_calls(out_dir, "routes_f32_gspmd", rank,
                                moe_f32_routes(mesh))
                    rec["f32_forward_s"] = time.perf_counter() - t0
            meta[mode] = rec
            _save_calls(out_dir, f"routes_{mode}", rank, calls)
    meta["seconds"] = time.perf_counter() - t_start
    _mesh_save(out_dir, "meta", rank, obj=meta)
    return 0


def run_moe_mesh_world() -> dict:
    """Spawn train_moe_mesh's ``MESH_WORLD`` ranks (``moe_mesh_child``) on
    the one card and wait for them: each rank's meta record and the
    world's wall. A rank that fails or outlives ``MOE_MESH_TIMEOUT_S``
    fails the run."""
    import shutil
    shutil.rmtree(MOE_MESH_DIR, ignore_errors=True)
    os.makedirs(MOE_MESH_DIR)
    port = _free_port()
    # a rank that dies in native code leaves its Python stack in its log
    env = dict(os.environ, PYTHONFAULTHANDLER="1", PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(HERE, "src"),
                    os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    t0 = time.perf_counter()
    procs, logs = [], []
    for r in range(MESH_WORLD):
        log = open(os.path.join(MOE_MESH_DIR, f"rank{r}.log"), "w")
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--moe-mesh-rank",
             str(r), str(MESH_WORLD), str(port), MOE_MESH_DIR],
            cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
        _CHILDREN.append(p)
        procs.append(p)
        logs.append(log)
    deadline = time.monotonic() + MOE_MESH_TIMEOUT_S
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    wall = time.perf_counter() - t0
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for log in logs:
        log.close()
    if codes != [0] * MESH_WORLD:
        tails = []
        for r in range(MESH_WORLD):
            with open(os.path.join(MOE_MESH_DIR, f"rank{r}.log")) as f:
                tails.append(f"rank {r}: " + f.read()[-1500:])
        fail(f"train_moe_mesh: the (2, 1) world failed (exit codes "
             f"{codes}): " + " | ".join(tails))
    metas = []
    for r in range(MESH_WORLD):
        with open(os.path.join(MOE_MESH_DIR, f"meta.rank{r}.json")) as f:
            metas.append(json.load(f))
    return {"metas": metas, "wall_s": wall}


def mesh_route_tables(tag: str, cfg, shape, rule: bool = False) -> list:
    """The (2, 1) world's routing tables (``route_tables``) of the calls
    saved as ``routes_<tag>``, over the whole batch: each group's tokens
    are the ranks' runs of it concatenated in rank order (a group is
    batch-major, and rank r holds row r). ``kept`` is what each rank's
    dispatch decided, or with ``rule`` the whole group's capacity rule
    over the same routing."""
    import numpy as np
    ranks = []
    for r in range(MESH_WORLD):
        with np.load(os.path.join(MOE_MESH_DIR,
                                  f"routes_{tag}.rank{r}.npz")) as f:
            ranks.append({k: f[k] for k in f.files})
    n = len({k.split("/")[0] for k in ranks[0]})
    calls = [((*shape, None), cfg, [tuple(
        np.concatenate([a[f"{i}/{name}"] for a in ranks], axis=1)
        for name in ("probs", "idx", "keep"))]) for i in range(n)]
    return route_tables(calls, rule)


def train_moe_mesh(card: str, full: dict) -> dict:
    """granite-moe-1b-a400m on meshes under launch.train's default MoE
    dispatch (GSPMD's). (a) A one-rank (1, 1) mesh at train_moe_full's
    path: its losses ``==`` train_moe_full's first MESH_STEPS and its
    launches a step exactly ``train_launches`` (96 B3, 48 B9). (b) A (2,
    1) data mesh of 2 ranks on the one card at MOE_MESH_PATH: in every
    MoE call of the first step and of a float32 forward of the first
    batch, the slots the ranks' dispatches kept are exactly the whole
    group's capacity rule over their routing; the float32 forward routes
    as the unsharded one, a difference allowed only at a rounding tie
    (``route_diff``); the losses within MOE_MESH_LOSS_RTOL of the
    unsharded run's and equal on both ranks; B3 and B9 on every rank (48
    and 24 a step). The bf16 step's routing against the unsharded run's
    is reported: its rounding differs (a rank's matmuls over 2 048 rows,
    the unsharded over 4 096) and a top-k choice at a near tie moves
    every later token of its row. (c) The same mesh under shard_map, one
    step: its data shards' capacity keeps other slots than the whole
    group's rule over the same routing, counted."""
    cfg = train_cfg(MOE_ARCH)
    path = dict(TRAIN_MOE_PATHS[0][2], steps=MESH_STEPS)
    one = moe_train_run(path, "1x1")
    check(one["losses"] == full["losses"][:MESH_STEPS],
          f"train_moe_mesh (1, 1): losses {one['losses']} != "
          f"train_moe_full's {full['losses'][:MESH_STEPS]}")
    want = train_launches(cfg, path["microbatches"])
    for i, got in enumerate(one["launches_per_step"]):
        check(got == want, f"train_moe_mesh (1, 1) step {i}: launches "
                           f"{got} != {want}")
    t0 = time.perf_counter()
    ref, calls = moe_train_run(MOE_MESH_PATH, routes=True)
    ref_tables = route_tables(calls)
    ref_f32 = route_tables(moe_f32_routes())
    ref["wall_s"] = time.perf_counter() - t0
    world = run_moe_mesh_world()
    want1 = train_launches(cfg, MOE_MESH_PATH["microbatches"])
    shape = (MOE_MESH_PATH["global_batch"], MOE_MESH_PATH["seq_len"])
    out = {"card": card, "arch": MOE_ARCH, "layers": cfg.n_layers,
           "one_rank": {"mesh": "1x1", "dispatch": "gspmd", **path,
                        "losses_equal_train_moe_full": True,
                        **{k: one[k] for k in ("losses", "step_s",
                                               "peak_memory_bytes",
                                               "wall_s")},
                        "launches_per_step": one["launches_per_step"][0]},
           "unsharded": {**MOE_MESH_PATH, **{k: ref[k] for k in (
               "losses", "step_s", "peak_memory_bytes", "wall_s")},
               "launches_per_step": ref["launches_per_step"][0]},
           "world_wall_s": world["wall_s"],
           "loss_rtol": MOE_MESH_LOSS_RTOL}
    for mode in ("gspmd", "shard_map"):
        recs = [m[mode] for m in world["metas"]]
        for r, rec in enumerate(recs):
            for i, got in enumerate(rec["launches_per_step"]):
                check(got == want1, f"train_moe_mesh (2, 1) {mode} rank "
                                    f"{r} step {i}: launches {got} != "
                                    f"{want1}")
        check(recs[0]["losses"] == recs[1]["losses"],
              f"train_moe_mesh (2, 1) {mode}: the ranks' losses differ: "
              f"{[rec['losses'] for rec in recs]}")
        off_rule = {}
        for tag in (mode, f"f32_{mode}")[:2 if mode == "gspmd" else 1]:
            seen = mesh_route_tables(tag, cfg, shape)
            rule = mesh_route_tables(tag, cfg, shape, rule=True)
            off_rule[tag] = sum(int((a["kept"] != b["kept"]).sum())
                                for a, b in zip(seen, rule))
        step = route_diff(ref_tables, mesh_route_tables(mode, cfg, shape),
                          False)
        rel = [abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"],
                                                   ref["losses"])]
        out[mode] = {
            "mesh": "data=2,model=1", **MOE_MESH_PATH,
            "steps": len(recs[0]["losses"]),
            "losses": recs[0]["losses"], "loss_rel_to_unsharded": rel,
            "step_s": [rec["step_s"] for rec in recs],
            "peak_memory_bytes": [rec["peak_memory_bytes"] for rec in recs],
            "wall_s": [rec["wall_s"] for rec in recs],
            "launches_per_step": [rec["launches_per_step"][0]
                                  for rec in recs],
            "kept_slots_off_whole_group_rule": off_rule,
            "routing_first_step": {k: v for k, v in step.items()
                                   if k != "differs"}}
    g, m = out["gspmd"], out["shard_map"]
    f32 = route_diff(ref_f32, mesh_route_tables("f32_gspmd", cfg, shape),
                     True)
    g["f32_forward_s"] = [w["gspmd"]["f32_forward_s"]
                          for w in world["metas"]]
    g["routing_f32_forward"] = {k: v for k, v in f32.items()
                                if k != "differs"}
    g["routed_alike_f32"] = not f32["differs"].any()
    check(not any(g["kept_slots_off_whole_group_rule"].values()),
          f"train_moe_mesh (2, 1) gspmd: the ranks kept other slots than "
          f"the whole group's capacity: {g['kept_slots_off_whole_group_rule']}")
    check(g["routing_f32_forward"]["drop_slot_diffs"] == 0
          or g["routing_f32_forward"]["tokens_differing_first"] > 0,
          f"train_moe_mesh (2, 1) gspmd: the float32 forward drops other "
          f"slots with no routing difference before: "
          f"{g['routing_f32_forward']}")
    check(max(g["loss_rel_to_unsharded"]) <= MOE_MESH_LOSS_RTOL,
          f"train_moe_mesh (2, 1) gspmd: losses {g['losses']} against the "
          f"unsharded {ref['losses']} past {MOE_MESH_LOSS_RTOL}")
    check(m["kept_slots_off_whole_group_rule"]["shard_map"] > 0,
          "train_moe_mesh (2, 1) shard_map: kept the whole group's slots")
    out["ranks_joined_s"] = [w["joined_s"] for w in world["metas"]]
    out["ranks_s"] = [w["seconds"] for w in world["metas"]]
    return out


# serve_arrivals: qwen2.5-3b at full width behind a short Poisson trace
# (launch.serve.serve_arrivals), then a child process on the card that is
# sent SIGTERM mid-trace and must drain: (rate requests/s, duration s,
# epoch s, prompt, generated tokens); the child's trace is long enough
# that the signal lands inside it, and the signal comes this many seconds
# after the child says it is serving
ARRIVALS = dict(rate=1.0, duration=20.0, epoch=5.0, prompt=512, tokens=16)
ARRIVALS_CHILD = dict(rate=4.0, duration=600.0, epoch=5.0, prompt=512,
                      tokens=16)
ARRIVALS_SIGNAL_AFTER_S = 3.0
SERVE_SIGNAL_CHILD = os.path.join("tests", "_torch_serve_signal_child.py")


def serve_arrivals_phase(card: str) -> dict:
    """``serve_arrivals`` on qwen2.5-3b at full width, batch 4, over a
    seeded Poisson trace (``ARRIVALS``): every arrival is served or
    queued, each wave is a whole batch, the waves launch B3 and B4. Then
    ``tests/_torch_serve_signal_child.py`` on the card, a process of its
    own, serves a long trace and is sent SIGTERM
    ``ARRIVALS_SIGNAL_AFTER_S`` after it starts serving: it must exit 0
    having written a report flagged ``drained`` and ``SIGTERM``."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.fleet import ArrivalSpec
    from repro_torch.launch.serve import Server, serve_arrivals
    a = ARRIVALS
    t0 = time.perf_counter()
    srv = Server(SERVE_ARCH, reduced=False, batch=SERVE_BATCH,
                 max_seq=a["prompt"] + a["tokens"] + 8, seed=0,
                 device="cuda")
    srv.generate(np.zeros((SERVE_BATCH, a["prompt"]), np.int32),
                 2)  # warm-up
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    stats = serve_arrivals(srv, ArrivalSpec("poisson", rate_rps=a["rate"]),
                           duration_s=a["duration"], epoch_s=a["epoch"],
                           prompt_len=a["prompt"], n_tokens=a["tokens"],
                           seed=0)
    wall = time.perf_counter() - t0
    launches = read_launches()
    del srv
    torch.cuda.empty_cache()
    served = sum(e["served"] for e in stats)
    arrived = sum(e["arrived"] for e in stats)
    waves = served // SERVE_BATCH
    check(len(stats) == math.ceil(a["duration"] / a["epoch"])
          and all(e["served"] % SERVE_BATCH == 0 for e in stats)
          and served + stats[-1]["queued"] == arrived and waves > 0,
          f"serve_arrivals: epochs {stats}")
    L = get_cfg(SERVE_ARCH).n_layers
    want = expected_launches(("flash_attention", "decode_attention"), 0)
    want["flash_attention"] = L * waves
    want["decode_attention"] = L * waves * (a["tokens"] - 1)
    check(launches == want, f"serve_arrivals launches {launches} != {want}")

    c = ARRIVALS_CHILD
    tmp = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    report = os.path.join(tmp, "serve_report.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cmd = [sys.executable, os.path.join(HERE, SERVE_SIGNAL_CHILD), report,
           "--device", "cuda", "--arch", SERVE_ARCH, "--full",
           "--batch", str(SERVE_BATCH), "--rate", str(c["rate"]),
           "--duration", str(c["duration"]), "--epoch", str(c["epoch"]),
           "--prompt-len", str(c["prompt"]), "--tokens", str(c["tokens"])]
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready = proc.stdout.readline().strip()
        if ready != "READY":
            fail(f"serve_arrivals child: {ready!r}, "
                 f"{proc.stderr.read()[-2000:]}")
        time.sleep(ARRIVALS_SIGNAL_AFTER_S)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
        drain_s = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"serve_arrivals child exited "
                                f"{proc.returncode}: {err[-2000:]}")
    with open(report) as f:
        rep = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    ep = rep["epochs"]
    check(rep["interrupted"] == "SIGTERM" and ep and ep[-1].get("drained")
          and len(ep) < math.ceil(c["duration"] / c["epoch"])
          and all(e["served"] % SERVE_BATCH == 0 for e in ep)
          and rep["served_total"] == sum(e["served"] for e in ep)
          and f"DONE {len(ep)}" in out,
          f"serve_arrivals child: report {rep}, output {out[-500:]}")
    return {"card": card, "arch": SERVE_ARCH, "batch": SERVE_BATCH,
            "trace": {"kind": "poisson", **a}, "init_s": init_s,
            "epochs": stats, "arrived": arrived, "served": served,
            "waves": waves, "wall_s": wall,
            "wave_wall_s": sum(e["wall_s"] for e in stats) / waves,
            "launches": launches,
            "sigterm_child": {"trace": {"kind": "poisson", **c},
                              "signal_after_ready_s":
                                  ARRIVALS_SIGNAL_AFTER_S,
                              "signal_to_exit_s": drain_s,
                              "epochs": ep,
                              "served_total": rep["served_total"],
                              "interrupted": rep["interrupted"]}}


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
    # the dry runs (a CPU child on a core of its own, no card) overlap
    # the card's phases
    dry_runs = start_dry_runs()

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
    b9 = check_attention_bwd_kernel(dev)
    masks = check_attention_masks(dev)
    torch.cuda.empty_cache()
    b10 = check_ssd_bwd_kernel(dev)
    torch.cuda.empty_cache()
    b9_masks = check_b9_masks(dev)
    torch.cuda.empty_cache()
    emit("kernels", card=card, k1_cases=k1_cases, k2_cases=k2_cases,
         b3_b4=attn, b3_b4_masks=masks, b5=ssd, b2=b2, b9=b9,
         b9_masks=b9_masks, b10=b10,
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
    held = {"sweep_full": res1, "sweep_full_wall_s": t_steady}
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
    ppf = program_plane_full(card, suite, keep=held)
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
    torch.cuda.empty_cache()

    # ---- 9b. training: card vs CPU, resume, qwen2.5-3b at full width -----
    emit("train_parity", **train_parity(card))
    emit("train_resume", **train_resume(card))
    torch.cuda.empty_cache()
    tr = train_full(card)
    emit("train_full", **tr)
    emit("profile_train", arch=TRAIN_ARCH, **profile_train(
        (*B3_KERNELS.values(), *B9_KERNELS["bfloat16"])))
    torch.cuda.empty_cache()

    # ---- 9b'. the parallel slice: train_full's cell on a one-card mesh,
    # and its dry run under fake tensors beside it
    mesh_rec = train_mesh(card, tr)
    probe = mesh_step_probe((*B3_KERNELS.values(),
                             *B9_KERNELS["bfloat16"]))
    emit("train_mesh", **mesh_rec, probe=probe)
    emit("dryrun_card", **dryrun_card(card, mesh_rec, probe,
                                      finish_dry_run(dry_runs, "card")))
    torch.cuda.empty_cache()

    # ---- 9c. the hybrid, vision and audio families at full width (after
    # every profiled phase above; their own timings profile kernels alone)
    a7a, a7a_shapes = {}, {}
    for arch, phase in ((HYBRID_ARCH, "serve_hybrid"), (VLM_ARCH,
                                                        "serve_vlm")):
        rec, srv, prompts = serve_full(card, arch)
        if arch == HYBRID_ARCH:  # the hill-climb toggles on the card
            rec["hillclimb_prefill"] = hillclimb_prefill(srv, prompts)
        emit(f"{phase}_full", **rec)
        a7a[arch] = rec
        a7a_shapes[arch] = model_shape_kernels(srv, prompts)
        hand = (*B3_KERNELS.values(), *B4_KERNELS)
        if arch == HYBRID_ARCH:
            a7a_shapes[arch]["ssd_scan"] = ssd_model_shapes(srv, prompts)
            hand += B5_KERNELS["bfloat16"]
        emit("kernels_model_shapes", card=card, arch=arch,
             **a7a_shapes[arch])
        emit("profile_serve", **profile_serve(srv, prompts, hand))
        del srv
        torch.cuda.empty_cache()
        emit(f"{phase}_parity", **serve_parity(arch))
        torch.cuda.empty_cache()
        if arch == HYBRID_ARCH:  # card (B3) vs CPU (the plain triangle)
            par = serve_parity(arch, attention="triangle", segments=True)
            check(par["triangle_calls_cpu"] == SERVE_PATHS[arch][
                "parity_layers"], f"serve_hybrid_parity_triangle: the "
                f"CPU ran the triangle {par['triangle_calls_cpu']} times")
            emit(f"{phase}_parity_triangle", **par)
            torch.cuda.empty_cache()
    rec, enc, frames = encode_audio_full(card)
    emit("encode_audio_full", **rec)
    a7a[AUDIO_ARCH] = rec
    _, q, k, v, mask = layer_attention_inputs(enc, frames, 0)
    # the encoder's scores (random weights, no rope) are nearly flat over
    # 1 500 keys, so p rounded to 3 bits averages out (3.9e-3 on an H100,
    # below the limit): the control there is 1 bit
    a7a_shapes[AUDIO_ARCH] = {"flash_attention": time_b3(
        q, k, v, **mask, control_bits=AUDIO_CONTROL_BITS)}
    emit("kernels_model_shapes", card=card, arch=AUDIO_ARCH,
         **a7a_shapes[AUDIO_ARCH])
    del q, k, v
    emit("profile_encode", arch=AUDIO_ARCH,
         **profile_run(lambda: encode_once(enc), tuple(B3_KERNELS.values()),
                       top=10))
    del enc
    torch.cuda.empty_cache()
    emit("encode_audio_parity", **encode_parity())
    torch.cuda.empty_cache()

    # ---- 9d. the MoE families (A7b): B3 at MLA's head dims, then
    # granite-moe-1b-a400m at full width and deepseek-v2-236b at every
    # published width cut to 3 layers
    t0 = time.perf_counter()
    b3_mla = check_b3_mla(dev)
    emit("kernels.b3_mla", card=card, seconds=time.perf_counter() - t0,
         **b3_mla)
    for arch, phase in ((MOE_ARCH, "serve_moe"), (MLA_ARCH, "serve_mla")):
        t0 = time.perf_counter()
        rec, srv, prompts = serve_full(card, arch)
        emit(f"{phase}_full", seconds=time.perf_counter() - t0, **rec)
        a7a[arch] = rec
        a7a_shapes[arch] = model_shape_kernels(srv, prompts)
        emit("kernels_model_shapes", card=card, arch=arch,
             **a7a_shapes[arch])
        hand = (*B3_KERNELS.values(),
                *(B4_KERNELS if SERVE_PATHS[arch]["step"] else ()))
        emit("profile_serve", **profile_serve(srv, prompts, hand))
        del srv
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        par = serve_parity(arch)
        emit(f"{phase}_parity", seconds=time.perf_counter() - t0, **par)
        torch.cuda.empty_cache()
    # the reduced deepseek-v2 (MLA at head dims (24, 16), B3 with q / k
    # padded to 32) served on the card against the CPU
    t0 = time.perf_counter()
    mla_reduced = {"serve": serve_parity(MLA_ARCH, reduced=True)}
    emit("serve_mla_reduced_parity", seconds=time.perf_counter() - t0,
         **mla_reduced["serve"])

    # ---- 9e. training the SSD, hybrid, vision and audio families at full
    # width (B3 / B9 under every mask, B5 / B10), each beside its parity
    # with the CPU; then a bit-exact resume through all four kernels
    trains = {}
    for phase, arch, path in TRAIN_PATHS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = train_full(card, arch, path)
        if arch == HYBRID_ARCH:  # the hill-climb toggles under grad
            torch.cuda.empty_cache()
            rec["hillclimb_step"] = hillclimb_train_step(path)
        emit(phase, seconds=time.perf_counter() - t0, **rec)
        trains[arch] = rec
        torch.cuda.empty_cache()
        if arch in PROFILED_TRAIN:
            hand = (*B3_KERNELS.values(), *B9_KERNELS["bfloat16"],
                    *B5_KERNELS["bfloat16"], *B10_KERNELS)
            emit("profile_train", arch=arch,
                 **profile_train(hand, arch, path))
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        par = train_parity(card, arch)
        emit(phase.replace("_full", "_parity"),
             wall_s=time.perf_counter() - t0, **par)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = train_resume(card, HYBRID_ARCH)
    emit("train_resume", seconds=time.perf_counter() - t0, **res)
    torch.cuda.empty_cache()

    # ---- 9f. training the MoE families (A8d): B9 at MLA's head dims, then
    # granite-moe-1b-a400m at full width (and two backward passes of one
    # of its microbatches, bit for bit) and deepseek-v2-236b at its
    # published widths cut to fit one card, each beside its parity with
    # the CPU; a bit-exact resume through the MoE dispatch
    t0 = time.perf_counter()
    b9_mla = check_b9_mla(dev)
    emit("kernels.b9_mla", card=card, seconds=time.perf_counter() - t0,
         **b9_mla)
    torch.cuda.empty_cache()
    moe_bits = None
    for phase, arch, path in TRAIN_MOE_PATHS:
        t0 = time.perf_counter()
        rec = train_full(card, arch, path)
        emit(phase, seconds=time.perf_counter() - t0, **rec)
        trains[arch] = rec
        torch.cuda.empty_cache()
        if arch == MOE_ARCH:
            moe_bits = moe_backward_bits(card, arch)
            emit("train_moe_bits", **moe_bits)
        if arch in PROFILED_TRAIN:
            emit("profile_train", arch=arch, **profile_train(
                (*B3_KERNELS.values(), *B9_KERNELS["bfloat16"]), arch,
                path))
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        par = train_parity(card, arch)
        emit(phase.replace("_full", "_parity"),
             wall_s=time.perf_counter() - t0, **par)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = train_resume(card, MOE_ARCH)
    emit("train_resume", seconds=time.perf_counter() - t0, **res)
    torch.cuda.empty_cache()
    # the reduced deepseek-v2 trained 3 steps on the card (B3 / B9 at
    # (24, 16)) against the CPU
    t0 = time.perf_counter()
    mla_reduced["train"] = train_parity(card, MLA_ARCH, reduced=True)
    emit("train_mla_reduced_parity", wall_s=time.perf_counter() - t0,
         **mla_reduced["train"])

    # ---- 9f'. MoE training on meshes (A9c): launch.train's default
    # dispatch, GSPMD's, on a one-rank (1, 1) mesh and on a (2, 1) data
    # mesh of two ranks on this card, beside shard_map
    t0 = time.perf_counter()
    rec = train_moe_mesh(card, trains[MOE_ARCH])
    emit("train_moe_mesh", seconds=time.perf_counter() - t0, **rec)
    torch.cuda.empty_cache()

    # ---- 9g. serving's arrivals and drain (A8a): qwen2.5-3b at full
    # width behind a Poisson trace, and a child on the card sent SIGTERM
    t0 = time.perf_counter()
    rec = serve_arrivals_phase(card)
    emit("serve_arrivals", seconds=time.perf_counter() - t0, **rec)
    torch.cuda.empty_cache()

    # ---- 10. the fleet, chaos and guard planes: K1 and K2, 97 calls a day
    # (after every profiled phase above, so that their threads and their
    # abandoned guard attempt cannot touch those phases' records)
    t0 = time.perf_counter()
    fleet_rec, fleet_report = fleet_full(card)
    emit("fleet_full", seconds=time.perf_counter() - t0, **fleet_rec)
    t0 = time.perf_counter()
    parity = fleet_parity(card, keep=held)
    emit("fleet_parity", seconds=time.perf_counter() - t0, **parity)
    t0 = time.perf_counter()
    chaos = chaos_full(card)
    emit("chaos_full", seconds=time.perf_counter() - t0, **chaos)
    t0 = time.perf_counter()
    guarded = guard_full(card, fleet_report, fleet_rec["k2_per_call"])
    emit("guard_full", seconds=time.perf_counter() - t0, **guarded)
    t0 = time.perf_counter()
    resume = guard_resume(card)
    emit("guard_resume", seconds=time.perf_counter() - t0, **resume)

    # ---- 10b. the power plane across ranks: a one-rank NCCL mesh in this
    # process, then one 2-rank world on this card (gloo), the sweep, the
    # program plane and the fleet each held to its one-device result above
    t0 = time.perf_counter()
    sweep_m, plane_m, fleet_m = mesh_phases(card, held)
    mesh_s = time.perf_counter() - t0
    emit("sweep_mesh", phases_s=mesh_s, **sweep_m)
    emit("program_plane_mesh", **plane_m)
    emit("fleet_mesh", **fleet_m)

    # ---- 11. the production dry run: deepseek-v2-236b at all 60 layers
    emit("dryrun_production", **dryrun_production(
        card, finish_dry_run(dry_runs, "production")))

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
         "launches_fleet": fleet_rec["launches"]["sa_occupancy"],
         "launches_fleet_per_call": fleet_rec["k1_per_call"],
         "launches_mesh": mesh_launches(
             "sa_occupancy", sweep_m, plane_m, fleet_m),
         "launch_floor_device_us": launch_floor_us,
         "tolerance": "torch.equal with the plain version on the card"},
        {"name": "segment_sum", "route": "cuda", "source": K1_SOURCE,
         "replaces": "src/repro/core/backend.py:203",
         "launches": launches["segment_sum"],
         "launches_fleet": fleet_rec["launches"]["segment_sum"],
         "launches_fleet_per_call": fleet_rec["k2_per_call"],
         "launches_mesh": mesh_launches(
             "segment_sum", sweep_m, plane_m, fleet_m),
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
            "launches_train": tr["launches"][name],
            "max_abs_err": max(t["max_abs_err"],
                               attn["max_abs_err"][key]["bfloat16"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_us": t["device_us"],
            "shape": t["shape"],
            "max_abs_err_float32": attn["max_abs_err"][key]["float32"],
            "max_abs_err_masks": max(r["max_abs_err"]
                                     for r in masks[key].values()),
            "launches_by_path": {
                "serve_full": serve_rec["launches"][name],
                "train_full": tr["launches"][name],
                **{a: a7a[a]["launches"][name] for a in a7a},
                **{f"train:{a}": trains[a]["launches"][name]
                   for a in trains}},
            "model_shapes": {a: {k: a7a_shapes[a][name][k] for k in (
                "shape", "ms", "device_us", "plain_ms", "library_ms",
                "library_device_us", "bound_ms", "bound_by", "max_abs_err")
                if k in a7a_shapes[a][name]} | (
                {"library_kernels": a7a_shapes[a][name]["library_kernels"],
                 "live_pairs": a7a_shapes[a][name]["live_pairs"]}
                if name == "flash_attention" else {})
                for a in a7a_shapes if name in a7a_shapes[a]},
            "tolerance": "allclose with the plain version on the card: "
                         "atol = rtol = 2e-2 (bf16), 2e-5 (float32)"
                         + ("; bit-identical on a second call"
                            if name == "decode_attention" else "")})
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS
    b3_entry = next(k for k in kernels if k["name"] == "flash_attention")
    b3_entry["head_dim_pairs"] = [list(pair) for pair in HEAD_DIM_PAIRS]
    b3_entry["mla_pair"] = {
        **{k: b3_mla["model_shape"][k] for k in (
            "shape", "ms", "device_us", "plain_ms", "library_ms",
            "library_device_us", "library_kernels", "bound_ms", "bound_by",
            "max_abs_err", "rel_l2", "live_pairs")},
        "launches_serve_mla_full": a7a[MLA_ARCH]["launches"][
            "flash_attention"],
        "max_abs_err_cases": {dn: max(r["max_abs_err"] for c, r in
                                      b3_mla["cases"].items()
                                      if c.endswith(dn))
                              for dn in ("bfloat16", "float32")}}
    timing_keys = ("shape", "ms", "device_us", "plain_ms", "library_ms",
                   "library_device_us", "library_kernels", "bound_ms",
                   "bound_by", "max_abs_err", "rel_l2", "live_pairs")
    b3_entry["mla_reduced_pair"] = {
        **{k: b3_mla["reduced_shape"][k] for k in timing_keys},
        "launches_serve_mla_reduced_parity": mla_reduced["serve"][
            "launches"]["flash_attention"],
        "launches_train_mla_reduced_parity": mla_reduced["train"][
            "launches_card"]["flash_attention"],
        "max_abs_err_cases": {dn: max(r["max_abs_err"] for c, r in
                                      b3_mla["reduced_cases"].items()
                                      if c.endswith(dn))
                              for dn in ("bfloat16", "float32")}}
    b3_entry["query_offset"] = {
        **{k: masks["chunked_prefill"][k] for k in timing_keys},
        "max_abs_err_cases": {dn: max(r["max_abs_err"] for c, r in
                                      masks["b3_offset"].items()
                                      if c.endswith(dn))
                              for dn in ("bfloat16", "float32")}}
    b3_entry["launches_hillclimb_prefill"] = a7a[HYBRID_ARCH][
        "hillclimb_prefill"]["launches"]["flash_attention"]
    from repro_torch.kernels.flash_attention_bwd import \
        HEAD_DIM_PAIRS as B9_HEAD_DIM_PAIRS
    b9m = b9["model_shape"]["bfloat16"]
    b9mla = b9_mla["model_shape"]["bfloat16"]
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": B9_SOURCE,
        "replaces": "src/repro/models/common.py:281",
        "replaces_note": "not Pallas: jax.vjp of the reference's attention "
                         "(plain_attention / flash_attention_jax)",
        "launches": tr["launches"]["flash_attention_bwd"],
        "launches_per_step": tr["launches_per_step"]["flash_attention_bwd"],
        "max_abs_err": b9["max_abs_err"]["bfloat16"],
        "max_abs_err_float32": b9["max_abs_err"]["float32"],
        "ms": b9m["ms"], "device_us": b9m["device_us"],
        "plain_ms": b9m["plain_ms"],
        "plain_note": "the plain version on the CPU copies of the inputs",
        "library_ms": b9m["library_ms"], "library_note": b9m["library_note"],
        "bound_ms": b9m["bound_ms"], "bound_by": b9m["bound_by"],
        "shape": b9m["shape"], "rel_l2": b9m["rel_l2"],
        "control_rel_l2": b9m["control_rel_l2"],
        "float32": {k: b9["model_shape"]["float32"][k] for k in
                    ("ms", "device_us", "plain_ms", "library_ms",
                     "bound_ms", "bound_by")},
        "launches_by_path": {"train_full": tr["launches"][
            "flash_attention_bwd"], **{f"train:{a}": trains[a]["launches"][
                "flash_attention_bwd"] for a in trains}},
        "head_dim_pairs": [list(pair) for pair in B9_HEAD_DIM_PAIRS],
        "mla_pair": {
            **{k: b9mla.get(k) for k in (
                "shape", "ms", "device_us", "plain_ms", "plain_note",
                "library_ms", "library_error", "bound_ms", "bound_by",
                "max_abs_err", "rel_l2", "control_rel_l2")},
            "float32": {k: b9_mla["model_shape"]["float32"].get(k) for k in
                        ("ms", "device_us", "plain_ms", "library_ms",
                         "bound_ms", "bound_by", "max_abs_err")},
            "max_abs_err_cases": b9_mla["max_abs_err"],
            "lse_max_abs_err": b9_mla["lse_max_abs_err"],
            "launches_train_mla_full": trains[MLA_ARCH]["launches"][
                "flash_attention_bwd"],
            "launches_per_step": trains[MLA_ARCH]["launches_per_step"][
                "flash_attention_bwd"]},
        "mla_reduced_pair": {
            **{k: b9_mla["reduced_shape"]["bfloat16"].get(k) for k in (
                "shape", "ms", "device_us", "plain_ms", "plain_note",
                "library_ms", "library_error", "bound_ms", "bound_by",
                "max_abs_err", "rel_l2", "control_rel_l2")},
            "max_abs_err_cases": b9_mla["reduced_max_abs_err"],
            "launches_train_mla_reduced_parity": mla_reduced["train"][
                "launches_card"]["flash_attention_bwd"]},
        "query_offset": {
            **{k: b9_masks["chunked_prefill"].get(k) for k in (
                "shape", "live_pairs", "ms", "device_us", "plain_ms",
                "library_ms", "library_error", "library_kernels",
                "bound_ms", "bound_by", "max_abs_err", "rel_l2",
                "control_rel_l2")},
            "max_abs_err_cases": max(r["max_abs_err"] for r in
                                     b9_masks["offset_cases"].values())},
        "launches_hillclimb_step": trains[HYBRID_ARCH]["hillclimb_step"][
            "launches"]["flash_attention_bwd"],
        "moe_backward_bit_identical_leaves": moe_bits[
            "leaves_bit_identical"],
        "max_abs_err_masks": max(r["max_abs_err"] for r in
                                 b9_masks["cases"].values()),
        "model_shapes": {b9_masks["model_shapes"][n]["arch"]: {
            k: b9_masks["model_shapes"][n][k] for k in (
                "shape", "live_pairs", "ms", "device_us", "plain_ms",
                "library_ms", "library_kernels", "bound_ms", "bound_by",
                "max_abs_err", "rel_l2", "control_rel_l2")}
            for n in b9_masks["model_shapes"]},
        "tolerance": f"float32: |kernel - plain| <= {B9_TOL_F32} "
                     f"(max(max|plain|, 1) + |plain|); bf16: relative L2 "
                     f"<= {B9_REL_L2_BF16} of each of dq, dk, dv (S > 1); "
                     f"bit-identical on a second call"})
    b10m = b10["model_shapes"][SSM_ARCH]["bfloat16"]
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda", "source": SSD_BWD_SOURCE,
        "replaces": "src/repro/models/blocks.py:510",
        "replaces_note": "not Pallas: jax.vjp of the reference's chunked "
                         "SSD scan (_ssd_chunk_scan)",
        "launches": trains[SSM_ARCH]["launches"]["ssd_scan_bwd"],
        "launches_per_step": trains[SSM_ARCH]["launches_per_step"][
            "ssd_scan_bwd"],
        "launches_by_path": {f"train:{a}": trains[a]["launches"][
            "ssd_scan_bwd"] for a in trains},
        "max_abs_err": b10["max_abs_err"]["bfloat16"],
        "max_abs_err_float32": b10["max_abs_err"]["float32"],
        "ms": b10m["ms"], "device_us": b10m["device_us"],
        "plain_ms": b10m["plain_ms"], "plain_note": b10m["plain_note"],
        "library_ms": None, "library_note": b10m["library_note"],
        "bound_ms": b10m["bound_ms"], "bound_by": b10m["bound_by"],
        "shape": b10m["shape"], "rel_l2": b10m["rel_l2"],
        "control_rel_l2": b10m["control_rel_l2"],
        "model_shapes": {a: {dn: {k: r[k] for k in (
            "shape", "ms", "device_us", "kernel_device_us", "plain_ms",
            "bound_ms", "bound_by", "scaled_err", "rel_l2")}
            for dn, r in b10["model_shapes"][a].items()}
            for a in b10["model_shapes"]},
        "tolerance": f"max |kernel - plain| / max |plain| <= "
                     f"{B10_SCALED_TOL} per gradient (float32; ddt and dA "
                     f"on the bf16 route); bf16 dx, dB, dC relative L2 <= "
                     f"{B10_REL_L2_BF16}; bit-identical on a second call"})
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
        "launches_by_path": {
            "serve_ssm_full": ssm_rec["launches"]["ssd_scan"],
            HYBRID_ARCH: a7a[HYBRID_ARCH]["launches"]["ssd_scan"],
            **{f"train:{a}": trains[a]["launches"]["ssd_scan"]
               for a in (SSM_ARCH, HYBRID_ARCH)}},
        "model_shapes": {HYBRID_ARCH: {
            k: a7a_shapes[HYBRID_ARCH]["ssd_scan"][k] for k in (
                "shape", "ms", "device_us", "plain_ms", "bound_ms",
                "bound_by", "max_abs_err", "rel_l2", "occupancy")
            if k in a7a_shapes[HYBRID_ARCH]["ssd_scan"]}},
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
        "launches_mesh": mesh_launches(
            "program_exec", sweep_m, plane_m, fleet_m),
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
    print(json.dumps({"kernels": kernels,
                      "profiler_fallbacks": PROFILER_FALLBACKS}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_child(int(sys.argv[2]), int(sys.argv[3]),
                            int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    if len(sys.argv) > 1 and sys.argv[1] == "--moe-mesh-rank":
        sys.exit(moe_mesh_child(int(sys.argv[2]), int(sys.argv[3]),
                                int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
