#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA GPU, in turns: a parent commit
against the change.

    mkdir -p build/parent                       # an ignored directory
    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent             # parent, change, change, parent
    python3 chip_ab.py build/parent --order PC --smoke-only  # a half of it
    python3 chip_ab.py build/parent --decode-pairs 3  # the decode loops only
    python3 chip_ab.py --calls build/parent  # Python calls a decode step (CPU)

Each run (``P`` the parent tree, ``C`` this checkout, in the order
``ORDER``) runs that tree's ``chip_smoke.py``, keeps its standard output
under ``--out`` and reads from it the numbers compared: B3 and B4 at
the model's shapes (``kernels_model_shapes``), K2 at the sweep's four
shapes (``kernels``), B2's five ``gated_matmul_full`` cases,
``sweep_full``'s steady wall, B7 and the wall split of
``program_plane_full`` (ms, device µs, ns a dependent step, the bytes
the executor call copied to the card, ``executor_s``), K1's device µs
beside the launch floor (``kernels``), ``serve_full`` and
``profile_serve``'s prefill and decode windows; for mamba2-780m, B5 at
the model's shapes, ``serve_ssm_full`` and its prefill window; B9 at the
training shape in both types (``kernels``: ms, device µs, bound, the
``sdpa`` backward's ms, bf16 relative L2 and its control),
``train_full`` (steady s/step, tokens/s, MFU, peak memory, the first
step's loss, which must be the same bits in every run while the forward
is unchanged) and ``profile_train`` (B9's device µs a call and its share
of the busy time); for the SSD backward B10 at mamba2-780m's and
hymba-1.5b's training shapes in both types (``kernels``: ms, device µs
over all its kernels, bound), ``train_ssm_full`` and
``train_hybrid_full`` (steady s/step, tokens/s, MFU, peak memory) and
their ``profile_train`` steps (B10's device µs a call and its share of
the busy time, every profiled kernel of B10's: ``B10_NAMES``); for the
MoE families B9 at multi-head latent attention's (192, 128) at
deepseek-v2's training microbatch in both types (``kernels.b9_mla``: ms,
device µs, bound, the ``sdpa`` backward's ms, bf16 relative L2),
``train_moe_full`` and ``train_mla_full`` (steady s/step, tokens/s, MFU
on the active parameters, peak memory) and deepseek's ``profile_train``
step (B9's device µs a call and its share of the busy time). Four
metrics are then timed for both trees by the same code, in a process of
its own,

    python3 chip_ab.py --same-code TREE

which imports TREE's port and times it with this checkout's
``chip_smoke`` functions on inputs made from a seed: B3 in float32 at
the prefill's shape (``time_b3``) and B5 in float32 at mamba2-780m's
prefill shape (``time_b5``), which no ``chip_smoke.py`` measures,
K2's device time at the sweep's four shapes (``time_k2``) and B10's in
bf16 at the training paths' shapes (``time_b10``). Each run prints one JSON
line and the last line is a summary: per metric, the values of the runs
in order. Each tree builds its kernels into its own ``build/`` at its
first run. Needs one card; it exits non-zero if any run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ORDER = "PCCP"
B3_SHAPE = (4, 2048, 16, 2, 128)   # B, S, H, Hkv, D: qwen2.5-3b's prefill
B5_SHAPE = (4, 2048, 48, 64, 1, 128)  # B, S, H, P, G, N: mamba2-780m's
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "hymba-1.5b"
# B10's kernels in either tree: the parent's ssd_scan_bwd_kernel and
# ssd_bwd_group_kernel, the four ssd_bwd_* passes since
B10_NAMES = ("ssd_scan_bwd", "ssd_bwd_")
# the training paths that run B10: (phase, arch, key in the summary)
SSD_TRAIN = (("train_ssm_full", SSM_ARCH, "train_ssm"),
             ("train_hybrid_full", HYBRID_ARCH, "train_hybrid"))
MOE_ARCH = "granite-moe-1b-a400m"
MLA_ARCH = "deepseek-v2-236b"
# the MoE families' training paths: (phase, arch, key in the summary)
MOE_TRAIN = (("train_moe_full", MOE_ARCH, "train_moe"),
             ("train_mla_full", MLA_ARCH, "train_mla"))


def same_code(tree: str) -> dict:
    """B3 of ``tree``'s port in float32 at ``B3_SHAPE``, its B5 in float32
    at ``B5_SHAPE``, its K2 at the sweep's four shapes and its B10 in bf16
    at the training paths' shapes, by this checkout's
    ``chip_smoke.time_b3``, ``time_b5`` and ``time_k2`` and ``time_b10``."""
    import chip_smoke  # this checkout's: the same timing code for both
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    import repro_torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab.py --same-code: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, Hkv, D = B3_SHAPE
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device="cuda")
               for h in (H, Hkv, Hkv))
    b3 = chip_smoke.time_b3(q, k, v)
    del q, k, v
    Bz, S, H, P, G, N = B5_SHAPE
    x = torch.randn((Bz, S, H, P), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((Bz, S, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.rand((H,), generator=gen, device="cuda"))
    Bm, Cm = (torch.randn((Bz, S, G, N), generator=gen, device="cuda")
              for _ in range(2))
    b5 = chip_smoke.time_b5(x, dt, A.expand(Bz, H), Bm, Cm)
    del x, dt, Bm, Cm
    shapes = chip_smoke.k2_port_shapes(torch.device("cuda"))
    return {"port": os.path.dirname(repro_torch.__file__), "b3_float32": b3,
            "b5_float32": b5,
            "k2": chip_smoke.time_k2(shapes, np.random.default_rng(0)),
            "b10_bfloat16": time_b10()}


#: the serving paths ``--decode`` times, and the runs of each tree
DECODE_ARCHS = ("qwen2.5-3b", "hymba-1.5b")


def time_decode(tree: str) -> dict:
    """``serve_full``'s timed decode loop over ``tree``'s port, by this
    checkout's code: per arch of ``DECODE_ARCHS``, ``Server`` at full width
    (``chip_smoke.SERVE_PATHS``), batch 4, the arch's prompt, a warm-up,
    then 31 steps; ms a step (their mean, as ``serve_full``'s
    ``decode_ms_per_step``) and the fastest step."""
    import gc

    import chip_smoke
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch.launch.serve import Server
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab.py --decode: no CUDA device")
    out = {"port": os.path.dirname(repro_torch.__file__)}
    for arch in DECODE_ARCHS:
        path = chip_smoke.SERVE_PATHS[arch]
        cfg = chip_smoke.get_cfg(arch)
        srv = Server(arch, reduced=False, n_layers=path.get("layers"),
                     batch=chip_smoke.SERVE_BATCH,
                     max_seq=chip_smoke.image_slots(cfg) + path["prompt"]
                     + chip_smoke.SERVE_TOKENS, seed=0, device="cuda")
        prompts = np.random.default_rng(0).integers(
            0, srv.cfg.vocab_size, (chip_smoke.SERVE_BATCH, path["prompt"]),
            dtype=np.int32)
        srv.generate(prompts[:, :64], 2)  # warm-up
        torch.cuda.synchronize()
        tok = srv.prefill_prompts(prompts)
        steps = []
        for _ in range(chip_smoke.SERVE_TOKENS - 1):
            t1 = time.perf_counter()
            tok = srv.step(tok)
            steps.append(time.perf_counter() - t1)
        out[arch] = {"decode_ms_per_step": 1e3 * sum(steps) / len(steps),
                     "decode_ms_per_step_min": 1e3 * min(steps)}
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    return out


def host_calls(tree: str, steps: int = 20) -> dict:
    """Python function calls a decode step of ``tree``'s port makes on the
    CPU (no card needed): qwen2.5-3b reduced in width, at its 36 layers,
    batch 1, ``steps`` steps under ``cProfile``: all calls, and those of
    the functions the parallel layer added to every path."""
    import cProfile
    import dataclasses
    import pstats
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.data.specs import make_batch
    from repro_torch.models import model as M
    from repro_torch.models import registry
    from repro_torch.models.param import init_params
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(), n_layers=36)
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.bfloat16)
    batch = make_batch(cfg, ShapeConfig("p", 16, 1, "prefill"), seed=0,
                       device="cpu")
    cache = M.init_cache(cfg, 1, 32, device="cpu")
    tok = {"tokens": torch.zeros((1, 1), dtype=torch.int64), "cache_len": 16}
    prof = cProfile.Profile()
    with torch.no_grad():
        M.prefill_step(params, batch, cfg, cache=cache)
        M.decode_step(params, cache, dict(tok), cfg)
        prof.enable()
        for _ in range(steps):
            M.decode_step(params, cache, dict(tok), cfg)
        prof.disable()
    stats = pstats.Stats(prof).stats
    named = ("constrain", "current_mesh", "current_rules", "is_dtensor",
             "split_heads", "gather_params", "local_map")
    return {"calls_per_step": sum(v[1] for v in stats.values()) / steps,
            **{f"{name}_per_step": sum(v[1] for k, v in stats.items()
                                       if k[2] == name) / steps
               for name in named}}


def decode_pairs(parent: str, n: int, out_dir: str) -> dict:
    """``n`` pairs of ``--decode`` runs, a process each, alternating which
    tree runs first (P C, C P, ...): per arch, each tree's ms a step in
    run order."""
    trees = {"P": os.path.abspath(parent), "C": HERE}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = []
    for i in range(n):
        for tag in ("PC" if i % 2 == 0 else "CP"):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--decode", trees[tag]], cwd=trees[tag],
                               env=env, capture_output=True, text=True)
            with open(os.path.join(out_dir, f"decode_{len(runs)}_{tag}.err"),
                      "w") as f:
                f.write(r.stderr)
            lines = r.stdout.strip().splitlines()
            rec = json.loads(lines[-1]) if r.returncode == 0 and lines \
                else {"error": r.stderr[-2000:]}
            runs.append({"tree": tag, "rc": r.returncode, **rec})
            print(json.dumps(runs[-1]), flush=True)
    return {"decode_pairs": n, "metrics": {
        f"{arch}_{k}_{tag}": [r[arch][k] for r in runs
                              if r["tree"] == tag and arch in r]
        for arch in DECODE_ARCHS
        for k in ("decode_ms_per_step", "decode_ms_per_step_min")
        for tag in "PC"}}


def time_b10() -> dict:
    """Device µs a call of the imported port's B10 at the training paths'
    shapes in bf16: every kernel the call puts on the card, whatever the
    tree names them."""
    import torch
    import chip_smoke
    from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd
    out = {}
    for arch, shape in chip_smoke.B10_MODEL_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(10)
        args = chip_smoke.b10_inputs(gen, shape, torch.bfloat16, "cuda")
        out[arch] = chip_smoke.kernel_device_us(
            lambda: ssd_scan_bwd(*args))
        del args
    return out


def _smoke_numbers(lines: list[str]) -> dict:
    """The numbers of one chip_smoke.py run that the comparison reads."""
    phases = {}
    for ln in lines:
        try:
            obj = json.loads(ln)
        except ValueError:
            continue
        if isinstance(obj, dict) and "phase" in obj:
            phases.setdefault(obj["phase"], []).append(obj)
    out = {}
    serve = phases.get("serve_full", [{}])[0]
    out["prefill_s"] = serve.get("prefill_s")
    out["decode_ms_per_step"] = serve.get("decode_ms_per_step")
    out["decode_vs_forward_rel_l2"] = serve.get(
        "decode_vs_forward", {}).get("max_rel_l2")
    out["sweep_wall_s_steady"] = phases.get("sweep_full", [{}])[0].get(
        "wall_s_steady")
    prof = phases.get("profile", [{}])[0]
    out["profile_sweep"] = {
        k: prof.get(k) for k in ("wall_s_profiled", "device_busy_s",
                                 "device_idle_share", "hand_kernels")}
    shapes = [p for p in phases.get("kernels_model_shapes", [])
              if p.get("arch") == "qwen2.5-3b"]
    if shapes:
        b3 = shapes[0]["flash_attention"]
        out["b3"] = {k: b3.get(k) for k in (
            "ms", "device_us", "plain_ms", "library_ms", "max_abs_err",
            "rel_l2", "median_abs_plain", "control_rel_l2")}
        b4 = shapes[0]["decode_attention"]
        out["b4"] = {k: b4.get(k) for k in (
            "ms", "device_us", "plain_ms", "library_ms", "library_device_us",
            "bound_ms", "max_abs_err", "rel_l2", "control_rel_l2", "shape")}
    kernels = phases.get("kernels", [{}])[0]
    out["b4_bf16_rel_l2_cases"] = kernels.get("b3_b4", {}).get(
        "b4_bf16_rel_l2")
    k2 = kernels.get("k2", {}).get("shapes", [])
    out["k2"] = {rec["what"]: {k: rec.get(k) for k in (
        "ms", "device_us", "plain_ms", "library_ms", "bound_ms")}
        for rec in k2}
    gm = phases.get("gated_matmul_full", [{}])[0].get("cases", {})
    out["b2"] = {name: {k: rec.get(k) for k in (
        "ms", "device_us", "plain_ms", "library_ms", "tiles_run")}
        for name, rec in gm.items()}
    prof = [p for p in phases.get("profile_serve", [])
            if p.get("arch") == "qwen2.5-3b"]
    if prof:
        pre = prof[0]["prefill"]
        out["profile_serve_prefill"] = {
            k: pre.get(k) for k in ("wall_s_profiled", "device_busy_s",
                                    "device_idle_share", "hand_kernels",
                                    "top_ops")}
        dec = prof[0]["decode_4_steps"]
        out["profile_serve_decode"] = {
            k: dec.get(k) for k in ("wall_s_profiled", "device_busy_s",
                                    "device_idle_share", "device_launches",
                                    "hand_kernels")}
    ppf = phases.get("program_plane_full", [{}])[0]
    out["b7"] = {k: ppf.get(k) for k in (
        "kernel_ms", "kernel_device_us", "chain_steps", "executor_s",
        "wall_s_sweep_program_plane", "host_prep_s", "rest_s", "split_s",
        "plain_ms_card", "plain_ms_cpu", "bound_ms",
        "bytes_bound_ms_row_copies")}
    # what the executor call copied to the card: the ragged streams, or
    # (before them) the dense stack
    out["b7"]["bytes_to_card"] = ppf.get("bytes_to_card",
                                         ppf.get("stack_bytes"))
    out["program_plane_records_wall_s"] = phases.get(
        "program_plane_records", [{}])[0].get("wall_s_card")
    out["k1"] = kernels.get("k1", {})
    ssm = phases.get("serve_ssm_full", [{}])[0]
    out["ssm"] = {"prefill_s": ssm.get("prefill_s"),
                  "decode_ms_per_step": ssm.get("decode_ms_per_step"),
                  "decode_vs_forward_rel_l2": ssm.get(
                      "decode_vs_forward", {}).get("max_rel_l2")}
    shapes = [p for p in phases.get("kernels_model_shapes", [])
              if p.get("arch") == SSM_ARCH]
    if shapes:
        b5 = shapes[0]["ssd_scan"]
        out["b5"] = {k: b5.get(k) for k in (
            "ms", "device_us", "plain_ms", "bound_ms", "max_abs_err",
            "scaled_err", "rel_l2", "control_rel_l2", "occupancy")}
    prof = [p for p in phases.get("profile_serve", [])
            if p.get("arch") == SSM_ARCH]
    if prof:
        pre = prof[0]["prefill"]
        out["profile_ssm_prefill"] = {
            k: pre.get(k) for k in ("wall_s_profiled", "device_busy_s",
                                    "device_idle_share", "hand_kernels",
                                    "top_ops")}
    b9 = kernels.get("b9", {}).get("model_shape", {})
    out["b9"] = {dn: {k: rec.get(k) for k in (
        "ms", "device_us", "bound_ms", "library_ms", "rel_l2",
        "control_rel_l2")} for dn, rec in b9.items()}
    tr = phases.get("train_full", [{}])[0]
    out["train_full"] = {k: tr.get(k) for k in (
        "steady_s_per_step", "tokens_per_s", "mfu", "peak_memory_bytes",
        "first_step_s", "step_s", "losses", "launches_per_step")}
    pt = phases.get("profile_train", [{}])[0]
    out["profile_train"] = {k: pt.get(k) for k in (
        "wall_s_profiled", "device_busy_s", "device_idle_share",
        "b9_device_us_per_call", "hand_kernels")}
    b10 = kernels.get("b10", {}).get("model_shapes", {})
    out["b10"] = {arch: {dn: {k: rec.get(k) for k in (
        "ms", "device_us", "bound_ms", "rel_l2", "scaled_err")}
        for dn, rec in recs.items()} for arch, recs in b10.items()}
    b9_mla = phases.get("kernels.b9_mla", [{}])[0].get("model_shape", {})
    out["b9_mla"] = {dn: {k: rec.get(k) for k in (
        "ms", "device_us", "bound_ms", "library_ms", "rel_l2",
        "control_rel_l2")} for dn, rec in b9_mla.items()}
    for phase, arch, key in MOE_TRAIN:
        tr = phases.get(phase, [{}])[0]
        out[key] = {k: tr.get(k) for k in (
            "steady_s_per_step", "tokens_per_s", "mfu", "peak_memory_bytes",
            "launches_per_step")}
    prof = [p for p in phases.get("profile_train", [])
            if p.get("arch") == MLA_ARCH]
    out["profile_train_mla"] = {k: prof[0].get(k) for k in (
        "wall_s_profiled", "device_busy_s", "device_idle_share",
        "b9_device_us_per_call", "hand_kernels")} if prof else {}
    for phase, arch, key in SSD_TRAIN:
        tr = phases.get(phase, [{}])[0]
        out[key] = {k: tr.get(k) for k in (
            "steady_s_per_step", "tokens_per_s", "mfu", "peak_memory_bytes",
            "launches_per_step")}
        prof = [p for p in phases.get("profile_train", [])
                if p.get("arch") == arch]
        out[f"profile_{key}"] = {k: prof[0].get(k) for k in (
            "wall_s_profiled", "device_busy_s", "device_idle_share",
            "b10_device_us_per_call", "hand_kernels")} if prof else {}
    # the host-bound walls: every serving path's decode ms a step, every
    # training path's steady s a step (``train_mesh`` where there is one)
    out["host_bound"] = {
        **{f"{ph}_decode_ms_per_step": recs[0].get("decode_ms_per_step")
           for ph, recs in phases.items()
           if ph.startswith("serve_") and ph.endswith("_full")},
        **{f"{ph}_steady_s_per_step": recs[0].get("steady_s_per_step")
           for ph, recs in phases.items()
           if ph.startswith("train_") and (ph.endswith("_full")
                                           or ph == "train_mesh")}}
    return out


def b9_train_share(prof: dict) -> float:
    """B9's share of the profiled training step's device busy time:
    every profiled kernel whose name holds ``attention_bwd``."""
    us = sum(v["device_us_total"] for k, v in prof["hand_kernels"].items()
             if "attention_bwd" in k)
    return us / (1e6 * prof["device_busy_s"])


def b10_train_share(prof: dict) -> float:
    """B10's share of a profiled training step's device busy time: every
    profiled kernel whose name holds one of ``B10_NAMES``."""
    us = sum(v["device_us_total"] for k, v in prof["hand_kernels"].items()
             if any(n in k for n in B10_NAMES))
    return us / (1e6 * prof["device_busy_s"])


def b5_prefill_us_per_call(prefill: dict) -> float:
    """B5's device µs a wrapper call in the mamba2 prefill: per profiled
    kernel whose name holds ``ssd_``, its time over its recorded
    launches, summed (a bf16 call launches two kernels)."""
    return sum(v["device_us_total"] / v["launches"]
               for k, v in prefill["hand_kernels"].items() if "ssd_" in k)


def b5_prefill_share(prefill: dict) -> float:
    """B5's share of the mamba2 prefill's device busy time: every
    profiled kernel whose name holds ``ssd_``."""
    us = sum(v["device_us_total"] for k, v in prefill["hand_kernels"].items()
             if "ssd_" in k)
    return us / (1e6 * prefill["device_busy_s"])


def k2_per_launch(hand_kernels: dict) -> float:
    """K2's device µs a launch over every profiled kernel whose name
    holds ``segment_sum``."""
    k2 = [v for k, v in hand_kernels.items() if "segment_sum" in k]
    return (sum(v["device_us_total"] for v in k2)
            / sum(v["launches"] for v in k2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="the parent commit's tree")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "ab"))
    ap.add_argument("--same-code", metavar="TREE")
    ap.add_argument("--order", default=ORDER,
                    help="the runs, P the parent and C this checkout "
                         f"(default {ORDER})")
    ap.add_argument("--smoke-only", action="store_true",
                    help="leave out the --same-code timings")
    ap.add_argument("--decode", metavar="TREE",
                    help="time TREE's decode loop (``time_decode``)")
    ap.add_argument("--calls", metavar="TREE",
                    help="Python calls a decode step of TREE's port makes "
                         "on the CPU (``host_calls``)")
    ap.add_argument("--decode-pairs", type=int, metavar="N",
                    help="instead of the chip_smoke runs: N pairs of "
                         "--decode runs of the parent and this checkout")
    args = ap.parse_args()
    if args.same_code:
        print(json.dumps(same_code(args.same_code)), flush=True)
        return 0
    if args.decode:
        print(json.dumps(time_decode(args.decode)), flush=True)
        return 0
    if args.calls:
        print(json.dumps(host_calls(args.calls)), flush=True)
        return 0
    if not args.parent:
        ap.error("give the parent commit's tree")
    if args.decode_pairs:
        os.makedirs(args.out, exist_ok=True)
        summary = decode_pairs(args.parent, args.decode_pairs, args.out)
        print(json.dumps(summary), flush=True)
        return 0
    trees = {"P": os.path.abspath(args.parent), "C": HERE}
    os.makedirs(args.out, exist_ok=True)
    runs, failed = [], False
    for i, tag in enumerate(args.order):
        tree = trees[tag]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                               env=env, capture_output=True, text=True)
        smoke_s = time.perf_counter() - t0
        for name, text in (("out", smoke.stdout), ("err", smoke.stderr)):
            with open(os.path.join(args.out, f"{i}_{tag}_smoke.{name}"),
                      "w") as f:
                f.write(text)
        same = subprocess.CompletedProcess([], 0, "", "") \
            if args.smoke_only else subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--same-code",
                 tree], cwd=tree, env=env, capture_output=True, text=True)
        lines = same.stdout.strip().splitlines()
        run = {"run": i, "tree": tag, "smoke_rc": smoke.returncode,
               "smoke_s": smoke_s, "same_code_rc": same.returncode,
               "smoke": _smoke_numbers(smoke.stdout.splitlines()),
               "same_code": json.loads(lines[-1]) if same.returncode == 0
               and lines else same.stderr[-2000:]}
        failed |= smoke.returncode != 0 or same.returncode != 0
        runs.append(run)
        print(json.dumps(run), flush=True)

    def series(get):
        vals = []
        for r in runs:
            try:
                vals.append(get(r))
            except (KeyError, TypeError, StopIteration, AttributeError,
                    ValueError, ZeroDivisionError):
                vals.append(None)
        return vals

    b2_cases = runs[0]["smoke"]["b2"] if runs else {}
    k2_shapes = runs[0]["smoke"].get("k2", {}) if runs else {}

    def decode_per_step(r, key):
        return r["smoke"]["profile_serve_decode"][key] / 4
    host_bound = runs[0]["smoke"].get("host_bound", {}) if runs else {}
    summary = {"order": args.order, "metrics": {
        **{k: series(lambda r, k=k: r["smoke"]["host_bound"][k])
           for k in host_bound},
        "smoke_s": series(lambda r: r["smoke_s"]),
        **{f"b3_bf16_{k}": series(lambda r, k=k: r["smoke"]["b3"][k])
           for k in ("ms", "device_us", "rel_l2")},
        **{f"b3_float32_{k}": series(
            lambda r, k=k: r["same_code"]["b3_float32"][k])
           for k in ("ms", "device_us")},
        **{f"b5_bf16_{k}": series(lambda r, k=k: r["smoke"]["b5"][k])
           for k in ("ms", "device_us", "rel_l2", "control_rel_l2")},
        **{f"b5_float32_{k}": series(
            lambda r, k=k: r["same_code"]["b5_float32"][k])
           for k in ("ms", "device_us")},
        **{f"ssm_{k}": series(lambda r, k=k: r["smoke"]["ssm"][k])
           for k in ("prefill_s", "decode_ms_per_step",
                     "decode_vs_forward_rel_l2")},
        "ssm_prefill_device_busy_s": series(
            lambda r: r["smoke"]["profile_ssm_prefill"]["device_busy_s"]),
        "ssm_prefill_device_idle_share": series(
            lambda r: r["smoke"]["profile_ssm_prefill"][
                "device_idle_share"]),
        "ssm_prefill_b5_share": series(lambda r: b5_prefill_share(
            r["smoke"]["profile_ssm_prefill"])),
        "ssm_prefill_b5_device_us_per_call": series(
            lambda r: b5_prefill_us_per_call(
                r["smoke"]["profile_ssm_prefill"])),
        **{f"b2_{name}_{k}": series(
            lambda r, n=name, k=k: r["smoke"]["b2"][n][k])
           for name in b2_cases for k in ("ms", "device_us")},
        **{f"b4_{k}": series(lambda r, k=k: r["smoke"]["b4"][k])
           for k in ("ms", "device_us", "library_ms", "library_device_us",
                     "rel_l2")},
        **{f"k2_{what}_{k}": series(
            lambda r, w=what, k=k: r["smoke"]["k2"][w][k])
           for what in k2_shapes for k in ("ms", "device_us", "library_ms")},
        **{f"k2_{what}_device_us_same_code": series(
            lambda r, w=what: next(rec["device_us"] for rec in
                                   r["same_code"]["k2"] if rec["what"] == w))
           for what in k2_shapes},
        "sweep_wall_s_steady": series(
            lambda r: r["smoke"]["sweep_wall_s_steady"]),
        **{f"b7_{k}": series(lambda r, k=k: r["smoke"]["b7"][k])
           for k in ("kernel_ms", "kernel_device_us", "bytes_to_card",
                     "executor_s", "wall_s_sweep_program_plane",
                     "host_prep_s", "rest_s", "plain_ms_card")},
        "b7_ns_per_step": series(
            lambda r: 1e3 * r["smoke"]["b7"]["kernel_device_us"]
            / r["smoke"]["b7"]["chain_steps"]),
        "program_plane_records_wall_s": series(
            lambda r: r["smoke"]["program_plane_records_wall_s"]),
        **{f"k1_{k}": series(lambda r, k=k: r["smoke"]["k1"][k])
           for k in ("kernel_ms", "device_us", "launch_floor_device_us")},
        # K2 has two instances (staged, direct): all launches of both
        "sweep_k2_device_us_per_launch": series(lambda r: k2_per_launch(
            r["smoke"]["profile_sweep"]["hand_kernels"])),
        "sweep_device_busy_s": series(
            lambda r: r["smoke"]["profile_sweep"]["device_busy_s"]),
        "decode_device_busy_ms_per_step": series(
            lambda r: 1e3 * decode_per_step(r, "device_busy_s")),
        "decode_device_launches_per_step": series(
            lambda r: decode_per_step(r, "device_launches")),
        **{f"b2_{name}_to_dense": series(
            lambda r, n=name: r["smoke"]["b2"][n]["ms"]
            / r["smoke"]["b2"]["dense"]["ms"])
           for name in ("n_underutilized", "k_underutilized", "both")},
        **{k: series(lambda r, k=k: r["smoke"][k])
           for k in ("prefill_s", "decode_ms_per_step",
                     "decode_vs_forward_rel_l2")},
        **{f"b9_{dn}_{k}": series(lambda r, dn=dn, k=k: r["smoke"]["b9"][
            dn][k]) for dn in ("bfloat16", "float32")
           for k in ("ms", "device_us", "bound_ms", "library_ms")},
        "b9_bfloat16_rel_l2_max": series(
            lambda r: max(r["smoke"]["b9"]["bfloat16"]["rel_l2"].values())),
        **{f"train_{k}": series(lambda r, k=k: r["smoke"]["train_full"][k])
           for k in ("steady_s_per_step", "tokens_per_s", "mfu",
                     "peak_memory_bytes", "first_step_s")},
        "train_first_loss": series(
            lambda r: r["smoke"]["train_full"]["losses"][0]),
        "train_b9_device_us_per_call": series(
            lambda r: r["smoke"]["profile_train"]["b9_device_us_per_call"]),
        "train_b9_share_of_busy": series(
            lambda r: b9_train_share(r["smoke"]["profile_train"])),
        "train_device_busy_s": series(
            lambda r: r["smoke"]["profile_train"]["device_busy_s"]),
        **{f"b10_{arch}_{dn}_{k}": series(
            lambda r, a=arch, dn=dn, k=k: r["smoke"]["b10"][a][dn][k])
           for arch in (SSM_ARCH, HYBRID_ARCH)
           for dn in ("bfloat16", "float32")
           for k in ("ms", "device_us", "bound_ms")},
        **{f"b10_{arch}_bfloat16_device_us_same_code": series(
            lambda r, a=arch: r["same_code"]["b10_bfloat16"][a])
           for arch in (SSM_ARCH, HYBRID_ARCH)},
        **{f"{key}_{k}": series(lambda r, key=key, k=k: r["smoke"][key][k])
           for _, _, key in SSD_TRAIN
           for k in ("steady_s_per_step", "tokens_per_s", "mfu",
                     "peak_memory_bytes")},
        **{f"{key}_b10_device_us_per_call": series(
            lambda r, key=key: r["smoke"][f"profile_{key}"][
                "b10_device_us_per_call"]) for _, _, key in SSD_TRAIN},
        **{f"{key}_b10_share_of_busy": series(
            lambda r, key=key: b10_train_share(r["smoke"][f"profile_{key}"]))
           for _, _, key in SSD_TRAIN},
        **{f"{key}_device_busy_s": series(
            lambda r, key=key: r["smoke"][f"profile_{key}"]["device_busy_s"])
           for _, _, key in SSD_TRAIN},
        **{f"b9_mla_{dn}_{k}": series(lambda r, dn=dn, k=k: r["smoke"][
            "b9_mla"][dn][k]) for dn in ("bfloat16", "float32")
           for k in ("ms", "device_us", "bound_ms", "library_ms")},
        "b9_mla_bfloat16_rel_l2_max": series(
            lambda r: max(r["smoke"]["b9_mla"]["bfloat16"]["rel_l2"]
                          .values())),
        **{f"{key}_{k}": series(lambda r, key=key, k=k: r["smoke"][key][k])
           for _, _, key in MOE_TRAIN
           for k in ("steady_s_per_step", "tokens_per_s", "mfu",
                     "peak_memory_bytes")},
        "train_mla_b9_device_us_per_call": series(
            lambda r: r["smoke"]["profile_train_mla"][
                "b9_device_us_per_call"]),
        "train_mla_b9_share_of_busy": series(
            lambda r: b9_train_share(r["smoke"]["profile_train_mla"])),
        "train_mla_device_busy_s": series(
            lambda r: r["smoke"]["profile_train_mla"]["device_busy_s"])}}
    first = summary["metrics"]["train_first_loss"]
    summary["train_first_loss_bit_identical"] = (
        None not in first and len(set(first)) == 1)
    print(json.dumps(summary), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
