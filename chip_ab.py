#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA GPU, in turns: a parent commit
against the change.

    mkdir -p build/parent                       # an ignored directory
    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent             # parent, change, change, parent

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
the model's shapes, ``serve_ssm_full`` and its prefill window. Three
metrics are then timed for both trees by the same code, in a process of
its own,

    python3 chip_ab.py --same-code TREE

which imports TREE's port and times it with this checkout's
``chip_smoke`` functions on inputs made from a seed: B3 in float32 at
the prefill's shape (``time_b3``) and B5 in float32 at mamba2-780m's
prefill shape (``time_b5``), which no ``chip_smoke.py`` measures, and
K2's device time at the sweep's four shapes (``time_k2``). Each run prints one JSON
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


def same_code(tree: str) -> dict:
    """B3 of ``tree``'s port in float32 at ``B3_SHAPE``, its B5 in float32
    at ``B5_SHAPE`` and its K2 at the sweep's four shapes, by this
    checkout's ``chip_smoke.time_b3``, ``time_b5`` and ``time_k2``."""
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
            "k2": chip_smoke.time_k2(shapes, np.random.default_rng(0))}


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
    return out


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
    args = ap.parse_args()
    if args.same_code:
        print(json.dumps(same_code(args.same_code)), flush=True)
        return 0
    if not args.parent:
        ap.error("give the parent commit's tree")
    trees = {"P": os.path.abspath(args.parent), "C": HERE}
    os.makedirs(args.out, exist_ok=True)
    runs, failed = [], False
    for i, tag in enumerate(ORDER):
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
        same = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--same-code", tree], cwd=tree, env=env,
                              capture_output=True, text=True)
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
            except (KeyError, TypeError, StopIteration):
                vals.append(None)
        return vals

    b2_cases = runs[0]["smoke"]["b2"] if runs else {}
    k2_shapes = runs[0]["smoke"].get("k2", {}) if runs else {}

    def decode_per_step(r, key):
        return r["smoke"]["profile_serve_decode"][key] / 4
    summary = {"order": ORDER, "metrics": {
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
                     "decode_vs_forward_rel_l2")}}}
    print(json.dumps(summary), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
