#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA GPU, in turns: a parent commit
against the change.

    mkdir -p build/parent                       # an ignored directory
    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent             # parent, change, change, parent

Each run (``P`` the parent tree, ``C`` this checkout, in the order
``ORDER``) runs that tree's ``chip_smoke.py``, keeps its standard output
under ``--out`` and reads from it the numbers compared: B3 at the
prefill's shape (``kernels_model_shapes``), B2's five
``gated_matmul_full`` cases, ``serve_full`` and ``profile_serve``'s
prefill. One metric no ``chip_smoke.py`` measures, B3 in float32 at the
prefill's shape, is then timed in a process of its own,

    python3 chip_ab.py --b3-float32 TREE

which imports TREE's port and times it with this checkout's
``chip_smoke.time_b3`` (the same code for both trees) on inputs made
from a seed. Each run prints one JSON line and the last line is a
summary: per metric, the values of the runs in order. Each tree builds
its kernels into its own ``build/`` at its first run. Needs one card; it
exits non-zero if any run fails.
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


def b3_float32(tree: str) -> dict:
    """B3 of ``tree``'s port in float32 at ``B3_SHAPE``, by
    ``chip_smoke.time_b3``."""
    import chip_smoke  # this checkout's: the same timing code for both
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import repro_torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab.py --b3-float32: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, Hkv, D = B3_SHAPE
    q, k, v = (torch.randn((B, S, h, D), generator=gen, device="cuda")
               for h in (H, Hkv, Hkv))
    return {"port": os.path.dirname(repro_torch.__file__),
            **chip_smoke.time_b3(q, k, v)}


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
    shapes = [p for p in phases.get("kernels_model_shapes", [])
              if p.get("arch") == "qwen2.5-3b"]
    if shapes:
        b3 = shapes[0]["flash_attention"]
        out["b3"] = {k: b3.get(k) for k in (
            "ms", "device_us", "plain_ms", "library_ms", "max_abs_err",
            "rel_l2", "median_abs_plain", "control_rel_l2")}
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
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", help="the parent commit's tree")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "ab"))
    ap.add_argument("--b3-float32", metavar="TREE")
    args = ap.parse_args()
    if args.b3_float32:
        print(json.dumps(b3_float32(args.b3_float32)), flush=True)
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
        f32 = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--b3-float32", tree], cwd=tree, env=env,
                             capture_output=True, text=True)
        lines = f32.stdout.strip().splitlines()
        run = {"run": i, "tree": tag, "smoke_rc": smoke.returncode,
               "smoke_s": smoke_s, "b3_float32_rc": f32.returncode,
               "smoke": _smoke_numbers(smoke.stdout.splitlines()),
               "b3_float32": json.loads(lines[-1]) if f32.returncode == 0
               and lines else f32.stderr[-2000:]}
        failed |= smoke.returncode != 0 or f32.returncode != 0
        runs.append(run)
        print(json.dumps(run), flush=True)

    def series(get):
        vals = []
        for r in runs:
            try:
                vals.append(get(r))
            except (KeyError, TypeError):
                vals.append(None)
        return vals

    b2_cases = runs[0]["smoke"]["b2"] if runs else {}
    summary = {"order": ORDER, "metrics": {
        **{f"b3_bf16_{k}": series(lambda r, k=k: r["smoke"]["b3"][k])
           for k in ("ms", "device_us", "rel_l2")},
        **{f"b3_float32_{k}": series(lambda r, k=k: r["b3_float32"][k])
           for k in ("ms", "device_us")},
        **{f"b2_{name}_{k}": series(
            lambda r, n=name, k=k: r["smoke"]["b2"][n][k])
           for name in b2_cases for k in ("ms", "device_us")},
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
