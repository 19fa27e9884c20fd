#!/usr/bin/env python3
"""Two trees of the port on one NVIDIA GPU, in turns: a parent commit
against the change.

    mkdir -p build/parent                       # an ignored directory
    git archive <parent> | tar -x -C build/parent
    python3 chip_ab.py build/parent             # parent, change, change, parent
    python3 chip_ab.py build/parent --order PC --smoke-only  # a half of it
    python3 chip_ab.py build/parent --decode-pairs 3  # the decode loops only
    python3 chip_ab.py build/parent --attention  # B3, B9 and deepseek only
    python3 chip_ab.py build/parent --k1         # K1, its launches, the cube
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

Four whole ``chip_smoke.py`` runs (~1 050 s each on the H100) no longer
fit one command limited to 3 600 s. ``--attention``
compares what a change to B3 or B9 moves, each tree in a process of its
own in the turns of ``--order`` (``attention_code``): both kernels at the
model paths' shapes (``ATTN_B3_SHAPES``, ``ATTN_B9_SHAPES``; at deepseek-v2's
the whole ``kernels.b3_mla`` / ``kernels.b9_mla`` record), deepseek-v2's
prefill (``serve_mla_full``, B3's share of its profile) and its training
step (``train_mla_full``'s steady s/step and first loss, B3's and B9's
device µs a call and shares of the profiled step), by this checkout's
``chip_smoke`` code over each tree's port. A whole run's summary reads
the same deepseek-v2 numbers (``b3_mla_*``, ``serve_mla_*``,
``train_mla_*``).
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


#: B3 and B9 at the model shapes ``--attention`` times: name -> (B, Sq,
#: Sk, H, Hkv, D, Dv, mask); deepseek's and the reduced config's inputs
#: as ``chip_smoke.mla_attention_inputs`` makes them (v a strided view)
ATTN_B3_SHAPES = {
    "deepseek": (4, 2048, 2048, 128, 128, 192, 128, {}),
    "qwen": (4, 2048, 2048, 16, 2, 128, 128, {}),
    "hymba": (4, 4096, 4096, 25, 5, 64, 64, dict(window=2048)),
    "paligemma": (4, 2304, 2304, 8, 1, 256, 256, dict(prefix_len=256)),
    "hubert": (4, 1500, 1500, 16, 16, 80, 80, dict(causal=False)),
    "granite": (4, 2048, 2048, 16, 8, 64, 64, {}),
    "reduced": (4, 2048, 2048, 4, 4, 24, 16, {}),
    "chunked": (4, 1024, 2048, 16, 2, 128, 128, dict(q_offset=1024))}
ATTN_B9_SHAPES = {
    "deepseek": (1, 2048, 2048, 128, 128, 192, 128, {}),
    "qwen": (1, 2048, 2048, 16, 2, 128, 128, {}),
    "hymba": (1, 4096, 4096, 25, 5, 64, 64, dict(window=2048)),
    "paligemma": (1, 2048, 2048, 8, 1, 256, 256, dict(prefix_len=256)),
    "hubert": (2, 1500, 1500, 16, 16, 80, 80, dict(causal=False)),
    "reduced": (1, 2048, 2048, 4, 4, 24, 16, {}),
    "chunked": (1, 1024, 2048, 16, 2, 128, 128, dict(q_offset=1024))}


def _attn_inputs(gen, B, Sq, Sk, H, Hkv, D, Dv):
    """bf16 q, k, v, do on the card: MLA's head dims as ``blocks.mla_qkv``
    lays them out, other pairs dense."""
    import torch
    import chip_smoke
    bf, dev = torch.bfloat16, "cuda"
    dims = {(192, 128): (128, 64, 128),
            (24, 16): chip_smoke.MLA_REDUCED_DIMS}.get((D, Dv))
    if dims is not None and Sq == Sk and H == Hkv:
        q, k, v = chip_smoke.mla_attention_inputs(gen, B, Sq, H, bf, dev,
                                                  dims)
    else:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(bf) for s in
                   ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv)))
    return q, k, v, torch.randn((B, Sq, H, Dv), generator=gen,
                                device=dev).to(bf)


def attention_code(tree: str) -> dict:
    """B3 and B9 of ``tree``'s port and deepseek-v2-236b's two paths, by
    this checkout's ``chip_smoke`` code: each kernel's device µs and ms a
    call at ``ATTN_B3_SHAPES`` / ``ATTN_B9_SHAPES`` (at deepseek's the
    whole ``kernels.b3_mla`` / ``kernels.b9_mla`` record: the plain
    version, the bound, ``sdpa``); ``serve_mla_full``'s prefill and its
    profile (B3's share of the busy time); ``train_mla_full`` (steady
    s/step, the first loss) and its ``profile_train`` step (B3's and B9's
    device µs a call and shares of the busy time)."""
    import gc

    import chip_smoke  # this checkout's: the same timing code for both
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import repro_torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab.py --attention-code: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.smi_line()
    out = {"port": os.path.dirname(repro_torch.__file__), "card": card,
           "b3": {}, "b9": {}}
    b3_name = chip_smoke.B3_KERNELS["bfloat16"]
    for name, (B, Sq, Sk, H, Hkv, D, Dv, mask) in ATTN_B3_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v, _ = _attn_inputs(gen, B, Sq, Sk, H, Hkv, D, Dv)
        if name == "deepseek":
            out["b3"][name] = chip_smoke.time_b3(q, k, v)
        else:
            run = lambda: flash_attention(q, k, v, **mask)  # noqa: E731
            out["b3"][name] = {"ms": chip_smoke.event_ms(run, 10),
                               "device_us": chip_smoke.kernel_device_us(
                                   run, b3_name)}
        del q, k, v
        torch.cuda.empty_cache()
    for name, (B, Sq, Sk, H, Hkv, D, Dv, mask) in ATTN_B9_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(9)
        q, k, v, do = _attn_inputs(gen, B, Sq, Sk, H, Hkv, D, Dv)
        if name == "deepseek":
            rec = chip_smoke.b9_masked_case(
                q, k, v, do, dict(causal=True, window=None, prefix_len=0),
                f"flash_attention_bwd[deepseek {(B, Sq, H)}]", True,
                plain_heads=chip_smoke.B9_MLA_PLAIN_HEADS)
        else:
            o, lse = flash_attention(q, k, v, return_lse=True, **mask)
            call = lambda: flash_attention_bwd(  # noqa: E731
                q, k, v, o, lse, do, **mask)
            rec = {"ms": chip_smoke.event_ms(call, 5, warmup=2),
                   "device_us": chip_smoke.calls_device_us(
                       call, chip_smoke.B9_KERNELS["bfloat16"],
                       chip_smoke.B9_CALL_KERNEL)}
            del o, lse
        out["b9"][name] = rec
        del q, k, v, do
        torch.cuda.empty_cache()
    arch = chip_smoke.MLA_ARCH
    rec, srv, prompts = chip_smoke.serve_full(card, arch)
    prof = chip_smoke.profile_serve(srv, prompts, (b3_name,))["prefill"]
    out["serve_mla"] = {
        "prefill_s": rec.get("prefill_s"),
        "launches": rec.get("launches"),
        "prefill_device_busy_s": prof.get("device_busy_s"),
        "prefill_b3_share": _share(prof, b3_name)}
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    path = dict((a, p) for _, a, p in chip_smoke.TRAIN_MOE_PATHS)[arch]
    tr = chip_smoke.train_full(card, arch, path)
    torch.cuda.empty_cache()
    prof = chip_smoke.profile_train(
        (b3_name, *chip_smoke.B9_KERNELS["bfloat16"]), arch, path)
    b3 = [v for n, v in prof.get("hand_kernels", {}).items()
          if b3_name in n]
    out["train_mla"] = {
        **{k: tr.get(k) for k in ("steady_s_per_step", "losses",
                                  "launches_per_step", "peak_memory_bytes")},
        "device_busy_s": prof.get("device_busy_s"),
        "b9_device_us_per_call": prof.get("b9_device_us_per_call"),
        "b3_device_us_per_call": sum(v["device_us_total"] for v in b3)
        / sum(v["launches"] for v in b3) if b3 else None,
        "b9_share": prof.get("b9_share_of_busy"),
        "b3_share": prof.get("b3_share_of_busy")}
    return out


def _share(prof: dict, part: str):
    """The share of a profile's device busy time in the hand kernels whose
    name holds ``part``."""
    if not prof.get("device_busy_s"):
        return None
    return sum(v["device_us_total"] for k, v in prof["hand_kernels"].items()
               if part in k) * 1e-6 / prof["device_busy_s"]


def tree_runs(flag: str, parent: str, order: str, out_dir: str
              ) -> tuple[list, bool, object]:
    """``chip_ab.py FLAG TREE`` for the parent (``P``) and this checkout
    (``C``) in the turns of ``order``, a process each, each printing one
    JSON line (kept under ``out_dir``). Returns the runs, whether one
    failed, and ``series(get)``: ``get`` of each run, None where it has
    no such value."""
    trees = {"P": os.path.abspath(parent), "C": HERE}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    tag_ = flag.strip("-").replace("-code", "")
    runs, failed = [], False
    for i, tag in enumerate(order):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            flag, trees[tag]], cwd=trees[tag],
                           env=env, capture_output=True, text=True)
        with open(os.path.join(out_dir, f"{tag_}_{i}_{tag}.err"),
                  "w") as f:
            f.write(r.stderr)
        lines = r.stdout.strip().splitlines()
        rec = json.loads(lines[-1]) if r.returncode == 0 and lines \
            else {"error": r.stderr[-3000:]}
        failed |= r.returncode != 0
        runs.append({"run": i, "tree": tag, "rc": r.returncode, **rec})
        print(json.dumps(runs[-1]), flush=True)

    def series(get):
        vals = []
        for r in runs:
            try:
                vals.append(get(r))
            except (KeyError, TypeError, ValueError, ZeroDivisionError):
                vals.append(None)
        return vals
    return runs, failed, series


def attention_runs(parent: str, order: str, out_dir: str) -> dict:
    """``--attention``: ``attention_code`` of the parent (``P``) and this
    checkout (``C``) in the turns of ``order``, a process each; per metric
    the values of the runs in order."""
    runs, failed, series = tree_runs("--attention-code", parent, order,
                                     out_dir)
    metrics = {
        **{f"b3_{n}_{k}": series(lambda r, n=n, k=k: r["b3"][n][k])
           for n in ATTN_B3_SHAPES for k in ("device_us", "ms")},
        **{f"b3_deepseek_{k}": series(lambda r, k=k: r["b3"]["deepseek"][k])
           for k in ("bound_ms", "library_ms", "library_device_us",
                     "rel_l2")},
        **{f"b9_{n}_{k}": series(lambda r, n=n, k=k: r["b9"][n][k])
           for n in ATTN_B9_SHAPES for k in ("device_us", "ms")},
        **{f"b9_deepseek_{k}": series(lambda r, k=k: r["b9"]["deepseek"][k])
           for k in ("bound_ms", "library_ms", "rel_l2")},
        **{f"serve_mla_{k}": series(lambda r, k=k: r["serve_mla"][k])
           for k in ("prefill_s", "prefill_device_busy_s",
                     "prefill_b3_share")},
        **{f"train_mla_{k}": series(lambda r, k=k: r["train_mla"][k])
           for k in ("steady_s_per_step", "device_busy_s",
                     "b9_device_us_per_call", "b3_device_us_per_call",
                     "b9_share", "b3_share")},
        "train_mla_first_loss": series(
            lambda r: r["train_mla"]["losses"][0])}
    first = metrics["train_mla_first_loss"]
    return {"order": order, "failed": failed, "metrics": metrics,
            "train_mla_first_loss_bit_identical":
                None not in first and len(set(first)) == 1}


#: the shapes ``--k1`` times K1 at: the sweep's call (``sweep_full``'s,
#: ``chip_smoke.sweep_kernel_inputs``) and one fleet-day call's
K1_SHAPES = ("sweep", "fleet_call")


def k1_code(tree: str) -> dict:
    """K1 of ``tree``'s port by this checkout's ``chip_smoke`` code, at
    ``K1_SHAPES``: held ``torch.equal`` to its plain version (every
    output), its device µs a call (``kernel_device_us``), its ms a call by
    CUDA events and the wrapper's host µs a call (200 calls issued, no
    sync between them), beside the launch floor (a one-element add's
    device time); then K1's launches in sweep_full's sweep and in the
    whole fleet day, and a digest of sweep_full's cube."""
    import chip_smoke  # this checkout's: the same timing code for both
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    import repro_torch
    from repro_torch.core.fleet import sweep_fleet
    from repro_torch.core.hw import NPUS
    from repro_torch.core.policies import POLICIES, KnobGrid
    from repro_torch.core.sweep import sweep_grid
    from repro_torch.kernels.sa_occupancy import (sa_occupancy,
                                                  sa_occupancy_plain)
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab.py --k1-code: no CUDA device")
    dev = torch.device("cuda")
    sweep_in = chip_smoke.sweep_kernel_inputs(dev)
    args = {"sweep": (*sweep_in["mm"], sweep_in["saw"]),
            "fleet_call": chip_smoke.fleet_call_k1_inputs(dev)}
    out = {"port": os.path.dirname(repro_torch.__file__),
           "card": chip_smoke.smi_line(), "k1": {}}
    for name in K1_SHAPES:
        a = args[name]
        got, want = sa_occupancy(*a), sa_occupancy_plain(*a)
        equal = all(torch.equal(got[k], want[k]) for k in want)
        run = lambda: sa_occupancy(*a)  # noqa: E731
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            run()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        out["k1"][name] = {
            "n": int(a[0].shape[0]), "S": int(torch.as_tensor(a[3]).numel()),
            "equal_to_plain": equal, "host_us": host_us,
            "ms": chip_smoke.event_ms(run, 200),
            "device_us": chip_smoke.kernel_device_us(
                run, "sa_occupancy_kernel")}
    one = torch.ones(1, device=dev)
    one_out = torch.empty_like(one)
    out["launch_floor_device_us"] = chip_smoke.kernel_device_us(
        lambda: torch.add(one, 1.0, out=one_out))
    sa_occupancy.launches = 0
    res = sweep_grid(sweep_in["suite"], npus=tuple(NPUS), policies=POLICIES,
                     as_records=False, **chip_smoke.FULL_GRID)
    out["launches_sweep"] = sa_occupancy.launches
    out["sweep_cube_sha256"] = chip_smoke.cube_sha256(res)
    sa_occupancy.launches = 0
    day = sweep_fleet(chip_smoke.fleet_day(),
                      KnobGrid(**chip_smoke.FLEET_GRID), device=dev)
    out["launches_fleet_day"] = sa_occupancy.launches
    out["fleet_day_requests"] = day.requests_total
    return out


def k1_runs(parent: str, order: str, out_dir: str) -> dict:
    """``--k1``: ``k1_code`` of the parent (``P``) and this checkout
    (``C``) in the turns of ``order``, a process each; per metric the
    values of the runs in order, and whether every run's sweep cube had
    the same digest."""
    runs, failed, series = tree_runs("--k1-code", parent, order, out_dir)
    metrics = {
        **{f"k1_{n}_{k}": series(lambda r, n=n, k=k: r["k1"][n][k])
           for n in K1_SHAPES for k in ("device_us", "ms", "host_us", "n",
                                         "S", "equal_to_plain")},
        **{k: series(lambda r, k=k: r[k]) for k in (
            "launch_floor_device_us", "launches_sweep",
            "launches_fleet_day")}}
    digests = series(lambda r: r["sweep_cube_sha256"])
    return {"order": order, "failed": failed, "metrics": metrics,
            "sweep_cube_bit_identical":
                None not in digests and len(set(digests)) == 1}


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
    # the run's budget: the last phase line's t_s, and the run's own
    # summary where it prints one
    t_s = [obj["t_s"] for objs in phases.values() for obj in objs
           if "t_s" in obj and obj["phase"] != "run_budget"]
    out["last_phase_t_s"] = max(t_s) if t_s else None
    budget = phases.get("run_budget", [{}])[0]
    out["run_budget"] = {k: budget.get(k) for k in (
        "host_wall_s", "last_phase_t_s", "parity_s", "longest")}
    out["parity_s"] = {p: [obj.get("t_s") for obj in objs] for p, objs in
                       phases.items() if "parity" in p}
    out["sweep_cube_sha256"] = phases.get("sweep_full", [{}])[0].get(
        "cube_sha256")
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
    b3_mla = phases.get("kernels.b3_mla", [{}])[0].get("model_shape", {})
    out["b3_mla"] = {k: b3_mla.get(k) for k in (
        "ms", "device_us", "bound_ms", "library_ms", "library_device_us",
        "rel_l2")}
    mla = phases.get("serve_mla_full", [{}])[0]
    prof = [p for p in phases.get("profile_serve", [])
            if p.get("arch") == MLA_ARCH]
    pre = prof[0]["prefill"] if prof else {}
    out["serve_mla"] = {"prefill_s": mla.get("prefill_s"),
                        "prefill_device_busy_s": pre.get("device_busy_s"),
                        "prefill_b3_share": _share(pre, "flash_attention")}
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
        "b9_device_us_per_call", "b9_share_of_busy", "b3_share_of_busy",
        "hand_kernels")} if prof else {}
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
    ap.add_argument("--attention", action="store_true",
                    help="instead of the chip_smoke runs: B3, B9 and "
                         "deepseek-v2's paths of each tree "
                         "(``attention_code``), in the turns of --order")
    ap.add_argument("--attention-code", metavar="TREE",
                    help=argparse.SUPPRESS)
    ap.add_argument("--k1", action="store_true",
                    help="instead of the chip_smoke runs: K1 of each tree "
                         "at the sweep's and a fleet call's shapes, its "
                         "launches and sweep_full's cube (``k1_code``), "
                         "in the turns of --order")
    ap.add_argument("--k1-code", metavar="TREE", help=argparse.SUPPRESS)
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
    if args.attention_code:
        print(json.dumps(attention_code(args.attention_code)), flush=True)
        return 0
    if args.k1_code:
        print(json.dumps(k1_code(args.k1_code)), flush=True)
        return 0
    if args.calls:
        print(json.dumps(host_calls(args.calls)), flush=True)
        return 0
    if not args.parent:
        ap.error("give the parent commit's tree")
    if args.attention or args.k1:
        os.makedirs(args.out, exist_ok=True)
        summary = (k1_runs if args.k1 else attention_runs)(
            args.parent, args.order, args.out)
        print(json.dumps(summary), flush=True)
        return 1 if summary["failed"] else 0
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
        "last_phase_t_s": series(lambda r: r["smoke"]["last_phase_t_s"]),
        "run_budget_parity_s": series(
            lambda r: r["smoke"]["run_budget"]["parity_s"]),
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
        **{f"b3_mla_{k}": series(lambda r, k=k: r["smoke"]["b3_mla"][k])
           for k in ("ms", "device_us", "bound_ms", "library_ms",
                     "rel_l2")},
        **{f"serve_mla_{k}": series(lambda r, k=k: r["smoke"]["serve_mla"][k])
           for k in ("prefill_s", "prefill_device_busy_s",
                     "prefill_b3_share")},
        "train_mla_b3_share_of_busy": series(
            lambda r: r["smoke"]["profile_train_mla"]["b3_share_of_busy"]),
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
    cubes = series(lambda r: r["smoke"]["sweep_cube_sha256"])
    # None where a run's chip_smoke.py prints no digest
    summary["sweep_cube_bit_identical"] = None if None in cubes \
        else len(set(cubes)) == 1
    print(json.dumps(summary), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
