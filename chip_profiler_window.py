#!/usr/bin/env python3
"""How far ``torch.profiler``'s device time stamps stray from the host's
clock, and whether ``chip_smoke.kernel_device_us``'s padded window keeps
every record, on one NVIDIA GPU.

    python3 chip_profiler_window.py [SECONDS]

For SECONDS (default 200) the card runs bf16 8192² matmuls, 40 to a
round. Every 20 rounds it profiles 5 calls of B4 ``decode_attention`` at
qwen2.5-3b's one-layer decode shape (two kernels a call, about 12 µs of
device time) twice, with the host's ``cudaLaunchKernel`` records: once in
a window that holds only the calls, once in a window padded by
``chip_smoke.PROFILE_PAD_S`` on both sides. A record kept is a kernel
whose stamp fell inside the window; a kernel's stamp minus its launch's
is below 0 where the device stamp came out before the host launched it.

Prints the card's name and power limit, one JSON line per profile and a
summary line: per window, the profiles that lost records and the most
negative kernel-minus-launch gap. Needs one card; exits non-zero without
one, or if a padded window lost a record.
"""
from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = 5
KERNELS = ("decode_attention_kernel", "decode_attention_combine_kernel")


def profile_calls(fn, pad: float) -> dict:
    """One profile of ``CALLS`` calls of ``fn``, its window padded by
    ``pad`` seconds on both sides."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    events = list(prof.profiler.kineto_results.events())
    launches = sorted(e.start_ns() for e in events
                      if e.name() == "cudaLaunchKernel")
    kernels = sorted(e.start_ns() for e in events
                     if e.device_type() == DeviceType.CUDA
                     and any(k in e.name() for k in KERNELS))
    gaps = [(k - ln) / 1e3 for k, ln in zip(kernels, launches)]
    return {"launched": len(launches), "kept": len(kernels),
            "min_kernel_minus_launch_us": min(gaps) if gaps else None}


def main() -> int:
    import torch
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    if not torch.cuda.is_available():
        print("chip_profiler_window: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.decode_attention import decode_attention
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 200.0
    print(chip_smoke.smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(4, 1, 16, 128, device="cuda", dtype=torch.bfloat16,
                    generator=gen)
    kc, vc = (torch.randn(4, 2080, 2, 128, device="cuda",
                          dtype=torch.bfloat16, generator=gen)
              for _ in range(2))
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16,
                    generator=gen)

    def fn():
        decode_attention(q, kc, vc, 2078)

    fn()
    torch.cuda.synchronize()
    windows = {"bare": 0.0, "padded": chip_smoke.PROFILE_PAD_S}
    seen = {w: [] for w in windows}
    t0 = time.perf_counter()
    rounds = 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(40):
            a @ a
        torch.cuda.synchronize()
        rounds += 1
        if rounds % 20:
            continue
        for w, pad in windows.items():
            rec = profile_calls(fn, pad)
            rec.update(window=w, t_s=time.perf_counter() - t0)
            seen[w].append(rec)
            print(json.dumps(rec), flush=True)
    summary = {}
    for w, recs in seen.items():
        gaps = [r["min_kernel_minus_launch_us"] for r in recs
                if r["min_kernel_minus_launch_us"] is not None]
        summary[w] = {"profiles": len(recs),
                      "lossy": sum(r["kept"] < r["launched"] for r in recs),
                      "kept_none": sum(r["kept"] == 0 for r in recs),
                      "min_kernel_minus_launch_us": min(gaps, default=None)}
    print(json.dumps({"pad_s": chip_smoke.PROFILE_PAD_S, **summary}),
          flush=True)
    return 1 if summary["padded"]["lossy"] else 0


if __name__ == "__main__":
    sys.exit(main())
