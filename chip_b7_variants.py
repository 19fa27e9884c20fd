#!/usr/bin/env python3
"""Kernel B7 ``program_exec`` in other builds of its one source, on one
NVIDIA GPU.

    python3 chip_b7_variants.py

``csrc/program_plane.cu`` is written for ``UT`` units a thread and a
shared-memory ring of stages of ``D`` events; the port builds it with
``UT = 1`` (a lane a unit, the bundle's start taken by shuffles) and
``D = 128``. This script writes copies of that source with the two
constants replaced (``VARIANTS``: ``UT = 4`` is one thread a row, its
four units in registers), builds each with the ``program_plane``
library's flags (one ``nvcc`` each, all started together) and runs each
through the port's stream entry (``program_exec_streams``) on the inputs
of ``chip_smoke.py``'s ``program_plane_full`` phase: the paper suite x
every NPU x ``PP_FULL_GRID``, 1 530 rows on 510 event streams. Each is
held ``torch.equal`` to the plain version evaluated on the CPU and timed
by its device µs a call (``chip_smoke.kernel_device_us``) and by CUDA
events (``chip_smoke.event_ms``), the port's own build first and last.

Prints the card's name and power limit, one JSON line per variant, and a
summary line. Needs one card; exits non-zero without one or if a
variant gives other results.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# (units a thread, events a ring stage); (1, 128) is the port's build
VARIANTS = ((1, 64), (1, 256), (4, 64), (4, 128), (4, 256))
PORT = (1, 128)
OUT = os.path.join(HERE, "build", "b7_variants")


def variant_source(text: str, ut: int, d: int) -> str:
    """The port's source with its two constants set to ``ut`` and ``d``."""
    for name, old, new in (("UT", PORT[0], ut), ("D", PORT[1], d)):
        decl = f"constexpr int {name} = {old};"
        if text.count(decl) != 1:
            raise SystemExit(f"{decl!r} is not in program_plane.cu once")
        text = text.replace(decl, f"constexpr int {name} = {new};")
    return text


def build(variants) -> dict:
    """Each variant's library, built by parallel ``nvcc``s."""
    from repro_torch.kernels import _build
    nvcc = _build.find_nvcc()
    lib = _build.LIBRARIES["program_plane"]
    os.makedirs(OUT, exist_ok=True)
    text = lib.source.read_text()
    procs = {}
    for ut, d in variants:
        src = os.path.join(OUT, f"program_plane_ut{ut}_d{d}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, ut, d))
        path = os.path.join(OUT, f"libprogram_plane_ut{ut}_d{d}.so")
        cmd = [nvcc, *lib.flags, "-I", str(lib.source.parent), "-o", path,
               src]
        procs[(ut, d)] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    paths = {}
    for key, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        paths[key] = (path, [ln for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln])
    return paths


def main() -> int:
    sys.path.insert(0, os.path.join(HERE, "src"))
    import ctypes

    import torch
    if not torch.cuda.is_available():
        print("chip_b7_variants.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.core import program_plane as pp
    from repro_torch.core.hw import NPUS, get_npu
    from repro_torch.core.opgen import paper_suite
    from repro_torch.core.policies import KnobGrid, knob_pairs
    from repro_torch.kernels import _build
    from repro_torch.kernels.program_exec import (program_exec_streams,
                                                  program_exec_streams_plain)

    print(chip_smoke.smi_line(), flush=True)
    paths = build(VARIANTS)
    triples, _ = knob_pairs(tuple(KnobGrid(**chip_smoke.PP_FULL_GRID)
                                  .product()))
    progs, dscales, stream_of_row, window, delay, horizon = pp._plane_rows(
        paper_suite(), [get_npu(n) for n in NPUS], triples)
    pa = pp.build_program_arrays(progs, dscales)
    args = pp._upload_streams(pa, stream_of_row, window, delay, horizon,
                              "cuda")
    want = program_exec_streams_plain(
        *pp._upload_streams(pa, stream_of_row, window, delay, horizon,
                            "cpu"))
    port_load = _build.load

    def run(variant):
        if variant is None:
            _build.load = port_load
        else:
            lib = ctypes.CDLL(paths[variant][0])
            _build._bind_program_plane(lib)
            _build.load = lambda name: lib
        try:
            got = program_exec_streams(*args)
            same = all(torch.equal(got[k].cpu(), v) for k, v in want.items())
            us = chip_smoke.kernel_device_us(
                lambda: program_exec_streams(*args), "program_exec_kernel")
            ms = chip_smoke.event_ms(lambda: program_exec_streams(*args), 10,
                                     warmup=2)
        finally:
            _build.load = port_load
        return {"variant": f"port {PORT}" if variant is None
                else list(variant), "equal_to_plain": same,
                "device_us": us, "ms": ms,
                "ptxas": paths[variant][1] if variant else None}

    results = []
    for variant in (None, *VARIANTS, None):
        rec = run(variant)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    chain = int(pa.lengths[stream_of_row].max())
    print(json.dumps({
        "rows": len(stream_of_row), "streams": pa.n_streams,
        "longest_row_events": chain,
        "ns_per_step": [[r["variant"], 1e3 * r["device_us"] / chain]
                        for r in results],
        "all_equal": all(r["equal_to_plain"] for r in results)}),
        flush=True)
    return 0 if all(r["equal_to_plain"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
