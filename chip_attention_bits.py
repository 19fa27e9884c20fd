#!/usr/bin/env python3
"""Are the attention kernels' bits unchanged between two trees?

    python3 chip_attention_bits.py PARENT_TREE [--out DIR]

Runs kernels B3 (``flash_attention``, with and without its row
log-sum-exp), B4 (``decode_attention``) and B9 (``flash_attention_bwd``)
of the port in PARENT_TREE and in this checkout, each tree in a child
process of its own (``PYTHONPATH=TREE/src``, its kernels built into
``TREE/build/repro_torch``), on the same seeded inputs: every head dim,
both dtypes, causal and bidirectional, ragged lengths, GQA groups of 1
to 8, decode lengths on and next to split boundaries. Only arguments
both trees' wrappers take are used. Every output must be ``torch.equal``
across the trees; the last line is a JSON summary, and the exit code is
1 if any output differs. Needs one NVIDIA card and ``nvcc``; a tree is
made with ``git archive <commit> | tar -x -C TREE`` under an ignored
directory such as ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

B3_CASES = [  # (B, S, H, Hkv, D, causal)
    (2, 1, 2, 1, 128, True), (2, 17, 16, 2, 128, True),
    (1, 130, 4, 4, 64, True), (2, 257, 8, 1, 16, True),
    (2, 200, 4, 2, 32, False), (1, 2049, 16, 2, 128, True),
    (2, 300, 8, 1, 64, False), (1, 1000, 4, 4, 32, True)]
B4_CASES = [  # (B, S, H, Hkv, D, cache_len)
    (4, 2080, 16, 2, 128, 2079), (4, 2080, 2, 2, 64, 127),
    (3, 512, 8, 8, 16, 128), (2, 700, 4, 2, 32, 0),
    (4, 2080, 16, 2, 64, 64)]
B9_CASES = [  # (B, S, H, Hkv, D, causal)
    (2, 63, 16, 2, 128, True), (1, 257, 8, 1, 128, True),
    (2, 130, 4, 2, 16, True), (1, 300, 8, 1, 64, False),
    (1, 1000, 4, 4, 32, True)]


def dump(path: str) -> None:
    """In a child: run every case with this tree's port, save the
    outputs (on the CPU) to ``path``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    def rnd(seed, dtype, *shapes):
        g = torch.Generator().manual_seed(seed)
        return [torch.randn(s, generator=g).to("cuda", dtype)
                for s in shapes]

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for i, (B, S, H, Hkv, D, causal) in enumerate(B3_CASES):
            q, k, v = rnd(i, dtype, (B, S, H, D), (B, S, Hkv, D),
                          (B, S, Hkv, D))
            out[f"b3/{dn}/{i}"] = flash_attention(q, k, v, causal=causal)
            o, lse = flash_attention(q, k, v, causal=causal,
                                     return_lse=True)
            out[f"b3_lse/{dn}/{i}/o"], out[f"b3_lse/{dn}/{i}/lse"] = o, lse
        for i, (B, S, H, Hkv, D, clen) in enumerate(B4_CASES):
            q, kc, vc = rnd(100 + i, dtype, (B, 1, H, D), (B, S, Hkv, D),
                            (B, S, Hkv, D))
            out[f"b4/{dn}/{i}"] = decode_attention(q, kc, vc, clen)
        for i, (B, S, H, Hkv, D, causal) in enumerate(B9_CASES):
            q, k, v, do = rnd(200 + i, dtype, (B, S, H, D), (B, S, Hkv, D),
                              (B, S, Hkv, D), (B, S, H, D))
            o, lse = flash_attention(q, k, v, causal=causal,
                                     return_lse=True)
            for name, g in zip("qkv", flash_attention_bwd(
                    q, k, v, o, lse, do, causal=causal)):
                out[f"b9/{dn}/{i}/d{name}"] = g
    torch.cuda.synchronize()
    torch.save({k: t.cpu() for k, t in out.items()}, path)
    info = _build.BUILD_INFO
    print(json.dumps({"outputs": len(out), "ptxas": [
        ln for name in ("attention", "attention_bwd")
        for ln in info.get(name, {}).get("log", "").splitlines()
        if "registers" in ln or "Compiling entry" in ln or "spill" in ln]}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--out", default=os.path.join("build", "attention_bits"))
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dump:
        dump(args.dump)
        return 0
    if not args.parent:
        ap.error("give the parent tree")
    import torch
    if not torch.cuda.is_available():
        print("chip_attention_bits: needs an NVIDIA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    logs = {}
    for name, tree in trees.items():
        path = os.path.join(os.path.abspath(args.out), f"{name}.pt")
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
        env.pop("REPRO_TORCH_BUILD_DIR", None)
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--dump", path], cwd=tree, env=env,
                           capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            print(f"chip_attention_bits: the {name} tree failed",
                  file=sys.stderr)
            return 1
        logs[name] = json.loads(r.stdout.strip().splitlines()[-1])
    a, b = (torch.load(os.path.join(args.out, f"{n}.pt")) for n in trees)
    differ = sorted(k for k in a if not torch.equal(a[k], b.get(k)))
    print(json.dumps({"ptxas_change": logs["change"]["ptxas"]}))
    print(json.dumps({"outputs": len(a), "missing": sorted(set(a) - set(b)),
                      "differ": differ, "bit_identical": not differ}))
    return 1 if differ or set(a) != set(b) else 0


if __name__ == "__main__":
    sys.exit(main())
