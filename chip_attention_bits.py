#!/usr/bin/env python3
"""Are the attention kernels' bits unchanged between two trees?

    python3 chip_attention_bits.py PARENT_TREE [--out DIR]

Runs kernels B3 (``flash_attention``, with and without its row
log-sum-exp), B4 (``decode_attention``) and B9 (``flash_attention_bwd``)
of the port in PARENT_TREE and in this checkout, each tree in a child
process of its own (``PYTHONPATH=TREE/src``, its kernels built into
``TREE/build/repro_torch``), on the same seeded inputs: every head dim,
both dtypes, causal and bidirectional, ragged lengths, GQA groups of 1
to 8, decode lengths on and next to split boundaries; B3 and B9 also
under windows and prefixes (``MASK_CASES``), and at multi-head latent
attention's (192, 128) (``MLA_CASES``: H == Hkv with v a strided view, as
the model makes it, and one GQA group; B3's ``tiles_loaded`` too). Only
arguments both trees' wrappers take are used for these. Every output must
be ``torch.equal`` across the trees.

A tree whose wrappers take a query offset and the reduced MLA's head
dims (24, 16) also runs ``NEW_CASES`` (B3 and B9 at (24, 16), and at
query offsets with causal, window and prefix masks): each is run twice
and must be ``torch.equal`` to its rerun, and every old case run again
with ``q_offset=0`` must be ``torch.equal`` to its run without it. The
last line is a JSON summary, and the exit code is 1 if any output
differs. Needs one NVIDIA card and ``nvcc``; a tree is made with ``git
archive <commit> | tar -x -C TREE`` under an ignored directory such as
``build/``.
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
MASK_CASES = [  # (B, S, H, Hkv, D, mask) for B3 and B9
    (1, 600, 4, 2, 64, dict(window=100)),
    (2, 300, 8, 1, 128, dict(prefix_len=70)),
    (1, 500, 4, 4, 80, dict(window=40, prefix_len=64)),
    (1, 257, 4, 1, 256, dict(causal=False, prefix_len=0))]
MLA_CASES = [  # (B, S, H, Hkv, mask) at (D, Dv) = (192, 128), B3 and B9
    (2, 700, 64, 64, dict()), (1, 2049, 128, 128, dict()),
    (2, 700, 64, 64, dict(causal=False)),
    (2, 700, 64, 64, dict(window=100)),
    (1, 1000, 64, 64, dict()), (1, 1000, 16, 8, dict(prefix_len=70))]
NEW_CASES = [  # (B, Sq, Sk, H, Hkv, D, Dv, mask) for B3 and B9
    (2, 300, 300, 4, 4, 24, 16, dict()),
    (1, 130, 130, 8, 8, 24, 16, dict(causal=False)),
    (2, 64, 200, 4, 2, 64, 64, dict(q_offset=136)),
    (1, 100, 1101, 4, 1, 128, 128, dict(q_offset=1000, window=300)),
    (1, 77, 300, 8, 2, 80, 80, dict(q_offset=1, prefix_len=90)),
    (1, 65, 129, 4, 4, 24, 16, dict(q_offset=64, window=40))]


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

    def mla_inputs(seed, dtype, B, S, H, Hkv):
        """q, k (its rope part one vector over the heads) and v (a
        stride-256 view) at (192, 128) as multi-head latent attention
        makes them where H == Hkv; dense k and v of a GQA group else."""
        g = torch.Generator().manual_seed(seed)
        q = torch.randn((B, S, H, 192), generator=g)
        do = torch.randn((B, S, H, 128), generator=g)
        if H != Hkv:
            k, v = (torch.randn((B, S, Hkv, d), generator=g)
                    for d in (192, 128))
        else:
            kv = torch.randn((B, S, H, 256), generator=g)
            kr = torch.randn((B, S, 1, 64), generator=g)
            k = torch.cat([kv[..., :128], kr.expand(B, S, H, 64)], dim=-1)
            kv = kv.to("cuda", dtype)
            return (q.to("cuda", dtype), k.to("cuda", dtype), kv[..., 128:],
                    do.to("cuda", dtype))
        return [t.to("cuda", dtype) for t in (q, k, v, do)]

    import inspect
    new = "q_offset" in inspect.signature(flash_attention).parameters
    out, reruns = {}, {}
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
        for i, (B, S, H, Hkv, D, mask) in enumerate(MASK_CASES):
            q, k, v, do = rnd(300 + i, dtype, (B, S, H, D), (B, S, Hkv, D),
                              (B, S, Hkv, D), (B, S, H, D))
            o, lse = flash_attention(q, k, v, return_lse=True, **mask)
            out[f"b3_mask/{dn}/{i}/o"], out[f"b3_mask/{dn}/{i}/lse"] = o, lse
            for name, g in zip("qkv", flash_attention_bwd(
                    q, k, v, o, lse, do, **mask)):
                out[f"b9_mask/{dn}/{i}/d{name}"] = g
        for i, (B, S, H, Hkv, mask) in enumerate(MLA_CASES):
            q, k, v, do = mla_inputs(500 + i, dtype, B, S, H, Hkv)
            tiles = torch.zeros((B, H, -(-S // 64)), dtype=torch.int32,
                                device="cuda")
            o, lse = flash_attention(q, k, v, return_lse=True,
                                     tiles_loaded=tiles, **mask)
            out[f"mla/{dn}/{i}/o"], out[f"mla/{dn}/{i}/lse"] = o, lse
            out[f"mla/{dn}/{i}/tiles"] = tiles
            for name, g in zip("qkv", flash_attention_bwd(
                    q, k, v, o, lse, do, **mask)):
                out[f"mla/{dn}/{i}/d{name}"] = g
        if not new:
            continue
        # the old cases at an explicit offset 0: the bits of no offset
        for i, (B, S, H, Hkv, D, causal) in enumerate(B3_CASES):
            q, k, v = rnd(i, dtype, (B, S, H, D), (B, S, Hkv, D),
                          (B, S, Hkv, D))
            reruns[f"b3/{dn}/{i}"] = flash_attention(q, k, v, causal=causal,
                                                     q_offset=0)
        for i, (B, Sq, Sk, H, Hkv, D, Dv, mask) in enumerate(NEW_CASES):
            q, k, v, do = rnd(400 + i, dtype, (B, Sq, H, D), (B, Sk, Hkv, D),
                              (B, Sk, Hkv, Dv), (B, Sq, H, Dv))
            for key, store in ((f"new/{dn}/{i}", out),
                               (f"new/{dn}/{i}", reruns)):
                o, lse = flash_attention(q, k, v, return_lse=True, **mask)
                store[f"{key}/o"], store[f"{key}/lse"] = o, lse
                for name, g in zip("qkv", flash_attention_bwd(
                        q, k, v, o, lse, do, **mask)):
                    store[f"{key}/d{name}"] = g
    torch.cuda.synchronize()
    same = sorted(k for k in reruns if torch.equal(reruns[k], out[k]))
    out["_reruns"] = torch.tensor([len(reruns), len(same)])
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
    a.pop("_reruns", None)
    reruns = [int(x) for x in b.pop("_reruns", torch.tensor([0, 0]))]
    new = sorted(set(b) - set(a))
    differ = sorted(k for k in a if not torch.equal(a[k], b.get(k)))
    print(json.dumps({"ptxas_change": logs["change"]["ptxas"]}))
    print(json.dumps({"outputs": len(a), "missing": sorted(set(a) - set(b)),
                      "differ": differ, "bit_identical": not differ,
                      "new_outputs": len(new), "reruns": reruns[0],
                      "reruns_equal": reruns[1]}))
    return 1 if differ or set(a) - set(b) or reruns[0] != reruns[1] else 0


if __name__ == "__main__":
    sys.exit(main())
