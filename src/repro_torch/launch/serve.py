"""Batched serving: prefill + decode with a KV / state cache.

    python -m repro_torch.launch.serve --arch qwen2.5-3b [--device cuda]
    python -m repro_torch.launch.serve --arch mamba2-780m [--device cuda]
    python -m repro_torch.launch.serve --arch hymba-1.5b [--device cuda]
    python -m repro_torch.launch.serve --arch paligemma-3b [--device cuda]
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-236b [--device cuda]
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --full \
        --layers 3 [--device cuda]
    python -m repro_torch.launch.serve --arrivals poisson --rate 2 \
        --duration 20 --epoch 5 [--checkpoint report.json] [--device cuda]

Serves a fixed batch of seeded random prompts: one prefill, then one
decode step per generated token, every request sharing one cache of
``max_seq`` slots (an SSD arch's cache is its conv tails and states,
whatever ``max_seq``; the prompt-length rule is the same). A vision arch
(paligemma) is served as the JAX server serves it: zero patch embeddings
(the stubbed vision tower's output) before every prompt, counted in the
cache's length. On the card (the default device) the hand-written
kernels run: for the attention families B3 over the prompt (hymba's
sliding-window layers skipping the key tiles outside the window,
paligemma's patches a bidirectional prefix, deepseek's multi-head
latent attention at q/k head dim 192 and v 128, or the reduced config's
24 and 16) and B4 at each step, for
the SSD family B5 over the prompt, hymba both; an SSD decode step is the
plain recurrent update, an MLA decode step the absorbed form in plain
PyTorch (no kernel), and MoE dispatch plain PyTorch everywhere. deepseek
at its published widths holds 236 B parameters: serve it on one card cut
in depth (``n_layers``; ``--full --layers 3``: the leading dense layer
and 2 MoE layers, 9.3 B parameters). The encoder-only arch (hubert) has
no decode step: run its ``models.model.forward``.

Differences from the JAX package's ``repro.launch.serve``, all for an
eager runtime: the weights are cast to bf16 once, at construction (the
jitted reference casts inside every step; eager PyTorch would copy the
whole tree per step); the cache is allocated once, at construction, and
the prompt's K/V, or conv tails and states, are written into it (no
graft; a prompt shorter than the conv width keeps its tail right-aligned,
where the JAX server's graft left-aligns it); decode steps update it in
place; the weights are drawn leaf by leaf and each cast to bf16 at once,
so the float32 tree never exists whole.

``--arrivals`` switches to arrival-driven serving (``serve_arrivals``), as
the JAX package's: a seeded request trace from the fleet plane's
generators (``repro_torch.core.fleet``: Poisson, diurnal, bursty) feeds the
server epoch by epoch, requests joining at the next epoch boundary and
queuing until a full batch forms; SIGTERM / SIGINT finish the wave in
flight, flag the epoch ``"drained"`` and write the report
(``guard.atomic_write_json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import signal
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.models import model as M
from repro_torch.models import registry
from repro_torch.models.param import init_params
from repro_torch.train.steps import make_prefill_step, make_serve_step


class Server:
    def __init__(self, arch: str, *, reduced: bool = True,
                 n_layers: Optional[int] = None, batch: int = 4,
                 max_seq: int = 128, seed: int = 0, device="cuda"):
        """``n_layers``: cut the (reduced or full-width) config to that
        many layers, the leading dense layer included."""
        base = get_arch(arch)
        self.cfg = base.reduced() if reduced else base
        if n_layers is not None:
            self.cfg = dataclasses.replace(self.cfg, n_layers=n_layers)
        if self.cfg.encoder_only:
            raise ValueError("encoder-only arch has no decode step")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to serve "
                               "on the CPU")
        self.batch = batch
        self.max_seq = max_seq
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(registry.param_specs(self.cfg), gen,
                                  self.device, dtype=torch.bfloat16)
        self.prefill = make_prefill_step(self.cfg)
        self.decode = make_serve_step(self.cfg)
        self.cache = M.init_cache(self.cfg, batch, max_seq, torch.bfloat16,
                                  device=self.device)
        self.cache_len = 0

    def prefill_prompts(self, prompts: np.ndarray) -> np.ndarray:
        """prompts: (B, S0) int. Fills the shared cache (the first S0 KV
        slots -- after a vision arch's frontend_seq patch slots --, or the
        SSD conv tails and states);
        returns the first generated token of each request, (B,)."""
        B, S0 = prompts.shape
        n_img = self.cfg.frontend_seq if self.cfg.frontend == "vision" else 0
        if B != self.batch or S0 < 1 or S0 + n_img >= self.max_seq:
            raise ValueError(f"prompts {prompts.shape}: want ({self.batch}, "
                             f"S0) with 0 < S0 and S0 + {n_img} image "
                             f"slots < max_seq={self.max_seq}")
        batch = {"tokens": torch.tensor(np.asarray(prompts),
                                        dtype=torch.int64,
                                        device=self.device)}
        if n_img:
            batch["patches"] = torch.zeros(
                (B, n_img, self.cfg.frontend_dim), dtype=torch.bfloat16,
                device=self.device)
        logits, self.cache = self.prefill(self.params, batch,
                                          cache=self.cache)
        self.cache_len = S0 + n_img
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def step(self, tokens: np.ndarray) -> np.ndarray:
        """tokens: (B,) — the previous step's outputs."""
        if self.cache_len >= self.max_seq:
            raise ValueError(f"cache full: {self.max_seq} slots")
        batch = {"tokens": torch.tensor(np.asarray(tokens),
                                        dtype=torch.int64,
                                        device=self.device)[:, None],
                 "cache_len": self.cache_len}
        logits, self.cache = self.decode(self.params, self.cache, batch)
        self.cache_len += 1
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def generate(self, prompts: np.ndarray, n_tokens: int) -> np.ndarray:
        out = [self.prefill_prompts(prompts)]
        for _ in range(n_tokens - 1):
            out.append(self.step(out[-1]))
        return np.stack(out, axis=1)  # (B, n_tokens)


def serve_arrivals(srv: Server, spec, *, duration_s: float,
                   epoch_s: float, prompt_len: int, n_tokens: int,
                   seed: int = 0, checkpoint: Optional[str] = None
                   ) -> list[dict]:
    """Serve a seeded arrival trace with epoch-boundary batching, as the
    JAX package's ``serve_arrivals``.

    ``spec`` is a ``repro_torch.core.fleet.ArrivalSpec``; its per-epoch
    request counts (deterministic under ``seed``) land on the queue at
    each epoch boundary, and the server drains the queue in full
    ``srv.batch``-sized waves (``srv.generate`` over seeded prompts); the
    remainder carries to the next epoch. Returns one stats dict per epoch:
    ``epoch``, ``arrived``, ``served``, ``queued``, ``wall_s``.

    On SIGTERM / SIGINT the wave in flight finishes, the epoch is recorded
    with ``"drained": True`` and the run ends; with ``checkpoint`` a JSON
    report (the epochs, ``served_total`` and the interrupting signal, or
    None) is written atomically either way. The earlier signal handlers
    are restored on exit."""
    from repro_torch.core.fleet import arrival_counts
    from repro_torch.core.guard import atomic_write_json
    n_epochs = max(1, int(math.ceil(duration_s / epoch_s)))
    rng = np.random.default_rng(seed)
    counts = arrival_counts(spec, n_epochs, epoch_s, rng)
    queue = 0
    stats: list[dict] = []
    stop: dict = {"signum": None}

    def _handler(signum, frame):
        stop["signum"] = signum

    prev = {s: signal.signal(s, _handler)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for e in range(n_epochs):
            queue += int(counts[e])
            served = 0
            t0 = time.time()
            while queue >= srv.batch and stop["signum"] is None:
                prompts = rng.integers(0, srv.cfg.vocab_size,
                                       (srv.batch, prompt_len),
                                       dtype=np.int32)
                srv.generate(prompts, n_tokens)
                queue -= srv.batch
                served += srv.batch
            rec = {"epoch": e, "arrived": int(counts[e]),
                   "served": served, "queued": queue,
                   "wall_s": time.time() - t0}
            stats.append(rec)
            if stop["signum"] is not None:
                rec["drained"] = True
                break
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        if checkpoint is not None:
            sig = stop["signum"]
            atomic_write_json(checkpoint, {
                "epochs": stats,
                "served_total": sum(s["served"] for s in stats),
                "interrupted": (signal.Signals(sig).name
                                if sig is not None else None)})
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="a decoder arch: the dense text archs, "
                         "mamba2-780m, hymba-1.5b, paligemma-3b, "
                         "granite-moe-1b-a400m, deepseek-v2-236b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced "
                         "config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--arrivals", choices=("poisson", "diurnal",
                                           "bursty"), default=None,
                    help="serve a seeded arrival trace (fleet-plane "
                         "generators) instead of one fixed batch")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean arrival rate, requests/s")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="arrival-trace window, seconds")
    ap.add_argument("--epoch", type=float, default=5.0,
                    help="batching epoch length, seconds")
    ap.add_argument("--checkpoint", default=None,
                    help="write the arrival-mode final report to this "
                         "path (atomic JSON; also written when a "
                         "SIGTERM/SIGINT drain ends the run early)")
    args = ap.parse_args(argv)
    n_img = get_arch(args.arch).reduced().frontend_seq
    if args.full:
        n_img = get_arch(args.arch).frontend_seq
    srv = Server(args.arch, reduced=not args.full, n_layers=args.layers,
                 batch=args.batch,
                 max_seq=n_img + args.prompt_len + args.tokens + 8,
                 seed=args.seed, device=args.device)
    if args.arrivals:
        from repro_torch.core.fleet import ArrivalSpec
        spec = ArrivalSpec(args.arrivals, rate_rps=args.rate,
                           period_s=args.duration)
        stats = serve_arrivals(srv, spec, duration_s=args.duration,
                               epoch_s=args.epoch,
                               prompt_len=args.prompt_len,
                               n_tokens=args.tokens, seed=args.seed,
                               checkpoint=args.checkpoint)
        for s in stats:
            drain = " [drained]" if s.get("drained") else ""
            print(f"[serve] epoch {s['epoch']}: arrived {s['arrived']}, "
                  f"served {s['served']}, queued {s['queued']} "
                  f"({s['wall_s']:.2f}s){drain}")
        print(f"[serve] {sum(s['served'] for s in stats)} requests served "
              f"over {len(stats)} epochs on {srv.device}")
        return stats
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, srv.cfg.vocab_size,
                           (args.batch, args.prompt_len), dtype=np.int32)
    t0 = time.time()
    toks = srv.generate(prompts, args.tokens)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.time() - t0
    print(f"[serve] {args.batch} requests x {args.tokens} tokens in "
          f"{dt:.2f}s ({args.batch*args.tokens/dt:.1f} tok/s) on "
          f"{srv.device}")
    print("[serve] outputs:", toks[:, :8].tolist())


if __name__ == "__main__":
    main()
