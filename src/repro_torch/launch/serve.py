"""Batched serving: prefill + decode with a KV / state cache.

    python -m repro_torch.launch.serve --arch qwen2.5-3b [--device cuda]
    python -m repro_torch.launch.serve --arch mamba2-780m [--device cuda]
    python -m repro_torch.launch.serve --arch hymba-1.5b [--device cuda]
    python -m repro_torch.launch.serve --arch paligemma-3b [--device cuda]
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --full \
        --layers 3 [--device cuda]

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
latent attention at q/k head dim 192 and v 128) and B4 at each step, for
the SSD family B5 over the prompt, hymba both; an SSD decode step is the
plain recurrent update, an MLA decode step the absorbed form in plain
PyTorch (no kernel), and MoE dispatch plain PyTorch everywhere. The
reduced deepseek's MLA head dims (24, 16) are not among B3's on the card:
serve it there at full width cut in depth (``n_layers``; ``--full
--layers 3``: the leading dense layer and 2 MoE layers, 9.3 B
parameters). The encoder-only arch (hubert) has no decode step: run its
``models.model.forward``.

Differences from the JAX package's ``repro.launch.serve``, all for an
eager runtime: the weights are cast to bf16 once, at construction (the
jitted reference casts inside every step; eager PyTorch would copy the
whole tree per step); the cache is allocated once, at construction, and
the prompt's K/V, or conv tails and states, are written into it (no
graft; a prompt shorter than the conv width keeps its tail right-aligned,
where the JAX server's graft left-aligns it); decode steps update it in
place; the weights are drawn leaf by leaf and each cast to bf16 at once,
so the float32 tree never exists whole. Arrival-driven serving
(``serve_arrivals``, ``--arrivals``) needs the fleet and guard planes and
waits for ROADMAP A5.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    args = ap.parse_args(argv)
    n_img = get_arch(args.arch).reduced().frontend_seq
    if args.full:
        n_img = get_arch(args.arch).frontend_seq
    srv = Server(args.arch, reduced=not args.full, n_layers=args.layers,
                 batch=args.batch,
                 max_seq=n_img + args.prompt_len + args.tokens + 8,
                 seed=args.seed, device=args.device)
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
