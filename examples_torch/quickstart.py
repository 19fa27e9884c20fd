"""Quickstart on the PyTorch / CUDA port: the paper's power-gating
analysis in five lines, plus one training step of an assigned
architecture — ``examples/quickstart.py`` with ``repro_torch``.

  PYTHONPATH=src python examples_torch/quickstart.py            # the card
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.opgen import llm_workload
from repro_torch.core.policies import evaluate_all, savings_vs_nopg
from repro_torch.data.specs import make_batch
from repro_torch.models import registry
from repro_torch.models.param import init_params, train_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import TrainState, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)

    # --- 1. ReGate: energy of an LLM decode workload under all five designs
    wl = llm_workload("llama3-8b", "decode", batch=8, n_chips=1)
    reports = evaluate_all(wl, "NPU-D", device=dev)
    savings = savings_vs_nopg(reports)
    print("== ReGate energy savings vs NoPG (llama3-8b decode, NPU-D) ==")
    for policy, s in savings.items():
        r = reports[policy]
        print(f"  {policy:12s} {s*100:6.2f}%   "
              f"avg power {r.avg_power_w:6.1f} W   "
              f"static fraction {r.static_frac:.2f}")

    # --- 2. one train step of an assigned architecture (reduced)
    cfg = get_arch("qwen3-32b").reduced()
    opt = AdamWConfig(total_steps=10)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = train_params(init_params(registry.param_specs(cfg), gen, dev))
    state = TrainState.create(params, opt)
    step = make_train_step(cfg, opt)
    batch = make_batch(cfg, ShapeConfig("t", 64, 4, "train"), seed=0,
                       device=dev)
    state, metrics = step(state, batch)
    print(f"\n== qwen3-32b (reduced) train step: "
          f"loss={float(metrics['loss']):.3f}"
          f" grad_norm={float(metrics['grad_norm']):.3f} ==")


if __name__ == "__main__":
    main()
