"""End-to-end driver on the PyTorch / CUDA port: train a ~100M-param
model for a few hundred steps with checkpointing —
``examples/train_e2e.py`` with ``repro_torch``.

  PYTHONPATH=src python examples_torch/train_e2e.py --device cpu [--steps 300]
  PYTHONPATH=src python examples_torch/train_e2e.py --device cpu --reduced --steps 3

Uses mamba2-780m scaled to ~100M (24 layers, d=768) — attention-free, so
CPU steps stay fast enough for hundreds of steps; ``--reduced`` trains
the arch's reduced config instead. ``--device`` defaults to the card, as
every entry point does: there each SSD layer is kernel B5 forward and
kernel B10 backward, through the same training loop as on the CPU.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_arch
from repro_torch.configs.base import SSMConfig, register
from repro_torch.launch.train import TrainLoopConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="train mamba2-780m's reduced config")
    args = ap.parse_args(argv)

    if args.reduced:
        arch, reduced = "mamba2-780m", True
        n = get_arch(arch).reduced().param_count()
    else:
        base = get_arch("mamba2-780m")
        cfg100m = dataclasses.replace(
            base, name="mamba2-100m", n_layers=24, d_model=768,
            vocab_size=50280,
            ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                          n_groups=1, chunk=64))
        register(cfg100m)
        arch, reduced = "mamba2-100m", False
        n = cfg100m.param_count()
    print(f"[e2e] {arch}{' (reduced)' if reduced else ''}: {n/1e6:.1f}M "
          f"params, {args.steps} steps @ batch {args.batch} x seq "
          f"{args.seq} on {args.device}")

    with tempfile.TemporaryDirectory() as ckpt:
        out = run(TrainLoopConfig(
            arch=arch, reduced=reduced, steps=args.steps,
            seq_len=args.seq, global_batch=args.batch, ckpt_dir=ckpt,
            checkpoint_every=100, log_every=20, device=args.device))
    first = out["losses"][0]
    tail = out["losses"][-10:]
    last = sum(tail) / len(tail)
    print(f"[e2e] loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return out


if __name__ == "__main__":
    main()
