"""Child process for the port's serve drain tests and ``chip_smoke.py``'s
``serve_arrivals`` phase.

    python tests/_torch_serve_signal_child.py REPORT [--device cpu]
        [--arch qwen2.5-3b] [--full] [--batch 4] [--rate 40]
        [--duration 120] [--epoch 1] [--prompt-len 4] [--tokens 2]

Builds a ``repro_torch.launch.serve.Server`` (the reduced config unless
``--full``), warms it with one wave, prints READY, and serves a seeded
Poisson trace through ``serve_arrivals`` with its report written to
REPORT; the parent sends SIGTERM or SIGINT mid-trace, and the drain must
still write the report and end with ``DONE <epochs>`` and exit 0.
"""
import argparse

import numpy as np

from repro_torch.core.fleet import ArrivalSpec
from repro_torch.launch.serve import Server, serve_arrivals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("report")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rate", type=float, default=40.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--epoch", type=float, default=1.0)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=2)
    args = ap.parse_args(argv)
    srv = Server(args.arch, reduced=not args.full, batch=args.batch,
                 max_seq=args.prompt_len + args.tokens + 8, seed=0,
                 device=args.device)
    srv.generate(np.zeros((args.batch, args.prompt_len), np.int32),
                 args.tokens)
    print("READY", flush=True)
    stats = serve_arrivals(srv, ArrivalSpec("poisson", rate_rps=args.rate),
                           duration_s=args.duration, epoch_s=args.epoch,
                           prompt_len=args.prompt_len,
                           n_tokens=args.tokens, seed=3,
                           checkpoint=args.report)
    print(f"DONE {len(stats)}", flush=True)


if __name__ == "__main__":
    main()
