"""Serve a small model with batched requests (prefill + decode loop) on
the PyTorch / CUDA port -- ``examples/serve_batched.py`` with
``repro_torch``.

  PYTHONPATH=src python examples_torch/serve_batched.py --arch qwen2.5-3b [--device cpu]

Arrival-driven mode: feed the server a seeded fleet-plane arrival trace
(Poisson / diurnal / bursty, ``repro_torch.core.fleet``) with requests
joining at the next epoch boundary; SIGTERM / SIGINT drain the wave in
flight and write the report:

  PYTHONPATH=src python examples_torch/serve_batched.py --arrivals bursty \\
      --rate 2 --duration 20 --epoch 4 [--checkpoint report.json] [--device cpu]

Runs on the card unless ``--device cpu``, as every entry point does.
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
