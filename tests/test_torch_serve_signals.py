"""The port's arrival-driven serving (``repro_torch.launch.serve.
serve_arrivals``) against the JAX package's, on the CPU, and its drain
discipline, as ``tests/test_serve_signals.py`` holds the reference's:
SIGTERM / SIGINT land mid-trace in a child process serving the reduced
qwen2.5-3b on ``device="cpu"``, and ``serve_arrivals`` must finish the
wave in flight, flag the epoch ``"drained"``, write the report, restore
the earlier handlers and exit 0. The per-epoch counts (arrived, served,
queued) equal the reference's on the same seed: the fleet plane's
arrival counts and the waves drawn from the one generator.
"""
import json
import os
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core.fleet import ArrivalSpec as RefArrivalSpec  # noqa: E402
from repro.launch.serve import serve_arrivals as ref_serve_arrivals  # noqa
from repro_torch.core.fleet import ArrivalSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_serve_signal_child.py")
#: the child's trace: 1 s epochs over 120 s, so a signal 0.6 s after it
#: starts serving lands in one of the first few
CHILD_EPOCHS = 120


def _run_child(report, sig):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE]))
    proc = subprocess.Popen([sys.executable, CHILD, str(report)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "READY", \
            proc.stderr.read()
        time.sleep(0.6)  # land inside an epoch's wave loop
        proc.send_signal(sig)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, err


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT],
                         ids=["SIGTERM", "SIGINT"])
def test_signal_drains_epoch_and_reports(sig, tmp_path):
    report = tmp_path / "serve.json"
    code, out, err = _run_child(report, sig)
    assert code == 0, err                        # drained, not killed
    rep = json.loads(report.read_text())
    assert rep["interrupted"] == signal.Signals(sig).name
    epochs = rep["epochs"]
    assert 1 <= len(epochs) < CHILD_EPOCHS       # ended early...
    assert epochs[-1]["drained"] is True         # ...but drained
    assert not any(e.get("drained") for e in epochs[:-1])
    assert all(e["served"] % 4 == 0 for e in epochs)  # whole waves
    assert rep["served_total"] == sum(e["served"] for e in epochs)
    assert f"DONE {len(epochs)}" in out


class _RefFakeServer:
    """The slice of the JAX ``Server`` that ``serve_arrivals`` touches:
    the reference's waves, without its model."""

    batch = 4

    class cfg:  # noqa: N801
        vocab_size = 151936

    def generate(self, prompts, n_tokens):
        import numpy as np
        assert prompts.shape == (self.batch, 4)
        return np.zeros((self.batch, n_tokens), np.int32)


@pytest.mark.parametrize("kind,rate,seed", [("poisson", 40.0, 3),
                                            ("bursty", 12.0, 1),
                                            ("diurnal", 20.0, 0)])
def test_epochs_equal_the_reference(kind, rate, seed, tmp_path):
    """The port's ``serve_arrivals`` over the reduced qwen2.5-3b on the
    CPU and the reference's over the same seed: the same epochs, each
    with the same arrived, served and queued counts; a clean run's report
    has no signal and the earlier handlers are back."""
    srv = serve.Server("qwen2.5-3b", batch=4, max_seq=16, device="cpu")
    prev = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    report = tmp_path / "serve.json"
    got = serve.serve_arrivals(
        srv, ArrivalSpec(kind, rate_rps=rate, period_s=6.0), duration_s=6.0,
        epoch_s=1.5, prompt_len=4, n_tokens=2, seed=seed,
        checkpoint=str(report))
    want = ref_serve_arrivals(
        _RefFakeServer(), RefArrivalSpec(kind, rate_rps=rate, period_s=6.0),
        duration_s=6.0, epoch_s=1.5, prompt_len=4, n_tokens=2, seed=seed)
    keys = ("epoch", "arrived", "served", "queued")
    assert [[e[k] for k in keys] for e in got] == \
        [[e[k] for k in keys] for e in want]
    assert len(got) == 4 and sum(e["served"] for e in got) > 0
    assert not any(e.get("drained") for e in got)
    rep = json.loads(report.read_text())
    assert rep["interrupted"] is None and rep["epochs"] == got
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == prev


def test_cli_serves_arrivals(capsys, tmp_path):
    report = tmp_path / "serve.json"
    stats = serve.main(["--device", "cpu", "--arrivals", "poisson",
                        "--rate", "4", "--duration", "4", "--epoch", "2",
                        "--prompt-len", "4", "--tokens", "2",
                        "--checkpoint", str(report)])
    assert len(stats) == 2
    assert json.loads(report.read_text())["epochs"] == stats
    out = capsys.readouterr().out
    assert "[serve] epoch 1:" in out and "requests served over 2" in out


def test_serve_batched_twin_runs_on_the_cpu(capsys):
    """``examples_torch/serve_batched.py``, the twin of
    ``examples/serve_batched.py``, in both of its modes."""
    import importlib.util
    path = os.path.join(HERE, "..", "examples_torch", "serve_batched.py")
    spec = importlib.util.spec_from_file_location("serve_batched_twin", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--tokens", "3"])
    assert "[serve] 4 requests x 3 tokens" in capsys.readouterr().out
    stats = mod.main(["--device", "cpu", "--arrivals", "bursty", "--rate",
                      "2", "--duration", "4", "--epoch", "2"])
    assert [e["epoch"] for e in stats] == [0, 1]
