"""The port's checkpoint manager: ``tests/test_checkpoint.py``'s checks
(round trip, async save and wait, atomic publish, retention, a given
step, the shape check, crash debris) on trees of tensors, and in place
of the reference's mesh case a device case: every leaf restores on the
requested device in the target leaf's dtype (bf16 stored as float32,
exactly) with its ``requires_grad``, into a ``TrainState``. A save
snapshots the leaves before it returns, and an error in a background
write is raised at the next ``wait``."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import TrainState  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros((4,))},
            "opt": {"m": torch.ones((8, 4)) * 0.5,
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_roundtrip(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    st = _state()
    cm.save(3, st, extras={"data_state": {"step": 3}}, blocking=True)
    restored, extras = cm.restore(_state(seed=9))
    assert extras["data_state"]["step"] == 3
    for a, b in zip(_leaves(st), _leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_async_save_and_wait(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(), blocking=False)
    cm.wait()
    assert cm.latest_step() == 1


def test_save_snapshots_before_returning(tmp_path):
    """An in-place update right after an async save does not reach the
    checkpoint."""
    cm = CheckpointManager(str(tmp_path))
    st = _state()
    want = st["params"]["w"].clone()
    cm.save(1, st, blocking=False)
    st["params"]["w"].add_(1.0)
    restored, _ = cm.restore(_state(seed=9))
    assert torch.equal(restored["params"]["w"], want)


def test_atomic_publish(tmp_path):
    """No .tmp directories survive a successful save."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, _state(), blocking=True)
    names = os.listdir(tmp_path)
    assert "step_5" in names
    assert not any(n.endswith(".tmp") for n in names)
    assert os.path.exists(tmp_path / "step_5" / "manifest.json")


def test_retention_gc(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _state(), blocking=True)
    assert cm.all_steps() == [3, 4]


def test_restore_specific_step(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(seed=1), blocking=True)
    cm.save(2, _state(seed=2), blocking=True)
    r1, _ = cm.restore(_state(), step=1)
    assert torch.equal(r1["params"]["w"], _state(seed=1)["params"]["w"])


def test_shape_mismatch_raises(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(), blocking=True)
    bad = _state()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape"):
        cm.restore(bad)


def test_missing_leaf_and_empty_dir_raise(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cm.restore(_state())
    cm.save(1, _state(), blocking=True)
    bigger = _state()
    bigger["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra"):
        cm.restore(bigger)


def test_device_restore(tmp_path):
    """The reference's mesh case on one device: each leaf lands on the
    requested device in the target's dtype, with its requires_grad."""
    cm = CheckpointManager(str(tmp_path))
    params = {"w": torch.randn((8, 4), generator=torch.Generator()
                               .manual_seed(1)).requires_grad_(),
              "h": torch.randn(5).to(torch.bfloat16)}
    st = TrainState.create(params, AdamWConfig())
    cm.save(1, st, blocking=True)
    target = TrainState.create(
        {"w": torch.zeros((8, 4)).requires_grad_(),
         "h": torch.zeros(5, dtype=torch.bfloat16)}, AdamWConfig())
    restored, _ = cm.restore(target, device="cpu")
    assert isinstance(restored, TrainState)
    w, h = restored.params["w"], restored.params["h"]
    assert w.requires_grad and not h.requires_grad
    assert h.dtype == torch.bfloat16 and torch.equal(h, params["h"])
    assert torch.equal(w.detach(), params["w"].detach())
    assert restored.step.dtype == torch.int32
    assert all(t.device.type == "cpu" for t in _leaves(restored.opt_state))
    import json
    with open(tmp_path / "step_1" / "manifest.json") as f:
        kinds = {e["key"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert kinds["params/h"] == "bfloat16" and kinds["step"] == "int32"


def test_crash_mid_save_keeps_previous(tmp_path):
    """A leftover .tmp dir from a crashed save must not break restore."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _state(seed=1), blocking=True)
    os.makedirs(tmp_path / "step_2.tmp")  # simulated crash debris
    with open(tmp_path / "step_2.tmp" / "leaf_0.npy", "w") as f:
        f.write("garbage")
    assert cm.latest_step() == 1
    restored, _ = cm.restore(_state())
    assert torch.equal(restored["params"]["w"],
                       _state(seed=1)["params"]["w"])


def test_background_error_raises_at_next_wait(tmp_path, monkeypatch):
    cm = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", broken)
    cm.save(1, _state(), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        cm.wait()
    monkeypatch.undo()
    cm.wait()  # the error is raised once
    assert cm.latest_step() is None
