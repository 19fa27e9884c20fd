"""Kill–resume on the port: real SIGKILLs against a checkpointed chaos
campaign of ``repro_torch`` on the CPU.

A subprocess runs ``_torch_guard_resume_child.campaign`` (the twin of
``_guard_resume_child.py``, importing only ``repro_torch``) with a
campaign checkpoint while ``REPRO_GUARD_KILL`` arms the guard plane's
self-fault-injection hook: ``boundary:<e>`` SIGKILLs right after epoch
``e``'s snapshot is published, ``mid:<e>`` at the top of epoch ``e``.
The parent checks the child died to SIGKILL, relaunches it on the same
checkpoint directory, and requires the resumed final report to be
bit-identical (the same JSON text) to an uninterrupted run — which is
itself held to the reference's campaign within 1e-9. Mirrors
``tests/test_guard_resume.py``.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _guard_resume_child as ref_child  # noqa: E402
import _torch_guard_resume_child as child  # noqa: E402
from _torch_parity import assert_trees_match  # noqa: E402

CHILD = os.path.join(os.path.dirname(__file__),
                     "_torch_guard_resume_child.py")

_BOUNDARY_EPOCHS = sorted(np.random.default_rng(2026).choice(
    child.N_EPOCHS, size=3, replace=False).tolist())
KILL_SPECS = [f"boundary:{e}" for e in _BOUNDARY_EPOCHS] \
    + [f"mid:{child.N_EPOCHS // 2}"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Uninterrupted checkpointed run, in-process (the code path the
    child executes), canonically serialized."""
    ck = tmp_path_factory.mktemp("ref_ck")
    return json.dumps(child.campaign(str(ck)), sort_keys=True)


def _launch(ckdir, out, *, kill=None):
    env = {k: v for k, v in os.environ.items() if k != "REPRO_GUARD_KILL"}
    if kill is not None:
        env["REPRO_GUARD_KILL"] = kill
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(CHILD), "..", "src"),
         os.path.dirname(CHILD)])
    return subprocess.run(
        [sys.executable, CHILD, str(ckdir), str(out), "cpu"],
        env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("kill", KILL_SPECS)
def test_sigkill_then_resume_is_bit_identical(kill, tmp_path, reference):
    ckdir = tmp_path / "ck"
    out = tmp_path / "out.json"

    died = _launch(ckdir, out, kill=kill)
    assert died.returncode == -signal.SIGKILL, died.stderr
    assert not out.exists()
    phase, _, e = kill.partition(":")
    snaps = sorted(p.name for p in (ckdir / "run0_hyst").glob(
        "epoch_*.json"))
    if phase == "boundary":
        assert f"epoch_{e}.json" in snaps, snaps
    assert not (ckdir / "run0_hyst" / "final.json").exists()
    manifest = json.loads((ckdir / "manifest.json").read_text())
    assert manifest["backend"] == "cpu"

    resumed = _launch(ckdir, out)
    assert resumed.returncode == 0, resumed.stderr
    assert out.read_text() == reference


def test_uninterrupted_subprocess_matches_reference(tmp_path, reference):
    """The subprocess introduces no drift, and the port's campaign is
    the reference's (numpy) within 1e-9, integers and flags exact."""
    out = tmp_path / "out.json"
    run = _launch(tmp_path / "ck", out)
    assert run.returncode == 0, run.stderr
    assert out.read_text() == reference
    want = json.loads(json.dumps(ref_child.campaign(str(tmp_path / "r")),
                                 sort_keys=True))
    assert_trees_match(want, json.loads(reference))
