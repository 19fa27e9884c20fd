"""The power plane's example twins (``examples_torch/power_gating_study.py``,
``fleet_day.py``, ``chaos_day.py``) on ``--device cpu`` against the JAX
package's examples (``examples/``, its numpy engine): every line they
print is the same text, the wall-time figures aside. The chaos day runs
on a cut fleet (16 chips, 6 epochs, severities 0 and 1) in both, its
in-line invariants included."""
import importlib.util
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
WALL = re.compile(r"\d+\.\d+s\b")


def _load(monkeypatch, folder: str, name: str):
    """``folder/name.py`` as a fresh module, its folder's ``fleet_day``
    being what ``import fleet_day`` finds meanwhile."""
    path = ROOT / folder
    monkeypatch.syspath_prepend(str(path))
    if name != "fleet_day":
        monkeypatch.setitem(sys.modules, "fleet_day",
                            _load(monkeypatch, folder, "fleet_day"))
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", path / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(capsys, fn) -> list:
    fn()
    out = capsys.readouterr().out
    return [WALL.sub("<wall>", ln) for ln in out.splitlines()]


@pytest.mark.parametrize("name", ["power_gating_study", "fleet_day"])
def test_twin_prints_the_references_lines(name, monkeypatch, capsys):
    ref = _load(monkeypatch, "examples", name)
    port = _load(monkeypatch, "examples_torch", name)
    want = _printed(capsys, lambda: ref.main([]))
    got = _printed(capsys, lambda: port.main(["--device", "cpu"]))
    assert len(want) > 10
    assert got == want


def _small_fleet(fleet_mod, opgen_mod):
    def build():
        wl = opgen_mod.llm_workload("llama3-8b", "decode", batch=8)
        return fleet_mod.FleetScenario(
            classes=(fleet_mod.WorkloadClass(
                "chat-decode", wl,
                fleet_mod.ArrivalSpec("diurnal", rate_rps=10.0,
                                      period_s=3600.0),
                requests_per_invocation=8),),
            n_chips=16, npu="NPU-D", policies=("NoPG", "ReGate-Full"),
            duration_s=6 * 600.0, epoch_s=600.0, slo_relax=1.2, seed=7,
            severity_levels=(0.0, 1.0))
    return build


def test_chaos_day_twin_prints_the_references_lines(monkeypatch, capsys):
    from repro.core import fleet as r_fleet
    from repro.core import opgen as r_opgen
    from repro_torch.core import fleet as p_fleet
    from repro_torch.core import opgen as p_opgen
    ref = _load(monkeypatch, "examples", "chaos_day")
    port = _load(monkeypatch, "examples_torch", "chaos_day")
    for mod, fl, op in ((ref, r_fleet, r_opgen), (port, p_fleet, p_opgen)):
        monkeypatch.setattr(mod, "build_scenario", _small_fleet(fl, op))
        monkeypatch.setattr(mod, "SEVERITIES", (0.0, 1.0))
    want = _printed(capsys, lambda: ref.main([]))
    got = _printed(capsys, lambda: port.main(["--device", "cpu"]))
    assert any("anti-thrash" in ln for ln in want)
    assert got == want
