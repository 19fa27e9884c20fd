"""Child process for the port's kill–resume tests (and for
``chip_smoke.py``'s ``guard_resume`` phase on the card).

Runs a small, fully deterministic chaos campaign of ``repro_torch`` with
a campaign checkpoint and writes the final summary JSON to ``argv[2]``;
``argv[3]`` is the device (default ``"cpu"``); ``campaign`` also takes
a ``mesh`` (``tests/_torch_sweep_mesh_child.py`` runs it on one). The
parent arms
``REPRO_GUARD_KILL`` in this process's environment (it is read when
``repro_torch.core.guard`` is imported) to SIGKILL it at an epoch
boundary (right after a snapshot publishes) or mid-epoch, then relaunches
it with the same checkpoint directory — the resumed output must be
bit-identical to an uninterrupted run. Imports nothing but
``repro_torch``: the twin of ``_guard_resume_child.py``, the same
campaign.
"""
import json
import sys

from repro_torch.core.fleet import (ArrivalSpec, FleetScenario,
                                    WorkloadClass, sweep_chaos)
from repro_torch.core.opgen import llm_workload
from repro_torch.core.policies import KnobGrid
from repro_torch.core.slo import Hysteresis

N_EPOCHS = 6


def campaign(checkpoint=None, device="cpu", mesh=None) -> dict:
    wl = llm_workload("llama2-13b", "decode", batch=8, n_chips=8, tp=8)
    sc = FleetScenario(
        classes=(WorkloadClass(
            "decode", wl,
            ArrivalSpec("diurnal", rate_rps=24.0, period_s=3600.0),
            requests_per_invocation=8),),
        n_chips=32, npu="NPU-D", policies=("NoPG", "ReGate-Full"),
        duration_s=3600.0, epoch_s=600.0, seed=17,
        severity_levels=(0.0, 1.0))
    out = sweep_chaos(sc, KnobGrid(window_scale=(0.5, 1.0)),
                      fault_severities=(0.0, 1.0),
                      hysteresis=Hysteresis(), thrash_baseline=False,
                      checkpoint=checkpoint, device=device, mesh=mesh)
    return {"summary": out["summary"],
            "reports": {repr(sev): rep.to_dict()
                        for sev, rep in out["reports"].items()}}


if __name__ == "__main__":
    ckdir, out_path = sys.argv[1], sys.argv[2]
    device = sys.argv[3] if len(sys.argv) > 3 else "cpu"
    res = campaign(ckdir, device)
    with open(out_path, "w") as f:
        json.dump(res, f, sort_keys=True)
