"""A chaos day: the fleet of ``fleet_day.py`` under injected faults, on
the PyTorch / CUDA port -- ``examples/chaos_day.py`` with ``repro_torch``.

Three fault severities (clean control, moderate, severe) are realized
into seeded chip/link fault timelines (``core.faults.fault_plan``) and
replayed through the fleet simulator by ``sweep_chaos``: chips fail and
repair on MTBF cycles, maintenance drains pull slices of the fleet,
ICI links flap / degrade / go down (re-lowering collectives onto the
detoured ring schedules), and occasional failures corrupt power-gating
control logic — forcing gated policies onto the NoPG-equivalent
fallback rung. The anti-thrash hysteresis governor re-tunes knobs
through it all, and every faulted scenario is also run under the
stateless governor as the thrash control.

  PYTHONPATH=src python examples_torch/chaos_day.py [--device cpu]
  PYTHONPATH=src python examples_torch/chaos_day.py --checkpoint /tmp/ck

Runs on the card unless ``--device cpu`` (the kernels' plain versions)
or ``--device numpy`` (the numpy batched engine), as every entry point
does.

The run is deterministic under the fixed seed (per-(chip, link) child
streams; each severity's timeline is keyed by the severity value's own
bit pattern, so the campaign composition never shifts a timeline). The
script asserts in-line the chaos-plane invariants: severity 0 is an
exact no-op versus the clean fleet run, per-epoch energy conserves to
<= 1e-9 relative, and the hysteresis governor retunes at most once per
fault transition while the stateless baseline thrashes at least as
often.

``--checkpoint DIR`` adds the guard plane's kill–resume demo: the script relaunches itself as a checkpointed subprocess with
``REPRO_GUARD_KILL`` armed, SIGKILLs it mid-campaign (epoch 60 of 96,
mid-epoch — no snapshot of that epoch exists), then resumes from DIR
in-process and asserts the resumed campaign is **bit-identical** to
the uninterrupted one — summary rows and per-epoch records.
"""
import argparse
import json
import math
import os
import signal
import subprocess
import sys
import time

from repro_torch.core.fleet import FleetReport, sweep_fleet
from repro_torch.core.policies import KnobGrid
from repro_torch.core.sweep import sweep_chaos

from fleet_day import build_scenario

REL_TOL = 1e-9
# 0 is the clean control; 0.25 is a partial-degradation regime (pg
# faults come and go); at >= 1 on a 4096-chip fleet some pg-corrupted
# chip is essentially always down, so gated policies ride the NoPG
# fallback rung all day — the bottom of the degradation ladder
SEVERITIES = (0.0, 0.25, 1.0, 2.0)
KILL_EPOCH = 60   # mid-epoch SIGKILL target for the --checkpoint demo


def check_clean_noop(campaign, scenario, grid, device) -> None:
    """Severity 0 realizes the all-clean timeline — its report must be
    bit-identical to a plain (faultless, stateless) fleet run apart
    from the fault bookkeeping columns."""
    clean: FleetReport = sweep_fleet(scenario, grid, device=device)
    rep: FleetReport = campaign["baseline_reports"][0.0]
    assert rep.records == clean.records
    assert rep.epoch_summary == clean.epoch_summary
    print(f"clean control: severity-0 baseline is bit-identical to the "
          f"faultless run ({len(clean.records)} records)")


def check_energy_conservation(rep: FleetReport) -> None:
    for s in rep.summary:
        pol = s["policy"]
        direct = math.fsum(r["total_j"] for r in rep.records
                           if r["policy"] == pol) \
            + math.fsum(x["unallocated_idle_j"]
                        for x in rep.epoch_summary
                        if x["policy"] == pol)
        rel = abs(s["total_j"] - direct) / max(direct, 1e-300)
        assert rel <= REL_TOL, (pol, rel)


def campaign_payload(campaign) -> str:
    """The campaign's result payload, canonically serialized for the
    bit-identity assertion (guard bookkeeping differs between a
    checkpointed and a plain run and is excluded)."""
    def recs(reports):
        return {repr(sev): {"records": rep.records,
                            "epoch_summary": rep.epoch_summary,
                            "summary": rep.summary}
                for sev, rep in reports.items()}
    return json.dumps({"summary": campaign["summary"],
                       "reports": recs(campaign["reports"]),
                       "baseline": recs(campaign["baseline_reports"])},
                      sort_keys=True)


def demo_kill_resume(ckdir: str, reference: str, device) -> None:
    """SIGKILL a checkpointed self-subprocess mid-campaign, resume
    from its checkpoint directory, assert bit-identical results."""
    cmd = [sys.executable, os.path.abspath(__file__),
           "--checkpoint", ckdir]
    if device:
        cmd += ["--device", device]
    env = dict(os.environ,
               REPRO_GUARD_KILL=f"mid:{KILL_EPOCH}",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..",
                                 "src"),
                    os.path.dirname(__file__)]))
    proc = subprocess.run(cmd, env=env, capture_output=True)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    snaps = sorted(os.listdir(os.path.join(ckdir, "run0_hyst")))
    print(f"\nkill–resume demo: subprocess SIGKILLed mid-epoch "
          f"{KILL_EPOCH}; checkpoint holds {snaps}")

    t0 = time.perf_counter()
    resumed = sweep_chaos(build_scenario(),
                          KnobGrid(window_scale=(0.5, 1.0, 2.0),
                                   delay_scale=(1.0, 2.0)),
                          fault_severities=SEVERITIES,
                          checkpoint=ckdir, device=device)
    wall = time.perf_counter() - t0
    assert campaign_payload(resumed) == reference
    print(f"kill–resume demo: resumed campaign is bit-identical to "
          f"the uninterrupted run (summary + per-epoch records), "
          f"{wall:.2f}s wall")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device of every per-epoch batched sweep call "
                         "(default: the card; 'cpu': the kernels' plain "
                         "versions; 'numpy': the numpy batched engine)")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="run the guard-plane kill–resume demo against "
                         "this campaign checkpoint directory")
    args = ap.parse_args(argv)
    return run(args.checkpoint, args.device)


def run(checkpoint=None, device=None):
    # armed child mode: the parent (below) relaunched us with
    # REPRO_GUARD_KILL set — run the checkpointed campaign directly
    # and die where the hook says; the parent resumes from our ruins
    if checkpoint is not None and os.environ.get("REPRO_GUARD_KILL"):
        sweep_chaos(build_scenario(),
                    KnobGrid(window_scale=(0.5, 1.0, 2.0),
                             delay_scale=(1.0, 2.0)),
                    fault_severities=SEVERITIES, checkpoint=checkpoint,
                    device=device)
        return
    scenario = build_scenario()
    grid = KnobGrid(window_scale=(0.5, 1.0, 2.0),
                    delay_scale=(1.0, 2.0))
    t0 = time.perf_counter()
    campaign = sweep_chaos(scenario, grid,
                           fault_severities=SEVERITIES, device=device)
    wall = time.perf_counter() - t0

    n_runs = len(campaign["reports"]) + len(campaign["baseline_reports"])
    print(f"chaos day: {len(SEVERITIES)} severities x "
          f"{len(scenario.policies)} policies over "
          f"{scenario.n_epochs} epochs on {scenario.n_chips} chips "
          f"({n_runs} fleet runs, one batched sweep call per epoch) "
          f"in {wall:.2f}s wall")

    print("\nfault timelines:")
    for sev in SEVERITIES:
        tl = campaign["timelines"][sev]
        fs = campaign["reports"][sev].fault_summary
        print(f"  sev={sev:.1f}  faulted_epochs={fs['faulted_epochs']:3d}"
              f"  transitions={tl.n_transitions:3d}"
              f"  chips_down_max={fs['chips_down_max']:3d}"
              f"  link_fault_epochs={fs['link_fault_epochs']:3d}"
              f"  pg_fault_epochs={fs['pg_fault_epochs']:3d}"
              f"  repairs={len(fs['repair_epochs'])}")

    print(f"\n{'sev':>4s} {'policy':12s} {'retunes':>8s} {'base':>5s} "
          f"{'bound':>6s} {'worst regret':>13s} {'SLO viol':>9s} "
          f"{'recov':>6s} {'pg-fb':>6s} {'J/req':>8s}")
    for row in campaign["summary"]:
        print(f"{row['fault_severity']:4.1f} {row['policy']:12s} "
              f"{row['retunes']:8d} {row['baseline_retunes']:5d} "
              f"{row['n_transitions']:6d} "
              f"{row['worst_regret_frac']*100:12.2f}% "
              f"{row['slo_violation_rate']*100:8.2f}% "
              f"{row['recovery_epochs_max']:6d} "
              f"{row['pg_fallback_epochs']:6d} "
              f"{row['j_per_request']:8.1f}")

    # in-line invariants ------------------------------------------------
    check_clean_noop(campaign, scenario, grid, device)
    for sev in SEVERITIES:
        check_energy_conservation(campaign["reports"][sev])
        check_energy_conservation(campaign["baseline_reports"][sev])
    print(f"energy conservation: totals match per-record sums to "
          f"<= {REL_TOL:g} relative, all severities and policies")
    for row in campaign["summary"]:
        if row["fault_severity"] == 0.0:
            assert row["retunes"] <= row["n_transitions"] \
                + len(scenario.policies)
            continue
        # anti-thrash: the hysteresis governor never out-retunes the
        # stateless baseline, and stays within the transition bound
        # (plus the initial deployment per class x knob row)
        assert row["retunes"] <= row["baseline_retunes"], row
    print("anti-thrash: hysteresis retunes <= stateless baseline "
          "retunes on every faulted scenario")

    if checkpoint is not None:
        demo_kill_resume(checkpoint, campaign_payload(campaign),
                         device)


if __name__ == "__main__":
    main()
