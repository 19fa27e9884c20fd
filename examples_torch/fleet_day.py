"""A day in the life of a 4096-chip NPU fleet, on the batched sweep
kernel of the PyTorch / CUDA port -- ``examples/fleet_day.py`` with
``repro_torch``.

Four tenant classes — diurnal chat decode + prefill, a bursty 70B
research tier, and a steady DLRM embedding service — generate over a
million requests across a 24h window (96 x 15-min epochs). Every epoch
is dispatched as exactly ONE batched ``evaluate_batch`` call over the
active (class-mix x policies x knob-grid) cube, the online SLO governor
re-tunes ``PolicyKnobs`` whenever queueing pressure inflates effective
runtimes past the relaxed SLO, and ``carbon.fleet_rollup`` turns the
summed per-chip joules into facility kWh / kgCO2e / USD.

  PYTHONPATH=src python examples_torch/fleet_day.py [--device cpu]

Runs on the card (kernels K1 and K2, one launch of K1 an epoch) unless
``--device cpu`` (their plain versions) or ``--device numpy`` (the numpy
batched engine), as every entry point does.

The run is deterministic under the fixed seed (arrival traces follow
the ``core.perturb`` explicit-Generator fixed-draw-count contract), and
the script asserts in-line that the fleet carbon/cost totals reconcile
with the sum of per-record chip energies to <= 1e-9 relative.
"""
import argparse
import math
import time

from repro_torch.core.carbon import CARBON_INTENSITY, PUE, USD_PER_KWH
from repro_torch.core.fleet import ArrivalSpec, FleetScenario, WorkloadClass
from repro_torch.core.opgen import dlrm_workload, llm_workload
from repro_torch.core.policies import KnobGrid
from repro_torch.core.sweep import sweep_fleet

REL_TOL = 1e-9


def build_scenario() -> FleetScenario:
    # Interactive chat rides the day curve (peak_frac=0.9: near-quiet
    # overnight troughs); the 70B research tier flash-crowds; DLRM
    # serving is steady background load.
    chat_decode = WorkloadClass(
        "chat-decode",
        llm_workload("llama3-8b", "decode", batch=8),
        ArrivalSpec("diurnal", rate_rps=10.0, peak_frac=0.9,
                    period_s=86400.0, phase_s=-21600.0),
        requests_per_invocation=8)
    chat_prefill = WorkloadClass(
        "chat-prefill",
        llm_workload("llama3-8b", "prefill", batch=1, seq=4096),
        ArrivalSpec("diurnal", rate_rps=10.0, peak_frac=0.9,
                    period_s=86400.0, phase_s=-21600.0))
    research = WorkloadClass(
        "research-70b",
        llm_workload("llama3-70b", "decode", batch=4, n_chips=8, tp=8),
        ArrivalSpec("bursty", rate_rps=1.5, burst_prob=0.15,
                    burst_factor=8.0),
        requests_per_invocation=4)
    ranking = WorkloadClass(
        "ranking-dlrm",
        dlrm_workload("M"),
        ArrivalSpec("poisson", rate_rps=3.0),
        requests_per_invocation=1024)
    return FleetScenario(
        classes=(chat_decode, chat_prefill, research, ranking),
        n_chips=4096, npu="NPU-D",
        policies=("NoPG", "ReGate-HW", "ReGate-Full"),
        duration_s=86400.0, epoch_s=900.0,
        slo_relax=1.2, seed=7, severity_levels=(0.0, 0.5, 1.0))


def check_reconciliation(report) -> None:
    """Fleet totals must equal the per-record chip-energy sums (plus
    unallocated-chip idle) and the carbon/cost roll-up must be exact
    arithmetic on those joules — both to <= 1e-9 relative."""
    for s in report.summary:
        pol = s["policy"]
        recs = [r for r in report.records if r["policy"] == pol]
        eps = [x for x in report.epoch_summary if x["policy"] == pol]
        direct = math.fsum(r["total_j"] for r in recs) \
            + math.fsum(x["unallocated_idle_j"] for x in eps)
        rel = abs(s["total_j"] - direct) / max(direct, 1e-300)
        assert rel <= REL_TOL, (pol, rel)
        kwh = s["total_j"] / 3.6e6
        for got, want in ((s["chip_kwh"], kwh),
                          (s["facility_kwh"], kwh * PUE),
                          (s["co2_kg"], kwh * PUE * CARBON_INTENSITY),
                          (s["cost_usd"], kwh * PUE * USD_PER_KWH)):
            assert abs(got - want) <= REL_TOL * max(abs(want), 1.0), pol
    print(f"reconciliation: totals match per-record sums and roll-up "
          f"arithmetic to <= {REL_TOL:g} relative, all policies")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device of every per-epoch batched sweep call "
                         "(default: the card; 'cpu': the kernels' plain "
                         "versions; 'numpy': the numpy batched engine)")
    args = ap.parse_args(argv)
    return run(args.device)


def run(device=None):
    scenario = build_scenario()
    grid = KnobGrid(window_scale=(0.5, 1.0, 2.0),
                    delay_scale=(1.0, 2.0))
    t0 = time.perf_counter()
    report = sweep_fleet(scenario, grid, device=device)
    wall = time.perf_counter() - t0

    assert report.n_chips == 4096
    assert report.requests_total >= 1_000_000, report.requests_total
    print(f"fleet day: {report.requests_total:,} requests over "
          f"{report.n_epochs} epochs x {report.epoch_s:.0f}s on "
          f"{report.n_chips} x {report.npu} chips "
          f"({len(report.class_names)} classes, "
          f"{grid.size}-knob grid, one batched sweep call per epoch) "
          f"in {wall:.2f}s wall")

    # a few epochs through the day: demand, congestion level, governor
    print("\nepoch samples (ReGate-Full):")
    eps = [s for s in report.epoch_summary
           if s["policy"] == "ReGate-Full"]
    for s in eps[:: max(1, len(eps) // 8)]:
        hour = s["epoch"] * report.epoch_s / 3600.0
        print(f"  t={hour:5.2f}h  requests={s['requests']:6d}  "
              f"severity={s['severity']:.1f}  "
              f"active_chips={s['chips_active']:4d}  "
              f"retunes={s['retunes']}  violations={s['violations']}")

    print(f"\n{'policy':12s} {'MWh(fac)':>9s} {'tCO2e':>7s} "
          f"{'USD':>8s} {'J/req':>8s} {'SLO viol':>9s} {'retunes':>8s}")
    nopg = report.policy_summary("NoPG")
    for s in report.summary:
        print(f"{s['policy']:12s} {s['facility_kwh']/1e3:9.2f} "
              f"{s['co2_kg']/1e3:7.2f} {s['cost_usd']:8.0f} "
              f"{s['j_per_request']:8.1f} "
              f"{s['slo_violation_rate']*100:8.2f}% "
              f"{s['retunes']:8d}")
    for pol in ("ReGate-HW", "ReGate-Full"):
        s = report.policy_summary(pol)
        sv = 1.0 - s["total_j"] / nopg["total_j"]
        print(f"  {pol} fleet energy saving vs NoPG: {sv*100:.1f}% "
              f"(${nopg['cost_usd'] - s['cost_usd']:.0f}/day)")

    print()
    check_reconciliation(report)


if __name__ == "__main__":
    main()
