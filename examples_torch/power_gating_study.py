"""Reproduce the paper's headline analysis end-to-end on the batched
sweep plane of the PyTorch / CUDA port -- ``examples/power_gating_study.py``
with ``repro_torch``: Figs 3/17/19/24 numbers for the whole Table-1
suite, the NPU-generation sweep, and a full delay-scale knob-grid
sensitivity study — each section is ONE batched ``sweep`` call (suite ×
npus × policies × knobs evaluated in a handful of tensor passes), so the
whole study runs in seconds.

  PYTHONPATH=src python examples_torch/power_gating_study.py [--device cpu]
                                                             [--fine-grid]

Runs on the card unless ``--device cpu`` (the kernels' plain versions on
the host), as every entry point does; ``--fine-grid`` adds a §6.5-style
``sweep_grid`` sensitivity cube (suite × 5 generations × {NoPG,
ReGate-Full} × 240 crossed knobs = 40 800 cells in one call).
"""
import argparse
import statistics
import time

from repro_torch.core.carbon import yearly_carbon
from repro_torch.core.hw import NPUS
from repro_torch.core.opgen import paper_suite
from repro_torch.core.policies import POLICIES, PolicyKnobs, evaluate_all, \
    savings_vs_nopg
from repro_torch.core.sweep import group_by, sweep, sweep_grid, with_savings


def fine_grid_study():
    """CompPow-style fine-knob cube: where does ReGate-Full's saving
    move fastest? One ``sweep_grid`` call, min/max over the cube."""
    t0 = time.perf_counter()
    recs = sweep_grid(
        paper_suite(), npus=tuple(NPUS),
        policies=("NoPG", "ReGate-Full"),
        delay_scale=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
        leak_off_logic=(0.01, 0.03, 0.1, 0.2, 0.4),
        leak_sram_sleep=(0.1, 0.25, 0.4, 0.6),
        leak_sram_off=(0.002, 0.02),
        sa_width=(None, 256))  # §6.5 SA-width axis — a real knob now
    recs = with_savings(recs)
    print(f"\nfine-grid cube: {len(recs)} cells in "
          f"{time.perf_counter() - t0:.2f}s")
    for (gen,), rows in group_by(recs, "npu").items():
        sv = [r["savings"] for r in rows if r["policy"] == "ReGate-Full"]
        print(f"  {gen}: ReGate-Full savings across the knob cube "
              f"{min(sv)*100:.1f}% .. {max(sv)*100:.1f}%")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device of every sweep in the study (default: "
                         "the card; 'cpu' runs the kernels' plain "
                         "versions)")
    ap.add_argument("--fine-grid", action="store_true",
                    help="also run the 40,800-cell sensitivity cube "
                         "(suite x 5 gens x {NoPG, ReGate-Full} x 240 "
                         "crossed knobs)")
    args = ap.parse_args(argv)
    if args.device:
        from repro_torch.core.sweep import SweepSession
        with SweepSession(device=args.device):
            return _study(args)
    return _study(args)


def _study(args):
    t_start = time.perf_counter()
    print(f"{'workload':24s} {'static%':>8s} "
          + "".join(f"{p:>13s}" for p in POLICIES[1:])
          + f" {'ovFull%':>9s} {'carbon%':>9s}")
    per_policy = {p: [] for p in POLICIES[1:]}
    for wl in paper_suite():
        reps = evaluate_all(wl, "NPU-D")  # one batched pass, all policies
        sv = savings_vs_nopg(reps)
        ov = reps["ReGate-Full"].runtime_s / reps["NoPG"].runtime_s - 1
        c_no = yearly_carbon(reps["NoPG"].avg_power_w, "NPU-D", False)
        c_rg = yearly_carbon(reps["ReGate-Full"].avg_power_w, "NPU-D", True)
        carbon = 1 - c_rg.total_kg_per_year / c_no.total_kg_per_year
        row = f"{wl.name:24s} {reps['NoPG'].static_frac*100:7.1f}%"
        for p in POLICIES[1:]:
            per_policy[p].append(sv[p])
            row += f" {sv[p]*100:11.1f}%"
        print(row + f" {ov*100:8.3f}% {carbon*100:8.1f}%")
    print("-" * 110)
    print("averages: " + "  ".join(
        f"{p}={statistics.mean(v)*100:.1f}%" for p, v in per_policy.items()))
    print("paper:    ReGate-Full 8.5-32.8% (avg 15.5%), overhead <0.5%, "
          "carbon 31.1-62.9%")

    # --- Fig 23: all 5 generations in ONE batched sweep ---
    print("\nper-generation ReGate-Full savings (paper Fig 23, one "
          "batched sweep over suite x 5 gens):")
    recs = with_savings(sweep(paper_suite(), npus=tuple(NPUS),
                              policies=("NoPG", "ReGate-Full")))
    for (gen,), rows in group_by(recs, "npu").items():
        vals = [r["savings"] for r in rows if r["policy"] == "ReGate-Full"]
        print(f"  {gen}: avg {statistics.mean(vals)*100:.1f}%  "
              f"range {min(vals)*100:.1f}-{max(vals)*100:.1f}%")

    # --- Fig 22-style knob-grid study: suite x 6 delay scales, one call;
    # NoPG is knob-insensitive, so the baseline rides the knob-0 cell and
    # with_savings falls back to it for the other knob points ---
    scales = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)
    grid = [PolicyKnobs(delay_scale=s) for s in scales]
    full = sweep(paper_suite(), policies=("NoPG", "ReGate-Full"),
                 knob_grid=grid)
    pruned = [r for r in full
              if r["policy"] != "NoPG" or r["knob_idx"] == 0]
    recs = with_savings(pruned)
    print(f"\ndelay-scale sensitivity (suite x {len(scales)}-point knob "
          "grid, one batched sweep):")
    for (ki,), rows in group_by(recs, "knob_idx").items():
        fullr = [r for r in rows if r["policy"] == "ReGate-Full"]
        if not fullr:
            continue
        sv = statistics.mean(r["savings"] for r in fullr)
        print(f"  delay x{scales[ki]:<5g} ReGate-Full avg savings "
              f"{sv*100:.1f}%")
    if args.fine_grid:
        fine_grid_study()
    print(f"\ntotal study wall time: {time.perf_counter()-t_start:.2f}s")


if __name__ == "__main__":
    main()
