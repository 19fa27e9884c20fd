"""The power plane: ReGate power-gating co-design, on PyTorch.

hw/power       — NPU-A..E specs (Table 2/3) + calibrated power model
sa_gating      — PE-level spatial SA gating closed form (Figs 10-13)
opgen          — operator traces and columnar trace compilation
policies       — the five designs (§6): the host engines ``evaluate``
                 (columnar) and ``evaluate_reference`` (scalar oracle),
                 and ``evaluate_batch``, the batched sweep kernel over
                 the stacked super-trace
sweep          — design-space sweeps (workloads × npus × policies ×
                 knob grids), the ``sweep_reference`` loop oracle, and
                 record-table consumers
backend        — the float64 tensor substrate; on a CUDA device its
                 occupancy pass and segmented sums are the hand-written
                 kernels of ``repro_torch.kernels``
session        — ``SweepSession``: the device a sweep runs on
isa/passes     — setpm ISA extension, the cycle-stepper and event-driven
                 executors, and the compiler passes (Figs 14-15, §4.3)
lowering       — workload traces lowered onto per-unit cycle timelines,
                 the SRAM segment-band analysis, the per-cell oracle
program_plane  — the batched program plane: every lowered, instrumented
                 program in one call of the event executor (kernel B7
                 on a CUDA device)
carbon         — operational/embodied carbon (Figs 24-25)
slo            — SLO-constrained config sweep (Fig 2) and the re-tune rule
ici_topology   — ring / 2-D-mesh collective schedules lowered onto the
                 op-level trace (per-step ICI busy/idle timelines)
perturb        — seeded fault injection + adversarial perturbation
                 (jitter plane) and the ISA differential fuzz harness
faults         — seeded chip / link fault timelines (chaos plane) and
                 the faults-seeded ISA fuzz
fleet          — a chip fleet over a day of seeded arrivals, one
                 ``evaluate_batch`` call per epoch (``sweep_fleet``), and
                 the chaos campaign over fault severities (``sweep_chaos``)
guard          — the guard plane: deadline watchdog, retries, the
                 failover ladder (none below the card), NaN quarantine
                 against the numpy batched engine,
                 crash-consistent campaign checkpoints
"""
from repro_torch.core.backend import get_backend
from repro_torch.core.hw import NPUS, get_npu
from repro_torch.core.opgen import compile_trace, stack_traces
from repro_torch.core.policies import POLICIES, evaluate, evaluate_all, \
    evaluate_batch, evaluate_batch_numpy, evaluate_reference, \
    savings_vs_nopg
from repro_torch.core.sweep import GuardPolicy, knob_product, sweep, \
    sweep_chaos, sweep_fleet, sweep_grid, sweep_program_plane, \
    sweep_program_plane_reference, sweep_reference, sweep_robustness

__all__ = ["NPUS", "get_npu", "POLICIES", "compile_trace", "stack_traces",
           "evaluate", "evaluate_all", "evaluate_batch",
           "evaluate_batch_numpy", "evaluate_reference", "savings_vs_nopg",
           "sweep", "sweep_grid", "sweep_reference", "sweep_robustness",
           "sweep_program_plane", "sweep_program_plane_reference",
           "sweep_fleet", "sweep_chaos", "GuardPolicy", "knob_product",
           "get_backend"]
