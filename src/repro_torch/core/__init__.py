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
"""
from repro_torch.core.backend import get_backend
from repro_torch.core.hw import NPUS, get_npu
from repro_torch.core.opgen import compile_trace, stack_traces
from repro_torch.core.policies import POLICIES, evaluate, evaluate_all, \
    evaluate_batch, evaluate_reference, savings_vs_nopg
from repro_torch.core.sweep import knob_product, sweep, sweep_grid, \
    sweep_reference

__all__ = ["NPUS", "get_npu", "POLICIES", "compile_trace", "stack_traces",
           "evaluate", "evaluate_all", "evaluate_batch",
           "evaluate_reference", "savings_vs_nopg", "sweep", "sweep_grid",
           "sweep_reference", "knob_product", "get_backend"]
