"""The power plane: ReGate power-gating co-design, on PyTorch.

hw/power       — NPU-A..E specs (Table 2/3) + calibrated power model
sa_gating      — PE-level spatial SA gating closed form (Figs 10-13)
opgen          — operator traces and columnar trace compilation
policies       — the five designs (§6) and ``evaluate_batch``, the
                 batched sweep kernel over the stacked super-trace
sweep          — design-space sweeps (workloads × npus × policies ×
                 knob grids) and record-table consumers
backend        — the float64 tensor substrate; on a CUDA device its
                 occupancy pass and segmented sums are the hand-written
                 kernels of ``repro_torch.kernels``
session        — ``SweepSession``: the device a sweep runs on
"""
from repro_torch.core.backend import get_backend
from repro_torch.core.hw import NPUS, get_npu
from repro_torch.core.opgen import compile_trace, stack_traces
from repro_torch.core.policies import POLICIES, evaluate_batch
from repro_torch.core.sweep import knob_product, sweep, sweep_grid

__all__ = ["NPUS", "get_npu", "POLICIES", "compile_trace", "stack_traces",
           "evaluate_batch", "sweep", "sweep_grid", "knob_product",
           "get_backend"]
