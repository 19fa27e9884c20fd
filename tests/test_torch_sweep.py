"""The port's slice as a whole against the reference's power plane.

``repro_torch`` ``sweep`` / ``sweep_grid`` / ``evaluate_batch`` on
``device="cpu"`` (the kernels' plain versions) against ``repro`` on
``backend="numpy"`` — the reference's oracle — record for record, same
order, every numeric field ≤1e-9 relative (1e-30 floor): the 1 700-record
acceptance grid, mixed ``sa_width × window_scale × delay_scale`` grids,
randomized ragged stacks with empty and single-op workloads, size-1 knob
grids, the record-table consumers, and the ``convert`` round trip that
pushes a reference-built trace through the port's kernel. The port's
kernel is also held bit for bit to the reference's backend-neutral
kernel on its numpy backend: same expressions, same operand order.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import backend as ref_backend  # noqa: E402
from repro.core import hw as ref_hw  # noqa: E402
from repro.core import opgen as ref_opgen  # noqa: E402
from repro.core import policies as ref_pol  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import hw as port_hw  # noqa: E402
from repro_torch.core import opgen as port_opgen  # noqa: E402
from repro_torch.core import policies as port_pol  # noqa: E402
from repro_torch.core import session as port_session  # noqa: E402

from _torch_parity import (RTOL, assert_cubes_match,  # noqa: E402
                           assert_records_match, build_workloads,
                           dump_knobs, dump_npu, dump_stack, knob_grids,
                           max_rel_dev, random_ops)

# both ``core`` packages re-export a ``sweep`` function that shadows the
# submodule of the same name on attribute access
ref_sweep = importlib.import_module("repro.core.sweep")
port_sweep = importlib.import_module("repro_torch.core.sweep")

POLICIES = ref_pol.POLICIES
NPUS = tuple(ref_hw.NPUS)

# the acceptance grid: paper_suite × 5 NPUs × 5 policies × 4 knobs
KNOB_ROWS = [dict(), dict(delay_scale=2.0), dict(delay_scale=4.0),
             dict(leak_off_logic=0.2, leak_sram_sleep=0.4,
                  leak_sram_off=0.02)]

MIXED_AXES = dict(delay_scale=(1.0, 2.0), leak_off_logic=(None, 0.2),
                  leak_sram_sleep=(None,), leak_sram_off=(0.002,),
                  sa_width=(None, 256), window_scale=(0.5, 1.0))


def _ref_kernel_cube(workloads, npus, policies, grid):
    """The reference's backend-neutral ``_sweep_kernel`` on its numpy
    backend — the program the port's kernel translates."""
    specs = tuple(ref_hw.get_npu(n) for n in npus)
    return ref_pol._evaluate_batch_backend(
        list(workloads), specs, tuple(policies), tuple(grid),
        ref_backend.get_backend("numpy"))


# --------------------------------------------------------------------------
# the acceptance grid
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def acceptance_records():
    rg, pg = knob_grids(KNOB_ROWS)
    ref = ref_sweep.sweep(ref_opgen.paper_suite(), NPUS, POLICIES, rg,
                          backend="numpy")
    got = port_sweep.sweep(port_opgen.paper_suite(), NPUS, POLICIES, pg,
                           device="cpu")
    return ref, got


def test_acceptance_grid_1700_records(acceptance_records):
    ref, got = acceptance_records
    assert len(got) == len(ref) == 17 * 5 * 5 * 4
    key = ("workload", "npu", "policy", "knob_idx")
    assert [tuple(r[k] for k in key) for r in ref] \
        == [tuple(r[k] for k in key) for r in got]
    assert_records_match(ref, got)
    assert max_rel_dev(ref, got) <= RTOL


def test_records_are_float64_finite_python_floats(acceptance_records):
    _, got = acceptance_records
    for rec in got:
        for k, v in rec.items():
            if isinstance(v, float):
                assert np.isfinite(v), (rec["workload"], k)
    assert isinstance(got[0]["total_j"], float)


@pytest.mark.parametrize("baseline", ["NoPG", "ReGate-Base"])
def test_with_savings_and_group_by_equal(acceptance_records, baseline):
    ref, got = acceptance_records
    rs = ref_sweep.with_savings(ref, baseline)
    ps = port_sweep.with_savings(got, baseline)
    assert_records_match(rs, ps)
    rg = ref_sweep.group_by(rs, "npu", "policy")
    pg = port_sweep.group_by(ps, "npu", "policy")
    assert list(rg) == list(pg)
    for k in rg:
        assert_records_match(rg[k], pg[k])


@pytest.mark.parametrize("npu", NPUS)
def test_kernel_bit_identical_to_reference_numpy_kernel(npu):
    """Same expressions in the same operand order: the port's kernel on
    the CPU gives the bits of the reference's kernel on numpy, on a
    crossed width × window × delay × leakage grid."""
    kw = dict(delay_scale=(0.25, 1.0, 8.0), leak_off_logic=(0.01, 0.4),
              leak_sram_sleep=(0.1,), leak_sram_off=(0.002, 0.02),
              sa_width=(None, 32, 256), window_scale=(0.5, 2.0))
    ref = _ref_kernel_cube(ref_opgen.paper_suite(), (npu,), POLICIES,
                           ref_pol.KnobGrid(**kw).product())
    got = port_pol.evaluate_batch(port_opgen.paper_suite(), (npu,),
                                  POLICIES, port_pol.KnobGrid(**kw),
                                  device="cpu")
    assert_cubes_match(ref, got, exact=True)


# --------------------------------------------------------------------------
# mixed sa_width × window_scale × delay_scale grids
# --------------------------------------------------------------------------

def test_sweep_grid_mixed_axes():
    rw, pw = ref_opgen.paper_suite()[:2], port_opgen.paper_suite()[:2]
    pols = ("NoPG", "ReGate-Full")
    ref = ref_sweep.sweep_grid(rw, npus=("NPU-D",), policies=pols,
                               backend="numpy", **MIXED_AXES)
    legacy = port_sweep.sweep_grid(pw, npus=("NPU-D",), policies=pols,
                                   device="cpu", **MIXED_AXES)
    new = port_sweep.sweep_grid(pw, npus=("NPU-D",), policies=pols,
                                device="cpu",
                                grid=port_pol.KnobGrid(**MIXED_AXES))
    assert len(ref) == 2 * 2 * 16
    assert_records_match(ref, legacy)
    assert legacy == new  # the two spellings are the same computation


def test_mixed_axes_survive_savings_and_group_by():
    kw = dict(sa_width=(None, 256), window_scale=(0.5, 1.0),
              delay_scale=(1.0, 2.0))
    pols = ("NoPG", "ReGate-Full")
    ref = ref_sweep.sweep_grid(ref_opgen.paper_suite()[:2], policies=pols,
                               grid=ref_pol.KnobGrid(**kw),
                               backend="numpy")
    got = port_sweep.sweep_grid(port_opgen.paper_suite()[:2], policies=pols,
                                grid=port_pol.KnobGrid(**kw), device="cpu")
    sv = port_sweep.with_savings(got)
    assert_records_match(ref_sweep.with_savings(ref), sv)
    assert len(sv) == 2 * 2 * 8
    assert all(r["savings"] is not None for r in sv)
    groups = port_sweep.group_by(sv, "sa_width", "window_scale")
    assert set(groups) == {(w, s) for w in (None, 256) for s in (0.5, 1.0)}
    assert sum(len(g) for g in groups.values()) == len(sv)


def test_sa_width_axis_moves_the_sa_numbers():
    wl_r, wl_p = ref_opgen.paper_suite()[4], port_opgen.paper_suite()[4]
    pols = ("NoPG", "ReGate-HW")
    ref = ref_sweep.sweep_grid(wl_r, ("NPU-D",), pols, sa_width=(None, 256),
                               backend="numpy")
    res = port_sweep.sweep_grid(wl_p, ("NPU-D",), pols,
                                sa_width=(None, 256), device="cpu",
                                as_records=False)
    assert tuple(n.name for n in res.npus) == ("NPU-D",)
    got = res.records()
    assert_records_match(ref, got)
    assert {r["sa_width"] for r in got} == {None, 256}
    native, wide = (next(r for r in got if r["sa_width"] == w
                         and r["policy"] == "ReGate-HW")
                    for w in (None, 256))
    assert native["runtime_s"] != wide["runtime_s"]


@pytest.mark.parametrize("npus", [("NPU-A", "NPU-E"), ("NPU-C",)])
def test_width_by_delay_grid(npus):
    """Widths that collapse onto the native one (128 on A–D, 256 on E)
    and ones that do not, crossed with delay scales."""
    kw = dict(delay_scale=(1.0, 3.0), sa_width=(None, 64, 128, 256, 512))
    ref = ref_sweep.sweep(ref_opgen.paper_suite()[:3], npus, POLICIES,
                          ref_sweep.knob_product(**kw), backend="numpy")
    got = port_sweep.sweep(port_opgen.paper_suite()[:3], npus, POLICIES,
                           port_sweep.knob_product(**kw), device="cpu")
    assert_records_match(ref, got)


def test_sweep_grid_rejects_mixed_spellings():
    wls = port_opgen.paper_suite()[:1]
    with pytest.raises(ValueError, match="not both"):
        port_sweep.sweep_grid(wls, grid=port_pol.KnobGrid(**MIXED_AXES),
                              delay_scale=(1.0, 2.0), device="cpu")
    with pytest.raises(TypeError, match="KnobGrid"):
        port_sweep.sweep_grid(wls, grid=[port_pol.PolicyKnobs()],
                              device="cpu")


# --------------------------------------------------------------------------
# randomized ragged stacks, empty and single-op workloads, size-1 grids
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 11, 17])
def test_randomized_ragged_stack(seed):
    rng = np.random.default_rng(seed)
    sizes = [0, 1, int(rng.integers(2, 30)), 0, 1,
             int(rng.integers(2, 30)), int(rng.integers(2, 40)), 0]
    specs = [(f"rand-{i}", random_ops(rng, n)) for i, n in enumerate(sizes)]
    rows = [dict(), dict(delay_scale=3.0),
            dict(leak_off_logic=0.0, delay_scale=0.25),
            dict(sa_width=64, window_scale=2.0)]
    rg, pg = knob_grids(rows)
    npus = ("NPU-A", "NPU-E")
    ref = ref_pol.evaluate_batch(build_workloads(ref_opgen, specs), npus,
                                 POLICIES, rg, backend="numpy")
    got = port_pol.evaluate_batch(build_workloads(port_opgen, specs), npus,
                                  POLICIES, pg, device="cpu")
    assert_cubes_match(ref, got)
    assert_records_match(ref.records(), got.records())
    for wi, n in enumerate(sizes):
        rep = got.report(wi, 0, 3, 1)
        want = ref.report(wi, 0, 3, 1)
        assert rep.workload == want.workload and rep.policy == want.policy
        if n == 0:  # empty segments come back as exact zeros
            assert rep.runtime_s == 0.0 and rep.total_j == 0.0
            assert rep.setpm_count == 0.0
    for rec in got.records():
        assert all(np.isfinite(v) for v in rec.values()
                   if isinstance(v, float))


def test_all_workloads_empty():
    """Segments but no ops at all: nothing reaches the device passes."""
    wls = [port_opgen.Workload(f"e{i}", "prefill", ()) for i in range(3)]
    res = port_pol.evaluate_batch(wls, ("NPU-B",), POLICIES, device="cpu")
    assert res.shape == (3, 1, len(POLICIES), 1)
    assert float(np.abs(res.runtime_s).sum()) == 0.0
    assert all(r["total_j"] == 0.0 for r in res.records())


def test_no_workloads_empty_result():
    res = port_pol.evaluate_batch([], ("NPU-D",), POLICIES, device="cpu")
    assert res.shape == (0, 1, len(POLICIES), 1)
    assert res.records() == []


def test_size_one_knob_grid_and_single_workload():
    rk, pk = knob_grids([dict(delay_scale=2.0)])
    ref = ref_sweep.sweep(ref_opgen.paper_suite()[8], ("NPU-C",), POLICIES,
                          rk, backend="numpy")
    got = port_sweep.sweep(port_opgen.paper_suite()[8], ("NPU-C",), POLICIES,
                           pk, device="cpu")
    assert len(got) == len(POLICIES)
    assert_records_match(ref, got)


def test_single_op_workload_and_spec_npus():
    spec = [("one", [dict(name="mm", flops_sa=2e12, flops_vu=1e9,
                          bytes_hbm=1e9, sram_demand=1 << 20,
                          matmul_dims=(512, 72, 512), count=3)])]
    ref = ref_sweep.sweep(build_workloads(ref_opgen, spec),
                          (ref_hw.get_npu("NPU-E"),), POLICIES,
                          backend="numpy")
    got = port_sweep.sweep(build_workloads(port_opgen, spec),
                           (port_hw.get_npu("NPU-E"),), POLICIES,
                           device="cpu")
    assert_records_match(ref, got)


def test_deterministic_ordering_and_rerun():
    wls = port_opgen.paper_suite()[:2]
    grid = [port_pol.PolicyKnobs(), port_pol.PolicyKnobs(delay_scale=2.0)]
    kw = dict(npus=("NPU-A", "NPU-D"), policies=("NoPG", "ReGate-Full"),
              knob_grid=grid, device="cpu")
    recs = port_sweep.sweep(wls, **kw)
    expect = [(w.name, n, p, k) for w in wls for n in ("NPU-A", "NPU-D")
              for p in ("NoPG", "ReGate-Full") for k in (0, 1)]
    assert [(r["workload"], r["npu"], r["policy"], r["knob_idx"])
            for r in recs] == expect
    assert recs[1]["delay_scale"] == 2.0
    assert recs == port_sweep.sweep(wls, **kw)  # bit-identical rerun


# --------------------------------------------------------------------------
# state carried across: reference trace -> port kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("npu", ["NPU-A", "NPU-D", "NPU-E"])
def test_convert_round_trip(npu):
    """The reference's stack, NPU spec and knob grid dumped to plain
    data, rebuilt by ``convert`` and pushed through the port's kernel:
    a difference here is the kernel's, not the trace generator's."""
    rwl = ref_opgen.paper_suite()[3:9]
    rgrid = ref_pol.KnobGrid(delay_scale=(0.5, 2.0), sa_width=(None, 64),
                             window_scale=(1.0, 2.0)).product()
    ref = ref_pol.evaluate_batch(rwl, (npu,), POLICIES, rgrid,
                                 backend="numpy")
    st = convert.stacked_trace_from_numpy(
        *dump_stack(ref_opgen.stack_traces(rwl)))
    spec = convert.npu_from_dict(dump_npu(ref_hw.get_npu(npu)))
    grid = convert.knob_grid_from_dicts(dump_knobs(rgrid))
    assert spec == port_hw.get_npu(npu)
    assert grid == tuple(port_pol.KnobGrid(
        delay_scale=(0.5, 2.0), sa_width=(None, 64),
        window_scale=(1.0, 2.0)).product())
    bk = port_pol.get_backend("cpu")
    data, _ = port_pol._backend_data(st, spec, bk)
    out = port_pol._sweep_kernel(data, port_pol._knob_arrays(grid, spec, bk),
                                 POLICIES, bk)
    d_seg = out["D_seg"].numpy().T                       # (W, K)
    nopg = POLICIES.index("NoPG")
    want = ref.runtime_s[:, 0, nopg, :]                  # no exposed wakes
    assert np.abs(d_seg - want).max() <= RTOL * np.abs(want).max()
    # and the whole cube through the port's host assembly
    port_stack = port_opgen.stack_traces(port_opgen.paper_suite()[3:9])
    for col in ("flops_sa", "bytes_hbm", "count", "has_mm"):
        assert np.array_equal(getattr(st, col), getattr(port_stack, col))
    got = port_pol.evaluate_batch(port_opgen.paper_suite()[3:9], (spec,),
                                  POLICIES, grid, device="cpu")
    assert_cubes_match(ref, got)


def test_convert_rejects_malformed_stacks():
    cols, names, offsets = dump_stack(
        ref_opgen.stack_traces(ref_opgen.paper_suite()[12:14]))
    with pytest.raises(ValueError, match="offsets"):
        convert.stacked_trace_from_numpy(cols, names, offsets[:-1])
    with pytest.raises(ValueError, match="shape"):
        convert.stacked_trace_from_numpy(
            {**cols, "count": cols["count"][:-1]}, names, offsets)
    with pytest.raises(ValueError, match="decrease"):
        convert.stacked_trace_from_numpy(cols, names, offsets[::-1])


# --------------------------------------------------------------------------
# validation and the device rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(delay_scale=0.0), dict(delay_scale=float("nan")),
    dict(window_scale=-1.0), dict(window_scale=float("inf")),
    dict(leak_off_logic=-0.1), dict(leak_sram_sleep=float("nan")),
    dict(leak_sram_off=float("inf")), dict(sa_width=0)])
def test_validate_knob_grid_rejects_what_the_reference_rejects(bad):
    rk, pk = knob_grids([dict(), bad])
    with pytest.raises(ValueError, match="knob 1"):
        ref_pol._validate_knob_grid(rk)
    with pytest.raises(ValueError, match="knob 1"):
        port_pol._validate_knob_grid(pk)
    with pytest.raises(ValueError, match="knob 1"):
        port_sweep.sweep(port_opgen.paper_suite()[:1], knob_grid=pk,
                         device="cpu")


@pytest.mark.parametrize("bad", [
    dict(delay_scale=(0.0,)), dict(window_scale=()), dict(sa_width=(1.5,)),
    dict(leak_off_logic=(-0.1,))])
def test_knob_grid_axis_validation(bad):
    with pytest.raises((ValueError, TypeError)):
        ref_pol.KnobGrid(**bad)
    with pytest.raises((ValueError, TypeError)):
        port_pol.KnobGrid(**bad)


def test_device_defaults_to_the_card_and_sessions_scope_it():
    wl = port_opgen.paper_suite()[12]
    assert port_session.current() == {"device": None,
                                      "gating_cache_size": None,
                                      "guard": None}
    if not torch.cuda.is_available():
        for call in (lambda: port_sweep.sweep(wl),
                     lambda: port_sweep.sweep_grid(wl),
                     lambda: port_pol.evaluate_batch(wl)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    explicit = port_sweep.sweep(wl, device="cpu")
    with port_sweep.SweepSession(device="cpu") as outer:
        assert port_session.resolve("device") == "cpu"
        assert port_sweep.sweep(wl) == explicit
        with port_sweep.SweepSession():  # inherits
            assert port_session.resolve("device") == "cpu"
        with pytest.raises(RuntimeError, match="re-entrant"):
            outer.__enter__()
    assert port_session.resolve("device") is None
    prev = port_session.set_root(device="cpu")
    try:
        assert prev == {"device": None}
        assert port_sweep.sweep(wl) == explicit
    finally:
        port_session.set_root(**prev)
    with pytest.raises(KeyError):
        port_session.set_root(backend="numpy")
    with pytest.raises(RuntimeError):
        port_sweep.SweepSession(device="not-a-device")


def test_missing_knob_column_fails_loudly():
    recs = port_sweep.sweep(port_opgen.paper_suite()[:1],
                            policies=("NoPG", "ReGate-Full"), device="cpu")
    broken = [dict(r) for r in recs]
    del broken[1]["window_scale"]
    with pytest.raises(ValueError, match="window_scale"):
        port_sweep.with_savings(broken)
    with pytest.raises(KeyError, match="window_scale"):
        port_sweep.group_by(broken, "window_scale")


def test_kernel_outputs_are_float64():
    """The dtype guard at the end of ``_sweep_kernel`` holds for every
    policy set, and trips on a float32 leaf."""
    got = port_pol.evaluate_batch(port_opgen.paper_suite()[12:14],
                                  ("NPU-A",), ("Ideal",), device="cpu")
    assert got.runtime_s.dtype == np.float64
    with pytest.raises(TypeError, match="float32"):
        port_pol._assert_float64({"x": {"y": torch.zeros(2)}})
