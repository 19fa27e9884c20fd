"""Host side of the port's slice against the reference, array for array.

Trace building, stacking and gap indexing stay numpy in the port, so
they must equal the reference's output *exactly*: ``compile_trace`` /
``stack_traces`` columns on the paper suite, ``gap_index`` on its
activity patterns, the kernel's host input tree, the NPU tables, the
power model, and the knob dedup.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_cfg  # noqa: E402
from repro.core import backend as ref_backend  # noqa: E402
from repro.core import hw as ref_hw  # noqa: E402
from repro.core import opgen as ref_opgen  # noqa: E402
from repro.core import policies as ref_pol  # noqa: E402
from repro.core import power as ref_power  # noqa: E402
from repro_torch.configs import base as port_cfg  # noqa: E402
from repro_torch.core import backend as port_backend  # noqa: E402
from repro_torch.core import hw as port_hw  # noqa: E402
from repro_torch.core import opgen as port_opgen  # noqa: E402
from repro_torch.core import policies as port_pol  # noqa: E402
from repro_torch.core import power as port_power  # noqa: E402

from _torch_parity import (MM_COLUMNS, STACK_COLUMNS,  # noqa: E402
                           build_workloads, random_ops)

TRACE_COLUMNS = STACK_COLUMNS + MM_COLUMNS
N_SUITE = 17


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and np.array_equal(a, b)


@pytest.mark.parametrize("i", range(N_SUITE))
def test_compile_trace_columns_equal(i):
    rw, pw = ref_opgen.paper_suite()[i], port_opgen.paper_suite()[i]
    assert (rw.name, rw.kind, rw.n_chips) == (pw.name, pw.kind, pw.n_chips)
    rt, pt = ref_opgen.compile_trace(rw), port_opgen.compile_trace(pw)
    assert rt.n_ops == pt.n_ops and rt.names == pt.names
    for col in TRACE_COLUMNS:
        assert _same(getattr(rt, col), getattr(pt, col)), (rw.name, col)


def test_paper_suite_is_the_sized_stack():
    st = port_opgen.stack_traces(port_opgen.paper_suite())
    assert st.n_segments == N_SUITE
    assert st.n_ops == 11191
    assert int((st.flops_sa > 0).sum()) > 5000
    assert port_opgen.paper_suite()[0] is port_opgen.paper_suite()[0]


def test_stack_traces_columns_equal():
    rs = ref_opgen.stack_traces(ref_opgen.paper_suite())
    ps = port_opgen.stack_traces(port_opgen.paper_suite())
    assert rs.names == ps.names and rs.n_ops == ps.n_ops
    assert _same(rs.offsets, ps.offsets) and _same(rs.seg_ids, ps.seg_ids)
    for col in STACK_COLUMNS:
        assert _same(getattr(rs, col), getattr(ps, col)), col
    # stacking is cached by trace identity
    assert port_opgen.stack_traces(port_opgen.paper_suite()) is ps


@pytest.mark.parametrize("comp,col", [("sa", "flops_sa"), ("vu", "flops_vu"),
                                      ("hbm", "bytes_hbm"),
                                      ("ici", "bytes_ici")])
def test_gap_index_equal_on_paper_suite(comp, col):
    rs = ref_opgen.stack_traces(ref_opgen.paper_suite())
    active = getattr(rs, col) > 0
    want = ref_backend.gap_index(active, rs.offsets)
    got = port_backend.gap_index(active, rs.offsets)
    assert _same(want[0], got[0]) and _same(want[1], got[1])
    ps = port_opgen.stack_traces(port_opgen.paper_suite())
    cached = port_pol._gap_indices(ps)[comp]
    assert _same(want[0], cached[0]) and _same(want[1], cached[1])


@pytest.mark.parametrize("seed", [17, 18, 19])
def test_ragged_stack_with_empty_segments(seed):
    """Randomized ragged stacks with leading / consecutive / trailing
    zero-op workloads: offsets, ids, gap index and ``segmented_gaps``."""
    rng = np.random.default_rng(seed)
    sizes = [0, int(rng.integers(1, 30)), 0, 0, int(rng.integers(1, 30)),
             1, 0]
    specs = [(f"w{i}", random_ops(rng, n)) for i, n in enumerate(sizes)]
    rs = ref_opgen.stack_traces(build_workloads(ref_opgen, specs))
    ps = port_opgen.stack_traces(build_workloads(port_opgen, specs))
    assert ps.offsets.tolist() == rs.offsets.tolist()
    assert _same(rs.seg_ids, ps.seg_ids)
    for col in STACK_COLUMNS:
        assert _same(getattr(rs, col), getattr(ps, col)), col
    active = ps.flops_vu > 0
    idle = np.where(active, 0.0, ps.count * 1e-3)
    for a, b in zip(ref_opgen.segmented_gaps(active, idle, rs.offsets),
                    port_opgen.segmented_gaps(active, idle, ps.offsets)):
        assert _same(a, b)
    for a, b in zip(ref_backend.gap_index(active, rs.offsets),
                    port_backend.gap_index(active, ps.offsets)):
        assert _same(a, b)
    seg = port_opgen.segment_sum(idle, ps.offsets)
    assert _same(ref_opgen.segment_sum(idle, rs.offsets), seg)
    # the fixed-shape index reproduces the ragged gaps
    chunk, gseg = port_backend.gap_index(active, ps.offsets)
    gv, _ = port_opgen.segmented_gaps(active, idle, ps.offsets)
    np.testing.assert_allclose(  # reduceat adds in another order
        np.bincount(chunk, weights=idle, minlength=len(gseg)), gv,
        rtol=1e-12, atol=0)


def test_empty_and_no_workload_stacks():
    empty = port_opgen.Workload("e", "prefill", ())
    st = port_opgen.stack_traces([empty, port_opgen.paper_suite()[8], empty])
    n1 = port_opgen.compile_trace(port_opgen.paper_suite()[8]).n_ops
    assert st.offsets.tolist() == [0, 0, n1, n1]
    assert (st.seg_ids == 1).all()
    st0 = port_opgen.stack_traces([])
    assert st0.n_segments == 0 and st0.n_ops == 0
    assert st0.offsets.tolist() == [0]
    with pytest.raises(ValueError, match="Workload"):
        port_opgen.stack_traces(["nope"])


@pytest.mark.parametrize("field,value,match", [
    ("flops_sa", -1.0, "negative"), ("bytes_hbm", float("nan"),
                                     "non-finite"),
    ("count", -2, "negative"), ("matmul_dims", (0, 4, 4), "matmul_dims")])
def test_validate_trace_rejects_what_the_reference_rejects(field, value,
                                                           match):
    kw = dict(name="bad", flops_sa=1e9, matmul_dims=(8, 8, 8))
    kw[field] = value
    for mod in (ref_opgen, port_opgen):
        wl = mod.Workload("w", "prefill", (mod.Op(**kw),))
        with pytest.raises(ValueError, match=match):
            mod.compile_trace(wl)


@pytest.mark.parametrize("name", sorted(ref_hw.NPUS))
def test_npu_tables_and_power_model_equal(name):
    r, p = ref_hw.NPUS[name], port_hw.NPUS[name]
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    for prop in ("freq_hz", "sa_flops", "vu_flops", "hbm_bw", "ici_bw",
                 "sram_bytes", "sram_segments"):
        assert getattr(r, prop) == getattr(p, prop), prop
    rp, pp = ref_power.PowerModel(r), port_power.PowerModel(p)
    assert rp.static_w == pp.static_w and rp.dyn_max_w == pp.dyn_max_w
    assert rp.idle_chip_gated_w() == pp.idle_chip_gated_w()
    assert port_hw.get_npu(name[-1].lower()) is p
    wide = port_hw.with_sa_width(p, 512)
    assert wide is port_hw.with_sa_width(p, 512) and wide.name == p.name
    assert wide.sa_flops == ref_hw.with_sa_width(r, 512).sa_flops
    assert port_hw.with_sa_width(p, None) is p


@pytest.mark.parametrize("name", sorted(ref_hw.NPUS))
def test_kernel_host_input_tree_equal(name):
    """``_host_columns``: every raw op column, gap index, per-NPU scalar
    and the SRAM setpm boundary counts the kernel is fed."""
    rs = ref_opgen.stack_traces(ref_opgen.paper_suite())
    ps = port_opgen.stack_traces(port_opgen.paper_suite())
    rh, r_setpm = ref_pol._host_columns(rs, ref_hw.NPUS[name])
    ph, p_setpm = port_pol._host_columns(ps, port_hw.NPUS[name])
    assert _same(r_setpm, p_setpm)
    assert set(rh["op"]) == set(ph["op"])
    for k in rh["op"]:
        assert _same(rh["op"][k], ph["op"][k]), k
    for c in rh["gap_seg"]:
        assert _same(rh["gap_seg"][c], ph["gap_seg"][c]), c
    assert rh["scal"] == ph["scal"]
    assert {c: len(ph["gap_seg"][c]) for c in ph["gap_seg"]} == {
        "sa": 5335, "vu": 8411, "hbm": 9248, "ici": 1960}


def test_knob_dedup_equal():
    kw = dict(delay_scale=(0.5, 1.0, 2.0), leak_off_logic=(None, 0.2),
              sa_width=(None, 128, 256), window_scale=(0.5, 1.0))
    rg = ref_pol.KnobGrid(**kw).product()
    pg = port_pol.KnobGrid(**kw).product()
    assert [dataclasses.asdict(k) for k in rg] \
        == [dataclasses.asdict(k) for k in pg]
    assert [ref_pol.knob_columns(k, i) for i, k in enumerate(rg)] \
        == [port_pol.knob_columns(k, i) for i, k in enumerate(pg)]
    rt, ri = ref_pol.knob_pairs(rg)
    pt, pi = port_pol.knob_pairs(pg)
    assert rt == pt and np.array_equal(ri, pi)
    bk = port_backend.get_backend("cpu")
    for npu in ("NPU-D", "NPU-E"):  # native width 128 / 256 collapses
        ra = ref_pol._knob_arrays(rg, ref_hw.NPUS[npu],
                                  ref_backend.get_backend("numpy"))
        pa = port_pol._knob_arrays(pg, port_hw.NPUS[npu], bk)
        assert set(ra) == set(pa)
        for k in ra:
            assert _same(np.asarray(ra[k]), pa[k].numpy()), k
        assert pa["saw_unique"].shape[0] == 2


def _arch(mod, **kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=256,
                n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=1000,
                head_dim=64)
    base.update(kw)
    return mod.ArchConfig(**base)


@pytest.mark.parametrize("family", ["dense", "moe", "ssm"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_arch_workload_equal(family, kind, monkeypatch):
    """``arch_workload`` op for op. Both packages size a training
    shape's closing ops with their own model registry's parameter
    counter; each counter is pinned to the same number here, so the
    comparison is of the op generator alone (the counters are compared
    in ``test_torch_model.py``)."""
    n_params = 123_456_789

    def cfg(mod):
        extra = {}
        if family == "moe":
            extra["moe"] = mod.MoEConfig(n_experts=4, top_k=2,
                                         d_ff_expert=128)
        if family == "ssm":
            extra["ssm"] = mod.SSMConfig(d_state=16, head_dim=32, chunk=64)
        return _arch(mod, family=family, **extra)

    if kind == "train":
        from repro.models import registry
        from repro_torch.models import registry as port_registry
        monkeypatch.setattr(registry, "count_params",
                            lambda cfg, active_only=False: n_params)
        monkeypatch.setattr(port_registry, "count_params",
                            lambda cfg: n_params)
    rw = ref_opgen.arch_workload(
        cfg(ref_cfg), ref_cfg.ShapeConfig("s", 512, 64, kind), n_chips=16,
        tp=4)
    pw = port_opgen.arch_workload(
        cfg(port_cfg), port_cfg.ShapeConfig("s", 512, 64, kind), n_chips=16,
        tp=4)
    assert rw.name == pw.name and len(rw.ops) == len(pw.ops)
    for a, b in zip(rw.ops, pw.ops):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


PORTED_ARCHS = ("qwen2.5-3b", "mamba2-780m", "qwen3-32b")
# every arch: each one's parameters are counted (and MoE / MLA's
# forwards, which wait, are not needed to size a workload)
ALL_ARCHS = tuple(sorted(ref_cfg.list_archs()))


@pytest.mark.parametrize("shape", sorted(ref_cfg.SHAPES))
@pytest.mark.parametrize("arch", PORTED_ARCHS + tuple(
    a for a in ALL_ARCHS if a not in PORTED_ARCHS))
def test_arch_workload_of_published_archs_equal(arch, shape):
    """Every arch x shape cell (40), training included, with each package
    counting the parameters itself: the same ops, op for op."""
    rw = ref_opgen.arch_workload(ref_cfg.get_arch(arch),
                                 ref_cfg.SHAPES[shape])
    pw = port_opgen.arch_workload(port_cfg.get_arch(arch),
                                  port_cfg.SHAPES[shape])
    assert rw.name == pw.name and rw.kind == pw.kind
    assert len(rw.ops) == len(pw.ops) > 0
    for a, b in zip(rw.ops, pw.ops):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_arch_workload_train_4k_of_qwen2_5_3b():
    w = port_opgen.arch_workload(port_cfg.get_arch("qwen2.5-3b"),
                                 port_cfg.SHAPES["train_4k"])
    assert len(w.ops) == 255 and w.kind == "train"


def test_shapes_equal():
    from repro_torch.configs import SHAPES
    assert SHAPES is port_cfg.SHAPES
    assert {k: dataclasses.asdict(v) for k, v in ref_cfg.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
    for k, v in SHAPES.items():
        assert v.is_decode == ref_cfg.SHAPES[k].is_decode
    assert [k for k, v in SHAPES.items() if v.is_decode] \
        == ["decode_32k", "long_500k"]


@pytest.mark.parametrize("arch", PORTED_ARCHS + tuple(
    a for a in ALL_ARCHS if a not in PORTED_ARCHS))
def test_param_count_and_supported_shapes_equal(arch):
    ref, port = ref_cfg.get_arch(arch), port_cfg.get_arch(arch)
    assert port.param_count() == ref.param_count()
    assert port.supported_shapes() == ref.supported_shapes()


def test_param_count_of_the_served_archs():
    assert port_cfg.get_arch("qwen2.5-3b").param_count() == 3_086_200_832
    assert port_cfg.get_arch("mamba2-780m").param_count() == 780_382_464


@pytest.mark.parametrize("arch", sorted(ref_cfg.list_archs()))
def test_supported_shapes_equal_for_every_arch(arch):
    assert port_cfg.get_arch(arch).supported_shapes() \
        == ref_cfg.get_arch(arch).supported_shapes()


def test_workload_generators_equal():
    for build in (lambda m: m.llm_workload("llama3-8b", "decode", batch=3,
                                           seq=128, tp=2, n_chips=2),
                  lambda m: m.dlrm_workload("M", batch=64),
                  lambda m: m.diffusion_workload("gligen", batch=2)):
        a, b = build(ref_opgen), build(port_opgen)
        assert a.name == b.name
        assert [dataclasses.asdict(o) for o in a.ops] \
            == [dataclasses.asdict(o) for o in b.ops]
