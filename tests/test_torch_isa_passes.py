"""The port's setpm ISA, executors, compiler passes and lowering against
the reference's (``repro.core.isa`` / ``passes`` / ``lowering``).

The same programs — drawn from a seeded ``numpy.random.Generator`` once
for each package, so both get the same draws — go through both, and the
results must be equal: the executors' counters are integers and the
passes and lowering are the same host numpy arithmetic, so nothing here
has a tolerance. Mirrors ``tests/test_isa_passes.py`` and
``tests/test_event_executor.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import isa as r_isa  # noqa: E402
from repro.core import lowering as r_low  # noqa: E402
from repro.core import passes as r_passes  # noqa: E402
from repro.core.opgen import paper_suite as r_suite  # noqa: E402
from repro_torch.core import isa as p_isa  # noqa: E402
from repro_torch.core import lowering as p_low  # noqa: E402
from repro_torch.core import passes as p_passes  # noqa: E402
from repro_torch.core.opgen import paper_suite as p_suite  # noqa: E402

MACHINE = dict(n_sa=1, n_vu=2, extra_units={"dma0": "hbm", "ici0": "ici"},
               delay_keys={"sa": "sa_pe"})


def result(res) -> tuple:
    """Every counter of an ``ExecResult``."""
    return (res.cycles, res.stall_cycles, res.setpm_executed,
            res.fu_on_cycles, res.fu_gated_cycles, res.wake_events)


def instr(ins) -> tuple:
    return (ins.opcode, ins.unit, ins.latency, ins.pm_fu_type,
            ins.pm_bitmap, None if ins.pm_mode is None else ins.pm_mode.value,
            ins.pm_range)


def events(evs) -> list:
    """A sparse program as plain tuples, comparable across packages."""
    return [(c, sorted((k, instr(v)) for k, v in b.items())) for c, b in evs]


def placements(ps) -> list:
    return [(p.cycle, instr(p.instr), p.reason) for p in ps]


def random_program(isa, seed: int, n: int = 40) -> tuple[list, int]:
    """The reference tests' random sparse program (gaps, multi-cycle
    latencies, overlapping same-unit uses, setpm on every FU family),
    built from ``isa``'s own classes."""
    rng = np.random.default_rng(seed)
    evs, c = [], 0
    for _ in range(n):
        c += int(rng.choice([1, 2, 3, 7, 15, 40, 200, 900]))
        b = {}
        if rng.random() < 0.3:
            b["misc"] = isa.setpm(
                ("vu", "sa", "hbm", "ici")[int(rng.integers(4))],
                int(rng.integers(1, 4)),
                (isa.PMode.ON, isa.PMode.OFF, isa.PMode.AUTO)[
                    int(rng.integers(3))])
        for u in ("sa0", "vu0", "vu1", "dma0", "ici0"):
            if rng.random() < 0.4:
                b[u] = isa.Instr("op", u, int(rng.choice([1, 2, 5, 30, 100])))
        if b:
            evs.append((c, b))
    return evs, c + int(rng.choice([0, 5, 500]))


# ------------------------------------------------------------ executors
@pytest.mark.parametrize("hw_auto", [False, True])
@pytest.mark.parametrize("with_setpm", [False, True])
def test_fig15_executors_match_reference(hw_auto, with_setpm):
    prog_r = r_isa.fig15_program(6, with_setpm=with_setpm)
    prog_p = p_isa.fig15_program(6, with_setpm=with_setpm)
    assert [sorted((k, instr(v)) for k, v in b.items()) for b in prog_p] \
        == [sorted((k, instr(v)) for k, v in b.items()) for b in prog_r]
    kw = dict(n_sa=2, n_vu=2, hw_auto_gating=hw_auto)
    want = result(r_isa.VLIWTimeline(**kw).run(prog_r))
    assert result(p_isa.VLIWTimeline(**kw).run(prog_p)) == want
    sparse = [(i, b) for i, b in enumerate(prog_p) if b]
    assert result(p_isa.EventTimeline(**kw).run(
        sparse, horizon=len(prog_p))) == want


@pytest.mark.parametrize("seed", [0, 7, 2024])
@pytest.mark.parametrize("hw_auto", [False, True])
def test_random_sparse_programs_match_reference(seed, hw_auto):
    for trial in range(6):
        ev_r, hz = random_program(r_isa, seed * 100 + trial)
        ev_p, hz_p = random_program(p_isa, seed * 100 + trial)
        assert hz == hz_p and events(ev_p) == events(ev_r)
        kw = dict(MACHINE, hw_auto_gating=hw_auto)
        kw_r = dict(kw, initial_modes={"vu1": r_isa.PMode.ON})
        kw_p = dict(kw, initial_modes={"vu1": p_isa.PMode.ON})
        want = result(r_isa.EventTimeline(**kw_r).run(ev_r, hz))
        assert result(p_isa.EventTimeline(**kw_p).run(ev_p, hz)) == want
        assert result(p_isa.VLIWTimeline(**kw_p).run(
            p_isa.expand_events(ev_p, hz))) == want


@pytest.mark.parametrize("unit,kind", [("sa0", "sa"), ("vu0", "vu"),
                                       ("dma0", "hbm"), ("ici0", "ici")])
def test_gap_at_the_detection_window_matches_reference(unit, kind):
    kw = dict(MACHINE, n_vu=1, hw_auto_gating=True)
    win = p_isa.VLIWTimeline(**kw)._window(kind)
    assert win == r_isa.VLIWTimeline(**kw)._window(kind)
    for gap in (win - 1, win, win + 1):
        mk = [[(0, {unit: m.Instr("op", unit, 1)}),
               (1 + gap, {unit: m.Instr("op", unit, 1)})]
              for m in (r_isa, p_isa)]
        horizon = 2 + gap + 200
        want = result(r_isa.EventTimeline(**kw).run(mk[0], horizon))
        assert result(p_isa.EventTimeline(**kw).run(mk[1], horizon)) == want
        assert result(p_isa.VLIWTimeline(**kw).run(
            p_isa.expand_events(mk[1], horizon))) == want


def test_setpm_during_exposed_wake_matches_reference():
    kw = dict(n_sa=1, n_vu=1, hw_auto_gating=True)
    tl = p_isa.VLIWTimeline(**kw)
    win, delay = tl._window("vu"), tl._delay("vu")
    wake = 1 + win + 5
    for off in (0, 1, max(1, delay // 2), max(1, delay - 1), delay):
        for mode in ("on", "off", "auto"):
            got = []
            for m in (r_isa, p_isa):
                evs = m.merge_events([
                    (0, {"vu0": m.Instr("op", "vu0", 1)}),
                    (wake, {"vu0": m.Instr("op", "vu0", 1)}),
                    (wake + off, {"misc": m.setpm("vu", 1, m.PMode(mode))})])
                got.append(result(m.EventTimeline(**kw).run(
                    evs, horizon=wake + delay + 50)))
            assert got[1] == got[0], (off, mode)


def test_merge_events_and_unsorted_programs():
    raws = []
    for m in (r_isa, p_isa):
        raws.append([(5, {"vu0": m.Instr("op", "vu0", 3)}),
                     (2, {"sa0": m.Instr("op", "sa0", 1)}),
                     (5, {"vu0": m.Instr("op", "vu0", 7),
                          "misc": m.setpm("vu", 1, m.PMode.OFF)}),
                     (5, {"misc": m.setpm("vu", 1, m.PMode.ON)})])
    merged = [events(m.merge_events(raw)) for m, raw in zip((r_isa, p_isa),
                                                            raws)]
    assert merged[1] == merged[0]
    with pytest.raises(ValueError):
        p_isa.EventTimeline(n_sa=1, n_vu=1).run(
            sorted(raws[1], key=lambda e: e[0]))
    for name in ("vu0", "sa12", "dma0", "dma", "ici"):
        assert p_isa.unit_index(name) == r_isa.unit_index(name)
    for key in ("sa_full", "sa_pe", "vu", "hbm", "ici"):
        for d, w in ((1.0, 1.0), (0.25, 1.0), (4.0, 0.5), (2.0, 3.0)):
            g_r = r_isa.get_npu("NPU-B").gating
            g_p = p_isa.get_npu("NPU-B").gating
            assert p_isa.scaled_delay(g_p, key, d) \
                == r_isa.scaled_delay(g_r, key, d)
            assert p_isa.scaled_window(g_p, key, d, w) \
                == r_isa.scaled_window(g_r, key, d, w)


@pytest.mark.parametrize("wl_idx", [0, 8, 15])  # train, decode, diffusion
def test_lowered_programs_match_reference(wl_idx):
    """Lowering, instrumentation, the merged event list and its columnar
    form equal the reference's; executed (schedule-compressed, so the
    cycle-stepper stays steppable) they give the same counters."""
    progs = [m.rescale_program(m.lower_workload(s()[wl_idx], "NPU-D"),
                               200_000)
             for m, s in ((r_low, r_suite), (p_low, p_suite))]
    plc = [m.instrument_program(p) for m, p in zip((r_low, p_low), progs)]
    assert placements(plc[1]) == placements(plc[0])
    evs = [m.build_events(p, q) for m, p, q in zip((r_low, p_low), progs,
                                                    plc)]
    assert events(evs[1]) == events(evs[0]) and len(evs[0]) > 50
    units = ("sa0", "vu0", "dma0", "ici0")
    cols = [m.events_to_arrays(e, units) for m, e in zip((r_isa, p_isa), evs)]
    for k in ("cycle", "lat", "pm"):
        assert cols[1][k].dtype == cols[0][k].dtype
        assert np.array_equal(cols[1][k], cols[0][k]), k
    hz = progs[0].horizon
    want = result(r_isa.EventTimeline(
        npu="NPU-D", **r_low.REGATE_FULL_TIMELINE).run(evs[0], horizon=hz))
    kw = dict(npu="NPU-D", **p_low.REGATE_FULL_TIMELINE)
    assert result(p_isa.EventTimeline(**kw).run(evs[1], horizon=hz)) == want
    if wl_idx == 8:
        assert result(p_isa.VLIWTimeline(**kw).run(
            p_isa.expand_events(evs[1], hz))) == want


def test_range_setpm_has_no_timeline_unit():
    ev = [(0, {"misc": p_isa.setpm("sram", 0, p_isa.PMode.OFF, (0, 4096))})]
    with pytest.raises(ValueError):
        p_isa.events_to_arrays(ev, ("sa0", "vu0"))


# ---------------------------------------------------------------- passes
def _random_uses(passes, seed: int):
    rng = np.random.default_rng(seed)
    uses = [passes.SlotUse(int(c), f"vu{int(u)}", "op", int(d))
            for c, u, d in zip(rng.integers(0, 5000, 60),
                               rng.integers(0, 3, 60),
                               rng.integers(1, 40, 60))]
    return uses, sorted(int(x) for x in rng.integers(0, 5000, 5))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("delay_scale", [0.25, 1.0, 4.0])
def test_vu_passes_match_reference(seed, delay_scale):
    got = []
    for m in (r_passes, p_passes):
        uses, dma = _random_uses(m, seed)
        idle = m.analyze_vu_idleness(uses, dma_cycles=dma, horizon=6000,
                                     include_leading=bool(seed % 2))
        got.append((
            {u: [(iv.unit, iv.start, iv.end, iv.unbounded) for iv in ivs]
             for u, ivs in idle.items()},
            placements(m.instrument_setpm(idle, "NPU-D",
                                          delay_scale=delay_scale)),
            placements(m.instrument_setpm(idle, "NPU-B", fu_type="vu",
                                          bet_key="ici", delay_key="ici",
                                          delay_scale=delay_scale))))
    assert got[1] == got[0]


def test_should_gate_matches_reference():
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 2000, 400).astype(np.float64)
    for bet, delay in ((100, 10), (50, 50), (0, 0), (7, 300)):
        assert np.array_equal(p_passes.should_gate(lengths, bet, delay),
                              r_passes.should_gate(lengths, bet, delay))
        for x in (bet - 1, bet, bet + 1, 2 * delay, 2 * delay + 1):
            assert p_passes.should_gate(x, bet, delay) \
                == r_passes.should_gate(x, bet, delay)


@pytest.mark.parametrize("seed", [0, 5])
def test_sram_passes_match_reference(seed):
    got = []
    for m in (r_passes, p_passes):
        rng = np.random.default_rng(seed)
        bufs = [m.BufferLifetime(int(s), int(s + d), int(a), int(z))
                for s, d, a, z in zip(rng.integers(0, 50_000, 40),
                                      rng.integers(1, 4000, 40),
                                      rng.integers(0, 60, 40) * 4096,
                                      rng.integers(1, 5, 40) * 4096)]
        seg = m.analyze_sram_lifetimes(bufs, 64 * 4096, horizon=60_000)
        got.append((seg, placements(m.sram_setpm_plan(seg, 60_000,
                                                      "NPU-C"))))
    assert got[1] == got[0]


# -------------------------------------------------------------- lowering
@pytest.mark.parametrize("wl_idx,npu", [(2, "NPU-A"), (9, "NPU-D"),
                                        (12, "NPU-E"), (16, "NPU-B")])
def test_lowering_and_crossval_match_reference(wl_idx, npu):
    progs = [m.lower_workload(s()[wl_idx], npu)
             for m, s in ((r_low, r_suite), (p_low, p_suite))]
    a, b = progs
    assert (b.horizon, b.workload) == (a.horizon, a.workload)
    assert {u: [(s.cycle, s.unit, s.opcode, s.duration) for s in us]
            for u, us in b.uses.items()} \
        == {u: [(s.cycle, s.unit, s.opcode, s.duration) for s in us]
            for u, us in a.uses.items()}
    for k in ("op_start", "op_end", "inst_op", "demand"):
        assert np.array_equal(getattr(b, k), getattr(a, k)), k
    for dsc in (0.5, 2.0):
        assert p_low.sram_band_gating(b, delay_scale=dsc) \
            == r_low.sram_band_gating(a, delay_scale=dsc)
    kn = [m.PolicyKnobs(delay_scale=2.0, window_scale=0.5)
          for m in (r_low, p_low)]
    assert p_low.crossval_record(p_suite()[wl_idx], npu, kn[1], 3) \
        == r_low.crossval_record(r_suite()[wl_idx], npu, kn[0], 3)


def test_execute_program_event_and_stepper_agree():
    """The whole pipeline on a compressed program: the port's event
    executor and its cycle-stepper agree with each other and with the
    reference."""
    prog = p_low.rescale_program(p_low.lower_workload(p_suite()[8], "NPU-D"),
                                 150_000)
    a = p_low.execute_program(prog)
    b = p_low.execute_program(prog, use_reference=True)
    ref = r_low.execute_program(r_low.rescale_program(
        r_low.lower_workload(r_suite()[8], "NPU-D"), 150_000))
    for s in (a, b):
        assert (s.cycles, s.stall_cycles, s.n_events) \
            == (ref.cycles, ref.stall_cycles, ref.n_events)
        assert s.setpm_isa == ref.setpm_isa
        assert s.gated_cycles == ref.gated_cycles
        assert s.wake_events == ref.wake_events
