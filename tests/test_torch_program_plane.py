"""The port's batched program plane against the reference's.

Three layers, as in ``tests/test_program_plane_batch.py`` and
``tests/test_program_plane_crossval.py``:

1. The executor (``repro_torch.kernels.program_exec``; on the CPU its
   plain version, B7's oracle) EXACTLY equal — integers, no tolerance —
   to the reference's per-cell ``EventTimeline`` and to its batched
   kernel on ``backend="numpy"``, on 24 seeded random programs at each
   of 6 delay/window scales, and on the edge cases the vectorization
   could get wrong: empty and single-bundle programs, setpm at cycle 0,
   same-cycle setpm collisions, padded events inside a row, inert rows.
2. ``sweep_program_plane`` on ``device="cpu"`` against the reference's
   on ``backend="numpy"``, record for record in the same order: the
   executor's integers exactly, every other field within 1e-9 of
   ``max(1, |value|)`` (the reference test's own rule: the policy side
   is ``evaluate_batch``, whose float sums run in another order).
3. One small case against the reference's jax backend, in a child
   process with ``JAX_ENABLE_X64=1`` (never set in the pytest process).
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import isa as r_isa  # noqa: E402
from repro.core import program_plane as r_pp  # noqa: E402
from repro.core.backend import get_backend as r_backend  # noqa: E402
from repro.core.lowering import REGATE_FULL_TIMELINE  # noqa: E402
from repro.core.opgen import paper_suite as r_suite  # noqa: E402
from repro.core.policies import KnobGrid as RKnobGrid  # noqa: E402
from repro_torch.core import isa as p_isa  # noqa: E402
from repro_torch.core import lowering as p_low  # noqa: E402
from repro_torch.core import program_plane as p_pp  # noqa: E402
from repro_torch.core.opgen import paper_suite as p_suite  # noqa: E402
from repro_torch.core.passes import SetpmPlacement  # noqa: E402
from repro_torch.core.policies import KnobGrid  # noqa: E402
from repro_torch.core.session import SweepSession  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import program_exec as p_exec  # noqa: E402
from repro_torch.kernels.program_exec import (OUTPUTS,  # noqa: E402
                                              program_exec,
                                              program_exec_plain,
                                              program_exec_streams,
                                              program_exec_streams_plain)

from _torch_programs import pack_programs as pack  # noqa: E402
from _torch_programs import program_arrays, row_knobs  # noqa: E402
from _torch_programs import seeded_programs  # noqa: E402

r_sweep = importlib.import_module("repro.core.sweep")
p_sweep = importlib.import_module("repro_torch.core.sweep")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
UNITS = p_pp.UNITS
SCALES = [(1.0, 1.0), (0.25, 1.0), (4.0, 1.0), (1.0, 0.25), (1.0, 4.0),
          (2.0, 0.5)]
GRID = dict(delay_scale=(1.0, 4.0), window_scale=(1.0, 0.5))
EXACT = ("prog_", "n_events", "stall_", "wakes_prog", "setpm_prog")
CHILD_TIMEOUT_S = 300


def plain(data: dict) -> dict:
    out = program_exec_plain({k: torch.from_numpy(v)
                              for k, v in data.items()})
    return {k: v.numpy() for k, v in out.items()}


def assert_rows_equal(out, refs):
    """Port outputs against one reference ``ExecResult`` per row."""
    for r, res in enumerate(refs):
        assert int(out["cycles"][r]) == res.cycles, r
        assert int(out["stall_cycles"][r]) == res.stall_cycles, r
        assert int(out["setpm_executed"][r]) == res.setpm_executed, r
        for ui, unit in enumerate(UNITS):
            assert int(out["on"][r, ui]) == res.fu_on_cycles[unit], (r, unit)
            assert int(out["gated"][r, ui]) == res.fu_gated_cycles[unit], \
                (r, unit)
            assert int(out["wakes"][r, ui]) == res.wake_events[unit], \
                (r, unit)


def check_against_reference(rows_r, rows_p, horizons, scales):
    """The port's plain executor == the reference's ``EventTimeline`` per
    row == the reference's batched kernel on numpy."""
    got = plain(pack(p_pp, p_isa, rows_p, horizons, scales))
    refs = [r_isa.EventTimeline(npu="NPU-D", delay_scale=d, window_scale=w,
                                **REGATE_FULL_TIMELINE).run(ev, horizon=hz)
            for ev, hz, (d, w) in zip(rows_r, horizons, scales)]
    assert_rows_equal(got, refs)
    want = r_pp._run_kernel(pack(r_pp, r_isa, rows_r, horizons, scales),
                            r_backend("numpy"))
    assert set(want) == set(OUTPUTS)
    for k in OUTPUTS:
        assert got[k].dtype == np.int64
        assert np.array_equal(got[k], want[k]), k
    return got


# --------------------------------------------------------- the executor
@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"d{s[0]}-w{s[1]}")
def test_seeded_random_programs_match_reference_exactly(scale):
    rows_r, horizons = seeded_programs(r_isa)
    rows_p, _ = seeded_programs(p_isa)
    check_against_reference(rows_r, rows_p, horizons, [scale] * len(rows_r))


def test_empty_and_single_bundle_programs():
    def rows(isa):
        return [[], [(0, {UNITS[0]: isa.Instr("op", UNITS[0], 5)})],
                [(499, {UNITS[3]: isa.Instr("op", UNITS[3], 7)})], []]

    horizons = [700, 500, 500, 0]
    got = check_against_reference(rows(r_isa), rows(p_isa), horizons,
                                  [(1.0, 1.0)] * 4)
    # the empty row still drains the whole horizon; vu0 starts ON (sw
    # managed, never auto-gates)
    assert int(got["cycles"][0]) == 700
    assert int(got["on"][0, UNITS.index("vu0")]) == 700


def test_setpm_at_cycle_zero():
    def rows(isa):
        P = isa.PMode
        return [[(0, {"misc": isa.setpm("vu", 1, P.OFF)}),
                 (50, {"vu0": isa.Instr("op", "vu0", 10)})],
                [(0, {"misc": isa.setpm("sa", 1, P.ON)}),
                 (600, {"sa0": isa.Instr("op", "sa0", 3)})],
                [(0, {"misc": isa.setpm("vu", 1, P.AUTO)})]]

    got = check_against_reference(rows(r_isa), rows(p_isa), [900] * 3,
                                  [(1.0, 1.0)] * 3)
    assert int(got["wakes"][0, UNITS.index("vu0")]) == 1
    assert int(got["gated"][2, UNITS.index("vu0")]) > 0


def test_same_cycle_setpm_collisions_merge_and_slip():
    """Colliding placements ride ``build_events``: the same (fu_type,
    mode) merges bitmaps, an opposite mode slips one cycle."""
    def events(low, isa, suite, placement_cls):
        prog = low.lower_workload(suite()[0], "NPU-D")
        base = low.instrument_program(prog)
        first = base[0].instr
        flip = isa.PMode.ON if first.pm_mode == isa.PMode.OFF \
            else isa.PMode.OFF
        extra = [placement_cls(base[0].cycle, first, "dup (merge)"),
                 placement_cls(base[0].cycle, isa.setpm("vu", 1, flip),
                               "slip")]
        return low.build_events(prog, list(base) + extra), prog.horizon

    from repro.core import lowering as r_low
    from repro.core.passes import SetpmPlacement as RSetpmPlacement
    ev_r, hz = events(r_low, r_isa, r_suite, RSetpmPlacement)
    ev_p, _ = events(p_low, p_isa, p_suite, SetpmPlacement)
    cycles = [c for c, _ in ev_p]
    assert len(cycles) == len(set(cycles))
    check_against_reference([ev_r], [ev_p], [hz], [(1.0, 1.0)])


def test_padding_events_and_inert_rows_change_nothing():
    """``cycle = -1`` is a no-op wherever it stands — inside a row too,
    where the kernel's row extent does not stop — and an inert row
    (horizon 0, no events) reads all zeros."""
    rows, horizons = seeded_programs(p_isa, seed=3, n=6)
    data = pack(p_pp, p_isa, rows, horizons, SCALES)
    want = plain(data)
    padded = dict(data)
    for k in ("cycle", "lat", "pm"):
        v = data[k]
        hole = np.full((3,) + v.shape[1:], -1 if k == "cycle" else 7,
                       v.dtype)
        padded[k] = np.concatenate([v[:4], hole, v[4:], hole])
    inert = {k: np.concatenate(
        [v, np.full((v.shape[0], 2) + v.shape[2:], -1 if k == "cycle"
                    else 0, v.dtype)], axis=1)
        if k in ("cycle", "lat", "pm") else
        np.concatenate([v, np.zeros((2,) + v.shape[1:], v.dtype)])
        for k, v in padded.items()}
    got = plain(inert)
    for k in OUTPUTS:
        assert np.array_equal(got[k][:6], want[k]), k
        assert not got[k][6:].any(), k


def test_cpu_tensors_run_the_plain_version():
    rows, horizons = seeded_programs(p_isa, seed=4, n=5)
    data = {k: torch.from_numpy(v)
            for k, v in pack(p_pp, p_isa, rows, horizons, SCALES[:5]).items()}
    before, libs = program_exec.launches, dict(_build._LIBS)
    got, want = program_exec(data), program_exec_plain(data)
    for k in OUTPUTS:
        assert torch.equal(got[k], want[k]), k
    assert program_exec.launches == before and _build._LIBS == libs


def test_program_exec_rejects_malformed_stacks():
    rows, horizons = seeded_programs(p_isa, seed=5, n=2)
    data = {k: torch.from_numpy(v)
            for k, v in pack(p_pp, p_isa, rows, horizons, SCALES[:2]).items()}
    for key, bad in (("pm", data["pm"].to(torch.int64)),
                     ("lat", data["lat"][:, :1]),
                     ("horizon", data["horizon"].to(torch.int32))):
        with pytest.raises(ValueError):
            program_exec(dict(data, **{key: bad}))
    with pytest.raises(ValueError):
        program_exec({k: v for k, v in data.items() if k != "mode0"})


# ------------------------------------------------- the ragged stream entry
def stream_case(make, stream_of_row, scales):
    """Ragged streams of the programs ``make(isa)`` builds (with their
    horizons) in both packages, row ``r`` on stream ``stream_of_row[r]``
    at ``scales[r]``: the port's ``ProgramArrays``, its stream-entry
    arguments on the CPU and the reference's dense stack."""
    rows_p, horizons = make(p_isa)
    rows_r, _ = make(r_isa)
    pa_p = program_arrays(p_pp, p_isa, rows_p, horizons)
    pa_r = program_arrays(r_pp, r_isa, rows_r, horizons)
    sor = np.asarray(stream_of_row, np.int64)
    delay, window = row_knobs(p_pp, p_isa, scales)
    hz = np.asarray(horizons, np.int64)[sor]
    args = p_pp._upload_streams(pa_p, sor, window, delay, hz, "cpu")
    dense_r = r_pp._pack_dense(pa_r, sor, window, delay, hz)
    return pa_p, args, dense_r


def assert_stream_entry_exact(make, stream_of_row, scales):
    """The stream entry on the CPU == its plain version == the dense
    plain version on the port's ``_pack_dense`` == the reference's
    numpy kernel on its own packing; and ``pack_streams`` is
    ``_pack_dense``'s layout exactly."""
    pa_p, args, dense_r = stream_case(make, stream_of_row, scales)
    got = program_exec_streams(*args)
    sor, window, delay, hz = (args[1].numpy(), args[2]["window"].numpy(),
                              args[2]["delay"].numpy(),
                              args[2]["horizon"].numpy())
    dense_p = p_pp._pack_dense(pa_p, sor, window, delay, hz)
    packed = p_exec.pack_streams(*args)
    for k, v in dense_p.items():
        assert np.array_equal(packed[k].numpy(), v), k
    plain_dense = plain(dense_p)
    ref = r_pp._run_kernel(dense_r, r_backend("numpy"))
    via_plain = program_exec_streams_plain(*args)
    for k in OUTPUTS:
        assert got[k].dtype == torch.int64
        assert torch.equal(got[k], via_plain[k]), k
        assert np.array_equal(got[k].numpy(), plain_dense[k]), k
        assert np.array_equal(got[k].numpy(), ref[k]), k
    return got


@pytest.mark.parametrize("scale", SCALES, ids=lambda s: f"d{s[0]}-w{s[1]}")
def test_stream_entry_equals_dense_and_reference(scale):
    assert_stream_entry_exact(seeded_programs, np.arange(24), [scale] * 24)


@pytest.mark.parametrize("share", [1, 3, 9])
def test_stream_entry_rows_share_streams_unsorted(share):
    """Each of 8 streams run by ``share`` rows at different scales, the
    rows shuffled; with an empty stream among them."""
    def make(isa):
        rows, horizons = seeded_programs(isa, seed=30 + share, n=8)
        rows[5] = []
        return rows, horizons

    sor = np.random.default_rng(share).permutation(
        np.repeat(np.arange(8), share))
    scales = [SCALES[i % len(SCALES)] for i in range(len(sor))]
    got = assert_stream_entry_exact(make, sor, scales)
    horizons = make(p_isa)[1]
    # the empty stream's rows still drain their horizon
    r5 = np.flatnonzero(sor == 5)
    assert (got["cycles"].numpy()[r5] == horizons[5]).all()


def test_stream_entry_padding_inside_and_unaligned_starts():
    """Streams of 1, 2, 3, 5, 6 and 7 events put every stream's start at
    another offset modulo 4; ``cycle = -1`` events inside a stream (lat
    and pm 7) and an unused stream change nothing."""
    def make(isa):
        return seeded_programs(isa, seed=40, n=7,
                               n_events=[1, 2, 3, 5, 6, 7, 130])

    _, args, _ = stream_case(make, [6, 0, 1, 2, 3, 4, 5, 6],
                             SCALES + SCALES[:2])
    starts = args[0]["offsets"][:-1].numpy()
    assert set(starts % 4) == {0, 1, 2, 3}
    want = program_exec_streams(*args)
    streams = dict(args[0])
    off = streams["offsets"]
    cyc, lat, pm = (streams[k].clone() for k in ("cycle", "lat", "pm"))
    holes = torch.tensor([int(off[6]) + 4, int(off[6]) + 60])
    parts = {"cycle": [], "lat": [], "pm": []}
    new_off = [0]
    for si in range(len(off) - 1):
        lo, hi = int(off[si]), int(off[si + 1])
        for k, col, fill in (("cycle", cyc, -1), ("lat", lat, 7),
                             ("pm", pm, 7)):
            seg = col[lo:hi]
            if si == 6:  # two holes inside the long stream
                at = (holes - lo).tolist()
                hole = torch.full((1,) + seg.shape[1:], fill, dtype=seg.dtype)
                seg = torch.cat([seg[:at[0]], hole, seg[at[0]:at[1]], hole,
                                 seg[at[1]:]])
            parts[k].append(seg)
        new_off.append(new_off[-1] + len(parts["cycle"][-1]))
    padded = {k: torch.cat(v) for k, v in parts.items()}
    padded["offsets"] = torch.tensor(new_off, dtype=torch.int64)
    got = program_exec_streams(padded, args[1], args[2])
    for k in OUTPUTS:
        assert torch.equal(got[k], want[k]), k


def test_dense_stack_as_streams_is_the_same_program():
    """``program_exec``'s card route turns a dense stack into one stream
    a row cut at its last real event; on the CPU that form gives the
    dense plain version's results, inert and padded rows too."""
    rows, horizons = seeded_programs(p_isa, seed=3, n=6)
    rows.append([])
    data = {k: torch.from_numpy(v) for k, v in
            pack(p_pp, p_isa, rows, horizons + [0], SCALES + SCALES[:1])
            .items()}
    data["cycle"][2, 1] = -1  # a hole inside a row
    streams, sor, rws = p_exec._dense_as_streams(data)
    assert int(streams["offsets"][-1]) == int(
        p_exec.row_extent(data["cycle"]).sum())
    got = program_exec_streams(streams, sor, rws)
    want = program_exec_plain(data)
    for k in OUTPUTS:
        assert torch.equal(got[k], want[k]), k


def test_program_exec_streams_rejects_malformed_input():
    _, (streams, sor, rws), _ = stream_case(
        lambda isa: seeded_programs(isa, seed=5, n=3), [0, 1, 2, 1],
        SCALES[:4])
    for bad in (dict(streams, pm=streams["pm"].to(torch.int64)),
                dict(streams, offsets=streams["offsets"].flip(0)),
                dict(streams, offsets=streams["offsets"] + 1)):
        with pytest.raises(ValueError):
            program_exec_streams(bad, sor, rws)
    with pytest.raises(ValueError):
        program_exec_streams(streams, sor + 3, rws)
    with pytest.raises(ValueError):
        program_exec_streams(streams, sor[:3], rws)


def test_card_path_ragged_call_equals_cpu_dense_call(monkeypatch):
    """``program_plane_batch``'s card route (``_run_streams``: the
    ragged stack through the stream entry) and its CPU route
    (``_run_dense``: ``_pack_dense`` through the dense entry) give the
    same batch, both run here on the CPU."""
    wls = p_suite()[10:13]
    knobs = KnobGrid(delay_scale=(1.0, 4.0),
                     window_scale=(0.5, 1.0, 2.0)).product()
    dense = p_pp.program_plane_batch(wls, ("NPU-B", "NPU-D"), knobs,
                                     device="cpu")
    calls = []

    def card_route(*a):
        calls.append(a[0].n_streams)
        return run_streams(*a)

    run_streams = p_pp._run_streams
    monkeypatch.setattr(p_pp, "_run_dense", card_route)
    got = p_pp.program_plane_batch(wls, ("NPU-B", "NPU-D"), knobs,
                                   device="cpu")
    # 3 workloads x 2 NPUs x 2 delay scales, each stream run by 3 rows
    assert calls == [12]
    for f in ("cycles", "stall_cycles", "n_events"):
        assert np.array_equal(getattr(got, f), getattr(dense, f)), f
    for f in ("gated_cycles", "wake_events", "setpm_isa"):
        a, b = getattr(got, f), getattr(dense, f)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), (f, k)
    assert got.records() == dense.records()


# ------------------------------------------------------------ the sweep
def assert_records_match(got, ref, tol=1e-9):
    assert len(got) == len(ref)
    for x, y in zip(ref, got):
        assert set(x) == set(y)
        for k in x:
            a, b = x[k], y[k]
            if a is None or isinstance(a, str):
                assert a == b, (k, a, b)
            elif k.startswith(EXACT):
                assert float(a) == float(b), (k, a, b)
            else:
                assert abs(float(a) - float(b)) \
                    <= tol * max(1.0, abs(float(a))), (k, a, b)


@pytest.mark.parametrize("npus", [("NPU-B", "NPU-D"), ("NPU-A", "NPU-E")])
def test_sweep_matches_reference_numpy_backend(npus):
    got = p_sweep.sweep_program_plane(p_suite()[:4], npus=npus,
                                      knob_grid=KnobGrid(**GRID),
                                      device="cpu")
    ref = r_sweep.sweep_program_plane(r_suite()[:4], npus=npus,
                                      knob_grid=RKnobGrid(**GRID),
                                      backend="numpy")
    assert len(got) == 4 * len(npus) * 4
    assert_records_match(got, ref)


def test_sweep_on_the_paper_suite_matches_reference():
    """Every workload of the paper suite at the default knob point; and
    the port's per-cell oracle equal to the reference's (the same host
    code: no tolerance) and to its own batched records."""
    got = p_sweep.sweep_program_plane(p_suite(), npus=("NPU-C",),
                                      device="cpu")
    ref = r_sweep.sweep_program_plane(r_suite(), npus=("NPU-C",),
                                      backend="numpy")
    assert_records_match(got, ref)
    idx = [0, 12, 16]
    oracle = p_sweep.sweep_program_plane_reference(
        [p_suite()[i] for i in idx], npus=("NPU-C",))
    assert_records_match(oracle, r_sweep.sweep_program_plane_reference(
        [r_suite()[i] for i in idx], npus=("NPU-C",)), tol=0.0)
    assert_records_match(oracle, [got[i] for i in idx])


def test_records_are_first_class_sweep_records():
    recs = p_sweep.sweep_program_plane(p_suite()[12:14], npus=("NPU-D",),
                                       knob_grid=KnobGrid(**GRID),
                                       device="cpu")
    need = ("knob_idx",) + KnobGrid.columns()
    assert all(k in r for r in recs for k in need)
    assert all(r["savings"] is None for r in p_sweep.with_savings(recs))
    groups = p_sweep.group_by(recs, "npu", "delay_scale", "window_scale")
    assert len(groups) == 4
    assert sum(len(v) for v in groups.values()) == len(recs)


def test_device_resolves_through_the_session():
    wls = p_suite()[12:13]
    with SweepSession(device="cpu"):
        a = p_sweep.sweep_program_plane(wls)
    assert_records_match(a, p_sweep.sweep_program_plane(wls, device="cpu"),
                         tol=0.0)
    if torch.cuda.is_available():
        return  # the card is there: "cuda" is a valid device
    with pytest.raises(RuntimeError):
        p_sweep.sweep_program_plane(wls, device="cuda")


# ------------------------------------------------ the reference's jax path
CHILD = r"""
import importlib, sys
import numpy as np
import jax
assert jax.config.jax_enable_x64
from repro.core.backend import get_backend
from repro.core.opgen import paper_suite
from repro.core.policies import KnobGrid
from repro.core.program_plane import _run_kernel
inp = np.load(sys.argv[1])
data = {k[5:]: inp[k] for k in inp.files if k.startswith("data|")}
out = {f"kernel|{k}": v for k, v in _run_kernel(data, get_backend("jax")).items()}
sweep = importlib.import_module("repro.core.sweep")
recs = sweep.sweep_program_plane(paper_suite()[12:14], npus=("NPU-D",),
    knob_grid=KnobGrid(delay_scale=(1.0, 4.0), window_scale=(1.0, 0.5)),
    backend="jax")
fields = sorted(k for k, v in recs[0].items() if isinstance(v, (int, float))
                and not isinstance(v, bool) and v is not None)
out["fields"] = np.array(fields)
out["values"] = np.array([[float(r[f]) for f in fields] for r in recs])
np.savez(sys.argv[2], **out)
"""


def test_matches_the_reference_jax_backend(tmp_path):
    pytest.importorskip("jax")
    rows, horizons = seeded_programs(p_isa, seed=77, n=6)
    rows.append([])
    horizons.append(1234)
    data = pack(p_pp, p_isa, rows, horizons, SCALES + [(1.0, 1.0)])
    np.savez(tmp_path / "in.npz", **{f"data|{k}": v for k, v in data.items()})
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [SRC] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = np.load(tmp_path / "out.npz")
    got = plain(data)
    for k in OUTPUTS:
        assert np.array_equal(got[k], out[f"kernel|{k}"]), k
    recs = p_sweep.sweep_program_plane(p_suite()[12:14], npus=("NPU-D",),
                                       knob_grid=KnobGrid(**GRID),
                                       device="cpu")
    fields = out["fields"].tolist()
    assert "prog_cycles" in fields and "policy_cycles" in fields
    ref = [dict(zip(fields, (float(x) for x in row)))
           for row in out["values"]]
    assert_records_match([{f: float(r[f]) for f in fields} for r in recs],
                         ref)
