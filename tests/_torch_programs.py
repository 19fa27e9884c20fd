"""Random sparse programs for the program plane's executor tests
(``tests/test_torch_program_plane.py``, ``tests/test_torch_gpu.py``).

Each helper takes the ISA / program-plane module of the package it
should build with, so the same seed gives the same program in the
reference and in the port; the module itself imports neither.
"""
import numpy as np

PP_UNITS = ("sa0", "vu0", "dma0", "ici0")   # the program plane's machine
PP_KINDS = ("sa", "vu", "hbm", "ici")


def random_events(isa, rng: np.random.Generator, n_events: int,
                  horizon: int) -> list:
    """A random sparse program on the program plane's units (every unit,
    setpm of every mode on every FU family), built from ``isa``'s own
    classes: the same draws give the same program in either package."""
    cycles = np.sort(rng.choice(horizon, size=n_events, replace=False))
    out = []
    for c in cycles:
        bundle = {}
        for u in PP_UNITS:
            if rng.random() < 0.4:
                bundle[u] = isa.Instr("op", u, int(rng.integers(1, 80)))
        if rng.random() < 0.35:
            kind = PP_KINDS[int(rng.integers(0, len(PP_KINDS)))]
            mode = (isa.PMode.ON, isa.PMode.OFF, isa.PMode.AUTO)[
                int(rng.integers(0, 3))]
            bundle["misc"] = isa.setpm(kind, 1, mode)
        if not bundle:
            bundle[PP_UNITS[0]] = isa.Instr("op", PP_UNITS[0], 1)
        out.append((int(c), bundle))
    return out


def seeded_programs(isa, seed: int = 10, n: int = 24,
                    n_events=None) -> tuple[list, list]:
    """``n`` random programs and their horizons from one seed; with
    ``n_events`` the programs have those lengths."""
    rng = np.random.default_rng(seed)
    rows, horizons = [], []
    for i in range(n):
        if n_events is None:
            horizon = int(rng.integers(200, 4000))
            k = int(rng.integers(1, min(120, horizon)))
        else:
            k = n_events[i]
            horizon = 4 * k + 50
        rows.append(random_events(isa, rng, k, horizon))
        horizons.append(horizon)
    return rows, horizons


def program_arrays(pp, isa, rows, horizons):
    """``rows`` through ``isa``'s own ``events_to_arrays`` into ``pp``'s
    ragged ``ProgramArrays``, one stream a program."""
    arrs = [isa.events_to_arrays(ev, PP_UNITS) for ev in rows]
    lengths = np.array([len(a["cycle"]) for a in arrs], np.int64)
    offsets = np.concatenate(([0], np.cumsum(lengths))).astype(np.int64)
    u = len(PP_UNITS)

    def cat(key, shape, dtype):
        if offsets[-1] == 0:
            return np.zeros(shape, dtype)
        return np.concatenate([a[key] for a in arrs])

    return pp.ProgramArrays(
        units=PP_UNITS, cycle=cat("cycle", (0,), np.int64),
        lat=cat("lat", (0, u), np.int64), pm=cat("pm", (0, u), np.int8),
        offsets=offsets, horizon=np.asarray(horizons, np.int64),
        setpm_vu=np.zeros(len(rows)))


def row_knobs(pp, isa, scales) -> tuple[np.ndarray, np.ndarray]:
    """Per row its ``(delay, window)`` ``(R, U)`` int64 at NPU-D's
    integer delays and windows, one (delay_scale, window_scale) a row."""
    g = isa.get_npu("NPU-D").gating
    u = len(PP_UNITS)
    delay = np.array([[isa.scaled_delay(g, k, d) for k in pp._KEYS]
                      for d, _ in scales], np.int64).reshape(-1, u)
    window = np.array([[isa.scaled_window(g, k, d, w) for k in pp._KEYS]
                       for d, w in scales], np.int64).reshape(-1, u)
    return delay, window


def pack_programs(pp, isa, rows, horizons, scales) -> dict:
    """``rows`` through ``pp``'s own ``events_to_arrays`` /
    ``_pack_dense`` into the dense executor stack, one (delay_scale,
    window_scale) per row at NPU-D's integer delays and windows."""
    pa = program_arrays(pp, isa, rows, horizons)
    delay, window = row_knobs(pp, isa, scales)
    return pp._pack_dense(pa, np.arange(len(rows)), window, delay,
                          np.asarray(horizons, np.int64))
