"""Port kernel K1 (``sa_occupancy``) against the reference closed forms.

On the CPU the wrapper evaluates the kernel's plain PyTorch version, so
these tests pin the arithmetic the CUDA kernel repeats: against the
reference's float64 closed form ``gating_stats_batch_xp(xp=np)`` and
against its int64 host batch, at ``rtol=1e-12, atol=0`` — the bar of the
reference's own kernel test — and, since every intermediate is an exact
integer, bit for bit. Inputs come from ``np.random.default_rng(seed)``
and go through both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sa_gating as ref_sa  # noqa: E402
from repro_torch.core import sa_gating as port_sa  # noqa: E402
from repro_torch.kernels.sa_occupancy import (sa_occupancy,  # noqa: E402
                                              sa_occupancy_plain)

RTOL = 1e-12
KEYS = ("duration_cycles", "frac_on", "frac_w_on", "frac_off",
        "wake_events")

# the case list of the reference's Pallas-kernel test: (n_ops, saw)
SA_OCC_CASES = [(777, 128.0), (64, 256.0), (1, 8.0), (513, 1.0)]


def _dims(rng, n, hi=(5000, 600, 5000)):
    return [rng.integers(1, h, n).astype(np.float64) for h in hi]


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("case", SA_OCC_CASES)
@pytest.mark.parametrize("fn", [sa_occupancy, sa_occupancy_plain],
                         ids=["wrapper", "plain"])
def test_matches_reference_closed_forms(case, fn):
    n, saw = case
    m, k, nn = _dims(np.random.default_rng(int(n + saw)), n)
    got = fn(_t(m), _t(k), _t(nn), saw)
    want = ref_sa.gating_stats_batch_xp(m, k, nn, saw, xp=np)
    assert set(got) == set(KEYS)
    for key in KEYS:
        assert got[key].dtype == torch.float64
        assert got[key].shape == (n,)
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   rtol=RTOL, atol=0)
        # exact-integer intermediates: not merely close, the same bits
        assert np.array_equal(got[key].numpy(), want[key]), key
    b = ref_sa.gating_stats_batch(m.astype(np.int64), k.astype(np.int64),
                                  nn.astype(np.int64), int(saw))
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), getattr(b, key),
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("wlc", [None, 0.0, 7.0])
def test_stacked_width_axis(wlc):
    """A width vector is a leading batch axis — how the sweep kernel
    drives the unique-width pass — and equals one call per width."""
    rng = np.random.default_rng(5)
    m, k, nn = _dims(rng, 200, (2000, 400, 2000))
    saws = (8.0, 32.0, 128.0, 256.0, 512.0)
    got = sa_occupancy(_t(m), _t(k), _t(nn), _t(saws), wlc)
    for key in KEYS:
        assert got[key].shape == (len(saws), 200)
    for i, saw in enumerate(saws):
        want = ref_sa.gating_stats_batch_xp(m, k, nn, saw, wlc, xp=np)
        b = ref_sa.gating_stats_batch(
            m.astype(np.int64), k.astype(np.int64), nn.astype(np.int64),
            int(saw), None if wlc is None else int(wlc))
        one = sa_occupancy(_t(m), _t(k), _t(nn), saw, wlc)
        for key in KEYS:
            assert np.array_equal(got[key][i].numpy(), want[key]), key
            assert torch.equal(got[key][i], one[key]), key
            np.testing.assert_allclose(got[key][i].numpy(),
                                       getattr(b, key), rtol=RTOL, atol=0)


def test_weight_load_cycles_override_moves_w_on():
    rng = np.random.default_rng(6)
    m, k, nn = _dims(rng, 100)
    d = sa_occupancy(_t(m), _t(k), _t(nn), 128.0)
    z = sa_occupancy(_t(m), _t(k), _t(nn), 128.0, weight_load_cycles=0.0)
    b0 = ref_sa.gating_stats_batch(m.astype(np.int64), k.astype(np.int64),
                                   nn.astype(np.int64), 128,
                                   weight_load_cycles=0)
    np.testing.assert_allclose(z["frac_w_on"].numpy(), b0.frac_w_on,
                               rtol=RTOL, atol=0)
    assert (z["duration_cycles"] < d["duration_cycles"]).all()
    with pytest.raises(ValueError, match="weight_load_cycles"):
        sa_occupancy(_t(m), _t(k), _t(nn), 128.0, weight_load_cycles=-1.0)


@pytest.mark.parametrize("saw", [128.0, (32.0, 64.0, 128.0)],
                         ids=["scalar", "vector"])
def test_empty_op_stream(saw):
    e = torch.zeros(0, dtype=torch.float64)
    got = sa_occupancy(e, e, e, saw if isinstance(saw, float) else _t(saw))
    shape = (0,) if isinstance(saw, float) else (3, 0)
    assert all(got[key].shape == shape for key in KEYS)


def test_fractions_partition_the_pe_cycles():
    rng = np.random.default_rng(8)
    m, k, nn = _dims(rng, 300)
    got = sa_occupancy(_t(m), _t(k), _t(nn), _t((64.0, 256.0)))
    tot = got["frac_on"] + got["frac_w_on"] + got["frac_off"]
    assert torch.allclose(tot, torch.ones_like(tot), rtol=1e-12, atol=0)
    assert (got["wake_events"] >= 1).all()


def test_port_host_batch_equals_reference_host_batch():
    """The port's int64 host check is the reference's, value for value."""
    rng = np.random.default_rng(9)
    m, k, nn = (a.astype(np.int64) for a in _dims(rng, 257))
    for saw, wlc in ((128, None), (8, 0), (np.array([[32], [256]]), None)):
        a = ref_sa.gating_stats_batch(m, k, nn, saw, wlc)
        b = port_sa.gating_stats_batch(m, k, nn, saw, wlc)
        for key in KEYS:
            assert np.array_equal(getattr(a, key), getattr(b, key)), key


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    m = torch.ones(4, dtype=torch.float64)
    args = {"dtype": (m.float(), m, m), "shape": (m, m[:3], m),
            "rank": (m[None], m[None], m[None])}[bad]
    with pytest.raises(ValueError):
        sa_occupancy(*args, 128.0)
    with pytest.raises(ValueError, match="saw"):
        sa_occupancy(m, m, m, torch.ones(2, 2, dtype=torch.float64))


# ---------------------------------------------------- ref.ref_sa_occupancy
# the reference's oracle (``repro.kernels.ref.ref_sa_occupancy``, jnp in
# float64) runs in a child with 64-bit JAX switched on for it alone --
# never in the pytest process, where it would change what the reference's
# own tests see -- and hands its results back as an .npz
REF_CHILD = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
assert jax.config.jax_enable_x64
from repro.kernels import ref

inp = np.load(sys.argv[1])
out = {}
for i, (n, saw) in enumerate(inp["cases"]):
    dims = [jnp.asarray(inp[f"{i}/{x}"]) for x in "mkn"]
    for wlc in (None, 0.0):
        for key, v in ref.ref_sa_occupancy(*dims, float(saw), wlc).items():
            out[f"{i}/{wlc}/{key}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_oracle(tmp_path_factory):
    import os
    import subprocess
    import sys
    tmp = tmp_path_factory.mktemp("ref_sa_occupancy")
    inp = {"cases": np.array(SA_OCC_CASES)}
    for i, (n, saw) in enumerate(SA_OCC_CASES):
        for x, a in zip("mkn", _dims(np.random.default_rng(int(n + saw)),
                                     n)):
            inp[f"{i}/{x}"] = a
    np.savez(tmp / "in.npz", **inp)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=src)
    subprocess.run([sys.executable, "-c", REF_CHILD, str(tmp / "in.npz"),
                    str(tmp / "out.npz")], env=env, check=True, timeout=300)
    return inp, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("wlc", [None, 0.0])
@pytest.mark.parametrize("i", range(len(SA_OCC_CASES)))
def test_ref_sa_occupancy_matches_the_reference(reference_oracle, i, wlc):
    """``ref.ref_sa_occupancy`` -- the reference's oracle under its name
    -- against the reference's, in float64, bit for bit (the bar of
    ``tests/test_kernels.py``'s kernel test is ``rtol=1e-12``; every
    intermediate is an exact integer); and ``sa_occupancy_plain`` (the
    same closed form with the width as a batch axis) the same bits."""
    from repro_torch.kernels.ref import ref_sa_occupancy
    inp, want = reference_oracle
    saw = float(SA_OCC_CASES[i][1])
    dims = [_t(inp[f"{i}/{x}"]) for x in "mkn"]
    got = ref_sa_occupancy(*dims, saw, wlc)
    plain = sa_occupancy_plain(*dims, saw, wlc)
    assert set(got) == set(KEYS)
    for key in KEYS:
        w = want[f"{i}/{wlc}/{key}"]
        assert got[key].dtype == torch.float64
        np.testing.assert_allclose(got[key].numpy(), w, rtol=RTOL, atol=0)
        assert np.array_equal(got[key].numpy(), w), key
        assert torch.equal(plain[key], got[key]), key


# ------------------------------------------- the wrapper and its plain form
# the width axes the wrapper takes: a scalar, and vectors of 1, 4 (the
# sweep's unique widths) and 72 widths
WIDTHS = {"scalar": 128.0, "S1": (64.0,), "S4": (32.0, 64.0, 128.0, 256.0),
          "S72": tuple(8.0 * (i + 1) for i in range(72))}


@pytest.mark.parametrize("wlc", [None, 0.0, 5.0])
@pytest.mark.parametrize("n", [0, 1, 257])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_wrapper_returns_what_the_plain_version_returns(widths, n, wlc):
    """The wrapper's dict against ``sa_occupancy_plain``'s: the same keys,
    and each value of the same shape, dtype and bits -- for a scalar
    width, 1, 4 and 72 widths, no op at all, and a weight-load override."""
    rng = np.random.default_rng(n + len(widths))
    dims = [_t(a) for a in _dims(rng, n)]
    saw = WIDTHS[widths]
    saw = saw if isinstance(saw, float) else _t(saw)
    got = sa_occupancy(*dims, saw, wlc)
    want = sa_occupancy_plain(*dims, saw, wlc)
    assert list(got) == list(want) == list(KEYS)
    shape = (n,) if widths == "scalar" else (len(WIDTHS[widths]), n)
    for key in KEYS:
        assert got[key].shape == want[key].shape == shape, key
        assert got[key].dtype == want[key].dtype == torch.float64, key
        assert torch.equal(got[key], want[key]), key

