"""Port kernel K2 (``segment_sum``) against the reference's oracle.

The reference's numpy backend sums segments with ``np.bincount``; the
JAX backend with ``jax.ops.segment_sum``. On the CPU the port's wrapper
evaluates the kernel's plain version, which must reproduce
``np.bincount`` bit for bit (same left-to-right add order) — vectors,
leading batch axes, empty segments at the head, in the middle and at
the tail. Inputs come from ``np.random.default_rng(seed)``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.backend import NumpyBackend  # noqa: E402
from repro_torch.core.backend import get_backend  # noqa: E402
from repro_torch.kernels.segment_sum import (MAX_SUBS,  # noqa: E402
                                             SUB, segment_starts,
                                             segment_sum,
                                             segment_sum_plain,
                                             stage_subtiles)


def _ids(rng, n, num, holes=()):
    ids = np.sort(rng.integers(0, num, n)).astype(np.int64)
    return ids[~np.isin(ids, holes)]


def _mixed(rng, shape):
    """Values across sixteen orders of magnitude and both signs, so a
    different add order would show in the last bits."""
    return rng.standard_normal(shape) * 10.0 ** rng.integers(-8, 8, shape)


CASES = [  # (n, num_segments, removed ids)
    (1000, 17, ()),
    (1000, 40, (0, 1, 2, 11, 12, 25, 37, 38, 39)),  # head, middle, tail
    (257, 300, ()),                                  # mostly empty
    (1, 1, ()),
    (64, 5, (0, 1, 2, 3)),                           # one live segment
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", [segment_sum, segment_sum_plain],
                         ids=["wrapper", "plain"])
def test_vector_equals_bincount_exactly(case, fn):
    n, num, holes = case
    rng = np.random.default_rng(n + num)
    ids = _ids(rng, n, num, holes)
    data = _mixed(rng, ids.shape)
    want = NumpyBackend.segment_sum(data, ids, num)
    got = fn(torch.tensor(data), torch.tensor(ids), num)
    assert got.dtype == torch.float64 and got.shape == (num,)
    assert np.array_equal(got.numpy(), want)
    for h in holes:
        assert got[h] == 0.0


@pytest.mark.parametrize("lead", [(1,), (6,), (90,), (3, 4)])
def test_leading_batch_axes(lead):
    rng = np.random.default_rng(len(lead) * 100 + lead[0])
    ids = _ids(rng, 500, 23, (0, 7, 22))
    data = _mixed(rng, lead + ids.shape)
    got = segment_sum(torch.tensor(data), torch.tensor(ids), 23)
    assert got.shape == lead + (23,)
    flat = data.reshape(-1, ids.shape[0])
    want = np.stack([np.bincount(ids, weights=row, minlength=23)[:23]
                     for row in flat]).reshape(lead + (23,))
    assert np.array_equal(got.numpy(), want)


def test_matches_jax_segment_sum():
    """The op the kernel replaces, run as the JAX package runs it on
    the CPU (float32 here: x64 stays off in this process)."""
    import jax.ops
    rng = np.random.default_rng(3)
    ids = _ids(rng, 400, 12, (5,))
    data = rng.uniform(0.0, 1.0, ids.shape)
    want = np.asarray(jax.ops.segment_sum(
        data.astype(np.float32), ids.astype(np.int32), num_segments=12,
        indices_are_sorted=True))
    got = segment_sum(torch.tensor(data), torch.tensor(ids), 12).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)  # float32 oracle


def test_ids_past_the_last_segment_are_dropped():
    ids = np.array([0, 0, 1, 3, 3, 5, 6], np.int64)
    data = np.arange(1.0, 8.0)
    want = NumpyBackend.segment_sum(data, ids, 4)
    got = segment_sum(torch.tensor(data), torch.tensor(ids), 4)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,num", [((0,), 4), ((3, 0), 4), ((5,), 0),
                                       ((0, 7), 3)])
def test_empty_inputs_give_zeros(shape, num):
    n = shape[-1]
    ids = torch.zeros(n, dtype=torch.int64)
    got = segment_sum(torch.zeros(shape, dtype=torch.float64), ids, num)
    assert got.shape == shape[:-1] + (num,)
    assert float(got.abs().sum()) == 0.0


def test_segment_starts_are_the_range_bounds():
    ids = torch.tensor([1, 1, 2, 5, 5, 5], dtype=torch.int64)
    assert segment_starts(ids, 7).tolist() == [0, 0, 2, 3, 3, 3, 6, 6]
    assert segment_starts(ids[:0], 2).tolist() == [0, 0, 0]
    data = torch.arange(6, dtype=torch.float64)
    a = segment_sum(data, ids, 7)
    b = segment_sum(data, ids, 7, segment_starts(ids, 7))
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["data dtype", "ids dtype", "ids shape",
                                 "negative num"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    data = torch.ones(4, dtype=torch.float64)
    ids = torch.zeros(4, dtype=torch.int64)
    args = {"data dtype": (data.float(), ids, 2),
            "ids dtype": (data, ids.int(), 2),
            "ids shape": (data, ids[:3], 2),
            "negative num": (data, ids, -1)}[bad]
    with pytest.raises(ValueError):
        segment_sum(*args)


def test_backend_contract_on_cpu():
    """``TorchBackend`` on the CPU: dtype discipline of ``asarray`` and
    the two passes routed to the plain versions."""
    bk = get_backend("cpu")
    assert bk.asarray(np.ones(3, np.float32)).dtype == torch.float64
    assert bk.asarray(np.ones(3, np.int32)).dtype == torch.int64
    assert bk.asarray(np.ones(3, bool)).dtype == torch.bool
    assert bk.asarray(2.5).shape == ()
    with pytest.raises(TypeError):
        bk.asarray(np.array(["a"]))
    ids = bk.asarray(np.array([0, 0, 2]))
    out = bk.segment_sum(bk.asarray(np.array([1.0, 2.0, 4.0])), ids, 3)
    assert bk.to_numpy(out).tolist() == [3.0, 0.0, 4.0]
    assert get_backend("cpu") is bk


def test_default_device_is_the_card():
    """``device=None`` means ``"cuda"``: with no card it raises instead
    of quietly running on the host."""
    if torch.cuda.is_available():
        assert get_backend(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            get_backend(None)


@pytest.mark.parametrize("n,num,want", [
    (11191, 17, MAX_SUBS),   # the sweep's ops -> workloads: one window
    (9248, 17, MAX_SUBS),    # gaps -> workloads
    (11191, 9248, 1),        # ops -> gap chunks: ~155 ops a block's run
    (1000, 5, 2), (1, 1, 1), (0, 3, 1), (5, 0, 1)])
def test_stage_subtiles(n, num, want):
    """K2's staging window: about twice a block's mean span, within
    [1, MAX_SUBS] sub-tiles; the main shape's row fits in one."""
    assert stage_subtiles(n, num) == want
    assert 1 <= want <= MAX_SUBS
    if (n, num) == (11191, 17):
        assert n <= stage_subtiles(n, num) * SUB


def test_row_longer_than_a_staging_window_equals_bincount():
    """A segment longer than the kernel's largest window (the kernel
    carries its running sum across windows); on the CPU the wrapper's
    plain route, with np.bincount's bits."""
    rng = np.random.default_rng(7)
    lengths = (MAX_SUBS * SUB * 2 + 3, 5, 1000)
    ids = np.repeat(np.arange(3), lengths).astype(np.int64)
    data = _mixed(rng, (2,) + ids.shape)
    got = segment_sum(torch.tensor(data), torch.tensor(ids), 3)
    for b in range(2):
        assert np.array_equal(got[b].numpy(),
                              np.bincount(ids, weights=data[b], minlength=3))
