"""The port's CUDA kernels on a card (marker ``gpu``).

These need an NVIDIA GPU and ``nvcc``; without a card they skip. Run
them on a machine that has one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at the sweep's full size.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import opgen  # noqa: E402
from repro_torch.core.policies import POLICIES, KnobGrid  # noqa: E402
from repro_torch.kernels.sa_occupancy import (sa_occupancy,  # noqa: E402
                                              sa_occupancy_plain)
from repro_torch.kernels.segment_sum import (segment_sum,  # noqa: E402
                                             segment_sum_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    # decided here, at run time: every worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 255, 257, 4099])
@pytest.mark.parametrize("wlc", [None, 0.0])
def test_sa_occupancy_kernel_equals_plain_bit_for_bit(card, n, wlc):
    rng = np.random.default_rng(n)
    dims = [torch.tensor(rng.integers(1, hi, n).astype(np.float64),
                         device=card) for hi in (5000, 600, 5000)]
    saws = torch.tensor([8.0, 32.0, 128.0, 256.0, 512.0],
                        dtype=torch.float64, device=card)
    before = sa_occupancy.launches
    for saw in (saws, 128.0):
        got = sa_occupancy(*dims, saw, wlc)
        want = sa_occupancy_plain(*dims, saw, wlc)
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert sa_occupancy.launches == before + 2


@pytest.mark.parametrize("batch", [(), (6,), (90,)])
def test_segment_sum_kernel_equals_cpu_plain_bit_for_bit(card, batch):
    rng = np.random.default_rng(len(batch) + 40)
    ids = np.sort(rng.integers(3, 37, 5000)).astype(np.int64)
    ids = ids[ids % 5 != 0]  # empty segments: head, middle, tail
    data = rng.standard_normal(batch + ids.shape) \
        * 10.0 ** rng.integers(-8, 8, batch + ids.shape)
    d, i = torch.tensor(data, device=card), torch.tensor(ids, device=card)
    before = segment_sum.launches
    got = segment_sum(d, i, 40)
    assert segment_sum.launches == before + 1
    assert torch.equal(got, segment_sum(d, i, 40))       # run to run
    want = segment_sum_plain(d.cpu(), i.cpu(), 40)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(
        got.cpu().numpy().reshape(-1, 40)[0],
        np.bincount(ids, weights=data.reshape(-1, len(ids))[0],
                    minlength=40))


def test_sweep_on_the_card_matches_the_cpu(card):
    sweep = importlib.import_module("repro_torch.core.sweep").sweep
    grid = KnobGrid(delay_scale=(0.5, 2.0), sa_width=(None, 64),
                    window_scale=(0.5, 1.0)).product()
    wls = opgen.paper_suite()[6:14]
    k1, k2 = sa_occupancy.launches, segment_sum.launches
    on_card = sweep(wls, ("NPU-A", "NPU-E"), POLICIES, grid)  # device=None
    assert sa_occupancy.launches > k1 and segment_sum.launches > k2
    on_cpu = sweep(wls, ("NPU-A", "NPU-E"), POLICIES, grid, device="cpu")
    assert len(on_card) == len(on_cpu)
    for a, b in zip(on_cpu, on_card):
        for k, va in a.items():
            if isinstance(va, float):
                assert abs(va - b[k]) <= 1e-9 * max(1e-30, abs(va),
                                                    abs(b[k])), k
            else:
                assert va == b[k], k
