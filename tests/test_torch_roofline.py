"""The port's roofline against the JAX package's: ``model_flops_estimate``
on every arch x ``SHAPES`` cell (1e-12 relative), and a report's
``dominant``, ``step_time_s``, ``roofline_fraction`` and ``flops_ratio``
from the same counts and the reference's ``TARGET`` figures. The port's
own target is the H100 SXM's public figures."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import get_arch as ref_arch  # noqa: E402
from repro.core import hw as ref_hw  # noqa: E402
from repro.core import roofline as ref  # noqa: E402

from repro_torch.configs.base import SHAPES, get_arch, list_archs  # noqa
from repro_torch.core import roofline  # noqa: E402
from repro_torch.core.costs import COLLECTIVES, HloCosts  # noqa: E402
from repro_torch.core.hw import H100_SXM, TARGET  # noqa: E402


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_estimate_is_the_references(arch, shape):
    got = roofline.model_flops_estimate(get_arch(arch), SHAPES[shape])
    want = ref.model_flops_estimate(ref_arch(arch), REF_SHAPES[shape])
    assert got > 0
    assert abs(got - want) <= 1e-12 * abs(want)


def test_the_target_is_the_h100s_public_figures():
    assert TARGET is H100_SXM
    assert (H100_SXM.name, H100_SXM.peak_flops, H100_SXM.hbm_bw,
            H100_SXM.hbm_gb, H100_SXM.ici_bw_link, H100_SXM.ici_links) \
        == ("h100-sxm", 989e12, 3.35e12, 80.0, 900e9, 1)


CASES = [  # flops, memory bytes, collective bytes by type, model flops
    (1.0e15, 2.0e12, (1e9, 2e9, 0.0, 0.0, 0.0), 4.0e17),
    (3.0e12, 9.0e12, (0.0, 0.0, 5e8, 0.0, 0.0), 1.0e15),
    (2.0e12, 1.0e11, (4e11, 0.0, 0.0, 1e9, 0.0), 3.0e14),
    (0.0, 0.0, (0.0,) * 5, 0.0),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_report_properties_are_the_references(case):
    flops, mem, coll, model = CASES[case]
    coll = dict(zip(COLLECTIVES, coll))
    target = ref_hw.TARGET
    n = 256
    ours = roofline.report_from_costs(
        HloCosts(flops=flops, memory_bytes=mem, collective_bytes=coll),
        arch="a", shape="s", mesh="m", n_chips=n, model_flops=model,
        target=target)
    theirs = ref.RooflineReport(
        arch="a", shape="s", mesh="m", n_chips=n, flops=flops,
        memory_bytes=mem, collective_bytes=coll,
        compute_s=flops / target.peak_flops, memory_s=mem / target.hbm_bw,
        collective_s=sum(coll.values())
        / (target.ici_bw_link * target.ici_links), model_flops=model)
    for name in ("compute_s", "memory_s", "collective_s"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.dominant == theirs.dominant
    assert ours.step_time_s == theirs.step_time_s
    assert ours.roofline_fraction == theirs.roofline_fraction
    assert ours.flops_ratio == theirs.flops_ratio
    js = ours.to_json()
    for k in ("dominant", "step_time_s", "roofline_fraction", "flops_ratio",
              "compute_s", "memory_s", "collective_s", "model_flops"):
        assert k in js
    assert js["target"] == target.name


def test_the_report_reads_its_own_targets_peak():
    costs = HloCosts(flops=1e12, memory_bytes=1e9)
    h100 = roofline.report_from_costs(costs, arch="a", shape="s", mesh="m",
                                      n_chips=1, model_flops=1e12)
    tpu = roofline.report_from_costs(costs, arch="a", shape="s", mesh="m",
                                     n_chips=1, model_flops=1e12,
                                     target=ref_hw.TARGET)
    assert h100.compute_s == 1e12 / 989e12
    assert math.isclose(h100.roofline_fraction, 1.0)
    assert math.isclose(tpu.roofline_fraction, 1.0)
    assert tpu.compute_s == 1e12 / ref_hw.TARGET.peak_flops
