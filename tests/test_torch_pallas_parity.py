"""The port against the reference's float64 JAX / Pallas route.

The reference's ``sa_occupancy_p`` Pallas kernel (interpret mode on the
CPU) and its ``backend="jax"`` sweep under
``SweepSession(sa_occupancy_impl="pallas")`` need 64-bit JAX, which is
switched on here for a child process only (``JAX_ENABLE_X64=1`` in the
child's environment — never in the pytest process, where it would
change what the reference's own tests see). The child computes from
inputs made with numpy from a seed and hands its results back as an
``.npz`` in ``tmp_path``; the parent pushes the same inputs through the
port and compares: the kernel at ``rtol=1e-12``, the sweep records at
≤1e-9 relative.
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.core import opgen as port_opgen  # noqa: E402
from repro_torch.core.policies import POLICIES, KnobGrid  # noqa: E402
from repro_torch.kernels.sa_occupancy import sa_occupancy  # noqa: E402

from _sweep_equiv import RTOL, rel  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SAWS = (8.0, 128.0, 256.0)
WORKLOADS = (8, 12, 16)           # decode, DLRM, diffusion: short traces
NPUS = ("NPU-A", "NPU-E")
GRID = dict(delay_scale=(1.0, 2.0, 4.0), sa_width=(None, 64))   # 6 knobs
CHILD_TIMEOUT_S = 300

CHILD = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
assert jax.config.jax_enable_x64
from repro.core.opgen import paper_suite
from repro.core.policies import POLICIES, KnobGrid
from repro.core.sweep import SweepSession, sweep
from repro.kernels.sa_occupancy import sa_occupancy_p

inp = np.load(sys.argv[1])
out = {}
m, k, n = (jnp.asarray(inp[x]) for x in ("m", "k", "n"))
for saw in inp["saws"]:
    for wlc in (None, 0.0):
        st = sa_occupancy_p(m, k, n, float(saw), wlc, block=256,
                            interpret=True)
        for key, v in st.items():
            out[f"occ|{saw}|{wlc}|{key}"] = np.asarray(v)
suite = paper_suite()
wls = [suite[int(i)] for i in inp["workloads"]]
grid = KnobGrid(delay_scale=tuple(inp["delay_scale"]),
                sa_width=(None, int(inp["sa_width"]))).product()
with SweepSession(sa_occupancy_impl="pallas"):
    recs = sweep(wls, tuple(str(x) for x in inp["npus"]), POLICIES, grid,
                 backend="jax")
fields = sorted(f for f, v in recs[0].items()
                if isinstance(v, float) and f not in
                ("delay_scale", "window_scale"))
out["fields"] = np.array(fields)
out["values"] = np.array([[r[f] for f in fields] for r in recs])
out["keys"] = np.array([f"{r['workload']}|{r['npu']}|{r['policy']}|"
                        f"{r['knob_idx']}" for r in recs])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pallas_parity")
    rng = np.random.default_rng(20)
    inp = dict(m=rng.integers(1, 5000, 700).astype(np.float64),
               k=rng.integers(1, 600, 700).astype(np.float64),
               n=rng.integers(1, 5000, 700).astype(np.float64),
               saws=np.array(SAWS), workloads=np.array(WORKLOADS),
               npus=np.array(NPUS),
               delay_scale=np.array(GRID["delay_scale"]),
               sa_width=np.array(GRID["sa_width"][1]))
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [SRC] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return inp, np.load(tmp / "out.npz")


@pytest.mark.parametrize("wlc", [None, 0.0])
@pytest.mark.parametrize("saw", SAWS)
def test_kernel_plain_version_matches_pallas_kernel(reference, saw, wlc):
    inp, out = reference
    got = sa_occupancy(*(torch.tensor(inp[x]) for x in ("m", "k", "n")),
                       saw, wlc)
    for key, v in got.items():
        np.testing.assert_allclose(v.numpy(), out[f"occ|{saw}|{wlc}|{key}"],
                                   rtol=1e-12, atol=0)


def test_sweep_matches_jax_backend_with_pallas_occupancy(reference):
    _, out = reference
    suite = port_opgen.paper_suite()
    # (``repro_torch.core`` re-exports a ``sweep`` function over the module)
    port_sweep = importlib.import_module("repro_torch.core.sweep")
    recs = port_sweep.sweep(
        [suite[i] for i in WORKLOADS], NPUS, POLICIES,
        KnobGrid(**GRID).product(), device="cpu")
    assert len(recs) == len(WORKLOADS) * len(NPUS) * len(POLICIES) * 6
    keys = [f"{r['workload']}|{r['npu']}|{r['policy']}|{r['knob_idx']}"
            for r in recs]
    assert keys == out["keys"].tolist()      # same records, same order
    fields = out["fields"].tolist()
    assert "total_j" in fields and "runtime_s" in fields
    worst = max(rel(r[f], float(out["values"][i, j]))
                for i, r in enumerate(recs) for j, f in enumerate(fields))
    assert worst <= RTOL, worst
