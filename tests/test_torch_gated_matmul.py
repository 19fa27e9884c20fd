"""Port kernel B2 (``gated_matmul``) against the JAX package.

On the CPU the wrapper evaluates the kernel's plain PyTorch version, so
these tests pin what the CUDA kernel must compute: the product of the
live tiles only. The same inputs, drawn with numpy from a seed (bf16 by
rounding the same float32 draws on both sides), go through the port and
through ``repro.kernels`` — the Pallas kernel in interpret mode and
``ref.ref_matmul``. Tolerances are those of ``tests/test_kernels.py``:
``atol = tol * max|want| + 1e-5``, ``rtol = tol``, with tol 1e-4 for
float32 (the same products summed in another order) and 2e-2 for bf16
(one rounding of the output to bf16 on each side).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels.gated_matmul import (  # noqa: E402
    gated_matmul_p as ref_gated_matmul_p)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.gated_matmul import (  # noqa: E402
    gated_matmul_p, gated_matmul_plain)

# (M, K, N, zero_cols, zero_rows): the GM_CASES of tests/test_kernels.py
GM_CASES = [
    (128, 128, 128, 0, 0),
    (256, 256, 512, 256, 0),     # N-underutilization (paper Fig 10 case 2)
    (384, 512, 256, 0, 256),     # K-underutilization (case 3)
    (128, 256, 384, 128, 128),   # both
    (512, 128, 128, 0, 0),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dt: str):
    """The same float32 draws as a port tensor and a JAX array of one
    dtype (both round float32 to bf16 to nearest even)."""
    tdt, jdt, _ = DTYPES[dt]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _assert_close(got, want, tol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max() + 1e-5)


def _case_inputs(case, seed):
    M, K, N, zn, zk = case
    g = np.random.default_rng(seed)
    x = g.standard_normal((M, K)).astype(np.float32)
    w = g.standard_normal((K, N)).astype(np.float32)
    if zn:
        w[:, N - zn:] = 0.0
    if zk:
        w[K - zk:, :] = 0.0
    return x, w


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", GM_CASES)
def test_plain_matches_pallas_interpret_and_ref_matmul(case, dt):
    x, w = _case_inputs(case, sum(case))
    (xt, xj), (wt, wj) = _pair(x, dt), _pair(w, dt)
    tol = DTYPES[dt][2]
    got = ops.gated_matmul(xt, wt)
    assert got.dtype == DTYPES[dt][0] and got.shape == (case[0], case[2])
    _assert_close(got, ref_ops.gated_matmul(xj, wj, interpret=True), tol)
    _assert_close(got, ref_ref.ref_matmul(xj, wj), tol)
    _assert_close(got, ref.ref_matmul(xt, wt), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_hand_bitmap_drops_a_nonzero_tile(dt):
    """A caller's bitmap with a 0 over nonzero weights drops them, as the
    Pallas kernel does; NaN in x meets only the tiles that run."""
    g = np.random.default_rng(11)
    x = g.standard_normal((256, 384)).astype(np.float32)
    w = g.standard_normal((384, 512)).astype(np.float32)
    x[:, 128:256] = np.nan  # K tile 1: dropped in every N tile below
    bitmap = np.array([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 0]], np.int32)
    (xt, xj), (wt, wj) = _pair(x, dt), _pair(w, dt)
    got = gated_matmul_p(xt, wt, torch.from_numpy(bitmap))
    want = ref_gated_matmul_p(xj, wj, jnp.asarray(bitmap), interpret=True)
    assert bool(torch.isfinite(got).all())
    _assert_close(got, want, DTYPES[dt][2])
    # the dropped tiles really change the product: N tile 1 has only K
    # tile 2, N tile 3 only K tile 0
    live_x = np.where(np.isnan(x), 0.0, x)
    dense = _np(ops.gated_matmul(*(torch.from_numpy(a).to(DTYPES[dt][0])
                                   for a in (live_x, w))))
    assert np.abs(_np(got)[:, 128:256] - dense[:, 128:256]).max() > 1.0


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_tile_nonzero_bitmap_matches_jax(dt):
    g = np.random.default_rng(3)
    w = g.standard_normal((384, 512)).astype(np.float32)
    w[0:128, 0:128] = 0.0           # a zero tile
    w[128:256, 128:256] = -0.0      # a tile of -0.0 is zero
    w[256:384, 256:384] = 0.0
    w[300, 300] = np.nan            # a NaN tile has bit 0 in both
    w[128:256, 384:512] = 0.0
    w[200, 400] = 1e-30             # one tiny value keeps a tile live
    wt, wj = _pair(w, dt)
    got = ops.tile_nonzero_bitmap(wt, 128, 128)
    want = np.asarray(ref_ops.tile_nonzero_bitmap(wj, 128, 128))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 0 and got[1, 1] == 0 and got[2, 2] == 0
    assert got[1, 3] == 1
    # 64-tiles of the same weights
    np.testing.assert_array_equal(
        ops.tile_nonzero_bitmap(wt, 64, 128).numpy(),
        np.asarray(ref_ops.tile_nonzero_bitmap(wj, 64, 128)))


def test_tile_nonzero_bitmap_marks_exactly_the_zero_tiles():
    """The case of tests/test_kernels.py::test_gated_matmul_skips_zero_tiles."""
    w = torch.ones((256, 512))
    w[:, 256:] = 0.0
    w[128:, :] = 0.0
    assert ops.tile_nonzero_bitmap(w, 128, 128).tolist() == \
        [[1, 1, 0, 0], [0, 0, 0, 0]]


@pytest.mark.parametrize("blocks", [(128, 128, 128), (64, 128, 64),
                                    (32, 64, 128)])
def test_tiles_run_counts_executed_tiles_on_the_cpu(blocks):
    bm, bn, bk = blocks
    g = np.random.default_rng(bm + bn + bk)
    x = torch.from_numpy(g.standard_normal((256, 256)).astype(np.float32))
    w = torch.from_numpy(g.standard_normal((256, 512)).astype(np.float32))
    bitmap = torch.from_numpy(
        (g.random((256 // bk, 512 // bn)) > 0.5).astype(np.int32))
    gated_matmul_p.tiles_run.zero_()
    out = gated_matmul_p(x, w, bitmap, bm=bm, bn=bn, bk=bk)
    want = (256 // bm) * int(bitmap.sum())
    assert int(gated_matmul_p.tiles_run) == want
    gated_matmul_p(x, w, bitmap, bm=bm, bn=bn, bk=bk)
    assert int(gated_matmul_p.tiles_run) == 2 * want
    assert gated_matmul_p.tiles_run.dtype == torch.int64
    # the plain version is blocked by the bitmap only: any bm agrees
    torch.testing.assert_close(
        out, gated_matmul_plain(x, w, bitmap, bm=256, bn=bn, bk=bk),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    dict(M=100), dict(K=200), dict(N=300), dict(bitmap=(1, 4))])
def test_shapes_that_do_not_tile_raise(bad):
    M, K, N = bad.get("M", 128), bad.get("K", 256), bad.get("N", 512)
    x, w = torch.zeros((M, K)), torch.zeros((K, N))
    bitmap = torch.ones(bad.get("bitmap", (K // 128, N // 128)),
                        dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple|bitmap"):
        gated_matmul_p(x, w, bitmap)
    if "bitmap" not in bad:
        with pytest.raises(ValueError):
            ops.gated_matmul(x, w)


def test_cpu_tensors_never_load_a_library():
    libs, launches = dict(_build._LIBS), gated_matmul_p.launches
    x = torch.ones((128, 128), dtype=torch.bfloat16)
    out = ops.gated_matmul(x, x)
    assert float(out[0, 0]) == 128.0
    assert gated_matmul_p.launches == launches
    assert _build._LIBS == libs

