"""The port's SSD (Mamba-2) scan and block against the JAX package's, on
the CPU.

* the plain version of kernel B5 (``ssd_scan_plain``, reached through
  ``ops.ssd_scan`` with CPU tensors) against the Pallas kernel
  ``ops.ssd_scan(..., interpret=True)`` and against the sequential oracle
  ``ref_ssd`` at the reference's own ``SSD_CASES``
  (``tests/test_kernels.py``), at its scaled ``atol=1e-4``;
* the model's chunked scan ``_ssd_chunk_scan`` against the JAX one, the
  same float32 arithmetic in another order, with the JAX chunk rule
  (S = 257 takes chunks of 1): 5e-5 of the largest value. In a chunk of
  256 the decays exp(cum_last - cum_j) are differences of float32
  cumsums of size ~500, where one ulp is 3e-5; against a float64
  recurrence the JAX state is off by up to 2.0e-5 of its largest value
  and the port's by 1.0e-5, and the two differ by up to 2.6e-5
  (measured; 1.05e-5 for y at S = 200);
* ``_causal_conv``, ``ssd_fwd`` and ``ssd_decode`` against the JAX
  functions on the JAX weights, float32, 1e-5 of the largest value;
* the head -> group map (G = 2) against the JAX ``jnp.repeat`` path;
* a strong-decay case (A = -16, dt ~ 10), where a mask after ``exp``
  would give inf * 0 = NaN: no NaN, and equal to ``ref_ssd``;
* CPU tensors take the plain version and never reach the kernel.

Inputs are drawn with numpy from fixed seeds and handed to both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models.param import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa
from repro_torch.models import blocks  # noqa: E402

# tests/test_kernels.py: (BH, S, P, N, chunk) and its scaled atol
SSD_CASES = [(2, 256, 64, 32, 128), (4, 256, 32, 16, 64),
             (1, 512, 64, 64, 128)]
KERNEL_ATOL = 1e-4
# float32 on both sides, the same chunking; only the summation order
# differs
F32_ATOL = 1e-5
# the same, over chunks of up to 256 positions (see the module docstring)
CHUNK_ATOL = 5e-5


def _scaled_close(got, want, atol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _scan_inputs(seed, BH, S, P, N):
    """x, dt (post-softplus), A (negative), B, C as numpy float32 in the
    kernel's (BH, S, ·) layout, drawn as tests/test_kernels.py draws."""
    g = np.random.default_rng(seed)
    x = g.standard_normal((BH, S, P)).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((BH, S)))).astype(np.float32)
    A = (-np.exp(g.uniform(0.0, 1.5, BH))).astype(np.float32)
    B = g.standard_normal((BH, S, N)).astype(np.float32)
    C = g.standard_normal((BH, S, N)).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------ B5's plain version

@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_plain_matches_pallas_kernel_and_ref_ssd(case):
    BH, S, P, N, chunk = case
    arrays = _scan_inputs(BH * S + P, BH, S, P, N)
    yk, hk = jops.ssd_scan(*_j(*arrays), chunk=chunk, interpret=True)
    yr, hr = jref.ref_ssd(*_j(*arrays))
    y, h = ops.ssd_scan(*_t(*arrays), chunk=chunk)
    assert y.shape == (BH, S, P) and h.shape == (BH, P, N)
    assert y.dtype == h.dtype == torch.float32
    for want_y, want_h in ((yk, hk), (yr, hr)):
        _scaled_close(y.numpy(), want_y, KERNEL_ATOL)
        _scaled_close(h.numpy(), want_h, KERNEL_ATOL)


def test_ref_ssd_matches_the_jax_oracle():
    arrays = _scan_inputs(3, 3, 40, 16, 8)
    y, h = ref.ref_ssd(*_t(*arrays))
    yr, hr = jref.ref_ssd(*_j(*arrays))
    _scaled_close(y.numpy(), yr, F32_ATOL)
    _scaled_close(h.numpy(), hr, F32_ATOL)


@pytest.mark.parametrize("S,chunk", [(1, 64), (63, 64), (130, 64),
                                     (100, 7)])
def test_plain_pads_a_ragged_last_chunk(S, chunk):
    """The plain version pads a ragged last chunk with dt = 0, x = B = C
    = 0, as the kernel masks it: the result is the recurrence's."""
    x, dt, A, B, C = _scan_inputs(S, 2, S, 16, 8)
    y, h = ssd_scan_plain(*_t(x[:, :, None], dt[:, :, None]),
                          torch.from_numpy(A)[:, None],
                          *_t(B[:, :, None], C[:, :, None]), chunk=chunk)
    yr, hr = jref.ref_ssd(*_j(x, dt, A, B, C))
    _scaled_close(y[:, :, 0].numpy(), yr, KERNEL_ATOL)
    _scaled_close(h[:, 0].numpy(), hr, KERNEL_ATOL)


def test_ops_returns_y_in_the_input_dtype():
    x, dt, A, B, C = _t(*_scan_inputs(1, 2, 32, 16, 16))
    y, h = ops.ssd_scan(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16())
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


# ------------------------------------------------ the model's chunk scan

def _model_scan_inputs(seed, Bz, S, nh, hd, N):
    g = np.random.default_rng(seed)
    x = g.standard_normal((Bz, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((Bz, S, nh)))).astype(np.float32)
    A = (-np.exp(g.uniform(0.0, 1.5, nh))).astype(np.float32)
    Bm = g.standard_normal((Bz, S, nh, N)).astype(np.float32)
    Cm = g.standard_normal((Bz, S, nh, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S", [1, 17, 200, 256, 257])
def test_chunk_scan_matches_jax(S):
    """S = 200: one chunk of 200; 256: one of 256; 257: 257 chunks of 1
    (``_largest_chunk``), as in the JAX package."""
    if S == 257:
        assert blocks._largest_chunk(S) == 1 == jblocks._largest_chunk(S)
    arrays = _model_scan_inputs(S, 2, S, 3, 16, 8)
    y, h = blocks._ssd_chunk_scan(*_t(*arrays))
    yj, hj = jblocks._ssd_chunk_scan(*_j(*arrays))
    assert y.shape == (2, S, 3, 16) and h.shape == (2, 3, 16, 8)
    _scaled_close(y.numpy(), yj, CHUNK_ATOL)
    _scaled_close(h.numpy(), hj, CHUNK_ATOL)


def test_largest_chunk_is_the_jax_rule():
    for S in (1, 2, 3, 24, 96, 200, 256, 257, 384, 2047, 2048, 2049, 6144):
        assert blocks._largest_chunk(S) == jblocks._largest_chunk(S)


# ----------------------------------------------------- the SSD block

def _ssd_cfgs(n_groups=1):
    cfg, rcfg = get_arch("mamba2-780m").reduced(), \
        ref_get_arch("mamba2-780m").reduced()
    if n_groups != 1:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=n_groups))
        rcfg = dataclasses.replace(
            rcfg, ssm=dataclasses.replace(rcfg.ssm, n_groups=n_groups))
    return cfg, rcfg


def _ssd_weights(rcfg, seed):
    """One layer's SSD weights from the JAX package, and the same numbers
    as a port tree; dt_bias and A_log moved off their trivial inits."""
    jp = ref_init_params(jblocks.ssd_specs(rcfg), jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed)
    nh = rcfg.ssm.n_heads(rcfg.d_model)
    jp["dt_bias"] = jnp.asarray(g.normal(0, 0.5, nh).astype(np.float32))
    jp["conv_b"] = jnp.asarray(
        g.normal(0, 0.1, jp["conv_b"].shape).astype(np.float32))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                 device="cpu")


def test_causal_conv_matches_jax():
    g = np.random.default_rng(0)
    x = g.standard_normal((2, 9, 12)).astype(np.float32)
    w = g.standard_normal((4, 12)).astype(np.float32)
    b = g.standard_normal(12).astype(np.float32)
    got = blocks._causal_conv(*_t(x, w, b))
    want = jblocks._causal_conv(*_j(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("S", [3, 20, 33])
def test_ssd_fwd_matches_jax(S, n_groups):
    """G = 2 holds the head -> group map to the JAX ``jnp.repeat``: head
    h reads group h // (nh // G)."""
    cfg, rcfg = _ssd_cfgs(n_groups)
    jp, tp = _ssd_weights(rcfg, S + n_groups)
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    want, (jtail, jh) = jblocks.ssd_fwd(jp, jnp.asarray(x), rcfg,
                                        return_cache=True)
    got, (tail, h) = blocks.ssd_fwd(tp, torch.from_numpy(x), cfg,
                                    return_cache=True)
    _scaled_close(got.numpy(), want, F32_ATOL)
    _scaled_close(h.numpy(), jh, F32_ATOL)
    for ours, theirs in zip(tail, jtail):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=F32_ATOL)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_ssd_decode_matches_jax_and_updates_in_place(n_groups):
    cfg, rcfg = _ssd_cfgs(n_groups)
    jp, tp = _ssd_weights(rcfg, 7 + n_groups)
    ss = cfg.ssm
    nh, di = ss.n_heads(cfg.d_model), ss.d_inner(cfg.d_model)
    GN = ss.n_groups * ss.d_state
    g = np.random.default_rng(n_groups)
    conv = [g.standard_normal((2, ss.conv_width - 1, c)).astype(np.float32)
            for c in (di, GN, GN)]
    ssm = g.standard_normal((2, nh, ss.head_dim, ss.d_state)).astype(
        np.float32)
    tconv, tssm = _t(*conv), torch.from_numpy(ssm.copy())
    for step in range(3):
        x = g.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jconv, jssm = jblocks.ssd_decode(jp, jnp.asarray(x),
                                               tuple(_j(*conv)),
                                               jnp.asarray(ssm), rcfg)
        got, oconv, ossm = blocks.ssd_decode(tp, torch.from_numpy(x),
                                             tuple(tconv), tssm, cfg)
        assert ossm is tssm and all(a is b for a, b in zip(oconv, tconv))
        _scaled_close(got.numpy(), want, F32_ATOL)
        _scaled_close(tssm.numpy(), jssm, F32_ATOL)
        for ours, theirs in zip(tconv, jconv):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       atol=F32_ATOL)
        conv, ssm = [np.asarray(c) for c in jconv], np.asarray(jssm)


@pytest.mark.parametrize("S", [1, 2])
def test_a_prompt_shorter_than_the_conv_keeps_its_tail_right_aligned(S):
    """The JAX package keeps only the S < W-1 rows it has; its server
    grafts them left-aligned. The port puts zeros before them."""
    cfg, rcfg = _ssd_cfgs()
    jp, tp = _ssd_weights(rcfg, 11)
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    _, (jtail, _) = jblocks.ssd_fwd(jp, jnp.asarray(x), rcfg,
                                    return_cache=True)
    _, (tail, _) = blocks.ssd_fwd(tp, torch.from_numpy(x), cfg,
                                  return_cache=True)
    W = cfg.ssm.conv_width
    for ours, theirs in zip(tail, jtail):
        assert ours.shape[1] == W - 1 and theirs.shape[1] == S
        assert not ours[:, :W - 1 - S].any()
        np.testing.assert_allclose(ours[:, W - 1 - S:].numpy(),
                                   np.asarray(theirs), atol=F32_ATOL)


# ------------------------------------------------- strong decay, NaN

def test_strong_decay_gives_no_nan_and_equals_ref_ssd():
    """A = -16, dt ~ 10: exp(cum_i - cum_j) above the diagonal would be
    exp(+1e3) = inf; masked after exp that is inf * 0 = NaN."""
    g = np.random.default_rng(5)
    BH, S, P, N = 2, 130, 16, 16
    x = g.standard_normal((BH, S, P)).astype(np.float32)
    dt = (10.0 + g.uniform(0, 0.1, (BH, S))).astype(np.float32)
    A = np.full(BH, -16.0, np.float32)
    B = g.standard_normal((BH, S, N)).astype(np.float32)
    C = g.standard_normal((BH, S, N)).astype(np.float32)
    y, h = ops.ssd_scan(*_t(x, dt, A, B, C))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    yr, hr = ref.ref_ssd(*_t(x, dt, A, B, C))
    _scaled_close(y.numpy(), yr.numpy(), KERNEL_ATOL)
    _scaled_close(h.numpy(), hr.numpy(), KERNEL_ATOL)


# ----------------------------------------- the wrapper on CPU tensors

def test_cpu_tensors_take_the_plain_version():
    x, dt, A, B, C = _t(*_model_scan_inputs(2, 2, 40, 4, 16, 16))
    Bg, Cg = B[:, :, :2], C[:, :, :2]  # two groups of two heads
    A2 = A.expand(2, 4)
    launches, libs = ssd_scan.launches, dict(_build._LIBS)
    y, h = ssd_scan(x, dt, A2, Bg, Cg)
    out = torch.full((3, 2, 4, 16, 16), 7.0)
    y2, h2 = ssd_scan(x, dt, A2, Bg, Cg, out_state=out[1])
    assert ssd_scan.launches == launches and _build._LIBS == libs
    want_y, want_h = ssd_scan_plain(x, dt, A2, Bg, Cg)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert torch.equal(y2, y) and h2.data_ptr() == out[1].data_ptr()
    assert torch.equal(out[1], h) and (out[0] == 7).all() \
        and (out[2] == 7).all()


@pytest.mark.parametrize("bad", ["groups", "dt_dtype", "A_shape", "mixed",
                                 "out_state", "empty"])
def test_wrapper_rejects_bad_arguments(bad):
    x, dt, A, B, C = _t(*_model_scan_inputs(4, 1, 8, 4, 16, 16))
    A = A.expand(1, 4)
    args = dict(x=x, dt=dt, A=A, B=B[:, :, :1], C=C[:, :, :1])
    kw = {}
    if bad == "groups":
        args.update(B=B[:, :, :3], C=C[:, :, :3])
    elif bad == "dt_dtype":
        args.update(dt=dt.double())
    elif bad == "A_shape":
        args.update(A=A[0])
    elif bad == "mixed":
        args.update(x=x.bfloat16())
    elif bad == "out_state":
        kw = {"out_state": torch.zeros((1, 4, 16, 16), dtype=torch.float64)}
    else:
        args = {k: v[:, :0] if v.dim() > 2 else v for k, v in args.items()}
    with pytest.raises(ValueError):
        ssd_scan(*args.values(), **kw)


# ----------------------------------------- what the C launchers receive

class _RecordingLib:
    """Stands in for the built library: records each launcher's call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _launch_args(dtype, odd_x=False):
    """Inputs in the model's layout, B and C strided views of one (B, S,
    2 G N) projection; with ``odd_x`` an x that starts 2 bytes into its
    storage with a row stride of 513 elements."""
    rng = np.random.default_rng(11)
    Bz, S, H, P, G, N = 2, 70, 4, 16, 2, 16
    xs = torch.tensor(rng.standard_normal((Bz, S, H * P + odd_x)),
                      dtype=torch.float32).to(dtype)
    x = xs[..., int(odd_x):].unflatten(2, (H, P))
    dt = torch.tensor(rng.uniform(0.1, 1.0, (Bz, S, H)), dtype=torch.float32)
    A = torch.tensor(-rng.uniform(0.5, 2.0, H), dtype=torch.float32)
    bc = torch.tensor(rng.standard_normal((Bz, S, 2 * G * N)),
                      dtype=torch.float32).to(dtype)
    B, C = bc[..., :G * N].unflatten(2, (G, N)), \
        bc[..., G * N:].unflatten(2, (G, N))
    y = torch.empty((Bz, S, H, P))
    state = torch.empty((Bz, H, P, N))
    return x, dt, A.expand(Bz, H), B, C, y, state


@pytest.mark.parametrize("odd_x", [False, True])
def test_bf16_launch_hands_tma_ready_operands(odd_x):
    """bf16 goes to ``ssd_scan_bf16_launch`` with x, B, C whose rows
    start on 16-byte boundaries: B and C (and an aligned x) in place, an
    x at an odd offset copied densely; their strides as
    ``kernel_strides`` gives them, in 16-byte multiples; and a C·Bᵀ
    workspace of its own."""
    from repro_torch.kernels.ssd_scan import _launch
    x, dt, A, B, C, y, state = _launch_args(torch.bfloat16, odd_x)
    lib = _RecordingLib()
    assert _launch(lib, x, dt, A, B, C, y, state, stream=7) == 0
    (name, args), = lib.calls
    assert name == "ssd_scan_bf16_launch"
    xp, dtp, ap, bp, cp, yp, sp, cbp = args[:8]
    assert (bp, cp, dtp, ap, yp, sp) == (
        B.data_ptr(), C.data_ptr(), dt.data_ptr(), A.data_ptr(),
        y.data_ptr(), state.data_ptr())
    assert (xp == x.data_ptr()) is (not odd_x)
    assert all(p % 16 == 0 for p in (xp, bp, cp, cbp))
    assert cbp not in (xp, bp, cp, yp, sp)
    assert args[8:14] == (2, 70, 4, 2, 16, 16)
    xst, bst, cst = list(args[14]), list(args[17]), list(args[18])
    assert xst == [70 * 64, 64, 16]
    assert bst == cst == [70 * 64, 64, 16]
    assert all(2 * s % 16 == 0 for s in xst + bst)
    assert list(args[15]) == [70 * 4, 4, 1] and list(args[16]) == [0, 1]
    assert list(args[19]) == list(state.stride()[:3]) and args[20] == 7


def test_float32_launch_takes_the_tensors_in_place():
    from repro_torch.kernels.ssd_scan import _launch
    x, dt, A, B, C, y, state = _launch_args(torch.float32, odd_x=True)
    lib = _RecordingLib()
    _launch(lib, x, dt, A, B, C, y, state, stream=3)
    (name, args), = lib.calls
    assert name == "ssd_scan_launch"
    assert args[:7] == tuple(t.data_ptr() for t in (x, dt, A, B, C, y,
                                                     state))
    assert args[7:13] == (2, 70, 4, 2, 16, 16)
    assert list(args[13]) == [70 * 65, 65, 16]
    assert args[-1] == 3
