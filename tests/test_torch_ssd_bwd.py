"""The backward of the SSD scan (kernel B10's plain version) against the
JAX package's, on the CPU.

* ``ssd_scan_bwd_plain`` (autograd through B5's plain version) against
  ``jax.vjp`` of the reference's ``blocks._ssd_chunk_scan``, float32, with
  G < nh, a ragged last chunk (S = 100 and 130 in the port's chunks of 64,
  one chunk of S in the reference's), the reference's own chunk (S = 256),
  the final state's gradient, and the strong-decay case (A = -16, dt ~ 10,
  where nothing survives a step): dx, ddt, dB, dC within 1e-5 relative L2
  (measured at most 6.9e-6).
* dA alone is held to ``DA_TOL``: it sums dt da over every position of a
  head, each da a sum of differences of float32 cumsums whose size is
  ~10-100 (an ulp ~1e-5), with heavy cancellation. Both packages sit
  1e-5 to 1.5e-4 from a float64 recurrence, and from each other (measured
  at most 1.5e-4); ``test_da_is_float32s_own_error`` shows the port's and
  the reference's distance to float64 side by side.
* The kernel's four passes (``csrc/ssd_scan_bwd.cu``), written out in
  float64 (``_four_passes``): the chunk-local states s_c and state
  gradients d_c, the forward and reverse state walks (the reverse one
  seeded by the final state's gradient), each chunk's gradients from its
  entering state and leaving gradient alone, and dA summed in chunk
  order -- against ``jax.vjp`` of the reference and against B10's plain
  version, at ``CASES`` and at 10 chunks, with and without the state's
  gradient, within the tolerances above (the float64 result is the
  exact one; the float32 references sit within them of it).
* ``KernelSSD`` (the card's autograd function: B5 forward, B10 backward),
  run here on CPU tensors, whose wrappers take their plain versions,
  gives autograd's gradients bit for bit.
* The wrapper on CPU tensors takes the plain version and loads nothing,
  and refuses malformed gradients.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.blocks import _largest_chunk  # noqa: E402
from repro.models.blocks import _ssd_chunk_scan as jscan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan_bwd import (ssd_scan_bwd,  # noqa: E402
                                              ssd_scan_bwd_plain)
from repro_torch.models.blocks import KernelSSD  # noqa: E402

GRAD_TOL = 1e-5  # relative L2: dx, ddt, dB, dC
DA_TOL = 3e-4    # relative L2: dA (module docstring)
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# (B, S, nh, hd, G, N), strong decay, with the final state's gradient
CASES = [((2, 100, 4, 16, 2, 16), False, False),
         ((1, 256, 2, 32, 1, 32), False, False),
         ((2, 130, 4, 16, 2, 16), True, False),
         ((1, 96, 2, 16, 1, 16), False, True)]


def _inputs(Bz, S, H, P, G, N, strong=False, seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((Bz, S, H, P)).astype(np.float32)
    if strong:
        dt = (10.0 + g.uniform(0, 0.1, (Bz, S, H))).astype(np.float32)
        A = np.full(H, -16.0, np.float32)
    else:
        dt = np.log1p(np.exp(g.standard_normal((Bz, S, H)))).astype(
            np.float32)
        A = (-np.exp(g.uniform(0.0, 1.5, H))).astype(np.float32)
    B = g.standard_normal((Bz, S, G, N)).astype(np.float32)
    C = g.standard_normal((Bz, S, G, N)).astype(np.float32)
    dy = g.standard_normal((Bz, S, H, P)).astype(np.float32)
    dh = g.standard_normal((Bz, H, P, N)).astype(np.float32)
    return x, dt, A, B, C, dy, dh


def _jax_grads(x, dt, A, B, C, dy, dh):
    """``jax.vjp`` of the reference's chunked scan (groups repeated to
    heads as its model does) for y's gradient ``dy`` and the final
    state's ``dh`` (zeros: none)."""
    rep = x.shape[2] // B.shape[2]

    def f(x, dt, A, B, C):
        return jscan(x, dt, A, jnp.repeat(B, rep, 2), jnp.repeat(C, rep, 2))

    _, vjp = jax.vjp(f, *map(jnp.asarray, (x, dt, A, B, C)))
    return [np.asarray(t) for t in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


def _port_grads(x, dt, A, B, C, dy, dh, *, chunk=None, state=True):
    """B10's plain version (the kernel's chunks), or, with ``chunk``,
    autograd through B5's plain version in chunks of that length."""
    T = torch.from_numpy
    Bz, _, H, _ = x.shape
    args = (T(x), T(dt), T(A)[None].expand(Bz, H), T(B), T(C))
    dstate = T(dh) if state else None
    if chunk is None:
        got = ssd_scan_bwd_plain(*args, T(dy), dstate)
    else:
        leaves = [t.clone().requires_grad_() for t in args]
        y, h = ssd_scan_plain(*leaves, chunk=chunk)
        torch.autograd.backward([y, h], [T(dy), torch.zeros_like(h)
                                         if dstate is None else dstate])
        got = [t.grad for t in leaves]
    got = [t.numpy() for t in got]
    got[2] = got[2].sum(0)  # A is the model's (nh,) vector over the batch
    return got


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check(got, want, strong):
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        if name == "dA" and strong:  # exp(-160) is 0: A moves nothing
            assert np.abs(a).max() == np.abs(w).max() == 0.0
            continue
        tol = DA_TOL if name == "dA" else GRAD_TOL
        assert _rel(a, w) <= tol, (name, _rel(a, w))


@pytest.mark.parametrize("chunk", ["kernel", "reference"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_bwd_matches_jax_vjp(case, chunk):
    """B10's plain version, in the kernel's chunks of 64 (a ragged last
    one at S = 100 and 130); and autograd through B5's plain version in
    the reference's own chunk rule, the arithmetic of the CPU model
    path."""
    shape, strong, state = case
    x, dt, A, B, C, dy, dh = _inputs(*shape, strong=strong)
    if not state:
        dh = np.zeros_like(dh)
    want = _jax_grads(x, dt, A, B, C, dy, dh)
    S = shape[1]
    Q = None if chunk == "kernel" else (
        min(S, 256) if S % 256 == 0 or S < 256 else _largest_chunk(S))
    _check(_port_grads(x, dt, A, B, C, dy, dh, chunk=Q, state=state), want,
           strong)


def _f64_grads(x, dt, A, B, C, dy):
    """dx, ddt, dA, dB, dC of the sequential recurrence h_t = exp(dt_t A)
    h + dt_t x_t B_t^T, y_t = h_t C_t, in float64 by autograd."""
    x, dt, A, B, C = (torch.from_numpy(t).double().requires_grad_()
                      for t in (x, dt, A, B, C))
    Bz, S, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    h = torch.zeros((Bz, H, P, B.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    torch.stack(ys, 1).backward(torch.from_numpy(dy).double())
    return [t.grad.numpy() for t in (x, dt, A, B, C)]


def _four_passes(x, dt, A, B, C, dy, dh, Q=64):
    """dx, ddt, dA (per batch row), dB, dC of the chunked scan for the
    gradients dy and dh (None: zero), computed in float64 as B10's kernels
    split the work: (1) per chunk its cumsum, s_c = sum_s exp(e - cum_s)
    dt_s x_s B_s^T and d_c = sum_t exp(cum_t) dy_t C_t^T; (2) the walks
    h_{c+1} = exp(e_c) h_c + s_c from 0 and dH_{c-1} = exp(e_c) dH_c + d_c
    from dh; (3) each chunk's gradients from h_c and dH_c alone; (4) dB,
    dC summed over a group's heads and dA over the chunks in order."""
    f = {k: torch.from_numpy(np.asarray(v)).double() for k, v in dict(
        x=x, dt=dt, B=B, C=C, dy=dy).items()}
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep, nc = H // G, -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # (Bz, S, H, ...) -> (Bz, H, nc, Q, ...), rows past S 0
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        t = t.reshape(Bz, nc, Q, *t.shape[2:])
        return t.movedim(3, 1)

    X, Y = chunks(f["x"]), chunks(f["dy"])
    dtc = chunks(f["dt"][..., None])[..., 0]
    Bc, Cc = (chunks(f[k].repeat_interleave(rep, 2)) for k in ("B", "C"))
    Ah = torch.as_tensor(np.asarray(A), dtype=torch.float64).reshape(
        -1, H).expand(Bz, H)[:, :, None, None]
    # (1) the chunk-local pass
    cum = torch.cumsum(dtc * Ah, -1)
    e = cum[..., -1]
    eend, ecum = torch.exp(e[..., None] - cum), torch.exp(cum)
    s_loc = torch.einsum("bhcs,bhcsp,bhcsn->bhcpn", eend * dtc, X, Bc)
    d_loc = torch.einsum("bhct,bhctp,bhctn->bhcpn", ecum, Y, Cc)
    # (2) the state walks
    h = torch.zeros_like(s_loc)
    dH = torch.zeros_like(d_loc)
    run = torch.zeros_like(s_loc[:, :, 0])
    for c in range(nc):
        h[:, :, c] = run
        run = torch.exp(e[:, :, c])[..., None, None] * run + s_loc[:, :, c]
    run = torch.zeros_like(run) if dh is None else \
        torch.from_numpy(np.asarray(dh)).double()
    for c in reversed(range(nc)):
        dH[:, :, c] = run
        run = torch.exp(e[:, :, c])[..., None, None] * run + d_loc[:, :, c]
    # (3) each chunk's gradients
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    L = torch.exp(torch.where(tril, cum[..., :, None] - cum[..., None, :],
                              torch.tensor(-torch.inf, dtype=torch.float64)))
    Gm = torch.einsum("bhctn,bhcsn->bhcts", Cc, Bc)
    Wm = torch.einsum("bhctp,bhcsp->bhcts", Y, X)
    GL, M = Gm * L, Wm * dtc[..., None, :] * L
    R = Gm * M
    f_ = torch.einsum("bhcsn,bhcpn->bhcsp", Bc, dH)
    du = torch.einsum("bhcts,bhctp->bhcsp", GL, Y) + eend[..., None] * f_
    hy = torch.einsum("bhctp,bhcpn->bhctn", Y, h)
    dC_h = torch.einsum("bhcts,bhcsn->bhctn", M, Bc) + ecum[..., None] * hy
    dB_h = torch.einsum("bhcts,bhctn->bhcsn", M, Cc) + (eend * dtc)[
        ..., None] * torch.einsum("bhcsp,bhcpn->bhcsn", X, dH)
    z = eend * dtc * (X * f_).sum(-1)
    dcum = R.sum(-1) - R.sum(-2) + ecum * (Cc * hy).sum(-1) - z
    dcum[..., -1] += z.sum(-1) + torch.exp(e) * (dH * h).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = Ah * da + (X * du).sum(-1)
    dA = torch.zeros((Bz, H), dtype=torch.float64)
    for c in range(nc):  # (4) dA in chunk order
        dA += (dtc[:, :, c] * da[:, :, c]).sum(-1)

    def unchunk(t):  # (Bz, H, nc, Q, ...) -> (Bz, S, H, ...)
        t = t.movedim(1, 3).reshape(Bz, nc * Q, H, *t.shape[4:])
        return t[:, :S]

    def group(t):  # (4) a group's heads summed, in head order
        t = unchunk(t).reshape(Bz, S, G, rep, N)
        out = t[:, :, :, 0]
        for k in range(1, rep):
            out = out + t[:, :, :, k]
        return out

    return [unchunk(dtc[..., None] * du).numpy(), unchunk(ddt[..., None])[
        ..., 0].numpy(), dA.numpy(), group(dB_h).numpy(),
        group(dC_h).numpy()]


# the kernel's chunk count past 8: 10 chunks of 64, the last ragged
LONG_CASE = ((1, 620, 2, 16, 1, 16), False, False)


@pytest.mark.parametrize("ref", ["jax_vjp", "plain"])
@pytest.mark.parametrize("state", [False, True], ids=["no_dstate",
                                                      "dstate"])
@pytest.mark.parametrize("case", CASES + [LONG_CASE], ids=str)
def test_four_passes_match_the_references(case, state, ref):
    """B10's decomposition in float64 against ``jax.vjp`` of the
    reference's chunked scan and against B10's plain version, each in
    float32: dx, ddt, dB, dC within ``GRAD_TOL`` relative L2, dA within
    ``DA_TOL``. With strong decay the exact dA is ~exp(-160): the float64
    one must be below 1e-30 of ddt's scale, and a reference's float32 dA,
    which is the rounding residue of differences of in-chunk cumsums
    (0 without the state's gradient; ~1.5e-4 with it, from B10's plain
    version), within one float32 ulp of the largest cumsum, 2^-23 x 64 x
    max(dt) x max|A| (~1.2e-3)."""
    shape, strong, _ = case
    x, dt, A, B, C, dy, dh = _inputs(*shape, strong=strong, seed=7)
    got = _four_passes(x, dt, A, B, C, dy, dh if state else None)
    got[2] = got[2].sum(0)  # A is the model's (nh,) vector over the batch
    if ref == "jax_vjp":
        want = _jax_grads(x, dt, A, B, C, dy,
                          dh if state else np.zeros_like(dh))
    else:
        want = _port_grads(x, dt, A, B, C, dy, dh, state=state)
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape, name
        if name == "dA" and strong:
            cum_max = 64 * float(dt.max()) * float(np.abs(A).max())
            assert np.abs(w).max() <= 2.0 ** -23 * cum_max
            assert np.abs(a).max() <= 1e-30 * np.abs(got[1]).max()
            continue
        tol = DA_TOL if name == "dA" else GRAD_TOL
        assert _rel(a, w) <= tol, (name, _rel(a, w))


def test_four_passes_match_float64_recurrence():
    """The decomposition against autograd of the sequential recurrence,
    both float64, over 10 chunks: every gradient within 1e-10 relative
    L2 -- the split into passes is exact algebra."""
    x, dt, A, B, C, dy, dh = _inputs(*LONG_CASE[0], seed=8)
    got = _four_passes(x, dt, A, B, C, dy, None)
    got[2] = got[2].sum(0)
    for name, a, w in zip(NAMES, got, _f64_grads(x, dt, A, B, C, dy)):
        assert _rel(a, w) <= 1e-10, (name, _rel(a, w))


def test_da_is_float32s_own_error():
    """dA of the port and of the reference, each against a float64
    recurrence: both within ``DA_TOL``, the port no further than twice the
    reference's distance; every other gradient within ``GRAD_TOL`` of
    float64."""
    x, dt, A, B, C, dy, dh = _inputs(1, 256, 2, 32, 1, 32)
    exact = _f64_grads(x, dt, A, B, C, dy)
    port = _port_grads(x, dt, A, B, C, dy, dh, state=False)
    ref = _jax_grads(x, dt, A, B, C, dy, np.zeros_like(dh))
    for name, p, r, e in zip(NAMES, port, ref, exact):
        if name == "dA":
            assert _rel(p, e) <= DA_TOL and _rel(r, e) <= DA_TOL
            assert _rel(p, e) <= 2 * _rel(r, e), (_rel(p, e), _rel(r, e))
        else:
            assert _rel(p, e) <= GRAD_TOL, name


def test_kernel_ssd_function_on_cpu_tensors_is_autograd():
    """``KernelSSD`` wired through the wrappers (B5 forward, B10 backward;
    their plain versions on CPU tensors) gives autograd's gradients of the
    plain scan bit for bit, the state's gradient included."""
    x, dt, A, B, C, dy, dh = _inputs(2, 100, 4, 16, 2, 16, seed=4)
    grads = {}
    for route in ("function", "autograd"):
        ts = [torch.from_numpy(t).requires_grad_() for t in (x, dt, A, B,
                                                             C)]
        args = (ts[0], ts[1], ts[2][None].expand(2, 4), ts[3], ts[4])
        y, h = KernelSSD.apply(*args) if route == "function" \
            else ssd_scan_plain(*args)
        torch.autograd.backward([y, h], [torch.from_numpy(dy),
                                         torch.from_numpy(dh)])
        grads[route] = [t.grad for t in ts]
    for a, b in zip(grads["function"], grads["autograd"]):
        assert torch.equal(a, b)


def test_wrapper_on_cpu_tensors_takes_the_plain_version():
    x, dt, A, B, C, dy, dh = (torch.from_numpy(t) for t in _inputs(
        1, 70, 2, 16, 1, 16, seed=5))
    A = A[None].expand(1, 2)
    launches, libs = ssd_scan_bwd.launches, dict(_build._LIBS)
    got = ssd_scan_bwd(x, dt, A, B, C, dy, dh)
    assert ssd_scan_bwd.launches == launches and _build._LIBS == libs
    want = ssd_scan_bwd_plain(x, dt, A, B, C, dy, dh)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [t.dtype for t in got] == [torch.float32] * 5
    assert got[2].shape == (1, 2) and got[3].shape == B.shape


@pytest.mark.parametrize("bad", ["dy_dtype", "dy_shape", "state_shape",
                                 "on_card"])
def test_wrapper_rejects_bad_arguments(bad):
    x, dt, A, B, C, dy, dh = (torch.from_numpy(t) for t in _inputs(
        1, 40, 2, 16, 1, 16))
    A = A[None].expand(1, 2)
    if bad == "on_card":
        with pytest.raises(ValueError, match="CPU tensors"):
            ssd_scan_bwd_plain(x.to("meta"), dt.to("meta"), A.to("meta"),
                               B.to("meta"), C.to("meta"), dy.to("meta"))
        return
    if bad == "dy_dtype":
        dy = dy.double()
    elif bad == "dy_shape":
        dy = dy[:, :-1]
    else:
        dh = dh[..., :-1]
    with pytest.raises(ValueError, match="dy|dstate"):
        ssd_scan_bwd(x, dt, A, B, C, dy, dh)
