"""The port's AdamW and synthetic data against the JAX package's, on the
CPU.

* ``tests/test_optim_data.py``'s checks, on the port: AdamW against the
  same numpy reference (atol 1e-5, as there), clipping, the cosine
  schedule, batch determinism, shifted labels, tokens in the vocabulary;
* ``adamw_update`` against ``repro.optim.adamw.adamw_update`` on the same
  seeded trees, 3 steps, float32 and bf16 moments: parameters within 2
  float32 ulps of 1, moments within 2 ulps of their leaf's largest
  (float32; one bf16 rounding, 2^-8, for bf16 moments), the learning
  rate and the norm within 1e-6 relative (measured at float32: params
  6.0e-8 absolute, moments 2.3e-7 of their leaf's largest (1.4e-2), lr
  and norm 8.9e-8);
* the in-place update chunked along the stacked axis gives the same bits
  as the whole-leaf update;
* ``SyntheticDataset`` and ``make_batch`` numbers equal the reference's
  bit for bit; as tensors the tokens are int64 with the same values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data.pipeline import SyntheticDataset as RefDataset  # noqa: E402
from repro.data.specs import make_batch as ref_make_batch  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticDataset  # noqa: E402
from repro_torch.data.specs import batch_specs, make_batch  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update, chunks, cosine_lr)

ULP_TOL = 2.4e-7  # two float32 ulps of 1


def _np_adamw(p, g, m, v, step, cfg: AdamWConfig, gnorm):
    scale = min(1.0, cfg.clip_norm / max(gnorm, 1e-9))
    g = g * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    c1 = 1 - cfg.b1 ** step
    c2 = 1 - cfg.b2 ** step
    delta = (m / c1) / (np.sqrt(v / c2) + cfg.eps)
    if p.ndim >= 2:
        delta = delta + cfg.weight_decay * p
    lr = float(cosine_lr(cfg, torch.tensor(step)))
    return p - lr * delta, m, v


def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=0, total_steps=100,
                      weight_decay=0.01)
    rng = np.random.default_rng(0)
    p = {"w": torch.tensor(rng.standard_normal((4, 3)), dtype=torch.float32),
         "b": torch.tensor(rng.standard_normal((3,)), dtype=torch.float32)}
    opt = adamw_init(p, cfg)
    m = {k: np.zeros(tuple(v.shape)) for k, v in p.items()}
    v_ = {k: np.zeros(tuple(v.shape)) for k, v in p.items()}
    pn = {k: x.numpy().copy() for k, x in p.items()}
    for step in range(1, 4):
        g = {k: torch.tensor(rng.standard_normal(tuple(x.shape)),
                             dtype=torch.float32) for k, x in p.items()}
        p, opt, metrics = adamw_update(g, opt, p, cfg)
        gnorm = float(np.sqrt(sum((x.numpy() ** 2).sum()
                                  for x in g.values())))
        for k in pn:
            pn[k], m[k], v_[k] = _np_adamw(
                pn[k], g[k].numpy(), m[k], v_[k], step, cfg, gnorm)
        for k in pn:
            np.testing.assert_allclose(p[k].numpy(), pn[k], atol=1e-5)


def test_grad_clipping_effective():
    cfg = AdamWConfig(lr_peak=1.0, warmup_steps=0, clip_norm=1.0,
                      weight_decay=0.0)
    p = {"w": torch.zeros((4,))}
    opt = adamw_init(p, cfg)
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = adamw_update(g, opt, p, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr_peak=1.0, warmup_steps=10, total_steps=110)
    lrs = [float(cosine_lr(cfg, torch.tensor(s))) for s in
           (0, 5, 10, 60, 110)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1)  # floor at 10% of peak


@pytest.mark.parametrize("step", [0, 1, 5, 10, 60, 109, 110, 500])
def test_cosine_lr_equals_the_reference(step):
    kw = dict(lr_peak=3e-4, warmup_steps=10, total_steps=110)
    got = float(cosine_lr(AdamWConfig(**kw), torch.tensor(step)))
    want = float(ref_adamw.cosine_lr(ref_adamw.AdamWConfig(**kw),
                                     jnp.asarray(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def _trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "layers": {"w": (3, 8, 5), "b": (3, 5)},
              "norm": (8,)}

    def draw(s, scale=1.0):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return shapes, draw


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], (*prefix, k))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_update_equals_the_reference(moment):
    shapes, draw = _trees(1)
    p0 = draw(shapes)
    kw = dict(lr_peak=1e-2, warmup_steps=1, total_steps=20,
              weight_decay=0.1, clip_norm=0.5)
    jcfg = ref_adamw.AdamWConfig(**kw, moment_dtype=getattr(jnp, moment))
    tcfg = AdamWConfig(**kw, moment_dtype=getattr(torch, moment))
    jp = jax.tree.map(jnp.asarray, p0)
    tp = jax.tree.map(torch.tensor, p0)
    jopt, topt = ref_adamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for _ in range(3):
        g = draw(shapes, 0.3)
        jp, jopt, jm = ref_adamw.adamw_update(jax.tree.map(jnp.asarray, g),
                                              jopt, jp, jcfg)
        tp, topt, tm = adamw_update(jax.tree.map(torch.tensor, g), topt,
                                    tp, tcfg)
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        tol = ULP_TOL if moment == "float32" else 2 ** -8
        for a, b in zip(_flat(jp), _flat(jax.tree.map(
                lambda t: t.float().numpy(), tp))):
            assert a[0] == b[0]
            np.testing.assert_allclose(b[1], a[1], rtol=tol, atol=tol)
        for key in ("m", "v"):
            for a, b in zip(_flat(jopt[key]), _flat(jax.tree.map(
                    lambda t: t.float().numpy(), topt[key]))):
                np.testing.assert_allclose(b[1], a[1], rtol=tol,
                                           atol=tol * np.abs(a[1]).max())
    assert int(topt["step"]) == int(jopt["step"]) == 3


@pytest.mark.parametrize("max_elems", [1, 40, 41, 79])
def test_chunked_update_gives_the_whole_leaf_bits(max_elems):
    """The in-place update in chunks of the stacked axis (one row, or
    several) equals the whole-leaf update bit for bit."""
    shapes, draw = _trees(2)
    p0 = draw(shapes)
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=20,
                      clip_norm=0.5)
    runs = []
    for chunk in (None, max_elems):
        p = jax.tree.map(torch.tensor, p0)
        opt = adamw_init(p, cfg)
        rng = np.random.default_rng(3)
        for _ in range(3):
            g = jax.tree.map(
                lambda a: torch.tensor(rng.standard_normal(a.shape)
                                       .astype(np.float32)), p0)
            p, opt, _ = adamw_update(g, opt, p, cfg, max_chunk_elems=chunk)
        runs.append((p, opt))
    (pa, oa), (pb, ob) = runs
    for tree_a, tree_b in ((pa, pb), (oa["m"], ob["m"]), (oa["v"], ob["v"])):
        for (ka, a), (kb, b) in zip(_flat(jax.tree.map(
                lambda t: t.numpy(), tree_a)), _flat(jax.tree.map(
                lambda t: t.numpy(), tree_b))):
            assert ka == kb
            np.testing.assert_array_equal(a, b)
    parts = list(chunks(torch.zeros((3, 8, 5)), max_elems))
    assert [t.shape[0] for t in parts] == \
        ([1, 1, 1] if max_elems < 80 else [2, 1])


@pytest.mark.parametrize("flat", [1, 7, 64])
def test_cpu_flat_chunks_give_the_whole_leaf_bits(flat, monkeypatch):
    """On the CPU a contiguous leaf is updated in chunks of its flat
    elements (``CPU_CHUNK_ELEMS``, here a few elements, so that chunks
    cross the rows): the bits of the whole-leaf update, params and both
    moments, in both moment dtypes."""
    import repro_torch.optim.adamw as adamw_mod
    shapes, draw = _trees(4)
    p0 = draw(shapes)
    for moment in (torch.float32, torch.bfloat16):
        cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=1, total_steps=20,
                          clip_norm=0.5, moment_dtype=moment)
        runs = []
        for whole in (True, False):
            monkeypatch.setattr(adamw_mod, "CPU_CHUNK_ELEMS", flat)
            p = jax.tree.map(torch.tensor, p0)
            opt = adamw_init(p, cfg)
            rng = np.random.default_rng(5)
            for _ in range(3):
                g = jax.tree.map(
                    lambda a: torch.tensor(rng.standard_normal(a.shape)
                                           .astype(np.float32)), p0)
                p, opt, _ = adamw_update(
                    g, opt, p, cfg, **({"max_chunk_elems": None}
                                       if whole else {}))
            runs.append([t for tree in (p, opt["m"], opt["v"])
                         for _, t in _flat(jax.tree.map(
                             lambda t: t.float().numpy(), tree))])
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_train_state_from_numpy_takes_broadcast_leaves(moment):
    """Zero moments handed over as ``np.broadcast_to`` views (no memory
    of their own) give the state dense zeros give, each leaf a dense
    tensor of its own (m and v share no memory)."""
    from repro_torch.convert import train_state_from_numpy
    shapes, draw = _trees(6)
    p = jax.tree.map(np.asarray, draw(shapes))
    dense = jax.tree.map(np.zeros_like, p)
    flat = jax.tree.map(lambda a: np.broadcast_to(np.zeros((), a.dtype),
                                                  a.shape), p)
    dt = getattr(torch, moment)
    states = [train_state_from_numpy(
        {"params": p, "opt_state": {"m": z, "v": z, "step": 0}, "step": 0},
        device="cpu", moment_dtype=dt) for z in (dense, flat)]
    for key in ("m", "v"):
        for (ka, a), (kb, b) in zip(_flat(jax.tree.map(
                lambda t: t.float().numpy(), states[0].opt_state[key])),
                _flat(jax.tree.map(lambda t: t.float().numpy(),
                                   states[1].opt_state[key]))):
            assert ka == kb
            np.testing.assert_array_equal(a, b)
    m, v = states[1].opt_state["m"], states[1].opt_state["v"]
    leaves = jax.tree.leaves(m)
    assert all(t.dtype == dt and t.is_contiguous() for t in leaves)
    jax.tree.map(lambda t: t.add_(1), m)
    assert all(float(t.abs().sum()) == 0.0 for t in jax.tree.leaves(v))


# ------------------------------------------------------------------ data
def test_batch_determinism():
    cfg = get_arch("qwen2.5-3b").reduced()
    shape = ShapeConfig("t", 16, 2, "train")
    d1 = SyntheticDataset(cfg, shape, seed=4, device="cpu")
    d2 = SyntheticDataset(cfg, shape, seed=4, device="cpu")
    b1, b2 = d1.batch(11), d2.batch(11)
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    b3 = d1.batch(12)
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_labels_are_shifted_tokens():
    cfg = get_arch("qwen2.5-3b").reduced()
    shape = ShapeConfig("t", 16, 2, "train")
    b = SyntheticDataset(cfg, shape, seed=1, device="cpu").batch(0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["tokens"].dtype == torch.int64


@pytest.mark.parametrize("step", [0, 7, 10_000])
def test_tokens_in_vocab(step):
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    shape = ShapeConfig("t", 8, 2, "train")
    t = SyntheticDataset(cfg, shape, seed=0, device="cpu").batch(step)[
        "tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch,kind", [("qwen2.5-3b", "train"),
                                       ("mamba2-780m", "train"),
                                       ("qwen2.5-3b", "prefill"),
                                       ("qwen2.5-3b", "decode"),
                                       ("paligemma-3b", "train"),
                                       ("hubert-xlarge", "train")])
@pytest.mark.parametrize("step", [0, 3])
def test_dataset_equals_the_reference_bit_for_bit(arch, kind, step):
    shape = ShapeConfig("t", 24, 4, kind)
    ref = RefDataset(ref_get_arch(arch).reduced(),
                     RefShape("t", 24, 4, kind), seed=5).batch(step)
    ds = SyntheticDataset(get_arch(arch).reduced(), shape, seed=5,
                          device="cpu")
    arrays, tensors = ds.arrays(step), ds.batch(step)
    assert set(arrays) == set(ref) == set(tensors)
    specs = batch_specs(get_arch(arch).reduced(), shape)
    for k, want in ref.items():
        want = np.asarray(want)
        got = arrays[k]
        if want.dtype == np.int32:
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(tensors[k].numpy(), want)
        else:  # float32 draws; the reference rounds them to bf16
            np.testing.assert_array_equal(
                torch.from_numpy(got).to(specs[k].dtype).float().numpy(),
                np.asarray(want, np.float32))
            assert tensors[k].dtype == specs[k].dtype
        assert tuple(specs[k].shape) == want.shape


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "paligemma-3b"])
def test_make_batch_equals_the_reference_bit_for_bit(arch):
    shape = ShapeConfig("t", 12, 2, "train")
    ref = ref_make_batch(ref_get_arch(arch).reduced(),
                         RefShape("t", 12, 2, "train"), seed=9)
    batch = make_batch(get_arch(arch).reduced(), shape, seed=9,
                       device="cpu")
    assert set(batch) == set(ref)
    for k, want in ref.items():
        got = batch[k]
        if got.is_floating_point():  # bf16 both sides, compared widened
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        else:
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_batch_and_dataset_default_to_the_card():
    cfg = get_arch("qwen2.5-3b").reduced()
    shape = ShapeConfig("t", 8, 2, "train")
    if torch.cuda.is_available():
        assert make_batch(cfg, shape)["tokens"].device.type == "cuda"
        assert SyntheticDataset(cfg, shape).batch(0)["tokens"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(cfg, shape)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticDataset(cfg, shape).batch(0)
