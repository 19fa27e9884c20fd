"""The hybrid, vision and audio families of the port against the JAX
package's model, on the CPU.

* hymba-1.5b cut to 5 layers (``reduced()`` has 2 layers and 3 global
  ones, so every layer would be global; at 5 the global layers are 0, 2
  and 4, and 1 and 3 slide over a window of 16), prompts longer than the
  window: ``prefill_step`` with the cache (the attention K/V, the SSD
  conv tails and states) and decode steps past the window;
* paligemma-3b reduced: 4 projected patch embeddings before the text, a
  bidirectional prefix over them, the text embedding scaled by
  ``sqrt(d_model)``; prefill and decode steps with the image in cache
  slots ``[0, 4)``;
* hubert-xlarge reduced: the encoder's forward over projected frames
  plus the sinusoidal table, bidirectional attention, the plain MLP;
* ``loss_fn`` of all three (paligemma's image positions carry no labels);
* decode against the port's own forward for hymba and paligemma;
* MoE and MLA, which raised here before they were ported, run at the
  entry points with the reference's shapes (``test_torch_moe_mla.py``
  holds them to the reference's numbers).

Both sides run in float32 on the JAX package's own weights (carried
across by ``params_from_numpy``): two to five layers of float32 matmuls
in another summation order, logits of size ~1 to 4 agree to 1e-4
absolute (measured at most 3e-6).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.param import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa
from repro_torch.kernels.flash_attention import flash_attention  # noqa
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param import init_params  # noqa: E402

LOGIT_ATOL = 1e-4  # float32 both sides; see the module docstring


def _cfgs(arch, **kw):
    """The port's and the JAX package's reduced config, cut alike."""
    return (dataclasses.replace(get_arch(arch).reduced(), **kw),
            dataclasses.replace(ref_get_arch(arch).reduced(), **kw))


HYMBA = dict(n_layers=5)


def _ref_params(rcfg, seed):
    p = ref_init_params(jreg.param_specs(rcfg), jax.random.PRNGKey(seed))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")


def _rng(seed):
    return np.random.default_rng(seed)


def _batches(cfg, B, S, seed):
    """The same batch for both packages: numpy, then jnp and torch."""
    g = _rng(seed)
    np_b = {}
    if cfg.frontend == "audio":
        np_b["frames"] = g.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    else:
        np_b["tokens"] = g.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)
    if cfg.frontend == "vision":
        np_b["patches"] = g.standard_normal(
            (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in np_b.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in np_b.items()}
    return jb, tb


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               atol=atol, rtol=0)


def test_reduced_hymba_cut_to_five_layers_has_sliding_layers():
    """The trap the cut avoids: at 2 layers every layer is global."""
    cfg, _ = _cfgs("hymba-1.5b", **HYMBA)
    assert registry.global_layer_indices(get_arch("hymba-1.5b").reduced()) \
        == [0, 1]
    assert registry.global_layer_indices(cfg) == [0, 2, 4]
    assert registry.window_array(cfg, 40).tolist() == [57, 16, 57, 16, 57]


@pytest.mark.parametrize("arch,kw,S", [("hymba-1.5b", HYMBA, 40),
                                       ("hymba-1.5b", HYMBA, 17),
                                       ("paligemma-3b", {}, 12),
                                       ("paligemma-3b", {}, 30)],
                         ids=["hymba-S40", "hymba-S17", "vlm-S12",
                              "vlm-S30"])
def test_prefill_and_decode_match_the_jax_model(arch, kw, S):
    """The prompt's last logits and the cache, then decode steps with the
    JAX cache grafted into max-seq slots as the JAX server does (hymba's
    sliding layers see the window move past the first slots)."""
    cfg, rcfg = _cfgs(arch, **kw)
    jp, tp = _ref_params(rcfg, seed=3)
    B, n = 2, 8
    n_img = cfg.frontend_seq
    jb, tb = _batches(cfg, B, S, seed=S)
    toks = _rng(S + 1).integers(0, cfg.vocab_size, (B, n), dtype=np.int32)
    smax = n_img + S + n + 2

    want, jcache = JM.prefill_step(jp, jb, rcfg, dtype=jnp.float32)
    cache = TM.init_cache(cfg, B, smax, torch.float32, device="cpu")
    got, same = TM.prefill_step(tp, tb, cfg, dtype=torch.float32,
                                cache=cache)
    assert same is cache
    _close(got, want)
    ours = jax.tree.leaves(cache["layers"])
    theirs = jax.tree.leaves(jcache["layers"])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        if a.shape != b.shape:  # a KV cache: the prompt's slots, then 0
            assert a.shape[2] == smax and b.shape[2] == n_img + S
            assert not a[:, :, n_img + S:].any()
            a = a[:, :, :n_img + S]
        _close(a, b)

    jdecode = jax.jit(lambda p, c, b: JM.decode_step(p, c, b, rcfg,
                                                    dtype=jnp.float32))
    full = JM.init_cache(rcfg, B, smax, dtype=jnp.float32)
    jcache = jax.tree.map(
        lambda dst, src: src.astype(dst.dtype) if dst.shape == src.shape
        else jax.lax.dynamic_update_slice_in_dim(
            dst, src.astype(dst.dtype), 0, axis=2), full, jcache)
    for t in range(n):
        clen = n_img + S + t
        want, jcache = jdecode(
            jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                         "cache_len": jnp.int32(clen)})
        got, cache = TM.decode_step(
            tp, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long(),
                        "cache_len": clen}, cfg, dtype=torch.float32)
        _close(got, want)


@pytest.mark.parametrize("S", [24, 50])
def test_audio_encoder_forward_matches_the_jax_model(S):
    cfg, rcfg = _cfgs("hubert-xlarge")
    jp, tp = _ref_params(rcfg, seed=5)
    jb, tb = _batches(cfg, 2, S, seed=S)
    want, _ = JM.forward(jp, jb, rcfg, dtype=jnp.float32)
    with torch.no_grad():
        got, aux = TM.forward(tp, tb, cfg, dtype=torch.float32)
    assert float(aux) == 0.0 and got.shape == (2, S, cfg.vocab_padded)
    _close(got, want)


@pytest.mark.parametrize("arch,kw", [("hymba-1.5b", HYMBA),
                                     ("paligemma-3b", {}),
                                     ("hubert-xlarge", {})],
                         ids=["hymba", "vlm", "audio"])
def test_forward_and_loss_match_the_jax_model(arch, kw):
    """The whole-sequence forward and ``loss_fn`` (cross-entropy, z-loss,
    paligemma's image positions dropped), float32."""
    cfg, rcfg = _cfgs(arch, **kw)
    jp, tp = _ref_params(rcfg, seed=7)
    B, S = 2, 36
    jb, tb = _batches(cfg, B, S, seed=11)
    labels = _rng(12).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(
        labels).long()
    want, _ = JM.forward(jp, jb, rcfg, dtype=jnp.float32)
    got, _ = TM.forward(tp, tb, cfg, dtype=torch.float32)
    _close(got, want)
    (jl, jm) = JM.loss_fn(jp, jb, rcfg, dtype=jnp.float32)
    (tl, tm) = TM.loss_fn(tp, tb, cfg, dtype=torch.float32)
    for k in ("loss", "ce", "z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("arch,kw", [("hymba-1.5b", HYMBA),
                                     ("paligemma-3b", {})],
                         ids=["hymba", "vlm"])
def test_decode_matches_forward(arch, kw):
    """prefill(S) + decode steps == forward(S + n) at the same positions,
    on the port alone (the check of
    ``tests/test_attention_equiv.py::test_decode_matches_forward``), past
    hymba's window; post-softmax distributions at its 2e-3."""
    cfg, _ = _cfgs(arch, **kw)
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(9), "cpu")
    B, S, n = 2, 20, 6
    _, tb = _batches(cfg, B, S + n, seed=9)
    want, _ = TM.forward(params, tb, cfg, dtype=torch.float32)
    n_img = cfg.frontend_seq
    cache = TM.init_cache(cfg, B, n_img + S + n + 2, torch.float32,
                          device="cpu")
    pb = dict(tb, tokens=tb["tokens"][:, :S])
    _, cache = TM.prefill_step(params, pb, cfg, dtype=torch.float32,
                               cache=cache)
    for t in range(n):
        got, cache = TM.decode_step(
            params, cache, {"tokens": tb["tokens"][:, S + t:S + t + 1],
                            "cache_len": n_img + S + t}, cfg,
            dtype=torch.float32)
        torch.testing.assert_close(got[:, 0].softmax(-1),
                                   want[:, n_img + S + t].softmax(-1),
                                   atol=2e-3, rtol=0)


def test_cpu_forward_launches_no_kernel():
    cfg, _ = _cfgs("hymba-1.5b", **HYMBA)
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(1), "cpu")
    _, tb = _batches(cfg, 1, 24, seed=1)
    before = (flash_attention.launches, decode_attention.launches)
    TM.prefill_step(params, tb, cfg)
    assert (flash_attention.launches, decode_attention.launches) == before


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-236b"])
def test_moe_and_mla_run_at_the_entry_points(arch):
    """MoE and MLA (refused before ROADMAP A7b) run at ``forward``,
    ``init_cache``, ``prefill_step`` and ``decode_step``, with the JAX
    package's shapes; the aux loss is a positive float32 scalar."""
    cfg, rcfg = _cfgs(arch)
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    logits, aux = TM.forward(params, {"tokens": tokens}, cfg)
    assert logits.shape == (1, 4, cfg.vocab_padded)
    assert aux.shape == () and aux.dtype == torch.float32 and float(aux) > 0
    cache = TM.init_cache(cfg, 1, 8, device="cpu")
    want = JM.init_cache(rcfg, 1, 8)
    assert set(cache) == set(want)
    for key in want:
        assert [tuple(t.shape) for t in jax.tree.leaves(cache[key])] == \
            [t.shape for t in jax.tree.leaves(want[key])]
    last, cache = TM.prefill_step(params, {"tokens": tokens}, cfg,
                                  cache=cache)
    assert last.shape == (1, 1, cfg.vocab_padded)
    step, _ = TM.decode_step(params, cache, {"tokens": tokens[:, :1],
                                             "cache_len": 4}, cfg)
    assert step.shape == (1, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(step.float()).all())
