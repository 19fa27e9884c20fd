"""The port's model against the JAX package's, on the CPU.

* configs: every arch name resolves, and the derived properties and the
  reduced configs equal the reference's;
* ``count_params`` (with and without ``active_only``) equals the
  reference's for every arch, full and reduced; MoE and MLA caches have
  the reference's structure (their numbers: ``test_torch_moe_mla.py``);
* reduced qwen-family archs and mamba2-780m: ``prefill_step`` and
  ``decode_step`` on the JAX package's own weights (carried across by
  ``params_from_numpy``), both sides in float32. Two layers of float32
  matmuls in another summation order: logits of size ~1 to 4 agree to
  1e-4 absolute (measured at most 2.3e-6 for qwen, 2.4e-6 for mamba2);
* decode-vs-forward consistency on the port alone (the check of
  ``tests/test_attention_equiv.py::test_decode_matches_forward``), for
  mamba2 also with prompts shorter than its conv (S = 1, 2), which the
  JAX server grafts into its cache left-aligned and cannot check;
* ``init_cache`` and ``params_from_numpy`` run on the card unless told
  otherwise, and raise without one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models.param import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.param import (  # noqa: E402
    cast_tree, init_params, tree_leaves)

DENSE_TEXT = ["qwen2.5-3b", "qwen2.5-14b", "qwen3-32b", "qwen1.5-4b"]
SSM = ["mamba2-780m"]
# the families whose forward runs since the hybrid, audio and vision slice
A7A = ["hymba-1.5b", "hubert-xlarge", "paligemma-3b"]
MOE = ["granite-moe-1b-a400m", "deepseek-v2-236b"]
ALL_ARCHS = DENSE_TEXT + SSM + A7A + MOE
LOGIT_ATOL = 1e-4  # float32 both sides; see the module docstring


def _ref_params(cfg, seed=0):
    """The JAX package's weights and the same numbers as a port tree."""
    p = ref_init_params(jreg.param_specs(cfg), jax.random.PRNGKey(seed))
    return p, params_from_numpy(jax.tree.map(np.asarray, p),
                                device="cpu")


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


# ------------------------------------------------------------------ configs

def test_every_arch_name_resolves():
    assert list_archs() == ref_list_archs()


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_and_reduced_configs_equal_the_reference(arch):
    for ours, ref in ((get_arch(arch), ref_get_arch(arch)),
                      (get_arch(arch).reduced(), ref_get_arch(arch).reduced())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        for prop in ("vocab_padded", "q_dim", "kv_dim", "is_attention_free",
                     "uses_full_attention_only"):
            assert getattr(ours, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_count_params_equals_the_reference(arch, reduced):
    ours, ref = get_arch(arch), ref_get_arch(arch)
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    assert registry.count_params(ours) == jreg.count_params(ref)
    assert ours.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_active_count_params_equals_the_reference(arch, reduced):
    """``active_only``: MoE counts top_k of its experts (and the shared
    ones); every other family counts everything."""
    ours, ref = get_arch(arch), ref_get_arch(arch)
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    got = registry.count_params(ours, active_only=True)
    assert got == jreg.count_params(ref, active_only=True)
    assert ours.active_param_count() == ref.active_param_count() == got
    if ours.moe is None:
        assert got == registry.count_params(ours)
    else:
        assert got < registry.count_params(ours)


def test_param_specs_carry_the_jax_tree_of_every_family():
    """The same leaf paths and shapes as the JAX package's trees, so
    ``params_from_numpy`` carries each family's weights across."""
    for arch in ALL_ARCHS:
        cfg, rcfg = get_arch(arch).reduced(), ref_get_arch(arch).reduced()
        ours = {p: s.shape for p, s in tree_leaves(registry.param_specs(cfg))}
        ref = {tuple(str(getattr(k, "key", k)) for k in path): leaf.shape
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jreg.param_specs(rcfg),
                   is_leaf=lambda x: hasattr(x, "shape"))[0]}
        assert ours == ref, arch


@pytest.mark.parametrize("arch", MOE)
def test_moe_and_mla_caches_have_the_reference_structure(arch):
    """``init_cache`` of the MoE archs (refused before ROADMAP A7b): the
    JAX package's entries and shapes -- granite's (k, v), deepseek's MLA
    latents (c, k_rope) stacked on its 1 MoE layer and ``dense0``'s
    unstacked -- zeroed, in the dtype asked for."""
    cfg, rcfg = get_arch(arch).reduced(), ref_get_arch(arch).reduced()
    cache = TM.init_cache(cfg, 2, 8, torch.float32, device="cpu")
    want = JM.init_cache(rcfg, 2, 8, dtype=jnp.float32)
    assert set(cache) == set(want) == ({"layers", "dense0"} if cfg.mla
                                       else {"layers"})
    for key in want:
        ours = jax.tree.leaves(cache[key])
        assert [tuple(t.shape) for t in ours] == \
            [t.shape for t in jax.tree.leaves(want[key])]
        assert all(t.dtype == torch.float32 and not t.any() for t in ours)


def test_init_cache_runs_on_the_card_unless_told(monkeypatch):
    cfg = get_arch("mamba2-780m").reduced()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(get_arch("qwen2.5-3b").reduced(), 1, 8)
    with pytest.raises(TypeError):  # device is keyword-only
        TM.init_cache(cfg, 1, 8, torch.float32, "cpu")
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    (cx, cB, cC), ssm = cache["layers"]
    ss = cfg.ssm
    W, GN = ss.conv_width, ss.n_groups * ss.d_state
    assert cx.shape == (cfg.n_layers, 2, W - 1, ss.d_inner(cfg.d_model))
    assert cB.shape == cC.shape == (cfg.n_layers, 2, W - 1, GN)
    assert cx.dtype == torch.bfloat16 and ssm.dtype == torch.float32
    assert ssm.shape == (cfg.n_layers, 2, ss.n_heads(cfg.d_model),
                         ss.head_dim, ss.d_state)


def test_params_from_numpy_runs_on_the_card_unless_told(monkeypatch):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "sub": {"ids": np.arange(4, dtype=np.int32)}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree)
    with pytest.raises(TypeError):  # device and dtype are keyword-only
        params_from_numpy(tree, "cpu", torch.bfloat16)
    got = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.bfloat16
    assert got["w"].tolist() == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]]
    assert got["sub"]["ids"].dtype == torch.int32
    assert got["sub"]["ids"].tolist() == [0, 1, 2, 3]


def test_init_params_follows_the_fan_in_rule():
    cfg = get_arch("qwen2.5-3b").reduced()
    specs = registry.param_specs(cfg)
    a = init_params(specs, torch.Generator().manual_seed(1), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(1), "cpu")
    ref = ref_init_params(jreg.param_specs(get_arch("qwen2.5-3b").reduced()),
                          jax.random.PRNGKey(1))
    ref_leaves = dict(tree_leaves(jax.tree.map(np.asarray, ref)))
    for path, s in tree_leaves(specs):
        x = dict(tree_leaves(a))[path]
        assert torch.equal(x, dict(tree_leaves(b))[path])  # seeded
        assert tuple(x.shape) == s.shape == ref_leaves[path].shape
        assert x.dtype == torch.float32
        if s.init == "normal":
            std = 1.0 / np.sqrt(s.shape[-2] if len(s.shape) >= 2
                                else s.shape[-1])
            assert abs(float(x.std()) / std - 1.0) < 0.1, path
        else:
            assert torch.equal(x, torch.full_like(
                x, 1.0 if s.init == "ones" else 0.0))


def test_ssd_init_kinds_follow_the_reference():
    """A_log = log(1 + 15 u) lies in [log 1, log 16]; the "small_normal"
    leaves are the fan-in-scaled normal with init_scale 0.5 (the JAX
    package has no branch of its own for them)."""
    cfg = get_arch("mamba2-780m").reduced()
    specs = registry.param_specs(cfg)
    p = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    a_log = p["layers"]["ssd"]["A_log"]
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= np.log(16.0)
    assert float(a_log.std()) > 0.3  # drawn, not a constant
    leaves = dict(tree_leaves(p))
    pooled = []
    for path, s in tree_leaves(specs):
        if s.init == "small_normal":
            assert s.init_scale == 0.5
            pooled.append(leaves[path].flatten() / (0.5 / np.sqrt(
                s.shape[-2])))
    assert len(pooled) == 3  # conv_x, conv_B, conv_C
    assert abs(float(torch.cat(pooled).std()) - 1.0) < 0.1


def test_init_params_leaves_no_reference_cycle():
    """The float32 tree a server casts to bf16 must be freed when it is
    dropped, not at the next garbage collection: at full width it is
    12 GB of device memory."""
    import gc
    import weakref
    cfg = get_arch("qwen2.5-3b").reduced()
    gc.disable()
    try:
        p = init_params(registry.param_specs(cfg),
                        torch.Generator().manual_seed(0), "cpu")
        leaf = weakref.ref(p["layers"]["attn"]["wq"])
        half = cast_tree(p, torch.bfloat16)
        del p
        assert leaf() is None
        assert half["layers"]["attn"]["wq"].dtype == torch.bfloat16
    finally:
        gc.enable()


def test_cast_tree_copies_only_what_changes():
    t = {"w": torch.ones(3), "i": torch.arange(3)}
    same = cast_tree(t, torch.float32)
    assert same["w"] is t["w"] and same["i"] is t["i"]
    half = cast_tree(t, torch.bfloat16)
    assert half["w"].dtype == torch.bfloat16 and half["i"] is t["i"]


# --------------------------------------------------------------- primitives

def test_rms_norm_and_rope_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 7, 4, 16)).astype(
        np.float32)
    w = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    pos = np.arange(7)
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           1e6).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5)


# ------------------------------------------------- the reduced model vs JAX

@pytest.mark.parametrize("arch", DENSE_TEXT)
def test_prefill_and_decode_match_the_jax_model(arch):
    cfg = get_arch(arch).reduced()
    rcfg = ref_get_arch(arch).reduced()
    jp, tp = _ref_params(rcfg, seed=3)
    B, S, smax = 2, 12, 20
    toks = _tokens(4, B, S + 3, cfg.vocab_size)

    want, jcache = JM.prefill_step(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                   rcfg, dtype=jnp.float32)
    cache = TM.init_cache(cfg, B, smax, torch.float32, device="cpu")
    got, cache = TM.prefill_step(tp, {"tokens": torch.from_numpy(
        toks[:, :S]).long()}, cfg, dtype=torch.float32, cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    for ours, ref in zip(cache["layers"], jcache["layers"]):
        np.testing.assert_allclose(ours[:, :, :S].numpy(), np.asarray(ref),
                                   atol=LOGIT_ATOL)
        assert not ours[:, :, S:].any()

    full = JM.init_cache(rcfg, B, smax, dtype=jnp.float32)
    jcache = jax.tree.map(
        lambda dst, src: jax.lax.dynamic_update_slice_in_dim(
            dst, src.astype(dst.dtype), 0, axis=2), full, jcache)
    for t in range(3):
        batch_j = {"tokens": jnp.asarray(toks[:, S + t:S + t + 1]),
                   "cache_len": jnp.int32(S + t)}
        want, jcache = JM.decode_step(jp, jcache, batch_j, rcfg,
                                      dtype=jnp.float32)
        batch_t = {"tokens": torch.from_numpy(
            toks[:, S + t:S + t + 1]).long(), "cache_len": S + t}
        got, cache = TM.decode_step(tp, cache, batch_t, cfg,
                                    dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("S", [12, 40])
def test_ssm_prefill_and_decode_match_the_jax_model(S):
    """Reduced mamba2-780m: the prompt's logits, every cache entry (conv
    tails, states) and three decode steps against the JAX model on its
    own weights, float32 (S = 40 is one chunk of 40 on both sides; S =
    12 one of 12)."""
    cfg = get_arch("mamba2-780m").reduced()
    rcfg = ref_get_arch("mamba2-780m").reduced()
    jp, tp = _ref_params(rcfg, seed=3)
    B = 2
    toks = _tokens(S, B, S + 3, cfg.vocab_size)
    want, jcache = JM.prefill_step(jp, {"tokens": jnp.asarray(toks[:, :S])},
                                   rcfg, dtype=jnp.float32)
    cache = TM.init_cache(cfg, B, S + 8, torch.float32, device="cpu")
    got, same = TM.prefill_step(tp, {"tokens": torch.from_numpy(
        toks[:, :S]).long()}, cfg, dtype=torch.float32, cache=cache)
    assert same is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)
    ours, theirs = jax.tree.leaves(cache["layers"]), \
        jax.tree.leaves(jcache["layers"])
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=LOGIT_ATOL)
    for t in range(3):
        batch_j = {"tokens": jnp.asarray(toks[:, S + t:S + t + 1]),
                   "cache_len": jnp.int32(S + t)}
        want, jcache = JM.decode_step(jp, jcache, batch_j, rcfg,
                                      dtype=jnp.float32)
        batch_t = {"tokens": torch.from_numpy(
            toks[:, S + t:S + t + 1]).long(), "cache_len": S + t}
        got, cache = TM.decode_step(tp, cache, batch_t, cfg,
                                    dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL)


def test_forward_matches_the_jax_model():
    cfg = get_arch("qwen2.5-3b").reduced()
    jp, tp = _ref_params(ref_get_arch("qwen2.5-3b").reduced(), seed=5)
    toks = _tokens(6, 2, 30, cfg.vocab_size)
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)},
                         ref_get_arch("qwen2.5-3b").reduced(),
                         dtype=jnp.float32)
    got, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks).long()}, cfg,
                          dtype=torch.float32)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL)


# ----------------------------------------------- consistency, port alone

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-32b", "qwen1.5-4b",
                                  "mamba2-780m"])
def test_decode_matches_forward(arch):
    """prefill(S) + decode steps == forward(S + n) at the same positions
    (float32; both paths run the same float32 arithmetic in another
    order). Post-softmax distributions compared, as the reference's
    test does, at its 2e-3."""
    cfg = get_arch(arch).reduced()
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(9), "cpu")
    B, S, n = 2, 24, 3
    toks = torch.from_numpy(_tokens(9, B, S + n, cfg.vocab_size)).long()
    want, _ = TM.forward(params, {"tokens": toks}, cfg, dtype=torch.float32)
    cache = TM.init_cache(cfg, B, S + n + 4, torch.float32, device="cpu")
    _, cache = TM.prefill_step(params, {"tokens": toks[:, :S]}, cfg,
                               dtype=torch.float32, cache=cache)
    for t in range(n):
        got, cache = TM.decode_step(
            params, cache, {"tokens": toks[:, S + t:S + t + 1],
                            "cache_len": S + t}, cfg, dtype=torch.float32)
        torch.testing.assert_close(got[:, 0].softmax(-1),
                                   want[:, S + t].softmax(-1), atol=2e-3,
                                   rtol=0)


@pytest.mark.parametrize("S", [1, 2])
def test_ssm_short_prompts_decode_matches_forward(S):
    """A prompt shorter than the conv's W-1 = 3 rows: the port keeps the
    tail right-aligned behind zeros, so the decode steps see the same
    window as a forward over the whole sequence (the JAX server's graft
    would not; ROADMAP Queue C)."""
    cfg = get_arch("mamba2-780m").reduced()
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(S), "cpu")
    B, n = 2, 4
    toks = torch.from_numpy(_tokens(S + 20, B, S + n, cfg.vocab_size)).long()
    want, _ = TM.forward(params, {"tokens": toks}, cfg, dtype=torch.float32)
    cache = TM.init_cache(cfg, B, S + n + 1, torch.float32, device="cpu")
    got, cache = TM.prefill_step(params, {"tokens": toks[:, :S]}, cfg,
                                 dtype=torch.float32, cache=cache)
    torch.testing.assert_close(got[:, 0], want[:, S - 1], atol=LOGIT_ATOL,
                               rtol=0)
    for t in range(n):
        got, cache = TM.decode_step(
            params, cache, {"tokens": toks[:, S + t:S + t + 1],
                            "cache_len": S + t}, cfg, dtype=torch.float32)
        torch.testing.assert_close(got[:, 0], want[:, S + t],
                                   atol=LOGIT_ATOL, rtol=0)


def test_ssm_prefill_without_a_cache_returns_tails_and_states():
    cfg = get_arch("mamba2-780m").reduced()
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(4), "cpu")
    toks = torch.from_numpy(_tokens(4, 2, 9, cfg.vocab_size)).long()
    last, cache = TM.prefill_step(params, {"tokens": toks}, cfg)
    (cx, cB, cC), ssm = cache["layers"]
    ss = cfg.ssm
    assert last.shape == (2, 1, cfg.vocab_padded)
    assert cx.shape == (cfg.n_layers, 2, ss.conv_width - 1,
                        ss.d_inner(cfg.d_model))
    assert ssm.shape == (cfg.n_layers, 2, ss.n_heads(cfg.d_model),
                         ss.head_dim, ss.d_state)
    assert cx.dtype == torch.bfloat16 and ssm.dtype == torch.float32
    given = TM.init_cache(cfg, 2, 16, device="cpu")
    _, given = TM.prefill_step(params, {"tokens": toks}, cfg, cache=given)
    for a, b in zip(jax.tree.leaves(cache["layers"]),
                    jax.tree.leaves(given["layers"])):
        assert torch.equal(a, b)


def test_prefill_without_a_cache_returns_the_prompt_kv():
    cfg = get_arch("qwen2.5-3b").reduced()
    params = init_params(registry.param_specs(cfg),
                         torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(_tokens(2, 2, 9, cfg.vocab_size)).long()
    last, cache = TM.prefill_step(params, {"tokens": toks}, cfg)
    k, v = cache["layers"]
    assert last.shape == (2, 1, cfg.vocab_padded)
    assert k.shape == v.shape == (cfg.n_layers, 2, 9, cfg.n_kv_heads,
                                  cfg.head_dim)
    assert k.dtype == torch.bfloat16
