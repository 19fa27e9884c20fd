"""The port's batched server against the JAX package's, on the CPU.

Both servers run the reduced qwen2.5-3b, mamba2-780m, hymba-1.5b or
paligemma-3b (behind its 4 zero patch embeddings, counted in the cache's
length) in bf16 on the same weights (the JAX server's own, carried across by
``params_from_numpy``) and are fed the same tokens (the JAX server's) at
every step, so each step's logits compare. bf16 is rounded at other
places on the two sides: the gap measured on these cases is at most
0.024 (qwen) and 0.035 (mamba2) on logits up to 2.1 (three to five bf16
steps); the tolerance is 0.0625, eight bf16 steps at that scale. A token
must then equal the JAX one wherever the JAX top-2 margin exceeds twice
the tolerance (each side may move a logit by the tolerance); elsewhere
the tie may break either way. mamba2 is compared for prompts of at least
W-1 = 3 tokens only: for shorter ones the JAX server grafts the conv
tail into its cache left-aligned (ROADMAP Queue C), and the port's
decode is held to its own forward instead (``test_torch_model.py``);
hymba's SSD half likewise. The reduced hymba's two layers are both
global (its sliding window is tested in ``test_torch_families.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch.serve import Server as RefServer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

LOGIT_ATOL = 0.0625


def _recording(fn, sink, to_np):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        sink.append(to_np(out[0][:, -1]))
        return out
    return wrapped


def _against_the_jax_server(arch, B, S0, n, seed):
    n_img = get_arch(arch).reduced().frontend_seq  # image slots first
    ref = RefServer(arch, batch=B, max_seq=n_img + S0 + n + 2, seed=seed)
    srv = serve.Server(arch, batch=B, max_seq=n_img + S0 + n + 2,
                       device="cpu")
    srv.params = params_from_numpy(jax.tree.map(np.asarray, ref.params),
                                   device="cpu", dtype=torch.bfloat16)
    want, got = [], []
    ref.prefill = _recording(ref.prefill, want,
                             lambda x: np.asarray(x, np.float32))
    ref.decode = _recording(ref.decode, want,
                            lambda x: np.asarray(x, np.float32))
    srv.prefill = _recording(srv.prefill, got, lambda x: x.float().numpy())
    srv.decode = _recording(srv.decode, got, lambda x: x.float().numpy())

    prompts = np.random.default_rng(seed).integers(0, 256, (B, S0),
                                                   dtype=np.int32)
    tok_ref = ref.prefill_prompts(prompts)
    toks = [(tok_ref, srv.prefill_prompts(prompts))]
    for _ in range(n - 1):
        nxt = ref.step(tok_ref)
        toks.append((nxt, srv.step(tok_ref)))  # the same input tokens
        tok_ref = nxt
    n_img = srv.cfg.frontend_seq
    assert srv.cache_len == ref.cache_len == n_img + S0 + n - 1
    assert len(got) == len(want) == n
    for w, g, (tw, tg) in zip(want, got, toks):
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
        assert np.array_equal(tg[clear], np.asarray(tw)[clear])


@pytest.mark.parametrize("B,S0,n,seed", [(2, 8, 6, 0), (4, 20, 8, 1),
                                         (3, 40, 6, 2)])
def test_server_matches_the_jax_server(B, S0, n, seed):
    _against_the_jax_server("qwen2.5-3b", B, S0, n, seed)


@pytest.mark.parametrize("B,S0,n,seed", [(2, 3, 5, 0), (3, 24, 6, 1),
                                         (2, 40, 4, 2)])
def test_ssm_server_matches_the_jax_server(B, S0, n, seed):
    _against_the_jax_server("mamba2-780m", B, S0, n, seed)


@pytest.mark.parametrize("B,S0,n,seed", [(2, 8, 6, 0), (3, 30, 5, 1)])
def test_hybrid_server_matches_the_jax_server(B, S0, n, seed):
    _against_the_jax_server("hymba-1.5b", B, S0, n, seed)


@pytest.mark.parametrize("B,S0,n,seed", [(2, 8, 6, 0), (3, 30, 5, 1)])
def test_vlm_server_matches_the_jax_server(B, S0, n, seed):
    _against_the_jax_server("paligemma-3b", B, S0, n, seed)


def test_generate_shape_and_range():
    srv = serve.Server("qwen2.5-3b", batch=2, max_seq=48, device="cpu")
    assert srv.params["embed"].dtype == torch.bfloat16  # cast once
    prompts = np.random.default_rng(0).integers(
        0, srv.cfg.vocab_size, (2, 8), dtype=np.int32)
    launches = (flash_attention.launches, decode_attention.launches)
    toks = srv.generate(prompts, 4)
    assert toks.shape == (2, 4)
    assert (toks >= 0).all() and (toks < srv.cfg.vocab_padded).all()
    assert srv.cache_len == 8 + 3
    # a CPU server takes the plain versions, never a kernel
    assert (flash_attention.launches, decode_attention.launches) == launches
    # the same seed gives the same weights and tokens; the cache is reused
    again = srv.generate(prompts, 4)
    assert np.array_equal(toks, again)
    other = serve.Server("qwen2.5-3b", batch=2, max_seq=48, device="cpu")
    assert np.array_equal(other.generate(prompts, 4), toks)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-236b"])
def test_moe_servers_generate(arch):
    """The MoE archs (refused before ROADMAP A7b) serve on the CPU: the
    reference's cache entries (deepseek's leading dense layer's too),
    tokens in range, a cache length of prompt + steps, and no kernel
    launched. Their logits against the JAX server:
    ``test_torch_moe_mla.py``."""
    srv = serve.Server(arch, batch=2, max_seq=24, device="cpu")
    assert set(srv.cache) == ({"layers", "dense0"} if srv.cfg.mla
                              else {"layers"})
    prompts = np.random.default_rng(3).integers(
        0, srv.cfg.vocab_size, (2, 9), dtype=np.int32)
    launches = (flash_attention.launches, decode_attention.launches)
    toks = srv.generate(prompts, 5)
    assert toks.shape == (2, 5) and srv.cache_len == 9 + 4
    assert (toks >= 0).all() and (toks < srv.cfg.vocab_padded).all()
    assert (flash_attention.launches, decode_attention.launches) == launches


def test_server_refuses_what_does_not_fit():
    srv = serve.Server("qwen2.5-3b", batch=2, max_seq=10, device="cpu")
    with pytest.raises(ValueError):
        srv.prefill_prompts(np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError):
        srv.prefill_prompts(np.zeros((2, 10), np.int32))
    srv.prefill_prompts(np.zeros((2, 9), np.int32))
    srv.step(np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        srv.step(np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        serve.Server("hubert-xlarge", device="cpu")
    vlm = serve.Server("paligemma-3b", batch=2, max_seq=10, device="cpu")
    with pytest.raises(ValueError):  # 4 image slots + 6 tokens: full
        vlm.prefill_prompts(np.zeros((2, 6), np.int32))
    vlm.prefill_prompts(np.zeros((2, 5), np.int32))
    assert vlm.cache_len == 9


def test_ssm_generate_shape_range_and_no_kernel():
    srv = serve.Server("mamba2-780m", batch=2, max_seq=16, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, srv.cfg.vocab_size, (2, 5), dtype=np.int32)
    launches = ssd_scan.launches
    toks = srv.generate(prompts, 4)
    assert toks.shape == (2, 4)
    assert (toks >= 0).all() and (toks < srv.cfg.vocab_padded).all()
    assert srv.cache_len == 5 + 3 and ssd_scan.launches == launches
    assert np.array_equal(srv.generate(prompts, 4), toks)  # cache reused
    with pytest.raises(ValueError):  # the same prompt-length rule
        srv.prefill_prompts(np.zeros((2, 16), np.int32))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m",
                                  "hymba-1.5b", "paligemma-3b"])
def test_main_serves_on_the_cpu(capsys, arch):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--tokens", "3"])
    out = capsys.readouterr().out
    assert "2 requests x 3 tokens" in out and "on cpu" in out
