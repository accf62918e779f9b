"""The port's Llama against the JAX package's, on the CPU.

The JAX model is built from a seed, its parameters carried into the port
with ``interop.load_jax_params``, and both run the same token ids.  f32
throughout; logits tolerance atol = 1e-4 (rtol 1e-4): two layers of the
same math with f32 sums in another order, on logits of O(1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.generation import generate as j_generate
from torchdistx_tpu.models import llama as jllama
from torchdistx_tpu_torch.generation import generate as t_generate
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import llama as tllama

TOL = dict(atol=1e-4, rtol=1e-4)
KV_HEADS = [4, 2]  # tiny (Hkv = Hq) and its GQA variant


def _pair(n_kv_heads):
    tdx.manual_seed(0)
    jm = jllama.Llama.from_name("tiny", n_kv_heads=n_kv_heads)
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = tllama.Llama.from_name("tiny", n_kv_heads=n_kv_heads, device="cpu")
    load_jax_params(tm, params)
    return jm, tm


@pytest.fixture(scope="module", params=KV_HEADS, ids=lambda h: f"hkv{h}")
def models(request):
    return _pair(request.param)


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def test_forward_matches_jax(models):
    jm, tm = models
    toks = _tokens(0, 2, 19)
    ref = np.asarray(jm(jnp.asarray(toks)))
    with torch.no_grad():
        out = tm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_prefill_then_decode_steps_match_jax(models):
    jm, tm = models
    toks = _tokens(1, 2, 11)
    jc = jm.init_cache(2, 32)
    jl, jc = jm.forward_cached(jnp.asarray(toks), jc, 0)
    with torch.no_grad():
        tc = tm.init_cache(2, 32)
        tl, tc = tm.forward_cached(torch.from_numpy(toks).long(), tc, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for i in range(3):
            step = _tokens(10 + i, 2, 1)
            jl, jc = jm.forward_cached(jnp.asarray(step), jc, 11 + i)
            tl, tc = tm.forward_cached(torch.from_numpy(step).long(), tc, 11 + i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_forward_decode_per_row_positions_matches_jax(models):
    jm, tm = models
    rs = np.random.RandomState(2)
    b, max_seq = 3, 24
    kv_shape = (b, max_seq, jm.cfg.n_kv_heads, jm.cfg.head_dim)
    caches = [(rs.randn(*kv_shape).astype(np.float32),
               rs.randn(*kv_shape).astype(np.float32))
              for _ in range(jm.cfg.n_layers)]
    toks = _tokens(3, b, 1)
    pos = np.array([0, 23, 9], np.int32)
    jl, jc = jm.forward_decode(
        jnp.asarray(toks), [tuple(map(jnp.asarray, c)) for c in caches],
        jnp.asarray(pos))
    with torch.no_grad():
        tl, tc = tm.forward_decode(
            torch.from_numpy(toks).long(),
            [tuple(torch.from_numpy(a.copy()) for a in c) for c in caches],
            torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("head_dim,max_seq,theta", [(16, 128, 1e4), (128, 8192, 5e5)])
def test_rope_tables_equal(head_dim, max_seq, theta):
    """f32 cos/sin of the same f32 arguments; the two libraries' f32 sin
    and cos may differ in the last bit, hence atol 1e-6 on values in
    [-1, 1]."""
    ref = np.asarray(jllama._rope_freqs(head_dim, max_seq, theta))
    out = tllama._rope_freqs(head_dim, max_seq, theta, device="cpu").numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_apply_rope_at_clips_like_jax():
    rs = np.random.RandomState(4)
    rope = np.array(jllama._rope_freqs(16, 8, 1e4))
    x = rs.randn(2, 3, 2, 16).astype(np.float32)
    pos = np.array([6, 2], np.int32)  # row 0 runs past the table's end
    ref = np.asarray(jllama.apply_rope_at(jnp.asarray(x), jnp.asarray(rope), jnp.asarray(pos)))
    out = tllama.apply_rope_at(torch.from_numpy(x), torch.from_numpy(rope),
                               torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_configs_match_jax_table():
    assert set(tllama.llama_configs) == set(jllama.llama_configs)
    for name, jcfg in jllama.llama_configs.items():
        tcfg = tllama.llama_configs[name]
        for key, val in jcfg.items():
            if key == "dtype":
                continue
            assert tcfg[key] == val, (name, key)
        j = jllama.LlamaConfig(**jcfg)
        t = tllama.LlamaConfig(**tcfg)
        assert (j.ffn_dim, j.n_kv_heads, j.head_dim, j.remat, j.remat_policy) == (
            t.ffn_dim, t.n_kv_heads, t.head_dim, t.remat, t.remat_policy)


def test_greedy_generate_matches_jax(models):
    jm, tm = models
    prompt = _tokens(5, 2, 7)
    ref = np.asarray(j_generate(jm, jnp.asarray(prompt), 6))
    out = t_generate(tm, prompt, 6, device="cpu").numpy()
    np.testing.assert_array_equal(out, ref)


def test_load_jax_params_rejects_missing_key():
    jm, tm = _pair(2)
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    params.pop("blocks.1.attn.wk.weight")
    with pytest.raises(KeyError, match="blocks.1.attn.wk.weight"):
        load_jax_params(tm, params)


def test_load_jax_params_rejects_misshaped_key():
    jm, tm = _pair(2)
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    params["norm.weight"] = np.ones(65, np.float32)
    with pytest.raises(ValueError, match="norm.weight"):
        load_jax_params(tm, params)


def test_rms_norm_casts_before_weight():
    """bf16: normalise in f32, cast to bf16, THEN multiply by the weight."""
    from torchdistx_tpu.nn import functional as jF
    from torchdistx_tpu_torch.nn import functional as tF

    rs = np.random.RandomState(6)
    x = rs.randn(4, 64).astype(np.float32)
    w = (1 + 0.1 * rs.randn(64)).astype(np.float32)
    ref = np.asarray(jF.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                 1e-5).astype(jnp.float32))
    out = tF.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                      1e-5).float().numpy()
    np.testing.assert_array_equal(out, ref)
