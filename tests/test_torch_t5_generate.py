"""T5 generation in the port against the JAX package's, on the CPU.

The JAX ``tiny`` T5 (f32) is built from a seed and its weights carried into
the port.  ``decode_step`` logits, step by step against the cached decoder
of both sides, are held at rtol = atol = 1e-5; greedy ``generate_encdec``
ids must be EQUAL to JAX's in each self-attention mode of the encoder:
the einsum path, flash with the materialized bias and flash with the
bucket table (the JAX side through the Pallas kernels in interpret mode,
the port's through their plain versions on CPU tensors).  Sampling uses
the port's seed-keyed sampler, which cannot match ``jax.random``'s bits:
the same seed gives the same ids, another seed other ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.generation import generate_encdec as jgenerate_encdec
from torchdistx_tpu.models import t5 as jt5
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu_torch.generation import generate_encdec
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import T5

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = {"einsum": dict(use_flash=False),
         "bias": dict(use_flash=True),
         "bucket": dict(use_flash=True, flash_bucket_bias=True)}


@pytest.fixture(scope="module")
def jax_params():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(jt5.T5.from_name, "tiny")
    tdx.materialize_module(jm)
    return {k: np.asarray(v) for k, v in jm.named_parameters()}


@pytest.fixture(scope="module")
def spread_params(jax_params):
    """The same names and shapes, every matrix redrawn from a seed with
    numpy at std 1/sqrt(fan_in) (embeddings and bias tables at 1): with
    T5's own init the tied head repeats the start token in every row, and
    greedy ids would not depend on the encoder at all."""
    rs = np.random.RandomState(3)
    out = {}
    for k, v in jax_params.items():
        if v.ndim == 1:
            out[k] = v
        elif "emb" in k or "rel_bias" in k:
            out[k] = rs.normal(0, 1.0, v.shape).astype(np.float32)
        else:
            out[k] = rs.normal(0, 1 / np.sqrt(v.shape[-1]), v.shape).astype(np.float32)
    return out


def _pair(mode, params):
    jm = jt5.T5.from_name("tiny", **MODES[mode])
    tm = load_jax_params(T5.from_name("tiny", device="cpu", **MODES[mode]), params)
    return jm, {k: jnp.asarray(v) for k, v in params.items()}, tm


def _src(seed, b=2, s=24):
    return np.random.RandomState(seed).randint(1, 256, (b, s)).astype(np.int32)


def test_decode_step_logits_match_jax(jax_params):
    jm, jp, tm = _pair("einsum", jax_params)
    src = _src(0)
    steps = np.random.RandomState(1).randint(0, 256, (2, 5)).astype(np.int32)

    def call(method, *args):
        return functional_call(jm, jp, args, method=method)

    enc = call("encode", jnp.asarray(src))
    jcache = call("init_decoder_cache", enc, 8)
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(src).long())
        np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), **TOL)
        tcache = tm.init_decoder_cache(tenc, 8)
        for i in range(steps.shape[1]):
            tok = steps[:, i:i + 1]
            ref, jcache = call("decode_step", jnp.asarray(tok), jcache, i)
            out, tcache = tm.decode_step(torch.from_numpy(tok).long(), tcache, i)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
        # a 3-token chunk from position 5 (the bias slice of several rows)
        chunk = steps[:, :3]
        ref, _ = call("decode_step", jnp.asarray(chunk), jcache, 5)
        out, _ = tm.decode_step(torch.from_numpy(chunk).long(), tcache, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cached_decode_equals_full_forward(jax_params):
    """Teacher-forced: the cached steps' logits equal the full forward's."""
    _, _, tm = _pair("einsum", jax_params)
    src = torch.from_numpy(_src(2)).long()
    tgt = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (2, 6))).long()
    with torch.no_grad():
        full = tm(src, tgt)
        cache = tm.init_decoder_cache(tm.encode(src), 6)
        for i in range(6):
            out, cache = tm.decode_step(tgt[:, i:i + 1], cache, i)
            np.testing.assert_allclose(out[:, 0].numpy(), full[:, i].numpy(), **TOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_encdec_greedy_equals_jax(jax_params, spread_params, mode):
    src = _src(4)
    for params in (jax_params, spread_params):
        jm, jp, tm = _pair(mode, params)
        ref = np.asarray(jgenerate_encdec(jm, jnp.asarray(src), 7, params=jp))
        out = generate_encdec(tm, src, 7)
        assert out.shape == (2, 7) and out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), ref)
        # a tensor input is taken as it is (on the card: never via numpy)
        assert torch.equal(generate_encdec(tm, torch.from_numpy(src), 7), out)
    assert len(set(ref[:, 0])) == 2  # the rows' ids depend on their encoder input


def test_generate_encdec_sampled_is_reproducible(jax_params):
    _, _, tm = _pair("einsum", jax_params)
    src = _src(5)
    a = generate_encdec(tm, src, 6, temperature=3.0, top_p=0.99, seed=7)
    b = generate_encdec(tm, src, 6, temperature=3.0, top_p=0.99, seed=7)
    c = generate_encdec(tm, src, 6, temperature=3.0, top_p=0.99, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="positive"):
        generate_encdec(tm, src, 0)
    with pytest.raises(ValueError, match="top_k"):
        generate_encdec(tm, src, 2, top_k=0)

