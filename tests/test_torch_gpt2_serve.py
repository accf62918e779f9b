"""GPT-2 serving in the port against the JAX package's, on the CPU.

The JAX ``tiny`` GPT-2 (f32, 4 heads of 64 / 4 = 16, 64 positions) is built
from a seed and its weights carried into the port with
``interop.load_jax_params``.  ``forward_cached`` and ``forward_decode``
(slab, paged, a verify block) are held to JAX's logits at rtol = atol =
1e-5 (two layers of the same f32 math, sums in another order); greedy
``generate`` and the ``ServeEngine`` streams must be EQUAL to JAX's, in
every mode the engine serves Llama in: chunked, persistent, paged with the
prefix cache, speculative and int8.  Sampled streams cannot match
``jax.random``'s bits; they are held to reproducibility by seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.generation import generate as jgenerate
from torchdistx_tpu.models import GPT2 as JGPT2
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch.generation import generate
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import GPT2
from torchdistx_tpu_torch.serve import ServeEngine
from torchdistx_tpu_torch.serve.kv_cache import PagedKVCache

TOL = dict(rtol=1e-5, atol=1e-5)
EOS = 97


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(11)
    jm = tdx.deferred_init(JGPT2.from_name, "tiny")
    tdx.materialize_module(jm)
    tm = GPT2.from_name("tiny", device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def _seeded_caches(model, rows, positions, jax_side):
    """Per-row caches of 16 positions holding a random prefix of each row's
    depth, then stacked into one (B, 16, H, D) slab per layer."""
    rs = np.random.RandomState(4)
    seeded = []
    for p in positions:
        pre = rs.randint(0, 256, (1, int(p))).astype(np.int32)
        if jax_side:
            _, c = model.forward_cached(jnp.asarray(pre), model.init_cache(1, 16), 0)
        else:
            _, c = model.forward_cached(torch.from_numpy(pre).long(),
                                        model.init_cache(1, 16), 0)
        seeded.append(c)
    cat = jnp.concatenate if jax_side else (lambda xs: torch.cat(xs))
    return [(cat([c[i][0] for c in seeded]), cat([c[i][1] for c in seeded]))
            for i in range(len(seeded[0]))]


def test_forward_cached_matches_jax(models):
    jm, tm = models
    toks = _tokens(0, 2, 12)
    ref, jcache = jm.forward_cached(jnp.asarray(toks), jm.init_cache(2, 32), 0)
    nxt = _tokens(1, 2, 1)
    ref2, _ = jm.forward_cached(jnp.asarray(nxt), jcache, 12)
    with torch.no_grad():
        out, cache = tm.forward_cached(torch.from_numpy(toks).long(), tm.init_cache(2, 32), 0)
        out2, _ = tm.forward_cached(torch.from_numpy(nxt).long(), cache, 12)
        full = tm(torch.from_numpy(np.concatenate([toks, nxt], 1)).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), **TOL)
    # the cached decode equals the full forward's last position
    np.testing.assert_allclose(out2[:, -1].numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("s", [1, 3], ids=["token", "verify_block"])
@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_forward_decode_matches_jax(models, s, layout):
    jm, tm = models
    positions = np.array([1, 7, 14], np.int32)  # row 2's block clips at 15
    toks = _tokens(5, 3, s)
    jkv = _seeded_caches(jm, 3, positions, True)
    tkv = _seeded_caches(tm, 3, positions, False)
    ref, _ = jm.forward_decode(jnp.asarray(toks), jkv, jnp.asarray(positions))
    with torch.no_grad():
        pos = torch.from_numpy(positions).long()
        if layout == "slab":
            out, _ = tm.forward_decode(torch.from_numpy(toks).long(), tkv, pos)
        else:
            # the same rows through page pools of 4 positions, shuffled pages
            ps, pp = 4, 4
            pools = PagedKVCache(tm, 3, 16, ps, 3 * pp + 1).kv
            order = np.random.RandomState(2).permutation(np.arange(1, 3 * pp + 1))
            tables = torch.from_numpy(order.reshape(3, pp).astype(np.int32))
            for (pk, pv), (k, v) in zip(pools, tkv):
                for row in range(3):
                    for j in range(pp):
                        pk[tables[row, j]] = k[row, j * ps:(j + 1) * ps]
                        pv[tables[row, j]] = v[row, j * ps:(j + 1) * ps]
            out, _ = tm.forward_decode(torch.from_numpy(toks).long(), pools, pos, tables)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_generate_greedy_equals_jax(models):
    jm, tm = models
    prompt = _tokens(1, 2, 6)
    ref = np.asarray(jgenerate(jm, jnp.asarray(prompt), max_new_tokens=8))
    out = generate(tm, prompt, 8)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(generate(tm, torch.from_numpy(prompt), 8), out)
    with pytest.raises(ValueError, match="maximum sequence length 64"):
        generate(tm, _tokens(2, 1, 60), 8)


def test_generate_sampled_is_reproducible(models):
    _, tm = models
    prompt = _tokens(3, 2, 5)
    a = generate(tm, prompt, 6, temperature=0.9, top_k=20, seed=4)
    b = generate(tm, prompt, 6, temperature=0.9, top_k=20, seed=4)
    c = generate(tm, prompt, 6, temperature=0.9, top_k=20, seed=5)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _requests(seed, lengths, max_new=8, temperature=0.0):
    rs = np.random.RandomState(seed)
    return [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32),
             "max_new_tokens": max_new, "temperature": temperature, "seed": 100 + i}
            for i, n in enumerate(lengths)]


LENGTHS = (6, 11, 9, 4, 13, 3, 15)
# the JAX engine's modes on GPT-2 (tests/test_serve.py, tests/test_spec_decode.py)
MODES = {
    "chunked": dict(decode_chunk=2),
    "persistent": dict(decode_mode="persistent"),
    "paged_prefix": dict(page_size=8, decode_chunk=2),
    "speculate": dict(speculate=2, decode_mode="persistent"),
    "int8": dict(kv_dtype="int8", decode_chunk=2),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_greedy_streams_equal_jax(models, mode):
    jm, tm = models
    kw = dict(num_slots=3, max_len=64, prefill_buckets=(16,), eos_token=EOS, **MODES[mode])
    reqs = _requests(0, LENGTHS)
    if mode == "paged_prefix":
        # a shared 8-token prefix: the second pass hits the radix index
        shared = _tokens(9, 8)
        reqs += [dict(r, prompt=np.concatenate([shared, r["prompt"][:5]])) for r in reqs[:3]]
    ref = JServeEngine(jm, **kw).run(reqs)
    engine = ServeEngine(tm, **kw)
    out = engine.run(reqs)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.finish_reason == r.finish_reason
    c = engine.metrics.counters
    if mode == "paged_prefix":
        assert c["prefix_hit_tokens"] > 0
    if mode == "speculate":
        assert c["draft_tokens_proposed"] > 0


def test_engine_limit_is_n_positions(models):
    _, tm = models
    engine = ServeEngine(tm)
    assert engine.max_len == 64 and engine.kv_heads == 4
    with pytest.raises(ValueError, match="maximum sequence length 64"):
        ServeEngine(tm, max_len=128)


def test_engine_sampled_reproducible_and_greedy_batchmate_unaffected(models):
    jm, tm = models
    prompts = _tokens(1, 2, 7)
    engine = ServeEngine(tm, num_slots=2, max_len=32, top_k=50)
    greedy = engine.submit(prompts[0], max_new_tokens=6)
    sampled = engine.submit(prompts[1], max_new_tokens=6, temperature=1.0, seed=3)
    while engine.step():
        pass
    ref = np.asarray(jgenerate(jm, jnp.asarray(prompts[:1]), 6))[0]
    np.testing.assert_array_equal(np.concatenate([prompts[0], greedy.result().tokens]), ref)
    again = ServeEngine(tm, num_slots=2, max_len=32, top_k=50).run(
        [{"prompt": prompts[1], "max_new_tokens": 6, "temperature": 1.0, "seed": 3}])
    np.testing.assert_array_equal(again[0].tokens, sampled.result().tokens)
