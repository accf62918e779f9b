"""The port's windowed Llama (the Mistral family) against the JAX
package's, on the CPU.

A tiny Llama with ``sliding_window=8`` and GQA (``n_kv_heads=2``) is built
in JAX from a seed and carried into the port with
``interop.load_jax_params``.  The JAX side runs its flash path (the Pallas
kernels in interpret mode) where the port runs ``flash_attention(window=)``
(its plain versions on CPU tensors), and both plain paths; sequences are
longer than the window, so the band cuts.  f32; logits and gradients atol
= rtol = 1e-4 (two layers of the same math, sums in another order);
greedy streams exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.nn import functional as tF
from torchdistx_tpu_torch.serve import ServeEngine
from torchdistx_tpu_torch.utils.benchmarks import build_train_workload

TOL = dict(atol=1e-4, rtol=1e-4)
WINDOW = 8


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    kw = dict(sliding_window=WINDOW, n_kv_heads=2, max_seq_len=64)
    jm = JLlama.from_name("tiny", **kw)
    tm = TLlama.from_name("tiny", device="cpu", **kw)
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_windowed_forward_and_grads_match_jax(models, use_flash):
    jm, tm = models
    toks, labels = _tokens(0, 2, 24), _tokens(1, 2, 24)
    jm.cfg.use_flash = tm.cfg.use_flash = use_flash
    try:
        params = dict(jm.named_parameters())

        def jloss(p):
            logits = functional_call(jm, p, (jnp.asarray(toks),))
            return jF.cross_entropy(logits, jnp.asarray(labels)), logits

        (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
        tm.zero_grad(set_to_none=True)
        logits = tm(torch.from_numpy(toks).long())
        loss = tF.cross_entropy(logits, torch.from_numpy(labels).long())
        loss.backward()
    finally:
        jm.cfg.use_flash = tm.cfg.use_flash = None
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]), err_msg=name, **TOL)


def test_window_changes_the_logits(models):
    """Past the window the band cuts: the windowed model differs from the
    same weights without a window."""
    _, tm = models
    toks = torch.from_numpy(_tokens(2, 1, 24)).long()
    with torch.no_grad():
        windowed = tm(toks)
        tm.cfg.sliding_window = None
        try:
            full = tm(toks)
        finally:
            tm.cfg.sliding_window = WINDOW
    assert torch.equal(windowed[:, :WINDOW], full[:, :WINDOW])
    assert (windowed[:, WINDOW:] - full[:, WINDOW:]).abs().max() > 1e-3


def test_prefill_then_decode_past_the_window_matches_jax(models):
    jm, tm = models
    toks = _tokens(3, 2, 20)
    jc = jm.init_cache(2, 32)
    jl, jc = jm.forward_cached(jnp.asarray(toks[:, :13]), jc, 0)
    with torch.no_grad():
        tc = tm.init_cache(2, 32)
        tl, tc = tm.forward_cached(torch.from_numpy(toks[:, :13]).long(), tc, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for i in range(13, 20):
            step = toks[:, i:i + 1]
            jl, jc = jm.forward_cached(jnp.asarray(step), jc, i)
            tl, tc = tm.forward_cached(torch.from_numpy(step).long(), tc, i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("num_slots,buckets", [(2, (16, 32)), (3, None)],
                         ids=["2-slots", "3-slots-default-buckets"])
def test_serve_engine_streams_past_the_window_equal_jax_engine(models, num_slots, buckets):
    """Prompts of 9-27 tokens against a window of 8; each pads to its
    bucket, harmless under the end-aligned band."""
    jm, tm = models
    rs = np.random.RandomState(4)
    reqs = [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32), "max_new_tokens": 8,
             "temperature": 0.0, "seed": i} for i, n in enumerate((9, 27, 14, 20))]
    kw = dict(num_slots=num_slots, max_len=64)
    if buckets:
        kw["prefill_buckets"] = buckets
    ref = JServeEngine(jm, **kw).run(reqs)
    out = ServeEngine(tm, **kw).run(reqs)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)


def test_windowed_train_workload_runs_on_the_cpu():
    """``build_train_workload`` of a windowed model (the chip runs
    mistral_7b at 8 layers x 8192 tokens): the JAX flops formula, finite
    falling losses."""
    w = build_train_workload("tiny", batch=1, seq=32, device="cpu", sliding_window=WINDOW,
                             use_flash=True, n_kv_heads=2)
    cfg = w["model"].cfg
    assert cfg.sliding_window == WINDOW
    assert w["flops_per_token"] == 6 * w["n_params"] + 12 * cfg.n_layers * cfg.dim * 32
    losses = w["run"](3)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
