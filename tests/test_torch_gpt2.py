"""The port's GPT-2 against the JAX package's, on the CPU.

The JAX ``tiny`` GPT-2 is built from a seed and its parameters carried into
the port with ``interop.load_jax_params`` (same names, same layouts, the
tied head a single ``tok_emb.weight``); both run the same token ids through
their plain attention.  Tolerances: f32 logits and hidden states 1e-5
(two layers of the same math, f32 sums in another order, on values of
O(1)); bf16 5e-2 absolute on values of O(1) (a few bf16 ulps: XLA rounds
each bf16 op of LayerNorm and GELU to bf16 where PyTorch's kernels compute
in f32 and round once, and the matmuls accumulate in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import gpt2 as jgpt2
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.interop import export_params, load_jax_params
from torchdistx_tpu_torch.models import GPT2, gpt2_configs
from torchdistx_tpu_torch.nn import functional as tF

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _pair(dt):
    jdt, tdt, _ = DTYPES[dt]
    tdx.manual_seed(0)
    jm = tdx.deferred_init(jgpt2.GPT2.from_name, "tiny", dtype=jdt)
    tdx.materialize_module(jm)
    params = {k: np.asarray(v) for k, v in jm.named_parameters()}
    tm = GPT2.from_name("tiny", device="cpu", dtype=tdt)
    load_jax_params(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module", params=list(DTYPES))
def models(request):
    return request.param, _pair(request.param)


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


@pytest.mark.parametrize("return_hidden", [False, True], ids=["logits", "hidden"])
def test_forward_matches_jax(models, return_hidden):
    dt, (jm, params, tm) = models
    tol = DTYPES[dt][2]
    toks = _tokens(0, 2, 37)
    ref = functional_call(jm, params, (jnp.asarray(toks),), {"return_hidden": return_hidden})
    with torch.no_grad():
        out = tm(torch.from_numpy(toks).long(), return_hidden=return_hidden)
    assert out.dtype == DTYPES[dt][1]
    want = (2, 37, 256 if not return_hidden else 64)
    assert tuple(out.shape) == want
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_parameter_names_and_layouts_match_jax(models):
    _, (jm, params, tm) = models
    own = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert own == {k: tuple(v.shape) for k, v in params.items()}
    assert "tok_emb.weight" in own and not any("lm_head" in k for k in own)
    assert own["blocks.0.attn_qkv.weight"] == (3 * 64, 64)


def test_configs_match_jax():
    assert set(gpt2_configs) == set(jgpt2.gpt2_configs)
    for name, kw in jgpt2.gpt2_configs.items():
        assert gpt2_configs[name] == kw


def test_sequence_past_n_positions_raises():
    tt.manual_seed(0)
    m = GPT2.from_name("tiny", device="cpu")
    with pytest.raises(ValueError, match="n_positions"):
        m(torch.zeros(1, 65, dtype=torch.long))


@pytest.mark.parametrize("method", ["forward_cached", "forward_decode", "init_cache",
                                    "sp_axis"])
def test_unported_methods_raise(method):
    tt.manual_seed(0)
    toks = torch.zeros(1, 4, dtype=torch.long)
    if method == "sp_axis":
        m = GPT2.from_name("tiny", device="cpu", sp_axis="sp")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            m(toks)
        return
    m = GPT2.from_name("tiny", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        getattr(m, method)(toks, None, 0)


def test_init_scheme():
    """Zero biases, unit LayerNorm weights, N(0, 0.02) weights and
    N(0, 0.02/sqrt(2L)) residual projections (gpt2 widths, 2 layers)."""
    tt.manual_seed(3)
    m = GPT2.from_name("gpt2", device="cpu", n_layers=2).requires_grad_(False)
    blk = m.blocks[0]
    for lin in (blk.attn_qkv, blk.attn_out, blk.mlp_up, blk.mlp_down):
        assert torch.count_nonzero(lin.bias) == 0
    assert torch.equal(blk.ln1.weight, torch.ones(768))
    assert torch.count_nonzero(m.ln_f.bias) == 0
    np.testing.assert_allclose(float(blk.mlp_up.weight.std()), 0.02, rtol=0.02)
    np.testing.assert_allclose(float(m.tok_emb.weight.std()), 0.02, rtol=0.02)
    np.testing.assert_allclose(float(blk.mlp_down.weight.std()), 0.02 / 2.0, rtol=0.02)


def test_deferred_init_is_bit_identical_to_eager():
    tt.manual_seed(7)
    deferred = tt.deferred_init(GPT2.from_name, "tiny", device="cpu")
    assert tt.is_deferred(deferred)
    tt.materialize_module(deferred)
    tt.manual_seed(7)
    eager = GPT2.from_name("tiny", device="cpu")
    a, b = export_params(deferred), export_params(eager)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("dt", list(DTYPES))
def test_layer_norm_and_gelu_match_jax(dt):
    jdt, tdt, tol = DTYPES[dt]
    rs = np.random.RandomState(5)
    x = (3.0 * rs.randn(4, 9, 64) + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(64)).astype(np.float32)
    b = (0.1 * rs.randn(64)).astype(np.float32)
    ref = jF.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt), 1e-5)
    out = tF.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                        torch.from_numpy(b).to(tdt), 1e-5)
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)
    for approx in (True, False):
        ref = jF.gelu(jnp.asarray(x, jdt), approximate=approx)
        out = tF.gelu(torch.from_numpy(x).to(tdt), approximate=approx)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)
    # the default is the tanh form, as in JAX: it differs from erf's
    xt = torch.from_numpy(x)
    assert torch.equal(tF.gelu(xt), torch.nn.functional.gelu(xt, approximate="tanh"))
    assert not torch.equal(tF.gelu(xt), torch.nn.functional.gelu(xt))
