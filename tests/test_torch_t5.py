"""The port's T5 against the JAX package's, on the CPU.

The JAX ``tiny`` T5 is built from a seed and its parameters carried into
the port with ``interop.load_jax_params`` (the same names, ``rel_bias``
only in layer 0 of each stack); both run the same token ids.  Three
self-attention paths on each side: the einsum path (``use_flash=False``),
flash with the materialized bias, and flash with the bucket table
(``flash_bucket_bias=True``), the JAX ones through the Pallas kernels in
interpret mode, the port's through its plain versions.  Tolerances (f32):
logits 1e-5 (two layers per stack of the same math, sums in another
order); every parameter gradient, ``rel_bias.weight`` included, rtol 5e-4
and atol 5e-5, as ``tests/test_flash_attention.py`` holds the JAX T5's
bucket path against its bias path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import t5 as jt5
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch import generation
from torchdistx_tpu_torch.interop import export_params, load_jax_params
from torchdistx_tpu_torch.models import T5, t5_configs
from torchdistx_tpu_torch.nn import functional as tF
from torchdistx_tpu_torch.ops import flash_attention as tflash

MODES = {"einsum": dict(use_flash=False),
         "bias": dict(use_flash=True),
         "bucket": dict(use_flash=True, flash_bucket_bias=True)}
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def jax_params():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(jt5.T5.from_name, "tiny")
    tdx.materialize_module(jm)
    return {k: np.asarray(v) for k, v in jm.named_parameters()}


def _tokens(seed, b=2, s_enc=24, s_dec=16):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (b, s_enc)).astype(np.int32),
            rs.randint(0, 256, (b, s_dec)).astype(np.int32))


def _jax_model(mode):
    return jt5.T5.from_name("tiny", **MODES[mode])


def _port_model(mode, params):
    return load_jax_params(T5.from_name("tiny", device="cpu", **MODES[mode]), params)


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_jax(jax_params, mode):
    src, tgt = _tokens(0)
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    ref = functional_call(_jax_model(mode), jp, (jnp.asarray(src), jnp.asarray(tgt)))
    tm = _port_model(mode, jax_params)
    with torch.no_grad():
        out = tm(torch.from_numpy(src).long(), torch.from_numpy(tgt).long())
    assert tuple(out.shape) == (2, 16, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_every_gradient_matches_jax(jax_params, mode):
    src, tgt = _tokens(1)
    jm = _jax_model(mode)
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    js, jt = jnp.asarray(src), jnp.asarray(tgt)

    def loss(p):
        return jF.cross_entropy(functional_call(jm, p, (js, jt)), jt)

    jloss, jgrads = jax.value_and_grad(loss)(jp)
    tm = _port_model(mode, jax_params)
    ts, tt_ = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    tloss = tF.cross_entropy(tm(ts, tt_), tt_)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=1e-5, rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(grads) == set(jgrads)
    for k, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(jgrads[k]), err_msg=k, **GRAD_TOL)
    # the shared bias carries gradient from every layer of its stack
    assert np.abs(grads["enc_blocks.0.self_attn.rel_bias.weight"]).max() > 0
    assert np.abs(grads["dec_blocks.0.self_attn.rel_bias.weight"]).max() > 0


def test_return_hidden_applies_the_head_scaling(jax_params):
    src, tgt = _tokens(2)
    tm = _port_model("einsum", jax_params)
    ts, tt_ = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    with torch.no_grad():
        h = tm(ts, tt_, return_hidden=True)
        torch.testing.assert_close(h @ tm.shared_emb.weight.T, tm(ts, tt_))
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    ref = functional_call(_jax_model("einsum"), jp, (jnp.asarray(src), jnp.asarray(tgt)),
                          {"return_hidden": True})
    np.testing.assert_allclose(h.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_parameter_names_and_layouts_match_jax(jax_params):
    tm = T5.from_name("tiny", device="cpu")
    own = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert own == {k: tuple(v.shape) for k, v in jax_params.items()}
    assert own["enc_blocks.0.self_attn.rel_bias.weight"] == (32, 4)
    assert "enc_blocks.1.self_attn.rel_bias.weight" not in own
    assert "dec_blocks.0.cross_attn.q.weight" in own


def test_configs_match_jax():
    assert set(t5_configs) == set(jt5.t5_configs)
    for name, kw in jt5.t5_configs.items():
        assert t5_configs[name] == kw


def test_t5_3b_parameter_count_matches_jax_under_fake_mode():
    with tdx.fake_mode():
        jm = jt5.T5.from_name("t5_3b")
    with tt.fake_mode():
        tm = T5.from_name("t5_3b", device="cpu")
    n = sum(p.numel() for p in tm.parameters())
    assert n == jm.num_params() == 2_851_598_336
    assert all(tt.is_fake(p) for p in tm.parameters())


def test_deferred_init_is_bit_identical_to_eager():
    tt.manual_seed(7)
    deferred = tt.deferred_init(T5.from_name, "tiny", device="cpu")
    assert tt.is_deferred(deferred)
    tt.materialize_module(deferred)
    tt.manual_seed(7)
    eager = T5.from_name("tiny", device="cpu")
    a, b = export_params(deferred), export_params(eager)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_init_scheme():
    """N(0, 1) embedding and relative-bias table, unit RMSNorm weights,
    kaiming-uniform projections (bound sqrt(6 / fan_in) / sqrt(1 + 5))."""
    tt.manual_seed(3)
    m = T5.from_name("t5_small", device="cpu", n_layers=1).requires_grad_(False)
    np.testing.assert_allclose(float(m.shared_emb.weight.std()), 1.0, rtol=0.02)
    assert torch.equal(m.enc_norm.weight, torch.ones(512))
    wi = m.enc_blocks[0].wi.weight
    assert float(wi.abs().max()) <= 1.0 / np.sqrt(512) + 1e-6
    rb = m.enc_blocks[0].self_attn.rel_bias.weight
    assert rb.shape == (32, 8) and float(rb.std()) > 0.5


def test_bias_modes_use_the_same_bucket_ids(jax_params):
    """The materialized bias is the table looked up at the cached ids the
    kernels read."""
    tm = _port_model("bias", jax_params)
    attn = tm.dec_blocks[0].self_attn
    with torch.no_grad():
        bias = attn._bias(16, 16)
        table = attn.rel_bias.weight.t()
        want = table[:, tflash.rel_bucket_matrix(16, 16, (32, 128, False))]
    assert torch.equal(bias, want)


@pytest.mark.parametrize("what", ["decode_step", "init_decoder_cache", "generate_encdec",
                                  "sp_axis"])
def test_unported_paths_raise(what):
    toks = torch.zeros(1, 4, dtype=torch.long)
    if what == "sp_axis":
        m = T5.from_name("tiny", device="cpu", sp_axis="sp")
        with pytest.raises(NotImplementedError, match="not ported yet"):
            m(toks, toks)
        with pytest.raises(ValueError, match="flash_bucket_bias"):
            T5.from_name("tiny", device="cpu", sp_axis="sp", flash_bucket_bias=True)
        return
    m = T5.from_name("tiny", device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        if what == "generate_encdec":
            generation.generate_encdec(m, toks, 4)
        else:
            getattr(m, what)(toks, None, 0)
