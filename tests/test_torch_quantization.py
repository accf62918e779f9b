"""The port's weight-only int8 quantization against the JAX package's, on
the CPU.

Modules are built in JAX from a seed, carried into the port with
``interop.load_jax_params`` and quantized on both sides.  The int8 codes
and f32 scales must be equal exactly (the same f32 absmax / 127, division,
round half to even and clip).  Outputs, f32: atol = rtol = 1e-5 for a
layer, 1e-4 for the tiny models' logits (the same int8 products summed in
another order); bf16 inputs: 2e-2 relative to the output's max (one bf16
rounding of the product and of the scaled result).  The int8 model is
also held to JAX's MoE fidelity metric against its full-precision self
(``tests/test_quantization.py``): 99th percentile of |int8 - f32| /
max|f32| below 0.05, greedy argmax agreement above 0.9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu import nn as jnn
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.models import Mixtral as JMixtral
from torchdistx_tpu.nn import QuantizedLinear as JQLinear
from torchdistx_tpu.nn import QuantizedMoE as JQMoE
from torchdistx_tpu.nn import quantize_module as j_quantize
from torchdistx_tpu.nn.moe import MoE as JMoE
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch import nn as tnn
from torchdistx_tpu_torch.interop import export_params, load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.models import Mixtral as TMixtral
from torchdistx_tpu_torch.nn import QuantizedLinear, QuantizedMoE, quantize_module
from torchdistx_tpu_torch.nn.moe import MoE as TMoE
from torchdistx_tpu_torch.serve import ServeEngine

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2


def _params(m):
    return {k: np.asarray(v) for k, v in m.named_parameters()}


def _assert_same_params(jm, tm):
    jp, tp = _params(jm), {k: v.detach() for k, v in tm.named_parameters()}
    assert jp.keys() == tp.keys()
    for name, a in jp.items():
        assert tp[name].dtype == {np.dtype(np.int8): torch.int8}.get(a.dtype, tp[name].dtype)
        np.testing.assert_array_equal(tp[name].float().numpy(), a.astype(np.float32),
                                      err_msg=name)


def _linear_pair(i, o, bias, seed):
    tdx.manual_seed(seed)
    jl = jnn.Linear(i, o, bias=bias)
    tl = tnn.Linear(i, o, bias=bias, device="cpu")
    load_jax_params(tl, _params(jl))
    return jl, tl


@pytest.mark.parametrize("i,o,bias", [(64, 32, True), (48, 80, False), (16, 8, True)])
def test_from_linear_codes_and_scales_equal_jax(i, o, bias):
    jl, tl = _linear_pair(i, o, bias, seed=i + o)
    if o == 8:  # an all-zero output channel: scale clamps to 1e-30, codes 0
        with torch.no_grad():
            tl.weight[3].zero_()
        jl.weight = jl.weight.at[3].set(0.0)
    jq, tq = JQLinear.from_linear(jl), QuantizedLinear.from_linear(tl)
    assert tq.weight_q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    _assert_same_params(jq, tq)
    x = np.random.RandomState(0).randn(5, i).astype(np.float32)
    with torch.no_grad():
        y = tq(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jq(jnp.asarray(x))), **LAYER_TOL)


def test_quantized_linear_bf16_matches_jax():
    jl, tl = _linear_pair(64, 48, True, seed=1)
    jq, tq = JQLinear.from_linear(jl), QuantizedLinear.from_linear(tl)
    jq.to(jnp.bfloat16)
    tq.to(torch.bfloat16)
    assert tq.scale.dtype == torch.float32 and tq.weight_q.dtype == torch.int8
    assert tq.bias.dtype == torch.bfloat16
    x = np.random.RandomState(1).randn(4, 64).astype(np.float32)
    ref = np.asarray(jq(jnp.asarray(x, jnp.bfloat16)), np.float32)
    with torch.no_grad():
        y = tq(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert np.abs(y.float().numpy() - ref).max() <= BF16_REL * np.abs(ref).max()


@pytest.mark.parametrize("capacity_factor,dispatch_mode",
                         [(None, "einsum"), (1.0, "einsum"), (1.0, "gather")],
                         ids=["dense", "einsum-c1", "gather-c1"])
def test_quantized_moe_matches_jax(capacity_factor, dispatch_mode):
    tdx.manual_seed(2)
    jm = JMoE(16, 32, 4, 2, capacity_factor=capacity_factor, dispatch_mode=dispatch_mode)
    tm = TMoE(16, 32, 4, 2, capacity_factor=capacity_factor, dispatch_mode=dispatch_mode,
              device="cpu")
    load_jax_params(tm, _params(jm))
    jq, tq = JQMoE.from_moe(jm), QuantizedMoE.from_moe(tm)
    _assert_same_params(jq, tq)
    assert tq.s_gate.shape == (4, 32) and tq.s_down.shape == (4, 16)
    x = np.random.RandomState(3).randn(2, 8, 16).astype(np.float32)
    jy, jaux = jq(jnp.asarray(x), return_aux=True)
    with torch.no_grad():
        y, aux = tq(torch.from_numpy(x), return_aux=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **LAYER_TOL)


def _quantized_pair(cls_j, cls_t, seed, filter_fn=None, **overrides):
    tdx.manual_seed(seed)
    jm = cls_j.from_name("tiny", **overrides)
    tm = cls_t.from_name("tiny", device="cpu", **overrides)
    load_jax_params(tm, _params(jm))
    return jm, tm


@pytest.mark.parametrize("family", ["llama", "mixtral"])
@pytest.mark.parametrize("keep_head", [False, True], ids=["all", "keep-lm_head"])
def test_quantize_module_matches_jax(family, keep_head):
    classes = (JLlama, TLlama) if family == "llama" else (JMixtral, TMixtral)
    jm, tm = _quantized_pair(*classes, seed=4, n_kv_heads=2)
    fn = (lambda path, mod: "lm_head" not in path) if keep_head else None
    assert j_quantize(jm, filter_fn=fn) is jm
    assert quantize_module(tm, filter_fn=fn) is tm
    _assert_same_params(jm, tm)
    kinds = {path: type(mod).__name__ for path, mod in tm.named_modules() if path}
    assert kinds["lm_head"] == ("Linear" if keep_head else "QuantizedLinear")
    if family == "mixtral":
        assert kinds["blocks.0.mlp"] == "QuantizedMoE"
        assert kinds["blocks.0.mlp.router"] == "QuantizedLinear"
    toks = np.random.RandomState(5).randint(0, 256, (2, 13)).astype(np.int32)
    with torch.no_grad():
        out = tm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(out, np.asarray(jm(jnp.asarray(toks))), **TOL)


def test_filter_excluded_moe_keeps_its_router():
    _, tm = _quantized_pair(JMixtral, TMixtral, seed=6)
    quantize_module(tm, filter_fn=lambda path, mod: not isinstance(mod, TMoE))
    for path, mod in tm.named_modules():
        assert not isinstance(mod, QuantizedMoE), path
        if isinstance(mod, TMoE):
            assert type(mod.router).__name__ == "Linear", path


def test_int8_mixtral_fidelity_against_full_precision():
    """JAX's metric for the MoE model: a near-tie routing choice may flip
    under int8, so the bulk of the logits is held, not their max."""
    _, tm = _quantized_pair(JMixtral, TMixtral, seed=5)
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (1, 16))).long()
    with torch.no_grad():
        ref = tm(toks).numpy()
        before = sum(p.numel() * p.element_size() for p in tm.parameters())
        quantize_module(tm)
        after = sum(p.numel() * p.element_size() for p in tm.parameters())
        q = tm(toks).numpy()
    rel = np.abs(q - ref) / np.abs(ref).max()
    assert np.quantile(rel, 0.99) < 0.05
    assert (q.argmax(-1) == ref.argmax(-1)).mean() > 0.9
    assert after < 0.55 * before


@pytest.mark.parametrize("build", [lambda: jnn.Linear(4, 4), lambda: JMoE(8, 16, 4)],
                         ids=["linear", "moe"])
def test_bare_layers_rejected_as_jax_rejects(build):
    tdx.manual_seed(7)
    jmod = build()
    tmod = (tnn.Linear(4, 4, device="cpu") if isinstance(jmod, jnn.Linear)
            else TMoE(8, 16, 4, device="cpu"))
    match = "Linear CHILDREN" if isinstance(jmod, jnn.Linear) else "MoE CHILDREN"
    with pytest.raises(ValueError, match=match):
        j_quantize(jmod)
    with pytest.raises(ValueError, match=match):
        quantize_module(tmod)


def test_interop_carries_codes_exactly_both_ways():
    jm, tm = _quantized_pair(JMixtral, TMixtral, seed=8)
    j_quantize(jm)
    quantize_module(tm)
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    load_jax_params(tm, _params(jm))
    _assert_same_params(jm, tm)
    back = export_params(tm)
    for name, a in _params(jm).items():
        np.testing.assert_array_equal(back[name], a.astype(np.float32), err_msg=name)


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_quantized_serve_engine_streams_equal_jax_engine(family):
    classes = (JLlama, TLlama) if family == "llama" else (JMixtral, TMixtral)
    jm, tm = _quantized_pair(*classes, seed=9, n_kv_heads=2, max_seq_len=64)
    j_quantize(jm)
    quantize_module(tm)
    rs = np.random.RandomState(10)
    reqs = [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32), "max_new_tokens": 6,
             "temperature": 0.0, "seed": i} for i, n in enumerate((7, 13, 4))]
    kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,))
    ref = JServeEngine(jm, **kw).run(reqs)
    out = ServeEngine(tm, **kw).run(reqs)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)
