"""The port's vision ``nn`` pieces against the JAX package's, on the CPU.

``conv2d`` (stride, dilation, groups; int, pair and asymmetric padding;
with and without bias), ``max_pool2d`` and ``avg_pool2d`` with padding,
``softmax`` / ``log_softmax``, ``BatchNorm2d`` in training and eval mode,
the activation layers and the containers: the same numpy inputs through
the JAX function (XLA on the CPU) and the port's.  ``dropout`` cannot
draw JAX's bits (a ``torch.Generator`` takes the place of the key): its
identity cases are held exactly, and with a generator each value is
``x / keep`` or 0 and the kept share lies within 6 standard deviations of
``keep`` (a false alarm about once in 5e8 runs).

Tolerances: f32 atol = rtol = 1e-5 (the same math, sums in another
order); bf16 one bf16 ulp of each element's magnitude, floored at the
ulp of 2**-6 of the output's largest magnitude (a result of cancellation
keeps the absolute error of its operands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu import nn as jnn
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch import nn as tnn
from torchdistx_tpu_torch.interop import load_jax_buffers, load_jax_params
from torchdistx_tpu_torch.nn import functional as tF

F32 = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               **(tol or F32))


def _bf16_ulp_close(t, j):
    """|t - j| within one bf16 ulp of each element (see the docstring)."""
    t = t.detach().float().numpy()
    j = np.asarray(j, np.float32)
    floor = np.abs(j).max() * 2.0 ** -6
    scale = np.maximum(np.abs(j), floor)
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    err = np.abs(t - j)
    assert np.all(err <= ulp), float((err / ulp).max())


CONV_CASES = [
    # stride, padding, dilation, groups, bias
    (1, 0, 1, 1, True),
    (1, 1, 1, 1, False),
    (2, 1, 1, 1, True),
    (2, (1, 2), 1, 1, False),
    (1, ((1, 0), (2, 1)), 1, 1, True),
    (2, ((0, 2), (1, 0)), 1, 2, False),
    (1, 2, 2, 1, True),
    ((2, 1), (0, 1), (1, 2), 2, True),
    (1, 1, 1, 4, False),
]


@pytest.mark.parametrize("stride,padding,dilation,groups,bias", CONV_CASES)
def test_conv2d_matches_jax(stride, padding, dilation, groups, bias):
    x = _rand(0, 2, 4, 9, 11)
    w = _rand(1, 8, 4 // groups, 3, 3)
    b = _rand(2, 8) if bias else None
    jy = jF.conv2d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                   stride=stride, padding=padding, dilation=dilation, groups=groups)
    ty = tF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   None if b is None else torch.from_numpy(b),
                   stride=stride, padding=padding, dilation=dilation, groups=groups)
    assert tuple(ty.shape) == jy.shape
    _close(ty, jy)


def test_conv2d_bf16_within_an_ulp_and_rejects_bad_padding():
    x, w, b = _rand(3, 2, 4, 8, 8), _rand(4, 6, 4, 3, 3), _rand(5, 6)
    jy = jF.conv2d(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)), stride=2,
                   padding=((1, 0), (0, 1)))
    ty = tF.conv2d(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)), stride=2,
                   padding=((1, 0), (0, 1)))
    # XLA and oneDNN sum the 36 products in other orders: a few f32 ulps
    # before the bf16 rounding, which then differs by at most one ulp
    _bf16_ulp_close(ty, jy)
    with pytest.raises(ValueError, match="padding"):
        tF.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=((1, 1),) * 3)


POOL_CASES = [
    # window, stride, padding
    (3, 2, 1),
    ((2, 3), None, 0),
    (3, 1, ((0, 0), (0, 0), (1, 2), (0, 1))),
    (2, (1, 2), 1),
]


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("window,stride,padding", POOL_CASES)
def test_pools_match_jax(kind, window, stride, padding):
    x = _rand(6, 2, 3, 7, 10)
    jfn = jF.max_pool2d if kind == "max" else jF.avg_pool2d
    tfn = tF.max_pool2d if kind == "max" else tF.avg_pool2d
    jy = jfn(jnp.asarray(x), window, stride=stride, padding=padding)
    ty = tfn(torch.from_numpy(x), window, stride=stride, padding=padding)
    assert tuple(ty.shape) == jy.shape
    _close(ty, jy)


def test_avg_pool_divides_by_the_whole_window_at_the_edges():
    ty = tF.avg_pool2d(torch.ones(1, 1, 2, 2), 3, stride=1, padding=1)
    # every 3 x 3 window holds the 4 ones and 5 zeros of padding
    torch.testing.assert_close(ty, torch.full((1, 1, 2, 2), 4 / 9))
    tm = tF.max_pool2d(-torch.ones(1, 1, 2, 2), 3, stride=1, padding=1)
    torch.testing.assert_close(tm, -torch.ones(1, 1, 2, 2))  # -inf padding


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_and_log_softmax_match_jax(axis):
    x = 3.0 * _rand(7, 4, 5, 6)
    _close(tF.softmax(torch.from_numpy(x), axis=axis), jF.softmax(jnp.asarray(x), axis=axis))
    _close(tF.log_softmax(torch.from_numpy(x), axis=axis),
           jF.log_softmax(jnp.asarray(x), axis=axis))


def _bn_pair(dtype, seed=8, c=6):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jbn = jnn.BatchNorm2d(c, dtype=jdt)
    rs = np.random.RandomState(seed)
    params = {"weight": rs.uniform(0.5, 1.5, c), "bias": rs.randn(c)}
    bufs = {"running_mean": rs.randn(c), "running_var": rs.uniform(0.5, 2.0, c)}
    params = {k: np.asarray(jnp.asarray(v, jdt)) for k, v in params.items()}
    bufs = {k: np.asarray(jnp.asarray(v, jdt)) for k, v in bufs.items()}
    tbn = tnn.BatchNorm2d(c, dtype=tdt, device="cpu")
    load_jax_params(tbn, params)
    load_jax_buffers(tbn, bufs)
    return jbn, {**params, **bufs}, tbn, jdt, tdt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_jax(dtype, training):
    jbn, state, tbn, jdt, tdt = _bn_pair(dtype)
    x = 2.0 * _rand(9, 4, 6, 5, 7) + 0.5
    jbn.train(training)
    tbn.train(training)
    jy = functional_call(jbn, {k: jnp.asarray(v) for k, v in state.items()},
                         (jnp.asarray(x, jdt),))
    before = {k: b.clone() for k, b in tbn.named_buffers()}
    ty = tbn(torch.from_numpy(x).to(tdt))
    assert ty.dtype == tdt
    if dtype == "f32":
        _close(ty, jy)
    else:
        _bf16_ulp_close(ty, jy)
    # the JAX semantics: a training forward never touches the running stats
    for k, b in tbn.named_buffers():
        assert torch.equal(b, before[k]), k


def test_batchnorm_registers_buffers_and_defers_them():
    tt.manual_seed(0)
    bn = tt.deferred_init(tnn.BatchNorm2d, 5, device="cpu")
    assert sorted(k for k, _ in bn.named_buffers()) == ["running_mean", "running_var"]
    assert all(tt.is_fake(b) for b in bn.buffers())
    tt.materialize_module(bn)
    torch.testing.assert_close(bn.running_mean, torch.zeros(5))
    torch.testing.assert_close(bn.running_var, torch.ones(5))
    assert bn.momentum == 0.1 and not tt.is_deferred(bn)


def test_dropout_identity_cases():
    x = torch.from_numpy(_rand(10, 3, 4))
    g = torch.Generator().manual_seed(0)
    assert tF.dropout(x, 0.5) is x  # no generator: the JAX function with no key
    assert tF.dropout(x, 0.0, g) is x
    assert tF.dropout(x, 0.5, g, training=False) is x
    jx = jnp.asarray(x.numpy())
    assert jF.dropout(jx, 0.5) is jx and jF.dropout(jx, 0.0, key=1) is jx
    layer = tnn.Dropout(0.5).eval()
    assert layer(x, g) is x


def test_dropout_with_a_generator_keeps_within_a_stated_bound():
    n, rate = 200_000, 0.3
    keep = 1.0 - rate
    x = torch.from_numpy(np.random.RandomState(11).uniform(1.0, 2.0, n).astype(np.float32))
    y = tF.dropout(x, rate, torch.Generator().manual_seed(1))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / keep, atol=0, rtol=0)
    share = kept.double().mean().item()
    assert abs(share - keep) <= 6 * (keep * rate / n) ** 0.5, share
    y2 = tnn.Dropout(rate)(x, torch.Generator().manual_seed(1))
    assert torch.equal(y2, y)  # one generator state, one mask


def test_activation_layers_match_jax():
    x = _rand(12, 3, 17)
    for jl, tl in ((jnn.ReLU(), tnn.ReLU()), (jnn.GELU(), tnn.GELU()), (jnn.SiLU(), tnn.SiLU())):
        _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))


def test_containers_name_children_as_jax_does():
    tdx.manual_seed(0)
    jseq = jnn.Sequential(jnn.Conv2d(3, 4, 3), jnn.BatchNorm2d(4), jnn.ReLU())
    tseq = tnn.Sequential(tnn.Conv2d(3, 4, 3, device="cpu"),
                          tnn.BatchNorm2d(4, device="cpu"), tnn.ReLU())
    assert [k for k, _ in tseq.named_parameters()] == [k for k, _ in jseq.named_parameters()]
    assert [k for k, _ in tseq.named_buffers()] == [k for k, _ in jseq.named_buffers()]
    load_jax_params(tseq, {k: np.asarray(v) for k, v in jseq.named_parameters()})
    x = _rand(13, 2, 3, 6, 6)
    _close(tseq(torch.from_numpy(x)), jseq(jnp.asarray(x)))
    assert len(tnn.Sequential()) == 0 and len(tseq) == 3
    mods = tnn.ModuleList([tnn.ReLU(), tnn.GELU()])
    assert [k for k, _ in mods.named_children()] == ["0", "1"]
    with pytest.raises(NotImplementedError):
        mods(torch.zeros(1))


def test_conv2d_layer_init_bounds_and_names():
    tt.manual_seed(3)
    conv = tnn.Conv2d(8, 6, (3, 5), stride=2, groups=2, device="cpu")
    assert conv.weight.shape == (6, 4, 3, 5) and conv.bias.shape == (6,)
    fan_in = 4 * 3 * 5
    # kaiming_uniform(a=sqrt(5)) bound sqrt(6 / ((1 + 5) * fan_in)) = 1 / sqrt(fan_in)
    assert conv.weight.abs().max() <= fan_in ** -0.5
    assert conv.bias.abs().max() <= fan_in ** -0.5
    assert tnn.Conv2d(3, 4, 1, bias=False, device="cpu").bias is None
    x = torch.from_numpy(_rand(14, 2, 8, 9, 9))
    torch.testing.assert_close(conv(x), tF.conv2d(x, conv.weight, conv.bias, stride=2,
                                                  groups=2))
