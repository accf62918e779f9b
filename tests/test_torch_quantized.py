"""The port's 8-bit AdamW against the JAX package's ``adamw_8bit``, on the
CPU.

Inputs are numpy arrays from a seed; the JAX functions run under
``jax.jit``, as the JAX trainer runs them.  ``blockwise_quantize``: the scales
bit for bit; the codes equal except where the value before rounding lies
within 1e-4 of a half-integer (the fourth root is the C library's
``powf`` under XLA and f64 rounded once in the port), and there at most 1
apart.  ``AdamW8bit``: ten steps on the f32 and on the bf16 parameters of tiny
Llama with the same seeded gradients on both sides, from a zero state and
from a JAX state carried over after three JAX steps, f32 parameters within
atol 1e-6, rtol 1e-5, bf16 ones within one bf16 ulp and equal on all but
a few in 10^3; per-group lr through ``with_param_groups``; the state-dict
round trip bit for bit.  ``adam8bit_state_shardings`` equal to JAX's spec for
spec over meshes of 2, 3 and 4 (every branch: ``n_blocks`` sharded, the
block dim, replicated, and ``count``), and ``load_jax_adam8bit_state`` of a
JAX state placed by that rule.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.optimizers import adamw_8bit as jadamw_8bit
from torchdistx_tpu.optimizers import quantized as jq
from torchdistx_tpu.optimizers import adam8bit_state_shardings as jstate_shardings
from torchdistx_tpu.optimizers import with_param_groups as jwith_param_groups
from torchdistx_tpu_torch.interop import load_jax_adam8bit_state
from torchdistx_tpu_torch.optimizers import (
    Adam8bitState,
    AdamW8bit,
    adam8bit_state_shardings,
    adamw_8bit,
    blockwise_dequantize,
    blockwise_quantize,
    with_param_groups,
)

TOL = dict(atol=1e-6, rtol=1e-5)
LR, WD = 1e-3, 0.01


def _near_half(pre):
    frac = np.abs(pre - np.floor(pre) - 0.5)
    return frac < 1e-4


@pytest.mark.parametrize("n,block", [(1000, 256), (4096, 256), (77, 32), (5, 256)])
@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_codes_and_scales_match_jax(n, block, signed):
    rs = np.random.RandomState(n + block)
    x = rs.randn(n).astype(np.float32) * np.float32(1e-3)
    if not signed:
        x = x * x
    x[: min(3, n)] = 0.0  # zeros, and a block of them when n is small
    quantize = jax.jit(jq.blockwise_quantize, static_argnums=1, static_argnames="signed")
    jc, js = quantize(jnp.asarray(x), block, signed=signed)
    tc, ts = blockwise_quantize(torch.from_numpy(x), block, signed=signed)
    jc, js = np.asarray(jc), np.asarray(js)
    assert tc.dtype == (torch.int8 if signed else torch.uint8)
    assert tc.shape == jc.shape and ts.shape == js.shape
    np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))
    pad = np.zeros(jc.size, np.float64)
    pad[:n] = x
    blocks = pad.reshape(jc.shape)
    amax = np.abs(blocks).max(1, keepdims=True)
    if signed:
        pre = blocks / np.maximum(amax * np.float32(1 / 127), 1e-30)
    else:
        pre = 255.0 * (blocks / np.maximum(amax, 1e-30)) ** 0.25
    diff = np.abs(tc.numpy().astype(np.int32) - jc.astype(np.int32))
    assert diff.max() <= 1
    assert not (diff[~_near_half(pre)]).any()
    back = blockwise_dequantize(tc, ts, x.shape).numpy()
    dequantize = jax.jit(jq.blockwise_dequantize, static_argnums=2)
    ref = np.asarray(dequantize(jnp.asarray(jc), jnp.asarray(js), x.shape))
    np.testing.assert_allclose(back, ref, rtol=1e-6, atol=0)


def _tiny_params():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(jm)
    return {k: np.asarray(v, np.float32) for k, v in jm.named_parameters()}


def _grads(params, steps, seed):
    rs = np.random.RandomState(seed)
    return [{k: (0.01 * rs.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
            for _ in range(steps)]


def _jax_steps(tx, p, s, grads):
    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    for g in grads:
        g = {k: jnp.asarray(v).astype(p[k].dtype) for k, v in g.items()}
        p, s = step(p, s, g)
    return p, s


def _torch_params(params, dtype=torch.float32):
    return {k: torch.nn.Parameter(torch.from_numpy(np.array(v, np.float32)).to(dtype))
            for k, v in params.items()}


def _torch_steps(opt, tparams, grads):
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy()).to(p.dtype)
        opt.step()


def _assert_state_matches(opt, tparams, js):
    names = sorted(tparams)
    for i, k in enumerate(names):
        st = opt.state[tparams[k]]
        np.testing.assert_array_equal(st["m_scales"].numpy(), np.asarray(js.m_scales[i]))
        np.testing.assert_array_equal(st["v_scales"].numpy(), np.asarray(js.v_scales[i]))
    assert opt.count == int(js.count)


def _assert_params_match(got, want, dtype, name):
    """f32: within TOL.  bf16: within one bf16 ulp of JAX's value (a
    code flipped at a half-integer, or an f32 update one ulp apart, moves
    the rounding of ``p + upd`` to bf16 by at most one step), and equal
    on all but a few elements in 10^3."""
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        return
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16  # f32 ulp -> bf16 ulp
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), (name, float(diff.max()))
    assert (diff != 0).mean() < 1e-3, (name, float((diff != 0).mean()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero_state", "jax_state"])
def test_ten_steps_match_jax(carried, dtype):
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = _tiny_params()
    grads = _grads(params, 13, seed=1)
    tx = jadamw_8bit(LR, weight_decay=WD)
    jp = {k: jnp.asarray(v).astype(jdtype) for k, v in params.items()}
    js = tx.init(jp)
    if carried:
        jp, js = _jax_steps(tx, jp, js, grads[:3])
    start = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tparams = _torch_params(start, dtype)
    opt = adamw_8bit(list(tparams.values()), LR, weight_decay=WD)
    if carried:
        load_jax_adam8bit_state(opt, tparams, js)
        _assert_state_matches(opt, tparams, js)
    jp, js = _jax_steps(tx, jp, js, grads[3:] if carried else grads[:10])
    _torch_steps(opt, tparams, grads[3:] if carried else grads[:10])
    assert opt.count == int(js.count) == 10 + 3 * carried
    moved = 0
    for k, p in tparams.items():
        assert p.dtype == dtype and jp[k].dtype == jdtype
        got = p.detach().float().numpy()
        _assert_params_match(got, np.asarray(jp[k], np.float32), dtype, k)
        moved += int((got != start[k]).sum())
    assert moved > 0.9 * sum(v.size for v in start.values())
    names = sorted(tparams)
    for i, k in enumerate(names):
        st = opt.state[tparams[k]]
        for f in ("m", "v"):
            codes = st[f"{f}_codes"].numpy().astype(np.int32)
            ref = np.asarray(getattr(js, f"{f}_codes")[i]).astype(np.int32)
            assert np.abs(codes - ref).max() <= 1, (k, f)
            assert (codes != ref).mean() < 1e-3, (k, f)


def test_per_group_lr_matches_jax():
    rs = np.random.RandomState(9)
    params = {"w": rs.randn(8, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)}
    grads = _grads(params, 3, seed=10)
    labels = {"w": "live", "b": "frozen"}
    tx = jwith_param_groups(jadamw_8bit, groups={"live": {}, "frozen": {"learning_rate": 0.0}},
                            labels=labels, learning_rate=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp, _ = _jax_steps(tx, jp, tx.init(jp), grads)
    tparams = _torch_params(params)
    opt = with_param_groups(adamw_8bit, {"live": {}, "frozen": {"lr": 0.0}}, labels,
                            tparams, learning_rate=1e-2)
    _torch_steps(opt, tparams, grads)
    np.testing.assert_array_equal(tparams["b"].detach().numpy(), params["b"])
    assert not np.allclose(tparams["w"].detach().numpy(), params["w"])
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_state_dict_round_trip(dtype):
    params = _tiny_params()
    grads = _grads(params, 6, seed=3)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
               for k, v in params.items()}
    opt = AdamW8bit(list(tparams.values()), lr=LR, weight_decay=WD, block_size=64)
    _torch_steps(opt, tparams, grads[:3])
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    twins = {k: torch.nn.Parameter(p.detach().clone()) for k, p in tparams.items()}
    other = AdamW8bit(list(twins.values()), lr=0.5, block_size=64)
    buf.seek(0)
    other.load_state_dict(torch.load(buf))
    assert other.count == 3 and other.param_groups[0]["lr"] == LR
    for k in tparams:
        a, b = opt.state[tparams[k]], other.state[twins[k]]
        assert a.keys() == b.keys()
        for f in a:
            assert a[f].dtype == b[f].dtype
            assert torch.equal(a[f], b[f]), (k, f)
    assert a["m_scales"].dtype == torch.float32 and a["v_codes"].dtype == torch.uint8
    _torch_steps(opt, tparams, grads[3:])
    _torch_steps(other, twins, grads[3:])
    for k in tparams:
        assert torch.equal(tparams[k], twins[k]), k
    n = sum(p.numel() for p in tparams.values())
    assert opt.state_bytes() == sum(
        2 * ((p.numel() + 63) // 64) * (64 + 4) for p in tparams.values())
    assert 2.0 < opt.state_bytes() / n < 2.5


# parameter shapes whose state takes every branch of the rule: at n = 4,
# (4096,) and (1000, 8) shard n_blocks (16, 32), (257, 64) and (64,) the
# block dim (65 and 1 blocks); at n = 3 (256 % 3 != 0) the latter replicate
STATE_SHAPES = [(4096,), (1000, 8), (257, 64), (64,), (1536,), (3, 5, 7)]


def _jmesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), ("fsdp",))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_state_shardings_equal_jax_spec_for_spec(n):
    from torchdistx_tpu_torch.parallel import AbstractMesh

    params = {f"p{i}": np.zeros(s, np.float32) for i, s in enumerate(STATE_SHAPES)}
    js = jadamw_8bit().init({k: jnp.asarray(v) for k, v in params.items()})
    want = jstate_shardings(js, _jmesh(n), "fsdp")
    tparams = _torch_params(params)
    state = AdamW8bit(list(tparams.values())).adam8bit_state(tparams)
    assert isinstance(state, Adam8bitState) and int(state.count) == 0
    got = adam8bit_state_shardings(state, AbstractMesh(np.arange(n), ("fsdp",)))
    assert got.count.spec == tuple(want.count.spec) == ()
    branches = set()
    for k in ("m_codes", "m_scales", "v_codes", "v_scales"):
        for x, g, w in zip(getattr(state, k), getattr(got, k), getattr(want, k)):
            assert g.spec == tuple(w.spec), (k, tuple(x.shape), g.spec, w.spec)
            branches.add(g.spec)
    assert branches == ({("fsdp", None), (None, "fsdp"), ()} if n != 3
                        else {("fsdp", None), ()})


def test_load_jax_state_placed_by_the_rule():
    params = _tiny_params()
    grads = _grads(params, 3, seed=5)
    tx = jadamw_8bit(LR, weight_decay=WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp, js = _jax_steps(tx, jp, tx.init(jp), grads)
    js = jax.device_put(js, jstate_shardings(js, _jmesh(4), "fsdp"))
    assert any(not x.sharding.is_fully_replicated for x in js.m_codes)
    tparams = _torch_params({k: np.asarray(v) for k, v in jp.items()})
    opt = adamw_8bit(list(tparams.values()), LR, weight_decay=WD)
    load_jax_adam8bit_state(opt, tparams, js)
    _assert_state_matches(opt, tparams, js)
    view = opt.adam8bit_state(tparams)
    for k in ("m_codes", "v_codes"):
        for got, want in zip(getattr(view, k), getattr(js, k)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
