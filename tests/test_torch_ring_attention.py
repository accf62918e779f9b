"""Sequence-parallel attention of the port against the JAX package, on the
CPU.

- The ``(m, l)`` residuals plain version (``flash_attention_residuals``,
  what the residuals kernel computes) against ``_flash_forward(
  return_residuals=True)`` in interpret mode: causal or not, GQA, an
  additive bias.  f32, rtol = atol = 1e-5 (the Pallas kernel folds its
  8-key blocks online, the plain version sums once).
- ``_ring_combine`` against JAX's, untouched rows (m = -1e30, l = 0)
  included; rtol = 1e-6.
- At world size 4 on ``gloo`` (one spawned world, ``tests/_torch_dist_worker.py``):
  ``ring_flash_attention`` and ``ring_attention`` forward and the
  gradients of ``sum(sin(out))`` against the JAX rings in ``shard_map`` on
  4 CPU devices, JAX's cases (hq, hkv, causal) = (4, 4, True), (8, 2,
  True), (4, 4, False) of ``tests/test_flash_attention.py`` (B 2, S 64,
  D 8), and with a (H, S_local, S) bias; ``ulysses_attention`` (plain and
  flash) and ``sp_attention`` against JAX's.  Tolerances the JAX test's:
  forward atol 2e-6, gradients atol 1e-5, in f32.
- Each JAX ``ValueError`` of these functions, raised by the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
from _torch_dist_worker import RING_CASES, RING_SHAPE, WORLD, attn_inputs, spawn_world
from torchdistx_tpu.ops import attention as JA
from torchdistx_tpu.ops.flash_attention import _flash_forward
from torchdistx_tpu.parallel.compat import shard_map
from torchdistx_tpu_torch.ops import attention as TA
from torchdistx_tpu_torch.ops import flash_attention as TF
from torchdistx_tpu_torch.parallel import create_mesh

FWD_ATOL, GRAD_ATOL = 2e-6, 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_world("ring", tmp_path_factory.mktemp("ring"))


def _got(ranks, name):
    res = [r[name] for r in ranks]
    for r in res:
        assert "error" not in r, r["error"]
    return res


# -- the residuals and the combine (one process) ------------------------------------


@pytest.mark.parametrize("hq,hkv,causal,bias,sq,skv", [
    (4, 4, True, False, 32, 32), (4, 4, False, False, 32, 32), (8, 2, True, False, 32, 32),
    (4, 4, False, True, 32, 32), (4, 4, True, True, 32, 32), (4, 2, True, False, 16, 32),
    (4, 4, False, False, 24, 40)])
def test_residuals_match_pallas(hq, hkv, causal, bias, sq, skv):
    rs = np.random.RandomState(hq * 7 + sq)
    q = rs.randn(2, sq, hq, 8).astype(np.float32)
    k, v = (rs.randn(2, skv, hkv, 8).astype(np.float32) for _ in range(2))
    b = (0.5 * rs.randn(hq, sq, skv)).astype(np.float32) if bias else None
    want = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          bias=None if b is None else jnp.asarray(b), causal=causal,
                          block_q=8, block_k=8, interpret=True, return_residuals=True)
    got = TF.flash_attention_residuals(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        bias=None if b is None else torch.from_numpy(b))
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_residuals_refuse_window_and_table():
    x = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no window"):
        TF.flash_fwd_cuda(x, x, x, return_residuals=True, window=4)
    with pytest.raises(ValueError, match="exclusive"):
        TF.flash_fwd_cuda(x, x, x, return_residuals=True, return_lse=True)


def test_ring_combine_matches_jax():
    rs = np.random.RandomState(0)
    b, hq, sq, d = 2, 4, 8, 8
    acc = rs.randn(b, hq, sq, d).astype(np.float32)
    m = rs.randn(b, hq, sq).astype(np.float32)
    m[:, :, :3] = -1e30  # untouched rows
    l = np.abs(rs.randn(b, hq, sq)).astype(np.float32)
    l[:, :, :3] = 0.0
    acc[:, :, :3] = 0.0
    raw = rs.randn(b, sq, hq, d).astype(np.float32)
    mj, lj = rs.randn(b, hq, sq).astype(np.float32), np.abs(rs.randn(b, hq, sq)).astype(np.float32)
    args = (acc, m, l, raw, mj, lj)
    want = JA._ring_combine(*map(jnp.asarray, args))
    got = TA._ring_combine(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# -- the rings at world size 4 -----------------------------------------------------------


def _mesh():
    return Mesh(np.array(jax.devices()[:WORLD]), ("sp",))


def _jax_ring(fn, arrays):
    specs = [P(None, "sp")] * 3 + [P(None, "sp", None)] * (len(arrays) - 3)
    f = shard_map(fn, mesh=_mesh(), in_specs=tuple(specs), out_specs=P(None, "sp"),
                  check_vma=False)
    xs = [jnp.asarray(a) for a in arrays]

    @jax.jit
    def out_and_grads(*a):
        # the gradients of sum(sin(out)): the cotangent cos(out)
        out, pull = jax.vjp(f, *a)
        return out, pull(jnp.cos(out))

    out, grads = out_and_grads(*xs)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check(ranks, name, fn, arrays):
    want_out, want_grads = _jax_ring(fn, arrays)
    got = _got(ranks, name)
    np.testing.assert_allclose(np.concatenate([r["out"] for r in got], 1), want_out,
                               atol=FWD_ATOL, rtol=0, err_msg="out")
    for i, w in enumerate(want_grads):
        g = np.concatenate([r["grads"][i] for r in got], 1)
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0, err_msg=f"grad {i}")


def _jax_flash_ring(causal):
    def f(q, k, v, bias=None):
        return JA.ring_flash_attention(q, k, v, axis="sp", causal=causal, bias=bias,
                                       block_q=8, block_k=8, interpret=True)
    return f


def _jax_plain_ring(causal):
    def f(q, k, v, bias=None):
        return JA.ring_attention(q, k, v, axis="sp", causal=causal, bias=bias)
    return f


@pytest.mark.parametrize("hq,hkv,causal", RING_CASES)
def test_ring_flash_attention_matches_jax(ranks, hq, hkv, causal):
    arrays = attn_inputs(**RING_SHAPE, hq=hq, hkv=hkv, seed=hq + hkv)
    _check(ranks, f"ring_flash_attention-{hq}-{hkv}-{causal}", _jax_flash_ring(causal), arrays)


@pytest.mark.parametrize("hq,hkv,causal", RING_CASES)
def test_ring_attention_matches_jax(ranks, hq, hkv, causal):
    arrays = attn_inputs(**RING_SHAPE, hq=hq, hkv=hkv, seed=hq + hkv)
    _check(ranks, f"ring_attention-{hq}-{hkv}-{causal}", _jax_plain_ring(causal), arrays)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("fn", ["ring_flash_attention", "ring_attention"])
def test_ring_with_bias_matches_jax(ranks, fn, causal):
    arrays = attn_inputs(**RING_SHAPE, hq=4, hkv=4, seed=8, bias=True)
    ring = _jax_flash_ring if fn == "ring_flash_attention" else _jax_plain_ring
    _check(ranks, f"{fn}-bias-{causal}", ring(causal), arrays)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_ulysses_matches_jax(ranks, flash, causal):
    arrays = attn_inputs(**RING_SHAPE, hq=8, hkv=4, seed=12)
    name = f"{'ulysses_flash' if flash else 'ulysses'}-{causal}"
    _check(ranks, name, lambda q, k, v: JA.ulysses_attention(
        q, k, v, axis="sp", causal=causal, use_flash=False), arrays)


@pytest.mark.parametrize("name,mode,hkv", [("sp_ring", "ring", 2), ("sp_ring_plain", "ring", 2),
                                           ("sp_ulysses", "ulysses", 4)])
def test_sp_attention_matches_jax(ranks, name, mode, hkv):
    arrays = attn_inputs(**RING_SHAPE, hq=8, hkv=hkv, seed=8 + hkv)
    _check(ranks, name, lambda q, k, v: JA.sp_attention(
        q, k, v, axis="sp", mode=mode, causal=True, use_flash=False), arrays)


# -- the argument checks -----------------------------------------------------------------


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_unequal_shard_lengths_rejected():
    want = _jax_error(lambda: JA.ring_flash_attention(
        jnp.zeros((1, 8, 4, 8)), jnp.zeros((1, 16, 4, 8)), jnp.zeros((1, 16, 4, 8)),
        axis="sp", causal=True))
    with pytest.raises(ValueError) as e:
        TA.ring_flash_attention(torch.zeros((1, 8, 4, 8)), torch.zeros((1, 16, 4, 8)),
                                torch.zeros((1, 16, 4, 8)), axis="sp", causal=True)
    assert str(e.value) == want


@pytest.mark.parametrize("kw", [dict(mode="ulysses", bias=True), dict(mode="tree")],
                         ids=["ulysses_bias", "bad_mode"])
def test_sp_attention_argument_errors(kw):
    def call(mod, zeros):
        z = zeros((1, 8, 4, 8))
        bias = zeros((4, 8, 8)) if kw.get("bias") else None
        return mod.sp_attention(z, z, z, axis="sp", mode=kw["mode"], bias=bias)

    want = _jax_error(lambda: call(JA, jnp.zeros))
    with pytest.raises(ValueError) as e:
        call(TA, torch.zeros)
    assert str(e.value) == want


@pytest.mark.parametrize("name,match", [
    ("err_ulysses_heads", "ulysses_attention needs head counts divisible by the axis size"),
    ("err_ring_bias", r"ring_flash_attention bias shape \(4, 8, 8\) != \(H, sq_local, S_global\)"),
    ("err_ring_attention_bias", r"ring_attention bias shape \(4, 8, 8\) != "),
])
def test_world_argument_errors(ranks, name, match):
    import re

    for r in _got(ranks, name):
        assert r["message"] is not None and re.match(match, r["message"]), r


def test_world_one_ring_is_flash():
    """At axis size 1 the ring is one diagonal block: flash attention."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(1, 16, h, 8).astype(np.float32)) for h in (4, 2, 2))
    with create_mesh({"sp": 1}):
        out = TA.ring_flash_attention(q, k, v, axis="sp")
    torch.testing.assert_close(out, TF.flash_attention(q, k, v), rtol=0, atol=FWD_ATOL)
