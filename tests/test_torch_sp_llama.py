"""Sequence-parallel Llama of the port (``sp_axis="sp"``) at world size 4
on ``gloo``, against the JAX package on 4 of the 8 CPU devices.

- Logits of tiny Llama (f32, B 2 x S 64, 16 tokens a rank) with the JAX
  weights (``load_jax_params``): the flash ring, the plain ring and
  Ulysses, each against JAX's sharded model in the same mode (``shard_map``
  over ``functional_call``; the flash ring through the Pallas kernels in
  interpret mode) and against the unsharded JAX model.  atol 2e-5, rtol
  1e-5, as ``tests/test_flash_attention.py`` holds JAX's own.
- 2 ``ShardedTrainStep`` steps with ``batch_spec=(None, "sp")`` and
  AnyPrecisionAdamW (lr 1e-3, f32 variance) against JAX's
  ``ShardedTrainStep`` (its ring on the CPU is the plain one): the flash
  ring over ``{"sp": 4}``, the plain ring over ``{"fsdp": 2, "sp": 2}``
  with FSDP, Ulysses over ``{"sp": 4}``.  Under SP the gradient of every
  parameter is the mean over ``sp`` of the shards' gradients: a sum would
  be off by 4.  Tolerances those of ``tests/test_torch_train.py``.
- ``sliding_window`` with ``sp_axis`` raises, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import WORLD, lm_batch, spawn_world
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.parallel import ShardedTrainStep as JStep
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel.compat import shard_map
from torchdistx_tpu_torch.models import Llama as TLlama

LR, STEPS, SEQ = 1e-3, 2, 64
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)
# case -> JAX model overrides
LOGITS = {"logits_ring_flash": dict(use_flash=True), "logits_ring_plain": dict(use_flash=False),
          "logits_ulysses": dict(use_flash=False, sp_mode="ulysses")}
# case -> (mesh, JAX model overrides, shard_axis)
TRAINS = {"train_ring_flash": ({"sp": 4}, dict(use_flash=False), None),
          "train_ring_plain_fsdp2_sp2": ({"fsdp": 2, "sp": 2}, dict(use_flash=False), "fsdp"),
          "train_ulysses": ({"sp": 4}, dict(use_flash=False, sp_mode="ulysses"), None)}


def _jax_model(**kw):
    tdx.manual_seed(3)
    m = tdx.deferred_init(JLlama.from_name, "tiny", max_seq_len=SEQ, **kw)
    tdx.materialize_module(m)
    return m


def _tokens():
    return np.random.RandomState(0).randint(0, 256, (2, SEQ)).astype(np.int64)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    init = {k: np.asarray(v) for k, v in _jax_model().named_parameters()}
    payload = dict(init=init, tokens=_tokens(), lr=LR, steps=STEPS, batch=lm_batch(2, SEQ))
    return spawn_world("sp_llama", tmp_path_factory.mktemp("sp_llama"), payload)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _mesh(axes):
    return jcreate_mesh(axes, devices=jax.devices()[:WORLD])


@pytest.mark.parametrize("name", list(LOGITS))
def test_sp_logits_match_jax(world, name):
    mesh = _mesh({"sp": WORLD})
    m_sp = _jax_model(sp_axis="sp", **LOGITS[name])
    params = jax.device_put(dict(m_sp.named_parameters()), NamedSharding(mesh, P()))
    toks = jnp.asarray(_tokens().astype(np.int32))
    want_sp = jax.jit(shard_map(lambda t: functional_call(m_sp, params, (t,)), mesh=mesh,
                                in_specs=P(None, "sp"), out_specs=P(None, "sp"),
                                check_vma=False))(toks)
    m_ref = _jax_model(use_flash=False)
    want = jax.jit(lambda p, t: functional_call(m_ref, p, (t,)))(
        dict(m_ref.named_parameters()), toks)
    got = np.concatenate([r["logits"] for r in _got(world, name)], axis=1)
    np.testing.assert_allclose(got, np.asarray(want_sp), **LOGIT_TOL, err_msg="vs sharded")
    np.testing.assert_allclose(got, np.asarray(want), **LOGIT_TOL, err_msg="vs unsharded")


def _jax_train(axes, kw, shard_axis):
    jm = _jax_model(sp_axis="sp", **kw)
    tx = anyprecision_adamw(LR, variance_dtype=jnp.float32)

    def loss_fn(p, b):
        return jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1])

    step = JStep(loss_fn, tx, _mesh(axes), shard_axis=shard_axis, batch_spec=P(None, "sp"))
    params = step.shard_params(dict(jm.named_parameters()))
    opt = step.init_optimizer(params)
    batch = tuple(jnp.asarray(a.astype(np.int32)) for a in lm_batch(2, SEQ))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("name", list(TRAINS))
def test_sp_train_steps_match_jax(world, name):
    losses, params = _jax_train(*TRAINS[name])
    for r in _got(world, name):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-5)
        for k, w in params.items():
            diff = np.abs(r["params"][k] - w)
            assert diff.max() <= 1e-4, (k, diff.max())
            assert np.mean(diff <= 1e-5) >= 0.999, (k, np.mean(diff <= 1e-5))


def test_sliding_window_with_sp_axis_raises():
    with pytest.raises(ValueError, match="sliding_window is not supported together with sp_axis"):
        _jax_model(sp_axis="sp", sliding_window=8)
    with pytest.raises(ValueError, match="sliding_window is not supported together with sp_axis"):
        TLlama.from_name("tiny", device="cpu", sp_axis="sp", sliding_window=8)


def test_bad_sp_mode_raises():
    with pytest.raises(ValueError, match="sp_mode must be 'ring' or 'ulysses'"):
        _jax_model(sp_axis="sp", sp_mode="tree")
    with pytest.raises(ValueError, match="sp_mode must be 'ring' or 'ulysses'"):
        TLlama.from_name("tiny", device="cpu", sp_axis="sp", sp_mode="tree")
