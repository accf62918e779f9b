"""The port's FSDP layer (``parallel.fsdp``, sharded ``materialize_module``)
at world size 4 on ``gloo``, against the JAX package on 4 of the 8 CPU
devices.

- ``fsdp_partition_spec`` equals JAX's for a table of shapes.
- ``materialize_module(sharding_rule=fsdp_shard_rule(mesh))`` of tiny Llama:
  every rank's piece is bit-identical to the same slice of an eager
  construction from the same seed, under JAX's spec, and the record
  session keeps no full copy of a tensor it cut.
- 3 ``ShardedTrainStep`` steps of tiny Llama (f32) against JAX's
  ``ShardedTrainStep`` from the same weights (``load_jax_params``) with
  AnyPrecisionAdamW (lr 1e-3, f32 variance) on both sides: at fsdp 4, and
  at dp 2 x fsdp 2 with ``allreduce_hook`` and with ``noop_hook`` (whose
  dp replicas diverge; JAX's arrays read back the dp = 0 replica, so the
  port's dp = 0 ranks are held), and at fsdp 4 with ``accum_steps=2``
  (batch 8 x 32 in all).  Tolerances those of
  ``tests/test_torch_train.py``: losses rtol = atol = 1e-5; parameters all
  within 1e-4 (a tenth of one step) and 99.9% within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
import torchdistx_tpu_torch as tt
from _torch_dist_worker import WORLD, lm_batch, spawn_world
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.parallel import ShardedTrainStep as JStep
from torchdistx_tpu.parallel import allreduce_hook as jallreduce
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel import fsdp_partition_spec as jspec
from torchdistx_tpu.parallel import noop_hook as jnoop
from torchdistx_tpu_torch.models import Llama as TLlama

LR, STEPS = 1e-3, 3
SHAPES = [(4096, 1024), (1000, 8), (3, 4096), (7, 13, 16), (64,), (8, 128), (1023, 1),
          (4, 4, 64), (1, 1024), (2, 512), (256, 64), (6, 6, 6, 6)]
TRAINS = {
    "train_fsdp4": ({"fsdp": 4}, dict(shard_axis="fsdp"), False),
    "train_dp2_fsdp2_allreduce": ({"dp": 2, "fsdp": 2},
                                  dict(shard_axis="fsdp", replica_axes=("dp",),
                                       comm_hook=jallreduce), False),
    "train_dp2_fsdp2_noop": ({"dp": 2, "fsdp": 2},
                             dict(shard_axis="fsdp", replica_axes=("dp",), comm_hook=jnoop),
                             True),
    "train_fsdp4_accum2": ({"fsdp": 4}, dict(shard_axis="fsdp", accum_steps=2,
                                             batch_axes=("fsdp",)), False),
}


def _jax_init():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(jm)
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, init = _jax_init()
    payload = dict(init=init, lr=LR, steps=STEPS, batch=lm_batch(8, 32), shapes=SHAPES)
    return spawn_world("fsdp", tmp_path_factory.mktemp("fsdp"), payload)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _mesh(axes):
    return jcreate_mesh(axes, devices=jax.devices()[:WORLD])


def test_fsdp_partition_spec_matches_jax(world):
    mesh = _mesh({"fsdp": WORLD})
    want = [tuple(jspec(s, mesh, "fsdp")) for s in SHAPES]
    for r in _got(world, "specs"):
        assert [tuple(s) for s in r["specs"]] == want


def test_sharded_materialize_is_the_eager_slice(world):
    tt.manual_seed(7)
    eager = dict(TLlama.from_name("tiny", device="cpu").named_parameters())
    mesh = _mesh({"fsdp": WORLD})
    got = _got(world, "materialize")
    # each cut tensor's full value was dropped once its piece was taken:
    # the session keeps only the replicated (uncut) ones
    uncut = sum(p.numel() * p.element_size() for p in eager.values()
                if "fsdp" not in jspec(p.shape, mesh, "fsdp"))
    assert [r["_cached_bytes"] for r in got] == [uncut] * WORLD
    for name, full in eager.items():
        spec = tuple(jspec(full.shape, mesh, "fsdp"))
        for rank, res in enumerate(got):
            r = res[name]
            assert r["is_param"] and tuple(r["spec"]) == spec and r["shape"] == tuple(full.shape)
            want = full.detach().numpy()
            if "fsdp" in spec:
                want = np.split(want, WORLD, axis=spec.index("fsdp"))[rank]
            np.testing.assert_array_equal(r["piece"], want, err_msg=f"{name} rank {rank}")


def _jax_train(axes, kw):
    jm, init = _jax_init()
    tx = anyprecision_adamw(LR, variance_dtype=jnp.float32)

    def loss_fn(p, b):
        return jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1])

    step = JStep(loss_fn, tx, _mesh(axes), **kw)
    params = step.shard_params({k: jnp.asarray(v) for k, v in init.items()})
    opt = step.init_optimizer(params)
    batch = tuple(jnp.asarray(a.astype(np.int32)) for a in lm_batch(8, 32))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


def _close_params(got, want):
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 1e-4, (name, diff.max())
        assert np.mean(diff <= 1e-5) >= 0.999, (name, np.mean(diff <= 1e-5))


@pytest.mark.parametrize("name", list(TRAINS))
def test_sharded_train_step_matches_jax(world, name):
    axes, kw, first_replica_only = TRAINS[name]
    losses, params = _jax_train(axes, kw)
    for r in _got(world, name):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-5)
        if first_replica_only and r["coords"]["dp"] != 0:
            continue
        _close_params(r["params"], params)
