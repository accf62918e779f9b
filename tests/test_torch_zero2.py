"""The port's ZeRO-2 (``ShardingPlan(zero2=True)`` through ``GSPMDTrainStep``)
at world size 4 on ``gloo`` (one spawned world, the ``zero2`` suite of
``tests/_torch_dist_worker.py``): the port's own copy of
``tests/test_plan.py::TestZero2``'s oracle.

Tiny Llama (f32) with the JAX model's weights, momentum SGD (lr 0.1,
momentum 0.9: param-shaped slots, no scalar leaf), ``test_plan.py``'s
batch of globally unique tokens over ``{"dp": 4}``, 10 steps:

- parameters and losses bit-equal to the replicated-optimizer oracle run
  in the same world (the update is elementwise, so slicing it changes no
  bit);
- the optimizer bytes a rank holds are 1/dp of the oracle's, and the
  derived slot shardings are ``dp`` over each parameter's first dimension;
- ``zero2_participating_bytes`` equals JAX's for the same plan;
- the trajectory against JAX's ``GSPMDTrainStep`` on 4 CPU devices with the
  replicated optimizer (JAX's own ZeRO-2 step is not the reference: its
  bitwise oracle test fails on the JAX package's tree): losses rtol 1e-5,
  parameters rtol 1e-4 / atol 1e-5 after 10 steps.

The ZeRO-2 bounce: ``on_failure="reshard"`` with ``inject_device_loss(2)``
after step 4 on ``{"dp": 4}``: the momentum's ``dp`` slices go through the
checkpoint and are cut again over ``{"dp": 2}`` (ranks 0 and 1; 2 and 3
leave), then 2 steps.  Against JAX's ``Trainer.reshard`` of its
``GSPMDTrainStep`` on the same plan (4 -> 2 CPU devices): the momentum
(gathered) and the parameters after the 2 steps within rtol 1e-4 / atol
1e-5, the losses within rtol 1e-5; each rank then holds half of every
slot, each cut on the parameter's first dimension over the new ``dp``.

Also ``build_train_workload("tiny", zero2=True)`` (the plan on every rank,
``min_shard_elems=1``; its bytes a rank 1/4), and the 8-bit AdamW, whose
blockwise state the step leaves whole (no parameter sliced), as the JAX
plan leaves its flat code lists replicated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import (WORLD, ZERO2_AFTER, ZERO2_INJECT, ZERO2_LR, ZERO2_MOMENTUM,
                                ZERO2_STEPS, spawn_world, zero2_batch)
from torchdistx_tpu.trainer import Trainer as JTrainer
from torchdistx_tpu.utils.failure import FailureDetector as JFailureDetector
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.parallel import GSPMDTrainStep as JStep
from torchdistx_tpu.parallel import ShardingPlan as JPlan
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh


def _jax_model():
    tdx.manual_seed(0)
    m = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(m)
    return m, {k: np.asarray(v) for k, v in m.named_parameters()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, init = _jax_model()
    tmp = tmp_path_factory.mktemp("zero2")
    return spawn_world("zero2", tmp, {"init": init, "tmp": str(tmp)}, timeout=150.0)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _mesh():
    return jcreate_mesh({"dp": WORLD}, devices=jax.devices()[:WORLD])


def test_ten_steps_bitwise_vs_replicated_oracle(world):
    for r in _got(world, "ten_steps"):
        assert r["sliced"] == len(r["params"])  # every parameter's update is sliced
        for k, v in r["oracle"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
        assert r["losses"] == r["oracle_losses"]
        # the parameters stay replicated
        assert all(spec == () for spec in r["specs"].values())


def test_optimizer_bytes_per_rank_are_one_over_dp(world):
    for r in _got(world, "ten_steps"):
        total, local = r["bytes"]
        assert (total, total) == tuple(r["oracle_bytes"])
        assert local * WORLD == total
        for name, row in r["derived"].items():
            assert row == {"momentum_buffer": ("dp",) + (None,) * (len(
                r["params"][name].shape) - 1)}, name


def test_participating_bytes_equal_jax(world):
    jm, init = _jax_model()
    plan = JPlan(_mesh(), dp_axis="dp", zero2=True, min_shard_elems=1)
    want = plan.zero2_participating_bytes({k: jnp.asarray(v) for k, v in init.items()})
    assert want == sum(v.nbytes for v in init.values())
    for r in _got(world, "ten_steps"):
        assert r["participating"] == want


def test_zero2_trajectory_matches_jax_gspmd_step(world):
    jm, init = _jax_model()
    mesh = _mesh()

    def loss_fn(p, batch):
        return jF.cross_entropy(functional_call(jm, p, (batch[0],)), batch[1])

    step = JStep(loss_fn, optax.sgd(ZERO2_LR, momentum=ZERO2_MOMENTUM), mesh,
                 batch_spec=P("dp"))
    params = jax.device_put({k: jnp.asarray(v) for k, v in init.items()},
                            NamedSharding(mesh, P()))
    state = step.init_optimizer(params)
    batch = tuple(jnp.asarray(a.astype(np.int32)) for a in zero2_batch())
    losses = []
    for _ in range(ZERO2_STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    for r in _got(world, "ten_steps"):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(r["params"][k], np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_build_train_workload_zero2(world):
    for r in _got(world, "workload"):
        assert r["plan"] == f"zero2(dp={WORLD})" and r["zero2_dp"] == WORLD
        assert len(r["losses"]) == 2 and all(np.isfinite(r["losses"]))
        total, local = r["bytes"]
        # AnyPrecisionAdamW: two param-shaped slots (f32, bf16) a parameter,
        # sliced 1/dp, and a scalar step count each
        assert local < total and r["participating"] > 0
        # the ring all-gather of the participating bytes, (n - 1) / n of them
        assert r["step_wire"] == r["participating"] * (WORLD - 1) // WORLD


def test_eight_bit_state_stays_whole(world):
    for r in _got(world, "eight_bit"):
        assert r["sliced"] == 0


def test_zero2_bounce_4_to_2_matches_jax_reshard(world, tmp_path):
    jm, init = _jax_model()
    mesh = _mesh()

    def loss_fn(p, batch):
        return jF.cross_entropy(functional_call(jm, p, (batch[0],)), batch[1])

    plan = JPlan(mesh, dp_axis="dp", zero2=True, min_shard_elems=1)
    step = JStep(loss_fn, optax.sgd(ZERO2_LR, momentum=ZERO2_MOMENTUM), mesh,
                 batch_spec=P("dp"), plan=plan)
    params = jax.device_put({k: jnp.asarray(v) for k, v in init.items()},
                            NamedSharding(mesh, P()))
    det, logs = JFailureDetector(), []
    tr = JTrainer(step, params, step.init_optimizer(params), checkpoint_dir=str(tmp_path),
                  checkpoint_every=100, log_every=1, log_fn=logs.append,
                  failure_detector=det, on_failure="reshard")
    batch = tuple(jnp.asarray(a.astype(np.int32)) for a in zero2_batch())
    tr.fit([batch] * ZERO2_INJECT)
    det.inject_device_loss(2)
    tr.fit([batch] * (1 + ZERO2_AFTER))
    assert tr.step.mesh.devices.size == 2
    jparams = {k: np.asarray(v) for k, v in tr.params.items()}
    (trace,) = [s for s in jax.tree_util.tree_leaves(
        tr.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    jmomentum = {k: np.asarray(v) for k, v in trace.trace.items()}
    for rank, r in enumerate(_got(world, "bounce")):
        (fail,) = r["logs"]
        assert fail["failure"] == "device_loss" and fail["action"] == "resharded"
        last = r["last"]
        assert last["step"] == ZERO2_INJECT + 1 and last["mode"] == "checkpoint"
        assert last["mesh_from"] == {"dp": WORLD} and last["mesh_to"] == {"dp": 2}
        assert r["departed"] is (rank >= 2)
        if rank >= 2:
            continue
        assert r["mesh"] == {"dp": 2} and r["global_step"] == ZERO2_INJECT + 1 + ZERO2_AFTER
        assert r["sliced"] == len(init)
        total, local = r["bytes"]
        assert local * 2 == total == sum(v.nbytes for v in init.values())
        assert all(spec[0] == "dp" for spec in r["specs"].values())
        assert len(r["losses"]) == ZERO2_INJECT + 1 + ZERO2_AFTER
        jlosses = [m["loss"] for m in logs if "loss" in m and "failure" not in m]
        np.testing.assert_allclose(r["losses"][-ZERO2_AFTER:], jlosses[-ZERO2_AFTER:],
                                   rtol=1e-5)
        for k, v in jparams.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(r["momentum"][k], jmomentum[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
