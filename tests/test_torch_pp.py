"""The port's pipeline parallelism (``parallel.pp``) against the JAX
package's, the cases of ``tests/test_pp.py``, at world size 4 on ``gloo``
(one spawned world, the ``pp`` suite of ``tests/_torch_dist_worker.py``);
the JAX side runs on the CPU devices in the parent.

- ``pipeline_apply`` (GPipe) on ``{"pp": 4}`` against the sequential run,
  6 microbatches and 5 (not a multiple of the stages): rtol / atol 2e-6, as
  ``test_pp.py``; its gradients through autograd against ``jax.grad`` of
  the sequential loss (rtol 1e-5, atol 1e-6), and 5 SGD steps through it
  against JAX's ``test_jit_and_train`` loop (losses rtol 1e-5).
- ``pipeline_train_step`` (1F1B) against JAX's ``pipeline_train_step``:
  loss rtol 1e-6, every stage's gradients rtol 1e-5 / atol 1e-6, for 6
  microbatches on 4 stages, 2 on 4 (fewer than the stages) and dp x pp
  (``{"dp": 2, "pp": 2}``, the batch over dp); 8 SGD steps against JAX's
  ``test_training_reduces_loss`` loop (losses rtol 1e-5).
- tp x pp through ``param_specs`` (``{"tp": 2, "pp": 2}``, Megatron MLP
  stages carrying ``copy_psum_grad`` / ``allreduce_linear``): the forward
  (rtol 1e-5, atol 1e-6) and the 1F1B loss and gradients against JAX's
  (rtol 1e-5, atol 1e-6), each rank's gradients in its tp-local layout.
- deferred-init Llama stages (``models.llama.pp_stage``) on ``{"dp": 2,
  "pp": 2}`` against the port's unpipelined run of the same stages (loss
  rtol 1e-5, gradients rtol 2e-4 / atol 1e-5, ``test_pp.py``'s).
- a stage count that is not the axis's raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
from _torch_dist_worker import (PP_APPLY, PP_TP_SPECS, PP_TRAINS, WORLD, pp_inputs, pp_stages,
                                spawn_world)
from torchdistx_tpu.parallel import collectives as jC
from torchdistx_tpu.parallel import create_mesh
from torchdistx_tpu.parallel.pp import (pipeline_apply, pipeline_train_step,
                                        split_microbatches, stack_pipeline_stages)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world("pp", tmp_path_factory.mktemp("pp"), timeout=150.0)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _jstages(stages):
    return [{k: jnp.asarray(v) for k, v in st.items()} for st in stages]


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return create_mesh(axes, devices=jax.devices()[:n])


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _mse(y, t):
    return jnp.mean((y - t) ** 2)


def _sequential(stages, micro, fn=_stage_fn):
    out = []
    for m in micro:
        x = m
        for p in stages:
            x = fn(p, x)
        out.append(x)
    return jnp.stack(out)


@pytest.mark.parametrize("name", sorted(PP_APPLY))
def test_forward_matches_sequential(world, name):
    d, n_micro, b, key, seed = PP_APPLY[name]
    stages = _jstages(pp_stages(WORLD, d, key))
    micro = jnp.asarray(np.random.RandomState(seed).randn(n_micro, b, d).astype(np.float32))
    ref = np.asarray(_sequential(stages, micro))
    for r in _got(world, name):
        np.testing.assert_allclose(r["out"], ref, rtol=2e-6, atol=2e-6)


def test_apply_gradients_and_training_match_jax(world):
    stages = _jstages(pp_stages(2, 8, 4))
    micro = jnp.asarray(np.random.RandomState(5).randn(4, 4, 8).astype(np.float32))
    g_seq = jax.grad(lambda st: jnp.mean(_sequential(st, micro) ** 2))(stages)
    # JAX's test_jit_and_train loop
    mesh = _mesh({"pp": WORLD})
    stacked = stack_pipeline_stages(_jstages(pp_stages(WORLD, 8, 6)), mesh)
    micro4 = jnp.asarray(np.random.RandomState(7).randn(4, 8, 8).astype(np.float32))
    tx = optax.sgd(0.1)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(lambda p: jnp.mean((pipeline_apply(
            p, micro4, mesh=mesh, stage_fn=_stage_fn) - 1.0) ** 2))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    s = tx.init(stacked)
    losses = []
    for _ in range(5):
        stacked, s, loss = step(stacked, s)
        losses.append(float(loss))
    # JAX's test_training_reduces_loss loop
    stacked = stack_pipeline_stages(_jstages(pp_stages(WORLD, 8, 16)), mesh)
    rs = np.random.RandomState(17)
    mb = split_microbatches(jnp.asarray(rs.randn(16, 8).astype(np.float32)), 4)
    tgt = split_microbatches(jnp.zeros((16, 8), jnp.float32), 4)
    tx3 = optax.sgd(0.3)

    @jax.jit
    def step3(p, s):
        loss, g = pipeline_train_step(p, mb, tgt, mesh=mesh, stage_fn=_stage_fn, loss_fn=_mse)
        u, s = tx3.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    s = tx3.init(stacked)
    train_losses = []
    for _ in range(8):
        stacked, s, loss = step3(stacked, s)
        train_losses.append(float(loss))
    assert train_losses[-1] < 0.5 * train_losses[0]
    for r in _got(world, "autodiff"):
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k], np.stack([np.asarray(g[k]) for g in g_seq]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["train_losses"], train_losses, rtol=1e-5)
        assert "stages" in r["wrong_count"]


@pytest.mark.parametrize("name", sorted(PP_TRAINS))
def test_train_step_matches_jax(world, name):
    axes, key, d, shape, dp = PP_TRAINS[name]
    mesh = _mesh(axes)
    stacked = stack_pipeline_stages(_jstages(pp_stages(axes["pp"], d, key)), mesh)
    mb, tgt = (jnp.asarray(a) for a in pp_inputs(key + 1, shape, d))
    if dp:
        mb, tgt = (jax.device_put(a, NamedSharding(mesh, P(None, "dp"))) for a in (mb, tgt))
    loss, g = pipeline_train_step(stacked, mb, tgt, mesh=mesh, stage_fn=_stage_fn,
                                  loss_fn=_mse, dp_axis=dp)
    n_stages, n_micro = axes["pp"], shape[0]
    for r in _got(world, name):
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k], np.asarray(g[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        assert r["grad_shape"][0] == 1
        # a stage sends each microbatch's activation on and its input
        # gradient back: the first and the last stage one of the two
        act = shape[1] // (2 if dp else 1) * d * 4
        assert r["pipe_bytes"] in (n_micro * act, 2 * n_micro * act)
    assert sum(r["pipe_bytes"] for r in _got(world, name)) == (
        2 * (n_stages - 1) * n_micro * act * (WORLD // n_stages))


def _tp_stage_fn(p, x):
    xin = jC.copy_psum_grad(x, "tp")
    h = jax.nn.relu(xin @ p["w1"].T + p["b1"])
    return x + jC.allreduce_linear(h @ p["w2"].T, "tp") + p["b2"]


def _tp_setup(key):
    mesh = _mesh({"tp": 2, "pp": 2})
    stages = _jstages(pp_stages(2, 8, key, h=16))
    stacked = jax.device_put(stack_pipeline_stages(stages, mesh),
                             {k: NamedSharding(mesh, P(*s)) for k, s in PP_TP_SPECS.items()})
    specs = {k: P(*s) for k, s in PP_TP_SPECS.items()}
    return mesh, stacked, specs


def test_tp_pp_forward_matches_jax(world):
    mesh, stacked, specs = _tp_setup(20)
    mb = jnp.asarray(np.random.RandomState(23).randn(3, 4, 8).astype(np.float32))
    out = pipeline_apply(stacked, mb, mesh=mesh, stage_fn=_tp_stage_fn, param_specs=specs)
    for r in _got(world, "tp_apply"):
        np.testing.assert_allclose(r["out"], np.asarray(out), rtol=1e-5, atol=1e-6)


def test_tp_pp_train_step_matches_jax(world):
    mesh, stacked, specs = _tp_setup(21)
    rs = np.random.RandomState(22)
    mb, tgt = (jnp.asarray(rs.randn(4, 4, 8).astype(np.float32)) for _ in range(2))
    loss, g = pipeline_train_step(stacked, mb, tgt, mesh=mesh, stage_fn=_tp_stage_fn,
                                  loss_fn=_mse, param_specs=specs)
    for r in _got(world, "tp_train"):
        assert r["local_w1"] == (1, 8, 8)  # w1 (h / tp, d) on each rank
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(r["grads"][k], np.asarray(g[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_llama_stages_match_unpipelined(world):
    for r in _got(world, "llama"):
        np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=1e-5)
        for k, g in r["grads"].items():
            ref = np.stack([st[k] for st in r["ref_grads"]])
            np.testing.assert_allclose(g, ref, rtol=2e-4, atol=1e-5, err_msg=k)
