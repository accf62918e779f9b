"""The port's SlowMo (``torchdistx_tpu_torch.slowmo``) against the JAX
package.

- The closed-form slow update of ``tests/test_optimizers.py`` (a scalar,
  SGD at 0.1, ``slowmo_freq`` 2, the identity average) by the same numbers,
  and step by step against JAX's ``slow_momentum`` on the same problem, to
  rtol 1e-6; ``state_dict`` round trips the hyperparameters and the state,
  and the loaded optimizer steps as the saved one would.
- At world 4 on ``gloo`` (2 nodes x 2 local): the two-replica average
  ([1] and [3] meet at [2]), a loaded ``slowmo_freq`` timing the slow step,
  and ``slowmo_hook`` with ``sync_grads`` on and off against JAX's
  ``shard_map`` on 4 of its 8 CPU devices, exactly.
- Divergent SlowMo training of tiny Llama (f32), 7 steps at
  ``slowmo_freq`` 3, AnyPrecisionAdamW (lr 1e-3, f32 variance) under
  ``SlowMomentumOptimizer`` against JAX's ``slow_momentum`` over
  ``anyprecision_adamw``: losses rtol = atol = 1e-5; each rank's parameters
  after every step against JAX's replica of its node, and ``consensus()``
  against JAX's, all within 1e-4 and 99.9% within 1e-5
  (``test_torch_gossip_grad.close_params``).  The ranks are bit-identical
  after each slow step and differ after the first fast step after it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
from _torch_dist_worker import WORLD, gossip_grads, lm_batch, spawn_world
from test_torch_gossip_grad import _jax_init, got, hold_divergent, jax_divergent
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.parallel import hierarchical_mesh as jhierarchical_mesh
from torchdistx_tpu.parallel.comm_hooks import HookContext as JContext
from torchdistx_tpu.parallel.compat import shard_map
from torchdistx_tpu.slowmo import SlowMoState as JSlowMoState
from torchdistx_tpu.slowmo import slow_momentum as jslow_momentum
from torchdistx_tpu.slowmo import slowmo_hook as jslowmo_hook
from torchdistx_tpu_torch.slowmo import SlowMomentumOptimizer, slow_momentum

LR, STEPS, FREQ = 1e-3, 7, 3


def _scalar(w0=1.0, freq=2):
    w = torch.nn.Parameter(torch.tensor(w0))
    opt = slow_momentum(torch.optim.SGD([w], lr=0.1), slowmo_freq=freq, slowmo_factor=0.5,
                        slowmo_lr=1.0, base_lr=0.1, average_fn=lambda t: t)
    return w, opt


def _step(w, opt, g=0.2):
    w.grad = torch.tensor(g)
    opt.step()
    return float(w.detach())


def test_closed_form_slow_update():
    w, opt = _scalar()
    assert isinstance(opt, SlowMomentumOptimizer)
    # step 1, fast only: 1 - 0.1 * 0.2
    np.testing.assert_allclose(_step(w, opt), 0.98, rtol=1e-6)
    # step 2: fast to 0.96; slow: v = (1 - 0.96) / 0.1 = 0.4, w = 1 - 0.1 * 0.4
    np.testing.assert_allclose(_step(w, opt), 0.96, rtol=1e-6)
    np.testing.assert_allclose(float(opt.slow_momentum[0]), 0.4, rtol=1e-6)
    np.testing.assert_allclose(float(opt.prev_params[0]), 0.96, rtol=1e-6)
    # steps 3-4: fast to 0.92; v = 0.5 * 0.4 + (0.96 - 0.92) / 0.1 = 0.6, w = 0.96 - 0.06
    _step(w, opt)
    np.testing.assert_allclose(_step(w, opt), 0.90, rtol=1e-6)


def test_slow_update_matches_jax_step_by_step():
    tx = jslow_momentum(optax.sgd(0.1), slowmo_freq=2, slowmo_factor=0.5, slowmo_lr=1.0,
                        base_lr=0.1, average_fn=lambda t: t)
    p = {"w": jnp.asarray(1.0)}
    s = tx.init(p)
    w, opt = _scalar()
    for _ in range(6):
        u, s = tx.update({"w": jnp.asarray(0.2)}, s, p)
        p = {"w": p["w"] + u["w"]}
        mine = _step(w, opt)
        np.testing.assert_allclose(mine, float(p["w"]), rtol=1e-6)
        np.testing.assert_allclose(float(opt.prev_params[0]), float(s.prev_params["w"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(opt.slow_momentum[0]), float(s.slow_momentum["w"]),
                                   rtol=1e-6)
        assert opt.count == int(s.count)


def test_state_dict_roundtrip():
    w = torch.nn.Parameter(torch.ones(4))
    opt = SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1, momentum=0.9), slowmo_freq=3,
                                base_lr=0.1, average_fn=lambda t: t)
    w.grad = torch.full((4,), 0.1)
    opt.step()
    sd = opt.state_dict()
    w2 = torch.nn.Parameter(w.detach().clone())
    opt2 = SlowMomentumOptimizer(torch.optim.SGD([w2], lr=0.1, momentum=0.9), base_lr=0.1,
                                 average_fn=lambda t: t)
    opt2.load_state_dict(sd)
    assert (opt2.slowmo_freq, opt2.slowmo_factor, opt2.slowmo_lr, opt2.base_lr) == (3, 0.5, 1.0,
                                                                                    0.1)
    assert opt2.count == 1
    np.testing.assert_array_equal(opt2.prev_params[0].numpy(), np.ones(4))
    # the loaded optimizer takes the saved one's next steps, the slow one at 3
    for i in range(3):
        for p in (w, w2):
            p.grad = torch.full((4,), 0.05 * (i + 2))
        opt.step()
        opt2.step()
        np.testing.assert_array_equal(w2.detach().numpy(), w.detach().numpy())
    np.testing.assert_array_equal(opt2.slow_momentum[0].numpy(), opt.slow_momentum[0].numpy())
    assert opt2.count == opt.count == 4


def test_slowmo_freq_must_be_positive():
    w = torch.nn.Parameter(torch.ones(1))
    with pytest.raises(ValueError, match="slowmo_freq must be at least 1"):
        SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1), slowmo_freq=0)


def test_replica_mean_needs_a_mesh():
    w = torch.nn.Parameter(torch.ones(1))
    w.grad = torch.zeros(1)
    opt = SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1), slowmo_freq=1)
    with pytest.raises(NameError, match="unbound axis name: 'node'"):
        opt.step()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, init = _jax_init()
    payload = dict(part="slowmo", init=init, lr=LR, steps=STEPS, slowmo_freq=FREQ,
                   batch=lm_batch(8, 32))
    return spawn_world("gossip", tmp_path_factory.mktemp("slowmo"), payload)


def test_replicas_meet_at_their_mean(world):
    for r in got(world, "replica_average"):
        np.testing.assert_allclose(r["w"], [2.0], rtol=1e-6)


def test_loaded_freq_times_the_slow_step(world):
    res = got(world, "loaded_freq_governs")
    # ranks 0-1 are node 0 ([1]), ranks 2-3 node 1 ([3])
    assert not np.allclose(res[0]["after_1"], res[2]["after_1"])
    for r in res:
        np.testing.assert_allclose(r["after_2"], [2.0], rtol=1e-6)


@pytest.mark.parametrize("sync_grads", [True, False])
def test_slowmo_hook_matches_jax(world, sync_grads):
    mesh = jhierarchical_mesh(2, devices=jax.devices()[:WORLD])
    state = JSlowMoState(sync_grads=sync_grads)
    spec = P(("node", "local"))

    def body(g):
        return jslowmo_hook(state, g, JContext(replica_axes=("node", "local")))

    grads = {k: jnp.asarray(v) for k, v in gossip_grads("slowmo").items()}
    want = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)(grads)
    name = "slowmo_hook_sync" if sync_grads else "slowmo_hook_no_sync"
    for rank, r in enumerate(got(world, name)):
        for k, v in want.items():
            np.testing.assert_array_equal(r[k], np.asarray(v)[rank])


def test_divergent_slowmo_training_matches_jax(world):
    tx = jslow_momentum(anyprecision_adamw(LR, variance_dtype=jnp.float32), slowmo_freq=FREQ,
                        base_lr=LR)
    res = got(world, "slowmo_2x2")
    hold_divergent(res, *jax_divergent(2, dict(shard_axis=None, batch_axes=("node", "local")),
                                       jslowmo_hook, JSlowMoState(), tx, STEPS))
    for s in range(STEPS):
        first = res[0]["snapshots"][s]
        same = all(np.array_equal(first[k], r["snapshots"][s][k])
                   for r in res[1:] for k in first)
        if (s + 1) % FREQ == 0:
            assert same, f"replicas differ after slow step {s + 1}"
        elif (s + 1) % FREQ == 1 and s > 0:
            assert not same, f"replicas still equal after fast step {s + 1}"
