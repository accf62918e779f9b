"""The port's expert parallelism (``nn.moe`` with ``moe_shard_rule``,
``Mixtral.shard_rule``, ``parallel.GSPMDTrainStep``) against the JAX
package unsharded, at world size 4 on ``gloo`` (one spawned world, the
``moe_ep`` suite of ``tests/_torch_dist_worker.py``).

- ``MoE`` (dim 16, ffn 32, 8 experts, top-2) with the JAX layer's weights,
  its experts sharded by ``moe_shard_rule`` (``tests/test_moe.py:42`` and
  :185): dense and capacity dispatch (einsum; gather at capacity 1.0) at
  ``{"ep": 4}`` with the tokens replicated, output, aux loss and the
  gradients of ``sum(y^2) + aux``; dense and capacity 1.0 (einsum) at
  ``{"dp": 2, "ep": 2}`` with the tokens sharded over dp, each shard held
  against the JAX layer on its own tokens (capacity and drops are a
  shard's own) and the gradients of ``sum(y^2)`` summed over dp.
  Tolerances those of ``tests/test_torch_mixtral.py``: outputs and aux
  1e-5, gradients 1e-4.
- Tiny Mixtral's EP train step with the 1e-2 aux (``tests/test_mixtral.py:85``):
  3 SGD steps (lr 1e-2) through ``GSPMDTrainStep`` with a plan that shards
  the experts, at ``{"ep": 4}`` and ``{"dp": 2, "ep": 2}`` (the batch
  replicated, as there), against the JAX unsharded trajectory: losses rtol
  1e-5, parameters rtol = atol = 2e-5.
- ``materialize_module(sharding_rule=m.shard_rule(mesh))``: every piece is
  the eager construction's slice, experts ``("ep", None, None)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import (
    MIXTRAL_LR,
    MIXTRAL_STEPS,
    MIXTRAL_TRAINS,
    MOE_CASES,
    MOE_SHAPE,
    mixtral_batch,
    moe_input,
    spawn_world,
)
from torchdistx_tpu.models import Mixtral as JMixtral
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.nn.moe import MoE as JMoE
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.models import Mixtral as TMixtral

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_moe(cf, mode):
    tdx.manual_seed(2)
    sh = MOE_SHAPE
    return JMoE(sh["dim"], sh["ffn"], n_experts=sh["experts"], top_k=sh["top_k"],
                capacity_factor=cf, dispatch_mode=mode)


def _jax_mixtral():
    tdx.manual_seed(0)
    return JMixtral.from_name("tiny")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    moe = {(cf, mode): _np(dict(_jax_moe(cf, mode).named_parameters()))
           for _, cf, mode in MOE_CASES.values()}
    payload = {"moe": moe, "mixtral": _np(dict(_jax_mixtral().named_parameters()))}
    return spawn_world("moe_ep", tmp_path_factory.mktemp("moe_ep"), payload, timeout=240.0)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _jax_layer(m, x, with_aux):
    params = dict(m.named_parameters())

    def loss(p, x_):
        y, aux = functional_call(m, p, (x_,), {"return_aux": True})
        return jnp.sum(y * y) + (aux if with_aux else 0.0), (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    return np.asarray(y), float(aux), np.asarray(gx), _np(gp)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_ep_moe_matches_jax_unsharded(world, case):
    axes, cf, mode = MOE_CASES[case]
    m = _jax_moe(cf, mode)
    x = moe_input()
    dp = "dp" in axes
    refs, summed = {}, None
    for r in _got(world, case):
        rows = slice(*r["rows"])
        key = (rows.start, rows.stop)
        if key not in refs:
            refs[key] = _jax_layer(m, x[rows], with_aux=not dp)
            g = refs[key][3]
            summed = g if summed is None else {k: summed[k] + g[k] for k in g}
    if not dp:
        assert len(refs) == 1
    for r in _got(world, case):
        y, aux, gx, _ = refs[(r["rows"][0], r["rows"][1])]
        assert r["local_experts"] == MOE_SHAPE["experts"] // axes["ep"]
        assert tuple(r["spec"]) == ("ep", None, None)
        np.testing.assert_allclose(r["y"], y, **LAYER_TOL)
        np.testing.assert_allclose(r["aux"], aux, **LAYER_TOL)
        np.testing.assert_allclose(r["x_grad"], gx, **TOL)
        for name, g in summed.items():
            np.testing.assert_allclose(r["grads"][name], g, err_msg=name, **TOL)


@pytest.fixture(scope="module")
def mixtral_reference():
    m = _jax_mixtral()
    tok, labels = (jnp.asarray(a.astype(np.int32)) for a in mixtral_batch())
    tx = optax.sgd(MIXTRAL_LR)

    def loss_fn(p):
        logits, aux = functional_call(m, p, (tok,), method="forward_with_aux")
        return jF.cross_entropy(logits, labels) + 1e-2 * aux

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(grads, s, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), s, loss

    params = dict(m.named_parameters())
    s = tx.init(params)
    losses = []
    for _ in range(MIXTRAL_STEPS):
        params, s, loss = step(params, s)
        losses.append(float(loss))
    return losses, _np(params)


@pytest.mark.parametrize("name", list(MIXTRAL_TRAINS))
def test_mixtral_ep_train_step_matches_jax(world, mixtral_reference, name):
    losses, params = mixtral_reference
    for r in _got(world, name):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k, want in params.items():
            np.testing.assert_allclose(r["params"][k], want, rtol=2e-5, atol=2e-5, err_msg=k)
        assert tuple(r["specs"]["blocks.0.mlp.w_gate"]) == ("ep", None, None)
        assert tuple(r["specs"]["lm_head.weight"]) == ()
        assert r["local_experts"] == 4 // MIXTRAL_TRAINS[name]["ep"]


def test_born_sharded_mixtral_is_the_eager_slice(world):
    tt.manual_seed(15)
    eager = {k: v.detach().numpy() for k, v in
             TMixtral.from_name("tiny", device="cpu").named_parameters()}
    for r in _got(world, "born_sharded"):
        for name, full in eager.items():
            if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down"):
                assert tuple(r["specs"][name]) == ("ep", None, None)
                full = np.split(full, 2, axis=0)[r["ep_index"]]
            else:
                assert tuple(r["specs"][name]) == ()
            np.testing.assert_array_equal(r["pieces"][name], full, err_msg=name)
