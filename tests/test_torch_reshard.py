"""The port's elastic resharding (``parallel.reshard``, ``Trainer.reshard``,
``on_failure="reshard"``) against the JAX package's, the cases of
``tests/test_reshard.py``; the trainer cases at world size 4 on ``gloo``
(one spawned world, the ``reshard`` suite of ``tests/_torch_dist_worker.py``).

- The closed forms (host arithmetic over shapes and shardings, on
  ``AbstractMesh`` layouts of 8 and 4 ranks) equal JAX's on 8 CPU devices
  exactly: unsharding 8 ways books 7/8 of the bytes, 8 -> 4 half, the same
  layout and a replicated source 0; a leaf-count mismatch raises;
  ``can_reshard_live`` as JAX's (8-way shards do not survive onto 4, a
  replica does).
- ``on_failure="reshard"`` with ``inject_device_loss(2)`` on ``{"fsdp":
  4}`` bounces through the checkpoint onto ``{"fsdp": 2}`` (ranks 0 and 1;
  ranks 2 and 3 leave): the continued losses and parameters bit-equal to
  a fresh ``{"fsdp": 2}`` run transplanted from the recovery step's state,
  and within rtol 1e-4 / atol 1e-5 of JAX's own elastic run (8 -> 4 CPU
  devices) of the same MLP, Adam and batches.
- The same bounce with the 8-bit AdamW, its state placed by
  ``adam8bit_state_shardings`` (the 64-value biases' codes cut on the block
  dim, the weights' blocks by rows): the state leaves as the rank's pieces
  of the 4-rank layout and comes back as those of the 2-rank one (half the
  blocks a rank, the biases' codes 128 columns each); the continuation
  (losses, parameters, every code and scale) bit-equal to a fresh
  ``{"fsdp": 2}`` run loaded with the recovery step's whole state, and
  equal to JAX's elastic run (8-bit, 4 -> 2 CPU devices): parameters within
  rtol 1e-4 / atol 1e-5, codes at most 1 apart, scales within rtol 5e-5
  (gradients summed in another order, ``test_torch_fsdp.py``).  JAX's
  ``Trainer.reshard`` re-places the flat code lists replicated (its plan
  does not know them); the values are the global arrays either way.
- A live shrink of ``{"dp": 2, "fsdp": 2}`` to ``{"dp": 1, "fsdp": 2}``:
  mode ``"live"``, zero wire bytes and no collective, continuation
  bit-equal to the transplant.
- ``_shrunk_mesh``'s shapes and its error, as JAX's.
- ``"reshard"`` on a failure that is not a lost device rolls back as
  ``"restore"`` does.
- ``reshard_to_plan`` of an FSDP-placed MLP and its Adam state onto the
  replicated plan: ``plan_transition_wire_bytes`` equal to JAX's for the
  same move, the pieces gathered whole (bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNS
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import (RESHARD_INJECT, RESHARD_LR8, RESHARD_STEPS, SLOTS8, WORLD,
                                reshard_batches, spawn_world)
from torchdistx_tpu.optimizers import adam8bit_state_shardings as jstate_shardings
from torchdistx_tpu.optimizers import adamw_8bit as jadamw_8bit
from torchdistx_tpu import nn as jnn
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.parallel import ShardedTrainStep as JShardedTrainStep
from torchdistx_tpu.parallel import can_reshard_live as jcan_reshard_live
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel import ShardingPlan as JPlan
from torchdistx_tpu.parallel import plan_reshard as jplan_reshard
from torchdistx_tpu.parallel.reshard import plan_transition_wire_bytes as jplan_transition
from torchdistx_tpu.parallel import reshard_wire_bytes as jreshard_wire_bytes
from torchdistx_tpu.trainer import Trainer as JTrainer
from torchdistx_tpu.utils.failure import FailureDetector as JFailureDetector
from torchdistx_tpu_torch.parallel import (AbstractMesh, NamedSharding, can_reshard_live,
                                           plan_reshard, reshard_wire_bytes)
from torchdistx_tpu_torch.parallel.mesh import mark_sharded


class MLP(jnn.Module):
    def __init__(self, d=16, h=64):
        super().__init__()
        self.fc1 = jnn.Linear(d, h)
        self.fc2 = jnn.Linear(h, d)

    def forward(self, x):
        return self.fc2(jax.nn.relu(self.fc1(x)))


def _jax_mlp():
    tdx.manual_seed(0)
    m = tdx.deferred_init(MLP)
    tdx.materialize_module(m)
    return m


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    mlp = {k: np.asarray(v) for k, v in _jax_mlp().named_parameters()}
    return spawn_world("reshard", tmp, {"mlp": mlp, "tmp": str(tmp)}, timeout=150.0)


def _got(world, name, ranks=None):
    res = [r[name] for i, r in enumerate(world) if ranks is None or i in ranks]
    for r in res:
        assert "error" not in r, r["error"]
    return res


# -- the closed forms ---------------------------------------------------------------


def _jmesh(n):
    return JMesh(np.asarray(jax.devices()[:n]), ("fsdp",))


def _jsharded(mesh, shape, spec):
    x = jnp.arange(int(np.prod(shape)), dtype=jnp.float32).reshape(shape)
    return jax.device_put(x, JNS(mesh, spec))


def _tsharded(n, shape, spec):
    """A meta tensor marked as a piece of ``shape`` under ``spec`` on an
    ``n``-rank abstract mesh."""
    sh = NamedSharding(AbstractMesh(np.arange(n), ("fsdp",)), spec)
    piece = [s // n if spec and d == 0 else s for d, s in enumerate(shape)]
    return mark_sharded(torch.empty(piece, device="meta"), sh, shape)


def _ts(n, spec):
    return NamedSharding(AbstractMesh(np.arange(n), ("fsdp",)), spec)


CLOSED_FORMS = {
    "unshard_8": (8, ("fsdp",), 8, ()),
    "same_layout": (8, ("fsdp",), 8, ("fsdp",)),
    "replicated_source": (8, (), 8, ("fsdp",)),
    "8_to_4": (8, ("fsdp",), 4, ("fsdp",)),
}


@pytest.mark.parametrize("name", sorted(CLOSED_FORMS))
def test_closed_forms_equal_jax(name):
    n_src, src, n_tgt, tgt = CLOSED_FORMS[name]
    j = _jsharded(_jmesh(n_src), (64, 16), P(*src))
    jplan = jplan_reshard({"x": j}, {"x": JNS(_jmesh(n_tgt), P(*tgt))})
    t = _tsharded(n_src, (64, 16), src)
    plan = plan_reshard({"x": t}, {"x": _ts(n_tgt, tgt)})
    assert plan == [{k: p[k] for k in ("axis", "nbytes", "gather_group", "wire_bytes")}
                    for p in jplan]
    assert reshard_wire_bytes({"x": t}, _ts(n_tgt, tgt)) == jreshard_wire_bytes(
        {"x": j}, JNS(_jmesh(n_tgt), P(*tgt)))
    s = 64 * 16 * 4
    want = {"unshard_8": s * 7 // 8, "same_layout": 0, "replicated_source": 0,
            "8_to_4": s // 2}[name]
    assert reshard_wire_bytes({"x": t}, _ts(n_tgt, tgt)) == want


def test_leaf_count_mismatch_raises():
    x = _tsharded(8, (8, 8), ())
    with pytest.raises(ValueError, match="leaves"):
        plan_reshard({"a": x, "b": x}, {"a": _ts(8, ())})


def test_can_reshard_live_as_jax():
    m8, m4 = _jmesh(8), _jmesh(4)
    a8, a4 = AbstractMesh(np.arange(8), ("fsdp",)), AbstractMesh(np.arange(4), ("fsdp",))
    for spec, onto, want in ((("fsdp",), 4, False), ((), 4, True), (("fsdp",), 8, True)):
        j = _jsharded(m8, (64, 16), P(*spec))
        assert jcan_reshard_live({"w": j}, m4 if onto == 4 else m8) is want
        assert can_reshard_live({"w": _tsharded(8, (64, 16), spec)},
                                a4 if onto == 4 else a8) is want


def test_can_reshard_live_over_ranks(world):
    for r in _got(world, "live_check"):
        assert r == {"sharded_onto_2": False, "sharded_onto_4": True, "replica_onto_2": True}


# -- the trainer ----------------------------------------------------------------------


def _jax_elastic(eight_bit=False):
    """JAX's elastic run of test_reshard.py on 8 -> 4 CPU devices (the
    8-bit AdamW: 4 -> 2, its state placed by ``adam8bit_state_shardings``),
    with the port suite's batches: the final parameters (and the trainer)."""
    model = _jax_mlp()

    def loss_fn(p, batch):
        x, y = batch
        return jnp.mean((functional_call(model, p, (x,)) - y) ** 2)

    n = 4 if eight_bit else 8
    mesh = jcreate_mesh({"fsdp": n}, devices=jax.devices()[:n])
    tx = jadamw_8bit(RESHARD_LR8) if eight_bit else optax.adam(1e-2)
    step = JShardedTrainStep(loss_fn, tx, mesh, shard_axis="fsdp")
    params = step.shard_params(dict(model.named_parameters()))
    opt = step.init_optimizer(params)
    if eight_bit:
        opt = jax.device_put(opt, jstate_shardings(opt, mesh, "fsdp"))
    det = JFailureDetector()
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tr = JTrainer(step, params, opt, checkpoint_dir=tmp, checkpoint_every=100,
                      log_every=1, log_fn=lambda m: None, failure_detector=det,
                      on_failure="reshard")
        batches = reshard_batches(RESHARD_STEPS)
        tr.fit(batches[:RESHARD_INJECT])
        det.inject_device_loss(n // 2)
        tr.fit(batches[RESHARD_INJECT:])
        return {k: np.asarray(v) for k, v in tr.params.items()}, tr


def test_bounce_4_to_2_bit_consistent_and_matches_jax(world):
    jfinal, _ = _jax_elastic()
    for rank, r in enumerate(_got(world, "bounce")):
        (fail,) = r["logs"]
        assert fail["failure"] == "device_loss" and fail["action"] == "resharded"
        last = r["last"]
        assert last["step"] == RESHARD_INJECT + 1 and last["mode"] == "checkpoint"
        assert last["mesh_from"] == {"fsdp": 4} and last["mesh_to"] == {"fsdp": 2}
        assert r["t_reshard"] > 0.0
        assert r["departed"] is (rank >= 2)
        if rank >= 2:
            assert r["global_step"] == RESHARD_INJECT + 1
            continue
        assert r["mesh"] == {"fsdp": 2} and r["global_step"] == RESHARD_STEPS
        assert r["local_shapes"]["fc1.weight"] == (32, 16)  # fsdp 2 over (64, 16)
        assert r["losses"] == r["oracle_losses"] and len(r["losses"]) == 2
        for k, v in r["oracle"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
            np.testing.assert_allclose(r["params"][k], jfinal[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_bounce_4_to_2_with_8bit_state_bit_consistent_and_matches_jax(world):
    jfinal, jtr = _jax_elastic(eight_bit=True)
    jstate = {k: [np.asarray(x) for x in getattr(jtr.opt_state, k)] for k in SLOTS8}
    assert jtr.step.mesh.devices.size == 2
    for rank, r in enumerate(_got(world, "bounce_8bit")):
        last = r["last"]
        assert last["mode"] == "checkpoint" and last["mesh_to"] == {"fsdp": 2}
        assert r["departed"] is (rank >= 2)
        if rank >= 2:
            continue
        assert r["mesh"] == {"fsdp": 2} and r["global_step"] == RESHARD_STEPS
        assert r["losses"] == r["oracle_losses"] and len(r["losses"]) == 2
        for k, v in r["oracle"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
            np.testing.assert_allclose(r["params"][k], jfinal[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        (count, state), (ocount, ostate) = r["state"], r["oracle_state"]
        assert count == ocount == RESHARD_STEPS == int(jtr.opt_state.count)
        for k in SLOTS8:
            for got, ora, want in zip(state[k], ostate[k], jstate[k]):
                np.testing.assert_array_equal(got, ora, err_msg=k)
                if k.endswith("codes"):
                    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
                else:
                    np.testing.assert_allclose(got, want, rtol=5e-5, atol=0, err_msg=k)
        # the pieces in the 2-rank layout: weights' blocks by rows, the
        # biases' codes by columns (their one block), the biases' scales whole
        assert r["specs"]["fc1.weight"]["m_codes"] == ("fsdp", None)
        assert r["specs"]["fc1.bias"] == {"m_codes": (None, "fsdp"), "m_scales": (),
                                          "v_codes": (None, "fsdp"), "v_scales": ()}
        # fc1.weight (64, 16) and fc2.weight (16, 64): 4 blocks each; the
        # biases 1 block each; a rank's codes (2 * 2 + 2 * 128 a moment) and
        # scales (2 * 2 + 2 a moment)
        assert r["state_bytes"] == 2 * ((2 * 2 * 256 + 2 * 128) + 4 * (2 * 2 + 2))


def test_live_dp_shrink_zero_wire_bit_consistent(world):
    for rank, r in enumerate(_got(world, "live")):
        assert r["mode"] == "live" and r["last"]["wire_bytes"] == 0
        assert not any(r["last"]["payload_bytes"].values())
        assert r["departed"] is (rank >= 2)
        if rank < 2:
            assert r["mesh"] == {"dp": 1, "fsdp": 2}
            for k, v in r["oracle"].items():
                np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


def test_shrunk_mesh_shapes(world):
    for rank, r in enumerate(_got(world, "shrunk")):
        assert r["dp_fsdp"]["shape"] == {"dp": 1, "fsdp": 2}
        assert r["dp_fsdp"]["ranks"] == [[0, 1]]
        assert r["fsdp"]["shape"] == {"fsdp": 2} and r["fsdp"]["ranks"] == [0, 1]
        assert r["fsdp"]["member"] is (rank < 2)
        assert "divisor" in r["odd"]["error"]


def test_reshard_policy_falls_back_to_restore(world):
    for r in _got(world, "fallback"):
        assert r["action"] == "restored" and r["global_step"] == 2
        for k, v in r["saved"].items():
            np.testing.assert_array_equal(r["restored"][k], v, err_msg=k)


def test_reshard_to_plan_prices_as_jax_and_gathers(world):
    model = _jax_mlp()
    mesh = jcreate_mesh({"fsdp": 4}, devices=jax.devices()[:4])
    params = JPlan.fsdp(mesh, min_shard_elems=1).apply(dict(model.named_parameters()))
    opt = jax.eval_shape(optax.adam(1e-2).init, params)
    opt = jax.device_put(optax.adam(1e-2).init(params),
                         JPlan.fsdp(mesh, min_shard_elems=1).optimizer_state_shardings(
                             opt, params))
    want = jplan_transition(params, JPlan.replicated(mesh), optimizer_state=opt)
    init = {k: np.asarray(v) for k, v in model.named_parameters()}
    nbytes = sum(v.nbytes for v in init.values())
    assert want == 3 * nbytes * 3 // 4  # parameters, mu and nu, each 4-way
    for r in _got(world, "to_plan"):
        # JAX's Adam state is mu and nu (param-shaped) and a replicated count;
        # torch's Adam has exp_avg, exp_avg_sq and a replicated step
        assert r["priced"] == want
        assert r["gathered"] == 3 * nbytes // WORLD  # each rank's pieces, once
        for k, v in init.items():
            # one Adam step on unit gradients moves every element by -lr
            np.testing.assert_allclose(r["params"][k], v - 1e-2, rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(r["slots"][k], np.full(v.shape, 0.1, np.float32),
                                       rtol=1e-6, err_msg=k)
