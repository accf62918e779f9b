"""The port's comm audit (``obs.comm``) and memory audit (``obs.memory``'s
``sharding_report``, ``memory_report``, ``record_materialize``,
``ShardingPlan.validate``) against the JAX package's on the CPU: the cases
of JAX's ``tests/test_comm_audit.py`` (FSDP, TP, PP, GossipGraD, the rings
and Ulysses, the sharding audit, the Trainer's profile and flight digest)
and of ``tests/test_plan.py`` (``price_step`` / ``step_wire_bytes`` and a
k-step ZeRO-2 audit, the plan transition, ``TestValidate``).

The port runs in ONE spawned world of four ``gloo`` ranks (the
``comm_audit`` suite of ``tests/_torch_dist_worker.py``); the JAX side runs
here on four of its eight CPU devices, on the same numpy inputs (the MLP
and tiny Llama weights carried by ``load_jax_params``).  A port profile's
``to_json()`` must EQUAL the JAX profile of the same run per kind and axis
(ops, payload and wire bytes: integers, no tolerance) and pass JAX's
``validate_comm_profile``.  The JAX package books at trace time (a cached
program books nothing); the port books one execution of a step program
(``obs.comm``'s module docstring), so one step's profile, and the
Trainer's after three steps, equal JAX's.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import AUDIT_FLASH_RING, AUDIT_PP, AUDIT_TP, audit_inputs, spawn_world
from torchdistx_tpu import nn as jnn
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.obs import comm_audit as jcomm_audit
from torchdistx_tpu.obs import memory as jmemory
from torchdistx_tpu.obs.comm import validate_comm_profile
from torchdistx_tpu.parallel import ShardedTrainStep as JShardedTrainStep
from torchdistx_tpu.parallel import ShardingPlan as JShardingPlan
from torchdistx_tpu.parallel import collectives as jcoll
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel.compat import shard_map
from torchdistx_tpu_torch import obs
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.obs.comm import (CommProfile, comm_audit, record_collective,
                                           tree_bytes)
from torchdistx_tpu_torch.parallel import ShardingPlan
from torchdistx_tpu_torch.parallel.mesh import AbstractMesh
from torchdistx_tpu_torch.parallel.plan import PlanError

GIB = 1 << 30


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


def _jax_llama(rule=None):
    tdx.manual_seed(0)
    m = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(m, **({"sharding_rule": rule} if rule is not None else {}))
    return m, dict(m.named_parameters())


def _mesh(axes):
    return jcreate_mesh(axes, devices=jax.devices()[:4])


def _mse_step(model, mesh, **kw):
    def loss_fn(p, batch):
        x, y = batch
        return jnp.mean((functional_call(model, p, (x,)) - y) ** 2)

    return JShardedTrainStep(loss_fn, optax.sgd(1e-2), mesh, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    payload = {"mlp": {k: np.asarray(v) for k, v in _jax_mlp().named_parameters()},
               "llama": {k: np.asarray(v) for k, v in _jax_llama()[1].items()}}
    return spawn_world("comm_audit", tmp_path_factory.mktemp("comm_audit"), payload,
                       timeout=240.0)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _same(port: dict, jax_doc: dict):
    """Equal per kind and axis (ops, payload, wire), JAX's schema."""
    assert validate_comm_profile(port) == []
    assert port["entries"] == jax_doc["entries"]
    assert port["bytes_by_axis"] == jax_doc["bytes_by_axis"]


# -- the profile itself (no world) ---------------------------------------------------


def test_profile_json_schema_and_nested_audits():
    prof = CommProfile()
    with comm_audit(prof):
        record_collective("all_reduce", "dp", payload_bytes=1024, axis_size=4)
    doc = prof.to_json()
    assert validate_comm_profile(doc) == []
    assert doc["bytes_by_axis"] == {"dp": 1536}  # 2 * (3/4) * 1024
    doc["entries"][0]["ops"] = "three"
    assert validate_comm_profile(doc)
    outer, inner = CommProfile(), CommProfile()
    with comm_audit(outer), comm_audit(inner):
        record_collective("all_reduce", "dp", payload_bytes=8, axis_size=2)
    assert outer.ops() == inner.ops() == 1
    assert outer.digest() == {"ops": 1, "bytes_by_axis": {"dp": 8}}
    outer.clear()
    assert not outer
    with comm_audit() as none:
        from torchdistx_tpu_torch.obs.comm import muted

        with muted():
            record_collective("all_reduce", "dp", payload_bytes=8, axis_size=2)
    assert not none
    assert tree_bytes({"a": torch.zeros(3, 2), "b": [np.zeros(4, np.int8)]}) == 28
    assert obs.comm_audit is comm_audit and obs.CommProfile is CommProfile


# -- the collectives and the steps, against JAX's profiles --------------------------


def test_fsdp_step_closed_form_and_a_cached_program_books_nothing(world):
    mesh = _mesh({"fsdp": 4})
    model = _jax_mlp()
    step = _mse_step(model, mesh, shard_axis="fsdp")
    params = step.shard_params(dict(model.named_parameters()))
    opt = step.init_optimizer(params)
    x = np.zeros((8, 16), np.float32)
    with jcomm_audit() as prof:
        step(params, opt, (x, x))
    for r in _got(world, "fsdp"):
        _same(r["profile"], prof.to_json())
        assert r["again"] is False
    ops = {(e["kind"], e["axis"]): e["ops"] for e in prof.to_json()["entries"]}
    assert ops == {("all_gather", "fsdp"): 2, ("reduce_scatter", "fsdp"): 2,
                   ("pmean", "fsdp"): 3}


def _jax_tp(wrt_input):
    w, x = audit_inputs("tp", 0)
    mesh = _mesh({"tp": 4})
    n_layers = AUDIT_TP["n_layers"]

    def loss_fn(p, x):
        h = x
        for i in range(n_layers):
            xin = jcoll.copy_psum_grad(h, "tp")
            mid = jax.nn.relu(xin @ p[f"w1_{i}"])
            h = jcoll.allreduce_linear(mid @ p[f"w2_{i}"], "tp")
        return jnp.sum(h)

    def body(p, x):
        if wrt_input:
            return jax.grad(loss_fn, argnums=(0, 1))(p, x)[0]
        return jax.grad(loss_fn)(p, x)

    specs = {f"w1_{i}": P(None, "tp") for i in range(n_layers)} | {
        f"w2_{i}": P("tp", None) for i in range(n_layers)}
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P()), out_specs=specs,
                          check_vma=False))
    with jcomm_audit() as prof:
        jax.block_until_ready(f({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x)))
    return prof.to_json()


def test_tp_megatron_pairs_book_forward_and_backward(world):
    live, dead = _jax_tp(True), _jax_tp(False)
    for r in _got(world, "tp"):
        _same(r["live"], live)
        _same(r["dead"], dead)
    ops = {e["kind"]: e["ops"] for e in live["entries"]}
    assert ops == {"allreduce_linear": 3, "allreduce_linear_bwd": 3, "copy_psum_grad_bwd": 3}
    # the first layer's backward all-reduce has a dead cotangent: not run, not booked
    assert {e["kind"]: e["ops"] for e in dead["entries"]}["copy_psum_grad_bwd"] == 2


def test_pp_1f1b_exchange_closed_form(world):
    from torchdistx_tpu.parallel.pp import (pipeline_train_step, split_microbatches,
                                            stack_pipeline_stages)

    stages, x = audit_inputs("pp", 1)
    mesh = _mesh({"pp": 4})
    stacked = stack_pipeline_stages([{k: jnp.asarray(v) for k, v in st.items()}
                                     for st in stages], mesh, axis="pp")
    mb = split_microbatches(jnp.asarray(x), AUDIT_PP["n_micro"])
    with jcomm_audit() as prof:
        loss, _ = pipeline_train_step(stacked, mb, jnp.zeros_like(mb), mesh=mesh,
                                      stage_fn=lambda p, a: a + jnp.tanh(a @ p["w"]),
                                      loss_fn=lambda y, t: jnp.mean((y - t) ** 2), axis="pp")
        jax.block_until_ready(loss)
    for r in _got(world, "pp"):
        _same(r, prof.to_json())
    ticks = AUDIT_PP["n_micro"] + 2 * 3
    assert prof.ops("exchange", "pp") == 2 * ticks


def test_gossip_books_every_branch_and_the_local_means(world):
    from torchdistx_tpu.parallel import GossipGraDState, gossip_grad_hook

    mesh = _mesh({"node": 2, "local": 2})
    model = _jax_mlp()
    state = GossipGraDState(2, node_axis="node", local_axis="local")
    step = _mse_step(model, mesh, shard_axis=None, replica_axes=("node",),
                     comm_hook=gossip_grad_hook, hook_state=state, divergent_replicas=True,
                     batch_axes=("node", "local"))
    p = step.stack_replicas(dict(model.named_parameters()))
    s = step.init_optimizer(p)
    x = np.zeros((8, 16), np.float32)
    with jcomm_audit() as prof:
        step(p, s, (x, x))
    for r in _got(world, "gossip"):
        assert r["branches"] == len(state.branch_table()[0])
        _same(r["profile"], prof.to_json())
    assert prof.ops("exchange", "node") == len(state.branch_table()[0])


def _jax_sp(fn, name, grad=False):
    q, k, v = (jnp.asarray(a) for a in audit_inputs(name, {"ring": 0, "flash_ring": 1,
                                                              "ulysses": 2}[name]))
    mesh = _mesh({"fsdp": 4})
    sm = shard_map(fn, mesh=mesh, in_specs=(P(None, "fsdp"),) * 3, out_specs=P(None, "fsdp"),
                   check_vma=False)
    if grad:
        f = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jnp.sin(sm(a, b, c))), argnums=(0, 1, 2)))
    else:
        f = jax.jit(sm)
    with jcomm_audit() as prof:
        jax.block_until_ready(f(q, k, v))
    return prof.to_json()


def test_ring_and_ulysses_book_as_jax_does(world):
    from torchdistx_tpu.ops.attention import (ring_attention, ring_flash_attention,
                                              ulysses_attention)

    c = AUDIT_FLASH_RING
    want = {
        "ring": _jax_sp(lambda a, b, d: ring_attention(a, b, d, axis="fsdp", causal=True),
                        "ring"),
        "flash_ring": _jax_sp(lambda a, b, d: ring_flash_attention(
            a, b, d, axis="fsdp", causal=True, block_q=8, block_k=8), "flash_ring", grad=True),
        "ulysses": _jax_sp(lambda a, b, d: ulysses_attention(
            a, b, d, axis="fsdp", causal=True, use_flash=False), "ulysses"),
    }
    for r in _got(world, "ring"):
        for case, doc in want.items():
            _same(r[case], doc)
    kv = c["b"] * (c["s"] // 4) * c["h"] * c["d"] * 4
    (row,) = want["flash_ring"]["entries"]
    assert row["ops"] == (3 + 5) * 4 and row["payload_bytes"] == 4 * (2 * kv + 4) + 4 * (
        4 * kv + 4)


def test_zero2_k_step_audit_equals_k_times_the_price(world):
    mesh = _mesh({"dp": 4})
    plan = JShardingPlan(mesh, dp_axis="dp", zero2=True, min_shard_elems=1)
    _, params = _jax_llama(plan.as_rule())
    rows = plan.price_step(params)
    for r in _got(world, "zero2"):
        assert r["rows"] == rows
        assert r["wire"] == plan.step_wire_bytes(params)
        assert r["gather_wire"] == plan.step_wire_bytes(params, "all_gather")
        (row,) = rows
        prof = r["profile"]
        assert validate_comm_profile(prof) == []
        (e,) = prof["entries"]
        assert (e["kind"], e["axis"]) == ("all_gather", "dp")
        assert e["ops"] == r["k"] and e["payload_bytes"] == r["k"] * row["payload_bytes"]
        assert e["wire_bytes"] == r["k"] * row["wire_bytes"]


def test_plan_transition_prices_then_books_identically(world):
    from torchdistx_tpu.parallel import plan_transition_wire_bytes, reshard_to_plan

    src = JShardingPlan.fsdp(_mesh({"fsdp": 4}))
    _, params = _jax_llama(src.as_rule())
    target = JShardingPlan.replicated(src.mesh)
    expected = plan_transition_wire_bytes(params, target)
    with jcomm_audit() as prof:
        reshard_to_plan(params, target)
    for r in _got(world, "transition"):
        assert r["expected"] == expected > 0
        _same(r["profile"], prof.to_json())


def test_trainer_profile_is_one_step_and_flight_records_carry_its_digest(world):
    from torchdistx_tpu.obs.flight import FlightRecorder as JFlightRecorder
    from torchdistx_tpu.trainer import Trainer as JTrainer

    mesh = _mesh({"fsdp": 4})
    model = _jax_mlp()
    step = _mse_step(model, mesh, shard_axis="fsdp")
    params = step.shard_params(dict(model.named_parameters()))
    rs = np.random.RandomState(0)
    batches = [(b, b) for b in (rs.randn(8, 16).astype(np.float32) for _ in range(3))]
    tr = JTrainer(step, params, step.init_optimizer(params), log_every=1,
                  log_fn=lambda m: None, flight=JFlightRecorder())
    tr.fit(batches)
    want = tr.comm_profile.to_json()
    for r in _got(world, "trainer"):
        _same(r["profile"], want)
        _same(r["outer"], want)  # an outer audit sees the one booked step too
        # a "step" record at each log boundary past the warm-up step
        assert r["step_comm"] == [r["digest"]] * 2
        assert r["digest"] == tr.comm_profile.digest()


# -- the memory audit ----------------------------------------------------------------


def test_sharding_report_flags_as_jax_does(world):
    mesh = _mesh({"fsdp": 4})
    big = jax.device_put(jnp.zeros((64, 64)), JNamedSharding(mesh, P()))
    sharded = jax.device_put(jnp.zeros((64, 64)), JNamedSharding(mesh, P("fsdp", None)))
    small = jax.device_put(jnp.zeros((8,)), JNamedSharding(mesh, P()))
    rep = jmemory.sharding_report({"big": big, "sharded": sharded, "small": small})
    mismatch = jmemory.sharding_report(
        {"big": big}, intended_rule=lambda p, a: JNamedSharding(mesh, P("fsdp", None)))
    model = _jax_mlp()
    params = {k: jax.device_put(v, JNamedSharding(mesh, P("fsdp", None) if v.ndim == 2
                                                  else P()))
              for k, v in dict(model.named_parameters()).items()}
    bad_state = jax.jit(optax.adam(1e-3).init)(jax.device_put(
        {k: np.asarray(v) for k, v in params.items()}, JNamedSharding(mesh, P())))
    bad = [f for f in jmemory.sharding_report(params, optimizer_state=bad_state)["flags"]
           if f["kind"] == "unsharded_optimizer_state"]
    for r in _got(world, "report"):
        got = r["report"]
        assert got["total_bytes"] == rep["total_bytes"] == (64 * 64 * 2 + 8) * 4
        assert got["bytes_per_device"] == rep["bytes_per_device"]
        assert [(f["kind"], f["path"], f["bytes"]) for f in got["flags"]] == [
            (f["kind"], f["path"], f["bytes"]) for f in rep["flags"]]
        assert r["planned"] == []
        assert [f["kind"] for f in r["mismatch"]] == [f["kind"] for f in mismatch["flags"]]
        assert len(r["bad"]) == len(bad) == 4
        assert sorted((f["param"], f["bytes"]) for f in r["bad"]) == sorted(
            (f["param"], f["bytes"]) for f in bad)
        assert all("optimizer_state_shardings" in f["detail"] for f in r["bad"])
        assert r["good"] == []
        assert [f["kind"] for f in r["budget"]] == ["over_budget"]


def test_validate_materialized_paths(world):
    mesh = _mesh({"fsdp": 4})
    plan = JShardingPlan.fsdp(mesh)
    x = jax.device_put(jnp.zeros((4096, 64)), JNamedSharding(mesh, P()))
    with pytest.raises(Exception, match="sharding_mismatch"):
        plan.validate({"w": x})
    for r in _got(world, "validate"):
        assert r["mismatch"] is not None and "sharding_mismatch" in r["mismatch"]
        assert r["conforming"] == []


def _abstract(n=8):
    return AbstractMesh(np.arange(n), ("fsdp",))


def test_validate_shape_only_paths_against_jax():
    jmesh = jcreate_mesh({"fsdp": 8})
    shape = (50_000, 100_000)
    jparams = {"giant.weight": jax.ShapeDtypeStruct(shape, jnp.float32)}
    tparams = {"giant.weight": torch.empty(shape, device="meta")}
    with pytest.raises(PlanError) as ei:
        ShardingPlan.replicated(_abstract()).validate(
            tparams, budget_bytes_per_device=16 * GIB, budget_name="H100 HBM")
    msg = str(ei.value)
    assert "H100 HBM" in msg and str(16 * GIB) in msg and "20000000000" in msg
    want = JShardingPlan.fsdp(jmesh).validate(jparams, budget_bytes_per_device=16 * GIB)
    got = ShardingPlan.fsdp(_abstract()).validate(tparams, budget_bytes_per_device=16 * GIB)
    assert got["fits"] is True and got["components"] == want["components"]
    jstate = jax.eval_shape(optax.adam(1e-3).init, jparams)
    tstate = {"giant.weight": {"exp_avg": torch.empty(shape, device="meta"),
                               "exp_avg_sq": torch.empty(shape, device="meta"),
                               "step": torch.empty((), device="meta")}}
    want = JShardingPlan.fsdp(jmesh).validate(jparams, optimizer_state=jstate)
    got = ShardingPlan.fsdp(_abstract()).validate(tparams, optimizer_state=tstate)
    # mu and nu like the parameter, plus a replicated 4-byte step count
    assert got["components"] == want["components"]
    assert got["components"]["optimizer_state"] == 2 * got["components"]["params"] + 4


def test_price_step_and_step_wire_bytes_equal_jax():
    jmesh = jcreate_mesh({"fsdp": 8})
    _, jparams = _jax_llama()
    tparams = {k: torch.empty(v.shape, device="meta") for k, v in jparams.items()}
    for jplan, tplan in (
            (JShardingPlan.fsdp(jmesh), ShardingPlan.fsdp(_abstract())),
            (JShardingPlan(jmesh, dp_axis="fsdp", zero2=True, min_shard_elems=1),
             ShardingPlan(_abstract(), dp_axis="fsdp", zero2=True, min_shard_elems=1)),
            (JShardingPlan.replicated(jmesh), ShardingPlan.replicated(_abstract()))):
        assert tplan.price_step(tparams) == jplan.price_step(jparams)
        for kind in (None, "all_gather", "reduce_scatter", "pmean"):
            assert tplan.step_wire_bytes(tparams, kind) == jplan.step_wire_bytes(jparams, kind)
    prof = CommProfile()
    with comm_audit(prof):
        ShardingPlan.fsdp(_abstract()).record_step_collectives(tparams)
    with jcomm_audit() as jprof:
        JShardingPlan.fsdp(jmesh).record_step_collectives(jparams)
    assert prof.to_json() == json.loads(json.dumps(jprof.to_json()))


def test_record_materialize_after_materialize_module():
    import torchdistx_tpu_torch as tt

    _jax_llama()
    want = jmemory.last_materialize_report()
    m = tt.deferred_init(TLlama.from_name, "tiny", device="cpu")
    tt.materialize_module(m)
    got = obs.last_materialize_report()
    assert (got["n_tensors"], got["total_bytes"]) == (want["n_tensors"], want["total_bytes"])
    assert got["total_bytes"] == sum(math.prod(p.shape) * 4 for p in m.parameters())
    assert got["watermark"]["source"] == "host_rusage"
    rep = obs.memory_report(m)
    assert "entries" not in rep["sharding"] and rep["sharding"]["flags"] == []
