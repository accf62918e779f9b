"""The port's tensor-parallel serving (``ServeEngine(mesh=, plan=)``) against
the JAX package's on the CPU: the cases of JAX's ``TestTPServing``
(``tests/test_serve.py``), ``TestServeEnginePlan`` (``tests/test_plan.py``),
the tp=2 -> tp=1 migration (``tests/test_serve_elastic.py``), the
prefill(tp=2) -> decode(tp=1) handoff (``tests/test_fleet.py``), int8 under
TP (``tests/test_kv_quant.py``) and ``TestSpecTP``
(``tests/test_spec_decode.py``).

The port runs in ONE spawned world of two ``gloo`` ranks (the
``serve_tp`` suite of ``tests/_torch_dist_worker.py``), every case on both
ranks, the JAX side in this process on two of its eight CPU devices.  Tiny
f32 Llama, the JAX model's weights carried by ``load_jax_params``.  Every
greedy stream (token ids: no tolerance) equals the world-1 engine's, the
JAX TP engine's and the other rank's; the comm-audit profiles, the
migration and handoff summaries and wire bytes equal the JAX engine's
exactly (integers), and the profiles pass JAX's ``validate_comm_profile``.
A persistent TP engine over ``gloo`` on the card is refused: that test is
``tests/test_torch_cuda.py::test_persistent_tp_engine_over_gloo_is_refused``
(card tests live in files without JAX).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import (CYCLIC_PROMPTS, ELASTIC_MNT, HANDOFF_MNT, serve_prompts,
                                shared_prefix_prompts, spawn_world)
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.models import LlamaConfig as JLlamaConfig
from torchdistx_tpu.obs.comm import CommProfile, comm_audit, validate_comm_profile
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu.serve import ServeFleet as JServeFleet


def _jax_models():
    tdx.manual_seed(0)
    tp = JLlama.from_name("tiny", max_seq_len=64)
    tdx.manual_seed(0)
    kv2 = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tdx.manual_seed(0)
    plan = JLlama(JLlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                               max_seq_len=64))
    return {"tp": tp, "kv2": kv2, "plan": plan}


def _mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("tp",))


@pytest.fixture(scope="module")
def jmodels():
    return _jax_models()


@pytest.fixture(scope="module")
def world(tmp_path_factory, jmodels):
    weights = {k: {n: np.asarray(v) for n, v in m.named_parameters()}
               for k, m in jmodels.items()}
    return spawn_world("serve_tp", tmp_path_factory.mktemp("serve_tp"),
                       {"weights": weights}, world=2, timeout=240.0)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _eq_streams(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _run(eng, prompts, mnt):
    mnt = mnt if isinstance(mnt, list) else [mnt] * len(prompts)
    return [np.asarray(r.tokens) for r in eng.run(
        [{"prompt": p, "max_new_tokens": m} for p, m in zip(prompts, mnt)])]


def _same_profile(port: dict, jax_doc: dict):
    """Equal per kind and axis: ops, payload and wire bytes."""
    assert validate_comm_profile(port) == []
    assert port["entries"] == jax_doc["entries"]
    assert port["bytes_by_axis"] == jax_doc["bytes_by_axis"]


def test_tp2_slab_fused_matches_single_device_and_jax(world, jmodels):
    prompts = serve_prompts(21, (6, 11, 9, 4, 13))
    eng = JServeEngine(jmodels["tp"], num_slots=3, max_len=64, prefill_buckets=(16,),
                       decode_chunk=4, mesh=_mesh())
    want = _run(eng, prompts, 6)
    for r in _got(world, "slab4"):
        assert r["tp"] == 2
        _eq_streams(r["tokens"], r["world1"])
        _eq_streams(r["tokens"], want)
        # the KV cache holds half the heads a rank; the plan's kv_cache is per shard
        assert r["local_shape"][2] == r["global_shape"][2] // 2
        assert r["nbytes"] == eng.cache.nbytes
        assert r["kv_plan"] == eng.memory_plan()["components"]["kv_cache"] == r["nbytes"] // 2


def test_tp2_paged_persistent_matches_single_device_and_jax(world, jmodels):
    prompts = serve_prompts(22, (5, 12, 9))
    eng = JServeEngine(jmodels["tp"], num_slots=2, max_len=64, prefill_buckets=(16,),
                       decode_mode="persistent", page_size=16, mesh=_mesh())
    want = _run(eng, prompts, 6)
    for r in _got(world, "paged_persistent"):
        _eq_streams(r["tokens"], r["world1"])
        _eq_streams(r["tokens"], want)


def test_tp_mesh_comm_audit_pins_closed_form(world, jmodels):
    eng = JServeEngine(jmodels["tp"], num_slots=2, max_len=64, prefill_buckets=(16,),
                       decode_chunk=4, mesh=_mesh())
    with comm_audit() as prof:
        _run(eng, serve_prompts(23, (7, 10)), 6)
    nl, dim = jmodels["tp"].cfg.n_layers, jmodels["tp"].cfg.dim
    for r in _got(world, "audit"):
        c = r["counters"]
        _same_profile(r["profile"], prof.to_json())
        (row,) = r["profile"]["entries"]
        assert (row["kind"], row["axis"]) == ("all_reduce", "tp")
        assert row["ops"] == 2 * nl * (c["prefill_calls"] + c["decode_steps"])
        assert row["payload_bytes"] == 2 * nl * 4 * dim * (
            c["tokens_prefilled"] + c["decode_steps"] * 2) == row["wire_bytes"]
        assert r["single_ops"] == 0


def test_kv_head_divisibility_and_argument_errors(world):
    for r in _got(world, "errors"):
        assert "does not divide" in r["divide"]
        assert "tp_axis" in r["axis"]
        assert "requires mesh" in r["rule"]
        assert "plan requires mesh" in r["plan"]
        assert "not both" in r["both"]


def test_plan_drives_params_and_kv_pool_and_tp_rule_is_a_shim(world, jmodels):
    eng = JServeEngine(jmodels["plan"], num_slots=2, max_len=32, mesh=_mesh())
    h = eng.submit([1, 2, 3], max_new_tokens=4)
    while not h.done():
        eng.step()
    for r in _got(world, "plan"):
        assert r["plan_type"] == "ShardingPlan"
        assert r["wq_spec"] == ("tp", None)
        assert r["kv_spec"] == r["plan_kv_spec"] == (None, None, "tp", None)
        np.testing.assert_array_equal(r["tokens"], h.result().tokens)
        assert "DeprecationWarning" in r["warned"] and r["shim_plan"] is None
        np.testing.assert_array_equal(r["shim_tokens"][0], h.result().tokens)


def _jax_elastic(jm, paged):
    def engine(tp, slots):
        kw = dict(max_len=64, prefill_buckets=(16,), decode_chunk=2)
        if paged:
            kw.update(page_size=8, num_pages=32)
        if tp > 1:
            kw["mesh"] = _mesh()
        return JServeEngine(jm, num_slots=slots, **kw)

    prompts = serve_prompts(7, (6, 9, 5, 11))
    src, dst = engine(2, 3), engine(1, 4)
    hs = [src.submit(p, max_new_tokens=m) for p, m in zip(prompts, ELASTIC_MNT)]
    for _ in range(2):
        src.step()
    src.drain()
    prof = CommProfile()
    with comm_audit(prof):
        summary = src.migrate_to(dst)
    while dst.step():
        pass
    return [np.asarray(h.result().tokens) for h in hs], summary, prof.to_json()


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_tp2_to_tp1_migration_bit_identical_wire_exact(world, jmodels, paged):
    tokens, summary, prof = _jax_elastic(jmodels["kv2"], paged)
    assert summary["wire_bytes"] > 0 and (summary["tp_from"], summary["tp_to"]) == (2, 1)
    for r in _got(world, "elastic_paged" if paged else "elastic_slab"):
        _eq_streams(r["tokens"], r["ref"])
        _eq_streams(r["tokens"], tokens)
        assert r["reasons"] == ["length"] * 4
        assert r["summary"] == summary
        _same_profile(r["profile"], prof)
        assert r["counters"]["migration_wire_bytes"] == summary["wire_bytes"]
        assert r["counters"]["requests_migrated_out"] == 4 == r["in"]


def test_prefill_tp2_to_decode_tp1_handoff_wire_exact(world, jmodels):
    def engine(tp):
        kw = dict(mesh=_mesh()) if tp > 1 else {}
        return JServeEngine(jmodels["kv2"], num_slots=4, max_len=64, prefill_buckets=(32,),
                            decode_chunk=2, **kw)

    reqs = [dict(prompt=p, max_new_tokens=m)
            for p, m in zip(shared_prefix_prompts(13, 4), HANDOFF_MNT)]
    pre, dec = engine(2), engine(1)
    fleet = JServeFleet([pre, dec], disaggregate=True, roles=["prefill", "decode"])
    prof = CommProfile()
    with comm_audit(prof):
        want = [np.asarray(o.tokens) for o in fleet.run(reqs)]
    c = pre.metrics.counters
    for r in _got(world, "handoff"):
        _eq_streams(r["tokens"], r["ref"])
        _eq_streams(r["tokens"], want)
        _same_profile(r["profile"], prof.to_json())
        assert r["pre"] == {k: c[k] for k in r["pre"]}
        assert r["pre"]["decode_dispatches"] == 0 and r["pre"]["requests_handed_off"] == 4
        assert r["dec"] == {"prefill_calls": 0, "requests_handed_in": 4}
        assert r["events_wire"] == r["pre"]["handoff_wire_bytes"] > 0


def test_int8_migration_scales_ride_and_wire_is_exact(world, jmodels):
    def engine(tp, slots=3):
        kw = dict(mesh=_mesh()) if tp > 1 else {}
        return JServeEngine(jmodels["kv2"], num_slots=slots, max_len=64,
                            prefill_buckets=(16,), kv_dtype="int8", decode_chunk=2, **kw)

    prompts = serve_prompts(7, (6, 9, 5, 11))
    src, dst = engine(2), engine(1, 4)
    hs = [src.submit(p, max_new_tokens=m) for p, m in zip(prompts, ELASTIC_MNT)]
    for _ in range(2):
        src.step()
    src.drain()
    prof = CommProfile()
    with comm_audit(prof):
        summary = src.migrate_to(dst)
    while dst.step():
        pass
    for r in _got(world, "int8_migrate"):
        _eq_streams(r["tokens"], r["ref"])
        _eq_streams(r["tokens"], [h.result().tokens for h in hs])
        assert r["summary"] == summary
        _same_profile(r["profile"], prof.to_json())
        assert r["scale_shape"][2] == 1  # the scales split over heads as the data


def test_spec_tp2_identity_and_collective_closed_form(world, jmodels):
    eng = JServeEngine(jmodels["tp"], num_slots=2, max_len=64, prefill_buckets=(16,),
                       decode_mode="persistent", speculate=2, mesh=_mesh())
    prompts = [np.asarray(p, np.int32) for p in CYCLIC_PROMPTS]
    with comm_audit() as prof:
        want = _run(eng, prompts, 16)
    nl, dim = jmodels["tp"].cfg.n_layers, jmodels["tp"].cfg.dim
    for r in _got(world, "spec"):
        _eq_streams(r["tokens"], r["base"])
        _eq_streams(r["tokens"], want)
        _same_profile(r["profile"], prof.to_json())
        c = r["counters"]
        (row,) = r["profile"]["entries"]
        assert row["ops"] == 2 * nl * (c["prefill_calls"] + c["decode_steps"])
        assert row["payload_bytes"] == 2 * nl * 4 * dim * (
            c["tokens_prefilled"] + c["decode_steps"] * 2 * 3)


def test_ranks_agree(world):
    """Every rank ran the same schedule and sampled the same tokens."""
    for case in ("slab4", "paged_persistent", "handoff", "spec"):
        a, b = _got(world, case)
        _eq_streams(a["tokens"], b["tokens"])
    a, b = _got(world, "audit")
    assert a["profile"] == b["profile"]
