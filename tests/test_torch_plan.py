"""The port's sharding plan (``parallel.plan``) against the JAX package's,
at world size 4 on ``gloo`` (one spawned world, ``tests/_torch_dist_worker.py``'s
``plan`` suite), the JAX side on 4 of the 8 CPU devices.

- Rule resolution, case by case as ``tests/test_plan.py::TestRuleResolution``
  (the same rules, paths and shapes, on ``{"fsdp": 4}``): first match wins,
  ``re.search``, no match gives replicated, a ``default_axis`` shards
  FSDP-style above ``min_shard_elems`` and an explicit rule even below it,
  an unknown axis raises ``PlanError``, and ``with_mesh``.
- ``llama_tp_rule``'s assignments (``tests/test_tp.py:24``) equal JAX's.
- ``materialize_module(sharding_rule=plan.as_rule())`` of tiny Llama under
  ``llama_tp_plan`` on ``{"dp": 2, "tp": 2}``: every piece the eager
  construction's slice, bit for bit; ``describe`` and ``per_device_bytes``
  equal JAX's.
- ``apply`` cuts a materialized model in place, leaves a placed one as it
  is and re-cuts one sharded another way; ``shard_params`` on a dict.
- The derived optimizer-state shardings equal JAX's for AnyPrecisionAdamW.
- ``accumulate_grads`` and ``strided_split`` (exact up to f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import PLAN_RESOLUTION, TP_RULE_PATHS, WORLD, spawn_world
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.parallel import PlanError as JPlanError
from torchdistx_tpu.parallel import ShardingPlan as JPlan
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel import fsdp_partition_spec as jspec
from torchdistx_tpu.parallel import llama_tp_plan as jllama_tp_plan
from torchdistx_tpu.parallel import llama_tp_rule as jllama_tp_rule
from torchdistx_tpu.parallel.fsdp import strided_split as jstrided_split
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.models import Llama as TLlama


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world("plan", tmp_path_factory.mktemp("plan"))


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    return res


def _mesh(axes):
    return jcreate_mesh(axes, devices=jax.devices()[:WORLD])


def _t(spec):
    return None if spec is None else tuple(spec)


def _jax_specs(rules):
    return tuple((pat, P(*spec)) for pat, spec in rules)


def _slice(full, spec, coords, sizes):
    """The piece of ``full`` at ``coords`` under ``spec`` (names major first)."""
    out = full
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,) if entry else ()
        n, idx = 1, 0
        for name in names:
            n, idx = n * sizes[name], idx * sizes[name] + coords[name]
        if n > 1:
            out = np.split(out, n, axis=d)[idx]
    return out


@pytest.mark.parametrize("case", list(PLAN_RESOLUTION))
def test_rule_resolution_matches_jax(world, case):
    rules, default, queries = PLAN_RESOLUTION[case]
    plan = JPlan(_mesh({"fsdp": WORLD}), rules=_jax_specs(rules), default_axis=default)
    want = [(_t(plan.spec_for(p, s)), _t(plan.maybe_spec_for(p, s))) for p, s in queries]
    for r in _got(world, "resolution"):
        assert [(tuple(a), _t(b)) for a, b in r[case]] == want
    if case == "first_match":  # both rules match; the first one answers
        assert want[0][0] == ("fsdp", None) and want[1][0] == ("fsdp", None)
    if case == "no_match":
        assert want == [((), None)]


def test_default_axis_is_fsdp_partition_spec(world):
    want = tuple(jspec((4096, 64), _mesh({"fsdp": WORLD}), "fsdp", 1024))
    for r in _got(world, "resolution"):
        assert tuple(r["fsdp_partition_spec"]) == want
        assert tuple(r["default_axis"][0][0]) == want and tuple(r["default_axis"][1][0]) == ()
        assert tuple(r["explicit_beats_min_elems"][0][0]) == ("fsdp",)


def test_unknown_axes_fail_loudly_as_in_jax(world):
    fsdp, grid = _mesh({"fsdp": WORLD}), _mesh({"dp": 2, "tp": 2})
    for make in (lambda: JPlan(fsdp, default_axis="nope"),
                 lambda: JPlan(fsdp, rules=((r".", P("tp")),)),
                 lambda: JPlan(fsdp, zero2=True),
                 lambda: JPlan(fsdp, default_axis="fsdp").with_mesh(grid)):
        with pytest.raises(JPlanError):
            make()
    for r in _got(world, "errors"):
        assert "default_axis" in r["default_axis"]
        assert "references axis" in r["rule_axis"]
        assert "requires dp_axis" in r["zero2"]
        assert r["with_mesh"] is not None


def test_with_mesh_carries_rules(world):
    plan = JPlan(_mesh({"fsdp": WORLD}), rules=((r"w", P("fsdp")),), default_axis="fsdp")
    moved = plan.with_mesh(_mesh({"dp": 2, "fsdp": 2}))
    assert moved.rules == plan.rules
    for r in _got(world, "with_mesh"):
        assert r["rules_equal"]
        assert tuple(r["spec"]) == tuple(moved.spec_for("w", (8, 8))) == ("fsdp",)
        assert r["size"] == int(moved.mesh.shape["fsdp"]) == 2


def test_llama_tp_rule_assignments_match_jax(world):
    rule = jllama_tp_rule(_mesh({"dp": 2, "tp": 2}), "tp")
    want = [tuple(rule(p, jax.ShapeDtypeStruct(s, jnp.float32)).spec) for p, s in TP_RULE_PATHS]
    assert want == [("tp", None), (None, "tp"), (None, "tp"), ("tp", None), ()]
    for r in _got(world, "tp_rule"):
        assert [tuple(s) for s in r] == want


def _jax_tiny():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(jm)
    return dict(jm.named_parameters())


def _eager():
    tt.manual_seed(7)
    return {k: v.detach().numpy() for k, v in
            TLlama.from_name("tiny", device="cpu").named_parameters()}


def test_materialize_under_the_plan_is_the_eager_slice(world):
    jparams = _jax_tiny()
    plan = jllama_tp_plan(_mesh({"dp": 2, "tp": 2}))
    want_specs = {k: tuple(v) for k, v in plan.describe(jparams).items()}
    eager = _eager()
    sizes = {"dp": 2, "tp": 2}
    for r in _got(world, "materialize"):
        assert {k: tuple(v) for k, v in r["describe"].items()} == want_specs
        assert {k: tuple(v) for k, v in r["specs"].items()} == want_specs
        assert r["per_device_bytes"] == plan.per_device_bytes(jparams)
        for name, full in eager.items():
            np.testing.assert_array_equal(
                r["pieces"][name], _slice(full, want_specs[name], r["coords"], sizes),
                err_msg=name)


def test_apply_cuts_in_place_and_recuts(world):
    eager = _eager()
    mesh = _mesh({"dp": 2, "tp": 2})
    flat = {k: tuple(v) for k, v in jllama_tp_plan(mesh).describe(_jax_tiny()).items()}
    two_d = {k: tuple(v) for k, v in
             jllama_tp_plan(mesh, "tp", fsdp_axis="dp").describe(_jax_tiny()).items()}
    assert two_d["blocks.0.attn.wq.weight"] == ("tp", "dp")
    sizes = {"dp": 2, "tp": 2}
    for rank, r in enumerate(_got(world, "apply")):
        coords = {"dp": rank // 2, "tp": rank % 2}
        assert r["same_objects"] and r["reapplied_in_place"]
        assert {k: tuple(v) for k, v in r["specs_2d"].items()} == two_d
        assert {k: tuple(v) for k, v in r["dict_specs_2d"].items()} == two_d
        for name, full in eager.items():
            np.testing.assert_array_equal(r["pieces"][name],
                                          _slice(full, flat[name], coords, sizes), err_msg=name)
            want = _slice(full, two_d[name], coords, sizes)
            np.testing.assert_array_equal(r["pieces_2d"][name], want, err_msg=name)
            np.testing.assert_array_equal(r["dict_pieces_2d"][name], want, err_msg=name)


def test_optimizer_state_shardings_match_jax(world):
    jparams = _jax_tiny()
    plan = jllama_tp_plan(_mesh({"dp": 2, "tp": 2}))
    placed = plan.apply(jparams)
    tx = anyprecision_adamw(1e-3)
    shardings = plan.optimizer_state_shardings(jax.eval_shape(tx.init, placed), placed)
    assert tuple(shardings.count.spec) == ()
    for r in _got(world, "opt_state"):
        assert r["derived"] == r["actual"]
        assert set(r["derived"]) == set(jparams)
        for name, row in r["derived"].items():
            assert set(row) == {"step", "exp_avg", "exp_avg_sq"}
            assert tuple(row["step"]) == ()
            assert tuple(row["exp_avg"]) == tuple(shardings.exp_avg[name].spec), name
            assert tuple(row["exp_avg_sq"]) == tuple(shardings.exp_avg_sq[name].spec), name
        assert tuple(r["carry"][0]) == ("tp", None) and r["carry"][1] is None


def test_unported_parts_raise_naming_the_roadmap_item(world):
    # every part is ported now: validate, price_step and
    # record_step_collectives in tests/test_torch_comm_audit.py, ZeRO-2 in
    # tests/test_torch_zero2.py; none of them raises NotImplementedError
    for r in _got(world, "unported"):
        for key in ("validate", "price_step", "record_step_collectives", "zero2"):
            assert r[key] is None, (key, r[key])


def test_accumulate_grads_and_strided_split(world):
    want = np.asarray(jstrided_split(jnp.arange(8), 8, 4))
    for r in _got(world, "accumulate"):
        np.testing.assert_array_equal(np.stack(r["strided"]), want)
        np.testing.assert_allclose(r["accum2"], r["whole"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["loss2"], r["loss"], rtol=1e-6)
        assert r["path"] == "blocks.0.attn"
