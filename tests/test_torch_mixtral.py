"""The port's MoE layer and Mixtral against the JAX package's, on the CPU.

The JAX modules are built from a seed and their parameters carried into
the port with ``interop.load_jax_params``; the same numpy inputs go
through both.  f32 throughout.  Tolerances: the MoE layer's outputs and
aux loss atol = rtol = 1e-5 (the same routing, products summed in another
order); its gradients and the tiny Mixtral's logits and gradients 1e-4
(two layers of the same math, logits of O(1)).  Routing ties do not occur
on these random inputs, so top-k picks the same experts on both sides.
Greedy streams and the deferred-init checks are exact.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.generation import generate as j_generate
from torchdistx_tpu.models import Mixtral as JMixtral
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.nn.moe import MoE as JMoE
from torchdistx_tpu.serve import ServeEngine as JServeEngine
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.generation import generate as t_generate
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Mixtral as TMixtral
from torchdistx_tpu_torch.nn import functional as tF
from torchdistx_tpu_torch.nn.moe import MoE as TMoE
from torchdistx_tpu_torch.nn.moe import moe_shard_rule
from torchdistx_tpu_torch.serve import ServeEngine

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
# (capacity_factor, dispatch_mode): dense; capacity 1.0 drops tokens;
# capacity 2.0 = E / top_k drops none
MODES = [(None, "einsum"), (1.0, "einsum"), (1.0, "gather"), (2.0, "einsum"), (2.0, "gather")]
MODE_IDS = ["dense", "einsum-c1", "gather-c1", "einsum-c2", "gather-c2"]


def _params(m):
    return {k: np.asarray(v) for k, v in m.named_parameters()}


def _moe_pair(capacity_factor, dispatch_mode, seed=0):
    tdx.manual_seed(seed)
    jm = JMoE(16, 32, n_experts=4, top_k=2, capacity_factor=capacity_factor,
              dispatch_mode=dispatch_mode)
    tm = TMoE(16, 32, n_experts=4, top_k=2, capacity_factor=capacity_factor,
              dispatch_mode=dispatch_mode, device="cpu")
    load_jax_params(tm, _params(jm))
    return jm, tm


@pytest.mark.parametrize("capacity_factor,dispatch_mode", MODES, ids=MODE_IDS)
def test_moe_output_aux_and_grads_match_jax(capacity_factor, dispatch_mode):
    jm, tm = _moe_pair(capacity_factor, dispatch_mode)
    x = np.random.RandomState(1).randn(2, 8, 16).astype(np.float32)
    params = dict(jm.named_parameters())

    def jloss(p, x_):
        y, aux = functional_call(jm, p, (x_,), {"return_aux": True})
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty, taux = tm(tx, return_aux=True)
    ((ty * ty).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **LAYER_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[name]), err_msg=name, **TOL)


def test_tight_capacity_drops_tokens_as_jax_does():
    """At capacity factor 0.5 most second choices are dropped: the outputs
    equal JAX's, and differ from the dense layer's."""
    jm, tm = _moe_pair(0.5, "gather", seed=3)
    _, dense = _moe_pair(None, "einsum", seed=3)
    x = np.random.RandomState(2).randn(1, 16, 16).astype(np.float32)
    with torch.no_grad():
        y = tm(torch.from_numpy(x)).numpy()
        yd = dense(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jm(jnp.asarray(x))), **LAYER_TOL)
    assert np.abs(y - yd).max() > 1e-3


@pytest.mark.parametrize("kw,match", [
    (dict(top_k=5), "top_k"),
    (dict(dispatch_mode="scatter"), "dispatch_mode"),
    (dict(dispatch_mode="gather"), "requires capacity_factor"),
], ids=["top_k", "mode", "gather-dense"])
def test_moe_argument_errors_match_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JMoE(8, 16, 4, **kw)
    with pytest.raises(ValueError, match=match):
        TMoE(8, 16, 4, device="cpu", **kw)


def test_expert_parallel_rules_wait_for_the_parallel_stack():
    """The parallel stack is ported: ``moe_shard_rule`` and
    ``Mixtral.shard_rule`` give JAX's specs on every path of tiny Mixtral
    (3-D expert weights over ``ep``, the rest replicated or
    ``base_rule``'s)."""
    from jax.sharding import NamedSharding as JNamedSharding
    from jax.sharding import PartitionSpec as P

    from torchdistx_tpu.nn.moe import moe_shard_rule as j_moe_shard_rule
    from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
    from torchdistx_tpu_torch.parallel import NamedSharding, create_mesh

    mesh, jmesh = create_mesh({"dp": 1, "ep": 1}), jcreate_mesh({"dp": 1, "ep": 1},
                                                                devices=jax.devices()[:1])
    model = TMixtral.from_name("tiny", device="cpu")
    base = lambda path, like: NamedSharding(mesh, ("dp",) if like.ndim == 2 else ())  # noqa: E731
    jbase = lambda path, like: JNamedSharding(jmesh, P("dp") if like.ndim == 2 else P())  # noqa: E731
    for rule, jrule in ((model.shard_rule(mesh), j_moe_shard_rule(jmesh)),
                        (moe_shard_rule(mesh, "ep", base), j_moe_shard_rule(jmesh, "ep", jbase))):
        for name, p in model.named_parameters():
            like = jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
            assert tuple(rule(name, p).spec) == tuple(jrule(name, like).spec), name
    assert tuple(model.shard_rule(mesh)("blocks.0.mlp.w_gate", model.blocks[0].mlp.w_gate)
                 .spec) == ("ep", None, None)


def _mixtral_pair(**overrides):
    tdx.manual_seed(0)
    jm = JMixtral.from_name("tiny", **overrides)
    tm = TMixtral.from_name("tiny", device="cpu", **overrides)
    load_jax_params(tm, _params(jm))
    return jm, tm


@pytest.fixture(scope="module")
def mixtral():
    return _mixtral_pair(n_kv_heads=2)


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def test_forward_with_aux_and_grads_match_jax(mixtral):
    jm, tm = mixtral
    toks, labels = _tokens(0, 2, 19), _tokens(1, 2, 19)
    params = dict(jm.named_parameters())

    def jloss(p):
        logits, aux = functional_call(jm, p, (jnp.asarray(toks),), method="forward_with_aux")
        return jF.cross_entropy(logits, jnp.asarray(labels)) + 1e-2 * aux, (logits, aux)

    (jl, (jlogits, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tm.zero_grad(set_to_none=True)
    logits, aux = tm.forward_with_aux(torch.from_numpy(toks).long())
    loss = tF.cross_entropy(logits, torch.from_numpy(labels).long()) + 1e-2 * aux
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]), err_msg=name, **TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(tm(torch.from_numpy(toks).long()).numpy(),
                                      logits.detach().numpy())


@pytest.mark.parametrize("capacity_factor,dispatch_mode", MODES[1:3], ids=MODE_IDS[1:3])
def test_capacity_mixtral_matches_jax(capacity_factor, dispatch_mode):
    jm, tm = _mixtral_pair(capacity_factor=capacity_factor, moe_dispatch=dispatch_mode)
    toks = _tokens(2, 2, 16)
    with torch.no_grad():
        out = tm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(out, np.asarray(jm(jnp.asarray(toks))), **TOL)


def test_cached_decode_matches_jax(mixtral):
    jm, tm = mixtral
    toks = _tokens(3, 1, 16)
    jc = jm.init_cache(1, 32)
    jl, jc = jm.forward_cached(jnp.asarray(toks[:, :12]), jc, 0)
    with torch.no_grad():
        tc = tm.init_cache(1, 32)
        tl, tc = tm.forward_cached(torch.from_numpy(toks[:, :12]).long(), tc, 0)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for i in range(12, 16):
            step = toks[:, i:i + 1]
            jl, jc = jm.forward_cached(jnp.asarray(step), jc, i)
            tl, tc = tm.forward_cached(torch.from_numpy(step).long(), tc, i)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_greedy_generate_matches_jax(mixtral):
    jm, tm = mixtral
    prompt = _tokens(4, 1, 8)
    ref = np.asarray(j_generate(jm, jnp.asarray(prompt), max_new_tokens=5))
    with torch.no_grad():
        out = t_generate(tm, torch.from_numpy(prompt).long(), max_new_tokens=5)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_serve_engine_streams_equal_jax_engine():
    jm, tm = _mixtral_pair(n_kv_heads=2, max_seq_len=64)
    rs = np.random.RandomState(5)
    reqs = [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32), "max_new_tokens": 6,
             "temperature": 0.0, "seed": i} for i, n in enumerate((5, 12, 9))]
    kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,))
    ref = JServeEngine(jm, **kw).run(reqs)
    out = ServeEngine(tm, **kw).run(reqs)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)


def _state(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def test_block_by_block_materialize_equals_whole_model():
    tt.manual_seed(7)
    whole = tt.deferred_init(TMixtral.from_name, "tiny", device="cpu")
    tt.materialize_module(whole)
    tt.manual_seed(7)
    parts = tt.deferred_init(TMixtral.from_name, "tiny", device="cpu")
    tt.materialize_module(parts.blocks[1])  # out of order on purpose
    assert tt.is_deferred(parts.blocks[0]) and not tt.is_deferred(parts.blocks[1])
    for blk in parts.blocks:
        tt.materialize_module(blk)
    tt.materialize_module(parts)
    assert not tt.is_deferred(parts)
    a, b = _state(whole), _state(parts)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_materialize_allocates_one_block_and_releases_dropped_weights():
    """A block's materialize makes only its own tensors, and once a
    quantized block dropped its full-precision weights the next
    materialize releases them from the record session."""
    from torchdistx_tpu_torch.nn import quantize_module

    tt.manual_seed(8)
    m = tt.deferred_init(TMixtral.from_name, "tiny", device="cpu")
    session = m.blocks[0].mlp.w_gate._ref[0]
    st = lambda: session._devices[torch.device("cpu")]  # noqa: E731
    tt.materialize_module(m.blocks[0])
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in st().cache.values()}
    block0 = {p.untyped_storage().data_ptr(): p.untyped_storage().nbytes()
              for p in m.blocks[0].parameters()}
    assert held == block0  # the block's storages, no other block's
    keys0 = set(st().cache)
    quantize_module(m.blocks[0])
    gc.collect()
    tt.materialize_module(m.blocks[1])
    # block 0's full-precision tensors left the session (its norms stay)
    norms = {p.untyped_storage().data_ptr() for n, p in m.blocks[0].named_parameters()
             if "norm" in n}
    assert {t.untyped_storage().data_ptr() for k, t in st().cache.items() if k in keys0} == norms
    tt.materialize_module(m)
    assert not tt.is_deferred(m)
    with torch.no_grad():
        assert torch.isfinite(m(torch.from_numpy(_tokens(9, 1, 8)).long())).all()


@pytest.mark.parametrize("name", ["tiny", "mixtral_8x7b"])
def test_from_name_takes_the_jax_config(name):
    """``Mixtral.from_name`` (a classmethod of its own, as JAX's): the
    JAX table's shapes, the overrides applied, the config's class kept."""
    from torchdistx_tpu.models.mixtral import mixtral_configs as jconfigs
    from torchdistx_tpu_torch.models.mixtral import MixtralConfig

    assert "from_name" in vars(TMixtral)
    with tt.fake_mode():
        m = TMixtral.from_name(name, device="cpu", n_layers=1)
    assert isinstance(m.cfg, MixtralConfig) and m.cfg.n_layers == 1
    for key, want in jconfigs[name].items():
        if key not in ("dtype", "n_layers"):
            assert getattr(m.cfg, key) == want, key
    assert m.blocks[0].mlp.w_gate.shape[0] == jconfigs[name]["n_experts"]
