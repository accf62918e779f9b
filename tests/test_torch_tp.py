"""The port's tensor parallelism (``parallel.tp.GSPMDTrainStep``) against the
JAX package's single-device trajectory, as ``tests/test_tp.py`` holds
JAX's GSPMD step, at world size 4 on ``gloo`` (one spawned world, the
``tp`` suite of ``tests/_torch_dist_worker.py``).

Tiny Llama (f32) with the JAX model's weights (``load_jax_params``), SGD at
lr 1e-1, 3 steps on ``test_tp.py``'s batch: ``llama_tp_plan`` on
``{"dp": 2, "tp": 2}`` (batch over dp) and ``{"tp": 4}`` (Megatron
compute), the 2-D TP x FSDP plan on ``{"fsdp": 2, "tp": 2}`` (batch over
fsdp; the fsdp dim gathered at use), and a plan whose norms are sharded
over tp and whose head is row-parallel (gathered at use, the head's
input cut).  ``test_tp.py``'s tolerances: losses rtol 1e-5, parameters
rtol 1e-4 / atol 1e-6; the parameters keep the plan's specs.  Also: a
model born sharded (``materialize_module(sharding_rule=llama_tp_rule)``)
against the port's unsharded steps; ``accum_steps=2`` against the whole
batch (loss rtol 1e-5, parameters rtol 3e-6 / atol 3e-7, ``test_tp.py:134``)
and its indivisible-batch error (:175); a batch sharded over the wrong
axis warns once (:100) and trains as the global batch, bit for bit; ``tp``
must divide ``n_kv_heads``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import TP_LR, TP_STEPS, TP_TRAINS, WORLD, spawn_world, tp_batch
from torchdistx_tpu_torch.models.llama import LlamaConfig, llama_configs
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel import llama_tp_plan as jllama_tp_plan
from torchdistx_tpu.parallel import ShardingPlan as JPlan
from jax.sharding import PartitionSpec as P

CUSTOM = ((r"norm\.weight$", P("tp")), (r"lm_head\.weight$", P(None, "tp")))


def _jax_model():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(jm)
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, init = _jax_model()
    return spawn_world("tp", tmp_path_factory.mktemp("tp"), {"init": init}, timeout=240.0)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _jax_trajectory(lr, steps, batch):
    """test_tp.py's single-device reference."""
    jm, init = _jax_model()
    params = {k: jnp.asarray(v) for k, v in init.items()}
    tx = optax.sgd(lr)

    @jax.jit
    def step(p, s, b):
        def lf(p):
            return jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1])

        loss, g = jax.value_and_grad(lf)(p)
        u, s = tx.update(g, s, p)
        return jax.tree_util.tree_map(lambda a, b_: a + b_, p, u), s, loss

    s = tx.init(params)
    b = tuple(jnp.asarray(a.astype(np.int32)) for a in batch)
    losses = []
    for _ in range(steps):
        params, s, loss = step(params, s, b)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def reference():
    return _jax_trajectory(TP_LR, TP_STEPS, tp_batch())


def _plan_specs(axes, kind):
    mesh = jcreate_mesh(axes, devices=jax.devices()[:WORLD])
    if kind == "llama":
        plan = jllama_tp_plan(mesh)
    elif kind == "llama_2d":
        plan = jllama_tp_plan(mesh, "tp", fsdp_axis="fsdp")
    else:
        plan = JPlan(mesh, rules=CUSTOM + jllama_tp_plan(mesh).rules)
    _, init = _jax_model()
    return {k: tuple(v) for k, v in plan.describe(init).items()}


def _close(got, want, **tol):
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


@pytest.mark.parametrize("name", list(TP_TRAINS))
def test_tp_training_matches_jax(world, reference, name):
    axes, _, kind = TP_TRAINS[name]
    losses, params = reference
    specs = _plan_specs(axes, kind)
    for r in _got(world, name):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        _close(r["params"], params, rtol=1e-4, atol=1e-6)
        # the parameters kept the plan's specs, and each rank holds its piece
        assert {k: tuple(v) for k, v in r["specs"].items()} == specs
        for k, spec in specs.items():
            want = list(params[k].shape)
            for d, entry in enumerate(spec):
                for ax in (entry if isinstance(entry, tuple) else (entry,) if entry else ()):
                    want[d] //= axes[ax]
            assert r["local_shapes"][k] == tuple(want), k
        assert r["local_forwards"] > 0


def test_megatron_reduces_once_a_sub_layer(world):
    # {"tp": 4}, the batch replicated: a step all-reduces one (B, S, dim)
    # activation a sub-layer in the forward (g after wo, w_down) and one in
    # the backward (f, the attention's and the MLP's input entered once),
    # plus the embedding's forward and the gathered head's input gradient
    cfg = LlamaConfig(**llama_configs["tiny"])
    b, s = tp_batch()[0].shape
    per_step = (4 * cfg.n_layers + 2) * b * s * cfg.dim * 4  # f32
    for r in _got(world, "train_tp4"):
        assert r["payload_bytes"]["all_reduce"] == TP_STEPS * per_step
        assert r["payload_bytes"]["reduce_scatter"] == 0


def test_born_sharded_model_trains_as_the_unsharded_one(world):
    for r in _got(world, "born_sharded"):
        np.testing.assert_allclose(r["losses"], r["ref_losses"], rtol=1e-5)
        _close(r["params"], r["ref_params"], rtol=1e-4, atol=1e-6)
        assert tuple(r["specs"]["blocks.0.attn.wq.weight"]) == ("tp", None)


def test_gradient_accumulation_matches_full_batch(world):
    losses, params = _jax_trajectory(1e-2, 1, tp_batch(b=8))
    for r in _got(world, "accum"):
        one, two = r["accum1"], r["accum2"]
        np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
        _close(two["params"], one["params"], rtol=3e-6, atol=3e-7)
        np.testing.assert_allclose(one["losses"], losses, rtol=1e-5)
        _close(one["params"], params, rtol=1e-4, atol=1e-6)


def test_gradient_accumulation_indivisible_raises(world):
    for r in _got(world, "accum"):
        assert r["indivisible"] is not None and "not divisible" in r["indivisible"]


def test_mismatched_batch_sharding_warns_once(world):
    for r in _got(world, "presharded"):
        assert r["tp_sharded"]["warnings"] == 1
        assert r["global"]["warnings"] == 0
        assert r["tp_sharded"]["losses"] == r["global"]["losses"]


def test_tp_must_divide_the_kv_heads(world):
    for r in _got(world, "kv_heads"):
        assert r["message"] is not None and "n_kv_heads" in r["message"]


def test_gspmd_init_optimizer_places_the_state_and_keeps_the_step():
    """``GSPMDTrainStep.init_optimizer`` (JAX's method): the state of every
    tensor the optimizer holds before the first step, shaped like it; a
    step after it equals a step whose optimizer made its state itself."""
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama as TLlama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import GSPMDTrainStep, create_mesh, llama_tp_plan

    batch = tuple(torch.from_numpy(x).long() for x in tp_batch())

    def run(init):
        tt.manual_seed(0)
        m = TLlama.from_name("tiny", device="cpu")
        mesh = create_mesh({"tp": 1})
        opt = tt.AnyPrecisionAdamW(m.parameters(), lr=1e-3)
        step = GSPMDTrainStep(m, opt, lambda mod, b: F.cross_entropy(mod(b[0]), b[1]), mesh,
                              plan=llama_tp_plan(mesh))
        if init:
            assert step.init_optimizer() is opt
            for p in m.parameters():
                st = opt.state[p]
                assert st and all(v.shape == p.shape for v in st.values()
                                  if isinstance(v, torch.Tensor) and v.dim())
        step(m, opt, batch)
        return {n: p.detach().clone() for n, p in m.named_parameters()}

    a, b = run(True), run(False)
    for n in a:
        assert torch.equal(a[n], b[n]), n
