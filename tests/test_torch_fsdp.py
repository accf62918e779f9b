"""The port's FSDP layer (``parallel.fsdp``, sharded ``materialize_module``)
at world size 4 on ``gloo``, against the JAX package on 4 of the 8 CPU
devices.

- ``fsdp_partition_spec`` equals JAX's for a table of shapes.
- ``materialize_module(sharding_rule=fsdp_shard_rule(mesh))`` of tiny Llama:
  every rank's piece is bit-identical to the same slice of an eager
  construction from the same seed, under JAX's spec, and the record
  session keeps no full copy of a tensor it cut.
- 3 ``ShardedTrainStep`` steps of tiny Llama (f32) against JAX's
  ``ShardedTrainStep`` from the same weights (``load_jax_params``) with
  AnyPrecisionAdamW (lr 1e-3, f32 variance) on both sides: at fsdp 4, and
  at dp 2 x fsdp 2 with ``allreduce_hook`` and with ``noop_hook`` (whose
  dp replicas diverge; JAX's arrays read back the dp = 0 replica, so the
  port's dp = 0 ranks are held), at fsdp 4 with ``accum_steps=2``, and at
  fsdp 4 with the port's model rematerialized (``remat=True``: each block
  recomputed in the backward from the gathered parameters) (batch 8 x 32
  in all).  Tolerances those of
  ``tests/test_torch_train.py``: losses rtol = atol = 1e-5; parameters all
  within 1e-4 (a tenth of one step) and 99.9% within 1e-5.
- 3 steps of the 8-bit AdamW (lr 1e-3, weight decay 0.01) through the
  sharded step against JAX's ``ShardedTrainStep`` + ``adamw_8bit`` with the
  state placed by JAX's ``adam8bit_state_shardings``: tiny Llama at fsdp 4
  (every matrix a flat piece of whole blocks; the norms replicated, their
  codes cut on the block dim) and tiny GPT-2 (vocab 257, 70 positions) at
  dp 2 x fsdp 2, whose embedding is cut on dim 1 (its codes on the block
  dim, the absmax all-reduced) and whose position table is cut into pieces
  of 2240 values, not whole blocks.  The gradients reach the update
  summed over the ranks in another order than XLA sums them (an ulp
  apart), which moves the scales by up to 2e-5 relative and flips a code
  at a half-integer tie once in some 10^4, and a flipped moment code moves
  the next steps' update of that value by up to 4.4e-5.  So: losses rtol
  = atol = 1e-5; parameters all within 1e-4 and, on all but 1 in 10^3 of
  the model's values (97% of any one tensor's), within
  ``tests/test_torch_quantized.py``'s atol 1e-6 + rtol 1e-5; the gathered
  codes equal JAX's global arrays on all but 1 in 10^3 of a slot's codes
  and there at most 1 apart; the scales within rtol 5e-5.  That the
  placed update is the unsharded one, bit for bit, on the same gradients,
  is ``test_placed_8bit_update_equals_the_unsharded_one_bit_for_bit``
  (and the unsharded update is JAX's: ``test_torch_quantized.py``).  Each
  rank's pieces have JAX's specs.  The trainer's
  comm audit exceeds JAX's by exactly the 8-bit update's moves, which XLA
  inserts in JAX's step unbooked (``_eight_bit_moves``): at fsdp 4 in
  tiny Llama, 5 ``all_gather`` of the norms' new values (1024 bytes each)
  and 10 ``pmax`` of 4 bytes; at fsdp 2 in tiny GPT-2, 24 ``all_gather``
  (the gradient, the parameter and the new values of the two embeddings,
  the new values of 18 replicated vectors: 270,848 bytes) and 38
  ``pmax`` (664 bytes).
- ``contiguous_split`` and ``ShardedTrainStep.param_sharding`` equal JAX's.
- The examples at world 4: ``examples.deferred_init_7b.main("tiny")``
  counts Llama-2-7B in fake mode as JAX's fake mode does (6,738,415,616,
  zero bytes held) and materializes tiny Llama FSDP-sharded;
  ``examples.vit_train.main`` (tiny ViT, 3 of the example's steps, JAX's
  weights) gives the JAX example's loop's losses on 4 CPU devices within
  rtol 1e-5 (``OptaxAdamW`` is optax's arithmetic; XLA fuses some of its
  multiply-adds), and ViT-L/16's fake-mode count equals JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
import torchdistx_tpu_torch as tt
from _torch_dist_worker import WORLD, lm_batch, spawn_world
from _torch_dist_worker import FSDP8_GPT2, FSDP8_LR, FSDP8_WD, VIT_STEPS
from torchdistx_tpu.models import ViT as JViT
from torchdistx_tpu.parallel import fsdp_shard_rule as jfsdp_shard_rule
from torchdistx_tpu.models import GPT2 as JGPT2
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.obs.comm import comm_audit as jcomm_audit
from torchdistx_tpu.optimizers import adam8bit_state_shardings as jstate_shardings
from torchdistx_tpu.optimizers import adamw_8bit as jadamw_8bit
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.parallel import ShardedTrainStep as JStep
from torchdistx_tpu.parallel.fsdp import contiguous_split as jcontiguous_split
from torchdistx_tpu.parallel import allreduce_hook as jallreduce
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel import fsdp_partition_spec as jspec
from torchdistx_tpu.parallel import noop_hook as jnoop
from torchdistx_tpu_torch.models import Llama as TLlama

LR, STEPS = 1e-3, 3
SHAPES = [(4096, 1024), (1000, 8), (3, 4096), (7, 13, 16), (64,), (8, 128), (1023, 1),
          (4, 4, 64), (1, 1024), (2, 512), (256, 64), (6, 6, 6, 6)]
TRAINS = {
    "train_fsdp4": ({"fsdp": 4}, dict(shard_axis="fsdp"), False),
    "train_dp2_fsdp2_allreduce": ({"dp": 2, "fsdp": 2},
                                  dict(shard_axis="fsdp", replica_axes=("dp",),
                                       comm_hook=jallreduce), False),
    "train_dp2_fsdp2_noop": ({"dp": 2, "fsdp": 2},
                             dict(shard_axis="fsdp", replica_axes=("dp",), comm_hook=jnoop),
                             True),
    "train_fsdp4_accum2": ({"fsdp": 4}, dict(shard_axis="fsdp", accum_steps=2,
                                             batch_axes=("fsdp",)), False),
    # the port's model with remat=True (the JAX one without: the same math)
    "train_fsdp4_remat": ({"fsdp": 4}, dict(shard_axis="fsdp"), False),
}


def _jax_init():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(jm)
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


def _jax_gpt2():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JGPT2.from_name, "tiny", **FSDP8_GPT2)
    tdx.materialize_module(jm)
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


def _jax_vit(steps=0):
    """The JAX example's loop (``examples/vit_train.py``) over 4 CPU devices
    for ``steps`` steps: the materialized weights and the losses."""
    import optax

    tdx.manual_seed(0)
    model = tdx.deferred_init(JViT.from_name, "tiny")
    mesh = _mesh({"fsdp": WORLD})
    tdx.materialize_module(model, sharding_rule=jfsdp_shard_rule(mesh))
    params = dict(model.named_parameters())
    init = {k: np.asarray(v) for k, v in params.items()}
    size = model.cfg.image_size

    def loss_fn(p, batch):
        images, labels = batch
        return jF.cross_entropy(functional_call(model, p, (images,)), labels)

    step = JStep(loss_fn, optax.adamw(3e-4, weight_decay=0.05), mesh, shard_axis="fsdp")
    opt_state = step.init_optimizer(params)
    rs = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        images = rs.randn(8, 3, size, size).astype(np.float32)
        labels = (rs.rand(8) * model.cfg.num_classes).astype(np.int32)
        params, opt_state, loss = step(params, opt_state, (images, labels))
        losses.append(float(loss))
    return init, losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, init = _jax_init()
    payload = dict(init=init, gpt2_init=_jax_gpt2()[1], vit_init=_jax_vit()[0],
                   lr=LR, steps=STEPS,
                   batch=lm_batch(8, 32), shapes=SHAPES)
    return spawn_world("fsdp", tmp_path_factory.mktemp("fsdp"), payload)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _mesh(axes):
    return jcreate_mesh(axes, devices=jax.devices()[:WORLD])


def test_fsdp_partition_spec_matches_jax(world):
    mesh = _mesh({"fsdp": WORLD})
    want = [tuple(jspec(s, mesh, "fsdp")) for s in SHAPES]
    for r in _got(world, "specs"):
        assert [tuple(s) for s in r["specs"]] == want


def test_sharded_materialize_is_the_eager_slice(world):
    tt.manual_seed(7)
    eager = dict(TLlama.from_name("tiny", device="cpu").named_parameters())
    mesh = _mesh({"fsdp": WORLD})
    got = _got(world, "materialize")
    # each cut tensor's full value was dropped once its piece was taken:
    # the session keeps only the replicated (uncut) ones
    uncut = sum(p.numel() * p.element_size() for p in eager.values()
                if "fsdp" not in jspec(p.shape, mesh, "fsdp"))
    assert [r["_cached_bytes"] for r in got] == [uncut] * WORLD
    for name, full in eager.items():
        spec = tuple(jspec(full.shape, mesh, "fsdp"))
        for rank, res in enumerate(got):
            r = res[name]
            assert r["is_param"] and tuple(r["spec"]) == spec and r["shape"] == tuple(full.shape)
            want = full.detach().numpy()
            if "fsdp" in spec:
                want = np.split(want, WORLD, axis=spec.index("fsdp"))[rank]
            np.testing.assert_array_equal(r["piece"], want, err_msg=f"{name} rank {rank}")


def _jax_train(axes, kw):
    jm, init = _jax_init()
    tx = anyprecision_adamw(LR, variance_dtype=jnp.float32)

    def loss_fn(p, b):
        return jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1])

    step = JStep(loss_fn, tx, _mesh(axes), **kw)
    params = step.shard_params({k: jnp.asarray(v) for k, v in init.items()})
    opt = step.init_optimizer(params)
    batch = tuple(jnp.asarray(a.astype(np.int32)) for a in lm_batch(8, 32))
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


def _close_params(got, want):
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 1e-4, (name, diff.max())
        assert np.mean(diff <= 1e-5) >= 0.999, (name, np.mean(diff <= 1e-5))


@pytest.mark.parametrize("name", list(TRAINS))
def test_sharded_train_step_matches_jax(world, name):
    axes, kw, first_replica_only = TRAINS[name]
    losses, params = _jax_train(axes, kw)
    for r in _got(world, name):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-5)
        if first_replica_only and r["coords"]["dp"] != 0:
            continue
        _close_params(r["params"], params)


def test_contiguous_split_and_param_sharding_match_jax(world):
    x = np.arange(48).reshape(12, 4)
    want = np.asarray(jcontiguous_split(jnp.asarray(x), 12, 3))
    mesh = _mesh({"fsdp": WORLD})
    jshard = JStep(lambda p, b: 0.0, anyprecision_adamw(LR), mesh)
    specs = jshard.param_sharding({str(s): jnp.zeros(s) for s in SHAPES})
    for r in _got(world, "helpers"):
        np.testing.assert_array_equal(r["contiguous_split"], want)
        assert r["param_sharding"] == {k: tuple(v.spec) for k, v in specs.items()}


TRAINS8 = {
    "train_fsdp4_8bit": ("llama", {"fsdp": 4}, dict(shard_axis="fsdp")),
    "train_fsdp2_8bit_misaligned": ("gpt2", {"dp": 2, "fsdp": 2},
                                    dict(shard_axis="fsdp", replica_axes=("dp",),
                                         comm_hook=jallreduce)),
}
SLOTS = ("m_codes", "m_scales", "v_codes", "v_scales")


def _jax_train8(kind, axes, kw):
    jm, init = _jax_gpt2() if kind == "gpt2" else _jax_init()
    tx = jadamw_8bit(FSDP8_LR, weight_decay=FSDP8_WD)

    def loss_fn(p, b):
        return jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1])

    mesh = _mesh(axes)
    step = JStep(loss_fn, tx, mesh, **kw)
    params = step.shard_params({k: jnp.asarray(v) for k, v in init.items()})
    state = tx.init(params)
    placed = jstate_shardings(state, mesh, "fsdp")
    state = jax.device_put(state, placed)
    batch = tuple(jnp.asarray(a.astype(np.int32)) for a in lm_batch(8, 32))
    losses = []
    with jcomm_audit() as prof:  # the step books its collectives as it traces
        for _ in range(STEPS):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
    specs = {k: [tuple(s.spec) for s in getattr(placed, k)] for k in SLOTS}
    return (losses, {k: np.asarray(v) for k, v in params.items()},
            {k: [np.asarray(x) for x in getattr(state, k)] for k in SLOTS},
            int(state.count), specs, prof.to_json()["entries"], init)


def _eight_bit_moves(init, n, axis="fsdp", block=256):
    """What the port's placed 8-bit update books beyond JAX's step (which
    has the same moves, inserted by XLA, unbooked): per parameter whose
    rank's blocks are not its piece's, an all-gather of the gradient and
    of the parameter when the parameter is cut, of the new values of the
    rank's blocks when the state is cut, and a ``pmax`` of the scales for
    each moment when the block dim is cut.  ``{kind: (ops, payload)}``."""
    from torchdistx_tpu_torch.parallel.fsdp import fsdp_partition_spec
    from torchdistx_tpu_torch.parallel.mesh import AbstractMesh

    mesh = AbstractMesh(np.arange(n), (axis,))
    out = {"all_gather": [0, 0], "pmax": [0, 0]}
    for v in init.values():
        nb = -(-v.size // block)
        spec = fsdp_partition_spec(v.shape, mesh, axis)
        state_dim = 0 if nb % n == 0 else 1 if block % n == 0 else None
        local = (not spec and state_dim is None) or (
            spec and spec[0] == axis and state_dim == 0 and (v.size // n) % block == 0)
        if local:
            continue
        if spec:
            out["all_gather"][0] += 2
            out["all_gather"][1] += 2 * v.nbytes
        if state_dim is not None:
            out["all_gather"][0] += 1
            out["all_gather"][1] += nb * block * v.itemsize
        if state_dim == 1:
            out["pmax"][0] += 2
            out["pmax"][1] += 2 * nb * 4
    return out


def _entries(entries):
    return {(e["kind"], e["axis"]): (e["ops"], e["payload_bytes"]) for e in entries}


@pytest.mark.parametrize("name", list(TRAINS8))
def test_sharded_8bit_step_matches_jax(world, name):
    kind, axes, kw = TRAINS8[name]
    losses, params, state, count, specs, jcomm, init = _jax_train8(kind, axes, kw)
    moves = _eight_bit_moves(init, axes["fsdp"])
    assert moves["all_gather"][0] > 0 and moves["pmax"][0] > 0
    for r in _got(world, name):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-5)
        assert r["count"] == count == STEPS
        far = 0
        for k, want in params.items():
            diff = np.abs(r["params"][k] - want)
            assert diff.max() <= 1e-4, (k, diff.max())
            assert (diff <= 1e-6 + 1e-5 * np.abs(want)).mean() >= 0.97, k
            far += int((diff > 1e-6 + 1e-5 * np.abs(want)).sum())
        assert far <= 1e-3 * sum(v.size for v in params.values()), far
        for slot in SLOTS:
            flips = 0
            for i, (got, want) in enumerate(zip(r["state"][slot], state[slot])):
                assert got.shape == want.shape and got.dtype == want.dtype, (slot, i)
                if slot.endswith("codes"):
                    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                    assert diff.max() <= 1, (slot, i)
                    flips += int((diff != 0).sum())
                else:
                    np.testing.assert_allclose(got, want, rtol=5e-5, atol=0, err_msg=slot)
            assert flips < 1e-3 * sum(w.size for w in state[slot]), (slot, flips)
        assert r["specs"] == specs
        got, want = _entries(r["comm"]), _entries(jcomm)
        extra = {k: (got[k][0] - want.get(k, (0, 0))[0], got[k][1] - want.get(k, (0, 0))[1])
                 for k in got}
        assert extra.pop(("all_gather", "fsdp")) == tuple(moves["all_gather"])
        assert extra.pop(("pmax", "fsdp")) == tuple(moves["pmax"])
        assert set(want) <= set(got) and not any(any(v) for v in extra.values()), extra
    if name == "train_fsdp4_8bit":
        assert moves == {"all_gather": [5, 5 * 1024], "pmax": [10, 40]}


def test_placed_8bit_update_equals_the_unsharded_one_bit_for_bit(world):
    for r in _got(world, "placed_update"):
        assert all(r["equal"].values()), [k for k, v in r["equal"].items() if not v]
        # a dim-1 cut, a misaligned dim-0 cut, an aligned one, a replicated
        # parameter (its block dim cut), a misaligned f32 one
        assert [(p["local"], p["param_dim"], p["state_dim"]) for p in r["placements"]] == [
            (False, 1, 1), (False, 0, 0), (True, 0, 0), (False, None, 1), (False, 0, 0)]


def test_examples_match_jax(world):
    with tdx.fake_mode():
        n7b = JLlama.from_name("llama2_7b").num_params()
        nvit = JViT.from_name("vit_l16").num_params()
    assert n7b == 6_738_415_616
    _, losses = _jax_vit(VIT_STEPS)
    tiny = sum(v.size for v in _jax_init()[1].values())
    for r in _got(world, "examples"):
        assert r["deferred"] == {"fake_params": n7b, "fake_bytes_held": 0, "n_params": tiny,
                                 "sharded": True, "card_bytes": 0}
        assert r["tok_emb"] == ("fsdp", None)
        assert r["vit_fake_params"] == nvit
        np.testing.assert_allclose(r["vit_losses"], losses, rtol=1e-5)
        assert r["vit_slots"] == ["exp_avg", "exp_avg_sq", "step"]
