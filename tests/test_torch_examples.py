"""The port's examples (``torchdistx_tpu_torch/examples``) at a tiny size
on the CPU: the counterparts of ``examples/elastic_training.py``,
``long_context_sp.py``, ``quantized_inference.py`` and the FSDP
``train_gpt2.py``.

``train_gpt2`` and ``long_context_sp`` also run in ONE spawned world of two
``gloo`` ranks (the ``examples`` suite of ``tests/_torch_dist_worker.py``,
a 240 s deadline): FSDP over ``{"fsdp": 2}`` gives the losses of one rank
to reduction order (rtol 1e-5), each rank holding half of every cut
parameter; the sequence cut over ``{"sp": 2}`` gives one rank's losses
within 1e-4 (the ring and the all-to-alls sum in another order).  Each
example's ``python -m`` entry point runs once with the JAX example's
environment knobs (``TDX_PLATFORM=cpu``, ``TDX_GEN_MODEL``, ``TDX_SP_MODE``,
``TDX_SEQ``).

Each example is also held against the JAX package on the same weights
(``params=``, the JAX model's, through ``load_jax_params``):

- ``quantized_inference``: JAX's ``quantize_module`` keeping ``lm_head``
  and its ``generate`` on tiny Llama: the same 16 greedy tokens, the same
  number of int8 layers and the same byte counts before and after;
- ``elastic_training``: the JAX example's ``Trainer`` recipe (its MLP,
  ``guard_nonfinite_updates(optax.adam(1e-3))``, the poisoned batch 30,
  ``on_failure="restore"``): the same failure record and the same logged
  steps, the losses within rtol 1e-4 (each is rounded to 6 digits in the
  record, after 60 Adam steps in f32);
- ``long_context_sp`` (ring and Ulysses, one rank): the JAX Llama at the
  same dims without ``sp_axis``, five ``optax.adamw(3e-4)`` steps: losses
  within rtol 1e-5;
- ``train_gpt2`` at world 2, FSDP from the JAX weights loaded into each
  rank's pieces, fused loss: the JAX recipe's losses
  (``tests/test_torch_train.py``'s ``_jax_gpt2_recipe``) within rtol = atol
  = 1e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from _torch_dist_worker import EXAMPLE_GPT2, EXAMPLE_SP, spawn_world
from test_torch_train import _jax_gpt2_recipe
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu_torch.examples import (elastic_training, long_context_sp,
                                           quantized_inference, train_gpt2)

ROOT = Path(__file__).resolve().parents[1]
GPT2_STREAM = np.random.RandomState(0).randint(0, 256, 50_000)


@pytest.fixture(scope="module")
def jax_gpt2():
    """The JAX GPT-2 recipe's start weights and losses on ``GPT2_STREAM``."""
    init, losses, _ = _jax_gpt2_recipe(GPT2_STREAM, EXAMPLE_GPT2["batch"],
                                       EXAMPLE_GPT2["seq"])
    return init, losses


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_gpt2):
    payload = {"gpt2_init": jax_gpt2[0], "gpt2_stream": GPT2_STREAM}
    return spawn_world("examples", tmp_path_factory.mktemp("examples"), payload, world=2,
                       timeout=240.0)


def _ranks(world, name):
    out = [r[name] for r in world]
    for r in out:
        assert "error" not in r, r["error"]
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_ce"])
def test_train_gpt2_fsdp_over_two_ranks_gives_one_ranks_losses(world, fused):
    one = train_gpt2.main("tiny", fused_ce=fused, device="cpu", log_fn=lambda m: None,
                          **EXAMPLE_GPT2)
    assert one["step"].mesh.shape == {"fsdp": 1}
    for rank in _ranks(world, "gpt2_fused" if fused else "gpt2"):
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=1e-5)
        assert rank["n_params"] == one["n_params"]
        cut = [(local, whole) for local, whole in rank["pieces"].values() if local != whole]
        assert cut and all(local[0] * 2 == whole[0] for local, whole in cut)


def test_train_gpt2_fsdp_from_jax_weights_matches_the_jax_recipe(world, jax_gpt2):
    """World 2, each rank loading its pieces of the JAX weights: the path
    of a launch without ``params`` (sharded materialize, FSDP step), held
    against the JAX recipe."""
    for rank in _ranks(world, "gpt2_jax"):
        assert len(rank["losses"]) == len(jax_gpt2[1]) == EXAMPLE_GPT2["steps"]
        np.testing.assert_allclose(rank["losses"], jax_gpt2[1], atol=1e-5, rtol=1e-5)
        cut = [(local, whole) for local, whole in rank["pieces"].values() if local != whole]
        assert cut and all(local[0] * 2 == whole[0] for local, whole in cut)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_long_context_sp_over_two_ranks_gives_one_ranks_losses(world, mode):
    one = long_context_sp.main(sp_mode=mode, device="cpu", log_fn=lambda m: None,
                               **EXAMPLE_SP)
    assert one["ranks"] == 1 and one["biased_out_finite"]
    for rank in _ranks(world, f"sp_{mode}"):
        assert rank["ranks"] == 2 and rank["biased_out_finite"]
        assert rank["biased_out_shape"] == one["biased_out_shape"] == (1, 64, 4, 64)
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=1e-4)
        assert rank["losses"][-1] < rank["losses"][0]


def _jax_sp_losses(seq, steps):
    """The JAX example's model and loop (``examples/long_context_sp.py``)
    at the port's dims, without ``sp_axis``: start weights and losses."""
    import optax

    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny", max_seq_len=seq, n_heads=8, dim=512,
                           dtype=jnp.float32)
    tdx.materialize_module(jm)
    params = dict(jm.named_parameters())
    init = {k: np.asarray(v) for k, v in params.items()}

    def loss_fn(p, tokens, labels):
        return jF.cross_entropy(functional_call(jm, p, (tokens,)), labels)

    tx = optax.adamw(3e-4)

    @jax.jit
    def step(p, s, tokens, labels):
        loss, g = jax.value_and_grad(loss_fn)(p, tokens, labels)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    data = jnp.asarray(np.random.RandomState(0).randint(0, 256, (2, seq + 1)), jnp.int32)
    state, losses = tx.init(params), []
    for _ in range(steps):
        params, state, loss = step(params, state, data[:, :-1], data[:, 1:])
        losses.append(float(loss))
    return init, losses


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_long_context_sp_matches_the_jax_model_on_one_rank(mode):
    init, jlosses = _jax_sp_losses(EXAMPLE_SP["seq"], EXAMPLE_SP["steps"])
    out = long_context_sp.main(sp_mode=mode, device="cpu", params=init,
                               log_fn=lambda m: None, **EXAMPLE_SP)
    assert out["ranks"] == 1 and len(out["losses"]) == len(jlosses)
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)


def _jax_elastic(workdir):
    """The JAX example's recipe (``examples/elastic_training.py``): start
    weights and the trainer's log records."""
    import optax

    from torchdistx_tpu import nn as jnn
    from torchdistx_tpu.trainer import Trainer
    from torchdistx_tpu.utils.failure import (FailureDetector, Heartbeat,
                                              guard_nonfinite_updates)

    class MLP(jnn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(32, 128)
            self.fc2 = jnn.Linear(128, 1)

        def forward(self, x):
            return self.fc2(jnn.functional.relu(self.fc1(x)))

    tdx.manual_seed(0)
    model = tdx.deferred_init(MLP)
    tdx.materialize_module(model)
    params = dict(model.named_parameters())
    init = {k: np.asarray(v) for k, v in params.items()}
    tx = guard_nonfinite_updates(optax.adam(1e-3))

    def loss_fn(p, batch):
        x, y = batch
        return jnp.mean((functional_call(model, p, (x,)) - y) ** 2)

    @jax.jit
    def step(p, s, batch):
        loss, grads = jax.value_and_grad(loss_fn)(p, batch)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.randn(64, 32), jnp.float32)
    y = jnp.sum(x[:, :4], axis=1, keepdims=True)

    def batches():
        n = 0
        while True:
            n += 1
            yield (x, y * jnp.float32(float("nan"))) if n == 30 else (x, y)

    records = []
    with Heartbeat(os.path.join(workdir, "heartbeat"), interval_s=5.0) as hb:

        def log(metrics):
            hb.step = metrics.get("step", hb.step)
            records.append(metrics)

        trainer = Trainer(step, params, tx.init(params), log_every=10, log_fn=log,
                          checkpoint_dir=workdir, checkpoint_every=10,
                          failure_detector=FailureDetector(nan_tolerance=0,
                                                           step_deadline_s=120),
                          on_failure="restore")
        trainer.fit(batches(), num_steps=60)
    assert trainer.global_step == 60
    return init, records


def test_elastic_training_matches_the_jax_example(tmp_path):
    (tmp_path / "jax").mkdir()
    init, jrecords = _jax_elastic(str(tmp_path / "jax"))
    out = elastic_training.main(device="cpu", workdir=str(tmp_path / "port"), params=init,
                                log_fn=lambda m: None)
    failures = [r for r in jrecords if "failure" in r]
    assert failures == out["failures"] == [{"step": 30, "failure": "nonfinite",
                                            "action": "restored", "resumed_from": 20}]
    got = [(r["step"], r["loss"]) for r in out["records"] if "loss" in r]
    want = [(r["step"], r["loss"]) for r in jrecords if "loss" in r]
    assert [s for s, _ in got] == [s for s, _ in want] == [10, 20, 30, 40, 50, 60]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-4)


def test_elastic_training_rolls_back_to_the_checkpoint_and_finishes(tmp_path):
    out = elastic_training.main(device="cpu", workdir=str(tmp_path), log_fn=lambda m: None)
    assert out["failures"] == [{"step": 30, "failure": "nonfinite", "action": "restored",
                                "resumed_from": 20}]
    assert out["global_step"] == 60 and out["params_finite"]
    losses = [r["loss"] for r in out["records"] if "loss" in r]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_")) == [
        "step_10", "step_20", "step_30", "step_40", "step_50", "step_60"]
    assert out["heartbeat"]["step"] >= 0


def test_quantized_inference_keeps_the_head_and_generates():
    out = quantized_inference.main("tiny", device="cpu", max_new_tokens=16,
                                   log_fn=lambda m: None)
    model = out["model"]
    cfg = model.cfg
    assert out["n_quantized"] == 7 * cfg.n_layers  # q, k, v, o, gate, up, down
    assert type(model.lm_head).__name__ == "Linear"
    assert out["bytes_after"] < out["bytes_before"]
    assert len(out["tokens"]) == 16 and all(0 <= t < cfg.vocab_size for t in out["tokens"])
    again = quantized_inference.main("tiny", device="cpu", max_new_tokens=16,
                                     log_fn=lambda m: None)
    assert again["tokens"] == out["tokens"]
    # the int8 model's greedy tokens are its own generate's, step by step
    from torchdistx_tpu_torch.generation import generate

    prompt = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 32)))
    assert generate(model, prompt, 16)[0, -16:].tolist() == out["tokens"]


def test_quantized_inference_matches_jax():
    from torchdistx_tpu.generation import generate as jgenerate
    from torchdistx_tpu.nn import QuantizedLinear as JQuantizedLinear
    from torchdistx_tpu.nn import quantize_module as jquantize

    def nbytes(m):
        return sum(p.size * p.dtype.itemsize for _, p in m.named_parameters())

    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny", dtype=jnp.float32)
    tdx.materialize_module(jm)
    init = {k: np.asarray(v) for k, v in jm.named_parameters()}
    before = nbytes(jm)
    jquantize(jm, filter_fn=lambda path, mod: "lm_head" not in path)
    prompt = jnp.asarray(np.random.RandomState(0).randint(0, 256, (1, 32)), jnp.int32)
    tokens = np.asarray(jgenerate(jm, prompt, max_new_tokens=16))[0, -16:].tolist()

    out = quantized_inference.main("tiny", device="cpu", max_new_tokens=16, params=init,
                                   log_fn=lambda m: None)
    assert out["tokens"] == tokens
    assert out["n_quantized"] == sum(isinstance(m, JQuantizedLinear)
                                     for _, m in jm.named_modules())
    assert (out["bytes_before"], out["bytes_after"]) == (before, nbytes(jm))


@pytest.mark.parametrize("module,env", [
    ("elastic_training", {}),
    ("long_context_sp", {"TDX_SP_MODE": "ulysses", "TDX_SEQ": "64"}),
    ("quantized_inference", {"TDX_GEN_MODEL": "tiny"}),
])
def test_examples_run_as_modules(tmp_path, module, env):
    run_env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    run_env.update(env, TDX_PLATFORM="cpu", PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", f"torchdistx_tpu_torch.examples.{module}"],
                         env=run_env, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert {"elastic_training": "done at step 60",
            "long_context_sp": "biased flash-ring attention",
            "quantized_inference": "generated:"}[module] in last
