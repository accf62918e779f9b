"""GPT-2 and T5 with ``sp_axis`` in the port against the JAX package's models
run unsharded, as ``tests/test_models.py`` holds the JAX SP runs
(``TestT5SequenceParallel``, ``test_gpt2_sp_matches_unsharded``), at world
size 4 on ``gloo`` (one spawned world, the ``sp_models`` suite of
``tests/_torch_dist_worker.py``).

Tiny models with the JAX weights: GPT-2 (2, 64) tokens, ring (plain and
flash, whose kernels run their plain versions on the CPU) and Ulysses; T5
(2, 64) sources and (2, 32) targets, the ring with the per-rank bias rows
and the cross-attention ring over the encoder's key shards, plain and
flash.  On ``{"dp": 2, "sp": 2}`` (two 2-way rings, a batch row each) and
``{"sp": 4}``.  Each rank's logits (its rows and sequence shard) within
``test_models.py``'s 2e-4 (rtol and atol) of the JAX forward; the
cross-entropy gradients (the mean over the ranks of each rank's shard
loss) within rtol 2e-4 / atol 1e-5 of ``jax.grad`` of the unsharded loss.
A global sequence past ``n_positions`` and ``flash_bucket_bias`` with
``sp_axis`` raise, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import SP_GPT2_CASES, SP_MESHES, SP_T5_CASES, spawn_world, sp_batch
from torchdistx_tpu.models import GPT2 as JGPT2
from torchdistx_tpu.models import T5 as JT5
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu_torch.models import T5

SEEDS = {"gpt2": 13, "t5": 11}


def _jax(kind):
    tdx.manual_seed(SEEDS[kind])
    m = tdx.deferred_init((JGPT2 if kind == "gpt2" else JT5).from_name, "tiny",
                          use_flash=False)
    tdx.materialize_module(m)
    return m, {k: np.asarray(v) for k, v in m.named_parameters()}


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for kind in ("gpt2", "t5"):
        m, params = _jax(kind)
        a, b = (jnp.asarray(x.astype(np.int32)) for x in sp_batch(kind))

        def loss(p, m=m, a=a, b=b, kind=kind):
            logits = functional_call(m, p, (a,) if kind == "gpt2" else (a, b))
            return jF.cross_entropy(logits, b), logits

        (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()})
        out[kind] = {"init": params, "logits": np.asarray(logits),
                     "grads": {k: np.asarray(v) for k, v in grads.items()}}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_side):
    payload = {k: v["init"] for k, v in jax_side.items()}
    return spawn_world("sp_models", tmp_path_factory.mktemp("sp_models"), payload,
                       timeout=150.0)


def _got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


CASES = ([("gpt2", c, m) for m in SP_MESHES for c in SP_GPT2_CASES]
         + [("t5", c, m) for m in SP_MESHES for c in SP_T5_CASES])


@pytest.mark.parametrize("kind,case,mesh", CASES)
def test_sp_forward_and_gradients_match_jax_unsharded(world, jax_side, kind, case, mesh):
    want = jax_side[kind]
    for r in _got(world, f"{kind}-{case}-{mesh}"):
        n, i = r["sp_size"], r["sp_index"]
        rows = slice(*r["rows"])
        ref = np.split(want["logits"][rows], n, axis=1)[i]
        np.testing.assert_allclose(r["logits"], ref, rtol=2e-4, atol=2e-4)
        for name, g in want["grads"].items():
            np.testing.assert_allclose(r["grads"][name], g, rtol=2e-4, atol=1e-5,
                                       err_msg=name)


def test_sp_sequence_past_n_positions_raises(world):
    for r in _got(world, "err_n_positions"):
        assert r["message"] is not None and "n_positions" in r["message"]


def test_bucket_bias_with_sp_raises_as_in_jax():
    with pytest.raises(ValueError, match="flash_bucket_bias"):
        JT5.from_name("tiny", sp_axis="sp", flash_bucket_bias=True)
    with pytest.raises(ValueError, match="flash_bucket_bias"):
        T5.from_name("tiny", device="cpu", sp_axis="sp", flash_bucket_bias=True)
