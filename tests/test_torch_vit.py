"""The port's ViT against the JAX package's, on the CPU: the counterparts
of ``tests/test_vit.py``.

The JAX ``tiny`` ViT gets weights drawn from a seed with numpy (it is
built under ``fake_mode``: the JAX initializers' first compiles take
longer than the test), carried into the port with ``load_jax_params``.
Tolerances (f32): logits and hidden states atol = rtol = 1e-5 (two layers
of the same math, sums in another order; a tanh GELU in place of the
exact one moves these logits well past that).  Training:
``build_vision_train_workload("tiny")`` with the JAX weights loaded takes
3 AnyPrecisionAdamW steps through ``Trainer.fit`` on its batch against the
JAX loop (``value_and_grad``, ``anyprecision_adamw(1e-4)``, f32 variance
on both sides) under ``tests/test_torch_train.py``'s tolerances: losses
1e-5; every parameter within 1e-4 and 99.9% of them within 1e-5, except
the key projections' biases.  Their true gradient is 0 (adding one vector
to every key shifts each query's logits by a constant, which the softmax
ignores), so each side's Adam steps them by the sign of its own f32 noise:
they are held within lr x steps of their start on both sides.  The
published parameter counts under ``fake_mode`` equal JAX's exactly;
``deferred_init`` equals eager construction bit for bit.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import ViT as JViT
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.trainer import Trainer as JTrainer
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.interop import export_params, load_jax_params
from torchdistx_tpu_torch.models import ViT, ViTConfig
from torchdistx_tpu_torch.utils.benchmarks import build_vision_train_workload

F32 = dict(atol=1e-5, rtol=1e-5)
STEPS = 3


def _jax_model(seed=0):
    with tdx.fake_mode():
        jm = JViT.from_name("tiny")
    rs = np.random.RandomState(seed)
    params = {}
    for k, p in jm.named_parameters():
        if k in ("cls_token", "pos_emb"):
            v = 0.02 * rs.randn(*p.shape)
        elif k.split(".")[-2].startswith("ln"):  # LayerNorm: near 1 and 0
            v = (1.0 if k.endswith("weight") else 0.0) + 0.1 * rs.randn(*p.shape)
        else:  # Linear and the patch conv: kaiming-uniform's scale
            fan_in = np.prod(dict(jm.named_parameters())[k.replace("bias", "weight")].shape[1:])
            v = rs.uniform(-1.0, 1.0, p.shape) / np.sqrt(fan_in)
        params[k] = v.astype(np.float32)
        jm._set_by_path(k, jnp.asarray(params[k]))
    return jm, params


def _images(seed=1, b=2, size=32):
    return np.random.RandomState(seed).randn(b, 3, size, size).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jm, params = _jax_model()
    tm = ViT.from_name("tiny", device="cpu")
    load_jax_params(tm, params)
    return jm, params, tm


def test_published_param_counts_match_jax():
    with tdx.fake_mode():
        jb, jl = JViT.from_name("vit_b16"), JViT.from_name("vit_l16")
    with tt.fake_mode():
        tb, tl = ViT.from_name("vit_b16", device="cpu"), ViT.from_name("vit_l16", device="cpu")
    assert sum(p.numel() for p in tb.parameters()) == jb.num_params() == 86_567_656
    assert sum(p.numel() for p in tl.parameters()) == jl.num_params() == 304_326_632
    assert all(tt.is_fake(p) for p in tl.parameters())


def test_deferred_matches_eager_bitwise():
    tt.manual_seed(0)
    m = tt.deferred_init(ViT.from_name, "tiny", device="cpu")
    assert tt.is_deferred(m)
    tt.materialize_module(m)
    tt.manual_seed(0)
    m2 = ViT.from_name("tiny", device="cpu")
    for (k1, p1), (k2, p2) in zip(m.named_parameters(), m2.named_parameters()):
        assert k1 == k2
        assert torch.equal(p1, p2), k1
    # the [CLS] and position tables: N(0, 1) cut at +-2, times 0.02
    assert m.pos_emb.abs().max() <= 0.04 and m.pos_emb.std() > 0.01


def test_names_match_jax(pair):
    jm, _, tm = pair
    assert [k for k, _ in tm.named_parameters()] == [k for k, _ in jm.named_parameters()]


def test_logits_and_hidden_match_jax(pair):
    jm, params, tm = pair
    x = _images()
    p = {k: jnp.asarray(v) for k, v in params.items()}
    jy = functional_call(jm, p, (jnp.asarray(x),))
    jh = functional_call(jm, p, (jnp.asarray(x),), {"return_hidden": True})
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
        th = tm(torch.from_numpy(x), return_hidden=True)
        assert ty.shape == (2, 10) and th.shape == (2, 1 + tm.cfg.n_patches, tm.cfg.dim)
        torch.testing.assert_close(tm.head(th[:, 0]), ty, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)


def test_bad_patch_size_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        ViTConfig(image_size=224, patch_size=15)


def _jax_train(jm, init, batch, lr=1e-4):
    params = {k: jnp.asarray(v) for k, v in init.items()}
    tx = anyprecision_adamw(lr, variance_dtype=jnp.float32)

    def loss_fn(p, b):
        return jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1])

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        u, s = tx.update(g, s, p)
        return jax.tree_util.tree_map(lambda a, d: a + d, p, u), s, loss

    losses = []

    def recording_step(p, s, b):
        p, s, loss = step(p, s, b)
        losses.append(float(loss))
        return p, s, loss

    trainer = JTrainer(recording_step, params, tx.init(params), log_every=1,
                       log_fn=lambda m: None, cost_card=False)
    trainer.fit(itertools.repeat(batch), STEPS)
    return losses, {k: np.asarray(v) for k, v in trainer.params.items()}


def test_three_trainer_steps_match_the_jax_loop(pair):
    jm, params, _ = pair
    w = build_vision_train_workload("tiny", batch=4, device="cpu", seed=2)
    assert w["image_size"] == 32 and w["num_classes"] == 10 and w["tokens_per_batch"] == 4
    load_jax_params(w["model"], params)
    for group in w["optimizer"].param_groups:
        group["variance_dtype"] = torch.float32
    images, labels = w["batch"]
    jlosses, jfinal = _jax_train(jm, params, (jnp.asarray(images.numpy()),
                                              jnp.asarray(labels.numpy().astype(np.int32))))
    tlosses = w["run"](STEPS)
    np.testing.assert_allclose(tlosses, jlosses, **F32)
    assert tlosses[-1] < tlosses[0]
    tfinal = export_params(w["model"])
    shift_invariant = {k for k in jfinal if k.endswith(".k.bias")}
    diffs = np.concatenate([np.abs(tfinal[k] - jfinal[k]).ravel()
                            for k in jfinal if k not in shift_invariant])
    assert diffs.max() <= 1e-4, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.999, np.mean(diffs <= 1e-5)
    for k in shift_invariant:
        for final in (tfinal[k], jfinal[k]):
            assert np.abs(final - params[k]).max() <= 1e-4 * STEPS * (1 + 1e-3), k
