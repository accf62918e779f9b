"""The port's ResNet against the JAX package's, on the CPU.

The JAX package's ``resnet18(num_classes=10)`` gets weights drawn from a
seed as its initializers draw them and random running statistics (so eval
mode normalizes with something other than 0 and 1), carried into the port
with ``load_jax_params`` / ``load_jax_buffers``.  Both run the same numpy
images.

Tolerances (f32): logits atol = rtol = 1e-4 (18 layers of convolutions,
XLA's and oneDNN's, summing in other orders), in eval mode at (2, 3, 32,
32) and in training mode at (4, 3, 64, 64).  Training mode at (2, 3, 32,
32) is held at 1e-3, and each package's f32 logits within 1e-3 of the
port's forward in f64: layer4's maps are 1 x 1 there, so its BatchNorm
normalizes 2 values a channel and amplifies f32 noise; at 4 x 64 x 64 it
sees 16 a channel.  The gradients of
``cross_entropy`` at (4, 3, 64, 64), each within 1e-4 of its tensor's
largest magnitude plus 1e-4 relative.  Training:
``build_vision_train_workload("resnet18")`` at 4 images of 64 x 64 with
the JAX weights loaded takes 3 AnyPrecisionAdamW steps through
``Trainer.fit`` on its batch against the JAX loop (``value_and_grad``,
``anyprecision_adamw(1e-4)``, f32 variance on both sides): losses within
1e-5 and 99.99% of the parameters within 1e-5, a tenth of one step
(``tests/test_torch_train.py`` asks 99.9%).  Adam divides by sqrt(v), so
an element whose gradient is at the f32 noise floor can move by up to lr
either way each step, and of resnet18's 11.2 million elements a handful
move past 1e-4, so the bound on every element is that reach, 2 x lr x
steps, where
``tests/test_torch_train.py``'s tiny Llama holds 1e-4.  ResNet-50 under
``fake_mode`` has exactly the JAX model's parameter count (torchvision's
25,557,032) and allocates nothing; ``deferred_init`` equals eager
construction bit for bit.
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import resnet18 as jresnet18
from torchdistx_tpu.models import resnet50 as jresnet50
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.trainer import Trainer as JTrainer
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.interop import export_params, load_jax_buffers, load_jax_params
from torchdistx_tpu_torch.models import ResNet, resnet18, resnet50
from torchdistx_tpu_torch.nn import functional as tF
from torchdistx_tpu_torch.utils.benchmarks import build_vision_train_workload

STEPS = 3
LR = 1e-4  # the vision workload's


def _jax_model(seed=0):
    """JAX's resnet18 with the JAX initializers' distributions drawn by
    numpy (it is built under ``fake_mode``: the initializers' first
    compiles take longer than the whole test), and random running
    statistics."""
    with tdx.fake_mode():
        jm = jresnet18(num_classes=10)
    rs = np.random.RandomState(seed)
    params, buffers = {}, {}
    for k, p in jm.named_parameters():
        if k.startswith("fc.") or p.ndim > 1:  # kaiming-uniform, the fc bias's bound
            fan_in = jm.fc.weight.shape[1] if k == "fc.bias" else np.prod(p.shape[1:])
            v = rs.uniform(-1.0, 1.0, p.shape) / np.sqrt(fan_in)
        else:  # BatchNorm: ones and zeros
            v = np.full(p.shape, 1.0 if k.endswith("weight") else 0.0)
        params[k] = v.astype(np.float32)
    for k, b in jm.named_buffers():
        v = 0.1 * rs.randn(*b.shape) if k.endswith("mean") else rs.uniform(0.5, 1.5, b.shape)
        buffers[k] = v.astype(np.float32)
    for k, v in {**params, **buffers}.items():
        jm._set_by_path(k, jnp.asarray(v))
    return jm, params, buffers


def _port_model(params, buffers):
    tm = resnet18(num_classes=10, device="cpu")
    load_jax_params(tm, params)
    return load_jax_buffers(tm, buffers)


def _images(seed=2, b=2, size=32):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, 3, size, size).astype(np.float32),
            rs.randint(0, 10, b).astype(np.int32))


@pytest.fixture(scope="module")
def pair():
    jm, params, buffers = _jax_model()
    return jm, params, buffers, _port_model(params, buffers)


def test_parameter_and_buffer_names_equal_jax(pair):
    jm, params, buffers, tm = pair
    assert [k for k, _ in tm.named_parameters()] == [k for k, _ in jm.named_parameters()]
    assert [k for k, _ in tm.named_buffers()] == [k for k, _ in jm.named_buffers()]
    assert "layer2.0.down.0.weight" in params and "layer2.0.down.1.running_var" in buffers


@pytest.mark.parametrize("training,b,size,tol", [(False, 2, 32, 1e-4), (True, 4, 64, 1e-4),
                                                (True, 2, 32, 1e-3)])
def test_logits_match_jax(pair, training, b, size, tol):
    jm, _, _, tm = pair
    x, _ = _images(2, b, size)
    jm.train(training)
    tm.train(training)
    params = {k: v for k, v in jm.named_parameters()}
    jy = jax.jit(lambda p, x: functional_call(jm, p, (x,)))(params, jnp.asarray(x))
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
    assert ty.shape == (b, 10)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tol, rtol=tol)
    if tol > 1e-4:  # the ill-conditioned case: both within tol of f64
        with torch.no_grad():
            exact = copy.deepcopy(tm).double()(torch.from_numpy(x).double()).numpy()
        for got in (ty.numpy(), np.asarray(jy)):
            np.testing.assert_allclose(got, exact, atol=tol, rtol=0)


def test_gradients_match_jax_grad(pair):
    jm, params, _, tm = pair
    x, y = _images(3, 4, 64)
    jm.train()
    tm.train()
    tm.zero_grad()

    def loss_fn(p):
        return jF.cross_entropy(functional_call(jm, p, (jnp.asarray(x),)), jnp.asarray(y))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tloss = tF.cross_entropy(tm(torch.from_numpy(x)), torch.from_numpy(y).long())
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    for k, p in tm.named_parameters():
        g = np.asarray(jgrads[k])
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)


def _jax_train(jm, init, batch, lr=LR):
    jm.train()
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
    w = build_vision_train_workload("resnet18", batch=4, image_size=64, num_classes=10,
                                    device="cpu", seed=4)
    assert w["tokens_per_batch"] == 4 and w["model"].training
    assert all(g["lr"] == LR for g in w["optimizer"].param_groups)
    jm, params, buffers, _ = pair
    load_jax_params(w["model"], params)
    load_jax_buffers(w["model"], buffers)
    for group in w["optimizer"].param_groups:
        group["variance_dtype"] = torch.float32
    images, labels = w["batch"]
    jlosses, jfinal = _jax_train(jm, params, (jnp.asarray(images.numpy()),
                                          jnp.asarray(labels.numpy().astype(np.int32))))
    tlosses = w["run"](STEPS)
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    tfinal = export_params(w["model"])
    diffs = np.concatenate([np.abs(tfinal[k] - jfinal[k]).ravel() for k in jfinal])
    assert diffs.max() <= 2 * LR * STEPS, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.9999, np.mean(diffs <= 1e-5)
    # training mode never writes the running statistics
    for k, b in w["model"].named_buffers():
        np.testing.assert_array_equal(b.numpy(), buffers[k], err_msg=k)


def test_resnet50_parameter_count_matches_jax_under_fake_mode():
    with tdx.fake_mode():
        jm = jresnet50()
    with tt.fake_mode():
        tm = resnet50(device="cpu")
    assert sum(p.numel() for p in tm.parameters()) == jm.num_params() == 25_557_032
    assert all(tt.is_fake(t) for t in (*tm.parameters(), *tm.buffers()))
    assert isinstance(tm, ResNet) and len(list(tm.buffers())) == 106


def test_deferred_init_is_bit_identical_to_eager():
    tt.manual_seed(7)
    deferred = tt.deferred_init(resnet18, num_classes=10, device="cpu")
    assert tt.is_deferred(deferred)
    tt.materialize_module(deferred)
    assert not tt.is_deferred(deferred)
    tt.manual_seed(7)
    eager = resnet18(num_classes=10, device="cpu")
    for (k1, a), (k2, b) in zip(deferred.state_dict().items(), eager.state_dict().items()):
        assert k1 == k2
        assert torch.equal(a, b), k1
