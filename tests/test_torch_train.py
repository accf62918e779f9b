"""The training slice end to end against the JAX package, on the CPU.

Both sides build ``tiny`` Llama with ``use_flash=True`` through
``deferred_init`` -> ``materialize_module``; the JAX weights cross into the
port with ``load_jax_params``.  Then each side's ``Trainer.fit`` takes 3
AnyPrecisionAdamW steps (lr 1e-3, f32 variance to keep the test off bf16
tie flips) on the same numpy batch: JAX through the Pallas flash forward
and FA2 backward in interpret mode, the port through its
``autograd.Function`` with the plain forward-with-lse and backward.

Tolerances (f32): losses atol = rtol = 1e-5 (two layers of the same math,
sums in another order).  Parameters: Adam divides by sqrt(v), which
amplifies f32 noise in elements whose gradient is tiny (each step can move
such an element by up to lr either way), so every element must agree within
1e-4 (a tenth of one step) and 99.9% of them within 1e-5.

The fused LM-head loss is held the same way: tiny Llama through
``build_train_workload(fused_ce=True)`` against the JAX step under
``fused_linear_cross_entropy`` (Pallas, interpret mode), and tiny GPT-2
through the GPT-2 example recipe on both sides (``deferred_init`` ->
``with_param_groups(AnyPrecisionAdamW, decay / no_decay, Kahan)`` ->
``DataLoader(TokenDataset)`` -> ``Trainer.fit``) with the fused loss on
the tied ``tok_emb.weight``; same tolerances.

T5 is held the same way: ``build_t5_train_workload("tiny")`` with the JAX
weights loaded, in both bias modes (the materialized bias and the bucket
table), 3 steps against the JAX loop of ``scripts/bench_t5_train.py``
(``value_and_grad``, ``anyprecision_adamw(1e-4)``, ``apply_updates``)
under ``Trainer.fit``, JAX through its flash kernels in interpret mode;
same tolerances.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
import torchdistx_tpu_torch as tt
from torchdistx_tpu.data import DataLoader as JLoader
from torchdistx_tpu.data import TokenDataset as JDataset
from torchdistx_tpu.models import GPT2 as JGPT2
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.models import T5 as JT5
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.ops.fused_ce import fused_linear_cross_entropy as jfused
from torchdistx_tpu.optimizers import anyprecision_adamw, decay_labels
from torchdistx_tpu.optimizers import with_param_groups as jwith_param_groups
from torchdistx_tpu.trainer import Trainer as JTrainer
from torchdistx_tpu_torch.examples.train_gpt2 import main as train_gpt2_main
from torchdistx_tpu_torch.interop import export_params, load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.nn import functional as tF
from torchdistx_tpu_torch.utils.benchmarks import build_t5_train_workload, build_train_workload

LR = 1e-3
STEPS = 3


def _batch(seed=0, b=2, s=32):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (b, s)).astype(np.int32),
            rs.randint(0, 256, (b, s)).astype(np.int32))


def _jax_run(batch, fused=False, lr=LR):
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny", use_flash=True)
    tdx.materialize_module(jm)
    params = dict(jm.named_parameters())
    init = {k: np.asarray(v) for k, v in params.items()}
    tx = anyprecision_adamw(lr, variance_dtype=jnp.float32)

    def loss_fn(p, toks, labs):
        if fused:
            h = functional_call(jm, p, (toks,), {"return_hidden": True})
            return jfused(h, p["lm_head.weight"], labs)
        return jF.cross_entropy(functional_call(jm, p, (toks,)), labs)

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(loss_fn)(p, *b)
        u, s = tx.update(g, s, p)
        return jax.tree_util.tree_map(lambda a, d: a + d, p, u), s, loss

    losses = []

    def recording_step(p, s, b):
        p, s, loss = step(p, s, b)
        losses.append(loss)
        return p, s, loss

    jb = tuple(jnp.asarray(x) for x in batch)
    trainer = JTrainer(recording_step, params, tx.init(params), log_every=1,
                       log_fn=lambda m: None, cost_card=False)
    trainer.fit(itertools.repeat(jb), STEPS)
    final = {k: np.asarray(v) for k, v in trainer.params.items()}
    return init, [float(x) for x in losses], final


def _port_model(init, remat=False):
    tt.manual_seed(0)
    tm = tt.deferred_init(TLlama.from_name, "tiny", device="cpu",
                          use_flash=True, remat=remat)
    tt.materialize_module(tm)
    return load_jax_params(tm, init)


def _loss(m, b):
    return tF.cross_entropy(m(b[0]), b[1])


@pytest.fixture(scope="module")
def runs():
    batch = _batch()
    init, jlosses, jfinal = _jax_run(batch)
    tm = _port_model(init)
    opt = tt.AnyPrecisionAdamW(tm.parameters(), lr=LR, variance_dtype=torch.float32)
    step = tt.TrainStep(tm, opt, _loss)
    tb = tuple(torch.from_numpy(x).long() for x in batch)
    trainer = tt.Trainer(step, log_every=1, log_fn=lambda m: None)
    out = trainer.fit(itertools.repeat(tb), STEPS)
    return dict(jlosses=jlosses, jfinal=jfinal, tlosses=[float(x) for x in step.losses],
                tfinal=export_params(tm), trainer=trainer, out=out)


def _assert_losses_match(tlosses, jlosses, falls=True):
    assert len(tlosses) == len(jlosses) == STEPS
    np.testing.assert_allclose(tlosses, jlosses, atol=1e-5, rtol=1e-5)
    if falls:  # one batch, repeated
        assert tlosses[-1] < tlosses[0]


def _assert_params_match(tf, jf):
    assert set(jf) == set(tf)
    diffs = np.concatenate([np.abs(tf[k] - jf[k]).ravel() for k in jf])
    assert diffs.max() <= 1e-4, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.999, np.mean(diffs <= 1e-5)


def test_losses_match_jax(runs):
    _assert_losses_match(runs["tlosses"], runs["jlosses"])


def test_final_params_match_jax(runs):
    _assert_params_match(runs["tfinal"], runs["jfinal"])


def test_fused_ce_workload_matches_the_jax_fused_step():
    """``build_train_workload("tiny", fused_ce=True)`` with the JAX weights
    loaded, 3 steps on its own batch, against the JAX step under the fused
    loss (lr 1e-4 as the workload; f32 variance on both sides)."""
    w = build_train_workload("tiny", batch=2, seq=32, device="cpu", use_flash=True,
                             fused_ce=True)
    assert w["fused_ce"]
    batch = tuple(t.numpy().astype(np.int32) for t in w["batch"])
    init, jlosses, jfinal = _jax_run(batch, fused=True, lr=1e-4)
    load_jax_params(w["model"], init)
    for group in w["optimizer"].param_groups:
        group["variance_dtype"] = torch.float32
    tlosses = w["run"](STEPS)
    _assert_losses_match(tlosses, jlosses)
    _assert_params_match(export_params(w["model"]), jfinal)


def _jax_gpt2_recipe(stream, batch, seq):
    """``examples/train_gpt2.py`` without the mesh: the same recipe as the
    port's example, with the fused loss on the tied head."""
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JGPT2.from_name, "tiny")
    tdx.materialize_module(jm)
    params = dict(jm.named_parameters())
    init = {k: np.asarray(v) for k, v in params.items()}
    tx = jwith_param_groups(
        anyprecision_adamw,
        groups={"decay": {"weight_decay": 0.01}, "no_decay": {"weight_decay": 0.0}},
        labels=decay_labels, learning_rate=3e-4, use_kahan_summation=True)

    def loss_fn(p, b):
        h = functional_call(jm, p, (b[0],), {"return_hidden": True})
        return jfused(h, p["tok_emb.weight"], b[1])

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

    loader = JLoader(JDataset(stream, seq_len=seq), batch, shuffle=True, seed=0, prefetch=0)
    trainer = JTrainer(recording_step, params, tx.init(params), log_every=1,
                       log_fn=lambda m: None, cost_card=False)
    trainer.fit(iter(loader), STEPS)
    return init, losses, {k: np.asarray(v) for k, v in trainer.params.items()}


def test_gpt2_example_recipe_matches_jax():
    """3 steps of tiny GPT-2 through ``examples.train_gpt2.main(...,
    fused_ce=True)`` from the JAX weights, against the JAX recipe."""
    stream = np.random.RandomState(0).randint(0, 256, 50_000)
    init, jlosses, jfinal = _jax_gpt2_recipe(stream, 8, 64)
    out = train_gpt2_main("tiny", batch=8, seq=64, steps=STEPS, fused_ce=True,
                          device="cpu", stream=stream, params=init,
                          log_fn=lambda m: None)
    # a new random batch every step: the loss need not fall in 3 steps
    _assert_losses_match(out["losses"], jlosses, falls=False)
    _assert_params_match(export_params(out["model"]), jfinal)
    m = out["metrics"]
    assert m["steps_total"] == STEPS and m["tokens_total"] == STEPS * 512


def test_trainer_metrics(runs):
    m = runs["trainer"].metrics
    assert m["steps_total"] == STEPS and runs["out"]["step"] == STEPS
    assert m["loss"] == pytest.approx(runs["tlosses"][-1])
    assert m["steps_per_sec"] > 0


def test_remat_gives_the_same_gradients():
    """``remat=True`` recomputes each block through torch.utils.checkpoint
    in the backward; the gradients are those of the plain forward
    (f32, 1e-6: the same ops replayed)."""
    batch = tuple(torch.from_numpy(x).long() for x in _batch(1))
    grads = []
    for remat in (False, True):
        tt.manual_seed(5)
        m = TLlama.from_name("tiny", device="cpu", use_flash=True, remat=remat)
        _loss(m, batch).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-6, rtol=1e-6)


def test_return_hidden_and_unported_options():
    tt.manual_seed(0)
    m = TLlama.from_name("tiny", device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    with torch.no_grad():
        h = m(toks, return_hidden=True)
        assert h.shape == (1, 4, 64)
        torch.testing.assert_close(m.lm_head(h), m(toks))
    dots = TLlama.from_name("tiny", device="cpu", remat=True, remat_policy="dots")
    with pytest.raises(NotImplementedError, match="dots"):
        dots(toks)
    for kw in (dict(checkpoint_dir="x"), dict(stall_timeout_s=1.0), dict(cost_card=True)):
        with pytest.raises(NotImplementedError):
            tt.Trainer(lambda p, s, b: (p, s, 0.0), **kw)
    with pytest.raises(NotImplementedError, match="ZeRO-2"):
        build_train_workload("tiny", device="cpu", zero2=True)


def test_build_train_workload_on_the_cpu():
    w = build_train_workload("tiny", batch=2, seq=16, device="cpu", use_flash=True)
    losses = w["run"](2)
    assert len(losses) == 2 and all(np.isfinite(losses))
    n, cfg = w["n_params"], w["model"].cfg
    assert w["flops_per_token"] == 6 * n + 12 * cfg.n_layers * cfg.dim * w["seq"]
    assert w["trainer"].metrics["tokens_total"] == 2 * w["tokens_per_batch"]


def _jax_t5_run(src, tgt, flash_bucket_bias):
    """``scripts/bench_t5_train.py``'s step (f32 variance, as the port's
    side below) under the JAX ``Trainer.fit``."""
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JT5.from_name, "tiny", use_flash=True,
                           flash_bucket_bias=flash_bucket_bias)
    tdx.materialize_module(jm)
    params = dict(jm.named_parameters())
    init = {k: np.asarray(v) for k, v in params.items()}
    tx = anyprecision_adamw(1e-4, variance_dtype=jnp.float32)

    def loss_fn(p, b):
        return jF.cross_entropy(functional_call(jm, p, b), b[1])

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

    jb = (jnp.asarray(src), jnp.asarray(tgt))
    trainer = JTrainer(recording_step, params, tx.init(params), log_every=1,
                       log_fn=lambda m: None, cost_card=False)
    trainer.fit(itertools.repeat(jb), STEPS)
    return init, losses, {k: np.asarray(v) for k, v in trainer.params.items()}


@pytest.mark.parametrize("flash_bucket_bias", [False, True], ids=["bias", "bucket"])
def test_t5_workload_matches_the_jax_t5_step(flash_bucket_bias):
    w = build_t5_train_workload("tiny", batch=2, seq=16, device="cpu",
                                flash_bucket_bias=flash_bucket_bias)
    assert w["flops_per_token"] == 6 * w["n_params"] and w["tokens_per_batch"] == 32
    src, tgt = (t.numpy().astype(np.int32) for t in w["batch"])
    init, jlosses, jfinal = _jax_t5_run(src, tgt, flash_bucket_bias)
    load_jax_params(w["model"], init)
    for group in w["optimizer"].param_groups:
        group["variance_dtype"] = torch.float32
    tlosses = w["run"](STEPS)
    _assert_losses_match(tlosses, jlosses)
    _assert_params_match(export_params(w["model"]), jfinal)
