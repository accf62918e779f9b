"""The single-card training workloads: ``build_train_workload``, counterpart
of ``torchdistx_tpu/utils/benchmarks.py:build_train_workload``, and
``build_t5_train_workload``, counterpart of ``scripts/bench_t5_train.py``.

A Llama LM step (flash attention on the card, AnyPrecisionAdamW at lr
1e-4, bf16) built the way the JAX one is: ``deferred_init`` of the model,
``materialize_module`` on the device, one fixed batch of tokens and labels
from ``np.random.RandomState(0)``, the plain ``cross_entropy`` loss, or
with ``fused_ce=True`` the fused LM-head loss on the hidden states
(``ops.fused_ce``, no (B, S, vocab) logits in device memory).  It takes
explicit arguments where the JAX function reads environment variables
(``name`` for ``TDX_BENCH_TRAIN_MODEL``, ``batch``, ``seq``, ``remat``), and
takes model overrides: ``build_train_workload("mistral_7b", batch=1,
seq=8192, n_layers=8)`` trains a windowed model through the window flash
kernels.  ``flops_per_token`` keeps the JAX formula, which counts every
causal pair and so overcounts a windowed model's attention.  The ZeRO-2
plan, the 8-bit optimizer and the numerics taps are not ported yet and
raise.

The T5 workload is the JAX script's step: ``deferred_init`` of
``T5.from_name(name, use_flash=True)``, ``materialize_module``,
AnyPrecisionAdamW at lr 1e-4, one fixed (src, tgt) batch from
``np.random.RandomState(seed)``, loss ``cross_entropy(model(src, tgt),
tgt)``, model FLOPs 6N per token (tokens = batch x seq), bf16 on the
card and f32 on the CPU (the script's choice), ``flash_bucket_bias``
choosing the bias mode.
"""

from __future__ import annotations

import itertools
import time
from typing import Any

import numpy as np
import torch

__all__ = ["build_train_workload", "build_t5_train_workload"]


def build_train_workload(
    name: str = "llama_1b",
    *,
    batch: int = 2,
    seq: int = 2048,
    remat: bool = False,
    remat_policy: str = "full",
    device="cuda",
    seed: int = 0,
    optimizer: str = "anyprecision",
    fused_ce: bool = False,
    zero2: bool = False,
    numerics: bool = False,
    **model_overrides: Any,
) -> dict:
    """Returns ``{"run", "trainer", "step", "model", "optimizer", "batch",
    "name", "n_params", "batch_size", "seq", "tokens_per_batch",
    "flops_per_token", "remat", "fused_ce", "deferred_init_s",
    "materialize_s"}``; ``run(n_steps)`` takes ``n_steps`` more steps
    through ``Trainer.fit`` and returns their losses as floats."""
    if optimizer != "anyprecision":
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported yet")
    for flag, what in ((zero2, "the ZeRO-2 plan"), (numerics, "numerics taps")):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")
    if remat_policy != "full" and not remat:
        raise ValueError("remat_policy has no effect without remat=True")

    from ..models.llama import Llama
    from ..nn import functional as F
    from ..ops.fused_ce import fused_linear_cross_entropy

    device = torch.device(device)
    model, init_s = _deferred_model(Llama.from_name, name, device, seed,
                                    max_seq_len=seq, remat=remat,
                                    remat_policy=remat_policy, **model_overrides)
    n_params = sum(p.numel() for p in model.parameters())
    cfg = model.cfg
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq))).to(device)
    labels = torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq))).to(device)

    if fused_ce:
        def loss_fn(m, b):
            toks, labs = b
            h = m(toks, return_hidden=True)
            return fused_linear_cross_entropy(h, m.lm_head.weight, labs)
    else:
        def loss_fn(m, b):
            toks, labs = b
            return F.cross_entropy(m(toks), labs)

    # model FLOPs per token: 6N for the forward and backward matmuls plus
    # the attention term 12 * L * dim * seq (PaLM appendix convention)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq
    return _workload(model, loss_fn, (tokens, labels), name, batch, seq, n_params,
                     flops_per_token, init_s, remat=remat, fused_ce=fused_ce)


def build_t5_train_workload(
    name: str = "t5_3b",
    *,
    batch: int = 4,
    seq: int = 512,
    flash_bucket_bias: bool = False,
    device="cuda",
    seed: int = 0,
    **model_overrides: Any,
) -> dict:
    """``scripts/bench_t5_train.py``'s step on one card (encoder and
    decoder both ``seq`` long).  Returns what ``build_train_workload``
    returns; ``batch`` is the (src, tgt) pair."""
    from ..models.t5 import T5
    from ..nn import functional as F

    device = torch.device(device)
    model_overrides.setdefault("use_flash", True)
    # the JAX script's choice: bf16 on the accelerator, f32 on the CPU
    model_overrides.setdefault(
        "dtype", torch.bfloat16 if device.type == "cuda" else torch.float32)
    model, init_s = _deferred_model(T5.from_name, name, device, seed,
                                    flash_bucket_bias=flash_bucket_bias,
                                    **model_overrides)
    n_params = sum(p.numel() for p in model.parameters())
    vocab = model.cfg.vocab_size
    rs = np.random.RandomState(seed)
    src = torch.from_numpy(rs.randint(0, vocab, (batch, seq))).to(device)
    tgt = torch.from_numpy(rs.randint(0, vocab, (batch, seq))).to(device)

    def loss_fn(m, b):
        s, t = b
        return F.cross_entropy(m(s, t), t)

    return _workload(model, loss_fn, (src, tgt), name, batch, seq, n_params,
                     6 * n_params, init_s, remat=False, fused_ce=False)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _deferred_model(ctor, name, device, seed, **kwargs):
    """``deferred_init`` then ``materialize_module`` on ``device``, and the
    host seconds of each (the card synchronized)."""
    from ..deferred_init import deferred_init, materialize_module
    from .rng import manual_seed

    manual_seed(seed)
    t0 = time.perf_counter()
    model = deferred_init(ctor, name, device=device, **kwargs)
    t1 = time.perf_counter()
    materialize_module(model)
    _sync(device)
    return model, {"deferred_init_s": t1 - t0, "materialize_s": time.perf_counter() - t1}


def _workload(model, loss_fn, batch_data, name, batch, seq, n_params,
              flops_per_token, init_s, **flags):
    from ..optimizers import AnyPrecisionAdamW
    from ..trainer import Trainer, TrainStep

    opt = AnyPrecisionAdamW(model.parameters(), lr=1e-4)
    step = TrainStep(model, opt, loss_fn)
    trainer = Trainer(step, tokens_per_batch=batch * seq, log_every=1,
                      log_fn=lambda m: None, flops_per_token=flops_per_token)

    def run(n_steps: int) -> list:
        start = len(step.losses)
        trainer.fit(itertools.repeat(batch_data), trainer.global_step + n_steps)
        return [float(x) for x in step.losses[start:]]

    return {
        "run": run, "trainer": trainer, "step": step, "model": model,
        "optimizer": opt, "batch": batch_data, "name": name,
        "n_params": int(n_params), "batch_size": batch, "seq": seq,
        "tokens_per_batch": batch * seq, "flops_per_token": flops_per_token,
        **flags, **init_s,
    }
