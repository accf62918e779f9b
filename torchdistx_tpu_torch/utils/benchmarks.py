"""The single-card training workload, counterpart of
``torchdistx_tpu/utils/benchmarks.py:build_train_workload``.

A Llama LM step (flash attention on the card, AnyPrecisionAdamW at lr
1e-4, bf16) built the way the JAX one is: ``deferred_init`` of the model,
``materialize_module`` on the device, one fixed batch of tokens and labels
from ``np.random.RandomState(0)``, the plain ``cross_entropy`` loss, or
with ``fused_ce=True`` the fused LM-head loss on the hidden states
(``ops.fused_ce``, no (B, S, vocab) logits in device memory).  It takes
explicit arguments where the JAX function reads environment variables.
The ZeRO-2 plan, the 8-bit optimizer and the numerics taps are not ported
yet and raise.
"""

from __future__ import annotations

import itertools
from typing import Any

import numpy as np
import torch

__all__ = ["build_train_workload"]


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
    "flops_per_token", "remat", "fused_ce"}``; ``run(n_steps)`` takes ``n_steps``
    more steps through ``Trainer.fit`` and returns their losses as
    floats."""
    if optimizer != "anyprecision":
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported yet")
    for flag, what in ((zero2, "the ZeRO-2 plan"), (numerics, "numerics taps")):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet")
    if remat_policy != "full" and not remat:
        raise ValueError("remat_policy has no effect without remat=True")

    from ..deferred_init import deferred_init, materialize_module
    from ..models.llama import Llama
    from ..nn import functional as F
    from ..ops.fused_ce import fused_linear_cross_entropy
    from ..optimizers import AnyPrecisionAdamW
    from ..trainer import Trainer, TrainStep
    from .rng import manual_seed

    device = torch.device(device)
    manual_seed(seed)
    model = deferred_init(Llama.from_name, name, device=device,
                          max_seq_len=seq, remat=remat,
                          remat_policy=remat_policy, **model_overrides)
    materialize_module(model)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AnyPrecisionAdamW(model.parameters(), lr=1e-4)

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

    step = TrainStep(model, opt, loss_fn)
    # model FLOPs per token: 6N for the forward and backward matmuls plus
    # the attention term 12 * L * dim * seq (PaLM appendix convention)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq
    trainer = Trainer(step, tokens_per_batch=batch * seq, log_every=1,
                      log_fn=lambda m: None, flops_per_token=flops_per_token)

    def run(n_steps: int) -> list:
        start = len(step.losses)
        trainer.fit(itertools.repeat((tokens, labels)),
                    trainer.global_step + n_steps)
        return [float(x) for x in step.losses[start:]]

    return {
        "run": run, "trainer": trainer, "step": step, "model": model,
        "optimizer": opt, "batch": (tokens, labels), "name": name,
        "n_params": int(n_params), "batch_size": batch, "seq": seq,
        "tokens_per_batch": batch * seq, "flops_per_token": flops_per_token,
        "remat": remat, "fused_ce": fused_ce,
    }
