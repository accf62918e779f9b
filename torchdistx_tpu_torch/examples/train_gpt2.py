"""Train GPT-2 on a synthetic token stream: the port's counterpart of
``examples/train_gpt2.py``, step for step on one card.

``deferred_init(GPT2.from_name, name)`` -> ``materialize_module`` on the
device -> ``with_param_groups(AnyPrecisionAdamW, decay / no_decay,
decay_labels, lr=3e-4, use_kahan_summation=True)`` ->
``DataLoader(TokenDataset(stream, seq), batch, shuffle=True, seed=0)`` ->
``Trainer(TrainStep(...)).fit``.  The JAX example shards the model over an
FSDP mesh of all local devices; the port's parallel stack is a later slice,
so this one trains unsharded on one card.  ``fused_ce=True`` swaps the loss
for ``fused_linear_cross_entropy`` of the hidden states on the tied
``tok_emb.weight``, the JAX GPT-2's documented use: no (B, S, vocab)
logits in device memory.  The loader is walked epoch after epoch until
``steps`` batches have been taken.

On the card (bf16, flash attention and the fused loss through the
kernels)::

    from torchdistx_tpu_torch.examples.train_gpt2 import main
    out = main("gpt2_large", batch=8, seq=1024, steps=20, fused_ce=True,
               dtype=torch.bfloat16)
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["main"]


def _epochs(loader):
    if len(loader) == 0:
        raise ValueError("the token stream is shorter than one batch")
    while True:
        yield from loader


def main(name: str = "tiny", *, batch: int = 8, seq: int = 64, steps: int = 100,
         fused_ce: bool = False, device="cuda", dtype: Optional[torch.dtype] = None,
         stream: Optional[np.ndarray] = None,
         params: Optional[Mapping[str, np.ndarray]] = None, log_every: int = 20,
         log_fn=None) -> dict:
    """Train ``steps`` steps and return ``{"metrics", "losses", "model",
    "n_params", "tokens_per_batch", "flops_per_token"}``.

    ``dtype`` overrides the configuration's (f32); ``stream`` is the 1-d
    token stream (default: 500,000 tokens of ``RandomState(0)`` below the
    vocab size); ``params`` are start weights by name (numpy arrays, e.g.
    exported from the JAX package) loaded over the seeded init; ``log_fn``
    receives the trainer's log record every ``log_every`` steps."""
    from .. import deferred_init, manual_seed, materialize_module
    from ..data import DataLoader, TokenDataset
    from ..interop import load_jax_params
    from ..models import GPT2
    from ..nn import functional as F
    from ..ops.fused_ce import fused_linear_cross_entropy
    from ..optimizers import AnyPrecisionAdamW, decay_labels, with_param_groups
    from ..trainer import Trainer, TrainStep

    device = torch.device(device)
    # 1. construct with zero storage, materialize on the device
    manual_seed(0)
    model = deferred_init(GPT2.from_name, name, device=device, dtype=dtype)
    materialize_module(model)
    if params is not None:
        load_jax_params(model, params)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())

    if fused_ce:
        def loss_fn(m, b):
            tokens, labels = b
            h = m(tokens, return_hidden=True)
            return fused_linear_cross_entropy(h, m.tok_emb.weight, labels)
    else:
        def loss_fn(m, b):
            tokens, labels = b
            return F.cross_entropy(m(tokens), labels)

    # the standard two-group recipe: decay_labels routes biases and norm
    # scales to no_decay, everything else decays
    optimizer = with_param_groups(
        AnyPrecisionAdamW,
        {"decay": {"weight_decay": 0.01}, "no_decay": {"weight_decay": 0.0}},
        decay_labels,
        model,
        lr=3e-4,
        use_kahan_summation=True,
    )

    # 2. synthetic data, prefetched to the device
    if stream is None:
        stream = np.random.RandomState(0).randint(0, cfg.vocab_size, 500_000)
    loader = DataLoader(TokenDataset(stream, seq_len=seq), batch, shuffle=True,
                        seed=0, device=device)

    # 3. train; model FLOPs per token: 6N for the forward and backward
    # matmuls plus the attention term 12 * L * dim * seq
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq
    step = TrainStep(model, optimizer, loss_fn)
    trainer = Trainer(step, tokens_per_batch=batch * seq,
                      log_every=max(1, min(log_every, steps)), log_fn=log_fn,
                      flops_per_token=flops_per_token)
    trainer.fit(_epochs(loader), steps)
    return {
        "metrics": dict(trainer.metrics), "losses": [float(x) for x in step.losses],
        "model": model, "n_params": int(n_params), "tokens_per_batch": batch * seq,
        "flops_per_token": flops_per_token,
    }

