"""ViT image classification: deferred init at real scale, then a sharded
fine-tuning loop on synthetic data; the port's counterpart of
``examples/vit_train.py``.

ViT-L/16 is counted in fake mode (zero bytes held); a small ViT is
deferred-initialized, materialized FSDP-sharded over every rank of the
world (``fsdp_shard_rule``; one rank: a mesh of one) and fine-tuned
through ``ShardedTrainStep`` with its optimizer state made by
``init_optimizer``.  JAX's ``optax.adamw(3e-4, weight_decay=0.05)`` is
:class:`OptaxAdamW`: ``torch.optim.AdamW``'s arguments and state with
optax's arithmetic.

On the card, one rank::

    from torchdistx_tpu_torch.examples.vit_train import main
    out = main("vit_b16", steps=10)

On the CPU at the tiny size: ``main(device="cpu")``; several ranks: each
process calls ``init_multihost`` first.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["OptaxAdamW", "main"]


class OptaxAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` (its arguments and its ``step`` / ``exp_avg``
    / ``exp_avg_sq`` state) stepping as ``optax.adamw`` does:
    ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``, the update
    ``(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd * p`` scaled by
    ``-lr`` and added to ``p``.  (torch's own decays ``p`` by ``lr * wd``
    first and folds the corrections into the step size: the same
    update, rounded differently.)"""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["step"] += 1
                t = int(st["step"].item())
                g = p.grad
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.copy_((1.0 - b1) * g + b1 * m)
                v.copy_((1.0 - b2) * (g * g) + b2 * v)
                c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** t
                c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** t
                upd = (m / c1.to(m.device)) / (torch.sqrt(v / c2.to(v.device)) + eps)
                if wd != 0.0:
                    upd = upd + wd * p
                p.add_(-lr * upd)
        return loss


BATCH, LR, WEIGHT_DECAY, LOG_EVERY = 8, 3e-4, 0.05, 10  # the JAX example's


def main(name: str = "tiny", *, steps: int = 30, device="cuda", mesh=None,
         params: Optional[Mapping[str, np.ndarray]] = None, seed: int = 0,
         log_fn=print) -> dict:
    """Count ViT-L/16 in fake mode, then fine-tune ``name`` for ``steps``
    steps on ``BATCH`` synthetic images a step (``RandomState(0)``: images
    ``randn``, labels ``rand * num_classes``, as the JAX example draws
    them).  ``params`` are start weights by name (numpy arrays, e.g. the
    JAX example's), loaded before the step cuts them.  Returns
    ``{"fake_params", "n_params", "losses", "metrics", "model", "step"}``."""
    from .. import deferred_init, fake_mode, manual_seed, materialize_module
    from ..interop import load_jax_params
    from ..models import ViT
    from ..nn import functional as F
    from ..parallel import ShardedTrainStep, create_mesh, fsdp_shard_rule
    from ..trainer import Trainer

    device = torch.device(device)
    # 1. inspect the real thing without allocating it
    with fake_mode():
        big = ViT.from_name("vit_l16", device=device)
    fake_params = sum(p.numel() for p in big.parameters())
    del big
    log_fn(f"ViT-L/16: {fake_params / 1e6:.1f}M params (zero bytes held)")

    # 2. train a small one, FSDP-sharded, on synthetic labels
    mesh = mesh if mesh is not None else create_mesh({"fsdp": -1})
    manual_seed(seed)
    model = deferred_init(ViT.from_name, name, device=device)
    if params is None:
        materialize_module(model, sharding_rule=fsdp_shard_rule(mesh))
    else:  # whole weights first; the step cuts them
        materialize_module(model)
        load_jax_params(model, params)
    n_params = sum(int(np.prod(getattr(p, "_tdx_global_shape", p.shape)))
                   for p in model.parameters())
    log_fn(f"model: {n_params / 1e6:.2f}M params over {mesh.size} ranks")
    size, classes = model.cfg.image_size, model.cfg.num_classes

    def loss_fn(m, b):
        images, labels = b
        return F.cross_entropy(m(images), labels)

    opt = OptaxAdamW(model.parameters(), lr=LR, weight_decay=WEIGHT_DECAY)
    step = ShardedTrainStep(model, opt, loss_fn, mesh, shard_axis="fsdp")
    step.init_optimizer()

    rs = np.random.RandomState(0)

    def batches():
        for _ in range(steps):
            images = rs.randn(BATCH, 3, size, size).astype(np.float32)
            labels = (rs.rand(BATCH) * classes).astype(np.int64)
            yield (torch.from_numpy(images).to(device, model.cfg.dtype),
                   torch.from_numpy(labels).to(device))

    def on_log(m):
        log_fn(f"step {m.get('step')}: loss {m.get('loss'):.4f}")

    trainer = Trainer(step, log_every=max(1, min(LOG_EVERY, steps)), log_fn=on_log,
                      tokens_per_batch=BATCH)
    trainer.fit(batches(), steps)
    return {"fake_params": int(fake_params), "n_params": int(n_params),
            "losses": [float(x) for x in step.losses], "metrics": dict(trainer.metrics),
            "model": model, "step": step}
