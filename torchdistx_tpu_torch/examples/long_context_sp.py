"""Sequence-parallel long-context training: the port's counterpart of
``examples/long_context_sp.py``.

A Llama whose attention runs RING (the flash kernels per block, K/V
rotating over the ranks) or ULYSSES (two all-to-alls around local flash
attention) sequence parallelism: the sequence dimension is cut over the
world's ``sp`` axis, so the trainable context grows with the ranks while a
rank's memory stays flat.  Then the T5-style relative-position bias on the
flash ring: the bias rows go with the queries (O(S) a rank), the key
columns stay global, and each hop takes its column slice.

One card: ``python -m torchdistx_tpu_torch.examples.long_context_sp``
(bf16 on the card, f32 on the CPU: ``TDX_PLATFORM=cpu``).  Several ranks:
launch one process a rank with ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``
and ``MASTER_PORT`` set (``torchrun``); each calls ``init_multihost``.
The strategy: ``TDX_SP_MODE=ring|ulysses`` (default ring); the global
context: ``TDX_SEQ`` (default 1024).  From Python, in a world that is up:
``main(sp_mode=, seq=, device=)``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["main"]

STEPS, LR = 5, 3e-4  # the JAX example's five optax.adamw(3e-4) steps


def main(*, sp_mode: str = "ring", seq: int = 1024, device="cuda", steps: int = STEPS,
         dtype: Optional[torch.dtype] = None,
         params: Optional[Mapping[str, np.ndarray]] = None, log_fn=print) -> dict:
    """Train tiny Llama (8 heads of 64: dim 512, where the JAX example's
    heads are 16 wide, below the flash kernels' head dims of 64 and 128)
    at a global context of ``seq``
    tokens over every rank of the world on the ``sp`` axis for ``steps``
    steps, then run the biased flash ring once.  ``dtype`` defaults to bf16
    on the card (the kernels' dtype) and f32 elsewhere; ``params`` are
    start weights by name (numpy arrays such as the JAX model's), loaded
    over the seeded init.  Returns
    ``{"ranks", "sp_mode", "seq", "losses", "biased_out_shape",
    "biased_out_finite", "step"}``."""
    from .. import deferred_init, manual_seed, materialize_module
    from ..interop import load_jax_params
    from ..models import Llama
    from ..nn import functional as F
    from ..ops.attention import ring_flash_attention
    from ..parallel import ShardedTrainStep, collectives, create_mesh
    from ..trainer import Trainer
    from .vit_train import OptaxAdamW

    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    mesh = create_mesh({"sp": -1})  # every rank on the sequence axis
    n = mesh.size
    if seq % n:
        raise ValueError(f"the context {seq} does not divide over {n} ranks")

    # 1. deferred-init the SP model; the parameters are replicated (sp cuts
    #    the activations, not the weights: compose sp x fsdp for both)
    manual_seed(0)
    model = deferred_init(Llama.from_name, "tiny", max_seq_len=seq, sp_axis="sp",
                          sp_mode=sp_mode, n_heads=8, dim=512, dtype=dtype, device=device)
    materialize_module(model)
    if params is not None:
        load_jax_params(model, params)
    log_fn(f"{sp_mode} SP over {n} ranks: global context {seq}, {seq // n} a rank")

    # 2. the step: each rank takes its slice of the sequence; attention
    #    communicates over sp inside the model
    def loss_fn(m, batch):
        tokens, labels = batch
        return F.cross_entropy(m(tokens), labels)

    opt = OptaxAdamW(model.parameters(), lr=LR, weight_decay=1e-4)  # optax.adamw's default
    step = ShardedTrainStep(model, opt, loss_fn, mesh, shard_axis=None,
                            batch_spec=(None, "sp"))

    # 3. synthetic next-token data at the GLOBAL context length
    rs = np.random.RandomState(0)
    data = torch.from_numpy(rs.randint(0, 256, (2, seq + 1))).to(device)
    batch = (data[:, :-1], data[:, 1:])

    def on_log(m):
        log_fn(f"step {m.get('step')}: loss {m.get('loss'):.4f}")

    trainer = Trainer(step, log_every=1, log_fn=on_log, tokens_per_batch=2 * seq)
    trainer.fit((batch for _ in range(steps)), steps)

    # 4. the relative-position bias on the flash ring: bias rows with the
    #    queries, key columns global
    h, d = 4, 64  # the JAX example's 4 heads, at the kernels' head dim
    rsb = np.random.RandomState(1)
    qkv = torch.from_numpy(rsb.randn(1, seq, h, d).astype(np.float32)).to(device, dtype)
    rel_bias = torch.from_numpy((rsb.randn(h, seq, seq) * 0.5).astype(np.float32))
    with mesh:
        rows = slice(collectives.axis_index("sp") * (seq // n),
                     (collectives.axis_index("sp") + 1) * (seq // n))
        local = qkv[:, rows]
        with torch.no_grad():
            out = ring_flash_attention(local, local, local, axis="sp", causal=True,
                                       bias=rel_bias[:, rows].to(device, dtype))
    finite = bool(torch.isfinite(out).all())
    shape = (1, seq) + tuple(out.shape[2:])
    log_fn(f"biased flash-ring attention (T5 rel-pos) over {n} ranks: out {shape}")
    return {"ranks": n, "sp_mode": sp_mode, "seq": seq,
            "losses": [float(x) for x in step.losses], "biased_out_shape": shape,
            "biased_out_finite": finite, "step": step}


if __name__ == "__main__":
    from ..parallel import init_multihost

    on_cpu = os.environ.get("TDX_PLATFORM") == "cpu"
    if os.environ.get("WORLD_SIZE"):
        init_multihost(device="cpu" if on_cpu else None)
    main(sp_mode=os.environ.get("TDX_SP_MODE", "ring"),
         seq=int(os.environ.get("TDX_SEQ", "1024")), device="cpu" if on_cpu else "cuda")
