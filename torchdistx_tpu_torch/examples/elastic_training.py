"""Elastic training with failure detection: the port's counterpart of
``examples/elastic_training.py``.

It composes the three elasticity layers of ``utils/failure.py``:

- ``guard_nonfinite_updates``: a step with non-finite gradients applies no
  update;
- ``FailureDetector`` + ``on_failure="restore"``: a step whose loss is not
  finite rolls the run back to its latest health-gated checkpoint, and the
  run goes on;
- ``Heartbeat``: a stamp file an external supervisor can watch.

A poisoned batch (its targets NaN: a corrupted shard read) is injected at
step ``poison_at`` to show the recovery.

On the card: ``python -m torchdistx_tpu_torch.examples.elastic_training``;
on the CPU: ``TDX_PLATFORM=cpu python -m
torchdistx_tpu_torch.examples.elastic_training`` (``TDX_PLATFORM`` is the
JAX example's knob).  From Python: ``main(device="cpu")``.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["MLP", "main"]


class MLP(torch.nn.Module):
    def __init__(self, device="cuda"):
        from .. import nn

        super().__init__()
        self.fc1 = nn.Linear(32, 128, device=device)
        self.fc2 = nn.Linear(128, 1, device=device)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def main(*, steps: int = 60, poison_at: int = 30, device="cuda",
         workdir: Optional[str] = None,
         params: Optional[Mapping[str, np.ndarray]] = None, log_fn=print) -> dict:
    """Train the MLP ``steps`` steps with a checkpoint every 10 and the
    batch of step ``poison_at`` poisoned (``params``: start weights by
    name, numpy arrays such as the JAX example's, loaded over the seeded
    init).  Returns ``{"global_step",
    "records", "failures", "params_finite", "heartbeat", "workdir"}``:
    the trainer's log records (every 10 steps and each failure), the
    failure records, and the heartbeat file's last stamp."""
    from .. import deferred_init, manual_seed, materialize_module
    from ..interop import load_jax_params
    from ..trainer import Trainer, TrainStep
    from ..utils.failure import FailureDetector, Heartbeat, guard_nonfinite_updates

    device = torch.device(device)
    manual_seed(0)
    model = deferred_init(MLP, device=device)
    materialize_module(model)
    if params is not None:
        load_jax_params(model, params)
    # in-step protection: a poisoned gradient applies NO update
    opt = guard_nonfinite_updates(torch.optim.Adam(model.parameters(), lr=1e-3))

    def loss_fn(m, batch):
        x, y = batch
        return torch.mean((m(x) - y) ** 2)

    workdir = workdir or tempfile.mkdtemp(prefix="elastic_")
    os.makedirs(workdir, exist_ok=True)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(64, 32).astype(np.float32)).to(device)
    y = x[:, :4].sum(1, keepdim=True)

    def batches():
        n = 0
        while True:
            n += 1
            # the injected fault: a corrupted batch
            yield (x, y * float("nan")) if n == poison_at else (x, y)

    records = []
    heartbeat = os.path.join(workdir, "heartbeat")
    with Heartbeat(heartbeat, interval_s=5.0) as hb:

        def log(metrics):
            hb.step = metrics.get("step", hb.step)  # step-resolution liveness
            records.append(metrics)
            log_fn(json.dumps(metrics))

        trainer = Trainer(
            TrainStep(model, opt, loss_fn),
            log_every=10,
            log_fn=log,
            checkpoint_dir=workdir,
            checkpoint_every=10,
            failure_detector=FailureDetector(nan_tolerance=0, step_deadline_s=120),
            on_failure="restore",
        )
        trainer.fit(batches(), steps)
    with open(heartbeat) as f:
        stamp = f.read().split()
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if not finite:
        raise RuntimeError("params must stay finite")
    log_fn(f"done at step {trainer.global_step}; checkpoints in {workdir}")
    return {"global_step": trainer.global_step, "records": records,
            "failures": [r for r in records if "failure" in r], "params_finite": finite,
            "heartbeat": {"time": float(stamp[0]), "step": int(stamp[1])},
            "workdir": workdir}


if __name__ == "__main__":
    main(device="cpu" if os.environ.get("TDX_PLATFORM") == "cpu" else "cuda")
