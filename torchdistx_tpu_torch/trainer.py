"""The training loop, counterpart of ``torchdistx_tpu/trainer.py``
(``Trainer``, ``fit``), its core only.

The step contract mirrors the JAX one, ``step(params, opt_state, batch)
-> (params, opt_state, loss)``.  PyTorch updates in place, so the port's
step is a :class:`TrainStep` over a module and a ``torch.optim``
optimizer: it runs forward, backward and the optimizer step on the
module's own parameters and hands back its own handles (``params`` is the
module, ``opt_state`` the optimizer).  Any callable with that signature
works.

``fit`` synchronizes with the card only at log boundaries, as the JAX loop
blocks only there.  The first step of the first ``fit`` is kept out of the
throughput window (its lazy setup: kernel builds, cuBLAS handles).

Metrics: ``steps_total``, ``tokens_total``, ``loss``, ``steps_per_sec``,
``tokens_per_sec``, ``mfu`` = tokens/s x ``flops_per_token`` /
``peak_flops`` (default: the H100 SXM's published dense bf16 peak),
``checkpoints_total`` and ``failures_total``.

Checkpoints (``utils/checkpoint.py``): every ``checkpoint_every`` steps
into ``checkpoint_dir/step_<n>``, and ``save()`` / ``restore()`` by hand;
the module and the optimizer are saved as their state dicts and restored
in place.  Failures (``utils/failure.py``): with a ``failure_detector``,
each log boundary checks the loss (and the window against a deadline);
``on_failure`` is ``"raise"``, ``"continue"`` (log only) or ``"restore"``
(roll back to the latest checkpoint and go on), and the log gets
``{"step", "failure", "action", "resumed_from"}``.  The health gate: no
checkpoint is written at a non-finite loss while a detector is set, so a
poisoned state never becomes the rollback target.  The flight recorder,
the session black box, the stall watchdog, cost cards and resharding
(``on_failure="reshard"``) are not ported yet: their arguments raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Callable, Iterable, Optional

import torch

from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.failure import StepFailure, apply_failure_policy

__all__ = ["Trainer", "TrainStep", "H100_PEAK_BF16"]

H100_PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)


class TrainStep:
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``:
    ``loss_fn(model, batch)`` forward, backward, ``optimizer.step()``.
    The loss comes back detached and unsynchronized; each one is also
    kept in ``losses``."""

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.losses: list = []

    def __call__(self, params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        loss = self.loss_fn(params, batch)
        loss.backward()
        opt_state.step()
        loss = loss.detach()
        self.losses.append(loss)
        return params, opt_state, loss


def _sync(loss) -> None:
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)


class Trainer:
    def __init__(
        self,
        step: Callable[..., Any],
        params: Any = None,
        opt_state: Any = None,
        *,
        tokens_per_batch: Optional[int] = None,
        log_every: int = 50,
        log_fn: Optional[Callable[[dict], None]] = None,
        flops_per_token: Optional[float] = None,
        peak_flops: Optional[float] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1000,
        failure_detector: Any = None,
        on_failure: str = "raise",
        flight: Any = None,
        record: Any = None,
        stall_timeout_s: Optional[float] = None,
        cost_card: bool = False,
    ) -> None:
        unported = dict(flight=flight, record=record, stall_timeout_s=stall_timeout_s,
                        cost_card=cost_card or None)
        for name, val in unported.items():
            if val is not None:
                raise NotImplementedError(f"Trainer({name}=...) is not ported yet")
        if on_failure == "reshard":
            raise NotImplementedError('on_failure="reshard" is not ported yet')
        if on_failure not in ("raise", "continue", "restore"):
            raise ValueError(f"unknown failure policy {on_failure!r}")
        if isinstance(step, TrainStep):
            params = step.model if params is None else params
            opt_state = step.optimizer if opt_state is None else opt_state
        self.step = step
        self.params = params
        self.opt_state = opt_state
        self.tokens_per_batch = tokens_per_batch
        self.log_every = log_every
        self.log_fn = log_fn or (lambda m: print(json.dumps(m), flush=True))
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops if peak_flops is not None else H100_PEAK_BF16
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.failure_detector = failure_detector
        self.on_failure = on_failure
        self.global_step = 0
        self._history: list = []
        self._last_checkpoint: Optional[str] = None
        self._warmed = False
        self.metrics: dict = {
            "steps_total": 0,
            "tokens_total": 0,
            "loss": None,
            "steps_per_sec": None,
            "tokens_per_sec": None,
            "mfu": None,
            "checkpoints_total": 0,
            "failures_total": 0,
        }

    # -- checkpoint --------------------------------------------------------

    def _state(self, step) -> dict:
        return {"params": self.params, "opt_state": self.opt_state, "global_step": step}

    def save(self, path: Optional[str] = None) -> str:
        """Write the module, the optimizer and the step to ``path``
        (default ``checkpoint_dir/step_<global_step>``)."""
        path = path or os.path.join(self.checkpoint_dir or ".", f"step_{self.global_step}")
        save_checkpoint(path, self._state(self.global_step))
        self._last_checkpoint = path
        self.metrics["checkpoints_total"] += 1
        return path

    def restore(self, path: str) -> None:
        """Load a checkpoint into the live module and optimizer, on their
        device, and take its step."""
        out = restore_checkpoint(path, like=self._state(0))
        self.params, self.opt_state = out["params"], out["opt_state"]
        self.global_step = int(out["global_step"])

    def reshard(self, *args, **kwargs):
        raise NotImplementedError("Trainer.reshard is not ported yet")

    def _update_derived_metrics(self) -> None:
        sps = self.metrics["steps_per_sec"]
        if sps and self.tokens_per_batch:
            tps = sps * self.tokens_per_batch
            self.metrics["tokens_per_sec"] = tps
            if self.flops_per_token:
                self.metrics["mfu"] = tps * self.flops_per_token / self.peak_flops

    def fit(self, batches: Iterable[Any], num_steps: Optional[int] = None) -> dict:
        """Run until ``global_step`` reaches ``num_steps`` (or the batches
        run out).  Returns ``{"step", "loss"}``."""
        t_window = time.perf_counter()
        window_steps = 0
        warmup_pending = not self._warmed
        loss = None
        it = iter(batches)
        while num_steps is None or self.global_step < num_steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            self.params, self.opt_state, loss = self.step(
                self.params, self.opt_state, batch)
            self.global_step += 1
            window_steps += 1
            self.metrics["steps_total"] += 1
            if self.tokens_per_batch:
                self.metrics["tokens_total"] += self.tokens_per_batch
            if warmup_pending:
                _sync(loss)
                t_window = time.perf_counter()
                window_steps = 0
                warmup_pending = False
                self._warmed = True
            if self.global_step % self.log_every == 0 and window_steps > 0:
                _sync(loss)
                dt = time.perf_counter() - t_window
                last_loss = float(loss)
                if self.failure_detector is not None:
                    try:
                        if hasattr(self.failure_detector, "check_devices"):
                            self.failure_detector.check_devices(self.global_step)
                        self.failure_detector.check_loss(self.global_step, last_loss)
                        self.failure_detector.check_window(self.global_step, dt,
                                                           window_steps)
                    except StepFailure as failure:
                        self.metrics["failures_total"] += 1
                        failed_step = self.global_step  # before any rollback
                        action = apply_failure_policy(self, failure, self.on_failure)
                        self.log_fn({"step": failed_step, "failure": failure.kind,
                                     "action": action,
                                     "resumed_from": self.global_step})
                        t_window = time.perf_counter()
                        window_steps = 0
                        continue
                self.metrics["loss"] = last_loss
                self.metrics["steps_per_sec"] = window_steps / dt
                self._update_derived_metrics()
                out = {"step": self.global_step, "loss": round(last_loss, 6),
                       "steps_per_sec": round(window_steps / dt, 3)}
                if self.tokens_per_batch:
                    out["tokens_per_sec"] = round(
                        self.tokens_per_batch * window_steps / dt, 1)
                self._history.append(last_loss)
                self.log_fn(out)
                t_window = time.perf_counter()
                window_steps = 0
            if self.checkpoint_dir and self.global_step % self.checkpoint_every == 0:
                # the health gate: a poisoned state never becomes the
                # rollback target of on_failure="restore"
                if self.failure_detector is not None and not math.isfinite(float(loss)):
                    self.log_fn({"step": self.global_step,
                                 "checkpoint": "skipped_nonfinite_loss"})
                else:
                    self.save()
        self._update_derived_metrics()
        return {"step": self.global_step,
                "loss": float(loss) if loss is not None else float("nan")}
