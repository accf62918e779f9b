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
``tokens_per_sec`` and ``mfu`` = tokens/s x ``flops_per_token`` /
``peak_flops`` (default: the H100 SXM's published dense bf16 peak).
Checkpointing, failure handling, the flight recorder, the session black
box, the stall watchdog, cost cards and resharding are not ported yet:
their arguments raise ``NotImplementedError``.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Iterable, Optional

import torch

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
        failure_detector: Any = None,
        flight: Any = None,
        record: Any = None,
        stall_timeout_s: Optional[float] = None,
        cost_card: bool = False,
    ) -> None:
        unported = dict(checkpoint_dir=checkpoint_dir,
                        failure_detector=failure_detector, flight=flight,
                        record=record, stall_timeout_s=stall_timeout_s,
                        cost_card=cost_card or None)
        for name, val in unported.items():
            if val is not None:
                raise NotImplementedError(f"Trainer({name}=...) is not ported yet")
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
        self.global_step = 0
        self._history: list = []
        self._warmed = False
        self.metrics: dict = {
            "steps_total": 0,
            "tokens_total": 0,
            "loss": None,
            "steps_per_sec": None,
            "tokens_per_sec": None,
            "mfu": None,
        }

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
        self._update_derived_metrics()
        return {"step": self.global_step,
                "loss": float(loss) if loss is not None else float("nan")}
