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
``on_failure`` is ``"raise"``, ``"continue"`` (log only), ``"restore"``
(roll back to the latest checkpoint and go on) or ``"reshard"`` (a
``device_loss`` shrinks the mesh and moves the state onto the survivors,
:meth:`Trainer.reshard`; any other failure rolls back as ``"restore"``),
and the log gets ``{"step", "failure", "action", "resumed_from"}``.  The
health gate: no checkpoint is written at a non-finite loss while a
detector is set, so a poisoned state never becomes the rollback target.
The flight recorder, the session black box, the stall watchdog and cost
cards are not ported yet: their arguments raise ``NotImplementedError``.
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
        if on_failure not in ("raise", "continue", "restore", "reshard"):
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
        self._t_reshard = 0.0  # seconds spent moving state onto a shrunk mesh
        self.last_reshard: Optional[dict] = None
        self.departed = False  # this rank was lost and has left the mesh
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

    # -- elastic resharding ------------------------------------------------

    @staticmethod
    def _shrunk_mesh(mesh, n_lost: int):
        """The surviving mesh after losing the LAST ``n_lost`` ranks of
        ``mesh``'s flat order (the injection contract; a real loss would
        pass the survivors' mesh to :meth:`reshard`): the survivors are the
        first ranks, and the shrink factor is taken by the outermost axis
        that divides it, so ``{"dp": 2, "fsdp": 2}`` losing a replica
        becomes ``{"dp": 1, "fsdp": 2}`` and ``{"fsdp": 4}`` losing two
        ``{"fsdp": 2}``.  Building a mesh makes process groups, which is
        collective over the world: every rank calls it, the lost ones
        too (they get a mesh they are not a member of)."""
        import numpy as np

        from .parallel.mesh import Mesh

        devices = [int(r) for r in np.asarray(mesh.devices).flat]
        n_surv = len(devices) - int(n_lost)
        if n_surv < 1 or len(devices) % n_surv != 0:
            raise StepFailure("device_loss", f"cannot shrink a {len(devices)}-rank mesh to "
                              f"{n_surv} survivors (need a divisor)")
        factor = len(devices) // n_surv
        shape = {ax: int(mesh.shape[ax]) for ax in mesh.axis_names}
        for ax in shape:
            if shape[ax] % factor == 0:
                shape[ax] //= factor
                break
        else:
            raise StepFailure("device_loss", f"no mesh axis of {shape} divides the shrink "
                              f"factor {factor}")
        arr = np.asarray(devices[:n_surv]).reshape(tuple(shape.values()))
        return Mesh(arr, tuple(shape), member=False)

    def reshard(self, failure: Any = None, *, mesh: Any = None) -> str:
        """Elastic recovery: move the parameters and the optimizer's state
        onto a shrunk mesh and rebuild the step there (the
        ``on_failure="reshard"`` leg of the failure policy).

        ``mesh`` defaults to :meth:`_shrunk_mesh` of the step's mesh by
        ``failure.n_lost`` ranks.  The step must have ``mesh``,
        ``placement_on`` and ``with_mesh`` (``ShardedTrainStep``,
        ``GSPMDTrainStep``; a plan's rules carry over, ``plan.with_mesh``).
        The state moves by ``parallel.reshard.reshard`` when the survivors
        hold every piece (``can_reshard_live``: ``"live"``), else by the
        checkpoint bounce (``"checkpoint"``: saved whole from the old mesh
        under ``checkpoint_dir``, restored into the new placements).

        The contract with the lost ranks, which this port only simulates:
        every rank of the old mesh calls ``reshard`` at the same step (the
        detector's injection is the same on every rank).  The lost ranks
        take part in making the survivors' process groups (collective
        over the world), in any gather of the live path and in the
        bounce's save on the old mesh, then leave: ``departed`` becomes
        True and ``fit`` returns.  The survivors go on with the new step.
        The time spent goes into ``_t_reshard``; ``last_reshard`` records
        the step, both mesh shapes, the mode, the closed-form wire bytes
        (``reshard_wire_bytes``; the bounce's restore reads from the
        checkpoint and moves none), the bytes the move handed to
        collectives and the seconds.  Booking them into a comm audit and
        the flight recorder waits for ``obs/comm`` and ``obs/flight``.
        Returns the mode."""
        from .parallel import collectives
        from .parallel.reshard import (can_reshard_live, optimizer_state_tree, reshard,
                                       reshard_via_checkpoint, reshard_wire_bytes,
                                       state_targets, write_back)

        step = self.step
        old_mesh = getattr(step, "mesh", None)
        kind = getattr(failure, "kind", "device_loss")
        if old_mesh is None or not hasattr(step, "with_mesh"):
            raise StepFailure(kind, f"{failure} (and the step carries no mesh to reshard)")
        if getattr(step, "_zero2", None):
            raise NotImplementedError("resharding a ZeRO-2 step is not ported yet "
                                      "(ROADMAP A.4.6)")
        if mesh is None:
            mesh = self._shrunk_mesh(old_mesh, getattr(failure, "n_lost", None) or 1)
        t0 = time.perf_counter()
        sent = dict(collectives.payload_bytes)
        model, opt = step.model, step.optimizer
        tree = {"params": dict(model.named_parameters()),
                "opt_state": optimizer_state_tree(opt, model)}
        targets = state_targets(tree, step.placement_on(mesh))
        live = can_reshard_live(tree, mesh)
        wire = reshard_wire_bytes(tree, targets) if live else 0
        if live:
            new = reshard(tree, targets)
        else:
            path = os.path.join(self.checkpoint_dir or ".", f"reshard_{self.global_step}")
            new = reshard_via_checkpoint(tree, path, targets)
        if mesh.is_member:
            write_back(model, opt, new)
            self.step = step.with_mesh(mesh)
        else:
            self.departed = True
        dt = time.perf_counter() - t0
        self._t_reshard += dt
        mode = "live" if live else "checkpoint"
        self.last_reshard = {
            "step": self.global_step, "mesh_from": dict(old_mesh.shape),
            "mesh_to": dict(mesh.shape), "mode": mode, "wire_bytes": wire,
            "payload_bytes": {k: v - sent[k] for k, v in collectives.payload_bytes.items()},
            "seconds": dt, "departed": self.departed}
        return mode

    def _update_derived_metrics(self) -> None:
        sps = self.metrics["steps_per_sec"]
        if sps and self.tokens_per_batch:
            tps = sps * self.tokens_per_batch
            self.metrics["tokens_per_sec"] = tps
            if self.flops_per_token:
                self.metrics["mfu"] = tps * self.flops_per_token / self.peak_flops

    def fit(self, batches: Iterable[Any], num_steps: Optional[int] = None) -> dict:
        """Run until ``global_step`` reaches ``num_steps`` (or the batches
        run out, or this rank leaves a shrinking mesh: ``departed``).
        Returns ``{"step", "loss"}``."""
        t_window = time.perf_counter()
        window_steps = 0
        warmup_pending = not self._warmed
        loss = None
        it = iter(batches)
        while (num_steps is None or self.global_step < num_steps) and not self.departed:
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
