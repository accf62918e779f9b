"""Failure detection and recovery for training loops, counterpart of
``torchdistx_tpu/utils/failure.py``.

The reference has no failure-detection subsystem; the only
resilience-adjacent logic is GossipGraD's INVALID_PEER skip.  Three
layers, as in the JAX package:

  - **In-step protection**: :func:`guard_nonfinite_updates` wraps a
    ``torch.optim`` optimizer so that a step whose gradients hold a
    non-finite value applies no update at all (``optax.apply_if_finite``'s
    rule, counters included).  It is the only layer that can skip a
    poisoned update, because it runs before the parameters are written.
  - **Run-level detection**: :class:`FailureDetector`, non-finite losses
    within a tolerance and overdue synchronization windows.  Both are
    post-hoc: a Python process cannot interrupt a blocked CUDA call.
  - **External supervision**: :class:`Heartbeat`, a daemon thread that
    stamps a file; a supervisor declares the job dead when the stamp goes
    stale, the only detection that survives a wedged runtime.

Trainer policies (``on_failure``): ``"raise"`` stops the run,
``"restore"`` rolls back to the latest health-gated checkpoint and goes
on, ``"continue"`` only logs (pair it with :func:`guard_nonfinite_updates`
if the update itself must be suppressed), ``"reshard"`` sends a
``device_loss`` to ``trainer.reshard(failure)`` (the mesh shrinks onto the
survivors) and rolls any other failure back as ``"restore"`` does.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Optional

import torch

__all__ = [
    "FailureDetector",
    "StepFailure",
    "guard_nonfinite_updates",
    "GuardedOptimizer",
    "Heartbeat",
    "apply_failure_policy",
]


class GuardedOptimizer:
    """A ``torch.optim`` optimizer whose ``step()`` is skipped while any
    gradient is non-finite (``optax.apply_if_finite``): the step goes
    through when every gradient is finite, or when ``notfinite_count``,
    the run of consecutive bad steps, exceeds ``max_consecutive_errors``.
    ``last_finite`` and ``total_notfinite`` are optax's counters too.  One
    host sync a step reads the verdict.  Everything else is the wrapped
    optimizer's."""

    def __init__(self, optimizer, max_consecutive_errors: int = 5) -> None:
        self.optimizer = optimizer
        self.max_consecutive_errors = max_consecutive_errors
        self.notfinite_count = 0
        self.last_finite = True
        self.total_notfinite = 0

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def grads_finite(self) -> bool:
        grads = [p.grad for g in self.optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        if not grads:
            return True
        flags = torch.stack([torch.isfinite(g).all() for g in grads])
        return bool(flags.all())

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        finite = self.grads_finite()
        self.last_finite = finite
        if finite:
            self.notfinite_count = 0
        else:
            self.notfinite_count += 1
            self.total_notfinite += 1
        if finite or self.notfinite_count > self.max_consecutive_errors:
            self.optimizer.step()
        return loss

    def state_dict(self) -> dict:
        return {"inner": self.optimizer.state_dict(),
                "notfinite_count": self.notfinite_count,
                "last_finite": self.last_finite,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict["inner"])
        self.notfinite_count = int(state_dict["notfinite_count"])
        self.last_finite = bool(state_dict["last_finite"])
        self.total_notfinite = int(state_dict["total_notfinite"])


def guard_nonfinite_updates(optimizer, max_consecutive_errors: int = 5) -> GuardedOptimizer:
    """Wrap ``optimizer`` so steps with non-finite gradients apply no
    update (the in-step "skip").  After ``max_consecutive_errors``
    consecutive bad steps the wrapper stops masking and lets the update
    through, surfacing the failure to the run-level detector instead of
    hiding it forever."""
    return GuardedOptimizer(optimizer, max_consecutive_errors)


class StepFailure(RuntimeError):
    """A training step failed in a way the failure policy must handle."""

    def __init__(self, kind: str, message: str) -> None:
        super().__init__(message)
        self.kind = kind  # "nonfinite" | "deadline" | "device_loss"


class FailureDetector:
    """Detects failed steps from the host side.

    Args:
      nan_tolerance: consecutive non-finite losses tolerated before the
        step is declared failed (0 = fail on the first).
      step_deadline_s: wall-clock budget PER STEP for a synchronization
        window; a window whose average exceeds it is declared overdue.
        Post-hoc by nature (see module docstring); ``None`` disables it.
    """

    def __init__(
        self,
        *,
        nan_tolerance: int = 0,
        step_deadline_s: Optional[float] = None,
    ) -> None:
        self.nan_tolerance = nan_tolerance
        self.step_deadline_s = step_deadline_s
        self._consecutive_nonfinite = 0
        self.failures: list[dict] = []  # observability: what happened when
        # device-loss injection seam (tests):
        # ``inject_device_loss(n)`` makes the NEXT health check report
        # the named devices gone.  A real deployment sets this from its
        # platform's health feed (CUDA has no portable device-health API;
        # the detection contract is external, like the Heartbeat).
        self._lost_devices: Optional[int] = None

    # -- device health -----------------------------------------------------

    def inject_device_loss(self, n_lost: int) -> None:
        """Arm a simulated loss of ``n_lost`` devices; the next
        :meth:`check_devices` (run by the trainer at the same log
        boundary that checks the loss) raises ``device_loss``: the
        injectable twin of the NaN path."""
        if n_lost < 1:
            raise ValueError(f"n_lost must be >= 1, got {n_lost}")
        self._lost_devices = int(n_lost)

    def check_devices(self, step: int) -> None:
        """Raise :class:`StepFailure('device_loss')` when a device loss
        is pending (injected, or wired from a platform health feed)."""
        if self._lost_devices is None:
            return
        n = self._lost_devices
        self._lost_devices = None
        self.failures.append(
            {"step": step, "kind": "device_loss", "n_lost": n}
        )
        err = StepFailure(
            "device_loss",
            f"step {step}: {n} device(s) reported lost — the mesh must "
            "shrink before the next collective",
        )
        err.n_lost = n  # what a reshard policy would size the survivor mesh from
        raise err

    def reset(self) -> None:
        """Forget transient state after a failure has been HANDLED, so the
        configured tolerance applies afresh to the recovered run."""
        self._consecutive_nonfinite = 0

    # -- observability -----------------------------------------------------

    @property
    def consecutive_nonfinite(self) -> int:
        """Current run of non-finite losses — nonzero means the job is
        degrading even if the tolerance hasn't tripped yet."""
        return self._consecutive_nonfinite

    def counts_by_kind(self) -> dict:
        """Lifetime failure-event counts by kind (``nonfinite`` /
        ``deadline``), including tolerated events that never raised."""
        out: dict = {}
        for f in self.failures:
            out[f["kind"]] = out.get(f["kind"], 0) + 1
        return out

    # -- loss health -------------------------------------------------------

    def check_loss(self, step: int, loss: float) -> None:
        """Record ``loss``; raise :class:`StepFailure` when the run is no
        longer healthy."""
        if math.isfinite(loss):
            self._consecutive_nonfinite = 0
            return
        self._consecutive_nonfinite += 1
        self.failures.append(
            {"step": step, "kind": "nonfinite", "loss": repr(loss)}
        )
        if self._consecutive_nonfinite > self.nan_tolerance:
            raise StepFailure(
                "nonfinite",
                f"step {step}: loss is {loss!r} "
                f"({self._consecutive_nonfinite} consecutive non-finite "
                f"losses, tolerance {self.nan_tolerance})",
            )

    # -- overdue-step check ------------------------------------------------

    def check_window(self, step: int, elapsed_s: float, n_steps: int) -> None:
        """Check a synchronized window of ``n_steps`` against the per-step
        deadline.  Raises :class:`StepFailure` when overdue."""
        if self.step_deadline_s is None or n_steps <= 0:
            return
        budget = self.step_deadline_s * n_steps
        if elapsed_s > budget:
            self.failures.append(
                {
                    "step": step,
                    "kind": "deadline",
                    "elapsed_s": round(elapsed_s, 3),
                    "budget_s": round(budget, 3),
                }
            )
            raise StepFailure(
                "deadline",
                f"step {step}: {n_steps}-step window took {elapsed_s:.1f}s, "
                f"over the {budget:.1f}s budget "
                f"({self.step_deadline_s:.1f}s/step) — device overloaded or "
                "collective degraded",
            )

    def deadline(self, n_steps: int = 1) -> "_Deadline":
        """Context manager form of :meth:`check_window` for standalone
        loops."""
        return _Deadline(self, n_steps)


class _Deadline:
    def __init__(self, det: FailureDetector, n_steps: int) -> None:
        self._det = det
        self._n = n_steps
        self._t0 = 0.0

    def __enter__(self) -> "_Deadline":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        self._det.check_window(-1, time.monotonic() - self._t0, self._n)


class Heartbeat:
    """Liveness stamp for external supervision of hard hangs.

    A daemon thread writes ``<monotonic-ish unix time> <step>`` to
    ``path`` every ``interval_s``.  An external supervisor declares the
    job dead when the file's stamp is older than its own threshold — the
    only detection that works when the runtime itself is wedged (an
    in-process watchdog cannot interrupt a blocked CUDA call).

    Use as a context manager around ``fit`` (or call :meth:`start` /
    :meth:`stop`); update ``self.step`` from the training loop for
    step-resolution liveness.
    """

    def __init__(self, path: str, interval_s: float = 10.0) -> None:
        self.path = path
        self.interval_s = interval_s
        self.step = 0
        self.write_failures = 0  # consecutive; resets on success
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _beat(self) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{time.time()} {self.step}\n")
        os.replace(tmp, self.path)  # atomic: supervisors never read a torn file

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            # A transient write error (disk full, path briefly unavailable)
            # must not permanently end liveness reporting while training
            # continues — a dead heartbeat makes the supervisor kill a
            # healthy job.  Count consecutive failures for observability;
            # the next successful beat resets the counter.
            try:
                self._beat()
            except OSError:
                self.write_failures += 1
            else:
                self.write_failures = 0

    def start(self) -> "Heartbeat":
        # Deliberately unguarded: a write failure HERE is almost always a
        # misconfigured path and must fail fast at startup, before the
        # supervisor starts trusting this file — only the steady-state
        # loop tolerates transient errors.
        self._beat()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @staticmethod
    def is_stale(path: str, max_age_s: float) -> bool:
        """Supervisor-side check: True when the stamp is missing or older
        than ``max_age_s``."""
        try:
            with open(path) as f:
                stamp = float(f.read().split()[0])
        except (OSError, ValueError, IndexError):
            return True
        return time.time() - stamp > max_age_s


def apply_failure_policy(
    trainer: Any, failure: StepFailure, policy: str
) -> str:
    """Resolve a step failure for a Trainer.

    Returns the action taken: "raise" never returns, "continue" keeps
    current state (log-only), "restore" rolled back to the latest
    health-gated checkpoint, "resharded" moved the state onto the
    survivors of a device loss (``policy="reshard"``; other failures fall
    back to the restore path).  Handled failures reset the detector's
    transient counters so its tolerance applies afresh.
    """
    if policy == "raise":
        raise failure
    det = getattr(trainer, "failure_detector", None)
    if policy == "continue":
        if det is not None:
            det.reset()
        return "continued"
    if policy == "reshard":
        if failure.kind == "device_loss" and hasattr(trainer, "reshard"):
            trainer.reshard(failure)
            if det is not None:
                det.reset()
            return "resharded"
        # a failure that is not a lost device means the state is suspect,
        # not the mesh: roll back as "restore" does
        policy = "restore"
    if policy == "restore":
        if not getattr(trainer, "_last_checkpoint", None):
            raise StepFailure(
                failure.kind,
                f"{failure} (and no checkpoint exists to restore from)",
            )
        trainer.restore(trainer._last_checkpoint)
        if det is not None:
            det.reset()
        return "restored"
    raise ValueError(f"unknown failure policy {policy!r}")
