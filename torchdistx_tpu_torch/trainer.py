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

Metrics, the JAX loop's keys: ``steps_total``, ``tokens_total``,
``checkpoints_total``, ``failures_total``, ``loss``, ``steps_per_sec``,
``tokens_per_sec``, ``mfu`` = tokens/s x ``flops_per_token`` /
``peak_flops`` (default: the H100 SXM's published dense bf16 peak),
``mfu_xla``, ``flop_attribution`` and ``goodput``.  The names are JAX's,
so a scrape (:meth:`Trainer.metrics_collector`) has JAX's families; in the
port ``mfu_xla`` is steps/s x the step's COUNTED FLOPs (the cost card's,
``obs.cost.counted_card``: the aten matrix products by FlopCounterMode's
per-op formulas plus the hand-written kernels' formulas) / ``peak_flops``, and
``flop_attribution`` the analytic over the counted FLOPs.  ``goodput`` is
the productive share of the wall time the loop has split, as JAX's:
productive (the log windows), compile (the first step, and the card taken
on it), checkpoint, rollback and reshard seconds.

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

Telemetry, as in the JAX loop: the flight recorder (``flight``: default
the process-wide one, ``False`` for none) records ``fit_start``, the
warm-up, every log boundary, checkpoints, failures and rollbacks,
reshards and ``fit_end``, and dumps its ring on an exception or a handled
failure; the session black box (``record``) records the trainer and, per
step, the batch's identity digest (:func:`batch_digest`) and the rng
counter; ``stall_timeout_s`` arms a dispatch-stall watchdog around every
step and every sync; ``cost_card=True`` takes the step's counted cost
card on the FIRST real step itself (no extra execution; the step is booked
to the compile bucket), into ``obs.cost.default_book()`` as JAX's: its
FLOPs, the analytic FLOPs, and on the card the caching allocator's peak
and temp bytes.  A card resets the allocator's peak statistics, which a
caller measuring peaks reads, so the port's default is off where JAX's is
on.

The numerics observatory (``obs.numerics``): a step built with
``numerics=True`` (:class:`TrainStep`, ``parallel.ShardedTrainStep``,
``parallel.GSPMDTrainStep``; None reads ``TDX_NUMERICS``) leaves its
digests on ``step.last_digests``: ``params/<group>`` before the update,
``act/<site>`` from the model's taps, ``loss`` and ``grads/<group>``, the
JAX package's sites.  The trainer folds them into ``numerics_book`` at each
log boundary, after the loss has been read (no sync of its own), and the
failure and rollback flight records name the earliest site whose
nonfinite count went positive (``nonfinite_site``).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from .obs.blackbox import resolve_record
from .obs.comm import CommProfile, comm_audit
from .obs.flight import get_flight_recorder
from .obs.numerics import (
    NumericsBook,
    StagedDigests,
    array_digest,
    numerics_enabled,
    numerics_tape,
    tree_group_digest,
)
from .utils.checkpoint import restore_checkpoint, save_checkpoint
from .utils.failure import StepFailure, apply_failure_policy

__all__ = ["Trainer", "TrainStep", "H100_PEAK_BF16", "batch_digest"]

H100_PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)


class TrainStep:
    """``step(model, optimizer, batch) -> (model, optimizer, loss)``:
    ``loss_fn(model, batch)`` forward, backward, ``optimizer.step()``.
    The loss comes back detached and unsynchronized; each one is also
    kept in ``losses``.  ``numerics=True`` (None: ``TDX_NUMERICS``) leaves
    the step's digests on ``last_digests`` (module docstring): device
    tensors, read by the trainer at its next sync."""

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable, *,
                 numerics: Optional[bool] = None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.losses: list = []
        self.numerics = numerics
        self.last_digests: Optional[dict] = None

    @property
    def numerics_on(self) -> bool:
        return numerics_enabled() if self.numerics is None else bool(self.numerics)

    def __call__(self, params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        num_on = self.numerics_on
        if num_on:
            digs = tree_group_digest(self.model.named_parameters(), "params/")
        with numerics_tape() if num_on else contextlib.nullcontext() as tape:
            loss = self.loss_fn(params, batch)
        loss.backward()
        if num_on:
            digs.update({f"act/{s}": d for s, d in tape.digests().items()})
            digs["loss"] = array_digest(loss)
            digs.update(tree_group_digest(
                ((n, p.grad) for n, p in self.model.named_parameters()), "grads/"))
            self.last_digests = digs
        opt_state.step()
        loss = loss.detach()
        self.losses.append(loss)
        return params, opt_state, loss


def _sync(loss) -> None:
    if isinstance(loss, torch.Tensor) and loss.is_cuda:
        torch.cuda.synchronize(loss.device)


def batch_digest(batch: Any) -> str:
    """Identity digest of one training batch, host side only: numpy arrays
    and CPU tensors hash by their bytes (shape and dtype included), tensors
    on the card by shape, dtype and device, never fetched, so a digest
    costs no device sync.  Bit-identical host batches give equal digests;
    a shuffled or corrupted pipeline names the first step that differs."""
    h = hashlib.sha256()
    leaves, _ = torch.utils._pytree.tree_flatten(batch)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu":
            leaf = leaf.detach().contiguous().numpy()
        if isinstance(leaf, np.ndarray):
            h.update(str((leaf.shape, str(leaf.dtype))).encode())
            h.update(np.ascontiguousarray(leaf).tobytes())
        elif isinstance(leaf, (bool, int, float, str, bytes)):
            h.update(repr(leaf).encode())
        else:
            h.update(str((type(leaf).__name__, tuple(getattr(leaf, "shape", ()) or ()),
                          str(getattr(leaf, "dtype", "")),
                          str(getattr(leaf, "device", "")))).encode())
    return h.hexdigest()


class _NoFlight:
    """The flight recorder of ``Trainer(flight=False)``: records nothing."""

    session_path = None

    def record(self, kind: str, **fields) -> None:
        return None

    def dump(self, reason: str = "manual") -> None:
        return None


def _rng_counter() -> int:
    from .utils.rng import _state

    return int(_state.counter)


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
        # the wall-time split goodput reads, host-measured at boundaries
        # that already wait on the card
        self._t_productive = 0.0
        self._t_compile = 0.0
        self._t_checkpoint = 0.0
        self._t_rollback = 0.0
        self._t_reshard = 0.0  # seconds spent moving state onto a shrunk mesh
        self.last_reshard: Optional[dict] = None
        self.departed = False  # this rank was lost and has left the mesh
        # every step runs under this comm audit (obs.comm): the sharded
        # steps book one execution of their program, a ZeRO-2 step its
        # closed form at each dispatch, and a reshard its migration
        self.comm_profile = CommProfile()
        # the numerics observatory: the step's digests (last_digests), read
        # at the log boundaries
        self.numerics_book = NumericsBook()
        self.numerics_harvest_errors = 0
        self.metrics: dict = {
            "steps_total": 0,
            "tokens_total": 0,
            "checkpoints_total": 0,
            "failures_total": 0,
            "loss": None,
            "steps_per_sec": None,
            "tokens_per_sec": None,
            "mfu": None,
            "mfu_xla": None,
            "flop_attribution": None,
            "goodput": None,
        }
        # the flight recorder: ring records at the log boundaries,
        # checkpoints and failures, dumped when the run breaks
        if flight is False:
            flight = _NoFlight()
        self.flight = flight if flight is not None else get_flight_recorder()
        self.last_flight_dump: Optional[str] = None
        # the session black box: the trainer, then per step the batch's
        # identity digest and the rng counter (TDX_SESSION_RECORD=0: none)
        self.recorder = resolve_record(record)
        self._bb_on = bool(getattr(self.recorder, "enabled", False))
        self._last_batch_digest: Optional[str] = None
        if self._bb_on:
            self.recorder.record("trainer", step_type=type(step).__name__,
                                 tokens_per_batch=tokens_per_batch,
                                 start_step=self.global_step, rng_counter=_rng_counter())
            if self.recorder.path:
                self.flight.session_path = self.recorder.path
        # the step's counted cost card (obs.cost), taken on the first step
        from .obs.cost import default_book, force_disabled

        self._want_cost_card = bool(cost_card) and not force_disabled()
        self.cost_card = None
        self.cost_book = default_book()
        # the dispatch-stall watchdog around every step and every sync
        self.watchdog = None
        if stall_timeout_s is not None:
            from .obs.watchdog import DispatchWatchdog

            self.watchdog = DispatchWatchdog(stall_timeout_s, flight=self.flight,
                                             book=self.cost_book)

    # -- checkpoint --------------------------------------------------------

    def _state(self, step) -> dict:
        return {"params": self.params, "opt_state": self.opt_state, "global_step": step}

    def save(self, path: Optional[str] = None) -> str:
        """Write the module, the optimizer and the step to ``path``
        (default ``checkpoint_dir/step_<global_step>``)."""
        path = path or os.path.join(self.checkpoint_dir or ".", f"step_{self.global_step}")
        t0 = time.perf_counter()
        save_checkpoint(path, self._state(self.global_step))
        self._last_checkpoint = path
        dt = time.perf_counter() - t0
        self._t_checkpoint += dt
        self.metrics["checkpoints_total"] += 1
        self.flight.record("checkpoint", step=self.global_step, path=path,
                           seconds=round(dt, 3))
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
        Slots the step places itself (``state_placement_on``: a placed
        8-bit AdamW's blockwise arrays, ZeRO-2's ``dp`` slices) go where
        its rule puts them on the new mesh; a ZeRO-2 step hands the
        optimizer its parameters back, and the new step slices them again.
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
        collectives and the seconds; the flight recorder gets
        ``reshard_start`` / ``reshard_done`` (the latter with the wire bytes
        the migration booked).  The migration's collectives are booked into
        ``comm_profile`` (``parallel.reshard``'s closed forms).  Returns
        the mode."""
        from .parallel import collectives
        from .parallel.reshard import (can_reshard_live, optimizer_state_tree, reshard,
                                       reshard_via_checkpoint, reshard_wire_bytes,
                                       state_targets, write_back)

        step = self.step
        old_mesh = getattr(step, "mesh", None)
        kind = getattr(failure, "kind", "device_loss")
        if old_mesh is None or not hasattr(step, "with_mesh"):
            raise StepFailure(kind, f"{failure} (and the step carries no mesh to reshard)")
        if mesh is None:
            mesh = self._shrunk_mesh(old_mesh, getattr(failure, "n_lost", None) or 1)
        t0 = time.perf_counter()
        self.flight.record("reshard_start", step=self.global_step,
                           mesh_from=dict(old_mesh.shape), mesh_to=dict(mesh.shape))
        sent = dict(collectives.payload_bytes)
        model, opt = step.model, step.optimizer
        tree = {"params": dict(model.named_parameters()),
                "opt_state": optimizer_state_tree(opt, model)}
        slot_target = getattr(step, "state_placement_on", None)
        targets = state_targets(tree, step.placement_on(mesh),
                                slot_target(mesh) if slot_target is not None else None)
        live = can_reshard_live(tree, mesh)
        wire = reshard_wire_bytes(tree, targets) if live else 0
        migration = CommProfile()
        with comm_audit(self.comm_profile), comm_audit(migration):
            if live:
                new = reshard(tree, targets)
            else:
                path = os.path.join(self.checkpoint_dir or ".", f"reshard_{self.global_step}")
                new = reshard_via_checkpoint(tree, path, targets)
        if mesh.is_member:
            write_back(model, opt, new)
            if getattr(step, "_zero2", None):
                step.release_zero2_slices()  # the new step slices them again
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
        self.flight.record("reshard_done", step=self.global_step,
                           mesh_from=dict(old_mesh.shape), mesh_to=dict(mesh.shape),
                           mode=mode, wire_bytes=int(round(migration.wire_bytes())),
                           seconds=round(dt, 3))
        return mode

    def _stage_numerics(self) -> Optional[StagedDigests]:
        """The step's digests (``step.last_digests``) with their copy to the
        host queued, at a log boundary before the loss's sync."""
        digs = getattr(self.step, "last_digests", None)
        if digs is None:
            return None
        try:
            return StagedDigests([digs])
        except Exception:
            self.numerics_harvest_errors += 1
            return None

    def _harvest_numerics(self, staged: Optional[StagedDigests]) -> None:
        """Fold staged digests into ``numerics_book`` right after the loss
        was read: that sync came after the copy, so reading copies nothing
        and waits on nothing.  A failed harvest is counted, never raised."""
        if staged is None:
            return
        try:
            (tree,) = staged.read()
            self.numerics_book.update_tree(tree, step=self.global_step)
            from .obs.trace import get_tracer

            self.numerics_book.emit_counter_tracks(get_tracer())
        except Exception:
            self.numerics_harvest_errors += 1

    def _update_derived_metrics(self) -> None:
        """tokens/s, mfu, mfu_xla, flop_attribution and goodput from the
        latest window and the accumulated wall-time split; host only."""
        sps = self.metrics["steps_per_sec"]
        if sps and self.tokens_per_batch:
            tps = sps * self.tokens_per_batch
            self.metrics["tokens_per_sec"] = tps
            if self.flops_per_token:
                self.metrics["mfu"] = tps * self.flops_per_token / self.peak_flops
        card = self.cost_card
        if card is not None and card.flops and sps:
            self.metrics["mfu_xla"] = sps * card.flops / self.peak_flops
            self.metrics["flop_attribution"] = card.flop_attribution
        overhead = self._t_compile + self._t_checkpoint + self._t_rollback + self._t_reshard
        if self._t_productive + overhead > 0:
            self.metrics["goodput"] = self._t_productive / (self._t_productive + overhead)

    def _watch(self, name: str):
        """The stall-watchdog guard of one region (a no-op without one)."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.arm(name)

    def _safe_dump(self, reason: str) -> Optional[str]:
        """Dump the flight ring; telemetry I/O never turns a survivable
        incident, or the original exception, into a telemetry crash."""
        try:
            self.last_flight_dump = self.flight.dump(reason=reason)
        except Exception:
            pass
        return self.last_flight_dump

    def _card_device(self):
        """The step's device: its module's parameters' (None when the
        step's params are not a module)."""
        params = self.params
        if isinstance(params, torch.nn.Module):
            p = next(params.parameters(), None)
            if p is not None:
                return p.device
        return None

    def _card_scope(self):
        """The counted cost card around the first real step (one attempt;
        ``obs.cost.counted_card``), or a no-op with cards off.  The card
        lands in ``cost_card`` and ``obs.cost.default_book()`` when the
        step returns."""
        if not self._want_cost_card:
            return contextlib.nullcontext()
        self._want_cost_card = False
        from .obs.cost import counted_card

        analytic = (self.flops_per_token * self.tokens_per_batch
                    if self.flops_per_token and self.tokens_per_batch else None)
        return counted_card("trainer/step", device=self._card_device(),
                            analytic_flops=analytic, book=self.cost_book)

    def fit(self, batches: Iterable[Any], num_steps: Optional[int] = None) -> dict:
        """Run until ``global_step`` reaches ``num_steps`` (or the batches
        run out, or this rank leaves a shrinking mesh: ``departed``).
        Returns ``{"step", "loss"}``.  An exception, a ``StepFailure``
        under ``on_failure="raise"`` included, is recorded and dumps the
        flight ring before it propagates."""
        self.flight.record("fit_start", step=self.global_step, num_steps=num_steps,
                           rng_counter=_rng_counter())
        try:
            return self._fit(batches, num_steps)
        except BaseException as e:
            self.flight.record("exception", step=self.global_step,
                               error=f"{type(e).__name__}: {e}"[:300],
                               last_checkpoint=self._last_checkpoint)
            self._safe_dump(f"exception:{type(e).__name__}")
            raise

    def _fit(self, batches: Iterable[Any], num_steps: Optional[int]) -> dict:
        t_window = t_warm0 = time.perf_counter()
        window_steps = 0
        warmup_pending = not self._warmed
        loss = None
        it = iter(batches)
        while (num_steps is None or self.global_step < num_steps) and not self.departed:
            try:
                batch = next(it)
            except StopIteration:
                break
            if self._bb_on:
                self._last_batch_digest = batch_digest(batch)
                self.recorder.record("train_step", step=self.global_step,
                                     rng_counter=_rng_counter(),
                                     batch=self._last_batch_digest)
            scope = self._card_scope() if warmup_pending else contextlib.nullcontext()
            with scope as card, self._watch("trainer/step"), comm_audit(self.comm_profile):
                self.params, self.opt_state, loss = self.step(
                    self.params, self.opt_state, batch)
            if card is not None:
                self.cost_card = card
            self.global_step += 1
            window_steps += 1
            self.metrics["steps_total"] += 1
            if self.tokens_per_batch:
                self.metrics["tokens_total"] += self.tokens_per_batch
            if warmup_pending:
                with self._watch("trainer/warmup_sync"):
                    _sync(loss)
                warm_s = time.perf_counter() - t_warm0
                self._t_compile += warm_s
                self.flight.record("warmup", step=self.global_step, seconds=round(warm_s, 3),
                                   comm=self.comm_profile.digest())
                t_window = time.perf_counter()
                window_steps = 0
                warmup_pending = False
                self._warmed = True
            if self.global_step % self.log_every == 0 and window_steps > 0:
                staged = self._stage_numerics()
                with self._watch("trainer/step_sync"):
                    _sync(loss)
                dt = time.perf_counter() - t_window
                last_loss = float(loss)
                self._harvest_numerics(staged)
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
                        # the EARLIEST tap site whose nonfinite count went
                        # positive: where a NaN was born, not only the loss
                        self.flight.record("failure", step=failed_step,
                                           failure_kind=failure.kind, loss=last_loss,
                                           last_checkpoint=self._last_checkpoint,
                                           nonfinite_site=self.numerics_book.first_nonfinite_site())
                        t_rb = time.perf_counter()
                        rs0 = self._t_reshard
                        action = apply_failure_policy(self, failure, self.on_failure)
                        # reshard() books its own time: the buckets stay disjoint
                        self._t_rollback += max(0.0, time.perf_counter() - t_rb
                                                - (self._t_reshard - rs0))
                        self.flight.record("rollback", step=failed_step, action=action,
                                           restored_step=self.global_step,
                                           checkpoint=self._last_checkpoint,
                                           seconds=round(time.perf_counter() - t_rb, 3),
                                           nonfinite_site=self.numerics_book.first_nonfinite_site())
                        # the dump is the incident's evidence, written even
                        # though the run goes on
                        self._safe_dump(f"failure:{failure.kind}")
                        self.log_fn({"step": failed_step, "failure": failure.kind,
                                     "action": action,
                                     "resumed_from": self.global_step})
                        t_window = time.perf_counter()
                        window_steps = 0
                        continue
                self.metrics["loss"] = last_loss
                self.metrics["steps_per_sec"] = window_steps / dt
                self._t_productive += dt
                self._update_derived_metrics()
                out = {"step": self.global_step, "loss": round(last_loss, 6),
                       "steps_per_sec": round(window_steps / dt, 3)}
                if self.tokens_per_batch:
                    out["tokens_per_sec"] = round(
                        self.tokens_per_batch * window_steps / dt, 1)
                self._history.append(last_loss)
                self.flight.record("step", step=self.global_step, loss=last_loss,
                                   steps_per_sec=round(window_steps / dt, 3),
                                   window_s=round(dt, 4), rng_counter=_rng_counter(),
                                   comm=self.comm_profile.digest(),
                                   last_checkpoint=self._last_checkpoint,
                                   batch=self._last_batch_digest)
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
        final = float(loss) if loss is not None else float("nan")
        self.flight.record("fit_end", step=self.global_step,
                           loss=None if loss is None else final, rng_counter=_rng_counter())
        return {"step": self.global_step, "loss": final}

    # -- observability -----------------------------------------------------

    def metrics_collector(self, prefix: str = "tdx_train"):
        """An ``obs.metrics`` collector over this trainer's live metrics
        (``registry.register_collector(t.metrics_collector(), obj=t)``), the
        JAX loop's families: ``*_total`` counters for steps, tokens,
        checkpoints and failures, ``loss`` / ``steps_per_sec`` /
        ``tokens_per_sec`` / ``mfu`` / ``mfu_xla`` / ``flop_attribution`` /
        ``goodput`` / ``global_step`` gauges from the latest log boundary,
        the numerics book's families once it has harvested, and, with a
        failure detector, its ``consecutive_nonfinite`` and per-kind
        ``failure_events_total``.  Holds the trainer by weak reference."""
        import weakref

        from .obs.metrics import MetricFamily

        ref = weakref.ref(self)  # don't pin the trainer in a registry

        def collect():
            self = ref()
            if self is None:
                return []
            m = self.metrics
            fams = []
            for name in ("steps_total", "tokens_total", "checkpoints_total", "failures_total"):
                fams.append(MetricFamily(f"{prefix}_{name}", "counter").add(m[name]))
            fams.append(MetricFamily(f"{prefix}_global_step", "gauge").add(self.global_step))
            for name in ("loss", "steps_per_sec", "tokens_per_sec", "mfu", "mfu_xla",
                         "flop_attribution", "goodput"):
                if m[name] is not None:
                    fams.append(MetricFamily(f"{prefix}_{name}", "gauge").add(m[name]))
            book = self.numerics_book
            if book is not None and book.harvests:
                fams.extend(book.collector(prefix=f"{prefix}_numerics")())
            det = self.failure_detector
            if det is not None:
                fams.append(MetricFamily(f"{prefix}_consecutive_nonfinite", "gauge")
                            .add(det.consecutive_nonfinite))
                ev = MetricFamily(
                    f"{prefix}_failure_events_total", "counter",
                    "detector-observed failure events by kind (incl. tolerated ones "
                    "that have not tripped the policy)")
                counts = det.counts_by_kind()
                for kind in sorted(counts):
                    ev.add(counts[kind], kind=kind)
                if not counts:
                    ev.add(0.0)
                fams.append(ev)
            return fams

        return collect
