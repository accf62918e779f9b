"""Dispatch-stall watchdog: turn a hung host sync into an artifact.
Counterpart of ``torchdistx_tpu/obs/watchdog.py``, copied: it runs on the
host only.

A device dispatch or its host sync that never returns hangs the process
inside a C call where no in-process handler fires, and an outside kill
erases every trace of WHAT was in flight.  :class:`DispatchWatchdog`
answers that from a side thread: ``arm(name)`` around every region that
blocks on the device (the serve engine's prefill and decode dispatch
plus its sync) starts a deadline timer; normal exit cancels it; expiry —
which CAN fire while the main thread is stuck in C — records a ``stall``
event naming the in-flight program (plus its
:class:`~torchdistx_tpu_torch.obs.cost.CostCard`, when a book holds one)
and dumps the flight recorder ring atomically.  The kill still happens;
the dump survives it.

Unit-testable without stalls: the timer factory is injectable
(``timer=``), so tests drive expiry from a fake timer under a fake
clock instead of sleeping.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, Optional

__all__ = ["DispatchWatchdog"]


class DispatchWatchdog:
    """Deadline timer around device-blocking regions.

    Args:
      timeout_s: seconds an armed region may run before it is declared
        stalled.
      flight: the :class:`~torchdistx_tpu_torch.obs.flight.FlightRecorder` to
        record into and dump on expiry (default: the process-wide one).
      book: optional :class:`~torchdistx_tpu_torch.obs.cost.CostBook` — a
        stall dump then embeds the in-flight program's cost card, so
        the postmortem says not just *which* program wedged but what
        the compiler built for it (FLOPs, temp/peak bytes).
      clock: monotonic time source (injectable for tests).
      timer: ``timer(interval, fn) -> obj`` with ``start()``/
        ``cancel()`` (default ``threading.Timer``; injectable for
        tests — a fake timer calls ``fn`` to simulate expiry).
    """

    def __init__(
        self,
        timeout_s: float,
        *,
        flight: Optional[Any] = None,
        book: Optional[Any] = None,
        clock=time.monotonic,
        timer=threading.Timer,
    ) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self._flight = flight
        self._book = book
        self._clock = clock
        self._timer_factory = timer
        self._lock = threading.Lock()
        self._timer = None
        self._armed_at: Optional[float] = None
        self.last_program: Optional[str] = None
        self.stalls_total = 0
        self.last_dump_path: Optional[str] = None

    def _get_flight(self):
        if self._flight is not None:
            return self._flight
        from .flight import get_flight_recorder

        return get_flight_recorder()

    @contextlib.contextmanager
    def arm(self, program: str) -> Iterator[None]:
        """Deadline-guard the body as ``program``.  Re-entrant arms are
        not supported (the engine arms serially); the newest
        arm wins the ``last_program`` attribution either way."""
        with self._lock:
            self.last_program = program
            self._armed_at = self._clock()
            t = self._timer_factory(self.timeout_s, self._expire)
            self._timer = t
        t.start()
        try:
            yield
        finally:
            with self._lock:
                if self._timer is t:
                    self._timer = None
                    self._armed_at = None
            t.cancel()

    def _expire(self) -> None:
        """Timer thread: the armed region overran its deadline.  Record
        the stall (program name + cost card + how long it has been
        armed) and dump the ring — telemetry I/O failures are swallowed
        (the black box must never add a second crash)."""
        with self._lock:
            program = self.last_program
            armed_at = self._armed_at
            self.stalls_total += 1
        armed_s = (
            None if armed_at is None else round(self._clock() - armed_at, 3)
        )
        try:
            flight = self._get_flight()
            card = self._book.get(program) if self._book else None
            flight.record(
                "stall",
                program=program,
                armed_s=armed_s,
                timeout_s=self.timeout_s,
                cost_card=card.to_json() if card is not None else None,
            )
            self.last_dump_path = flight.dump(
                reason=f"watchdog_stall:{program}"
            )
        except Exception:
            pass
