"""Closed-loop fleet autoscaler: burn-state signals in, scale events out.
Counterpart of ``torchdistx_tpu/serve/autoscale.py`` (copied: host code
over the port's fleet).

The fleet is OBSERVABLE (multi-window burn rates, attainment,
per-replica occupancy) and ACTUATABLE (zero-drop ``drain``/``remove``,
warmed ``add``, prefill/decode roles).  This module is the loop between
the two: a declarative :class:`ScalingPolicy` evaluated by an
:class:`AutoscaleController` once per fleet tick, mapping sustained
``warn``/``page`` burn states to capacity adds (a fresh replica via the
engine factory, or re-roling an idle prefill replica to decode) and
sustained ``ok``-plus-headroom to a drain-and-remove of the coldest
replica through the zero-drop migration path.

Every decision — holds included — is emitted as a structured
``("scale", ts, {...})`` event into ``fleet.events`` carrying the FULL
signal vector it was made from (burn state per window, attainment,
per-replica headroom/pages/queue-depth, sustain runs, cooldown state),
mirrored into the flight recorder, and counted by ``tdx_autoscale_*``
Prometheus families (:meth:`AutoscaleController.collector`) — a scaling
decision is as auditable as a collective.

Signals are PLUGGABLE, and that is the determinism story: the default
:class:`LoadSignal` derives burn states from tick-windowed queue/slot
pressure — pure arithmetic over scheduler gauges, so a seeded scenario
(:mod:`~torchdistx_tpu_torch.serve.workload`) replays to bit-identical
decisions and scale-event counts are exact pins.
:func:`slo_burn_signal` is the production variant: it reads the real
``obs/slo.py`` burn report (wall-clock latencies — honest, but not
pinnable).  Tests replay explicit signal vectors through
:func:`replay_signal`.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from .fleet import ServeFleet, _load_key, replica_signals

__all__ = [
    "ScalingPolicy",
    "AutoscaleController",
    "LoadSignal",
    "slo_burn_signal",
    "replay_signal",
]

_STATES = ("ok", "warn", "page")


@dataclass(frozen=True)
class ScalingPolicy:
    """The declarative scaling rules (frozen: a policy IS its
    fingerprint, serialized verbatim into every scale event).

    Hysteresis is ASYMMETRIC by default: scaling up takes
    ``up_sustain`` consecutive non-``ok`` ticks, scaling down takes
    ``down_sustain`` (>  ``up_sustain``) consecutive idle-``ok`` ticks,
    and each action arms its own cooldown — so an oscillating signal
    adds capacity fast, sheds it slowly, and never flaps
    (the tests pin this)."""

    min_replicas: int = 1
    max_replicas: int = 3
    windows: Tuple[int, ...] = (2, 8)  # burn lookback windows, in ticks
    up_threshold: float = 1.0  # window-mean pressure that burns
    down_threshold: float = 0.5  # long-window pressure ceiling for down
    up_sustain: int = 2
    down_sustain: int = 6
    up_cooldown: int = 3
    down_cooldown: int = 8
    prefer_rerole: bool = True  # re-role an idle prefill replica first

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        ws = tuple(int(w) for w in self.windows)
        if not ws or any(w < 1 for w in ws) or list(ws) != sorted(set(ws)):
            raise ValueError(
                f"windows must be ascending positive ticks, got {ws}"
            )
        object.__setattr__(self, "windows", ws)
        if self.up_sustain < 1 or self.down_sustain < 1:
            raise ValueError("sustain counts must be >= 1")
        if self.up_cooldown < 0 or self.down_cooldown < 0:
            raise ValueError("cooldowns must be >= 0")

    @classmethod
    def default(cls) -> "ScalingPolicy":
        return cls()

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["windows"] = list(self.windows)
        return d

    @classmethod
    def from_json(cls, obj) -> "ScalingPolicy":
        """Accepts a dict, a JSON string, a path to a JSON file, or the
        catalog name ``"default"``."""
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, str):
            if obj == "default":
                return cls.default()
            if obj.lstrip().startswith("{"):
                obj = json.loads(obj)
            else:
                with open(obj) as f:
                    obj = json.load(f)
        if not isinstance(obj, dict):
            raise TypeError(f"cannot build a ScalingPolicy from {obj!r}")
        if "windows" in obj:
            obj = {**obj, "windows": tuple(obj["windows"])}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(
                f"unknown ScalingPolicy field(s) {sorted(unknown)}"
            )
        return cls(**obj)


def _replica_vector(fleet: ServeFleet) -> List[dict]:
    """Per-replica slice of the signal vector: live router-facing load
    signals (the same ``replica_signals`` the routing tie-break reads),
    labeled by rid/role."""
    return [
        {
            "replica": rep.rid,
            "role": rep.role,
            "routed": rep.routed,
            **replica_signals(rep.engine),
        }
        for rep in fleet.replicas
    ]


class LoadSignal:
    """The default (deterministic) signal: burn states derived from
    tick-windowed queue/slot pressure of the routed role.

    ``pressure(t) = (queued + active) / slots`` across the decode-side
    replicas — > 1 means arrivals are backing up beyond capacity, the
    tick-domain analog of an SLO latency burn.  Each policy window's
    "burn rate" is the mean pressure over its lookback; a window burns
    when that mean exceeds ``up_threshold``.  State rolls up exactly
    like ``obs/slo.py``: ``page`` when ALL windows burn, ``warn`` when
    any does, else ``ok`` — so the policy's state machine is identical
    under this signal and the production SLO signal.  Pure arithmetic
    over scheduler gauges: a seeded scenario replays to bit-identical
    states (no wall clock anywhere)."""

    def __init__(self, policy: ScalingPolicy):
        self.policy = policy
        self._history: List[float] = []

    def __call__(self, fleet: ServeFleet) -> dict:
        role = "decode" if fleet.disaggregate else "serve"
        reps = [r for r in fleet.replicas if r.role == role]
        slots = sum(r.engine.num_slots for r in reps)
        backlog = sum(
            r.engine.scheduler.queue_depth + len(r.engine.scheduler.running)
            for r in reps
        )
        pressure = backlog / max(1, slots)
        self._history.append(pressure)
        windows = []
        for w in self.policy.windows:
            tail = self._history[-w:]
            rate = sum(tail) / len(tail)
            windows.append(
                {
                    "ticks": w,
                    "rate": round(rate, 6),
                    "burning": rate > self.policy.up_threshold,
                }
            )
        burning = [w for w in windows if w["burning"]]
        state = (
            "page"
            if burning and len(burning) == len(windows)
            else "warn"
            if burning
            else "ok"
        )
        long_rate = windows[-1]["rate"]
        return {
            "source": "load",
            "state": state,
            "pressure": round(pressure, 6),
            "windows": windows,
            "attainment": None,
            "headroom_ok": long_rate <= self.policy.down_threshold,
            "replicas": _replica_vector(fleet),
        }


def slo_burn_signal(spec, *, policy=None) -> Callable[[ServeFleet], dict]:
    """The production signal: evaluate the real ``obs/slo.py`` spec over
    the fleet's finished requests each tick and project the report's
    burn block into the controller's signal shape.  Wall-clock based —
    use for live deployments; pinned runs use :class:`LoadSignal`."""
    from ..obs.slo import evaluate_slo

    def signal(fleet: ServeFleet) -> dict:
        report = evaluate_slo(
            spec, fleet.finished_requests(), policy=policy
        )
        burn = report.get("burn") or {}
        windows = [
            {
                "ticks": None,
                "seconds": w.get("window_s"),
                "rate": w.get("burn_rate"),
                "burning": bool(w.get("burning")),
            }
            for w in burn.get("windows") or []
        ]
        return {
            "source": "slo",
            "state": burn.get("state") or "ok",
            "pressure": None,
            "windows": windows,
            "attainment": (report.get("attainment") or {}).get("overall"),
            "headroom_ok": (burn.get("state") or "ok") == "ok",
            "replicas": _replica_vector(fleet),
        }

    return signal


def replay_signal(vectors: Sequence[dict]) -> Callable[[ServeFleet], dict]:
    """Feed a pre-recorded signal-vector sequence through the controller
    — the unit-test surface for pinning decisions (and for replaying a
    production incident's vectors against a candidate policy).  Repeats
    the last vector once the sequence is exhausted."""
    vectors = [dict(v) for v in vectors]
    if not vectors:
        raise ValueError("replay_signal needs at least one vector")
    it = iter(range(len(vectors)))

    def signal(fleet: ServeFleet) -> dict:
        i = next(it, len(vectors) - 1)
        v = dict(vectors[i])
        v.setdefault("source", "replay")
        v.setdefault("headroom_ok", v.get("state") == "ok")
        v.setdefault("windows", [])
        v.setdefault("attainment", None)
        v.setdefault("replicas", _replica_vector(fleet))
        return v

    return signal


class AutoscaleController:
    """Evaluates one :class:`ScalingPolicy` against one fleet, once per
    tick (call :meth:`tick` right after ``fleet.step()``).

    ``engine_factory(role)`` builds a fresh replica for scale-ups
    (``fleet.add`` warms it through every reachable compiled program
    before it enters rotation, so the first routed request never eats a
    compile stall); without a factory, scale-ups can only re-role.  The
    scale-down victim is the COLDEST eligible replica — maximal
    ``_load_key`` headroom, i.e. the one whose removal perturbs the
    least work — removed via the zero-drop ``fleet.remove`` path.
    """

    def __init__(
        self,
        fleet: ServeFleet,
        policy: Optional[ScalingPolicy] = None,
        *,
        engine_factory: Optional[Callable[[str], object]] = None,
        signal_fn: Optional[Callable[[ServeFleet], dict]] = None,
        flight: bool = True,
    ):
        self.fleet = fleet
        self.policy = policy or ScalingPolicy.default()
        self.engine_factory = engine_factory
        self.signal_fn = signal_fn or LoadSignal(self.policy)
        self.flight = flight
        if getattr(fleet, "_bb_on", False):
            # the session black box: the policy is part of the recorded
            # outside world; replay rebuilds this controller from it and
            # re-drives the recorded signal vectors (replay_signal)
            fleet.recorder.record("autoscale", policy=self.policy.to_json())
        self.counters = {
            "autoscale_decisions": 0,
            "autoscale_scale_ups": 0,
            "autoscale_scale_downs": 0,
            "autoscale_reroles": 0,
            "autoscale_holds": 0,
            "autoscale_cooldown_holds": 0,
            "autoscale_replica_ticks": 0,
        }
        self._up_run = 0
        self._down_run = 0
        self._cooldown = 0
        self._last_state = "ok"

    # -- the scaled role ---------------------------------------------------

    def _role(self) -> str:
        return "decode" if self.fleet.disaggregate else "serve"

    def _role_replicas(self):
        role = self._role()
        return [r for r in self.fleet.replicas if r.role == role]

    # -- one tick ----------------------------------------------------------

    def tick(self) -> dict:
        """Evaluate the policy once and execute at most one action;
        returns the emitted decision data (also appended to
        ``fleet.events`` and the flight recorder)."""
        pol = self.policy
        sig = self.signal_fn(self.fleet)
        state = sig.get("state", "ok")
        if state not in _STATES:
            raise ValueError(f"signal state {state!r} not in {_STATES}")
        self._last_state = state
        self.counters["autoscale_decisions"] += 1
        self.counters["autoscale_replica_ticks"] += len(
            self.fleet.replicas
        )
        if state != "ok":
            self._up_run += 1
            self._down_run = 0
        elif sig.get("headroom_ok"):
            self._down_run += 1
            self._up_run = 0
        else:
            self._up_run = 0
            self._down_run = 0
        n = len(self._role_replicas())
        want_up = self._up_run >= pol.up_sustain and n < pol.max_replicas
        want_down = (
            self._down_run >= pol.down_sustain and n > pol.min_replicas
        )
        action, mode, replica, reason = "hold", None, None, "steady"
        if self._cooldown > 0:
            if want_up or want_down:
                reason = (
                    f"cooldown ({self._cooldown} tick(s) left) suppressed "
                    f"{'scale_up' if want_up else 'scale_down'}"
                )
                self.counters["autoscale_cooldown_holds"] += 1
            self._cooldown -= 1
        elif want_up:
            action, mode, replica, reason = self._scale_up()
        elif want_down:
            action, mode, replica, reason = self._scale_down()
        elif self._up_run or self._down_run:
            side = "up" if self._up_run else "down"
            need = pol.up_sustain if self._up_run else pol.down_sustain
            run = self._up_run or self._down_run
            reason = f"sustaining {side} ({run}/{need} tick(s))"
        if action == "hold":
            self.counters["autoscale_holds"] += 1
        data = {
            "tick": self.fleet.tick,
            "action": action,
            "mode": mode,
            "replica": replica,
            "role": self._role(),
            "reason": reason,
            "replicas_before": n,
            "replicas_after": len(self._role_replicas()),
            "sustain": {"up": self._up_run, "down": self._down_run},
            "cooldown_remaining": self._cooldown,
            "policy": pol.to_json(),
            "signal": sig,
        }
        self.fleet.events.append(("scale", time.monotonic(), data))
        if getattr(self.fleet, "_bb_on", False):
            # an outside event (the live signal vector is the controller's
            # whole outside world) and the decision's attribution: replay
            # compares the (tick, action, replica) streams exactly
            self.fleet.recorder.record("ctrl_tick", tick=data["tick"], action=action,
                                       mode=mode, replica=replica,
                                       reason=data["reason"], signal=sig)
        if self.flight:
            from ..obs.flight import get_flight_recorder

            get_flight_recorder().record("scale", **data)
        return data

    # -- actions -----------------------------------------------------------

    def _scale_up(self):
        pol, fleet = self.policy, self.fleet
        if fleet.disaggregate and pol.prefer_rerole:
            idle = [
                r
                for r in fleet.replicas
                if r.role == "prefill"
                and not r.engine._draining
                and not r.engine.scheduler.has_work()
            ]
            prefills = [r for r in fleet.replicas if r.role == "prefill"]
            if idle and len(prefills) > 1:
                victim = max(idle, key=_load_key)
                fleet.reassign_role(victim.rid, "decode")
                self._up_run = 0
                self._cooldown = pol.up_cooldown
                self.counters["autoscale_scale_ups"] += 1
                self.counters["autoscale_reroles"] += 1
                return (
                    "scale_up",
                    "rerole",
                    victim.rid,
                    "sustained burn: re-roled idle prefill replica "
                    f"{victim.rid} to decode",
                )
        if self.engine_factory is None:
            return (
                "hold",
                None,
                None,
                "sustained burn but no engine_factory and no idle "
                "prefill replica to re-role",
            )
        role = self._role()
        rid = fleet.add(self.engine_factory(role), role=role)
        self._up_run = 0
        self._cooldown = pol.up_cooldown
        self.counters["autoscale_scale_ups"] += 1
        return (
            "scale_up",
            "add",
            rid,
            f"sustained burn: added warmed {role} replica {rid}",
        )

    def _scale_down(self):
        pol, fleet = self.policy, self.fleet
        cands = [
            r for r in self._role_replicas() if not r.engine._draining
        ]
        if len(cands) <= pol.min_replicas:
            return "hold", None, None, "at min_replicas"
        # coldest = maximal headroom (fewest active slots / queue, most
        # free pages): removing it migrates the least work.  Zero-drop
        # removal additionally needs the SURVIVORS to absorb the
        # victim's in-flight load — an unabsorbable victim is skipped,
        # and a tick with none holds WITHOUT burning cooldown or the
        # sustain run, so the scale-down retries as soon as load drains
        # (slot fit is the conservative check: queued work lands in
        # survivor queues, so a paged-geometry residual still raises
        # loudly from ``fleet.remove`` rather than dropping requests)
        for victim in sorted(cands, key=_load_key, reverse=True):
            load = len(victim.engine.scheduler.running) + (
                victim.engine.scheduler.queue_depth
            )
            if load <= sum(
                r.engine.scheduler.free_slot_count
                for r in cands
                if r.rid != victim.rid
            ):
                break
        else:
            return (
                "hold",
                None,
                None,
                "sustained headroom but no victim whose in-flight load "
                "fits the survivors' free slots",
            )
        self._down_run = 0
        self._cooldown = pol.down_cooldown
        fleet.remove(victim.rid)
        self.counters["autoscale_scale_downs"] += 1
        return (
            "scale_down",
            "remove",
            victim.rid,
            "sustained headroom: drained and removed coldest replica "
            f"{victim.rid} (zero-drop migration)",
        )

    # -- observability -----------------------------------------------------

    def metrics_json(self) -> dict:
        """Counters + live gauges (all integers — exact pins)."""
        return {
            "counters": dict(self.counters),
            "gauges": {
                "replicas": len(self._role_replicas()),
                "sustain_up": self._up_run,
                "sustain_down": self._down_run,
                "cooldown_remaining": self._cooldown,
                "burn_state": _STATES.index(self._last_state),
            },
        }

    def collector(self, prefix: str = "tdx_autoscale"):
        """An ``obs.metrics`` collector: the decision counters as
        ``{prefix}_*_total`` and the controller's live state (replica
        count, sustain runs, cooldown, last burn state as 0/1/2) as
        ``{prefix}_*`` gauges — register with
        ``registry.register_collector(ctrl.collector(), obj=ctrl)``."""
        import weakref

        from ..obs.metrics import MetricFamily

        ref = weakref.ref(self)

        def collect():
            ctrl = ref()
            if ctrl is None:
                return []
            j = ctrl.metrics_json()
            fams = []
            for name, v in j["counters"].items():
                short = name.replace("autoscale_", "", 1)
                fams.append(
                    MetricFamily(f"{prefix}_{short}_total", "counter").add(
                        v
                    )
                )
            for gname, v in j["gauges"].items():
                fams.append(
                    MetricFamily(f"{prefix}_{gname}", "gauge").add(v)
                )
            return fams

        return collect
