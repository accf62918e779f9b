"""Deterministic open-loop traffic generator for the serving fleet,
counterpart of ``torchdistx_tpu/serve/workload.py`` (copied: host only).

A CLOSED-loop workload submits the next request when the client decides
to, so the arrival process adapts to the system under test and tail
latency is understated (coordinated omission).  :func:`generate` is the
OPEN alternative: a discrete-event scenario where request ``k`` arrives
at a pre-computed integer ``arrival_tick`` regardless of how the fleet is
doing, which is the load shape an autoscaler
(:mod:`~torchdistx_tpu_torch.serve.autoscale`) must be judged under.

Determinism contract: EVERY sample — per-tick Poisson thinning, Zipf
prefix-group choice, prompt tail tokens, length and output mixes — is
drawn from ``utils/rng.py``'s counter stream via
:func:`~torchdistx_tpu_torch.utils.rng.next_host_uniform` under
``rng_scope(spec.seed)``.  Same :class:`ScenarioSpec` ⇒ bit-identical
request list on every platform, and the JAX package's list bit for bit
(the stream is the same SHA-256 counter), so request counts, routing
decisions and scale events are exact pins.

Arrival-rate modulation composes multiplicatively on ``base_rate``:
``diurnal_*`` (sinusoidal day curve), ``burst_*`` (periodic square-wave
bursts), and ``flash_*`` (a one-off flash crowd: a sustained multiplier
over ``[flash_tick, flash_tick + flash_len)``).  The :data:`SCENARIOS`
catalog names the four canonical shapes autoscaling is judged
under: ``poisson``, ``diurnal``, ``bursty``, ``flash_crowd``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.rng import next_host_uniform, rng_scope

__all__ = [
    "ScenarioSpec",
    "SyntheticRequest",
    "SCENARIOS",
    "scenario",
    "generate",
    "workload_counters",
]


@dataclass(frozen=True)
class ScenarioSpec:
    """One fully-specified traffic scenario (frozen: a spec IS its
    fingerprint).  Rates are in requests per fleet tick; lengths in
    tokens.  ``deadline_ticks`` is the per-request SLO attainment is
    scored against (finish_tick - arrival_tick <= deadline_ticks)."""

    name: str
    seed: int = 0
    horizon_ticks: int = 40
    base_rate: float = 1.0
    n_groups: int = 4
    zipf_alpha: float = 1.2
    prefix_len: int = 16
    tail_lens: Tuple[int, ...] = (4, 8)
    tail_weights: Tuple[float, ...] = (0.75, 0.25)
    output_lens: Tuple[int, ...] = (8, 16)
    output_weights: Tuple[float, ...] = (0.75, 0.25)
    deadline_ticks: int = 10
    vocab: int = 256
    # -- rate modulation (all optional, multiplicative) -------------------
    diurnal_period: int = 0  # ticks per "day"; 0 = off
    diurnal_depth: float = 0.8  # peak-to-mean swing in (0, 1]
    burst_period: int = 0  # ticks between burst starts; 0 = off
    burst_len: int = 0
    burst_mult: float = 1.0
    flash_tick: int = -1  # first tick of the flash crowd; <0 = off
    flash_len: int = 0
    flash_mult: float = 1.0

    def __post_init__(self):
        if self.horizon_ticks < 1:
            raise ValueError("horizon_ticks must be >= 1")
        if self.n_groups < 1:
            raise ValueError("n_groups must be >= 1")
        if len(self.tail_lens) != len(self.tail_weights):
            raise ValueError("tail_lens / tail_weights length mismatch")
        if len(self.output_lens) != len(self.output_weights):
            raise ValueError("output_lens / output_weights length mismatch")
        if self.base_rate < 0:
            raise ValueError("base_rate must be >= 0")

    def rate_at(self, tick: int) -> float:
        """The instantaneous arrival rate at ``tick`` — the closed-form
        every generator draw thins against (pure, so tests can pin the
        shape without generating)."""
        rate = self.base_rate
        if self.diurnal_period > 0:
            phase = 2.0 * math.pi * tick / self.diurnal_period
            rate *= 1.0 + self.diurnal_depth * math.sin(phase)
        if self.burst_period > 0 and self.burst_len > 0:
            if tick % self.burst_period < self.burst_len:
                rate *= self.burst_mult
        if (
            self.flash_tick >= 0
            and self.flash_tick <= tick < self.flash_tick + self.flash_len
        ):
            rate *= self.flash_mult
        return max(0.0, rate)

    @property
    def max_prompt_len(self) -> int:
        return self.prefix_len + max(self.tail_lens)

    @property
    def max_output_len(self) -> int:
        return max(self.output_lens)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in (
            "tail_lens",
            "tail_weights",
            "output_lens",
            "output_weights",
        ):
            d[k] = list(d[k])
        return d


@dataclass(frozen=True)
class SyntheticRequest:
    """One generated arrival.  ``index`` is the submission order (also
    the engine sampling seed, so replays stay per-request deterministic
    at any temperature); ``group`` names the Zipf prefix group the
    prompt shares its head with."""

    index: int
    arrival_tick: int
    group: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline_ticks: int

    def submit_kwargs(self) -> dict:
        """Engine/fleet ``submit()`` kwargs (the prompt is copied so an
        engine can never alias the scenario's canonical arrays)."""
        return {
            "prompt": np.array(self.prompt, dtype=np.int32),
            "max_new_tokens": int(self.max_new_tokens),
            "temperature": 0.0,
            "seed": int(self.index),
        }


def _poisson(rate: float) -> int:
    """Knuth inversion from the counter stream (rates here are O(10) per
    tick, where inversion is exact and cheap)."""
    if rate <= 0.0:
        return 0
    limit = math.exp(-rate)
    n, acc = 0, next_host_uniform()
    while acc > limit:
        n += 1
        acc *= next_host_uniform()
    return n


def _choice(weights: Sequence[float]) -> int:
    total = float(sum(weights))
    u = next_host_uniform() * total
    acc = 0.0
    for i, w in enumerate(weights):
        acc += float(w)
        if u < acc:
            return i
    return len(weights) - 1


def _tokens(n: int, vocab: int) -> np.ndarray:
    return np.array(
        [int(next_host_uniform() * vocab) for _ in range(n)],
        dtype=np.int32,
    )


def _zipf_weights(n: int, alpha: float) -> List[float]:
    return [1.0 / (k ** alpha) for k in range(1, n + 1)]


def generate(spec: ScenarioSpec) -> List[SyntheticRequest]:
    """Materialize the scenario: the full arrival list, ordered by
    ``(arrival_tick, index)``.  Every draw comes from the counter stream
    under ``rng_scope(spec.seed)`` — the caller's ambient RNG stream is
    untouched, and two calls with the same spec return bit-identical
    requests (prompts included)."""
    with rng_scope(spec.seed):
        prefixes = [
            _tokens(spec.prefix_len, spec.vocab)
            for _ in range(spec.n_groups)
        ]
        zipf = _zipf_weights(spec.n_groups, spec.zipf_alpha)
        out: List[SyntheticRequest] = []
        for tick in range(spec.horizon_ticks):
            for _ in range(_poisson(spec.rate_at(tick))):
                group = _choice(zipf)
                tail = _tokens(
                    spec.tail_lens[_choice(spec.tail_weights)], spec.vocab
                )
                out.append(
                    SyntheticRequest(
                        index=len(out),
                        arrival_tick=tick,
                        group=group,
                        prompt=np.concatenate([prefixes[group], tail]),
                        max_new_tokens=spec.output_lens[
                            _choice(spec.output_weights)
                        ],
                        deadline_ticks=spec.deadline_ticks,
                    )
                )
    return out


def workload_counters(requests: Sequence[SyntheticRequest]) -> Dict[str, int]:
    """The scenario's integer invariants as exactly pinnable counters:
    request volume, token volume, group spread, and the
    arrival envelope.  Deterministic by construction — no wall clock,
    no floats."""
    groups = {r.group for r in requests}
    peak: Dict[int, int] = {}
    for r in requests:
        peak[r.arrival_tick] = peak.get(r.arrival_tick, 0) + 1
    return {
        "workload_requests": len(requests),
        "workload_prompt_tokens": int(
            sum(int(r.prompt.size) for r in requests)
        ),
        "workload_output_token_budget": int(
            sum(int(r.max_new_tokens) for r in requests)
        ),
        "workload_groups_touched": len(groups),
        "workload_peak_arrivals_per_tick": max(peak.values(), default=0),
        "workload_last_arrival_tick": max(
            (r.arrival_tick for r in requests), default=0
        ),
    }


#: The scenario catalog, the JAX package's.  Sized for tiny-model
#: engines with tick-based SLOs; rescale via :func:`scenario` overrides.
SCENARIOS: Dict[str, ScenarioSpec] = {
    "poisson": ScenarioSpec(name="poisson", seed=11, base_rate=1.0),
    "diurnal": ScenarioSpec(
        name="diurnal",
        seed=12,
        base_rate=1.4,
        horizon_ticks=72,
        diurnal_period=36,
        diurnal_depth=0.93,
        # a day curve ramps (unlike the flash crowd's step), so the SLO
        # tolerates the policy's deliberate up-sustain lag at peak
        # onset; the deep trough is where autoscaling wins its cost back
        deadline_ticks=16,
    ),
    "bursty": ScenarioSpec(
        name="bursty",
        seed=13,
        base_rate=0.6,
        burst_period=14,
        burst_len=4,
        burst_mult=5.0,
    ),
    "flash_crowd": ScenarioSpec(
        name="flash_crowd",
        seed=14,
        base_rate=0.5,
        flash_tick=12,
        flash_len=8,
        flash_mult=7.0,
    ),
}


def scenario(name: str, **overrides) -> ScenarioSpec:
    """Look up a catalog scenario, optionally overriding fields (e.g.
    ``scenario("bursty", seed=99)`` for a fresh replica of the same
    shape)."""
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; catalog: {sorted(SCENARIOS)}"
        )
    spec = SCENARIOS[name]
    return dataclasses.replace(spec, **overrides) if overrides else spec
