"""Continuous-batching serving, counterpart of ``torchdistx_tpu/serve``:
a slot-based or paged KV cache (:mod:`.kv_cache`), the page pool and
radix prefix index (:mod:`.prefix_cache`), the FCFS scheduler
(:mod:`.scheduler`), the engine with chunked or persistent decode,
chunked prefill, the HBM admission gate, drain, migration and handoff
(:mod:`.engine`), plain-dict metrics with a Prometheus projection
(:mod:`.metrics`), the prefix-affinity fleet over N engines with
disaggregation (:mod:`.fleet`), the closed-loop autoscaler
(:mod:`.autoscale`) and the deterministic open-loop traffic generator
(:mod:`.workload`).
"""

from .autoscale import (
    AutoscaleController,
    LoadSignal,
    ScalingPolicy,
    replay_signal,
    slo_burn_signal,
)
from .engine import ServeEngine
from .fleet import (
    AffinityPolicy,
    LeastLoadedPolicy,
    RoundRobinPolicy,
    ServeFleet,
)
from .kv_cache import PagedKVCache, SlotKVCache, write_slot
from .metrics import Histogram, ServeMetrics
from .prefix_cache import PagePool, RadixPrefixIndex
from .scheduler import Request, RequestHandle, RequestResult, Scheduler
from .workload import (
    SCENARIOS,
    ScenarioSpec,
    SyntheticRequest,
    generate,
    scenario,
    workload_counters,
)

__all__ = [
    "ServeEngine",
    "ServeFleet",
    "AffinityPolicy",
    "LeastLoadedPolicy",
    "RoundRobinPolicy",
    "AutoscaleController",
    "ScalingPolicy",
    "LoadSignal",
    "slo_burn_signal",
    "replay_signal",
    "ScenarioSpec",
    "SyntheticRequest",
    "SCENARIOS",
    "scenario",
    "generate",
    "workload_counters",
    "SlotKVCache",
    "PagedKVCache",
    "write_slot",
    "PagePool",
    "RadixPrefixIndex",
    "ServeMetrics",
    "Histogram",
    "Request",
    "RequestHandle",
    "RequestResult",
    "Scheduler",
]
