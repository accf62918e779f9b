from .engine import ServeEngine
from .kv_cache import SlotKVCache, write_slot
from .metrics import Histogram, ServeMetrics
from .scheduler import Request, RequestHandle, RequestResult, Scheduler

__all__ = [
    "ServeEngine",
    "SlotKVCache",
    "write_slot",
    "Histogram",
    "ServeMetrics",
    "Request",
    "RequestHandle",
    "RequestResult",
    "Scheduler",
]
