"""Device cost observatory: per-program cost cards.

Counterpart of ``torchdistx_tpu/obs/cost.py``.  The JAX card is XLA's
``cost_analysis`` and ``memory_analysis`` of a compiled program.  The port
has no compiled program: its card for a serving program (a prefill
bucket, cold or warm; the decode step of a ``decode_chunk``; the
persistent loop) is taken at that program's FIRST dispatch on the card,
from the CUDA caching allocator (:func:`begin_allocator_card`, then
:func:`finish_allocator_card`):
``torch.cuda.reset_peak_memory_stats`` before the dispatch, then
``max_memory_allocated`` (the card's ``peak_bytes``) and its excess over
``memory_allocated`` after it (``temp_bytes``: what the dispatch held
only while it ran).  The card names that source (``"cuda_allocator"``).
A probe resets the allocator's peak statistics: a caller that reads
``max_memory_allocated`` across a first dispatch sees only the peak since
the probe.

A **counted** card (:func:`compute_cost_card`, :func:`counted_card`; the
``Trainer``'s, taken on its first step) also counts FLOPs.  The port has
no compile-only path, so the program EXECUTES once under a dispatch mode
that counts the aten matrix products by
``torch.utils.flop_counter.FlopCounterMode``'s own per-op formulas, while
every kernel the port launches through ctypes (which no counter can see)
books its launch's FLOPs from its shapes, one formula per kernel
(``ops._cost``).  The mode runs every op as dispatched:
``FlopCounterMode`` itself decomposes the ops that have an implicit
decomposition (``silu_backward`` among them), which changes a step's bits,
and a counted step must train as an uncounted one does.  ``card.flops`` is the sum,
``kernel_flops`` the kernels' share, ``kernel_launches`` the launches by
wrapper, and ``flops_source`` names the source, ``"flop_counter+kernels"``
(as ``peak_source`` names the peak's).  On the CPU the wrappers run their
plain versions, which the counter sees, so the CPU and the card count the
same program.  The same mode counts ``bytes_accessed``: for each aten op,
the bytes of its tensor inputs (each read once) and of its tensor outputs
(each written once); an op whose outputs alias an input without writing
it (a view: ``view``, ``t``, ``detach``, ``expand``, ``as_strided``, ...,
by its schema's ``alias_info``) moves nothing, nor does one whose output
holds no values yet (``empty`` and its kin); each kernel launch adds the
bytes ``ops._cost`` books for it.  On the CPU a card has no allocator
peak.

Exports, as in the JAX package: :meth:`CostBook.collector` projects every
card as ``tdx_cost_*{program=...}`` gauges through an ``obs.metrics``
registry, and recording a card emits a counter-track sample on the
``obs.trace`` timebase (``cost/<program>``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Any, Dict, Iterator, List, Optional

from .._aten import UNINITIALIZED_OPS

__all__ = [
    "CostCard",
    "CostBook",
    "compute_cost_card",
    "counted_card",
    "default_book",
    "span_mfu",
    "begin_allocator_card",
    "finish_allocator_card",
    "cards_enabled",
    "force_disabled",
    "roofline",
    "validate_cost_card",
]

CARD_SCHEMA = "tdx-cost-v1"

#: ``flops_source`` of a counted card: the aten products FlopCounterMode
#: saw plus the kernels' formulas
COUNTED_FLOPS = "flop_counter+kernels"

#: the peak sources that are properties of a program, not of the load
_PROGRAM_PEAK_SOURCES = ("xla_peak", "arg+out+temp", "cuda_allocator")

#: the JAX card's deterministic numeric fields, the ledger's counter rows
_COUNTER_FIELDS = (
    "flops",
    "bytes_accessed",
    "transcendentals",
    "arg_bytes",
    "out_bytes",
    "temp_bytes",
)

#: peak sources a compiler's analysis gives: deterministic, so they gate
_ANALYSIS_PEAK_SOURCES = ("xla_peak", "arg+out+temp")

@dataclasses.dataclass
class CostCard:
    """What one program cost: FLOP and memory-traffic counts where
    something counted them (None otherwise), temp and peak bytes, and
    their provenance.  ``scope`` is the ``obs.recompile`` attribution
    scope active when the card was taken, so a card and the program
    counters name programs identically."""

    program: str
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    output_bytes_accessed: Optional[float] = None
    transcendentals: Optional[float] = None
    arg_bytes: Optional[int] = None
    out_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    peak_source: str = "unavailable"
    scope: Optional[str] = None
    platform: Optional[str] = None
    #: the analytic model's FLOP count for one execution of this program
    analytic_flops: Optional[float] = None
    #: what counted ``flops`` ("unavailable": nothing did)
    flops_source: str = "unavailable"
    #: of ``flops``, what the hand-written kernels' formulas booked
    kernel_flops: Optional[float] = None
    #: the kernel launches the count saw, by wrapper name
    kernel_launches: Optional[Dict[str, int]] = None

    @property
    def arithmetic_intensity(self) -> Optional[float]:
        if self.flops and self.bytes_accessed:
            return self.flops / self.bytes_accessed
        return None

    @property
    def flop_attribution(self) -> Optional[float]:
        """analytic / counted FLOPs; None where nothing counted them."""
        if self.analytic_flops and self.flops:
            return self.analytic_flops / self.flops
        return None

    def counter_fields(self) -> Dict[str, float]:
        """The deterministic numeric fields, prefixed ``cost_``: the ledger's
        counter rows for this card, by the JAX card's rule that a runtime
        watermark never gates.  The JAX card's ``temp_bytes`` is the
        compiler's buffer assignment; the port's comes from the caching
        allocator (``peak_source="cuda_allocator"``), a watermark of one
        dispatch that moves with what else the allocator holds, so on such
        a card it stays out, as its ``peak_bytes`` does.  A card whose peak
        a compiler's analysis gave keeps both, as JAX's does."""
        out: Dict[str, float] = {}
        for f in _COUNTER_FIELDS:
            if f == "temp_bytes" and self.peak_source == "cuda_allocator":
                continue
            v = getattr(self, f)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"cost_{f}"] = v
        if (isinstance(self.peak_bytes, (int, float))
                and self.peak_source in _ANALYSIS_PEAK_SOURCES):
            out["cost_peak_bytes"] = self.peak_bytes
        return out

    def to_json(self) -> dict:
        """The JAX card's JSON; a counted card adds ``flops_source``,
        ``kernel_flops`` and ``kernel_launches``."""
        d = {"schema": CARD_SCHEMA}
        d.update(dataclasses.asdict(self))
        if self.flops_source == "unavailable":
            for key in ("flops_source", "kernel_flops", "kernel_launches"):
                del d[key]
        d["arithmetic_intensity"] = self.arithmetic_intensity
        d["flop_attribution"] = self.flop_attribution
        return d


#: TDX_COST_CARDS spellings that mean OFF — one list for both probes
_OFF_VALUES = ("0", "false", "")


def _env_state() -> Optional[bool]:
    """TDX_COST_CARDS as a tri-state: None (unset), True (on), False
    (any off spelling, case-insensitive)."""
    v = os.environ.get("TDX_COST_CARDS")
    if v is None:
        return None
    return v.strip().lower() not in _OFF_VALUES


def cards_enabled(default: bool = False) -> bool:
    """The global opt-in for card capture at unbounded hook sites.
    Bounded-program components (the serve engine's per-bucket / per-K
    programs) take an explicit constructor flag instead and default ON —
    ``TDX_COST_CARDS=0`` force-disables those too."""
    state = _env_state()
    return default if state is None else state


def force_disabled() -> bool:
    """True when ``TDX_COST_CARDS`` is explicitly set to an off spelling:
    the kill switch that turns every capture site off."""
    return _env_state() is False


def _device_of(tree) -> Optional["torch.device"]:  # noqa: F821
    """The device of the first tensor (or module parameter) in ``tree``."""
    import torch

    leaves, _ = torch.utils._pytree.tree_flatten(tree)
    for leaf in leaves:
        if isinstance(leaf, torch.nn.Module):
            leaf = next(leaf.parameters(), None)
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


_PRODUCT_COUNTER = None


def _tensor_bytes(tree) -> int:
    import torch

    leaves, _ = torch.utils._pytree.tree_flatten(tree)
    return sum(x.numel() * x.element_size() for x in leaves if isinstance(x, torch.Tensor))


def _moves_bytes(func) -> bool:
    """False for an op that moves no bytes: a view (an output aliasing an
    input, not written) or an op whose output holds no values yet."""
    schema = func._schema
    if schema.name in UNINITIALIZED_OPS:
        return False
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)


def _product_counter():
    """A fresh dispatch mode whose ``flops`` adds, for every aten op that
    runs, ``FlopCounterMode``'s formula of that op (matrix products and
    convolutions; 0 for the rest), and whose ``bytes`` adds the bytes of
    its tensor inputs and outputs (0 for a view or an uninitialized
    output), the op executed exactly as dispatched."""
    global _PRODUCT_COUNTER
    if _PRODUCT_COUNTER is None:
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        class ProductCounter(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.bytes = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                count = flop_registry.get(func._overloadpacket)
                if count is not None:
                    self.flops += int(count(*args, **kwargs, out_val=out))
                if _moves_bytes(func):
                    self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
                return out

        _PRODUCT_COUNTER = ProductCounter
    return _PRODUCT_COUNTER()


@contextlib.contextmanager
def counted_card(name: str, *, device=None, analytic_flops: Optional[float] = None,
                 book: Optional["CostBook"] = None) -> Iterator[CostCard]:
    """Count what the body executes into the card it yields (module
    docstring): the aten products' FLOPs by ``FlopCounterMode``'s formulas
    plus the kernels' booked ones, the aten ops' and the kernels' bytes
    accessed, and on a CUDA ``device`` the allocator's
    peak and temp bytes
    (:func:`begin_allocator_card`, which resets the peak statistics).  The
    card is filled when the body ends, and with ``book`` recorded; a body
    that raises leaves it unfilled."""
    import torch

    from ..ops import _cost

    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        card = begin_allocator_card(name, device, analytic_flops=analytic_flops)
    else:
        from .recompile import current_scope

        card = CostCard(program=name, scope=current_scope(), analytic_flops=analytic_flops,
                        platform="cpu" if device is not None else None)
    counter = _product_counter()
    with counter, _cost.tally() as kernels:
        yield card
    card.kernel_flops = float(kernels.flops)
    card.kernel_launches = dict(kernels.launches)
    card.flops = float(counter.flops + kernels.flops)
    card.bytes_accessed = float(counter.bytes + kernels.bytes)
    card.flops_source = COUNTED_FLOPS
    if cuda:
        finish_allocator_card(card, device)
    if book is not None:
        book.record(card)


def compute_cost_card(fn: Any, *args: Any, name: str,
                      analytic_flops: Optional[float] = None,
                      book: Optional["CostBook"] = None, **kwargs: Any) -> CostCard:
    """The counted card of one call ``fn(*args, **kwargs)``, counterpart of
    the JAX function, which lowers and compiles only.  The port has no
    compile-only path: this EXECUTES ``fn`` once (a train step takes its
    step; pass copies where that matters) inside :func:`counted_card` on
    the device of the first tensor or module parameter in the arguments.
    With ``book`` the card is also recorded."""
    device = _device_of((args, kwargs))
    with counted_card(name, device=device, analytic_flops=analytic_flops, book=book) as card:
        fn(*args, **kwargs)
    return card


def begin_allocator_card(name: str, device, *,
                         analytic_flops: Optional[float] = None) -> CostCard:
    """Start the card of one dispatch on ``device``: reset the caching
    allocator's peak statistics (module docstring).  Dispatch, then
    :func:`finish_allocator_card`."""
    import torch

    from .recompile import current_scope

    card = CostCard(
        program=name,
        scope=current_scope(),
        analytic_flops=analytic_flops,
        platform="gpu",
    )
    torch.cuda.reset_peak_memory_stats(torch.device(device))
    return card


def finish_allocator_card(card: CostCard, device, *,
                          book: Optional["CostBook"] = None) -> CostCard:
    """Read the dispatch's peak and temp bytes into ``card`` and, with
    ``book``, record it."""
    import torch

    dev = torch.device(device)
    peak = int(torch.cuda.max_memory_allocated(dev))
    card.peak_bytes = peak
    card.temp_bytes = peak - int(torch.cuda.memory_allocated(dev))
    card.peak_source = "cuda_allocator"
    if book is not None:
        book.record(card)
    return card


class CostBook:
    """Per-program card store: the queryable runtime surface ("what did
    serve/decode/k4 hold?") plus the Prometheus projection.  Thread-safe;
    recording emits the card's Perfetto counter sample (no-op unless
    tracing is enabled)."""

    def __init__(self) -> None:
        self._cards: Dict[str, CostCard] = {}
        self._lock = threading.Lock()

    def record(self, card: CostCard) -> CostCard:
        with self._lock:
            self._cards[card.program] = card
        from .trace import get_tracer

        get_tracer().counter(
            f"cost/{card.program}",
            flops=float(card.flops or 0.0),
            bytes_accessed=float(card.bytes_accessed or 0.0),
            peak_bytes=float(card.peak_bytes or 0.0),
        )
        return card

    def get(self, program: str) -> Optional[CostCard]:
        with self._lock:
            return self._cards.get(program)

    def cards(self) -> Dict[str, CostCard]:
        with self._lock:
            return dict(self._cards)

    def __len__(self) -> int:
        with self._lock:
            return len(self._cards)

    def max_temp_bytes(self) -> int:
        """The worst per-program temp footprint on record — what the
        capacity planner charges as transient dispatch overhead (the
        programs run serially, so the max, not the sum)."""
        return max(
            (c.temp_bytes or 0 for c in self.cards().values()), default=0
        )

    def max_peak_bytes(self) -> int:
        return max(
            (
                c.peak_bytes or 0
                for c in self.cards().values()
                if c.peak_source in _PROGRAM_PEAK_SOURCES
            ),
            default=0,
        )

    def to_json(self) -> Dict[str, dict]:
        """``{program: card}``."""
        return {
            name: card.to_json()
            for name, card in sorted(self.cards().items())
        }

    def collector(self, prefix: str = "tdx_cost"):
        """An ``obs.metrics`` collector over the book: one labeled sample
        per card for flops / bytes-accessed / temp / peak, where the card
        has the value (the peak family carries its source label)."""
        import weakref

        from .metrics import MetricFamily

        ref = weakref.ref(self)  # never pin a discarded engine's book

        def collect():
            book = ref()
            if book is None:
                return []
            cards = book.cards()
            if not cards:
                return []
            fams = []
            specs = (
                ("flops", "flops", "counted FLOPs per execution"),
                ("bytes_accessed", "bytes_accessed",
                 "counted bytes accessed per execution"),
                ("temp_bytes", "temp_bytes",
                 "bytes held only while the program ran"),
            )
            for field, suffix, help_ in specs:
                fam = MetricFamily(f"{prefix}_{suffix}", "gauge", help_)
                for name in sorted(cards):
                    v = getattr(cards[name], field)
                    if v is not None:
                        fam.add(v, program=name)
                if fam.samples:
                    fams.append(fam)
            peak = MetricFamily(
                f"{prefix}_peak_bytes", "gauge",
                "per-program peak bytes (source labeled)",
            )
            for name in sorted(cards):
                c = cards[name]
                if c.peak_bytes is not None:
                    peak.add(
                        c.peak_bytes, program=name, source=c.peak_source
                    )
            if peak.samples:
                fams.append(peak)
            return fams

        return collect


_DEFAULT: Optional[CostBook] = None
_DEFAULT_LOCK = threading.Lock()


def default_book() -> CostBook:
    """Process-wide book for components without a natural owner (the
    trainer's step program).  Engine-owned books (``ServeEngine.cost_book``)
    stay separate so two engines' programs never collide."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = CostBook()
        return _DEFAULT


def span_mfu(
    card: CostCard,
    *,
    executions: int,
    seconds: Optional[float],
    peak_flops: Optional[float],
) -> Optional[float]:
    """Measured MFU of one program's span: counted FLOPs x how many times
    it ran, over the span's wall seconds and the card's peak.  None when
    any input is missing (no count, no peak, no time recorded)."""
    if not (card.flops and executions and seconds and peak_flops):
        return None
    return card.flops * executions / (seconds * peak_flops)


def roofline(
    card: CostCard,
    *,
    peak_flops: Optional[float] = None,
    hbm_bw: Optional[float] = None,
) -> dict:
    """Roofline classification of one program: compute-bound floor
    (``flops / peak_flops``), memory-bound floor (``bytes_accessed /
    hbm_bw``), and which bound dominates — each only where the card has
    the count."""
    out: dict = {
        "flops": card.flops,
        "bytes_accessed": card.bytes_accessed,
        "arithmetic_intensity": card.arithmetic_intensity,
    }
    cb = mb = None
    if peak_flops and card.flops:
        cb = card.flops / peak_flops
        out["compute_bound_s"] = cb
    if hbm_bw and card.bytes_accessed:
        mb = card.bytes_accessed / hbm_bw
        out["memory_bound_s"] = mb
    if cb is not None and mb is not None:
        out["bound"] = "compute" if cb >= mb else "memory"
    return out


def validate_cost_card(card, where: str = "card") -> List[str]:
    """Schema errors for one serialized card (empty list == valid).  The
    JAX package's rules, except that ``flops`` and ``bytes_accessed`` may
    be null on an allocator card that nothing counted: the key must be
    there, and a value that is there must be a finite non-negative number.
    A counted card (``flops_source``) needs both, as every JAX card does."""
    errs: List[str] = []
    if not isinstance(card, dict):
        return [f"{where}: not an object"]
    if card.get("schema") != CARD_SCHEMA:
        errs.append(f"{where}: bad schema {card.get('schema')!r}")
    if not card.get("program") or not isinstance(card.get("program"), str):
        errs.append(f"{where}: missing str 'program'")
    src = card.get("peak_source")
    for key in ("flops", "bytes_accessed"):
        v = card.get(key)
        nullable = src == "cuda_allocator" and card.get("flops_source") != COUNTED_FLOPS
        if key not in card or (v is None and not nullable):
            errs.append(f"{where}: missing {key}")
        elif v is None:
            continue
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            errs.append(f"{where}: non-numeric {key}: {v!r}")
        elif not math.isfinite(v) or v < 0:
            errs.append(f"{where}: bad {key}: {v!r}")
    if not isinstance(src, str) or not src or src == "unavailable":
        errs.append(f"{where}: peak_bytes source not named ({src!r})")
    elif card.get("peak_bytes") is None:
        errs.append(f"{where}: peak_source {src!r} without peak_bytes")
    return errs
