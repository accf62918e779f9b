"""Collective-traffic audit: op counts and analytic bytes per mesh axis
for every collective choke point, counterpart of
``torchdistx_tpu/obs/comm.py`` with the same ``tdx-comm-v1`` schema and
the same wire-byte table.

Collective traffic is analytically accountable (arXiv:2112.01075): for
ring algorithms the wire bytes of each primitive are a closed-form
function of its payload and the axis size.  A :func:`comm_audit` profile
holds ``{(kind, axis): ops, payload bytes, wire bytes}``, and tests pin
it (``tests/test_torch_comm_audit.py``).

Accounting model, and where it differs from the JAX package's:

- The JAX package records at TRACE time: the Python bodies of its
  collectives run once per compiled program, so a profile describes one
  execution of a program and a cached program's later calls record
  nothing.  The port runs eagerly and every call runs its collective.
  Its steps therefore book one execution of a step program: the
  ``Trainer`` audits a step object's first call only, and
  ``ShardedTrainStep`` books a batch signature's first call and runs the
  later ones under :func:`muted`.  The serving engine books the JAX
  engine's closed form at every dispatch, as the JAX engine does.
- Loop-executed collectives book their trip counts explicitly, as JAX's
  scans do: the ring books ``n`` hops of each rotating tensor (the JAX
  scan's home-coming hop included), the 1F1B pipeline ``2 * ticks``
  exchanges.
- Collectives the JAX package leaves to XLA (``GSPMDTrainStep``'s, the
  serving engine's Megatron reductions) are not booked from the port's
  eager calls; the step and the engine book the JAX package's closed form
  instead and run their own collectives under :func:`muted`.  The custom
  autograd pairs (``allreduce_linear`` / ``copy_psum_grad``) book their
  backward, as the JAX package's custom-VJP rules do.
- ``collectives.payload_bytes`` and ``_permute.staged_bytes`` still count
  what the ``torch.distributed`` transport actually carried, audited or
  not.

The audit stack is the process's, not the thread's: autograd runs a CUDA
backward on a thread of its own, and the backward collectives must land
in the profile the forward's caller opened.

Per-device wire bytes (ring algorithms over an axis of size ``n``,
arXiv:2112.01075 §2; ``payload`` is the full logical operand):

=================  =====================  ==========================
kind               payload definition     wire bytes per device
=================  =====================  ==========================
all_reduce/-mean   operand bytes S        2 * (n-1)/n * S
reduce_scatter     input bytes S          (n-1)/n * S
all_gather         gathered bytes S       (n-1)/n * S
broadcast          operand bytes S        (n-1)/n * S  (pipelined 1-to-all)
exchange/shift     operand bytes S        S * len(perm)/n  (senders only)
ppermute           operand bytes S        S  (full-rotation ring hop)
all_to_all         operand bytes S        (n-1)/n * S  (keeps own slice)
=================  =====================  ==========================
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

__all__ = [
    "CommProfile",
    "comm_audit",
    "current_comm_profile",
    "muted",
    "record_collective",
    "tree_bytes",
    "validate_comm_profile",
]

def _leaves(tree: Any):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Total bytes of a tensor, or of the tensors (and anything with a
    ``shape`` and a ``dtype``) of nested dicts, lists and tuples."""
    import numpy as np
    import torch

    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
            continue
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        if isinstance(dtype, torch.dtype):
            item = torch.empty((), dtype=dtype).element_size()
        else:
            item = np.dtype(dtype).itemsize
        total += int(math.prod(shape)) * item
    return total


@dataclasses.dataclass
class _Entry:
    ops: int = 0
    payload_bytes: int = 0
    wire_bytes: float = 0.0


class CommProfile:
    """Accumulated per-(kind, axis) collective traffic.  Thread-safe."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[str, str], _Entry] = {}
        self._lock = threading.Lock()

    def _record(self, kind: str, axis: str, count: int, payload: int, wire: float) -> None:
        key = (kind, str(axis))
        with self._lock:
            e = self._entries.setdefault(key, _Entry())
            e.ops += count
            e.payload_bytes += payload * count
            e.wire_bytes += wire * count

    def _select(self, kind: Optional[str], axis: Optional[str]):
        with self._lock:
            return [
                e
                for (k, a), e in self._entries.items()
                if (kind is None or k == kind) and (axis is None or a == axis)
            ]

    def ops(self, kind: Optional[str] = None, axis: Optional[str] = None) -> int:
        return sum(e.ops for e in self._select(kind, axis))

    def payload_bytes(self, kind: Optional[str] = None, axis: Optional[str] = None) -> int:
        return sum(e.payload_bytes for e in self._select(kind, axis))

    def wire_bytes(self, kind: Optional[str] = None, axis: Optional[str] = None) -> float:
        return sum(e.wire_bytes for e in self._select(kind, axis))

    def bytes_by_axis(self) -> Dict[str, int]:
        """Wire bytes per mesh axis."""
        out: Dict[str, float] = {}
        with self._lock:
            for (_, a), e in self._entries.items():
                out[a] = out.get(a, 0.0) + e.wire_bytes
        return {a: int(round(v)) for a, v in sorted(out.items())}

    def to_json(self) -> dict:
        """``{"schema": "tdx-comm-v1", "entries": [{kind, axis, ops,
        payload_bytes, wire_bytes}], "bytes_by_axis": {...}}``, the JAX
        package's record (:func:`validate_comm_profile`)."""
        with self._lock:
            entries = [
                {
                    "kind": k,
                    "axis": a,
                    "ops": e.ops,
                    "payload_bytes": e.payload_bytes,
                    "wire_bytes": int(round(e.wire_bytes)),
                }
                for (k, a), e in sorted(self._entries.items())
            ]
        return {
            "schema": "tdx-comm-v1",
            "entries": entries,
            "bytes_by_axis": self.bytes_by_axis(),
        }

    def digest(self) -> dict:
        """Compact form for flight records: total ops and wire bytes per
        axis."""
        return {"ops": self.ops(), "bytes_by_axis": self.bytes_by_axis()}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._entries)


_stack: list = []
_mute = [0]
_stack_lock = threading.Lock()


def current_comm_profile() -> Optional[CommProfile]:
    with _stack_lock:
        return _stack[-1] if _stack else None


@contextlib.contextmanager
def comm_audit(profile: Optional[CommProfile] = None) -> Iterator[CommProfile]:
    """Activate ``profile`` (or a fresh one) for collective recording::

        with comm_audit() as prof:
            step(model, opt, batch)
        assert prof.payload_bytes("reduce_scatter", "fsdp") == param_bytes

    Nested audits ALL record: an outer audit sees the collectives of a
    ``Trainer`` step that books into the trainer's own profile too."""
    prof = profile if profile is not None else CommProfile()
    with _stack_lock:
        _stack.append(prof)
    try:
        yield prof
    finally:
        with _stack_lock:
            for i in range(len(_stack) - 1, -1, -1):
                if _stack[i] is prof:
                    del _stack[i]
                    break


@contextlib.contextmanager
def muted() -> Iterator[None]:
    """Record nothing inside: for collectives whose traffic the caller
    books itself in closed form, and for a step program's later calls."""
    with _stack_lock:
        _mute[0] += 1
    try:
        yield
    finally:
        with _stack_lock:
            _mute[0] -= 1


# wire-byte ratio per executed op, as a function of axis size n (and the
# sender count s for permutes); see the module-docstring table
_WIRE = {
    "all_reduce": lambda n, s: 2.0 * (n - 1) / n,
    "all_mean": lambda n, s: 2.0 * (n - 1) / n,
    "allreduce_linear": lambda n, s: 2.0 * (n - 1) / n,
    "allreduce_linear_bwd": lambda n, s: 0.0,  # identity backward
    "copy_psum_grad_bwd": lambda n, s: 2.0 * (n - 1) / n,
    "pmean": lambda n, s: 2.0 * (n - 1) / n,
    "broadcast": lambda n, s: (n - 1) / n,
    "all_gather": lambda n, s: (n - 1) / n,
    "reduce_scatter": lambda n, s: (n - 1) / n,
    "exchange": lambda n, s: (s if s is not None else n) / n,
    "shift": lambda n, s: 1.0,  # every device sends in a ring shift
    "ppermute": lambda n, s: 1.0,  # full rotation: every device sends
    "all_to_all": lambda n, s: (n - 1) / n,  # own slice stays local
}


def _axis_label_and_size(axis: Any) -> tuple:
    """``(label, size or None)``: the name the JAX package files the row
    under (``str(axis)``; an :class:`~..parallel.mesh.Axis` by its name)
    and the axis size of the active mesh (the product over a tuple)."""
    from ..parallel.mesh import Axis, resolve_axis

    if isinstance(axis, Axis):
        return axis.name, axis.size
    names = axis if isinstance(axis, tuple) else (axis,)
    try:
        size = math.prod(resolve_axis(a).size for a in names)
    except Exception:
        size = None
    if isinstance(axis, tuple):
        axis = tuple(a.name if isinstance(a, Axis) else a for a in axis)
    return str(axis), size


def record_collective(
    kind: str,
    axis: Any,
    tree: Any = None,
    *,
    payload_bytes: Optional[int] = None,
    count: int = 1,
    axis_size: Optional[int] = None,
    senders: Optional[int] = None,
) -> None:
    """Record ``count`` executions of a collective into every active
    profile (nothing when none is active or inside :func:`muted`).

    ``payload_bytes`` overrides the ``tree`` measurement; ``axis_size``
    defaults to the axis's size in the active mesh; ``senders`` is the
    permutation length of exchange-style ops."""
    with _stack_lock:
        if not _stack or _mute[0]:
            return
        profs = list(_stack)
    payload = payload_bytes if payload_bytes is not None else tree_bytes(tree)
    label, n = _axis_label_and_size(axis)
    if axis_size is not None:
        n = axis_size
    if n is None or n <= 0:
        wire = float(payload)  # unknown axis: degrade to payload
    else:
        ratio = _WIRE.get(kind)
        wire = payload * ratio(n, senders) if ratio else float(payload)
    for prof in profs:
        prof._record(str(kind), label, int(count), int(payload), wire)


def validate_comm_profile(doc: Any) -> list:
    """Schema check for :meth:`CommProfile.to_json` output.  Returns a
    list of error strings (empty = valid)."""
    errors: list = []
    if not isinstance(doc, dict):
        return [f"comm profile is {type(doc).__name__}, not dict"]
    if doc.get("schema") != "tdx-comm-v1":
        errors.append(f"bad comm-profile schema tag {doc.get('schema')!r}")
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return errors + ["comm profile has no entries list"]
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            errors.append(f"entry {i} is not an object")
            continue
        for field, typ in (
            ("kind", str),
            ("axis", str),
            ("ops", int),
            ("payload_bytes", int),
            ("wire_bytes", int),
        ):
            if not isinstance(e.get(field), typ):
                errors.append(
                    f"entry {i}: {field} is "
                    f"{type(e.get(field)).__name__}, want {typ.__name__}"
                )
        if isinstance(e.get("ops"), int) and e["ops"] < 0:
            errors.append(f"entry {i}: negative ops")
    bba = doc.get("bytes_by_axis")
    if not isinstance(bba, dict) or not all(isinstance(v, int) for v in bba.values()):
        errors.append("bytes_by_axis must map axis -> int")
    return errors
