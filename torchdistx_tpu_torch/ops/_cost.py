"""One cost formula per kernel: the FLOPs and bytes of a launch, from its
shapes.

Each hand-written kernel of ``ops`` (the 12 rows that replace the TPU
kernels, in every variant, and the flash backward's delta pre-pass) has
one function here.  FLOPs follow what the kernel's plain version
multiplies, dense over masked blocks, 2 a multiply-add, as
``flops_per_token``'s ``12 * L * dim * seq`` counts attention:

- flash forward (``flash_attention_reference``): Q.K^T and P.V, ``4 P``
  with ``P = B * Hq * Sq * Skv * D``; the ``lse`` variant's plain version
  takes the f32 logits once more for the log-sum-exp (``6 P``); the
  residuals' (``flash_attention_residuals_reference``) ``4 P``;
- flash backward (``flash_bwd_reference``): ``10 P``, of which the dK/dV
  kernel owns the recompute of the logits and dP = dO V^T, dV and dK
  (``8 P``) and the dQ kernel dQ (``2 P``); the delta pre-pass multiplies
  nothing; dbias and dtable (``flash_bias_grad_reference``) recompute the
  logits and dP (``4 P``);
- fused cross-entropy (``fused_ce_fwd_reference`` /
  ``fused_ce_bwd_reference``): ``2 N V D`` forward, ``6 N V D`` backward
  (the logits again, dW = dP^T X, dX = dP W);
- decode attention, slab or paged, one token or a verify block, bf16 or
  int8 (``_slot_attend`` / ``_slot_attend_block`` over the cache or the
  page-table gather of the pools): ``4 * B * Hq * S * L * D`` over the
  ``L`` rows a slot's cache holds (the slab's ``max_len``, the pages'
  ``pages_per_slot * page_size``).

So the CPU, where the wrappers run their plain versions and the counted
card counts their aten products by ``torch.utils.flop_counter``'s
formulas, and the card, where they launch and book the formula, count the
same program
(``tests/test_torch_cost.py`` holds every formula equal to the counter's
count of its plain version).  Bytes are the operands of ``PERF.md`` §6's
bound column: each input read once and each output written once (bf16
tensors 2 bytes an element, lse, delta, scales and labels 4), over the
dense cache for decode (its visible rows would need the positions, which
a launch must not read back).

A CUDA wrapper books its launch with :func:`book` after the kernel was
queued; every :class:`KernelTally` open at that moment (:func:`tally`)
adds it.  The tallies are process-wide, not per thread, so the kernels an
autograd backward launches from its worker thread are counted too.  A
wrapper on CPU tensors runs the plain version and books nothing: the
counter sees its aten ops instead, never both.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, NamedTuple, Optional

__all__ = [
    "Cost",
    "KernelTally",
    "book",
    "tally",
    "flash_fwd",
    "flash_bwd_delta",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_dbias",
    "flash_bwd_dtable",
    "fused_ce_fwd",
    "fused_ce_bwd",
    "decode_attention",
    "paged_decode_attention",
]

BF16, F32 = 2, 4


class Cost(NamedTuple):
    """One launch's FLOPs and the bytes it must move."""

    flops: int
    bytes: int


def _pairs(b, sq, skv, hq, d) -> int:
    return b * hq * sq * skv * d


def _bias_bytes(hq, sq, skv, bias: Optional[str], buckets: int) -> int:
    """An additive (Hq, Sq, Skv) bf16 bias, or an (Hq, buckets) bf16 table
    and the int32 bucket ids of its Sq + Skv - 1 distances."""
    if bias == "bias":
        return BF16 * hq * sq * skv
    if bias == "table":
        return BF16 * hq * buckets + F32 * (sq + skv - 1)
    return 0


def flash_fwd(b, sq, skv, hq, hkv, d, *, out: str = "plain", bias: Optional[str] = None,
              buckets: int = 0) -> Cost:
    """``csrc/flash_fwd.cu`` (row 1): ``out`` "plain", "lse" or
    "residuals"; ``bias`` None, "bias" or "table" (``buckets`` its
    width); a window multiplies what the plain version multiplies, the
    dense product."""
    flops = (6 if out == "lse" else 4) * _pairs(b, sq, skv, hq, d)
    nbytes = BF16 * (b * sq * hq * d + 2 * b * skv * hkv * d)
    if out == "residuals":
        nbytes += F32 * (b * sq * hq * d + 2 * b * hq * sq)
    else:
        nbytes += BF16 * b * sq * hq * d + (F32 * b * hq * sq if out == "lse" else 0)
    return Cost(flops, nbytes + _bias_bytes(hq, sq, skv, bias, buckets))


def flash_bwd_delta(b, s, hq, d) -> Cost:
    """The backward's pre-pass, ``rowsum(dO * O)``: reads o and dO, writes
    the f32 (B, Hq, S) delta; multiplies nothing a matrix product counts."""
    return Cost(0, 2 * BF16 * b * s * hq * d + F32 * b * hq * s)


def _bwd_reads(b, s, hq, hkv, d, bias, buckets) -> int:
    """q, dO, k, v, lse and delta read once, and the bias or table."""
    return (2 * BF16 * b * s * hq * d + 2 * BF16 * b * s * hkv * d + 2 * F32 * b * hq * s
            + _bias_bytes(hq, s, s, bias, buckets))


def flash_bwd_dkv(b, s, hq, hkv, d, *, bias: Optional[str] = None, buckets: int = 0,
                  out_bytes: int = BF16) -> Cost:
    """``csrc/flash_bwd.cu`` dK/dV (row 2), Sq == Skv == S: the logits'
    recompute, dP, dV and dK (``out_bytes`` 4 for the f32 partials)."""
    return Cost(8 * _pairs(b, s, s, hq, d),
                _bwd_reads(b, s, hq, hkv, d, bias, buckets) + out_bytes * 2 * b * s * hkv * d)


def flash_bwd_dq(b, s, hq, hkv, d, *, bias: Optional[str] = None, buckets: int = 0,
                 out_bytes: int = BF16) -> Cost:
    """``csrc/flash_bwd.cu`` dQ (row 3): dQ = dS K."""
    return Cost(2 * _pairs(b, s, s, hq, d),
                _bwd_reads(b, s, hq, hkv, d, bias, buckets) + out_bytes * b * s * hq * d)


def flash_bwd_dbias(b, s, hq, hkv, d) -> Cost:
    """``csrc/flash_bwd.cu`` dbias (row 4): the logits' and dP's recompute,
    the (Hq, S, S) bf16 batch sum written."""
    return Cost(4 * _pairs(b, s, s, hq, d),
                _bwd_reads(b, s, hq, hkv, d, "bias", 0) + BF16 * hq * s * s)


def flash_bwd_dtable(b, s, hq, hkv, d, buckets) -> Cost:
    """``csrc/flash_bwd.cu`` dtable (row 5): as dbias, folded per bucket
    into the (Hq, buckets) bf16 gradient."""
    return Cost(4 * _pairs(b, s, s, hq, d),
                _bwd_reads(b, s, hq, hkv, d, "table", buckets) + BF16 * hq * buckets)


def fused_ce_fwd(n, d, v) -> Cost:
    """``csrc/fused_ce.cu`` forward (row 6): the logits; x, w and the
    labels read, loss and lse written."""
    return Cost(2 * n * v * d, BF16 * (n * d + v * d) + F32 * n + 2 * F32 * n)


def fused_ce_bwd(n, d, v) -> Cost:
    """``csrc/fused_ce.cu`` backward (rows 7-8, one launch): the logits
    again, dW = dP^T X and dX = dP W; x, w, labels and lse read, dX and dW
    written, the bf16 (N, V) dP panel written once and read twice."""
    return Cost(6 * n * v * d,
                BF16 * (n * d + v * d) + 2 * F32 * n + BF16 * (n * d + v * d)
                + 3 * BF16 * n * v)


def _decode(b, s, hq, hkv, d, rows, int8) -> Cost:
    per_row = 2 * hkv * (d * (1 if int8 else BF16) + (F32 if int8 else 0))
    return Cost(4 * b * hq * s * (rows // b) * d,
                2 * BF16 * b * s * hq * d + F32 * b + rows * per_row)


def decode_attention(b, s, hq, hkv, d, max_len, *, int8: bool = False) -> Cost:
    """``csrc/decode_attention.cu`` over the (B, max_len, Hkv, D) slab
    (rows 9 and 10: ``s`` 1 or the verify block's): q, o and the
    positions, and every cache row of every slot (with its f32 scales when
    int8)."""
    return _decode(b, s, hq, hkv, d, b * max_len, int8)


def paged_decode_attention(b, s, hq, hkv, d, pages_per_slot, page_size, *,
                           int8: bool = False) -> Cost:
    """``csrc/decode_attention.cu`` over page pools (rows 11 and 12): the
    slab's formula over the ``pages_per_slot * page_size`` rows each
    slot's table names, plus the int32 tables."""
    c = _decode(b, s, hq, hkv, d, b * pages_per_slot * page_size, int8)
    return Cost(c.flops, c.bytes + F32 * b * pages_per_slot)


class KernelTally:
    """What the kernels launched while it was open: their FLOPs and bytes,
    and the launches by wrapper name."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.launches: Dict[str, int] = {}

    def _add(self, name: str, cost: Cost) -> None:
        self.flops += cost.flops
        self.bytes += cost.bytes
        self.launches[name] = self.launches.get(name, 0) + 1


_lock = threading.Lock()
_open: List[KernelTally] = []


def book(name: str, cost: Cost) -> None:
    """Add one launch of the wrapper ``name`` to every open tally."""
    with _lock:
        for t in _open:
            t._add(name, cost)


@contextlib.contextmanager
def tally() -> Iterator[KernelTally]:
    """Count every kernel launch booked inside the body."""
    t = KernelTally()
    with _lock:
        _open.append(t)
    try:
        yield t
    finally:
        with _lock:
            _open.remove(t)
