"""Attention and loss ops and the kernels behind them.  The kernel modules
are reached as modules (``ops.flash_attention``, ``ops.decode_attention``,
``ops.fused_ce``) so that their launch counters stay addressable."""

from . import attention, decode_attention, flash_attention, fused_ce
from .attention import cached_attention, multihead_attention, slot_cached_attention

__all__ = [
    "attention",
    "flash_attention",
    "decode_attention",
    "fused_ce",
    "multihead_attention",
    "cached_attention",
    "slot_cached_attention",
]
