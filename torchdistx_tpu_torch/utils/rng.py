"""Deterministic counter-keyed RNG stream for parameter initialization.

Counterpart of ``torchdistx_tpu/utils/rng.py``.  JAX folds a monotonically
increasing counter into a root key for every parameter draw; here every
draw gets its own ``torch.Generator`` seeded from ``(seed, counter)``, so
the same seed and the same construction order give bit-identical
parameters on one device type.  The bits differ from ``jax.random``'s
(the two generators share no algorithm): tests that compare the two
packages carry weights across with ``interop.load_jax_params``.
"""

from __future__ import annotations

import hashlib
import struct
import threading

import torch

__all__ = ["manual_seed", "derive_seed", "next_generator"]


class _RngState(threading.local):
    def __init__(self) -> None:
        self.seed = 0
        self.counter = 0


_state = _RngState()


def manual_seed(seed: int) -> None:
    """Reset the init RNG stream (``torch.manual_seed`` analog)."""
    _state.seed = int(seed)
    _state.counter = 0


def derive_seed(seed: int, counter: int) -> int:
    """63-bit generator seed for ``(seed, counter)``: SHA-256 of the pair,
    so neighbouring counters give unrelated streams."""
    digest = hashlib.sha256(struct.pack("<qq", int(seed), int(counter))).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def next_generator(device="cuda") -> torch.Generator:
    """The next generator of the stream, on ``device``.  Under
    ``fake_mode(fake_cuda=True)`` on a host without a card, a claimed
    ``cuda`` device gets a CPU generator of the same seed: the draw is
    recorded by its seed, and a replay on the CPU matches an eager CPU
    construction."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        from ..fake import fake_cuda_active

        if fake_cuda_active():
            device = torch.device("cpu")
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(_state.seed, _state.counter))
    _state.counter += 1
    return g
