"""The streamed tail of the persistent decode, counterpart of the JAX
package's io_callback / debug.callback ``stream_cb``: each loop iteration
pushes its ``(tokens, live mask, cursor)`` to the host with a clock stamp,
so first tokens are timestamped as they exist, before the ring drain lands.
The drain stays the path that decides which tokens a request gets.

On the card a push is two nodes of the captured iteration
(``csrc/stream_ring.cu``, built by ``ops/_build.py`` like the kernels): an
async copy of the staged row into pinned host memory, then a host node
(``cudaLaunchHostFunc``) whose C function appends the row and a
``CLOCK_MONOTONIC`` stamp to a ring in host memory.  The host function is
C, not a Python callback: a callback on a CUDA runtime thread would take the
GIL, and could deadlock against a main thread waiting on the stream.  A
capture that cannot take the nodes raises; there is no silent fallback.
On the CPU the same push is a plain call per iteration, stamped with
``time.monotonic()`` (the same clock).
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["StreamRing"]

_LIB = "stream_ring"
_CAPACITY, _WIDTH, _STAGING, _ROWS, _STAMPS, _COUNT, _DROPPED = range(7)


def _lib():
    from ..ops import _build

    lib = _build.load(_LIB)
    if lib.tdx_stream_ring_push.argtypes is None:
        lib.tdx_stream_ring_push.argtypes = [ctypes.c_void_p] * 3
        lib.tdx_stream_ring_push.restype = ctypes.c_int
        lib.tdx_stream_ring_count.argtypes = [ctypes.c_void_p]
        lib.tdx_stream_ring_count.restype = ctypes.c_int64
        lib.tdx_stream_ring_header_len.restype = ctypes.c_int
    return lib


class StreamRing:
    """A host ring of ``capacity`` pushed rows of ``width`` int64 values.

    ``push(tokens, live, cursor)`` runs inside the loop iteration: on CUDA
    tensors it enqueues the copy and the host node on the current stream
    (captured with the iteration); on CPU tensors it appends the row at
    once.  ``take()`` returns the rows pushed since the last ``take`` as
    ``(stamp, tokens, live, cursor)``; ``reset()`` empties the ring (call it
    only when no push is in flight: between drains).  ``pushes`` counts
    every row taken."""

    def __init__(self, capacity: int, batch: int, device):
        self.capacity = int(capacity)
        self.batch = int(batch)
        self.width = 2 * self.batch + 1
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pushes = 0
        self._read = 0
        self._rows = torch.zeros((self.capacity, self.width), dtype=torch.int64)
        self._stamps = torch.zeros(self.capacity, dtype=torch.float64)
        self._count = 0  # the CPU path's row count
        if self.cuda:
            lib = _lib()
            if lib.tdx_stream_ring_header_len() != 7:
                raise RuntimeError("stream_ring.cu's header layout differs from stream.py's")
            self._staging = torch.zeros(self.width, dtype=torch.int64, pin_memory=True)
            self._header = torch.zeros(7, dtype=torch.int64)
            h = self._header.numpy()
            h[_CAPACITY], h[_WIDTH] = self.capacity, self.width
            h[_STAGING] = self._staging.data_ptr()
            h[_ROWS], h[_STAMPS] = self._rows.data_ptr(), self._stamps.data_ptr()
            self._lib = lib

    def push(self, tokens: torch.Tensor, live: torch.Tensor, cursor: torch.Tensor) -> None:
        row = torch.cat([tokens.reshape(-1).long(), live.reshape(-1).long(),
                         cursor.reshape(-1).long()])
        if not self.cuda:
            if self._count < self.capacity:
                self._rows[self._count] = row
                self._stamps[self._count] = time.monotonic()
                self._count += 1
            return
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = self._lib.tdx_stream_ring_push(self._header.data_ptr(), row.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"the streamed tail's copy or host node failed (CUDA error {err}): "
                "persistent_stream needs a capture that takes a host node")

    def count(self) -> int:
        if self.cuda:
            return int(self._lib.tdx_stream_ring_count(self._header.data_ptr()))
        return self._count

    @property
    def dropped(self) -> int:
        return int(self._header[_DROPPED]) if self.cuda else 0

    def take(self) -> List[Tuple[float, np.ndarray, np.ndarray, int]]:
        n = self.count()
        rows = self._rows[self._read:n].numpy().copy()
        stamps = self._stamps[self._read:n].numpy().copy()
        self._read = n
        self.pushes += len(rows)
        b = self.batch
        return [(float(t), r[:b], r[b:2 * b].astype(bool), int(r[2 * b]))
                for t, r in zip(stamps, rows)]

    def reset(self) -> None:
        self._read = 0
        if self.cuda:
            self._header[_COUNT] = 0
        else:
            self._count = 0
