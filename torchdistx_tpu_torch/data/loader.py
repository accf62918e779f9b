"""Host data pipeline with device prefetch, counterpart of
``torchdistx_tpu/data/loader.py``.

``TokenDataset`` cuts a token stream into next-token LM examples;
``DataLoader`` batches them in the JAX loader's order (the epoch's
permutation is ``np.random.RandomState(seed + epoch)``, so both packages
yield the same batches) and resumes from ``state_dict`` the same way.
Batches arrive as torch tensors on ``device``; with ``prefetch`` > 0 a
background thread assembles them in pinned host memory and copies them
with ``non_blocking`` transfers, overlapping the next batches with the
card's compute.  With ``sharding=NamedSharding(mesh, spec)`` (the JAX
argument) each rank's batches are its piece of the global batch
(``shard_slices``), cut on the host before the transfer and marked with
the sharding and the global shape (``parallel.mesh.mark_sharded``), which
``parallel.GSPMDTrainStep`` takes as the rank's piece.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = ["DataLoader", "TokenDataset", "prefetch_to_device"]


class TokenDataset:
    """Contiguous token stream -> fixed-length LM examples.

    ``__getitem__(i)`` returns ``(tokens, labels)`` where labels are the
    next-token shift, both of length ``seq_len``.
    """

    def __init__(self, tokens: np.ndarray, seq_len: int) -> None:
        self.tokens = np.asarray(tokens)
        if self.tokens.ndim != 1:
            raise ValueError("TokenDataset expects a 1-d token stream")
        self.seq_len = seq_len

    def __len__(self) -> int:
        return max(0, (len(self.tokens) - 1) // self.seq_len)

    def __getitem__(self, i: int):
        lo = i * self.seq_len
        x = self.tokens[lo : lo + self.seq_len]
        y = self.tokens[lo + 1 : lo + self.seq_len + 1]
        return x, y


class DataLoader:
    """Seeded, shuffling, batching loader with optional device prefetch.

    Args:
      dataset: indexable (``__len__`` + ``__getitem__``) dataset whose items
        are arrays or tuples of arrays.
      batch_size: examples per batch.
      shuffle / seed: epoch-seeded permutation (deterministic resume:
        ``state_dict``/``load_state_dict`` capture epoch + position).
      prefetch: batches to keep in flight (0 disables the thread).
      drop_last: drop the trailing partial batch (default True).
      collate: optional ``list[item] -> batch`` override; default stacks.
      device: where batches land (default ``"cuda"``).
      sharding: a ``parallel.NamedSharding``: each rank takes its piece of
        every array, marked with the sharding and the global shape.

    One ``iter()`` walks the rest of the current epoch, as in the JAX
    package.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        sharding: Any = None,
        prefetch: int = 2,
        drop_last: bool = True,
        collate: Optional[Callable[[list], Any]] = None,
        device="cuda",
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.sharding = sharding
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.collate = collate or _default_collate
        self.device = torch.device(device)
        self.epoch = 0
        self._pos = 0  # batch index within the epoch, for resume

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self._pos, "seed": self.seed}

    def load_state_dict(self, sd: dict) -> None:
        self.epoch = sd["epoch"]
        self._pos = sd["pos"]
        self.seed = sd["seed"]

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _host_batches(self) -> Iterator[Any]:
        """Producer for one epoch from the current resume point.  It does
        not touch the loader's state: the prefetch thread runs ahead of the
        consumer, and resume state follows what the consumer received."""
        order = self._epoch_order(self.epoch)
        for i in range(self._pos, len(self)):
            sel = order[i * self.batch_size : (i + 1) * self.batch_size]
            yield self.collate([self.dataset[int(j)] for j in sel])

    def __iter__(self) -> Iterator[Any]:
        host = self._host_batches()
        nb = len(self)
        if self.prefetch <= 0:
            stream: Iterator[Any] = (_place(b, self.device, sharding=self.sharding)
                                     for b in host)
        else:
            stream = prefetch_to_device(host, self.device, self.prefetch, self.sharding)
        for b in stream:
            # a delivered batch counts as consumed, however far the
            # prefetch thread has run ahead
            self._pos += 1
            if self._pos >= nb:
                self._pos = 0
                self.epoch += 1
            yield b


def _default_collate(items: list) -> Any:
    first = items[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            np.stack([it[k] for it in items]) for k in range(len(first))
        )
    return np.stack(items)


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _place(batch: Any, device: torch.device, pin: bool = False, sharding: Any = None) -> Any:
    """Every array of ``batch`` as a tensor on ``device``; with ``pin`` (a
    CUDA target) through pinned host memory and a ``non_blocking`` copy;
    with ``sharding`` this rank's piece of it, marked."""

    def one(a):
        a = np.asarray(a)
        shape = a.shape
        if sharding is not None:
            a = a[sharding.shard_slices(shape)]
        t = torch.as_tensor(np.ascontiguousarray(a))
        if device.type != "cuda":
            t = t.to(device)
        else:
            if pin:
                t = t.pin_memory()
            t = t.to(device, non_blocking=pin)
        if sharding is not None:
            from ..parallel.mesh import mark_sharded

            mark_sharded(t, sharding, shape)
        return t

    return _map(one, batch)


def prefetch_to_device(batches: Iterable[Any], device="cuda", size: int = 2,
                       sharding: Any = None) -> Iterator[Any]:
    """Background-thread prefetch: keeps ``size`` batches transferred ahead
    of the consumer, from pinned host memory with ``non_blocking`` copies
    to ``device``, so the consumer's compute overlaps the next batches'
    host work and transfers; with ``sharding`` each batch is this rank's
    piece, as the loader places it."""
    device = torch.device(device)
    q: "queue.Queue[Any]" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    err: list = []

    def put(item: Any) -> bool:
        # gives up when the consumer left, so an early `break` in the
        # training loop cannot leak this thread and its batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for b in batches:
                if not put(_place(b, device, pin=device.type == "cuda", sharding=sharding)):
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if b is sentinel:
                if err:
                    raise err[0]
                return
            yield b
    finally:
        stop.set()
        while not q.empty():  # unblock the worker and drop buffered batches
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
