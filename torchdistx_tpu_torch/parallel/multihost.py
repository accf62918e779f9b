"""Process-group initialization, counterpart of
``torchdistx_tpu/parallel/multihost.py``.

The JAX package stands up one process per host with
``jax.distributed.initialize``; PyTorch runs one process per device and
joins them with ``torch.distributed.init_process_group``.  ``init_multihost``
is that call: NCCL on the card, ``gloo`` only when the caller asks for the
CPU (``device="cpu"`` or ``backend="gloo"``).  Asked for the card on a host
that has none, it raises rather than carry on in ``gloo``.

The rendezvous is ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, as the JAX function also reads them), an explicit
``coordinator_address`` (``host:port``, over TCP), or a ``store`` (a
``torch.distributed.FileStore`` lets tests start worlds without a port).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_multihost", "is_multihost", "process_index", "process_count"]


def _backend(backend: Optional[str], device: Optional[str]) -> str:
    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_multihost: NCCL needs a CUDA device and this host has none; "
            "pass device='cpu' (or backend='gloo') to run on the CPU"
        )
    return backend


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Optional[str] = None,
    store: Optional[dist.Store] = None,
    timeout_s: Optional[float] = None,
) -> None:
    """Join this process to the world.  ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``; ``coordinator_address`` to
    ``MASTER_ADDR:MASTER_PORT`` (read by ``env://``).  On NCCL the process
    takes the card ``LOCAL_RANK`` (else its rank modulo the cards)."""
    if dist.is_initialized():
        raise RuntimeError("init_multihost: the process group is already initialized")
    backend = _backend(backend, device)
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if store is not None:
        kwargs["store"] = store
    elif coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id, **kwargs)


def is_multihost() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
