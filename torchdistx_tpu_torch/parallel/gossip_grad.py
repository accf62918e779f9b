"""GossipGraD gradient communication hook (arXiv:1803.05880), counterpart of
``torchdistx_tpu/parallel/gossip_grad.py``.

Per step: the mean over the ``local`` axis (when the hook owns it), then
each node exchanges its gradients with one peer node and takes
``(g + received) * 0.5``.  The peer depends on the exchange *power*,
``(iteration // num_modules) % gossip_period``, and on the virtual
topology, a seeded shuffle of the nodes that rotates every
``gossip_period`` adjusted steps.  Peers are computed on positions in the
permutation and mapped back to node ids:

  CUBE:          peer = topo[pos XOR 2**power], none (the node keeps its
                 gradient) if that position is past the last node
  DISSEMINATION: send to topo[(pos + 2**power) % n],
                 receive from topo[(pos - 2**power) % n]

The exchange is ``collectives.exchange`` over the ``node`` axis, run by
every rank of a node with its peer node's rank of the same ``local``
index, so all local ranks carry a share of the traffic.

The schedule is the JAX package's, draw for draw: the same
``random.Random(seed)`` shuffles, the same cap of the topology set at
``max_branches // gossip_period`` shuffles (with its warning), the same
one draw from the topology cycle per rotation window for ``num_modules >
1`` (the JAX package's documented deviation from the reference, which
burns ``num_modules`` draws a window), and the same deduplicated branch
table.  An eager step compiles no ``lax.switch``, so the cap bounds no
compile cost here; it is kept because it decides which topologies the
schedule cycles through, and dropping it would change the schedule.
``step_args()`` is the step's index into the branch table, a Python int.
"""

from __future__ import annotations

import enum
import itertools
import math
import random
import warnings
from typing import Any, Iterator, Optional, Sequence

import torch

from . import collectives
from .comm_hooks import DefaultState, HookContext

__all__ = [
    "Topology",
    "GossipGraDState",
    "gossip_grad_hook",
    "get_num_modules",
    "INVALID_PEER",
]


def get_num_modules(module: torch.nn.Module) -> int:
    """The submodules of ``module`` (the root included) that directly own a
    parameter, at least 1: the units a per-submodule hook caller fires for
    (the reference counts its nested FSDP modules).  ``ShardedTrainStep``
    calls the hook once per step over every gradient, so its states keep
    ``num_modules=1``."""
    n = sum(1 for m in module.modules()
            if any(p is not None for p in m._parameters.values()))
    return max(1, n)


INVALID_PEER = -1


class Topology(enum.Enum):
    CUBE = "cube"
    DISSEMINATION = "dissemination"


def _peers(topology: Topology, topo: Sequence[int], power: int, num_nodes: int):
    """``(send_to, recv_from, valid)``, each of length ``num_nodes``, for the
    virtual topology ``topo`` (a permutation of node ids) at ``power``."""
    send = [INVALID_PEER] * num_nodes
    recv = [INVALID_PEER] * num_nodes
    valid = [False] * num_nodes
    stride = 2**power
    position = {node: pos for pos, node in enumerate(topo)}
    for i in range(num_nodes):
        pos = position[i]
        if topology is Topology.CUBE:
            peer_pos = pos ^ stride
            if peer_pos < num_nodes:
                send[i] = recv[i] = topo[peer_pos]
                valid[i] = True
        else:
            send[i] = topo[(pos + stride) % num_nodes]
            recv[i] = topo[(pos - stride) % num_nodes]
            valid[i] = True
    return send, recv, valid


class GossipGraDState(DefaultState):
    """The hook's state: the topology schedule and the iteration count.

    ``num_nodes`` seeded shuffles of the nodes, kept up to ``max_branches
    // gossip_period`` of them, cycled every ``gossip_period`` adjusted
    steps; the power ``(iteration // num_modules) % gossip_period``;
    ``gossip_period`` defaults to ``ceil(log2(num_nodes))``; the topology
    to DISSEMINATION.  A test may inject a schedule by assigning
    ``state.topologies_set = [perm, ...]`` and ``state.topology_cycle =
    itertools.cycle(range(len(...)))`` and pinning ``state.iteration``.
    """

    def __init__(
        self,
        num_nodes: int,
        *,
        node_axis: str = "node",
        local_axis: Optional[str] = "local",
        topology: Topology = Topology.DISSEMINATION,
        seed: int = 2403,
        gossip_period: Optional[int] = None,
        num_modules: int = 1,
        max_branches: int = 64,
    ) -> None:
        super().__init__()
        if num_nodes < 2:
            raise ValueError("GossipGraD needs at least 2 nodes")
        if num_nodes % 2 != 0 and topology is Topology.CUBE:
            raise ValueError(
                "Current implementation doesn't support uneven number"
                " of nodes for CUBE topology."
            )
        self.num_nodes = num_nodes
        self.node_axis = node_axis
        self.local_axis = local_axis
        self.topology = topology
        self.gossip_period = gossip_period or max(1, math.ceil(math.log2(num_nodes)))
        self.num_modules = max(1, num_modules)
        rng = random.Random(seed)
        nodes = list(range(num_nodes))
        topologies = []
        for _ in range(num_nodes):
            rng.shuffle(nodes)
            topologies.append(tuple(nodes))
        # the JAX package caps the set to bound its step's compiled branches;
        # the cap is kept for the schedule it gives (see the module docstring)
        if max_branches < self.gossip_period:
            raise ValueError(
                f"max_branches={max_branches} cannot hold even one "
                f"topology's {self.gossip_period} exchange powers"
            )
        self.max_branches = max_branches
        keep = max(1, max_branches // self.gossip_period)
        if len(topologies) > keep:
            warnings.warn(
                f"GossipGraD: keeping {keep} of {len(topologies)} "
                f"pre-generated topologies (max_branches={max_branches}, "
                f"gossip_period={self.gossip_period}) — the schedule "
                "cycles through fewer distinct shuffles than the "
                "reference's num_nodes permutations; raise max_branches "
                "to trade compile time for a longer topology cycle",
                stacklevel=2,
            )
            topologies = topologies[:keep]
        self.topologies_set: Sequence[Sequence[int]] = topologies
        self.topology_cycle: Iterator[int] = itertools.cycle(range(len(topologies)))
        self._current_topology_idx: Optional[int] = None
        self._rotation_idx = -1
        self._spec_cache: Optional[tuple] = None

    def branch_table(self):
        """The deduplicated ``(send, recv, valid)`` specs and the map
        ``(topology_idx, power) -> spec index``.  Recomputed when
        ``topologies_set`` changes, so injected schedules take effect."""
        key = (tuple(tuple(t) for t in self.topologies_set), self.topology,
               self.gossip_period)
        if self._spec_cache is not None and self._spec_cache[0] == key:
            return self._spec_cache[1], self._spec_cache[2]
        specs: list = []
        index: dict = {}
        seen: dict = {}
        for ti, topo in enumerate(self.topologies_set):
            for power in range(self.gossip_period):
                send, recv, valid = _peers(self.topology, topo, power, self.num_nodes)
                k = (tuple(send), tuple(recv))
                if k not in seen:
                    seen[k] = len(specs)
                    specs.append((send, recv, valid))
                index[(ti, power)] = seen[k]
        self._spec_cache = (key, specs, index)
        return specs, index

    @property
    def current_power(self) -> int:
        """This step's exchange power; changes every adjusted step."""
        return (self.iteration // self.num_modules) % self.gossip_period

    @property
    def current_topology_idx(self) -> int:
        """The active virtual topology's index; one draw from
        ``topology_cycle`` per rotation window of ``gossip_period``
        adjusted steps."""
        adjusted = self.iteration // self.num_modules
        rotation = adjusted // self.gossip_period
        if rotation != self._rotation_idx or self._current_topology_idx is None:
            self._current_topology_idx = next(iter(self.topology_cycle))
            self._rotation_idx = rotation
        return self._current_topology_idx

    @property
    def current_topology(self) -> Sequence[int]:
        return self.topologies_set[self.current_topology_idx]

    def step_args(self) -> int:
        """This step's index into :meth:`branch_table`'s specs."""
        _, index = self.branch_table()
        return index[(self.current_topology_idx, self.current_power)]


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _zip_map(fn, v, b[k]) for k, v in a.items()}
    return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))


def gossip_grad_hook(state: GossipGraDState, grads: Any, ctx: HookContext) -> Any:
    """The hook: ``ctx.step`` is ``state.step_args()``, the branch whose
    peers this step exchanges with.  Every member takes part in the
    exchange; a member with a peer takes ``(g + received) * 0.5``, one
    without (CUBE past the last node) keeps ``g``."""
    if state.local_axis is not None and state.local_axis in ctx.replica_axes:
        grads = collectives.all_mean(grads, state.local_axis)
    specs, _ = state.branch_table()
    send, recv, valid = specs[ctx.step]
    received = collectives.exchange(grads, state.node_axis, send, recv, fill="zero")
    if not valid[collectives.axis_index(state.node_axis)]:
        return grads
    return _zip_map(lambda g, r: (g + r) * 0.5, grads, received)
