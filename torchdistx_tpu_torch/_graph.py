"""The recorded op graph behind ``deferred_init``.

Counterpart of ``torchdistx_tpu/_graph.py`` (``RecordingSession``,
``record``, ``materialize_many``), in pure Python.
A node holds one aten op: its arguments, with each fake input replaced by
a reference to the node output that made it, each real tensor kept with
its version counter, and each generator kept as its device and state at
record time; and its outputs.

Fakes that share a (meta) storage form one *group*: a view, or the fake
that ``nn.Parameter`` makes by ``detach()``, joins its base's group, and
an in-place op writes the groups of the arguments it mutates.  The value
of a fake is the state of its group after every recorded write, so the
replay of a target runs every node that made or wrote its group, and,
for each of those nodes, every node that made or wrote a group it read
before it ran; in record order.  Intermediates are dropped at their last
use.  A target's group is kept per device: the same record always gives
back the same tensor, and a node is never applied twice to a tensor that
was handed out.

The JAX package's jit compile cache, chunked replay and native core are
JAX-specific and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Set, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["RecordingSession"]

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class _Ref:
    node: int
    idx: int


@dataclasses.dataclass(frozen=True)
class _Const:
    tensor: torch.Tensor
    version: int


@dataclasses.dataclass(frozen=True)
class _Gen:
    device_type: str
    state: torch.Tensor
    seed: int
    fresh: bool  # never drawn from before this op: its seed says it all

    def make(self, device: torch.device) -> torch.Generator:
        g = torch.Generator(device=device)
        if device.type == self.device_type:
            g.set_state(self.state)
        elif self.fresh:
            g.manual_seed(self.seed)
        else:
            raise RuntimeError(
                f"a {self.device_type} generator that had already been drawn "
                f"from cannot be replayed on {device}"
            )
        return g


@dataclasses.dataclass
class _Node:
    func: Any
    template: list
    spec: Any
    reads: Set[int]
    touches: Set[int]  # groups this node makes or writes
    outs: Dict[int, int]  # output index -> group


class _DeviceState:
    def __init__(self) -> None:
        self.cache: Dict[Tuple[int, int], torch.Tensor] = {}
        self.done: Set[int] = set()
        self.persisted: Set[int] = set()
        self.params: Dict[Tuple[int, int], torch.nn.Parameter] = {}


def _norm(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class RecordingSession:
    def __init__(self) -> None:
        self.nodes: List[_Node] = []
        self._group_of: Dict[int, int] = {}
        self._storages: list = []  # keep meta storages alive: ids stay unique
        self.group_nodes: Dict[int, List[int]] = {}
        self._gens: Dict[int, torch.Generator] = {}
        self._devices: Dict[torch.device, _DeviceState] = {}

    # -- recording -----------------------------------------------------------

    def _group(self, meta: torch.Tensor) -> int:
        st = meta.untyped_storage()
        key = st._cdata
        gid = self._group_of.get(key)
        if gid is None:
            gid = len(self._storages)
            self._group_of[key] = gid
            self._storages.append(st)
        return gid

    def _capture(self, x):
        from .fake import FakeTensor

        if isinstance(x, FakeTensor):
            return _Ref(x._ref[1], x._ref[2])
        if isinstance(x, torch.Tensor):
            return _Const(x, x._version)
        if isinstance(x, torch.Generator):
            if id(x) in self._gens:
                raise RuntimeError(
                    "one torch.Generator feeds several deferred ops; replay "
                    "cannot reproduce its stream (give each draw its own "
                    "generator, as nn.init does)"
                )
            self._gens[id(x)] = x
            probe = torch.Generator(device=x.device)
            probe.manual_seed(x.initial_seed())
            state = x.get_state()
            return _Gen(x.device.type, state, x.initial_seed(),
                        bool(torch.equal(probe.get_state(), state)))
        return x

    def record(self, func, flat, spec, outs) -> int:
        from .fake import FakeTensor

        nid = len(self.nodes)
        reads = {self._group(x._meta) for x in flat if isinstance(x, FakeTensor)}
        touches: Set[int] = set()
        schema = func._schema
        args, kw = tree_unflatten(list(flat), spec)
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kw.get(a.name)
            for v in tree_flatten(val)[0]:
                if isinstance(v, FakeTensor):
                    touches.add(self._group(v._meta))
        out_groups = {}
        for i, o in enumerate(outs):
            if isinstance(o, torch.Tensor):
                out_groups[i] = self._group(o)
                touches.add(out_groups[i])
        template = [self._capture(x) for x in flat]
        if not any(isinstance(x, FakeTensor) for x in flat):
            # a creation op: pin the dtype it resolved at record time
            names = {a.name for a in schema.arguments}
            a_, k_ = tree_unflatten(template, spec)
            if "dtype" in names and k_.get("dtype") is None and out_groups:
                k_ = dict(k_, dtype=outs[min(out_groups)].dtype)
                template, spec = tree_flatten((a_, k_))
        self.nodes.append(_Node(func, template, spec, reads, touches, out_groups))
        for g in touches:
            self.group_nodes.setdefault(g, []).append(nid)
        return nid

    # -- replay --------------------------------------------------------------

    def _closure(self, groups) -> Tuple[Set[int], Dict[int, float]]:
        need: Set[int] = set()
        reach: Dict[int, float] = {}
        stack = [(g, _INF) for g in groups]
        while stack:
            g, before = stack.pop()
            if reach.get(g, -1) >= before:
                continue
            reach[g] = before
            for n in self.group_nodes.get(g, ()):
                if n >= before:
                    break
                if n not in need:
                    need.add(n)
                    stack.extend((r, n) for r in self.nodes[n].reads)
        return need, reach

    def _resolve(self, x, env, st, device):
        if isinstance(x, _Ref):
            key = (x.node, x.idx)
            return env[key] if key in env else st.cache[key]
        if isinstance(x, _Const):
            if x.tensor._version != x.version:
                raise RuntimeError(
                    "a real tensor used by a deferred op was mutated before "
                    "materialization"
                )
            t = x.tensor
            return t.to(device) if t.dim() > 0 and t.device != device else t
        if isinstance(x, _Gen):
            return x.make(device)
        if isinstance(x, torch.device):
            return device
        return x

    def materialize_many(self, targets, device) -> list:
        """Real tensors on ``device`` for ``targets``, a list of ``(node,
        out_idx)``, in one replay."""
        device = _norm(device)
        st = self._devices.setdefault(device, _DeviceState())
        groups = {self.nodes[n].outs[i] for n, i in targets}
        need, reach = self._closure(groups)
        stale = {g for g in st.persisted
                 if reach.get(g, _INF) < _INF
                 and self.group_nodes[g][-1] >= reach[g]}
        order = sorted(n for n in need
                       if n not in st.done or self.nodes[n].touches & stale)
        uses: Dict[Tuple[int, int], int] = {}
        for n in order:
            for x in self.nodes[n].template:
                if isinstance(x, _Ref):
                    uses[(x.node, x.idx)] = uses.get((x.node, x.idx), 0) + 1
        keep = groups - stale
        wanted = set(targets)
        env: Dict[Tuple[int, int], torch.Tensor] = {}
        with _disable_current_modes(), torch.no_grad():
            for n in order:
                node = self.nodes[n]
                vals = [self._resolve(x, env, st, device) for x in node.template]
                args, kwargs = tree_unflatten(vals, node.spec)
                if any(a.name == "device" for a in node.func._schema.arguments):
                    kwargs = dict(kwargs, device=device)
                outs = tree_flatten(node.func(*args, **kwargs))[0]
                for i in node.outs:
                    env[(n, i)] = outs[i]
                persist = bool(node.touches & keep) and not node.touches & stale
                if persist:
                    st.done.add(n)
                    for i in node.outs:
                        st.cache[(n, i)] = outs[i]
                for x in node.template:
                    if isinstance(x, _Ref):
                        key = (x.node, x.idx)
                        uses[key] -= 1
                        if uses[key] == 0 and key not in wanted:
                            env.pop(key, None)
        st.persisted |= keep
        return [st.cache[(n, i)] if (n, i) in st.cache else env[(n, i)]
                for n, i in targets]

    def parameter(self, ref, device, requires_grad: bool) -> torch.nn.Parameter:
        """The one ``nn.Parameter`` for a materialized record (tied
        parameters stay one object)."""
        st = self._devices[_norm(device)]
        p = st.params.get(ref)
        if p is None:
            p = torch.nn.Parameter(st.cache[ref], requires_grad=requires_grad)
            st.params[ref] = p
        return p
