"""Declarative sharding plans, counterpart of
``torchdistx_tpu/parallel/plan.py``: one object that owns a model's
placement.

A :class:`ShardingPlan` is a frozen value: ordered ``(regex, spec)`` rules
over dotted parameter paths (``re.search``, first match wins, t5x
``match_partition_rules`` style), a spec being the port's per-dimension
tuple of axis names (``parallel.mesh.NamedSharding``).  From the rules
every other placement is derived:

- parameter shardings (:meth:`~ShardingPlan.param_shardings`, and
  :meth:`~ShardingPlan.as_rule` for ``materialize_module(sharding_rule=)``);
- a materialized model's placement (:meth:`~ShardingPlan.apply` cuts each
  full parameter to this rank's piece in place, and re-cuts one sharded
  another way);
- optimizer-state shardings (:meth:`~ShardingPlan.optimizer_state_shardings`:
  each slot shaped like its parameter inherits the parameter's rule; with
  ``zero2=True`` a slot whose parameter the plan replicates is sharded
  over ``dp_axis`` by its own shape, the ZeRO-2 layout that
  ``GSPMDTrainStep`` realizes);
- the serve KV pool's layout, as a ``kv_cache`` pseudo-path rule
  (:meth:`~ShardingPlan.maybe_spec_for`).

An eager step creates the optimizer's state from the rank's pieces and
donates nothing, so the derived optimizer and carry shardings describe a
layout that already holds (:meth:`~ShardingPlan.shardings_for` reports
each tensor's own).  ``zero2_participating_bytes`` is ZeRO-2's closed
form, the bytes of the parameters whose update it shards (the step's
all-gather payload).

The plan checks and prices itself: :meth:`~ShardingPlan.validate` holds a
materialized state against the plan through ``obs.memory.sharding_report``
and prices a shape-only one (fake or meta tensors) in closed form through
``obs.memory.capacity_plan``; :meth:`~ShardingPlan.price_step` gives a
train step's collective rows on the ring model of ``obs.comm``, which
:meth:`~ShardingPlan.record_step_collectives` books into the active comm
audit.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from . import collectives
from .fsdp import _spec_axes, donated_carry_shardings, fsdp_partition_spec
from .mesh import Mesh, NamedSharding, mark_sharded, sharding_of

__all__ = [
    "PlanError",
    "ShardingPlan",
    "derive_optimizer_state_shardings",
    "tree_path_str",
    "gather_full",
    "place_params",
]


class PlanError(ValueError):
    """A sharding plan failed validation: an axis the mesh lacks, an
    option without the one it needs, a state placed otherwise than the
    plan says, or a state over its budget.  The message names the
    offending rule, argument or numbers."""


def tree_path_str(path: Sequence[Any]) -> str:
    """The dotted parameter path of a key path (strings, indices, or JAX-style
    keys with ``key`` / ``name`` / ``idx``): ``("blocks", 0, "attn")`` is
    ``"blocks.0.attn"``, the string ``named_parameters`` gives and the
    plan's regexes match."""
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                k = getattr(k, attr)
                break
        parts.append(str(k))
    return ".".join(parts)


def _norm_spec(spec) -> tuple:
    """A spec as a tuple of None, names and tuples of names."""
    out = []
    for entry in spec:
        if isinstance(entry, (list, tuple)):
            entry = tuple(entry) if len(entry) > 1 else (entry[0] if entry else None)
        out.append(entry)
    return tuple(out)


def _global_shape(t: Any) -> tuple:
    found = sharding_of(t) if isinstance(t, torch.Tensor) else None
    return found[1] if found else tuple(getattr(t, "shape", ()) or ())


def _named(params: Any) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _leaf_bytes(t: Any) -> int:
    shape = _global_shape(t)
    item = t.element_size() if isinstance(t, torch.Tensor) else 4
    return math.prod(shape) * item


def _effective(sharding: NamedSharding, ndim: int) -> tuple:
    """Per dimension the axes of size > 1 that cut it: shardings with equal
    ones place a tensor the same way."""
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return tuple(tuple(a for a in (e if isinstance(e, tuple) else (e,))
                       if e is not None and sharding.mesh.shape[a] > 1) for e in spec)


def equivalent(a: NamedSharding, b: NamedSharding, ndim: int) -> bool:
    """Whether ``a`` and ``b`` place a tensor of rank ``ndim`` alike (the
    same mesh, the same cuts; axes of size 1 cut nothing)."""
    return a.mesh is b.mesh and _effective(a, ndim) == _effective(b, ndim)


def gather_full(t: torch.Tensor, sharding: Optional[NamedSharding] = None) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's piece (under
    ``sharding``, default ``t``'s :func:`~.mesh.sharding_of`), all-gathered
    dim by dim, every rank of each axis taking part; no gradient."""
    if sharding is None:
        found = sharding_of(t)
        if found is None:
            return t.detach()
        sharding = found[0]
    out = t.detach()
    for d, entry in enumerate(sharding.spec):
        names = entry if isinstance(entry, tuple) else (entry,) if entry else ()
        for name in reversed(names):  # the minor axis first
            out = collectives._gather(out, sharding.mesh.axes[name], d)
    return out


def place(t: torch.Tensor, target: NamedSharding):
    """``(piece, global shape)``: this rank's piece of ``t``'s whole tensor
    under ``target``; ``t`` itself when it is already placed so, a new
    tensor otherwise (re-cut from the gathered whole if another sharding
    marks ``t``)."""
    found = sharding_of(t)
    shape = found[1] if found else tuple(t.shape)
    if found is not None and equivalent(found[0], target, len(shape)):
        return t, shape
    full = gather_full(t, found[0]) if found else t.detach()
    return full[target.shard_slices(shape)].clone(), shape


def place_params(params: Any, rule: Callable[[str, Any], NamedSharding]) -> Any:
    """Place parameters by ``rule(path, like)``.  A module is placed in
    place: each parameter is cut to this rank's piece (``param.data``, so an
    optimizer made before keeps it) and marked; one already placed so is
    left as it is.  A ``{name: tensor}`` dict gives a new dict of marked
    pieces.  Every rank of the mesh must call it together (a parameter
    sharded another way is gathered first)."""
    if isinstance(params, nn.Module):
        for name, p in params.named_parameters():
            target = rule(name, p)
            piece, shape = place(p, target)
            if piece is not p:
                with torch.no_grad():
                    p.data = piece
            mark_sharded(p, target, shape)
        return params
    out = {}
    for name, t in dict(params).items():
        target = rule(name, t)
        piece, shape = place(t, target)
        out[name] = t if piece is t else mark_sharded(piece, target, shape)
    return out


def _state_tree(state: Any, named: dict) -> dict:
    """``{name: (held, {slot: leaf})}`` of a torch optimizer (by the
    identity of the tensor it holds: the parameter, or the slice a ZeRO-2
    step gave it, which carries its parameter's path as ``_tdx_path``), or
    of ``{name: {slot: leaf}}`` (held: the parameter)."""
    if hasattr(state, "state") and hasattr(state, "param_groups"):
        name_of = {id(p): n for n, p in named.items()}
        return {getattr(p, "_tdx_path", None) or name_of.get(id(p), str(i)): (p, dict(s))
                for i, (p, s) in enumerate(state.state.items())}
    return {n: (named.get(n), dict(slots)) for n, slots in dict(state).items()}


def _is_replicated(sh: NamedSharding) -> bool:
    return not _spec_axes(sh.spec)


def derive_optimizer_state_shardings(
    state: Any,
    params: Any,
    mesh: Mesh,
    sharding_of: Callable[[str, Any], NamedSharding],
    *,
    replicated_override: Optional[Callable[[str, Any], NamedSharding]] = None,
) -> dict:
    """The optimizer-state sharding engine shared by the plan and
    ``fsdp.optimizer_state_shardings``.

    ``state`` is a torch optimizer or ``{param name: {slot: leaf}}``;
    ``params`` a module or ``{name: tensor}``.  A slot tensor shaped like
    the tensor the optimizer holds for a parameter (its piece, or a ZeRO-2
    slice of it) inherits ``sharding_of(name, param)``; every other leaf
    (step counts, blockwise slots, entries of no parameter) is replicated.
    ``replicated_override(name, param)``, when given, replaces the
    replicated sharding of a param-shaped slot whose parameter is
    replicated: the ZeRO-2 hook (the slot is sharded over ``dp`` by the
    parameter's own shape).  The 8-bit AdamW's blockwise codes stay
    replicated under it, as the JAX package's flat code lists do.  Returns
    ``{name: {slot: NamedSharding}}``."""
    repl = NamedSharding(mesh, ())
    named = _named(params)
    out = {}
    for name, (held, slots) in _state_tree(state, named).items():
        p = named.get(name)
        row = {}
        for slot, leaf in slots.items():
            sh = repl
            if (p is not None and isinstance(leaf, torch.Tensor) and held is not None
                    and tuple(leaf.shape) == tuple(held.shape)):
                sh = sharding_of(name, p)
                if replicated_override is not None and _is_replicated(sh):
                    sh = replicated_override(name, p)
            row[slot] = sh
        out[name] = row
    return out


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """A frozen, declarative sharding plan over one mesh.

    Args:
      mesh: the :class:`~.mesh.Mesh` every derived sharding targets.
      rules: ordered ``(regex, spec)`` pairs matched against dotted
        parameter paths with ``re.search``; the first match wins.  An
        explicit rule applies even to tiny tensors.
      default_axis: placement of paths no rule matches: None replicates
        them, a mesh axis name FSDP-shards them on their first divisible
        dim (``fsdp_partition_spec``, honoring ``min_shard_elems``).
      dp_axis: the data-parallel axis ZeRO-2 shards updates over.
      zero2: when True, optimizer slots whose parameter the plan replicates
        are sharded over ``dp_axis`` by the parameter's own shape
        (``fsdp_partition_spec``), and ``GSPMDTrainStep`` updates each
        rank's ``dp`` slice of such a parameter and all-gathers the result
        (ZeRO-2, arXiv:1910.02054); the parameters stay replicated.
      min_shard_elems: tensors smaller than this stay replicated on the
        ``default_axis`` and ZeRO-2 paths.
      tp_groups: the model's Megatron sub-layers (``parallel.tp.TPGroup``),
        which ``GSPMDTrainStep`` runs on their local shards; a model-specific
        plan (``llama_tp_plan``) declares them.  Not in the JAX plan, whose
        collectives XLA places.
    """

    mesh: Mesh
    rules: tuple = ()
    default_axis: Optional[str] = None
    dp_axis: Optional[str] = None
    zero2: bool = False
    min_shard_elems: int = 1024
    tp_groups: tuple = ()

    def __post_init__(self) -> None:
        rules = tuple((str(pat), _norm_spec(spec)) for pat, spec in self.rules)
        object.__setattr__(self, "rules", rules)
        object.__setattr__(self, "_compiled", tuple((re.compile(p), s) for p, s in rules))
        axis_names = set(self.mesh.axis_names)
        for name in ("default_axis", "dp_axis"):
            ax = getattr(self, name)
            if ax is not None and ax not in axis_names:
                raise PlanError(
                    f"{name}={ax!r} is not a mesh axis (mesh has {sorted(axis_names)})")
        for pat, spec in rules:
            for ax in _spec_axes(spec):
                if ax not in axis_names:
                    raise PlanError(
                        f"rule {pat!r} -> {spec} references axis {ax!r} "
                        f"not in mesh axes {sorted(axis_names)}")
        if self.zero2 and self.dp_axis is None:
            raise PlanError("zero2=True requires dp_axis=")

    # -- constructors ------------------------------------------------------

    @classmethod
    def fsdp(cls, mesh: Mesh, axis: str = "fsdp", min_shard_elems: int = 1024
             ) -> "ShardingPlan":
        """The classic FSDP plan: no rules, every parameter sharded on its
        first divisible dim over ``axis``."""
        return cls(mesh, rules=(), default_axis=axis, min_shard_elems=min_shard_elems)

    @classmethod
    def replicated(cls, mesh: Mesh) -> "ShardingPlan":
        """Everything replicated."""
        return cls(mesh, rules=())

    def with_mesh(self, mesh: Mesh) -> "ShardingPlan":
        """The same rules over another mesh (validated again)."""
        return dataclasses.replace(self, mesh=mesh)

    # -- rule resolution ---------------------------------------------------

    def maybe_spec_for(self, path: str, shape: Sequence[int]) -> Optional[tuple]:
        """The first matching rule's spec, or None when no rule matches."""
        for pat, spec in self._compiled:
            if pat.search(path):
                return spec
        return None

    def spec_for(self, path: str, shape: Sequence[int]) -> tuple:
        """The plan's spec for one parameter path of global ``shape``."""
        spec = self.maybe_spec_for(path, shape)
        if spec is not None:
            return spec
        if self.default_axis is not None:
            return fsdp_partition_spec(tuple(shape), self.mesh, self.default_axis,
                                       self.min_shard_elems)
        return ()

    def sharding_for(self, path: str, like: Any) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(path, _global_shape(like)))

    def as_rule(self) -> Callable[[str, Any], NamedSharding]:
        """``(path, like) -> NamedSharding``, the signature of
        ``materialize_module(sharding_rule=)``."""
        return self.sharding_for

    def describe(self, params: Any) -> dict:
        """``{path: spec}`` over a module or ``{name: tensor}``."""
        return {name: self.spec_for(name, _global_shape(t))
                for name, t in _named(params).items()}

    # -- derived placements ------------------------------------------------

    def param_shardings(self, params: Any) -> dict:
        return {name: self.sharding_for(name, t) for name, t in _named(params).items()}

    def apply(self, params: Any) -> Any:
        """Place parameters by the plan (:func:`place_params`): a module in
        place, a ``{name: tensor}`` dict into a new dict."""
        return place_params(params, self.sharding_for)

    def zero2_sharding(self, path: str, like: Any) -> Optional[NamedSharding]:
        """The ``dp`` sharding of the update of parameter ``path`` under
        ZeRO-2: its own shape over ``dp_axis`` (``fsdp_partition_spec``,
        honoring ``min_shard_elems``) when the plan replicates it and that
        cuts it; else None (the update is not sharded)."""
        if not self.zero2:
            return None
        shape = _global_shape(like)
        if _spec_axes(self.spec_for(path, shape)):
            return None  # the plan shards the parameter itself
        spec = fsdp_partition_spec(shape, self.mesh, self.dp_axis, self.min_shard_elems)
        return NamedSharding(self.mesh, spec) if _spec_axes(spec) else None

    def optimizer_state_shardings(self, state: Any, params: Any) -> dict:
        """``{name: {slot: NamedSharding}}`` derived from the rules: slots
        shaped like their parameter take its rule, the rest replicate; with
        ``zero2=True`` a slot of a parameter the plan replicates is sharded
        over ``dp_axis`` by its own shape."""
        override = None
        if self.zero2:
            def override(path: str, p: Any) -> NamedSharding:
                return self.zero2_sharding(path, p) or NamedSharding(self.mesh, ())

        return derive_optimizer_state_shardings(
            state, params, self.mesh, lambda path, t: self.sharding_for(path, t),
            replicated_override=override)

    def shardings_for(self, *trees: Any) -> tuple:
        """Each tensor's own sharding (``fsdp.donated_carry_shardings``):
        for a plan-placed tree that is the plan's placement."""
        return donated_carry_shardings(*trees)

    # -- validation and pricing --------------------------------------------

    def validate(self, params: Any, *, optimizer_state: Any = None,
                 budget_bytes_per_device: Optional[int] = None,
                 budget_name: str = "device HBM") -> dict:
        """Check a materialized or shape-only state against the plan.

        ``params``: a module or ``{name: tensor}``; ``optimizer_state``: a
        torch optimizer or ``{name: {slot: tensor}}``.  When every tensor
        is real, the state runs through ``obs.memory.sharding_report`` with
        this plan as the intended rule, and ANY flag raises
        :class:`PlanError` with the flags; the report is returned.  When
        they are fake or meta tensors (shapes alone), the rank's bytes are
        priced from the rules (``per_device_bytes``, and the optimizer's
        slots by :meth:`optimizer_state_shardings`) and gated through
        ``obs.memory.capacity_plan``: over ``budget_bytes_per_device`` the
        plan raises with the numbers; the capacity plan is returned.  Both
        failures name the budget (``budget_name``)."""
        from ..obs import memory as obs_memory

        named = _named(params)
        leaves = list(named.values())
        if optimizer_state is not None:
            leaves += [leaf for _, (_, slots) in _state_tree(optimizer_state, named).items()
                       for leaf in slots.values() if isinstance(leaf, torch.Tensor)]
        if leaves and all(obs_memory._real(t) for t in leaves):
            report = obs_memory.sharding_report(
                params, intended_rule=self.as_rule(), optimizer_state=optimizer_state,
                min_shard_elems=self.min_shard_elems,
                budget_bytes_per_device=budget_bytes_per_device)
            if report.get("flags"):
                budget = (f"{budget_name} budget {budget_bytes_per_device} bytes/device"
                          if budget_bytes_per_device is not None else "no per-device budget")
                raise PlanError(f"sharding plan validation failed ({budget}): "
                                f"flags={report['flags']}")
            return report
        components = {"params": self.per_device_bytes(params)}
        if optimizer_state is not None:
            components["optimizer_state"] = self._per_device_bytes_with(
                optimizer_state, self.optimizer_state_shardings(optimizer_state, params),
                named)
        plan_doc = obs_memory.capacity_plan(components, budget_bytes=budget_bytes_per_device)
        if budget_bytes_per_device is not None and not plan_doc["fits"]:
            raise PlanError(
                f"sharding plan overshoots the {budget_name} budget: projected "
                f"{plan_doc['projected_peak_bytes']} bytes/device > "
                f"{budget_bytes_per_device} bytes/device (headroom "
                f"{plan_doc['headroom_bytes']}); components={plan_doc['components']}")
        return plan_doc

    def _num_shards(self, spec) -> int:
        return math.prod(int(self.mesh.shape[ax]) for ax in _spec_axes(spec))

    def per_device_bytes(self, params: Any) -> int:
        """Closed-form parameter bytes a rank holds under the plan."""
        return sum(_leaf_bytes(t) // self._num_shards(self.spec_for(name, _global_shape(t)))
                   for name, t in _named(params).items())

    def _per_device_bytes_with(self, state: Any, shardings: dict, named: dict) -> int:
        """Closed-form bytes a rank holds of an optimizer state under
        ``{name: {slot: NamedSharding}}``."""
        total = 0
        for name, (_, slots) in _state_tree(state, named).items():
            for slot, leaf in slots.items():
                if isinstance(leaf, torch.Tensor):
                    spec = shardings.get(name, {}).get(slot, NamedSharding(self.mesh, ())).spec
                    total += _leaf_bytes(leaf) // self._num_shards(spec)
        return total

    def zero2_participating_bytes(self, params: Any) -> int:
        """Bytes of the parameters whose update ZeRO-2 shards (the plan
        replicates them, and their own shape cuts over ``dp_axis`` above
        ``min_shard_elems``): the step's all-gather payload.  0 without
        ``zero2``."""
        return sum(_leaf_bytes(t) for name, t in _named(params).items()
                   if self.zero2_sharding(name, t) is not None)

    def price_step(self, params: Any) -> list:
        """The plan's collective rows of one train step, from the rules
        alone on the ``obs.comm`` ring model: ``{kind, axis,
        payload_bytes, wire_bytes, count, axis_size}`` each, what the step
        books into the comm audit.  A ``zero2`` plan prices ONE all-gather
        of the participating parameters over ``dp_axis``; a
        ``default_axis`` (FSDP) plan a gather and a reduce-scatter of each
        parameter it shards (payload the whole parameter) and a pmean of
        the others.  The 4-byte loss reductions are not priced."""
        from ..obs.comm import _WIRE

        rows = []

        def row(kind: str, axis: str, payload: int, count: int = 1) -> None:
            n = int(self.mesh.shape[axis])
            ratio = _WIRE.get(kind)
            wire = payload * ratio(n, None) if ratio else float(payload)
            rows.append({"kind": kind, "axis": axis, "payload_bytes": int(payload),
                         "wire_bytes": int(round(wire * count)), "count": int(count),
                         "axis_size": n})

        if self.zero2:
            payload = self.zero2_participating_bytes(params)
            if payload:
                row("all_gather", self.dp_axis, payload)
        if self.default_axis is not None:
            axis = self.default_axis
            for name, t in sorted(_named(params).items()):
                if axis in _spec_axes(self.spec_for(name, _global_shape(t))):
                    row("all_gather", axis, _leaf_bytes(t))
                    row("reduce_scatter", axis, _leaf_bytes(t))
                else:
                    row("pmean", axis, _leaf_bytes(t))
        return rows

    def step_wire_bytes(self, params: Any, kind: Optional[str] = None) -> int:
        """Total closed-form wire bytes of one step (optionally one kind)."""
        return sum(r["wire_bytes"] for r in self.price_step(params)
                   if kind is None or r["kind"] == kind)

    def record_step_collectives(self, params: Any) -> None:
        """Book :meth:`price_step`'s rows into the active comm audit, once
        per dispatched step: a k-step audit equals k times the closed form
        (``GSPMDTrainStep`` does it for a ZeRO-2 plan)."""
        from ..obs.comm import record_collective

        for r in self.price_step(params):
            record_collective(r["kind"], r["axis"], payload_bytes=r["payload_bytes"],
                              count=r["count"], axis_size=r["axis_size"])
