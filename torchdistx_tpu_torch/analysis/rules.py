"""tdx-lint rule pack of the port: the invariants of the torch code as AST
checks, counterpart of ``torchdistx_tpu/analysis/rules.py``.

The rule ids are the JAX package's, so a finding names the same invariant
in both packages.  TDX101 (a donated jit without ``out_shardings``) has no
torch counterpart: the port donates no buffers and pins no output
layouts (PyTorch updates in place, and a tensor's placement is its
``parallel.mesh`` mark).  It stays in :data:`RULE_CATALOG` with that
reason and has no rule object.  TDX102-TDX104 say in torch what the JAX
rules say in jax; TDX105 and TDX106 are the JAX rules as they are (the port
has ``obs/metrics.py`` and ``obs/ledger.py``).  Rules are lexical: stdlib
``ast``, no import of torch, so the linter runs where neither torch nor
jax is installed.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, LintContext, Rule

# ---------------------------------------------------------------------------
# shared AST helpers


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.manual_seed' for an Attribute/Name chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def _has_kwarg(call: ast.Call, *names: str) -> bool:
    return any(kw.arg in names for kw in call.keywords)


def _has_splat(call: ast.Call) -> bool:
    return any(kw.arg is None for kw in call.keywords)


# ---------------------------------------------------------------------------

#: the global generator's seeding calls
_TORCH_SEEDING = {
    "torch.manual_seed",
    "torch.random.manual_seed",
    "torch.seed",
    "torch.random.seed",
}
#: draws from the global generator unless given ``generator=``
_TORCH_DRAWS = {
    "rand",
    "randn",
    "randint",
    "randperm",
    "normal",
    "bernoulli",
    "multinomial",
}
#: in-place initializers (tensor methods and ``torch.nn.init`` functions)
#: that draw from the global generator unless given ``generator=``
_INPLACE_DRAWS = {
    "normal_",
    "uniform_",
    "bernoulli_",
    "exponential_",
    "geometric_",
    "log_normal_",
    "cauchy_",
    "random_",
    "trunc_normal_",
    "xavier_uniform_",
    "xavier_normal_",
    "kaiming_uniform_",
    "kaiming_normal_",
    "orthogonal_",
    "sparse_",
}
_NP_STATEFUL = {
    "seed",
    "rand",
    "randn",
    "random",
    "normal",
    "uniform",
    "randint",
    "permutation",
    "choice",
    "shuffle",
    "standard_normal",
}


class StatefulRngOutsideCounterStream(Rule):
    """TDX102 — ad-hoc RNG outside ``utils/rng.py``.

    Convention: parameter init draws from utils/rng.py's counter stream
    (its ``torch.Generator`` keyed by the counter) — same seed =>
    bit-identical deferred vs eager init.  Seeding or drawing from torch's
    global generator (``torch.manual_seed``, ``torch.seed``,
    ``torch.cuda.manual_seed*``; ``torch.rand`` / ``randn`` / ``randint``
    / ``randperm`` / ``normal`` / ``bernoulli`` / ``multinomial`` and the
    in-place initializers ``normal_`` / ``uniform_`` / ``nn.init.*_``
    without ``generator=``), or numpy's legacy global ``np.random.*``,
    creates a parallel seed universe that breaks that identity.  Seeded
    generators (``torch.Generator().manual_seed(s)``,
    ``np.random.RandomState(s)``, ``np.random.default_rng(s)``) are fine:
    they are explicit streams.
    """

    rule_id = "TDX102"
    severity = "error"
    summary = "stateful RNG outside utils/rng.py counter stream"

    def _label(self, node: ast.Call) -> Optional[str]:
        name = _dotted(node.func) or ""
        if name in _TORCH_SEEDING or name.startswith(
            ("torch.cuda.manual_seed", "torch.cuda.seed")
        ):
            return "seeding %s" % name
        parts = name.split(".")
        if (
            len(parts) == 3
            and parts[0] in ("np", "numpy")
            and parts[1] == "random"
            and parts[2] in _NP_STATEFUL
        ):
            return "global-generator %s" % name
        if _has_kwarg(node, "generator") or _has_splat(node):
            return None
        if len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DRAWS:
            return "%s without generator=" % name
        if isinstance(node.func, ast.Attribute) and node.func.attr in _INPLACE_DRAWS:
            return "%s() without generator=" % (name or node.func.attr)
        return None

    def check(self, ctx: LintContext) -> List[Finding]:
        if ctx.rel_path.endswith("utils/rng.py"):
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            label = self._label(node)
            if label is None:
                continue
            out.append(
                self.finding(
                    ctx,
                    node,
                    "%s: draw from the utils/rng.py counter stream (or a "
                    "seeded torch.Generator / np.random.RandomState passed "
                    "explicitly) so deferred and eager init stay "
                    "bit-identical" % label,
                )
            )
        return out


#: ``torch.distributed`` collectives; a name ending in ``*`` is a prefix
_RAW_COLLECTIVES = (
    "all_reduce",
    "all_gather*",
    "reduce_scatter*",
    "broadcast*",
    "all_to_all*",
    "send",
    "recv",
    "isend",
    "irecv",
    "barrier",
)
_DIST_MODULES = {"dist", "torch.distributed", "distributed"}
#: the port's booking helpers beyond ``record_collective`` and ``_record*``
_BOOKING_HELPERS = {"record_collective", "record_step_collectives"}


def _is_raw_collective(name: str) -> bool:
    for pat in _RAW_COLLECTIVES:
        if pat.endswith("*") and name.startswith(pat[:-1]):
            return True
        if name == pat:
            return True
    return False


def _contains_booking_call(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            callee = _last(_dotted(node.func))
            if callee in _BOOKING_HELPERS or callee.startswith("_record"):
                return True
    return False


class RawCollectiveOutsideChokePoint(Rule):
    """TDX103 — raw ``torch.distributed`` collective invisible to the comm
    audit.

    Convention: collectives route through parallel/collectives.py (or
    book themselves via obs.comm.record_collective) so the closed-form
    wire model in obs/comm.py stays COMPLETE — an unbooked collective
    makes every comm-audit pin an undercount.  A raw ``dist.all_reduce``
    / ``all_gather*`` / ``reduce_scatter*`` / ``broadcast*`` /
    ``all_to_all*`` / ``send`` / ``recv`` / ``isend`` / ``irecv`` is
    exempt only when a lexically enclosing function also books the
    traffic: it calls ``record_collective``, a ``_record*`` helper (the
    collectives' ``_record``, ``ops.attention._record_ring_pass``, the
    engine's ``_record_tp_collectives``) or
    ``ShardingPlan.record_step_collectives``.  ``dist.barrier`` carries
    no payload that a booking call could account for, so no booking
    exempts it: ``parallel.collectives.barrier`` is its choke point.
    """

    rule_id = "TDX103"
    severity = "error"
    summary = "raw torch.distributed collective outside parallel/collectives.py"

    def check(self, ctx: LintContext) -> List[Finding]:
        if ctx.rel_path.endswith("parallel/collectives.py"):
            return []
        out = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func) or ""
            if "." not in name:
                continue
            base, op = name.rsplit(".", 1)
            if base not in _DIST_MODULES or not _is_raw_collective(op):
                continue
            if op != "barrier" and any(
                _contains_booking_call(fn)
                for fn in ctx.enclosing_functions(node)
            ):
                continue
            out.append(
                self.finding(
                    ctx,
                    node,
                    "raw %s bypasses parallel/collectives.py: the "
                    "obs/comm.py audit cannot see it, so comm pins "
                    "undercount wire bytes — use the choke-point wrapper "
                    "or book it with record_collective in the enclosing "
                    "function" % name,
                )
            )
        return out


_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
_GRAPHED_CALLABLES = {"make_graphed_callables"}
_LOOP_METHODS = {"capture", "run"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_SYNC_CASTS = {"float", "int", "bool"}


def _is_loop_receiver(node: ast.AST) -> bool:
    """``x.loop`` / ``loop`` / ``graph_loop`` / ``GraphLoop(...)``: the
    names the port gives a ``serve.graph_loop.GraphLoop``."""
    if isinstance(node, ast.Call):
        return _last(_dotted(node.func)) == "GraphLoop"
    return _last(_dotted(node)).lower().endswith("loop")


class HostSyncInCapturedBody(Rule):
    """TDX104 — host synchronisation lexically inside a captured body.

    Convention: a body captured into a CUDA graph never host-syncs (the
    persistent-loop lesson: one stray ``.item()`` either breaks the
    capture or, replayed, reads a value frozen at capture time).
    "Captured" = the body of a ``with torch.cuda.graph(...)`` block, or a
    function passed by name (a ``self.<method>`` included) or as an
    inline lambda to ``GraphLoop.capture`` / ``GraphLoop.run`` (a receiver
    named ``*loop``) or to ``torch.cuda.make_graphed_callables``.  "Host
    sync" = ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize`` / ``Event.synchronize`` (any
    ``.synchronize()``), and ``float`` / ``int`` / ``bool`` of a call
    result.
    """

    rule_id = "TDX104"
    severity = "warning"
    summary = "host sync (.item/.tolist/.cpu/synchronize/float) in captured body"

    def _captured(self, ctx: LintContext) -> List[ast.AST]:
        names: Set[str] = set()
        roots: List[ast.AST] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ce = item.context_expr
                    if isinstance(ce, ast.Call) and _dotted(ce.func) in _GRAPH_CONTEXTS:
                        roots.extend(node.body)
                        break
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            takes_body = _last(_dotted(func)) in _GRAPHED_CALLABLES or (
                isinstance(func, ast.Attribute)
                and func.attr in _LOOP_METHODS
                and _is_loop_receiver(func.value)
            )
            if not takes_body:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    roots.append(arg)
                elif isinstance(arg, (ast.Name, ast.Attribute)):
                    names.add(_last(_dotted(arg)))
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in names:
                    roots.append(node)
        return roots

    @staticmethod
    def _label(node: ast.Call) -> Optional[str]:
        func = node.func
        if (
            isinstance(func, ast.Name)
            and func.id in _HOST_SYNC_CASTS
            and node.args
            and isinstance(node.args[0], ast.Call)
        ):
            return "%s() of a call result" % func.id
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _HOST_SYNC_METHODS
            and not node.args
        ):
            return "." + func.attr + "()"
        if _dotted(func) == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        return None

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        seen: Set[Tuple[int, int]] = set()
        for root in self._captured(ctx):
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                loc = (node.lineno, node.col_offset)
                if loc in seen:
                    continue
                label = self._label(node)
                if label is None:
                    continue
                seen.add(loc)
                out.append(
                    self.finding(
                        ctx,
                        node,
                        "%s inside a captured body forces a device->host "
                        "sync: a CUDA graph cannot capture it, and a replay "
                        "reads the value frozen at capture — hoist it out "
                        "of the captured iteration" % label,
                    )
                )
        return out


_REG_METHODS = {"counter", "gauge", "summary"}


def _neg_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return isinstance(node.operand, ast.Constant)
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    ) and node.value < 0


class MetricsRegistryMisuse(Rule):
    """TDX105 — metrics contract violations.

    (a) Counters are monotone: ``Counter.inc`` raises on negative at
    runtime; ``.set``/``.dec`` on a counter handle doesn't exist and
    fails only when first executed.  Catch it statically.
    (b) A ``tdx_*`` MetricFamily emitted with a literal name that no
    registry ever registers (and whose ``tdx_<component>`` prefix no
    collector declares) scrapes as a ghost series no dashboard knows.
    """

    rule_id = "TDX105"
    severity = "error"
    summary = "counter decrement/set, or unregistered tdx_* metric family"

    def collect(self, ctx: LintContext) -> None:
        names: Set[str] = ctx.shared.setdefault(  # type: ignore[assignment]
            "TDX105.names", set()
        )
        prefixes: Set[str] = ctx.shared.setdefault(  # type: ignore[assignment]
            "TDX105.prefixes", set()
        )
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REG_METHODS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    names.add(node.args[0].value)
                for kw in node.keywords:
                    if (
                        kw.arg == "prefix"
                        and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, str)
                    ):
                        prefixes.add(kw.value.value)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                # align defaults right-to-left over positional args
                pos = args.posonlyargs + args.args
                for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
                    if (
                        a.arg == "prefix"
                        and isinstance(d, ast.Constant)
                        and isinstance(d.value, str)
                    ):
                        prefixes.add(d.value)
                for a, d in zip(args.kwonlyargs, args.kw_defaults):
                    if (
                        d is not None
                        and a.arg == "prefix"
                        and isinstance(d, ast.Constant)
                        and isinstance(d.value, str)
                    ):
                        prefixes.add(d.value)

    def _counter_vars(self, ctx: LintContext) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            if not isinstance(val, ast.Call):
                continue
            is_counter = (
                isinstance(val.func, ast.Attribute)
                and val.func.attr == "counter"
            ) or _dotted(val.func) in ("Counter", "metrics.Counter")
            if not is_counter:
                continue
            for tgt in node.targets:
                d = _dotted(tgt)
                if d:
                    out.add(d)
        return out

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        counter_vars = self._counter_vars(ctx)
        names: Set[str] = ctx.shared.get("TDX105.names", set())  # type: ignore[assignment]
        prefixes: Set[str] = ctx.shared.get("TDX105.prefixes", set())  # type: ignore[assignment]
        roots = {p for p in prefixes} | {
            "_".join(n.split("_")[:2]) for n in names | prefixes
        }
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                base = _dotted(node.func.value)
                if base in counter_vars:
                    if node.func.attr in ("set", "dec"):
                        out.append(
                            self.finding(
                                ctx,
                                node,
                                "counter %s.%s(): counters are monotone — "
                                "Counter only has inc(); use a Gauge for "
                                "set/dec semantics" % (base, node.func.attr),
                            )
                        )
                        continue
                    if node.func.attr == "inc" and node.args and _neg_literal(
                        node.args[0]
                    ):
                        out.append(
                            self.finding(
                                ctx,
                                node,
                                "counter %s.inc(negative): Counter.inc "
                                "raises on negative amounts at runtime"
                                % base,
                            )
                        )
                        continue
            if (
                _last(_dotted(node.func)) == "MetricFamily"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                mname = node.args[0].value
                if not mname.startswith("tdx_"):
                    continue
                root = "_".join(mname.split("_")[:2])
                if mname in names or root in roots:
                    continue
                out.append(
                    self.finding(
                        ctx,
                        node,
                        "MetricFamily(%r) emits a tdx_* series that no "
                        "registry registers and no collector prefix "
                        "declares — ghost metric" % mname,
                    )
                )
        return out


_WALL_CLOCKS = {
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.monotonic_ns",
}


class NondeterminismInCounterRows(Rule):
    """TDX106 — nondeterministic inputs near exact-gated counter rows.

    Convention: ledger rows with ``metric_class="counter"`` compare
    EXACTLY across runs in the perf gate — a wall-clock read or a
    set-iteration order feeding one makes the gate flap.  Flagged inside
    any function that creates counter-class rows.
    """

    rule_id = "TDX106"
    severity = "warning"
    summary = "wall-clock or set-iteration in a counter-row-producing function"

    def _makes_counter_rows(self, fn: ast.AST) -> bool:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if (
                    kw.arg == "metric_class"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value == "counter"
                ):
                    return True
            if _last(_dotted(node.func)) in ("make_row", "counter_row") and any(
                isinstance(a, ast.Constant) and a.value == "counter"
                for a in node.args
            ):
                return True
        return False

    def check(self, ctx: LintContext) -> List[Finding]:
        out = []
        seen: Set[Tuple[int, int]] = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not self._makes_counter_rows(fn):
                continue
            for node in ast.walk(fn):
                loc = (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
                if isinstance(node, ast.Call):
                    name = _dotted(node.func) or ""
                    if name in _WALL_CLOCKS or name.endswith("datetime.now"):
                        if loc in seen:
                            continue
                        seen.add(loc)
                        out.append(
                            self.finding(
                                ctx,
                                node,
                                "%s() in a function producing "
                                "metric_class='counter' rows: counter rows "
                                "gate EXACTLY — derive values from counted "
                                "events, keep wall clocks out or move them "
                                "to timing-band rows" % name,
                            )
                        )
                elif isinstance(node, (ast.For, ast.comprehension)):
                    it = node.iter
                    if isinstance(it, ast.Set) or (
                        isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id == "set"
                    ):
                        if loc in seen:
                            continue
                        seen.add(loc)
                        out.append(
                            self.finding(
                                ctx,
                                node,
                                "iterating a set in a function producing "
                                "counter rows: set order is "
                                "hash-randomised — sort it first",
                            )
                        )
        return out


def default_rules() -> List[Rule]:
    return [
        StatefulRngOutsideCounterStream(),
        RawCollectiveOutsideChokePoint(),
        HostSyncInCapturedBody(),
        MetricsRegistryMisuse(),
        NondeterminismInCounterRows(),
    ]


#: id -> (severity, one-line summary); TDX100 is emitted by the core, and
#: TDX101 names the JAX rule that has no torch counterpart.
RULE_CATALOG: Dict[str, Tuple[str, str]] = {
    "TDX100": ("error", "tdx-lint suppression without justification text"),
    "TDX101": (
        "error",
        "no torch counterpart: the port donates no buffers and pins no "
        "out_shardings (a JAX jit's donated-carry layouts)",
    ),
    **{
        r.rule_id: (r.severity, r.summary)
        for r in default_rules()
    },
}
