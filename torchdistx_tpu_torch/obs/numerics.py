"""Numerics observatory: on-device value digests with nonfinite provenance
(schema ``tdx-numerics-v1``), counterpart of ``torchdistx_tpu/obs/numerics.py``.

The other obs layers watch resources (bytes, FLOPs, microseconds,
collectives); this one watches the values: where the NaNs are, where the
zeros are, and the magnitude distribution of an activation, gradient,
logit or KV-error tensor, as a small summary instead of the tensor.

A **digest** of a tensor is a handful of reductions computed on its
device: ``nonfinite``, ``zeros``, ``count`` and ``exp_hist`` (32 buckets
of the f32 biased exponent of ``|x|``, 8 exponents a bucket) are integer
sums of per-element predicates, exact and independent of the reduction
order, so equal across runs, devices and mesh shapes; ``max_abs`` (exact,
but a float) and ``sumsq`` (a float sum) are gauges.  The classification
reads the bit pattern of ``x.float()`` (``view(torch.int32)``, the sign
masked off), as the JAX package's does, so

    count == nonfinite + zeros + sum(exp_hist)

holds by construction.  The integer fields come from ONE ``index_add_`` of
ones into a preallocated histogram of 34 entries (32 buckets, then
nonfinite, then zeros), spread over up to 1024 rows by element index and
summed: integer atomics are exact in any order, and no shape depends on the
data, so a digest can be captured in a CUDA graph (``torch.bincount`` would
size its output from the data, a host sync).  The integer fields are
int64 on the device, where the JAX package's are int32: the same values
within its range, none of its overflow on a long persistent loop.

**The tape.**  JAX records digests at trace time into a thread-local
tape; PyTorch runs eagerly, so here the tape records while the code runs:
``numerics_tape(sites=)`` installs a :class:`Tape` for a region,
``tap(site, x)`` is an identity that digests ``x`` into the innermost tape
when one is active and accepts the site, and costs nothing otherwise.
A tape with declared ``sites`` starts every site at the zero digest (the
JAX loop carry's static structure), so a harvested book holds every
declared site even when nothing tapped it.  ``Tape(defer=True)`` keeps a
site's tapped tensors and digests them in ONE pass at :meth:`Tape.digests`:
the integer fields and ``max_abs`` are the same, only ``sumsq`` (a gauge)
sums in another order; the serving decode steps use it to launch a few
kernels a site per step instead of a few per tapped tensor (``tap_made``
defers the KV dequantization error's arithmetic the same way).

The host side (:class:`HostDigest`, :class:`NumericsBook` with its ledger
counter rows, drift rows, metrics collector and Perfetto counter tracks)
is the JAX package's, copied.  ``TDX_NUMERICS`` is the default for the
trainer and serving flags (:func:`numerics_enabled`).
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

__all__ = [
    "NUMERICS_SCHEMA",
    "NBUCKETS",
    "BUCKET_WIDTH",
    "numerics_enabled",
    "array_digest",
    "error_digest",
    "zero_digest",
    "merge_digests",
    "merge_digest_trees",
    "reduce_stacked_digests",
    "allreduce_digests",
    "fold_digests",
    "fold_host_digests",
    "mesh_group_digest",
    "tree_group_digest",
    "provenance_key",
    "numerics_tape",
    "active_tape",
    "tap",
    "tap_error",
    "tap_made",
    "tree_digest",
    "fetch_digests",
    "StagedDigests",
    "Tape",
    "HostDigest",
    "NumericsBook",
]

NUMERICS_SCHEMA = "tdx-numerics-v1"

#: base-2 exponent buckets of |x|: bucket ``i`` holds the finite nonzero
#: elements whose f32 biased exponent ``bexp`` has ``bexp // 8 == i``
#: (bucket 0 also holds the subnormals, ``bexp == 0``)
NBUCKETS = 32
BUCKET_WIDTH = 8

#: the packed integer histogram: the buckets, then nonfinite, then zeros
_NONFINITE = NBUCKETS
_ZEROS = NBUCKETS + 1
#: a digest spreads its histogram atomics over up to this many rows, one
#: row per this many elements
_SPREAD_ROWS = 1024
_SPREAD_MIN = 256

_OFF_VALUES = ("0", "false", "")


def numerics_enabled(default: bool = False) -> bool:
    """``TDX_NUMERICS`` as the default of the trainer and serving flags;
    an explicit constructor flag (``ServeEngine(numerics=True)``) wins."""
    v = os.environ.get("TDX_NUMERICS")
    if v is None:
        return default
    return v.strip().lower() not in _OFF_VALUES


# -- device side --------------------------------------------------------


def zero_digest(device=None) -> Dict[str, torch.Tensor]:
    """The merge identity."""
    return {
        "nonfinite": torch.zeros((), dtype=torch.int64, device=device),
        "zeros": torch.zeros((), dtype=torch.int64, device=device),
        "count": torch.zeros((), dtype=torch.int64, device=device),
        "exp_hist": torch.zeros((NBUCKETS,), dtype=torch.int64, device=device),
        "max_abs": torch.zeros((), dtype=torch.float32, device=device),
        "sumsq": torch.zeros((), dtype=torch.float32, device=device),
    }


def array_digest(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Digest one tensor on its device with a fixed handful of kernels and
    no host sync (capturable).  ``max_abs`` and ``sumsq`` leave the
    nonfinite elements out, so one NaN does not poison the magnitude
    summary it is counted beside; ``max_abs`` of an empty tensor is 0."""
    xf = x.detach().float().reshape(-1)  # bf16/f16 -> f32 is exact
    n = xf.numel()
    mag = xf.view(torch.int32) & 0x7FFFFFFF
    nonfinite = mag >= 0x7F800000  # inf and nan
    # bexp // 8 == mag >> 26 for the finite magnitudes (bexp <= 254)
    code = torch.where(nonfinite, _NONFINITE, torch.where(mag == 0, _ZEROS, mag >> 26))
    # element i adds into row i % rows of a (rows, 34) histogram: the
    # atomics of a large tensor spread over many addresses instead of
    # queueing on 34 (exact in any order all the same)
    rows = max(1, min(_SPREAD_ROWS, n // _SPREAD_MIN))
    if rows > 1:
        code = code + (torch.arange(n, dtype=torch.int32, device=xf.device) % rows) * (NBUCKETS + 2)
    hist = torch.zeros(rows * (NBUCKETS + 2), dtype=torch.int64, device=xf.device)
    hist.index_add_(0, code, torch.ones((), dtype=torch.int64, device=xf.device).expand(n))
    hist = hist.view(rows, NBUCKETS + 2).sum(0) if rows > 1 else hist
    safe = torch.where(nonfinite, 0.0, xf.abs())
    return {
        "nonfinite": hist[_NONFINITE],
        "zeros": hist[_ZEROS],
        "count": torch.full((), n, dtype=torch.int64, device=xf.device),
        "exp_hist": hist[:NBUCKETS],
        "max_abs": (safe.amax() if n else torch.zeros((), device=xf.device)),
        "sumsq": (safe * safe).sum(),
    }


def error_digest(x: torch.Tensor, x_hat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Digest of ``x - x_hat`` (both in f32): the KV dequantization-error
    probe; ``max_abs`` is the worst element's error."""
    return array_digest(x.detach().float() - x_hat.detach().float())


def merge_digests(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Associative merge: sums, the histogram elementwise, ``max_abs`` max."""
    return {
        "nonfinite": a["nonfinite"] + b["nonfinite"],
        "zeros": a["zeros"] + b["zeros"],
        "count": a["count"] + b["count"],
        "exp_hist": a["exp_hist"] + b["exp_hist"],
        "max_abs": torch.maximum(a["max_abs"], b["max_abs"]),
        "sumsq": a["sumsq"] + b["sumsq"],
    }


def merge_digest_trees(a: Dict[str, Dict[str, Any]],
                       b: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Merge two ``{site: digest}`` dicts with the same sites."""
    if set(a) != set(b):
        raise ValueError(f"digest site mismatch: {sorted(a)} vs {sorted(b)}")
    return {site: merge_digests(a[site], b[site]) for site in a}


def reduce_stacked_digests(digests: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Merge a ``{site: digest}`` tree whose fields carry a stacked leading
    dim (one entry per microbatch or step) into single digests."""
    out = {}
    for site, d in digests.items():
        out[site] = {
            "nonfinite": d["nonfinite"].sum(0),
            "zeros": d["zeros"].sum(0),
            "count": d["count"].sum(0),
            "exp_hist": d["exp_hist"].sum(0),
            "max_abs": d["max_abs"].amax(0),
            "sumsq": d["sumsq"].sum(0),
        }
    return out


def _inexact(x) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())


def tree_group_digest(named: Any, prefix: str = "", depth: int = 2) -> Dict[str, Dict[str, Any]]:
    """Digest every floating tensor of ``named`` (``{path: tensor}`` or an
    iterable of ``(path, tensor)``, such as ``named_parameters()``), merged
    into groups keyed by the first ``depth`` dot components of the path:
    ``params/blocks.0``, ``grads/tok_emb.weight``; the JAX package's keys
    for the same model.  None entries are skipped."""
    items = named.items() if isinstance(named, dict) else named
    groups: Dict[str, Dict[str, Any]] = {}
    for path, leaf in items:
        if leaf is None or not _inexact(leaf):
            continue
        key = prefix + ".".join(str(path).split(".")[:depth])
        d = array_digest(leaf)
        prev = groups.get(key)
        groups[key] = d if prev is None else merge_digests(prev, d)
    return groups


_STAGE_RANK = {"params": 0, "act": 1, "logits": 2, "loss": 3, "grads": 4}


def provenance_key(site: str):
    """Sort key giving program order over site names: params, activations,
    logits, loss, grads, natural-sorted within a stage (``act/block10``
    after ``act/block2``)."""
    stage = site.split("/", 1)[0]
    rank = _STAGE_RANK.get(stage, len(_STAGE_RANK) + 1)
    nat = tuple((0, int(p)) if p.isdigit() else (1, p)
                for p in re.split(r"(\d+)", site) if p)
    return (rank, nat)


def allreduce_digests(digests: Dict[str, Dict[str, Any]], axes,
                      mesh_shape: Dict[str, int]) -> Dict[str, Dict[str, Any]]:
    """Fold per-rank digests into global ones over the ``axes`` of the
    active mesh (the JAX function's ``psum`` / ``pmax`` inside
    ``shard_map``): the integer fields and ``sumsq`` summed (the integers
    exactly, in any order), ``max_abs`` maxed.  The comm audit books the
    JAX function's rows: one ``psum`` of count 2 carrying ``3 + NBUCKETS``
    int32 and two f32 words a site, and one ``pmax`` of one f32 word a
    site.  The transport is :func:`fold_digests`."""
    from .comm import record_collective

    axes = tuple(axes)
    if not axes or not digests:
        return digests
    group = 1
    for ax in axes:
        group *= int(mesh_shape[ax])
    name = axes[0] if len(axes) == 1 else axes
    record_collective("psum", name, payload_bytes=len(digests) * (4 * (3 + NBUCKETS) + 4 * 2),
                      count=2, axis_size=group)
    record_collective("pmax", name, payload_bytes=len(digests) * 4, axis_size=group)
    return fold_digests(digests, axes)


def fold_digests(digests: Dict[str, Dict[str, Any]], axes) -> Dict[str, Dict[str, Any]]:
    """Sum (``max_abs``: max) ``{site: digest}`` over each of ``axes`` of
    the active mesh, books nothing: three all-reduces of the packed fields
    on each axis's group through ``parallel.collectives``' private helpers
    (bytes counted in its ``payload_bytes``).  Every rank gets the same
    result."""
    from ..parallel import collectives

    axes = tuple(axes)
    if not axes or not digests:
        return digests
    sites = list(digests)
    ints = torch.stack([torch.cat([digests[s]["exp_hist"].long(), torch.stack(
        [digests[s][f].long() for f in ("nonfinite", "zeros", "count")])]) for s in sites])
    sums = torch.stack([digests[s]["sumsq"].float() for s in sites])
    mx = torch.stack([digests[s]["max_abs"].float() for s in sites])
    for ax in collectives._axes(axes):
        ints, sums = collectives._psum(ints, ax), collectives._psum(sums, ax)
        mx = collectives._pmax(mx, ax)
    return {s: {"nonfinite": ints[i, NBUCKETS], "zeros": ints[i, NBUCKETS + 1],
                "count": ints[i, NBUCKETS + 2], "exp_hist": ints[i, :NBUCKETS],
                "max_abs": mx[i], "sumsq": sums[i]}
            for i, s in enumerate(sites)}


def fold_host_digests(trees: List[Dict[str, "HostDigest"]], sites: Iterable[str],
                      axes) -> List[Dict[str, "HostDigest"]]:
    """:func:`fold_digests` of host digests: the ``sites`` of each tree in
    ``trees`` (``{site: HostDigest}``, as :meth:`StagedDigests.read`
    returns them) summed (``max_abs``: maxed) over ``axes`` of the active
    mesh, the other sites as they are; books nothing.  Three all-reduces a
    call whatever the number of trees: the integer fields as int64, the
    gauges as f64, host tensors on a ``gloo`` group (the fold waits on no
    device work).  Every
    rank must call it with as many trees, a site absent from a tree
    taking part as zeros."""
    from ..parallel import collectives

    sites = tuple(sites)
    rows = [(i, s) for i in range(len(trees)) for s in sites]
    if not rows:
        return trees
    ints = torch.zeros((len(rows), NBUCKETS + 3), dtype=torch.int64)
    sums = torch.zeros(len(rows), dtype=torch.float64)
    mx = torch.zeros(len(rows), dtype=torch.float64)
    for r, (i, s) in enumerate(rows):
        d = trees[i].get(s)
        if d is not None:
            ints[r] = torch.tensor(list(d.exp_hist) + [d.nonfinite, d.zeros, d.count])
            sums[r], mx[r] = d.sumsq, d.max_abs
    for ax in collectives._axes(tuple(axes)):
        ints, sums = collectives._psum(ints, ax), collectives._psum(sums, ax)
        mx = collectives._pmax(mx, ax)
    ih, sh, mh = ints.tolist(), sums.tolist(), mx.tolist()
    out = [dict(t) for t in trees]
    for r, (i, s) in enumerate(rows):
        if s in trees[i]:
            out[i][s] = HostDigest(nonfinite=ih[r][NBUCKETS], zeros=ih[r][NBUCKETS + 1],
                                   count=ih[r][NBUCKETS + 2], exp_hist=ih[r][:NBUCKETS],
                                   max_abs=mh[r], sumsq=sh[r])
    return out


def mesh_group_digest(items: Iterable, prefix: str, mesh_axes: Iterable[str],
                      depth: int = 2) -> Dict[str, Dict[str, Any]]:
    """:func:`tree_group_digest` of tensors held in pieces over a mesh, in
    the active mesh: ``items`` are ``(path, piece, cut_axes)``, ``cut_axes``
    the mesh axes over which the ranks hold different pieces.  A rank
    digests its piece when it is index 0 on every other axis of
    ``mesh_axes`` (one holder of each distinct piece), and the partial
    digests are folded over ``mesh_axes`` (:func:`fold_digests`): the
    digests of the whole tensors, what the JAX package's train steps take
    on their global arrays, the same on every rank."""
    from ..parallel import collectives

    mesh_axes = tuple(mesh_axes)
    first = {ax: collectives.axis_index(ax) == 0 for ax in mesh_axes}
    groups: Dict[str, Dict[str, Any]] = {}
    for path, leaf, cut in items:
        if leaf is None or not _inexact(leaf):
            continue
        held = all(first[ax] for ax in mesh_axes if ax not in cut)
        key = prefix + ".".join(str(path).split(".")[:depth])
        d = array_digest(leaf if held else leaf.new_empty(0))
        prev = groups.get(key)
        groups[key] = d if prev is None else merge_digests(prev, d)
    return fold_digests(groups, mesh_axes)


# -- the tape -----------------------------------------------------------

_TLS = threading.local()


class Tape:
    """Ordered digest accumulator.  ``sites=None`` accepts every tap; a
    declared tuple restricts the tape to those sites and starts each at the
    zero digest (on ``device``).  ``defer=True`` keeps each site's tapped
    tensors (flattened, f32) and digests them in one pass when
    :meth:`digests` is read (module docstring)."""

    def __init__(self, sites: Optional[Iterable[str]] = None, *, device=None,
                 defer: bool = False):
        self.sites = None if sites is None else tuple(sites)
        self.defer = bool(defer)
        self._digests: Dict[str, Dict[str, Any]] = {}
        self._held: Dict[str, List[torch.Tensor]] = {}
        if self.sites is not None:
            for s in self.sites:
                self._digests[s] = zero_digest(device)

    def accepts(self, site: str) -> bool:
        return self.sites is None or site in self.sites

    def record(self, site: str, digest: Dict[str, Any]) -> None:
        prev = self._digests.get(site)
        self._digests[site] = digest if prev is None else merge_digests(prev, digest)

    def hold(self, site: str, *parts: torch.Tensor, make: Optional[Callable] = None) -> None:
        """Tap ``make(*parts)`` (``parts[0]`` when ``make`` is None) at
        ``site``: digested now, or on a deferring tape kept until
        :meth:`digests`, which concatenates each part over the site's taps
        along dim 0 and calls ``make`` once."""
        if not self.defer:
            self.record(site, array_digest(parts[0] if make is None else make(*parts)))
            return
        if make is None:
            parts = (parts[0].detach().float().reshape(-1),)
        key = (make, tuple(tuple(p.shape[1:]) for p in parts))
        self._held.setdefault(site, {}).setdefault(key, []).append(parts)
        self._digests.setdefault(site, None)

    def digests(self) -> Dict[str, Dict[str, Any]]:
        """The accumulated ``{site: digest}``, in tap order (declared order
        when ``sites`` was given)."""
        held, self._held = self._held, {}
        for site, groups in held.items():
            for (make, _), taps in groups.items():
                cols = [c[0] if len(c) == 1 else torch.cat(c) for c in zip(*taps)]
                d = array_digest(cols[0] if make is None else make(*cols))
                prev = self._digests[site]
                self._digests[site] = d if prev is None else merge_digests(prev, d)
        return dict(self._digests)


@contextmanager
def numerics_tape(sites: Optional[Iterable[str]] = None, *, device=None,
                  defer: bool = False):
    """Install a :class:`Tape` for a region; nesting is LIFO and ``tap``
    records into the innermost tape only."""
    tape = Tape(sites, device=device, defer=defer)
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    stack.append(tape)
    try:
        yield tape
    finally:
        stack.pop()


def active_tape() -> Optional[Tape]:
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


def tap(site: str, x):
    """Identity on ``x``; digests it into the innermost active tape when
    that tape accepts ``site`` and ``x`` is a floating tensor.  Without a
    tape it does nothing, so model forwards carry taps for free."""
    tape = active_tape()
    if tape is None or not tape.accepts(site) or not _inexact(x):
        return x
    tape.hold(site, x)
    return x


def tap_error(site: str, x, x_hat) -> None:
    """Record the digest of ``x - x_hat`` at ``site`` (observation only)."""
    tape = active_tape()
    if tape is None or not tape.accepts(site):
        return
    tape.hold(site, x.detach().float() - x_hat.detach().float())


def tap_made(site: str, make: Callable, *parts: torch.Tensor) -> None:
    """Record the digest of ``make(*parts)`` at ``site`` (observation
    only).  A deferring tape concatenates each part over the step's taps of
    the site along dim 0 first and calls ``make`` once, so ``make`` must
    act row by row (the KV dequantization error of many writes: one
    subtraction instead of one a write)."""
    tape = active_tape()
    if tape is None or not tape.accepts(site):
        return
    tape.hold(site, *(p.detach() for p in parts), make=make)


def tree_digest(named: Any, prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """``{prefix + path: digest}`` of every floating tensor of ``named``
    (``{path: tensor}`` or ``(path, tensor)`` pairs): the init-time probe,
    deferred init against eager construction as digest equality.  Its own
    work, never on a steady-state path."""
    items = named.items() if isinstance(named, dict) else named
    with torch.no_grad():
        return {prefix + str(path): array_digest(leaf) for path, leaf in items
                if leaf is not None and _inexact(leaf)}


class StagedDigests:
    """Digest trees packed into ONE int64 buffer on their device, whose copy
    to the host is queued at once: into pinned memory with
    ``non_blocking=True`` on the card (an event marks its end), the packed
    tensor itself on the CPU.  Stage right after the work that made the
    digests and before a sync the caller already owns; :meth:`read` after
    that sync then copies nothing and waits on nothing.  A row a site: the
    buckets, ``nonfinite``, ``zeros``, ``count``, then ``max_abs`` and
    ``sumsq`` as f64 bit patterns (exact for the f32 gauges)."""

    __slots__ = ("_keys", "_n", "_host", "_event")

    def __init__(self, trees: List[Dict[str, Dict[str, Any]]]) -> None:
        self._keys = [(i, site) for i, tree in enumerate(trees) for site in tree]
        self._n = len(trees)
        self._host = self._event = None
        if not self._keys:
            return
        packed = torch.stack([
            torch.cat([d["exp_hist"].reshape(-1).long(),
                       torch.stack([d["nonfinite"], d["zeros"], d["count"]]).reshape(-1).long(),
                       torch.stack([d["max_abs"].reshape(()), d["sumsq"].reshape(())])
                       .double().view(torch.int64)])
            for tree in trees for d in tree.values()])
        if packed.is_cuda:
            self._host = torch.empty(packed.shape, dtype=torch.int64, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = packed

    def read(self) -> List[Dict[str, "HostDigest"]]:
        """The trees as :class:`HostDigest` trees, in staging order.  Waits
        on the copy only if no sync has passed it yet."""
        out: List[Dict[str, HostDigest]] = [{} for _ in range(self._n)]
        if not self._keys:
            return out
        if self._event is not None and not self._event.query():
            self._event.synchronize()
        ih = self._host[:, :NBUCKETS + 3].tolist()
        fh = self._host[:, NBUCKETS + 3:].contiguous().view(torch.float64).tolist()
        for (i, site), iv, fv in zip(self._keys, ih, fh):
            out[i][site] = HostDigest(nonfinite=iv[NBUCKETS], zeros=iv[NBUCKETS + 1],
                                      count=iv[NBUCKETS + 2], exp_hist=iv[:NBUCKETS],
                                      max_abs=fv[0], sumsq=fv[1])
        return out


def fetch_digests(trees: List[Dict[str, Dict[str, Any]]]) -> List[Dict[str, "HostDigest"]]:
    """Copy digest trees to the host as :class:`HostDigest` trees in one
    copy, waiting for it: for callers with no sync of their own (the
    serving and training harvests stage with :class:`StagedDigests`
    before their sync instead)."""
    return StagedDigests(trees).read()


# -- host side (the JAX package's, copied) --------------------------------


def _as_int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _as_float(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


class HostDigest:
    """One site's digest on the host: plain ints, floats and an int list,
    merged with the device side's rules.  Equality compares the exact
    integer fields; ``max_abs`` and ``rms`` are the platform's floats."""

    __slots__ = ("nonfinite", "zeros", "count", "exp_hist", "max_abs", "sumsq")

    def __init__(self, nonfinite=0, zeros=0, count=0, exp_hist=None,
                 max_abs=0.0, sumsq=0.0):
        self.nonfinite = _as_int(nonfinite)
        self.zeros = _as_int(zeros)
        self.count = _as_int(count)
        if exp_hist is None:
            self.exp_hist = [0] * NBUCKETS
        elif isinstance(exp_hist, torch.Tensor):
            self.exp_hist = [int(v) for v in exp_hist.tolist()]
        else:
            self.exp_hist = [int(v) for v in exp_hist]
        self.max_abs = _as_float(max_abs)
        self.sumsq = _as_float(sumsq)

    @classmethod
    def from_device(cls, d: Dict[str, Any]) -> "HostDigest":
        """Build from a digest dict of tensors (each copied to the host)
        or of host values."""
        return cls(nonfinite=d["nonfinite"], zeros=d["zeros"], count=d["count"],
                   exp_hist=d["exp_hist"], max_abs=d["max_abs"], sumsq=d["sumsq"])

    def merge(self, other: "HostDigest") -> "HostDigest":
        return HostDigest(
            nonfinite=self.nonfinite + other.nonfinite,
            zeros=self.zeros + other.zeros,
            count=self.count + other.count,
            exp_hist=[a + b for a, b in zip(self.exp_hist, other.exp_hist)],
            max_abs=max(self.max_abs, other.max_abs),
            sumsq=self.sumsq + other.sumsq,
        )

    @property
    def rms(self) -> float:
        return math.sqrt(self.sumsq / self.count) if self.count else 0.0

    @property
    def hist_hash(self) -> int:
        """FNV-1a (64-bit) fold of the exact integer fields, kept below
        2**53 so a double holds it exactly."""
        h = 0xCBF29CE484222325
        for v in (self.nonfinite, self.zeros, self.count, *self.exp_hist):
            h ^= int(v) & 0xFFFFFFFFFFFFFFFF
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h & 0x1FFFFFFFFFFFFF

    def int_fields(self) -> Dict[str, int]:
        """The exact-class fields (ledger counter material)."""
        return {"nonfinite": self.nonfinite, "zeros": self.zeros,
                "count": self.count, "hist_hash": self.hist_hash}

    def to_json(self) -> dict:
        return {"nonfinite": self.nonfinite, "zeros": self.zeros, "count": self.count,
                "exp_hist": list(self.exp_hist), "hist_hash": self.hist_hash,
                "max_abs": self.max_abs, "rms": self.rms}

    def __eq__(self, other) -> bool:
        if not isinstance(other, HostDigest):
            return NotImplemented
        return (self.nonfinite == other.nonfinite and self.zeros == other.zeros
                and self.count == other.count and self.exp_hist == other.exp_hist)

    def __repr__(self) -> str:
        return (f"HostDigest(count={self.count}, nonfinite={self.nonfinite}, "
                f"zeros={self.zeros}, max_abs={self.max_abs:.3e})")


class NumericsBook:
    """Ordered per-site digests on the host: the harvest target of the tap
    surfaces (the trainer's log boundaries, the engine's syncs) and the
    source of the ``tdx_numerics_*`` gauges (:meth:`collector`), the
    Perfetto counter tracks (:meth:`emit_counter_tracks`) and the exact
    ledger counter rows (:meth:`counter_rows`).  Site order is first-update
    order, program order within a harvest, so :meth:`first_nonfinite_site`
    names the earliest site whose nonfinite count went positive."""

    def __init__(self) -> None:
        self._sites: Dict[str, HostDigest] = {}
        self._last: Dict[str, HostDigest] = {}
        self.harvests = 0
        self.first_nonfinite: Optional[str] = None
        self.first_nonfinite_step: Optional[int] = None

    def update(self, site: str, digest: HostDigest, step: Optional[int] = None) -> None:
        prev = self._sites.get(site)
        self._sites[site] = digest if prev is None else prev.merge(digest)
        self._last[site] = digest

    def update_tree(self, digests: Dict[str, Any], step: Optional[int] = None) -> None:
        """Harvest one ``{site: digest}`` dict (host digests, or tensors
        the caller's sync has made ready), sites visited in
        :func:`provenance_key` order."""
        self.harvests += 1
        for site in sorted(digests, key=provenance_key):
            d = digests[site]
            hd = d if isinstance(d, HostDigest) else HostDigest.from_device(d)
            self.update(site, hd, step=step)
            if hd.nonfinite > 0 and self.first_nonfinite is None:
                self.first_nonfinite = site
                self.first_nonfinite_step = step

    def sites(self) -> List[str]:
        return list(self._sites)

    def digest(self, site: str) -> Optional[HostDigest]:
        return self._sites.get(site)

    def last(self, site: str) -> Optional[HostDigest]:
        """The most recent single harvest of ``site`` (not merged)."""
        return self._last.get(site)

    def first_nonfinite_site(self) -> Optional[str]:
        return self.first_nonfinite

    def counter_rows(self) -> List[dict]:
        """The exact fields as ``{site, metric, value}`` triples, what the
        ledger ingests as ``metric_class: counter`` rows."""
        rows = []
        for site, d in self._sites.items():
            for metric, value in d.int_fields().items():
                rows.append({"site": site, "metric": f"numerics_{metric}", "value": value})
        return rows

    def to_json(self) -> dict:
        return {
            "schema": NUMERICS_SCHEMA,
            "harvests": self.harvests,
            "first_nonfinite_site": self.first_nonfinite,
            "first_nonfinite_step": self.first_nonfinite_step,
            "sites": {s: d.to_json() for s, d in self._sites.items()},
        }

    @classmethod
    def from_json(cls, data: dict) -> "NumericsBook":
        if data.get("schema") != NUMERICS_SCHEMA:
            raise ValueError(f"expected schema {NUMERICS_SCHEMA!r}, "
                             f"got {data.get('schema')!r}")
        book = cls()
        book.harvests = int(data.get("harvests", 0))
        book.first_nonfinite = data.get("first_nonfinite_site")
        book.first_nonfinite_step = data.get("first_nonfinite_step")
        for site, d in (data.get("sites") or {}).items():
            book._sites[site] = HostDigest(
                nonfinite=d["nonfinite"], zeros=d["zeros"], count=d["count"],
                exp_hist=d["exp_hist"], max_abs=d.get("max_abs", 0.0),
                sumsq=float(d.get("rms", 0.0)) ** 2 * d["count"])
        return book

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    def collector(self, prefix: str = "tdx_numerics"):
        """``obs.metrics`` collector: ``{prefix}_{field}{site=...}`` gauges
        per site and ``{prefix}_harvests_total``; holds the book weakly."""
        import weakref

        from .metrics import MetricFamily

        ref = weakref.ref(self)

        def collect():
            book = ref()
            if book is None:
                return []
            fams = []
            gauges = (
                ("nonfinite", lambda d: d.nonfinite),
                ("zeros", lambda d: d.zeros),
                ("count", lambda d: d.count),
                ("hist_hash", lambda d: d.hist_hash),
                ("max_abs", lambda d: d.max_abs),
                ("rms", lambda d: d.rms),
            )
            for field, get in gauges:
                fam = MetricFamily(f"{prefix}_{field}", "gauge")
                for site, d in book._sites.items():
                    fam.add(get(d), site=site)
                if book._sites:
                    fams.append(fam)
            fams.append(MetricFamily(f"{prefix}_harvests_total", "counter").add(book.harvests))
            return fams

        return collect

    def emit_counter_tracks(self, tracer=None) -> None:
        """One Perfetto counter sample per site (the last harvest) on the
        tracer's timebase."""
        if tracer is None:
            from .trace import get_tracer

            tracer = get_tracer()
        for site, d in self._last.items():
            tracer.counter(f"numerics/{site}", nonfinite=float(d.nonfinite),
                           zeros=float(d.zeros), max_abs=float(d.max_abs))

    def drift_rows(self, expected: Dict[str, Dict[str, int]]) -> List[dict]:
        """One row per exact field of the merged digests that differs from
        ``expected`` (``{site: {field: value}}``); empty when none drifted."""
        rows = []
        for site, pins in expected.items():
            d = self._sites.get(site)
            if d is None:
                rows.append({"site": site, "metric": "missing", "expected": pins,
                             "actual": None})
                continue
            actual = d.int_fields()
            for metric, want in pins.items():
                got = actual.get(metric)
                if got != want:
                    rows.append({"site": site, "metric": metric, "expected": want,
                                 "actual": got})
        return rows
