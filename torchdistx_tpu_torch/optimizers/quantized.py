"""8-bit blockwise-quantized AdamW state, counterpart of
``torchdistx_tpu/optimizers/quantized.py``.

Both moments live as 8-bit codes with one f32 scale per ``block_size``
values of the flattened parameter (zero-padded to a whole block): the
first moment as linear int8 codes ``round(x / (absmax / 127))``, the
nonnegative second moment as uint8 power-law codes
``round(255 * (x / absmax) ** (1/4))``, read back as
``absmax * (code / 255) ** 4`` (linear codes would zero every small ``v``
of a block and blow its update up).  That is about 2.03 bytes a parameter
of moment state against AnyPrecisionAdamW's 6.

The update is the JAX one operation for operation: dequantize, the Adam
moments, ``denom = sqrt(v / c2) + eps``, ``upd = -lr * ((m / c1) / denom +
wd * p)`` in f32, rounded to the parameter's dtype and added in that dtype
(two roundings, as ``anyprecision_optimizer.py`` explains), requantize.
``torch.round`` rounds half to even as ``jnp.round`` does.  The divisions
by the constants 127 and 255 are multiplications by their f32 reciprocals,
as XLA compiles the jitted JAX step (eager ``jnp`` divides), and
``(m / c1) / denom`` is ``m / (c1 * denom)``, XLA's rewrite; the four
multiplies that feed an add (the two moments, the weight decay and, for
f32 parameters, the installed update) are fused multiply-adds
(:func:`_fma`), as XLA's CPU backend contracts them.  The fourth
root and fourth power are taken in f64 and rounded to f32: XLA's CPU
``pow`` is the C library's ``powf``, which f64 arithmetic rounded once
matches on all but a few inputs in 10^4 (f32 ``torch.pow`` misses one in
80), so the codes agree with the JAX package's nearly everywhere.

Plain PyTorch, a parameter at a time: the JAX update is plain ``jnp``
outside any Pallas kernel.  Its f32 temporaries are bounded by the
largest parameter.

Sharded state (``place``, which ``ShardedTrainStep`` calls): JAX updates
on the global arrays, so its blocks are those of the whole flattened
parameter, and ``adam8bit_state_shardings`` places them (``n_blocks``
over the axis when it divides, else the block dim, else replicated;
``count`` replicated).  A placed optimizer holds exactly the rank's
pieces of that layout (:meth:`AdamW8bit.adam8bit_state` views them as
an :class:`Adam8bitState`).  Where the rank's blocks are the blocks of
its parameter piece (a piece cut on dim 0 that is a whole number of
blocks, or a replicated parameter with replicated state) the update is
the one above on the piece, with no collective.  Otherwise the gradient
and the parameter are all-gathered over the axis, the rank updates its
rows or columns of the blocks (a block's absmax, when the block dim is
cut, is the all-reduced max of the ranks' partial maxima: exact), and
the new values of its state piece are all-gathered back into the
parameter's layout, through ``parallel.collectives`` so that the comm
audit books each move (XLA inserts the same moves in JAX's step,
unbooked).  Every value is computed as the unsharded update computes
it: the update is elementwise and its reductions are maxima.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

__all__ = ["blockwise_quantize", "blockwise_dequantize", "AdamW8bit", "adamw_8bit",
           "Adam8bitState", "adam8bit_state_shardings"]

_V_POWER = 4.0  # power-law code map exponent for the unsigned moment


def _blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block_size)


def blockwise_quantize(x: torch.Tensor, block_size: int = 256, *, signed: bool = True):
    """``(codes, scales)``: codes ``(ceil(n / block), block)`` over the
    flattened, zero-padded input, int8 (``signed``) or uint8 power-law;
    scales f32 ``(ceil(n / block), 1)``."""
    return _quantize_blocks(_blocks(x, block_size), signed)


def _quantize_blocks(blocks: torch.Tensor, signed: bool, reduce_max=None):
    """:func:`blockwise_quantize` of f32 ``blocks`` (rows of a block, or
    a rank's columns of every block: ``reduce_max`` then makes the
    partial maxima the whole blocks')."""
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    if reduce_max is not None:
        absmax = reduce_max(absmax)
    if signed:
        scales = absmax * (1.0 / 127.0)
        codes = torch.round(blocks / torch.clamp(scales, min=1e-30)).to(torch.int8)
        return codes, scales
    unit = blocks / torch.clamp(absmax, min=1e-30)
    root = unit.double().pow(1.0 / _V_POWER).float()
    codes = torch.round(255.0 * root).to(torch.uint8)
    return codes, absmax


def blockwise_dequantize(codes: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of :func:`blockwise_quantize`: f32 of ``shape``."""
    n = math.prod(shape)
    return _dequantize_blocks(codes, scales).reshape(-1)[:n].reshape(shape)


def _dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    if codes.dtype == torch.uint8:  # power-law unsigned map
        unit = (codes.float() * (1.0 / 255.0)).double().pow(_V_POWER).float()
        return scales * unit
    return codes.float() * scales


def _f32(x: float) -> float:
    return torch.tensor(x, dtype=torch.float32).item()


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as XLA's CPU backend
    contracts a multiply feeding an add: the product of two f32 values is
    exact in f64, the sum rounds once there, then to f32 (a second
    rounding that differs from a true fused multiply-add about once in
    2^29)."""
    b = b.double() if isinstance(b, torch.Tensor) else _f32(b)
    return a.double().mul_(b).add_(c.double()).float()


def _correction(beta: float, count: int, device) -> torch.Tensor:
    """``1 - beta ** count`` in f32, as the JAX step takes it: the power
    rounded once to f32 (``powf``), then the f32 subtraction.  A 0-d
    tensor on ``device``, so that dividing by it is a true division."""
    b = torch.tensor(beta, dtype=torch.float32).item()
    power = torch.tensor(b ** count, dtype=torch.float32)
    return (1.0 - power).to(device)


class Adam8bitState(NamedTuple):
    """An :class:`AdamW8bit`'s state in the JAX ``Adam8bitState``'s layout:
    ``count`` and, per parameter in the order asked for, the codes and
    scales over the WHOLE parameter's blocks; a placed optimizer's entries
    are the rank's pieces, each marked (``parallel.mesh.sharding_of``)
    with its sharding and the whole array's shape."""

    count: Any
    m_codes: list
    m_scales: list
    v_codes: list
    v_scales: list


_SLOTS = ("m_codes", "m_scales", "v_codes", "v_scales")


def _state_spec(shape, n: int, axis: str) -> tuple:
    """JAX's ``adam8bit_state_shardings`` rule for one array of ``shape``:
    dim 0 over ``axis`` when it divides, else dim 1, else replicated."""
    if len(shape) >= 1 and shape[0] % n == 0:
        return (axis,) + (None,) * (len(shape) - 1)
    if len(shape) >= 2 and shape[1] % n == 0:
        return (None, axis) + (None,) * (len(shape) - 2)
    return ()


def adam8bit_state_shardings(state: Adam8bitState, mesh, axis: str = "fsdp") -> Adam8bitState:
    """ZeRO-style placement of an :class:`Adam8bitState`, the JAX
    function's rule: every code and scale array's leading ``n_blocks`` dim
    over ``axis`` when it divides, else its block dim (codes), else
    replicated; ``count`` replicated.  An entry's shape is the whole
    array's (its ``sharding_of`` global shape when it is a piece)."""
    from ..parallel.mesh import NamedSharding, sharding_of

    n = mesh.shape[axis]

    def sh(x):
        if not hasattr(x, "shape"):
            return NamedSharding(mesh, ())
        found = sharding_of(x)
        return NamedSharding(mesh, _state_spec(found[1] if found else tuple(x.shape), n, axis))

    return Adam8bitState(count=NamedSharding(mesh, ()),
                         **{k: [sh(x) for x in getattr(state, k)] for k in _SLOTS})


class _Placement:
    """Where one parameter's blockwise state lives on a mesh axis, and how
    the rank's blocks meet its parameter piece (module docstring)."""

    def __init__(self, p: torch.Tensor, mesh, axis: str, block_size: int):
        from ..parallel.mesh import NamedSharding, sharding_of

        found = sharding_of(p)
        self.param_sharding, self.shape = (found if found is not None
                                           else (NamedSharding(mesh, ()), tuple(p.shape)))
        self.numel = math.prod(self.shape)
        self.n_blocks = -(-self.numel // block_size)
        self.block_size = block_size
        self.axis = mesh.axes[axis]
        n = self.axis.size
        self.codes = NamedSharding(mesh, _state_spec((self.n_blocks, block_size), n, axis))
        self.scales = NamedSharding(mesh, _state_spec((self.n_blocks, 1), n, axis))
        spec = tuple(self.param_sharding.spec)
        self.param_dim = spec.index(axis) if axis in spec else None
        self.state_dim = self.codes.spec.index(axis) if axis in self.codes.spec else None
        d = self.param_dim
        if n == 1 or (d is None and self.state_dim is None):
            self.local = True  # the piece is the whole parameter, its state whole
        else:  # a flat-contiguous piece of whole blocks, its state the same rows
            self.local = (d is not None and self.state_dim == 0
                          and math.prod(self.shape[:d]) == 1
                          and (self.numel // n) % block_size == 0)

    def global_shape(self, slot: str) -> tuple:
        return (self.n_blocks, 1 if slot.endswith("scales") else self.block_size)

    def sharding(self, slot: str):
        return self.scales if slot.endswith("scales") else self.codes

    def piece_shape(self, slot: str) -> tuple:
        """The shape of the rank's piece of ``slot``."""
        whole = self.global_shape(slot)
        n = self.axis.size
        return tuple(s // n if e else s for s, e in zip(whole, self.sharding(slot).spec
                                                         + (None,) * len(whole)))

    def piece(self, slot: str, whole: torch.Tensor) -> torch.Tensor:
        """The rank's piece of a whole ``(n_blocks, ...)`` array of ``slot``."""
        return whole[self.sharding(slot).shard_slices(whole.shape)]


class AdamW8bit(torch.optim.Optimizer):
    """AdamW whose moments are blockwise 8-bit (module docstring).

    Per parameter the state holds ``m_codes``, ``m_scales``, ``v_codes``
    and ``v_scales``; one step count ``count`` is shared by every
    parameter, as the JAX state's.  ``param_groups`` carry per-group
    ``lr``, ``betas``, ``eps`` and ``weight_decay``; ``block_size`` is the
    optimizer's.  ``state_dict()`` keeps the codes and scales as they are
    (``load_state_dict`` casts nothing) and adds ``count``.  After
    :meth:`place` each parameter's state is the rank's pieces of JAX's
    sharded layout."""

    def __init__(self, params, lr: float = 1e-3, betas: tuple = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 block_size: int = 256) -> None:
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.block_size = block_size
        self.count = 0
        self._placed: dict = {}  # parameter -> _Placement

    def place(self, mesh, axis: str = "fsdp") -> "AdamW8bit":
        """Hold each parameter's state as the rank's pieces of
        :func:`adam8bit_state_shardings` over ``axis`` of ``mesh``; the
        parameters carry their own placement (``sharding_of``; unmarked:
        whole on every rank).  State that exists must already be in that
        layout (``Trainer.reshard`` moves it there)."""
        self._placed = {p: _Placement(p, mesh, axis, self.block_size)
                        for group in self.param_groups for p in group["params"]}
        return self

    def placement(self, p: torch.Tensor):
        """``p``'s :class:`_Placement`, or None when the state is whole."""
        return self._placed.get(p)

    def state_sharding(self, p: torch.Tensor, slot: str):
        """``(NamedSharding, whole shape)`` of ``slot`` of a placed
        parameter's state, else None."""
        pl = self._placed.get(p)
        if pl is None or slot not in _SLOTS:
            return None
        return pl.sharding(slot), pl.global_shape(slot)

    def _init_state(self, p: torch.Tensor) -> dict:
        """The JAX ``init``: the codes of a zero moment (zeros), as the
        rank's pieces when placed."""
        pl = self._placed.get(p)
        state = self.state[p]
        if pl is None:
            zeros = torch.zeros_like(p, dtype=torch.float32)
            mc, ms = blockwise_quantize(zeros, self.block_size, signed=True)
            vc, vs = blockwise_quantize(zeros, self.block_size, signed=False)
            state.update(m_codes=mc, m_scales=ms, v_codes=vc, v_scales=vs)
            return state
        dtypes = {"m_codes": torch.int8, "v_codes": torch.uint8}
        for slot in _SLOTS:
            state[slot] = torch.zeros(pl.piece_shape(slot), device=p.device,
                                      dtype=dtypes.get(slot, torch.float32))
        return state

    def adam8bit_state(self, params=None) -> Adam8bitState:
        """The state as an :class:`Adam8bitState` (made first where it does
        not exist), its lists in the order of ``params``: a sequence of
        parameters, or a module or ``{name: parameter}``, taken by sorted
        name as JAX flattens a dict (default: the parameter groups' order).
        A placed entry is the rank's piece, marked with its sharding."""
        from ..parallel.mesh import mark_sharded

        if params is None:
            params = [p for g in self.param_groups for p in g["params"]]
        elif isinstance(params, torch.nn.Module):
            params = [p for _, p in sorted(params.named_parameters())]
        elif isinstance(params, dict):
            params = [params[k] for k in sorted(params)]
        lists = {k: [] for k in _SLOTS}
        for p in params:
            st = self.state[p] if self.state.get(p) else self._init_state(p)
            for k in _SLOTS:
                placed = self.state_sharding(p, k)
                lists[k].append(mark_sharded(st[k], *placed) if placed else st[k])
        return Adam8bitState(count=torch.tensor(self.count, dtype=torch.int32), **lists)

    def state_bytes(self) -> int:
        """Bytes of moment state over every parameter that has some (a
        placed optimizer's: the rank's pieces)."""
        return sum(t.numel() * t.element_size()
                   for st in self.state.values() for t in st.values()
                   if isinstance(t, torch.Tensor))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.count += 1
        corrections = {}
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                key = (b1, b2, p.device)
                if key not in corrections:
                    corrections[key] = (_correction(b1, self.count, p.device),
                                        _correction(b2, self.count, p.device))
                state = self.state[p] if self.state.get(p) else self._init_state(p)
                pl = self._placed.get(p)
                if pl is None or pl.local:
                    self._update(p, p.grad, state, group, *corrections[key])
                else:
                    self._update_placed(p, p.grad, state, group, *corrections[key], pl)
        return loss

    @staticmethod
    def _adam(p, g32, m, v, group, c1, c2):
        """The update's arithmetic: ``p`` (any shape, its own dtype) written
        in place; returns the new f32 moments ``(m, v)``."""
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        m = _fma(g32, 1.0 - b1, m.mul_(b1))
        v = _fma(g32 * (1.0 - b2), g32, v.mul_(b2))
        denom = torch.sqrt(v / c2).add_(eps).mul_(c1)
        upd = m / denom  # XLA's (m / c1) / denom
        del denom
        if wd != 0.0:
            upd = _fma(p.float(), wd, upd)
        if p.dtype == torch.float32:  # p + upd, the rounding to p's dtype a no-op
            p.copy_(_fma(upd, -lr, p))
        else:
            p.add_(upd.mul_(-lr).to(p.dtype))
        return m, v

    def _update(self, p, grad, state, group, c1, c2):
        g32 = grad.float()  # may be the gradient itself: not written to
        m = blockwise_dequantize(state["m_codes"], state["m_scales"], grad.shape)
        v = blockwise_dequantize(state["v_codes"], state["v_scales"], grad.shape)
        m, v = self._adam(p, g32, m, v, group, c1, c2)
        del g32
        state["m_codes"], state["m_scales"] = blockwise_quantize(
            m, self.block_size, signed=True)
        state["v_codes"], state["v_scales"] = blockwise_quantize(
            v, self.block_size, signed=False)

    def _update_placed(self, p, grad, state, group, c1, c2, pl: _Placement):
        """The update of a rank's state piece that is not its parameter
        piece's blocks (module docstring): the moves are booked
        collectives over the placement's axis."""
        from ..parallel import collectives

        ax, d = pl.axis, pl.param_dim

        def whole_blocks(t):
            if d is not None:
                t = collectives.all_gather(t.contiguous(), ax, tiled_axis=d)
            return _pad_blocks(t, pl.block_size)[pl.codes.shard_slices(
                (pl.n_blocks, pl.block_size))]

        g32 = whole_blocks(grad).float()
        vals = whole_blocks(p.detach()).clone()
        m = _dequantize_blocks(state["m_codes"], state["m_scales"])
        v = _dequantize_blocks(state["v_codes"], state["v_scales"])
        m, v = self._adam(vals, g32, m, v, group, c1, c2)
        del g32
        reduce_max = None
        if pl.state_dim == 1:  # a block's columns on every rank: exact max
            def reduce_max(x):
                return collectives.all_max(x, ax)
        state["m_codes"], state["m_scales"] = _quantize_blocks(m, True, reduce_max)
        state["v_codes"], state["v_scales"] = _quantize_blocks(v, False, reduce_max)
        if pl.state_dim is not None:
            vals = collectives.all_gather(vals, ax, tiled_axis=pl.state_dim)
        whole = vals.reshape(-1)[:pl.numel].reshape(pl.shape)
        p.copy_(whole[pl.param_sharding.shard_slices(pl.shape)])

    def state_dict(self) -> dict:
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict: dict) -> None:
        saved = state_dict["param_groups"]
        if len(saved) != len(self.param_groups) or any(
                len(s["params"]) != len(g["params"])
                for s, g in zip(saved, self.param_groups)):
            raise ValueError("the state dict's parameter groups do not match")
        for group, s in zip(self.param_groups, saved):
            for p, idx in zip(group["params"], s["params"]):
                st = state_dict["state"].get(idx)
                self.state.pop(p, None)
                if st:
                    self.state[p] = {k: v.to(p.device) if isinstance(v, torch.Tensor)
                                     else v for k, v in st.items()}
            group.update({k: v for k, v in s.items() if k != "params"})
        self.count = int(state_dict["count"])


def _pad_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """``x`` flattened, zero-padded to whole blocks, ``(n_blocks, block)``,
    in ``x``'s dtype."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block_size)


def adamw_8bit(params, learning_rate: float = 1e-3, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
               *, block_size: int = 256) -> AdamW8bit:
    """:class:`AdamW8bit` under the JAX factory's keyword names."""
    return AdamW8bit(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                     weight_decay=weight_decay, block_size=block_size)
