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
"""

from __future__ import annotations

import torch

__all__ = ["blockwise_quantize", "blockwise_dequantize", "AdamW8bit", "adamw_8bit"]

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
    blocks = _blocks(x, block_size)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
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
    n = 1
    for s in shape:
        n *= s
    if codes.dtype == torch.uint8:  # power-law unsigned map
        unit = (codes.float() * (1.0 / 255.0)).double().pow(_V_POWER).float()
        vals = scales * unit
    else:
        vals = codes.float() * scales
    return vals.reshape(-1)[:n].reshape(shape)


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


class AdamW8bit(torch.optim.Optimizer):
    """AdamW whose moments are blockwise 8-bit (module docstring).

    Per parameter the state holds ``m_codes``, ``m_scales``, ``v_codes``
    and ``v_scales``; one step count ``count`` is shared by every
    parameter, as the JAX state's.  ``param_groups`` carry per-group
    ``lr``, ``betas``, ``eps`` and ``weight_decay``; ``block_size`` is the
    optimizer's.  ``state_dict()`` keeps the codes and scales as they are
    (``load_state_dict`` casts nothing) and adds ``count``."""

    def __init__(self, params, lr: float = 1e-3, betas: tuple = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, *,
                 block_size: int = 256) -> None:
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.block_size = block_size
        self.count = 0

    def _init_state(self, p: torch.Tensor) -> dict:
        """The JAX ``init``: the codes of a zero moment."""
        zeros = torch.zeros_like(p, dtype=torch.float32)
        mc, ms = blockwise_quantize(zeros, self.block_size, signed=True)
        vc, vs = blockwise_quantize(zeros, self.block_size, signed=False)
        state = self.state[p]
        state.update(m_codes=mc, m_scales=ms, v_codes=vc, v_scales=vs)
        return state

    def state_bytes(self) -> int:
        """Bytes of moment state over every parameter that has some."""
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
                self._update(p, p.grad, state, group, *corrections[key])
        return loss

    def _update(self, p, grad, state, group, c1, c2):
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        g32 = grad.float()  # may be the gradient itself: not written to
        m = blockwise_dequantize(state["m_codes"], state["m_scales"], grad.shape)
        v = blockwise_dequantize(state["v_codes"], state["v_scales"], grad.shape)
        m = _fma(g32, 1.0 - b1, m.mul_(b1))
        v = _fma(g32 * (1.0 - b2), g32, v.mul_(b2))
        del g32
        denom = torch.sqrt(v / c2).add_(eps).mul_(c1)
        upd = m / denom  # XLA's (m / c1) / denom
        del denom
        if wd != 0.0:
            upd = _fma(p.float(), wd, upd)
        if p.dtype == torch.float32:  # p + upd, the rounding to p's dtype a no-op
            p.copy_(_fma(upd, -lr, p))
        else:
            p.add_(upd.mul_(-lr).to(p.dtype))
        del upd
        state["m_codes"], state["m_scales"] = blockwise_quantize(
            m, self.block_size, signed=True)
        state["v_codes"], state["v_scales"] = blockwise_quantize(
            v, self.block_size, signed=False)

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


def adamw_8bit(params, learning_rate: float = 1e-3, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
               *, block_size: int = 256) -> AdamW8bit:
    """:class:`AdamW8bit` under the JAX factory's keyword names."""
    return AdamW8bit(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                     weight_decay=weight_decay, block_size=block_size)
