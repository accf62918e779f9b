"""AnyPrecisionAdamW: AdamW with state dtypes of the user's choosing and
optional Kahan-compensated updates, for pure-bf16 training.

Counterpart of ``torchdistx_tpu/optimizers/anyprecision_optimizer.py``
(``anyprecision_adamw`` / ``AnyPrecisionAdamW``) and of the reference's
optimizer: f32 momentum, bf16 variance, Kahan summation off with a bf16
buffer, decoupled weight decay, bias corrections.  ``torch.optim``'s own
``param_groups`` carry per-group ``lr``, ``betas``, ``eps`` and
``weight_decay``.  The update is applied in place.

Rounding follows the JAX step exactly: the f32 update is rounded to the
parameter's dtype, then added in that dtype (``p + round(delta)``: two
roundings, as the JAX trainer installs ``p + updates``); the Kahan buffer
absorbs both.  ``p.add_(delta_f32)`` would round once and differ by a
bf16 ulp.  The bias corrections are taken in f32 like the JAX ones.
"""

from __future__ import annotations

import torch

__all__ = ["AnyPrecisionAdamW"]


class AnyPrecisionAdamW(torch.optim.Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas: tuple = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        *,
        use_kahan_summation: bool = False,
        momentum_dtype: torch.dtype = torch.float32,
        variance_dtype: torch.dtype = torch.bfloat16,
        compensation_buffer_dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        defaults = dict(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            use_kahan_summation=use_kahan_summation,
            momentum_dtype=momentum_dtype, variance_dtype=variance_dtype,
            compensation_buffer_dtype=compensation_buffer_dtype,
        )
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p] if self.state.get(p) else self._init_state(p, group)
                self._update(p, p.grad, state, group, b1, b2, lr, eps, wd)
        return loss

    def _init_state(self, p, group) -> dict:
        """Zero moments (and Kahan buffer) shaped like ``p``, in the
        group's dtypes."""
        state = self.state[p]
        state["step"] = 0
        state["exp_avg"] = torch.zeros_like(p, dtype=group["momentum_dtype"])
        state["exp_avg_sq"] = torch.zeros_like(p, dtype=group["variance_dtype"])
        if group["use_kahan_summation"]:
            state["compensation"] = torch.zeros_like(
                p, dtype=group["compensation_buffer_dtype"])
        return state

    @staticmethod
    def _update(p, grad, state, group, b1, b2, lr, eps, wd):
        state["step"] += 1
        step = torch.tensor(float(state["step"]), dtype=torch.float32, device=p.device)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=p.device), step)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=p.device), step)

        g = grad.float()
        m, v = state["exp_avg"], state["exp_avg_sq"]
        m32 = m.float() * b1 + g * (1.0 - b1)
        m.copy_(m32)
        v.copy_(v.float() * b2 + g * g * (1.0 - b2))

        pf = p.float()
        denom = torch.sqrt(v.float()) / torch.sqrt(bc2) + eps
        delta = -(lr / bc1) * (m.float() / denom)
        if wd != 0.0:
            delta = delta - (lr * wd) * pf
        if not group["use_kahan_summation"]:
            p.add_(delta.to(p.dtype))
            return
        comp = state["compensation"]
        buf = comp.float() + delta
        new_p = (pf + buf).to(p.dtype)
        upd = new_p - p
        installed = (pf + upd.float()).to(p.dtype)
        comp.copy_(buf - (installed.float() - pf))
        p.copy_(installed)
