"""Mixture-of-Experts layer, counterpart of ``torchdistx_tpu/nn/moe.py``.

Top-k softmax routing with renormalized weights over SwiGLU experts whose
weights are stacked with a leading expert dim: ``w_gate``/``w_up`` (E, D,
F) and ``w_down`` (E, F, D), the JAX package's names and layouts.  Two
compute modes:

  - dense (``capacity_factor=None``, the default and Mixtral's): every
    expert computes every token and the combine is masked.  Exact, E/top_k
    times the dispatched FLOPs.
  - capacity dispatch (``capacity_factor=``): the GShard / Switch
    algorithm.  Each expert takes at most ``C = ceil(n * top_k / E *
    capacity_factor)`` tokens (at most n), top-1 choices of every token
    before top-2 choices, each in token order; tokens past an expert's
    capacity are dropped (combine weight 0).  ``dispatch_mode="einsum"``
    builds one-hot (n, E, C) dispatch and combine tensors;
    ``"gather"`` indexes the same slots directly.  Both give the same
    expert batches.

The expert products are plain batched matrix products (``torch.matmul``):
the JAX package leaves them to XLA, outside any Pallas kernel.  Expert
parallelism (``moe_shard_rule``) waits for the port's parallel stack.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as _F
from torch import nn

from . import init
from .layers import Linear

__all__ = ["MoE", "moe_shard_rule"]


class MoE(nn.Module):
    """Top-k routed SwiGLU-style expert FFN."""

    def __init__(self, dim: int, ffn_dim: int, n_experts: int, top_k: int = 2,
                 dtype=torch.float32, capacity_factor: Optional[float] = None,
                 dispatch_mode: str = "einsum", device="cuda") -> None:
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k={top_k} out of range for {n_experts} experts")
        if dispatch_mode not in ("einsum", "gather"):
            raise ValueError(
                f"dispatch_mode {dispatch_mode!r} (expected 'einsum' or 'gather')")
        if dispatch_mode == "gather" and capacity_factor is None:
            raise ValueError(
                "dispatch_mode='gather' requires capacity_factor: dense compute "
                "(capacity_factor=None) has no dispatch step for the gather path "
                "to replace")
        self.dim = dim
        self.ffn_dim = ffn_dim
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dispatch_mode = dispatch_mode
        self.router = Linear(dim, n_experts, bias=False, dtype=dtype, device=device)
        bound = math.sqrt(1.0 / dim)
        down = math.sqrt(1.0 / ffn_dim)
        self.w_gate = nn.Parameter(
            init.uniform((n_experts, dim, ffn_dim), -bound, bound, dtype, device))
        self.w_up = nn.Parameter(
            init.uniform((n_experts, dim, ffn_dim), -bound, bound, dtype, device))
        self.w_down = nn.Parameter(
            init.uniform((n_experts, ffn_dim, dim), -down, down, dtype, device))

    def _route(self, x):
        return torch.softmax(self.router(x).float(), dim=-1)  # (..., E)

    def forward(self, x, return_aux: bool = False):
        """Apply the layer; with ``return_aux=True`` also return the
        load-balancing loss of the same routing pass."""
        probs = self._route(x)
        if self.capacity_factor is not None:
            y = self._capacity_forward(x, probs)
        else:
            y = self._dense_forward(x, probs)
        if return_aux:
            return y, self._balance_loss(probs)
        return y

    def _top_k(self, probs):
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        return top_p / top_p.sum(-1, keepdim=True), top_i

    def _dense_forward(self, x, probs):
        top_p, top_i = self._top_k(probs)
        onehot = _F.one_hot(top_i, self.n_experts).to(probs.dtype)
        combine = torch.einsum("...k,...ke->...e", top_p, onehot)
        expert_out = self._dense_ffn(x)
        return torch.einsum("...e,...ed->...d", combine.to(x.dtype), expert_out)

    def _proj(self, x, name: str):
        """(E or 1, N, K) x the stacked weight ``name`` (E, K, M) -> (E, N, M)."""
        return torch.matmul(x, getattr(self, name))

    def _experts(self, expert_in):
        """(E or 1, N, D) -> (E, N, D): the SwiGLU expert FFNs; a leading 1
        broadcasts the same tokens to every expert."""
        h = _F.silu(self._proj(expert_in, "w_gate")) * self._proj(expert_in, "w_up")
        return self._proj(h, "w_down")

    def _dense_ffn(self, x):
        """(..., D) -> (..., E, D): every expert's FFN on every token."""
        lead, d = x.shape[:-1], x.shape[-1]
        out = self._experts(x.reshape(1, -1, d))  # (E, n, D)
        return out.transpose(0, 1).reshape(*lead, self.n_experts, d)

    def _capacity_slots(self, pf, cap):
        """GShard slot assignment shared by both dispatch modes: for each of
        the k routing choices, the chosen expert, the token's slot in that
        expert's capacity, the keep mask and the combine weight.  Top-1
        slots come before top-2 ones across all tokens, then token order."""
        e = self.n_experts
        top_p, top_i = self._top_k(pf)
        slots = []
        counts = torch.zeros((e,), dtype=torch.long, device=pf.device)
        for j in range(self.top_k):
            oh = _F.one_hot(top_i[:, j], e)  # (n, E)
            pos = torch.cumsum(oh, dim=0) - 1 + counts[None, :]
            pos_t = (oh * pos).sum(-1)  # (n,) position in the expert
            slots.append((top_i[:, j], pos_t, pos_t < cap, top_p[:, j]))
            counts = counts + oh.sum(0)
        return slots

    def _capacity_forward(self, x, probs):
        e = self.n_experts
        lead, d = x.shape[:-1], x.shape[-1]
        xf = x.reshape(-1, d)
        pf = probs.reshape(-1, e)
        n = xf.shape[0]
        cap = min(int(math.ceil(n * self.top_k / e * float(self.capacity_factor))), n)
        slots = self._capacity_slots(pf, cap)
        if self.dispatch_mode == "gather":
            return self._capacity_gather(xf, slots, n, cap).reshape(*lead, d)
        dt = x.dtype
        dispatch = torch.zeros((n, e, cap), dtype=dt, device=x.device)
        combine = torch.zeros((n, e, cap), dtype=dt, device=x.device)
        for ei, pos_t, keep, w in slots:
            slot = _F.one_hot(torch.where(keep, pos_t, 0), cap).to(dt)  # (n, C)
            sel = _F.one_hot(ei, e).to(dt) * keep[:, None].to(dt)
            dispatch = dispatch + sel[:, :, None] * slot[:, None, :]
            combine = combine + (sel * w[:, None].to(dt))[:, :, None] * slot[:, None, :]
        expert_in = torch.einsum("nec,nd->ecd", dispatch, xf)
        y = torch.einsum("nec,ecd->nd", combine, self._experts(expert_in))
        return y.reshape(*lead, d)

    def _capacity_gather(self, xf, slots, n, cap):
        """The einsum path's slots by index: a (E*C,) table of token ids
        (dropped tokens write nowhere), empty slots exact zeros, and the
        combine a per-choice gather weighted by the (zero when dropped)
        routing weight."""
        e, d, dt = self.n_experts, xf.shape[-1], xf.dtype
        tok_ids = torch.arange(n, device=xf.device)
        slot_token = torch.zeros((e * cap,), dtype=torch.long, device=xf.device)
        slot_valid = torch.zeros((e * cap,), dtype=dt, device=xf.device)
        for ei, pos_t, keep, _ in slots:
            flat = (ei * cap + pos_t)[keep]
            slot_token[flat] = tok_ids[keep]
            slot_valid[flat] = 1
        expert_in = (xf[slot_token] * slot_valid[:, None]).reshape(e, cap, d)
        expert_out = self._experts(expert_in).reshape(e * cap, d)
        y = torch.zeros((n, d), dtype=dt, device=xf.device)
        for ei, pos_t, keep, w in slots:
            flat = torch.where(keep, ei * cap + pos_t, 0)
            y = y + expert_out[flat] * (w.to(dt) * keep.to(dt))[:, None]
        return y

    def _balance_loss(self, probs):
        pf = probs.reshape(-1, self.n_experts)
        me = pf.mean(0)
        ce = _F.one_hot(pf.argmax(-1), self.n_experts).float().mean(0)
        return self.n_experts * (me * ce).sum()

    def aux_load_balance_loss(self, x):
        """Switch-style load-balancing auxiliary loss.  Prefer
        ``forward(x, return_aux=True)``, which reuses the routing pass."""
        return self._balance_loss(self._route(x))


def moe_shard_rule(mesh, ep_axis: str = "ep", base_rule: Optional[Callable] = None):
    """Expert-parallel sharding rule of the JAX package: it waits for the
    port's parallel stack."""
    raise NotImplementedError(
        "moe_shard_rule (expert parallelism) waits for the port's parallel stack")
