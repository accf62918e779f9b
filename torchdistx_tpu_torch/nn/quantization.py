"""Weight-only int8 quantization for inference, counterpart of
``torchdistx_tpu/nn/quantization.py``.

A ``Linear`` weight is stored as int8 codes with one f32 scale per output
channel (absmax / 127, codes rounded half to even and clipped to +-127);
the forward computes ``x @ W_q^T`` in the input's dtype and applies the
scale in f32 after the product, as the JAX package does.  MoE expert
weights (the bulk of a Mixtral's bytes) quantize the same way per (expert,
output channel).  Scales stay f32 when the module is cast.

Quantize after materialization, in place:

    model = deferred_init(Mixtral.from_name, "mixtral_8x7b")
    for blk in model.blocks:           # one block's bf16 at a time
        materialize_module(blk)
        quantize_module(blk)
    materialize_module(model)
    quantize_module(model)             # the LM head

The int8 products are plain matrix products on a dequantized copy of the
codes: the JAX package computes them in XLA, outside any Pallas kernel.
``named_parameters`` carries the codes and scales under the JAX names.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as _F
from torch import nn

from .layers import Linear
from .moe import MoE

__all__ = ["QuantizedLinear", "QuantizedMoE", "quantize_module"]


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class _KeepF32:
    """``module.to(dtype)`` moves the ``_keep_dtype`` parameters but keeps
    them f32 (a bf16 scale would add up to ~0.39% systematic per-channel
    error on top of the quantization's)."""

    _keep_dtype: tuple = ()

    def _apply(self, fn, recurse=True):
        kept = {n: self._parameters[n] for n in self._keep_dtype}
        for n in kept:
            self._parameters[n] = None
        super()._apply(fn, recurse)
        for n, p in kept.items():
            device = fn(p.data[:0]).device
            self._parameters[n] = _frozen(p.data.to(device, torch.float32))
        return self


def _codes(w, reduce_dim: int):
    """int8 codes and f32 scales of ``w`` with the absmax taken over
    ``reduce_dim`` (the contracted one), the scale kept with that dim."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=reduce_dim, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-30)
    codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return codes, scale


class QuantizedLinear(_KeepF32, nn.Module):
    """Linear with int8 weight codes (out, in) and a per-output-channel f32
    scale (out,).  Built from a :class:`Linear` by :meth:`from_linear`."""

    _keep_dtype = ("scale",)

    def __init__(self, weight_q, scale, bias=None) -> None:
        super().__init__()
        self.in_features = weight_q.shape[1]
        self.out_features = weight_q.shape[0]
        self.weight_q = _frozen(weight_q)
        self.scale = _frozen(scale)
        if bias is not None:
            self.bias = _frozen(bias.detach())
        else:
            self.register_parameter("bias", None)

    @classmethod
    def from_linear(cls, lin: Linear) -> "QuantizedLinear":
        codes, scale = _codes(lin.weight, 1)
        return cls(codes, scale[:, 0], lin.bias)

    def forward(self, x):
        y = _F.linear(x, self.weight_q.to(x.dtype))
        y = (y.float() * self.scale).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, int8")


class QuantizedMoE(_KeepF32, MoE):
    """MoE whose stacked expert weights are int8 codes with per-(expert,
    output channel) f32 scales ``s_gate``/``s_up`` (E, F) and ``s_down``
    (E, D), and whose router is a :class:`QuantizedLinear`.  Routing,
    capacity slotting and both dispatch modes are inherited; each expert
    product applies its scale in f32 after the contraction."""

    _keep_dtype = ("s_gate", "s_up", "s_down")

    @classmethod
    def from_moe(cls, m: MoE) -> "QuantizedMoE":
        q = cls.__new__(cls)
        nn.Module.__init__(q)
        for attr in ("dim", "ffn_dim", "n_experts", "top_k", "capacity_factor",
                     "dispatch_mode"):
            setattr(q, attr, getattr(m, attr))
        q.router = QuantizedLinear.from_linear(m.router)
        for w, s in (("w_gate", "s_gate"), ("w_up", "s_up"), ("w_down", "s_down")):
            codes, scale = _codes(getattr(m, w), 1)  # (E, in, out): contract dim 1
            setattr(q, w, _frozen(codes))
            setattr(q, s, _frozen(scale[:, 0]))
        return q

    def _proj(self, x, name: str):
        scale = getattr(self, "s" + name[1:])  # (E, out)
        y = torch.matmul(x, getattr(self, name).to(x.dtype))
        return (y.float() * scale[:, None, :]).to(x.dtype)


def quantize_module(module: nn.Module, *,
                    filter_fn: Optional[Callable[[str, nn.Module], bool]] = None) -> nn.Module:
    """Replace every :class:`Linear` under ``module`` (in place) with a
    :class:`QuantizedLinear` and every :class:`MoE` with a
    :class:`QuantizedMoE`.  ``filter_fn(path, mod) -> bool`` limits which
    layers convert (e.g. keep the LM head: ``lambda path, mod: "lm_head"
    not in path``).  A replaced or filtered-out layer is not descended
    into.  Returns ``module``."""
    if isinstance(module, Linear):
        raise ValueError(
            "quantize_module replaces Linear CHILDREN; wrap a bare Linear with "
            "QuantizedLinear.from_linear(lin) instead")
    if isinstance(module, MoE) and not isinstance(module, QuantizedMoE):
        raise ValueError(
            "quantize_module replaces MoE CHILDREN; convert a bare MoE with "
            "QuantizedMoE.from_moe(moe) instead")

    def walk(mod: nn.Module, path: str) -> None:
        for name, child in list(mod._modules.items()):
            child_path = f"{path}.{name}" if path else name
            if isinstance(child, Linear):
                make = QuantizedLinear.from_linear
            elif isinstance(child, MoE) and not isinstance(child, QuantizedMoE):
                make = QuantizedMoE.from_moe
            else:
                walk(child, child_path)
                continue
            if filter_fn is None or filter_fn(child_path, child):
                setattr(mod, name, make(child))

    walk(module, "")
    return module
