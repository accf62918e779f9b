"""Carry parameters and buffers exported from the JAX package into the port.

``load_jax_params(model, params)`` takes the JAX model's
``named_parameters()`` as a dict of numpy arrays (the caller converts; this
module imports no JAX) and copies them into the port's module of the same
architecture, so both packages compute the same function in the parity
tests; ``load_jax_buffers(model, buffers)`` does the same for
``named_buffers()`` (BatchNorm's running statistics).  Names and shapes
must match exactly: a missing, extra or mis-shaped key raises.  A
parameter that is a rank's piece (a sharded ``materialize_module`` or
``parallel.shard_tensor``) takes its slice of the whole array.  Float arrays cross through f32 (exact for bf16 and
f32); integer arrays (the int8 codes of ``nn.quantization``) cross in
their own dtype, so codes arrive exactly.  Stacked MoE expert weights
(E, D, F) keep their layout.  ``export_params(model)`` is the inverse:
the port's parameters as f32 numpy arrays under the same names.
``load_jax_adam8bit_state(optimizer, params, state)`` loads a JAX
``Adam8bitState`` (its flat lists, in ``tree_leaves(params)`` order) into
an ``optimizers.AdamW8bit``, so both optimizers go on from one state.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "load_jax_buffers", "export_params",
           "load_jax_adam8bit_state"]


def _load(own: Mapping[str, torch.Tensor], arrays: Mapping[str, np.ndarray],
          what: str) -> None:
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(
            f"{what} names differ: missing {missing}, unexpected {extra}"
        )
    for name, t in own.items():
        src = np.asarray(arrays[name])
        want = getattr(t, "_tdx_global_shape", tuple(t.shape))
        if tuple(src.shape) != tuple(want):
            raise ValueError(
                f"{name}: shape {tuple(src.shape)} != {tuple(want)}"
            )
    with torch.no_grad():
        for name, t in own.items():
            src = np.asarray(arrays[name])
            sharding = getattr(t, "_tdx_sharding", None)
            if sharding is not None:  # a rank's piece: its slice of the whole
                src = src[sharding.shard_slices(src.shape)]
            if not np.issubdtype(src.dtype, np.integer):
                src = src.astype(np.float32)
            t.copy_(torch.from_numpy(np.array(src, copy=True)).to(t.dtype))


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    _load(dict(model.named_parameters()), params, "parameter")
    return model


def load_jax_buffers(model: torch.nn.Module,
                     buffers: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """The JAX model's ``named_buffers()`` into the port's buffers of the
    same names, with ``load_jax_params``'s checks."""
    _load(dict(model.named_buffers()), buffers, "buffer")
    return model


def export_params(model: torch.nn.Module) -> dict:
    """``{name: np.ndarray}`` of the module's parameters, as f32 on the
    host."""
    return {name: p.detach().float().cpu().numpy()
            for name, p in model.named_parameters()}


def load_jax_adam8bit_state(optimizer, params, state):
    """Copy a JAX ``Adam8bitState`` into ``optimizer`` (an ``AdamW8bit``).

    ``params`` gives the port's parameters in the JAX state's leaf order:
    a sequence of them, or a module or ``{name: parameter}`` mapping, which
    JAX flattens as a dict, by sorted name.  ``state`` has the fields
    ``count``, ``m_codes``, ``m_scales``, ``v_codes`` and ``v_scales``
    (the NamedTuple, or a dict of them); codes cross in their own integer
    dtype and scales in f32, bit for bit.  Each array is the whole one
    (``np.asarray`` of a JAX array gathers it, however
    ``adam8bit_state_shardings`` placed it); an optimizer placed over a
    mesh (``AdamW8bit.place``) keeps the rank's piece of it."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    if isinstance(params, Mapping):
        params = [params[k] for k in sorted(params)]
    fields = ("m_codes", "m_scales", "v_codes", "v_scales")
    get = (state.get if isinstance(state, Mapping)
           else lambda k: getattr(state, k))
    lists = {k: list(get(k)) for k in fields}
    if any(len(v) != len(params) for v in lists.values()):
        raise ValueError(f"the state has {len(lists['m_codes'])} leaves, "
                         f"not {len(params)}")
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for i, p in enumerate(params):
        if id(p) not in owned:
            raise ValueError(f"leaf {i} is not a parameter of the optimizer")
        placed = getattr(optimizer, "placement", lambda _: None)(p)
        row = {}
        for k in fields:
            whole = torch.from_numpy(np.array(lists[k][i], copy=True))
            if placed is not None:
                if tuple(whole.shape) != placed.global_shape(k):
                    raise ValueError(f"leaf {i} {k}: shape {tuple(whole.shape)}, the "
                                     f"placement wants {placed.global_shape(k)}")
                whole = placed.piece(k, whole).clone()
            row[k] = whole.to(p.device)
        optimizer.state[p] = row
    optimizer.count = int(np.asarray(get("count")))
    return optimizer
