"""Carry parameters exported from the JAX package into the port.

``load_jax_params(model, params)`` takes the JAX model's
``named_parameters()`` as a dict of numpy arrays (the caller converts; this
module imports no JAX) and copies them into the port's module of the same
architecture, so both packages compute the same function in the parity
tests.  Names and shapes must match exactly: a missing, extra or
mis-shaped key raises.  ``export_params(model)`` is the inverse: the
port's parameters as f32 numpy arrays under the same names.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "export_params"]


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(
            f"parameter names differ: missing {missing}, unexpected {extra}"
        )
    for name, p in own.items():
        src = np.asarray(params[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}"
            )
    with torch.no_grad():
        for name, p in own.items():
            src = np.array(params[name], dtype=np.float32, copy=True)
            p.copy_(torch.from_numpy(src).to(p.dtype))
    return model


def export_params(model: torch.nn.Module) -> dict:
    """``{name: np.ndarray}`` of the module's parameters, as f32 on the
    host."""
    return {name: p.detach().float().cpu().numpy()
            for name, p in model.named_parameters()}
