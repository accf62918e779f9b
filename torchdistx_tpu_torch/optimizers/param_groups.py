"""Per-parameter-group hyperparameters for any optimizer factory.

Counterpart of ``torchdistx_tpu/optimizers/param_groups.py``.  The JAX
package labels the leaves of a parameter pytree and partitions them with
``optax.multi_transform``; in torch the same recipe is one optimizer with
one ``param_groups`` entry per label, each entry overriding the
optimizer's defaults.  Labels are keyed by parameter name
(``module.named_parameters()``), and the rule of ``decay_labels`` is the
JAX one, so both packages put every parameter of a model in the same
group.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping, Tuple, Union

import torch

__all__ = ["with_param_groups", "decay_labels", "label_tree"]

_NO_DECAY_NAME_HINTS = ("bias", "norm", "ln_", "layernorm", "scale")

NamedParams = Union[torch.nn.Module, Mapping[str, torch.Tensor],
                    Iterable[Tuple[str, torch.Tensor]]]


def _named(params: NamedParams) -> list:
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    if isinstance(params, Mapping):
        return list(params.items())
    return list(params)


def label_tree(params: NamedParams, fn: Callable[[str, Any], str]) -> dict:
    """``{name: fn(lowercased name, parameter)}`` over the named
    parameters (the JAX package's label pytree)."""
    return {name: fn(name.lower(), p) for name, p in _named(params)}


def decay_labels(params: NamedParams) -> dict:
    """The standard AdamW two-group split: weight matrices decay
    ("decay"); biases, norm scales and any sub-2D parameter do not
    ("no_decay")."""

    def assign(name: str, p: Any) -> str:
        if p.dim() < 2:
            return "no_decay"
        if any(h in name for h in _NO_DECAY_NAME_HINTS):
            return "no_decay"
        return "decay"

    return label_tree(params, assign)


def with_param_groups(
    factory: Callable[..., torch.optim.Optimizer],
    groups: Mapping[str, Mapping[str, Any]],
    labels: Union[Mapping[str, str], Callable[[list], Mapping[str, str]]],
    params: NamedParams,
    **common: Any,
) -> torch.optim.Optimizer:
    """``factory(param_groups, **common)`` with one group per label of
    ``groups``: ``{"params": [...], "name": label, **groups[label]}``.
    ``labels`` maps parameter names to group names, or is a callable of the
    named parameters that returns such a map (e.g. :func:`decay_labels`).
    A label that names no group raises ``ValueError``; a group that gets no
    parameter is left out."""
    named = _named(params)
    lab = dict(labels(named) if callable(labels) else labels)
    missing = sorted(n for n, _ in named if n not in lab)
    if missing:
        raise ValueError(f"no label for parameters {missing}")
    unknown = set(lab.values()) - set(groups)
    if unknown:
        raise ValueError(
            f"labels reference undefined groups {sorted(unknown)}; "
            f"defined: {sorted(groups)}"
        )
    param_groups = []
    for label, overrides in groups.items():
        members = [p for n, p in named if lab[n] == label]
        if members:
            param_groups.append({"params": members, "name": label, **dict(overrides)})
    return factory(param_groups, **common)
