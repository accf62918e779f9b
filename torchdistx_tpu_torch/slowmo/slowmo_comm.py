"""SlowMo communication hook, counterpart of
``torchdistx_tpu/slowmo/slowmo_comm.py``: gradients are averaged within a
node only (the ``local`` mesh axis); the nodes meet only in
:class:`~.slowmo_optimizer.SlowMomentumOptimizer`'s periodic average.
"""

from __future__ import annotations

from typing import Any, Optional

from ..parallel import collectives
from ..parallel.comm_hooks import DefaultState, HookContext

__all__ = ["SlowMoState", "slowmo_hook"]


class SlowMoState(DefaultState):
    def __init__(self, subgroup_axis: Optional[str] = "local", sync_grads: bool = True) -> None:
        super().__init__()
        self.subgroup_axis = subgroup_axis
        self.sync_grads = sync_grads


def slowmo_hook(state: SlowMoState, grads: Any, ctx: HookContext) -> Any:
    """The mean over ``state.subgroup_axis`` when ``state.sync_grads``; else
    the gradients as they are."""
    if state.sync_grads and state.subgroup_axis is not None:
        grads = collectives.all_mean(grads, state.subgroup_axis)
    return grads
