"""SlowMo (arXiv:1910.00643), counterpart of ``torchdistx_tpu/slowmo``: the
intra-node gradient hook and the slow-momentum optimizer wrapper."""

from .slowmo_comm import SlowMoState, slowmo_hook
from .slowmo_optimizer import SlowMomentumOptimizer, replica_mean, slow_momentum

__all__ = [
    "SlowMoState",
    "slowmo_hook",
    "SlowMomentumOptimizer",
    "slow_momentum",
    "replica_mean",
]
