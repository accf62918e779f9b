from .anyprecision_optimizer import AnyPrecisionAdamW
from .param_groups import decay_labels, label_tree, with_param_groups

__all__ = ["AnyPrecisionAdamW", "decay_labels", "label_tree", "with_param_groups"]
