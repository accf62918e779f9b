from .anyprecision_optimizer import AnyPrecisionAdamW
from .param_groups import decay_labels, label_tree, with_param_groups
from .quantized import (
    Adam8bitState,
    AdamW8bit,
    adam8bit_state_shardings,
    adamw_8bit,
    blockwise_dequantize,
    blockwise_quantize,
)

__all__ = ["AnyPrecisionAdamW", "AdamW8bit", "adamw_8bit", "Adam8bitState",
           "adam8bit_state_shardings", "blockwise_quantize", "blockwise_dequantize",
           "decay_labels", "label_tree", "with_param_groups"]
