from . import functional, init
from .layers import (
    GELU,
    BatchNorm2d,
    Conv2d,
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    ModuleList,
    ReLU,
    RMSNorm,
    Sequential,
    SiLU,
)
from .moe import MoE
from .quantization import QuantizedLinear, QuantizedMoE, quantize_module

__all__ = ["functional", "init", "Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "Sequential", "ModuleList", "Conv2d", "BatchNorm2d", "ReLU", "GELU", "SiLU",
           "MoE", "QuantizedLinear", "QuantizedMoE", "quantize_module"]
