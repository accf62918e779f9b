from . import functional, init
from .layers import Embedding, LayerNorm, Linear, RMSNorm
from .moe import MoE
from .quantization import QuantizedLinear, QuantizedMoE, quantize_module

__all__ = ["functional", "init", "Linear", "Embedding", "LayerNorm", "RMSNorm", "MoE",
           "QuantizedLinear", "QuantizedMoE", "quantize_module"]
