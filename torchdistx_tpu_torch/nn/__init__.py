from . import functional, init
from .layers import Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "init", "Linear", "Embedding", "LayerNorm", "RMSNorm"]
