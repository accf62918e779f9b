from . import functional, init
from .layers import Embedding, Linear, RMSNorm

__all__ = ["functional", "init", "Linear", "Embedding", "RMSNorm"]
