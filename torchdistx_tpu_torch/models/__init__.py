from .llama import Llama, LlamaConfig, llama_configs

__all__ = ["Llama", "LlamaConfig", "llama_configs"]
