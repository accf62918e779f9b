from .gpt2 import GPT2, GPT2Config, gpt2_configs
from .llama import Llama, LlamaConfig, llama_configs

__all__ = ["GPT2", "GPT2Config", "gpt2_configs", "Llama", "LlamaConfig", "llama_configs"]
