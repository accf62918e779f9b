from .gpt2 import GPT2, GPT2Config, gpt2_configs
from .llama import Llama, LlamaConfig, llama_configs
from .mixtral import Mixtral, MixtralBlock, MixtralConfig, mixtral_configs
from .t5 import T5, T5Config, t5_configs

__all__ = ["GPT2", "GPT2Config", "gpt2_configs", "Llama", "LlamaConfig", "llama_configs",
           "Mixtral", "MixtralBlock", "MixtralConfig", "mixtral_configs",
           "T5", "T5Config", "t5_configs"]
