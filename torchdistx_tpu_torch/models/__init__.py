from .gpt2 import GPT2, GPT2Config, gpt2_configs
from .llama import Llama, LlamaConfig, llama_configs
from .mixtral import Mixtral, MixtralBlock, MixtralConfig, mixtral_configs
from .resnet import ResNet, resnet18, resnet50, resnet101
from .t5 import T5, T5Config, t5_configs
from .vit import ViT, ViTConfig, vit_configs

__all__ = ["GPT2", "GPT2Config", "gpt2_configs", "Llama", "LlamaConfig", "llama_configs",
           "Mixtral", "MixtralBlock", "MixtralConfig", "mixtral_configs",
           "ResNet", "resnet18", "resnet50", "resnet101",
           "T5", "T5Config", "t5_configs", "ViT", "ViTConfig", "vit_configs"]
