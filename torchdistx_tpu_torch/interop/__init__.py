from .from_jax import export_params, load_jax_adam8bit_state, load_jax_buffers, load_jax_params
from .torch_interop import (
    from_torch_state_dict,
    gpt2_key_map,
    llama_key_map,
    mixtral_key_map,
    t5_key_map,
    to_torch_state_dict,
    vit_key_map,
)

__all__ = ["load_jax_params", "load_jax_buffers", "export_params", "load_jax_adam8bit_state",
           "from_torch_state_dict", "to_torch_state_dict", "gpt2_key_map", "llama_key_map",
           "mixtral_key_map", "t5_key_map", "vit_key_map"]
