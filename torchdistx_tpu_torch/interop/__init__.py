from .from_jax import export_params, load_jax_params

__all__ = ["load_jax_params", "export_params"]
