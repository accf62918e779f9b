from .rng import manual_seed, next_generator

__all__ = ["manual_seed", "next_generator"]
