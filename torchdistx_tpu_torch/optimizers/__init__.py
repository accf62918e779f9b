from .anyprecision_optimizer import AnyPrecisionAdamW

__all__ = ["AnyPrecisionAdamW"]
