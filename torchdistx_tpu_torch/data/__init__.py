from .loader import DataLoader, TokenDataset, prefetch_to_device

__all__ = ["DataLoader", "TokenDataset", "prefetch_to_device"]
