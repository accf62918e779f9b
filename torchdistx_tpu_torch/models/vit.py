"""Vision Transformer (ViT) family, counterpart of
``torchdistx_tpu/models/vit.py`` (Dosovitskiy et al., arXiv:2010.11929).

A conv patchify stem, a learned [CLS] token and positional table,
pre-LayerNorm bidirectional encoder blocks with separate q/k/v projections
and EXACT (erf) GELU, and a classification head on the [CLS] row.
Parameter names and the init scheme are the JAX package's, so
``interop.load_jax_params`` carries a JAX model across one to one and
``interop.vit_key_map`` loads an HF ``ViTForImageClassification``.

Attention runs through the plain ``ops.attention.multihead_attention``
(f32 softmax), not the flash kernels: the JAX package takes its jnp path
here on purpose (197 tokens at ViT-B/16's 224 px, too short for flash to
pay), so no Pallas kernel lies on this path.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn as tnn

from .. import nn
from ..nn import functional as F
from ..nn import init
from ..ops.attention import multihead_attention

__all__ = ["ViT", "ViTBlock", "ViTConfig", "vit_configs"]


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}"
            )

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


# the JAX package's table (the ViT paper's table 1; "tiny" for tests)
vit_configs = {
    "tiny": dict(image_size=32, patch_size=8, num_classes=10, dim=32,
                 n_layers=2, n_heads=2, mlp_dim=64),
    "vit_b16": dict(),
    "vit_l16": dict(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096),
}


class ViTBlock(tnn.Module):
    def __init__(self, cfg: ViTConfig, device="cuda"):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.ln1 = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps, **kw)
        self.q = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.k = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.v = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.proj = nn.Linear(cfg.dim, cfg.dim, **kw)
        self.ln2 = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps, **kw)
        self.fc1 = nn.Linear(cfg.dim, cfg.mlp_dim, **kw)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.dim, **kw)
        self.n_heads = cfg.n_heads
        self.head_dim = cfg.dim // cfg.n_heads

    def forward(self, x):
        b, s, d = x.shape
        h = self.ln1(x)
        shape = (b, s, self.n_heads, self.head_dim)
        q, k, v = (proj(h).reshape(shape) for proj in (self.q, self.k, self.v))
        att = multihead_attention(q, k, v, causal=False)
        x = x + self.proj(att.reshape(b, s, d))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate=False))


class ViT(tnn.Module):
    def __init__(self, cfg: ViTConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.patch_embed = nn.Conv2d(3, cfg.dim, cfg.patch_size, stride=cfg.patch_size, **kw)
        # [CLS] token + learned positions over (1 + n_patches) slots
        self.cls_token = tnn.Parameter(init.truncated_normal((1, 1, cfg.dim), std=0.02, **kw))
        self.pos_emb = tnn.Parameter(
            init.truncated_normal((1, 1 + cfg.n_patches, cfg.dim), std=0.02, **kw))
        self.blocks = nn.ModuleList([ViTBlock(cfg, device) for _ in range(cfg.n_layers)])
        self.ln_f = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps, **kw)
        self.head = nn.Linear(cfg.dim, cfg.num_classes, **kw)

    @classmethod
    def from_name(cls, name: str, *, device="cuda", dtype=None, **overrides) -> "ViT":
        kw = dict(vit_configs[name])
        if dtype is not None:
            kw["dtype"] = dtype
        kw.update(overrides)
        return cls(ViTConfig(**kw), device=device)

    def forward(self, images, return_hidden: bool = False):
        """``images``: (B, 3, H, W).  Returns (B, num_classes) logits, or the
        (B, 1 + n_patches, dim) encoded sequence with ``return_hidden=True``."""
        b = images.shape[0]
        x = self.patch_embed(images)  # (B, dim, H/p, W/p)
        x = x.reshape(b, self.cfg.dim, -1).transpose(1, 2)
        cls = self.cls_token.expand(b, 1, self.cfg.dim).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.pos_emb
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.head(x[:, 0])
