"""GPT-2 family, counterpart of ``torchdistx_tpu/models/gpt2.py``.

Learned positional embeddings, pre-LayerNorm blocks, tanh-GELU MLP, biased
Linears, weight-tied LM head (``x @ tok_emb.weight.T``).  Parameter names,
layouts and the init scheme (N(0, 0.02) weights, residual projections
N(0, 0.02 / sqrt(2 * n_layers)), zero biases) are the JAX package's, so
``interop.load_jax_params`` carries a JAX model's weights across one to
one.  With ``use_flash`` resolved on, attention runs through the
differentiable ``ops.flash_attention.flash_attention`` (head_dim 64).
``forward(tokens, return_hidden=True)`` returns the post-``ln_f`` hidden
states for ``ops.fused_ce.fused_linear_cross_entropy`` with the tied
``tok_emb.weight`` as the head.

Serving (``init_cache``, ``forward_cached``, ``forward_decode``) and
sequence parallelism (``sp_axis``) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn as tnn

from .. import nn
from ..nn import functional as F
from ..nn import init as nn_init
from ..ops.attention import multihead_attention
from ..ops.flash_attention import flash_attention, resolve_use_flash

__all__ = ["GPT2Config", "GPT2", "GPT2Block", "gpt2_configs"]


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    # the kernels; None = auto: on for CUDA tensors, off on the CPU
    use_flash: Optional[bool] = None
    # sequence parallelism: kept for the JAX config's shape, not ported
    sp_axis: Optional[str] = None
    sp_mode: str = "ring"

    def __post_init__(self) -> None:
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(
                f"sp_mode must be 'ring' or 'ulysses', got {self.sp_mode!r}"
            )


# the JAX package's table
gpt2_configs = {
    "tiny": dict(vocab_size=256, n_positions=64, dim=64, n_layers=2, n_heads=4),
    "gpt2": dict(dim=768, n_layers=12, n_heads=12),
    "gpt2_medium": dict(dim=1024, n_layers=24, n_heads=16),
    "gpt2_large": dict(dim=1280, n_layers=36, n_heads=20),
    "gpt2_xl": dict(dim=1600, n_layers=48, n_heads=25),
}


def _normal_init(std):
    return lambda s, d, dev: nn_init.normal(s, std=std, dtype=d, device=dev)


def _zeros_init(s, d, dev):
    return nn_init.zeros(s, d, dev)


def _unported(what):
    raise NotImplementedError(f"GPT-2 {what} is not ported yet")


class GPT2Block(tnn.Module):
    def __init__(self, cfg: GPT2Config, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        w = _normal_init(0.02)
        w_res = _normal_init(0.02 / math.sqrt(2 * cfg.n_layers))
        kw = dict(dtype=cfg.dtype, device=device)
        self.ln1 = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.attn_qkv = nn.Linear(d, 3 * d, weight_init=w, bias_init=_zeros_init, **kw)
        self.attn_out = nn.Linear(d, d, weight_init=w_res, bias_init=_zeros_init, **kw)
        self.ln2 = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.mlp_up = nn.Linear(d, 4 * d, weight_init=w, bias_init=_zeros_init, **kw)
        self.mlp_down = nn.Linear(4 * d, d, weight_init=w_res, bias_init=_zeros_init, **kw)
        self.n_heads = cfg.n_heads

    def forward(self, x):
        b, s, d = x.shape
        h = self.ln1(x)
        # (b, s, 3, H, hd), then [:, :, 0/1/2]: the JAX split order
        qkv = self.attn_qkv(h).reshape(b, s, 3, self.n_heads, d // self.n_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if resolve_use_flash(self.cfg.use_flash, x.device):
            a = flash_attention(q, k, v, causal=True)
        else:
            a = multihead_attention(q, k, v, causal=True)
        x = x + self.attn_out(a.reshape(b, s, d))
        h = self.ln2(x)
        return x + self.mlp_down(F.gelu(self.mlp_up(h)))


class GPT2(tnn.Module):
    def __init__(self, cfg: GPT2Config, device="cuda"):
        super().__init__()
        self.cfg = cfg
        emb = _normal_init(0.02)
        kw = dict(dtype=cfg.dtype, device=device)
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.dim, weight_init=emb, **kw)
        self.pos_emb = nn.Embedding(cfg.n_positions, cfg.dim, weight_init=emb, **kw)
        self.blocks = tnn.ModuleList([GPT2Block(cfg, device) for _ in range(cfg.n_layers)])
        self.ln_f = nn.LayerNorm(cfg.dim, eps=cfg.norm_eps, **kw)

    @classmethod
    def from_name(cls, name: str, *, device="cuda", dtype=None, **overrides) -> "GPT2":
        kw = dict(gpt2_configs[name])
        if dtype is not None:
            kw["dtype"] = dtype
        kw.update(overrides)
        return cls(GPT2Config(**kw), device=device)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    def forward(self, tokens, return_hidden: bool = False):
        """Logits (B, S, vocab) through the tied head; ``return_hidden=True``
        returns the post-``ln_f`` hidden states instead (the input of
        ``fused_linear_cross_entropy`` with ``tok_emb.weight``)."""
        if self.cfg.sp_axis is not None:
            _unported("sequence parallelism (sp_axis)")
        s = tokens.shape[1]
        if s > self.cfg.n_positions:
            # an embedding lookup past the table would fail less clearly
            raise ValueError(
                f"sequence length {s} exceeds n_positions={self.cfg.n_positions}"
            )
        pos = torch.arange(s, device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(pos)[None]
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return x @ self.tok_emb.weight.T

    def init_cache(self, *args, **kwargs):
        _unported("init_cache (serving)")

    def forward_cached(self, *args, **kwargs):
        _unported("forward_cached (serving)")

    def forward_decode(self, *args, **kwargs):
        _unported("forward_decode (serving)")
