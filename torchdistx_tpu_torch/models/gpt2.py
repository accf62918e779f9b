"""GPT-2 family, counterpart of ``torchdistx_tpu/models/gpt2.py``.

Learned positional embeddings, pre-LayerNorm blocks, tanh-GELU MLP, biased
Linears, weight-tied LM head (``x @ tok_emb.weight.T``).  Parameter names,
layouts and the init scheme (N(0, 0.02) weights, residual projections
N(0, 0.02 / sqrt(2 * n_layers)), zero biases) are the JAX package's, so
``interop.load_jax_params`` carries a JAX model's weights across one to
one.  With ``use_flash`` resolved on, attention runs through the
differentiable ``ops.flash_attention.flash_attention`` (head_dim 64).
With ``sp_axis`` set the sequence is sharded over that mesh axis (run the
model inside the ``parallel.Mesh``, as the sharded train steps do): each
rank embeds its block at the global positions ``axis_index * s +
arange(s)`` (a ``ValueError`` when ``s * n`` exceeds ``n_positions``) and
attends through ``ops.attention.sp_attention``, the flash ring
(``sp_mode="ring"``, the plain ring without flash) or Ulysses.
``forward(tokens, return_hidden=True)`` returns the post-``ln_f`` hidden
states for ``ops.fused_ce.fused_linear_cross_entropy`` with the tied
``tok_emb.weight`` as the head.

Serving follows the Llama contract (``generation.generate``,
``serve.ServeEngine``): ``init_cache`` gives per-layer (k, v) slabs of
(B, max_seq, H, 64), ``forward_cached`` runs a prompt or a token against
them from a host position (a from-empty prefill through the flash kernel
on the card), and ``forward_decode`` runs one token or a verify block per
serving slot at the (B,) device ``positions`` through the decode kernels,
slab or paged.  Learned positions are looked up per row from
``positions`` on the device, so a decode iteration reads nothing back and
can be captured in a CUDA graph.  GPT-2 has as many KV heads as query
heads: the decode kernels run at group size 1.
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
from ..obs.numerics import tap as _num_tap
from ..ops.attention import (
    cached_attention,
    multihead_attention,
    slot_cached_attention,
    sp_attention,
)
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
    # sequence parallelism: the mesh axis the sequence is sharded over, and
    # "ring" (the flash ring, or the plain ring without flash) or "ulysses"
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

    def _qkv(self, x):
        b, s, d = x.shape
        h = self.ln1(x)
        # (b, s, 3, H, hd), then [:, :, 0/1/2]: the JAX split order
        qkv = self.attn_qkv(h).reshape(b, s, 3, self.n_heads, d // self.n_heads)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _rest(self, x, a):
        b, s, d = x.shape
        x = x + self.attn_out(a.reshape(b, s, d))
        h = self.ln2(x)
        return x + self.mlp_down(F.gelu(self.mlp_up(h)))

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self._qkv(x)
        if self.cfg.sp_axis is not None:
            a = sp_attention(q, k, v, axis=self.cfg.sp_axis, mode=self.cfg.sp_mode,
                             causal=True, use_flash=self.cfg.use_flash)
        elif resolve_use_flash(self.cfg.use_flash, x.device):
            a = flash_attention(q, k, v, causal=True)
        else:
            a = multihead_attention(q, k, v, causal=True)
        return self._rest(x, a)

    def forward_cached(self, x, cache, cache_pos):
        """Attention against the (k, v) cache from host position
        ``cache_pos`` (``ops.attention.cached_attention``: the flash kernel
        for a from-empty prefill on the card).  Returns (x, cache)."""
        q, k, v = self._qkv(x)
        a, cache = cached_attention(q, k, v, cache, cache_pos,
                                    use_flash=self.cfg.use_flash)
        return self._rest(x, a), cache

    def forward_decode(self, x, cache, positions, page_tables=None):
        """One token (or a verify block) per serving slot at its own depth
        (``ops.attention.slot_cached_attention``: the decode kernels on the
        card, the paged ones with ``page_tables``).  Returns (x, cache)."""
        q, k, v = self._qkv(x)
        a, cache = slot_cached_attention(q, k, v, cache, positions,
                                         use_flash=self.cfg.use_flash,
                                         page_tables=page_tables)
        return self._rest(x, a), cache


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
        s = tokens.shape[1]
        start = 0
        if self.cfg.sp_axis is not None:
            from ..parallel.collectives import axis_index, axis_size

            # s is this rank's shard; the positions are global
            n = axis_size(self.cfg.sp_axis)
            if s * n > self.cfg.n_positions:
                raise ValueError(
                    f"global sequence length {s * n} exceeds n_positions="
                    f"{self.cfg.n_positions}"
                )
            start = axis_index(self.cfg.sp_axis) * s
        elif s > self.cfg.n_positions:
            # an embedding lookup past the table would fail less clearly
            raise ValueError(
                f"sequence length {s} exceeds n_positions={self.cfg.n_positions}"
            )
        pos = torch.arange(start, start + s, device=tokens.device)
        x = _num_tap("tok_emb", self.tok_emb(tokens) + self.pos_emb(pos)[None])
        for i, blk in enumerate(self.blocks):
            x = _num_tap(f"block{i}", blk(x))
        x = self.ln_f(x)
        if return_hidden:
            return x
        return _num_tap("logits", x @ self.tok_emb.weight.T)

    # -- KV-cache decode (the generation.generate contract, as Llama's) ----

    def init_cache(self, batch_size: int, max_seq: Optional[int] = None):
        """Per-layer (k, v) caches of static shape (B, max_seq, H, D)."""
        cfg = self.cfg
        max_seq = max_seq or cfg.n_positions
        shape = (batch_size, max_seq, cfg.n_heads, cfg.dim // cfg.n_heads)
        return [
            (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(shape, dtype=cfg.dtype, device=self.device))
            for _ in range(cfg.n_layers)
        ]

    def _head(self, x):
        return self.ln_f(x) @ self.tok_emb.weight.T

    def forward_cached(self, tokens, cache, cache_pos):
        """Run ``tokens`` (a prompt or one token) against the cache from
        host position ``cache_pos`` (the cache is updated in place).
        Returns (logits, cache)."""
        s = tokens.shape[1]
        pos = int(cache_pos) + torch.arange(s, device=tokens.device)
        x = self.tok_emb(tokens) + self.pos_emb(pos)[None]
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk.forward_cached(x, c, cache_pos)
            new_cache.append(c)
        return self._head(x), new_cache

    def forward_decode(self, tokens, cache, positions, page_tables=None):
        """One decode step for independent serving slots: ``tokens`` (B, S),
        ``positions`` (B,) integer on the device, token ``(b, i)`` at depth
        ``positions[b] + i`` (``S > 1`` is the speculative verify block,
        whose positions clip to ``n_positions - 1`` as JAX's do).  With
        ``page_tables`` the cache is the per-layer page pools.  Returns
        (logits, cache)."""
        s = tokens.shape[1]
        positions = positions.to(tokens.device).long()
        if s == 1:
            x = self.tok_emb(tokens) + self.pos_emb(positions)[:, None]
        else:
            pos = (positions[:, None]
                   + torch.arange(s, device=tokens.device)[None, :])
            x = self.tok_emb(tokens) + self.pos_emb(
                pos.clamp(0, self.cfg.n_positions - 1))
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk.forward_decode(x, c, positions, page_tables)
            new_cache.append(c)
        return self._head(x), new_cache
