"""Llama-family decoder, counterpart of ``torchdistx_tpu/models/llama.py``.

RMSNorm pre-norm, rotary position embeddings (computed in f32, cast back),
grouped-query attention, SwiGLU MLP, untied LM head.  Parameter names and
layouts are the JAX package's, so ``interop.load_jax_params`` carries a
JAX model's weights across one to one.  With ``use_flash`` resolved on,
the training forward runs through the differentiable
``ops.flash_attention.flash_attention`` (forward with ``lse``, backward by
the FA2 kernels).  ``remat`` recomputes each block in the backward through
``torch.utils.checkpoint``.  Sequence parallelism is a later slice: its
config fields (``sp_axis``, ``sp_mode``) are not carried yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn as tnn

from .. import nn
from ..nn import functional as F
from ..nn import init as nn_init
from ..ops.attention import (
    cached_attention,
    multihead_attention,
    slot_cached_attention,
)
from ..ops.flash_attention import flash_attention, resolve_use_flash

__all__ = ["LlamaConfig", "Llama", "llama_configs", "apply_rope", "apply_rope_at"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None
    ffn_dim: Optional[int] = None  # default: Llama SwiGLU sizing
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # the kernels; None = auto: on for CUDA tensors, off on the CPU
    use_flash: Optional[bool] = None
    sliding_window: Optional[int] = None
    # recompute each block in the backward instead of keeping its
    # activations; "full" recomputes everything ("dots", which keeps the
    # matmul outputs, is not ported yet)
    remat: bool = False
    remat_policy: str = "full"

    def __post_init__(self) -> None:
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got {self.remat_policy!r}"
            )
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {self.sliding_window}"
            )
        if self.n_kv_heads is None:
            self.n_kv_heads = self.n_heads
        if self.ffn_dim is None:
            hidden = int(2 * (4 * self.dim) / 3)
            multiple = 256
            self.ffn_dim = multiple * ((hidden + multiple - 1) // multiple)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def _hf_normal(shape, dtype, device):
    """HF Llama init: N(0, initializer_range=0.02) for matmuls/embeddings."""
    return nn_init.normal(shape, std=0.02, dtype=dtype, device=device)


# the JAX package's table, with torch dtypes
llama_configs = {
    "tiny": dict(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, max_seq_len=128,
        dtype=torch.float32,
    ),
    "llama_1b": dict(
        vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
        max_seq_len=2048, remat=True,
    ),
    "llama2_7b": dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
        max_seq_len=4096,
    ),
    "llama2_13b": dict(
        vocab_size=32000, dim=5120, n_layers=40, n_heads=40,
        max_seq_len=4096,
    ),
    "mistral_7b": dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, ffn_dim=14336, max_seq_len=8192,
        rope_theta=10000.0, sliding_window=4096,
    ),
    "llama3_8b": dict(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, ffn_dim=14336, max_seq_len=8192,
        rope_theta=500000.0,
    ),
}


def _rope_freqs(head_dim: int, max_seq: int, theta: float,
                device="cuda") -> torch.Tensor:
    """(max_seq, head_dim/2, 2) f32 table of (cos, sin)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (exps / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def _rotate(x, cos, sin):
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, rope, offset: int = 0):
    """x: (B, S, H, D); rope: (max_seq, D/2, 2); scalar ``offset``."""
    s = x.shape[1]
    offset = min(max(int(offset), 0), rope.shape[0] - s)  # XLA's clamp
    window = rope[offset:offset + s]
    return _rotate(x, window[None, :, None, :, 0], window[None, :, None, :, 1])


def apply_rope_at(x, rope, positions):
    """x: (B, S, H, D); ``positions``: (B,) per-row rotary offsets; token
    ``(b, i)`` is rotated at ``positions[b] + i``, clipped to the table."""
    s = x.shape[1]
    pos = positions.to(rope.device).long()
    grid = (pos[:, None] + torch.arange(s, device=rope.device)[None, :])
    window = rope[grid.clamp(0, rope.shape[0] - 1)]  # (B, S, D/2, 2)
    return _rotate(x, window[:, :, None, :, 0], window[:, :, None, :, 1])


def _linear(cfg, i, o, device):
    return nn.Linear(i, o, bias=False, dtype=cfg.dtype, device=device,
                     weight_init=_hf_normal)


class LlamaAttention(tnn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        d, hd = cfg.dim, cfg.head_dim
        self.cfg = cfg
        self.wq = _linear(cfg, d, cfg.n_heads * hd, device)
        self.wk = _linear(cfg, d, cfg.n_kv_heads * hd, device)
        self.wv = _linear(cfg, d, cfg.n_kv_heads * hd, device)
        self.wo = _linear(cfg, cfg.n_heads * hd, d, device)

    def _qkv(self, x):
        b, s, _ = x.shape
        cfg = self.cfg
        q = self.wq(x).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        return q, k, v

    def _out(self, out):
        b, s = out.shape[:2]
        return self.wo(out.reshape(b, s, self.cfg.n_heads * self.cfg.head_dim))

    def forward(self, x, rope, pos_offset: int = 0):
        cfg = self.cfg
        q, k, v = self._qkv(x)
        q = apply_rope(q, rope, pos_offset)
        k = apply_rope(k, rope, pos_offset)
        if resolve_use_flash(cfg.use_flash, x.device):
            if cfg.sliding_window is not None:
                raise NotImplementedError(
                    "sliding-window flash attention is not ported yet"
                )
            out = flash_attention(q, k, v, causal=True)
        else:
            out = multihead_attention(
                q, k, v, causal=True, window=cfg.sliding_window
            )
        return self._out(out)

    def forward_cached(self, x, rope, cache, cache_pos):
        cfg = self.cfg
        q, k, v = self._qkv(x)
        q = apply_rope(q, rope, cache_pos)
        k = apply_rope(k, rope, cache_pos)
        out, cache = cached_attention(
            q, k, v, cache, cache_pos, use_flash=cfg.use_flash,
            window=cfg.sliding_window,
        )
        return self._out(out), cache

    def forward_decode(self, x, rope, cache, positions, page_tables=None):
        cfg = self.cfg
        q, k, v = self._qkv(x)
        q = apply_rope_at(q, rope, positions)
        k = apply_rope_at(k, rope, positions)
        out, cache = slot_cached_attention(
            q, k, v, cache, positions, window=cfg.sliding_window,
            use_flash=cfg.use_flash, page_tables=page_tables,
        )
        return self._out(out), cache


class LlamaMLP(tnn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.w_gate = _linear(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w_up = _linear(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w_down = _linear(cfg, cfg.ffn_dim, cfg.dim, device)

    def forward(self, x):
        return self.w_down(F.silu(self.w_gate(x)) * self.w_up(x))


class LlamaBlock(tnn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.attn_norm = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, dtype=cfg.dtype,
                                    device=device)
        self.attn = LlamaAttention(cfg, device)
        self.mlp_norm = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, dtype=cfg.dtype,
                                   device=device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, rope):
        x = x + self.attn(self.attn_norm(x), rope)
        return x + self.mlp(self.mlp_norm(x))

    def forward_cached(self, x, rope, cache, cache_pos):
        a, cache = self.attn.forward_cached(self.attn_norm(x), rope, cache,
                                            cache_pos)
        x = x + a
        return x + self.mlp(self.mlp_norm(x)), cache

    def forward_decode(self, x, rope, cache, positions, page_tables=None):
        a, cache = self.attn.forward_decode(self.attn_norm(x), rope, cache,
                                            positions, page_tables)
        x = x + a
        return x + self.mlp(self.mlp_norm(x)), cache


class Llama(tnn.Module):
    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=cfg.dtype,
                                    device=device, weight_init=_hf_normal)
        self.blocks = tnn.ModuleList(
            [LlamaBlock(cfg, device) for _ in range(cfg.n_layers)]
        )
        self.norm = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, dtype=cfg.dtype,
                               device=device)
        self.lm_head = _linear(cfg, cfg.dim, cfg.vocab_size, device)
        self._rope = {}  # device -> f32 table, not a parameter or buffer

    @classmethod
    def from_name(cls, name: str, *, device="cuda", dtype=None,
                  **overrides) -> "Llama":
        kw = dict(llama_configs[name])
        if dtype is not None:
            kw["dtype"] = dtype
        kw.update(overrides)
        return cls(LlamaConfig(**kw), device=device)

    @property
    def device(self) -> torch.device:
        return self.tok_emb.weight.device

    def rope_table(self):
        dev = self.device
        if dev not in self._rope:
            cfg = self.cfg
            self._rope[dev] = _rope_freqs(cfg.head_dim, cfg.max_seq_len,
                                          cfg.rope_theta, dev)
        return self._rope[dev]

    def forward(self, tokens, return_hidden: bool = False):
        """Logits (B, S, vocab); ``return_hidden=True`` returns the
        pre-LM-head hidden states instead (the input of a fused LM-head
        loss)."""
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet"
            )
        rope = self.rope_table()
        x = self.tok_emb(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    blk, x, rope, use_reentrant=False)
            else:
                x = blk(x, rope)
        x = self.norm(x)
        if return_hidden:
            return x
        return self.lm_head(x)

    # -- incremental decoding (KV cache) ----------------------------------

    def init_cache(self, batch_size: int, max_seq: Optional[int] = None):
        """Per-layer (k, v) caches of static shape (B, max_seq, Hkv, D)."""
        cfg = self.cfg
        max_seq = max_seq or cfg.max_seq_len
        shape = (batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return [
            (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
             torch.zeros(shape, dtype=cfg.dtype, device=self.device))
            for _ in range(cfg.n_layers)
        ]

    def forward_cached(self, tokens, cache, cache_pos):
        """Run ``tokens`` against the cache from position ``cache_pos``
        (the cache is updated in place).  Returns (logits, cache)."""
        rope = self.rope_table()
        x = self.tok_emb(tokens)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk.forward_cached(x, rope, c, cache_pos)
            new_cache.append(c)
        return self.lm_head(self.norm(x)), new_cache

    def forward_decode(self, tokens, cache, positions, page_tables=None):
        """One decode step for independent serving slots: ``tokens`` (B, 1),
        ``positions`` (B,) — row ``b`` is written at its own depth.
        Returns (logits, cache)."""
        rope = self.rope_table()
        x = self.tok_emb(tokens)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk.forward_decode(x, rope, c, positions, page_tables)
            new_cache.append(c)
        return self.lm_head(self.norm(x)), new_cache
