"""T5 encoder-decoder family, counterpart of ``torchdistx_tpu/models/t5.py``
(BASELINE config 4: deferred_init(T5-3B) -> materialize -> train step).

Standard T5 v1.0: RMS-style LayerNorm without bias or mean subtraction,
relative-position-bucket attention bias shared across the layers of each
stack (layer 0 owns it), ReLU MLP, tied embedding with T5's 1/sqrt(dim)
head scaling, unscaled attention logits.  Parameter names, layouts and
init (kaiming-uniform ``Linear``, N(0, 1) ``Embedding``, unit norms) are
the JAX package's, so ``interop.load_jax_params`` carries a JAX model's
weights across one to one.

Self-attention runs through the differentiable
``ops.flash_attention.flash_attention`` when ``use_flash`` resolves on
(auto: CUDA tensors): with the materialized (H, S, S) bias by default, or
with ``flash_bucket_bias`` the (H, buckets) table, whose biases the
kernels look up per tile so that no (H, S, S) bias exists.  Either way the
bias's gradient comes from a kernel (dbias or dtable) and reaches
``rel_bias.weight`` through autograd.  Cross-attention is plain
``einsum`` and softmax, as in JAX.  Bucket ids come from
``ops.flash_attention.rel_bucket_ids`` (computed on the CPU, cached on the
device), so the materialized bias and the kernels' agree.  The plain
path (``use_flash`` off) is the kernels' plain version, the JAX einsum
branch's math.

With ``sp_axis`` set the sequence is sharded over that mesh axis (run the
model inside the ``parallel.Mesh``): self-attention runs the ring
(``ops.attention.sp_attention``: the flash ring when ``use_flash``
resolves on) with this rank's slice of the relative-position bias, its
query rows at their global positions against every key, (H, sq_local,
S); cross-attention runs a non-causal ring over the encoder's key
shards.  ``flash_bucket_bias`` with ``sp_axis`` raises.  Cached
generation (``decode_step``, ``init_decoder_cache``) runs unsharded and
is not ported yet: it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn as tnn

from .. import nn
from ..nn import functional as F
from ..ops.attention import sp_attention
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    rel_bucket_ids,
    rel_bucket_matrix,
    resolve_use_flash,
)

__all__ = ["T5Config", "T5", "T5Attention", "T5Block", "t5_configs"]


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    dim: int = 512
    d_ff: int = 2048
    d_kv: int = 64
    n_heads: int = 8
    n_layers: int = 6  # per stack
    rel_pos_buckets: int = 32
    rel_pos_max_dist: int = 128
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    # the kernels for self-attention; None = auto: on for CUDA tensors, off
    # on the CPU.  Cross-attention stays einsum.
    use_flash: Optional[bool] = None
    # self-attention passes the (H, buckets) table into the flash kernels
    # instead of the materialized (H, S, S) bias; requires use_flash
    flash_bucket_bias: bool = False
    # sequence parallelism: the mesh axis the sequence (of both stacks) is
    # sharded over; the ring, with the bias sliced per rank
    sp_axis: Optional[str] = None

    def __post_init__(self) -> None:
        if self.flash_bucket_bias and self.sp_axis is not None:
            raise ValueError(
                "flash_bucket_bias is not supported together with "
                "sp_axis: the ring paths slice a materialized per-device "
                "bias (O(S) rows) — drop one of the two"
            )


# the JAX package's table
t5_configs = {
    "tiny": dict(vocab_size=256, dim=64, d_ff=128, d_kv=16, n_heads=4, n_layers=2),
    "t5_small": dict(dim=512, d_ff=2048, d_kv=64, n_heads=8, n_layers=6),
    "t5_base": dict(dim=768, d_ff=3072, d_kv=64, n_heads=12, n_layers=12),
    "t5_large": dict(dim=1024, d_ff=4096, d_kv=64, n_heads=16, n_layers=24),
    "t5_3b": dict(dim=1024, d_ff=16384, d_kv=128, n_heads=32, n_layers=24),
    "t5_11b": dict(dim=1024, d_ff=65536, d_kv=128, n_heads=128, n_layers=24),
}


def _unported(what):
    raise NotImplementedError(f"T5 {what} is not ported yet")


class T5Attention(tnn.Module):
    def __init__(self, cfg: T5Config, *, has_rel_bias: bool, bidirectional: bool,
                 device="cuda"):
        super().__init__()
        inner = cfg.n_heads * cfg.d_kv
        self.cfg = cfg
        self.bidirectional = bidirectional
        kw = dict(bias=False, dtype=cfg.dtype, device=device)
        self.q = nn.Linear(cfg.dim, inner, **kw)
        self.k = nn.Linear(cfg.dim, inner, **kw)
        self.v = nn.Linear(cfg.dim, inner, **kw)
        self.o = nn.Linear(inner, cfg.dim, **kw)
        if has_rel_bias:
            self.rel_bias = nn.Embedding(cfg.rel_pos_buckets, cfg.n_heads,
                                         dtype=cfg.dtype, device=device)
        else:
            self.rel_bias = None

    def _bucket_cfg(self):
        return (self.cfg.rel_pos_buckets, self.cfg.rel_pos_max_dist, self.bidirectional)

    def _bias(self, sq: int, skv: int):
        """(H, sq, skv) relative-position bias, contiguous (the kernels read
        it in that layout; one copy per stack, not per layer)."""
        if self.rel_bias is None:
            return None
        bucket = rel_bucket_matrix(sq, skv, self._bucket_cfg(), self.rel_bias.weight.device)
        return self.rel_bias(bucket).permute(2, 0, 1).contiguous()  # (H, Sq, Skv)

    def _bias_sp(self, sq: int):
        """This rank's slice of the sequence-parallel bias: its query rows
        (global positions from ``axis_index * sq``) against every key
        position, (H, sq, n * sq), the ring's layout."""
        if self.rel_bias is None:
            return None
        from ..parallel.collectives import axis_index, axis_size

        n, idx = axis_size(self.cfg.sp_axis), axis_index(self.cfg.sp_axis)
        s, dev = n * sq, self.rel_bias.weight.device
        buckets, max_dist, bidirectional = self._bucket_cfg()
        ids = rel_bucket_ids(s, s, bidirectional=bidirectional, buckets=buckets,
                             max_dist=max_dist, device=dev)
        rows = idx * sq + torch.arange(sq, device=dev)
        rel = torch.arange(s, device=dev)[None, :] - rows[:, None] + (s - 1)
        return self.rel_bias(ids.long()[rel]).permute(2, 0, 1).contiguous()

    def forward(self, x, kv=None, causal: bool = False, bias=None):
        cfg = self.cfg
        b, sq, _ = x.shape
        is_self = kv is None
        kv = x if kv is None else kv
        skv = kv.shape[1]
        q = self.q(x).reshape(b, sq, cfg.n_heads, cfg.d_kv)
        k = self.k(kv).reshape(b, skv, cfg.n_heads, cfg.d_kv)
        v = self.v(kv).reshape(b, skv, cfg.n_heads, cfg.d_kv)
        if cfg.sp_axis is not None:
            # self-attention: the ring with this rank's bias rows (layer 0
            # makes them, the stack shares them); cross-attention: a
            # non-causal ring over the encoder's key shards
            if is_self and bias is None:
                bias = self._bias_sp(sq)
            out = sp_attention(q, k, v, axis=cfg.sp_axis, causal=causal, scale=1.0,
                               bias=bias if is_self else None, use_flash=cfg.use_flash)
            return self.o(out.reshape(b, sq, cfg.n_heads * cfg.d_kv)), bias
        use_flash = is_self and resolve_use_flash(cfg.use_flash, x.device)
        if use_flash and cfg.flash_bucket_bias:
            # the shared "bias" is the (H, buckets) TABLE in this mode:
            # layer 0 extracts it, later layers reuse it
            table = bias
            if table is None and self.rel_bias is not None:
                table = self.rel_bias.weight.t().contiguous()
            out = flash_attention(
                q, k, v, causal=causal, scale=1.0, rel_bias_table=table,
                rel_bias_buckets=cfg.rel_pos_buckets,
                rel_bias_max_dist=cfg.rel_pos_max_dist,
                rel_bias_bidirectional=self.bidirectional,
            )
            return self.o(out.reshape(b, sq, cfg.n_heads * cfg.d_kv)), table
        if bias is None and self.rel_bias is not None:
            bias = self._bias(sq, skv)
        # T5 uses unscaled dot products (scale folded into init); the plain
        # path is the JAX einsum branch's math (the kernels' plain version)
        attend = flash_attention if use_flash else flash_attention_reference
        out = attend(q, k, v, bias=bias, causal=causal, scale=1.0)
        return self.o(out.reshape(b, sq, cfg.n_heads * cfg.d_kv)), bias

    def forward_cached_self(self, *args, **kwargs):
        _unported("cached self-attention (generation)")

    def forward_cross_cached(self, *args, **kwargs):
        _unported("cached cross-attention (generation)")


class T5Block(tnn.Module):
    def __init__(self, cfg: T5Config, *, is_decoder: bool, has_rel_bias: bool,
                 device="cuda"):
        super().__init__()
        self.is_decoder = is_decoder
        kw = dict(dtype=cfg.dtype, device=device)
        self.ln1 = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, **kw)
        self.self_attn = T5Attention(cfg, has_rel_bias=has_rel_bias,
                                     bidirectional=not is_decoder, device=device)
        if is_decoder:
            self.ln_cross = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, **kw)
            self.cross_attn = T5Attention(cfg, has_rel_bias=False, bidirectional=True,
                                          device=device)
        self.ln2 = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, **kw)
        self.wi = nn.Linear(cfg.dim, cfg.d_ff, bias=False, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.dim, bias=False, **kw)

    def forward(self, x, enc=None, bias=None):
        a, bias = self.self_attn(self.ln1(x), causal=self.is_decoder, bias=bias)
        x = x + a
        if self.is_decoder and enc is not None:
            c, _ = self.cross_attn(self.ln_cross(x), kv=enc)
            x = x + c
        return x + self.wo(F.relu(self.wi(self.ln2(x)))), bias

    def decode_step(self, *args, **kwargs):
        _unported("decode_step (generation)")


class T5(tnn.Module):
    def __init__(self, cfg: T5Config, device="cuda"):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.shared_emb = nn.Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.enc_blocks = tnn.ModuleList([
            T5Block(cfg, is_decoder=False, has_rel_bias=(i == 0), device=device)
            for i in range(cfg.n_layers)
        ])
        self.enc_norm = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, **kw)
        self.dec_blocks = tnn.ModuleList([
            T5Block(cfg, is_decoder=True, has_rel_bias=(i == 0), device=device)
            for i in range(cfg.n_layers)
        ])
        self.dec_norm = nn.RMSNorm(cfg.dim, eps=cfg.norm_eps, **kw)

    @classmethod
    def from_name(cls, name: str, *, device="cuda", dtype=None, **overrides) -> "T5":
        kw = dict(t5_configs[name])
        if dtype is not None:
            kw["dtype"] = dtype
        kw.update(overrides)
        return cls(T5Config(**kw), device=device)

    @property
    def device(self) -> torch.device:
        return self.shared_emb.weight.device

    def encode(self, tokens):
        x = self.shared_emb(tokens)
        bias = None
        for i, blk in enumerate(self.enc_blocks):
            x, b = blk(x, bias=bias)
            if i == 0:
                bias = b  # first layer's rel bias shared by the stack
        return self.enc_norm(x)

    def forward(self, enc_tokens, dec_tokens, return_hidden: bool = False):
        """Logits (B, S_dec, vocab) through the tied head; ``return_hidden=
        True`` returns the decoder hidden states with T5's 1/sqrt(dim) head
        scaling already applied (``fused_linear_cross_entropy(h,
        shared_emb.weight, labels)`` then gives the tied-head loss)."""
        enc = self.encode(enc_tokens)
        x = self.shared_emb(dec_tokens)
        bias = None
        for i, blk in enumerate(self.dec_blocks):
            x, b = blk(x, enc=enc, bias=bias)
            if i == 0:
                bias = b
        x = self.dec_norm(x)
        # tied output head with T5's 1/sqrt(dim) scaling
        x = x * (self.cfg.dim**-0.5)
        if return_hidden:
            return x
        return x @ self.shared_emb.weight.T

    def init_decoder_cache(self, *args, **kwargs):
        _unported("init_decoder_cache (generation)")

    def decode_step(self, *args, **kwargs):
        _unported("decode_step (generation)")
