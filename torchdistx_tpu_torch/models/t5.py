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
shards.  ``flash_bucket_bias`` with ``sp_axis`` raises.

Cached generation (``generation.generate_encdec``) runs unsharded:
``init_decoder_cache`` projects each decoder layer's encoder K/V once and
zeroes its causal self-attention cache; ``decode_step`` runs a token (or a
chunk) against both, with the first decoder layer's relative-position
bias sliced for the rows being decoded.  The cached self-attention with a
bias stays on the plain path, as JAX's stays on its jnp path; the
cross-attention is plain ``einsum`` and softmax over the projected K/V.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn as tnn

from .. import nn
from ..nn import functional as F
from ..ops.attention import _einsum_logits, _einsum_out, cached_attention, sp_attention
from ..ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    rel_bucket_ids,
    rel_bucket_matrix,
    rel_pos_bucket,
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

    def _split(self, t, b, s):
        return t.reshape(b, s, self.cfg.n_heads, self.cfg.d_kv)

    def forward_cached_self(self, x, cache, cache_pos, bias):
        """Causal self-attention against a (k, v) cache from host position
        ``cache_pos``, unscaled, with ``bias`` the (H, sq, max_seq) slice of
        the relative-position bias for the rows being decoded (computed
        once a step by the stack and shared by every layer).  Returns
        (out, cache)."""
        cfg = self.cfg
        b, sq, _ = x.shape
        q, k, v = (self._split(proj(x), b, sq) for proj in (self.q, self.k, self.v))
        out, cache = cached_attention(q, k, v, cache, cache_pos, scale=1.0,
                                      bias=bias, use_flash=cfg.use_flash)
        return self.o(out.reshape(b, sq, cfg.n_heads * cfg.d_kv)), cache

    def forward_cross_cached(self, x, ke, ve):
        """Cross-attention against the encoder K/V projected once up front
        (``T5.init_decoder_cache``): the JAX einsum branch's math."""
        cfg = self.cfg
        b, sq, _ = x.shape
        q = self._split(self.q(x), b, sq)
        probs = torch.softmax(_einsum_logits(q, ke, 1.0), dim=-1).to(x.dtype)
        out = _einsum_out(probs, ve, x.dtype)
        return self.o(out.reshape(b, sq, cfg.n_heads * cfg.d_kv))


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

    def decode_step(self, x, cache, cache_pos, bias):
        """Incremental decoder block: cached causal self-attention, then
        cross-attention over the projected encoder K/V.  ``cache`` is
        ``(k, v, ke, ve)``; returns (x, cache)."""
        ck, cv, ke, ve = cache
        a, (ck, cv) = self.self_attn.forward_cached_self(self.ln1(x), (ck, cv),
                                                         cache_pos, bias)
        x = x + a
        x = x + self.cross_attn.forward_cross_cached(self.ln_cross(x), ke, ve)
        return x + self.wo(F.relu(self.wi(self.ln2(x)))), (ck, cv, ke, ve)


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

    # -- incremental encoder-decoder decode (generation.generate_encdec) --

    def init_decoder_cache(self, enc, max_seq: int):
        """Per decoder layer ``(k, v, ke, ve)``: the causal self-attention
        cache, zeros of (B, max_seq, H, d_kv), and the encoder's K/V
        projected once, (B, S_enc, H, d_kv), which cross-attention reuses
        every step."""
        cfg = self.cfg
        b, s_enc, _ = enc.shape
        shape = (b, max_seq, cfg.n_heads, cfg.d_kv)
        caches = []
        for blk in self.dec_blocks:
            ke = blk.cross_attn.k(enc).reshape(b, s_enc, cfg.n_heads, cfg.d_kv)
            ve = blk.cross_attn.v(enc).reshape(b, s_enc, cfg.n_heads, cfg.d_kv)
            zeros = lambda: torch.zeros(shape, dtype=cfg.dtype, device=enc.device)  # noqa: E731
            caches.append((zeros(), zeros(), ke, ve))
        return caches

    def _decoder_bias_slice(self, sq: int, max_seq: int, cache_pos):
        """(H, sq, max_seq): the first decoder layer's relative-position
        bias for decode rows ``cache_pos + [0, sq)`` against every cache
        slot, the incremental slice of the stack's shared bias."""
        layer0 = self.dec_blocks[0].self_attn
        dev = layer0.rel_bias.weight.device
        ctx = (int(cache_pos) + torch.arange(sq, device=dev))[:, None]
        mem = torch.arange(max_seq, device=dev)[None, :]
        bucket = rel_pos_bucket(mem - ctx, bidirectional=False,
                                buckets=self.cfg.rel_pos_buckets,
                                max_dist=self.cfg.rel_pos_max_dist)
        return layer0.rel_bias(bucket).permute(2, 0, 1)

    def decode_step(self, dec_tokens, cache, cache_pos):
        """Run a decoder token (or chunk) against the cache from host
        position ``cache_pos`` (updated in place).  Returns (logits,
        cache)."""
        sq = dec_tokens.shape[1]
        max_seq = cache[0][0].shape[1]
        x = self.shared_emb(dec_tokens)
        bias = self._decoder_bias_slice(sq, max_seq, cache_pos)
        new_cache = []
        for blk, c in zip(self.dec_blocks, cache):
            x, c = blk.decode_step(x, c, cache_pos, bias)
            new_cache.append(c)
        x = self.dec_norm(x)
        return (x * (self.cfg.dim**-0.5)) @ self.shared_emb.weight.T, new_cache
