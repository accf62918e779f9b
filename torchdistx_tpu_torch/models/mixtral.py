"""Mixtral-family sparse-MoE decoder, counterpart of
``torchdistx_tpu/models/mixtral.py``.

A Llama decoder whose FFN is a top-k-routed mixture of SwiGLU experts
(Jiang et al., arXiv:2401.04088): :class:`MixtralBlock` puts an
``nn.MoE`` into :class:`LlamaBlock`'s FFN slot, so the attention (flash on
the card), the KV-cache paths, serving and deferred init are Llama's.
``forward_with_aux`` also returns the router load-balancing loss of the
same routing pass, to be added with a small weight to the training loss.
Expert parallelism (``shard_rule``) waits for the port's parallel stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from ..nn.moe import MoE
from .llama import Llama, LlamaBlock, LlamaConfig

__all__ = ["MixtralConfig", "MixtralBlock", "Mixtral", "mixtral_configs"]


@dataclasses.dataclass
class MixtralConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # None = dense compute (every expert, masked combine); a float enables
    # GShard capacity dispatch (see nn.moe)
    capacity_factor: Optional[float] = None
    moe_dispatch: str = "einsum"  # or "gather"


# the JAX package's table, with torch dtypes
mixtral_configs = {
    "tiny": dict(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, max_seq_len=128,
        n_experts=4, top_k=2, dtype=torch.float32,
    ),
    # 8x7B (the paper's table 1); ffn_dim is per expert
    "mixtral_8x7b": dict(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14336, max_seq_len=4096, n_experts=8, top_k=2,
    ),
}


class MixtralBlock(LlamaBlock):
    """LlamaBlock with a routed MoE in the FFN slot."""

    def __init__(self, cfg: MixtralConfig, device="cuda"):
        super().__init__(cfg, device, mlp=MoE(
            cfg.dim, cfg.ffn_dim, cfg.n_experts, top_k=cfg.top_k, dtype=cfg.dtype,
            capacity_factor=cfg.capacity_factor, dispatch_mode=cfg.moe_dispatch,
            device=device))

    def forward(self, x, rope, return_aux: bool = False):
        x = x + self.attn(self.attn_norm(x), rope)
        if return_aux:
            y, aux = self.mlp(self.mlp_norm(x), return_aux=True)
            return x + y, aux
        return x + self.mlp(self.mlp_norm(x))


class Mixtral(Llama):
    """``forward``, ``forward_cached``, ``forward_decode`` and ``init_cache``
    are Llama's over MoE blocks; ``forward_with_aux`` is Mixtral's own."""

    block_cls = MixtralBlock
    configs = mixtral_configs
    config_cls = MixtralConfig

    def forward_with_aux(self, tokens):
        """(logits, aux): ``aux`` is the mean over layers of the Switch
        load-balancing loss, from the same routing pass as the forward."""
        cfg = self.cfg
        if cfg.remat and cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r} is not ported yet")
        rope = self.rope_table()
        x = self.tok_emb(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    blk, x, rope, True, use_reentrant=False)
            else:
                x, aux = blk(x, rope, return_aux=True)
            aux_total = aux_total + aux
        return self.lm_head(self.norm(x)), aux_total / len(self.blocks)

    def shard_rule(self, mesh, ep_axis: str = "ep", base_rule=None):
        """Expert-parallel sharding rule of the JAX package: it waits for the
        port's parallel stack."""
        raise NotImplementedError(
            "Mixtral.shard_rule (expert parallelism) waits for the port's "
            "parallel stack")
