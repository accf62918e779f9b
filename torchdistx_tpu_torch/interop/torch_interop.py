"""torch / HuggingFace interop: load pretrained state dicts into the port's
models, counterpart of ``torchdistx_tpu/interop/torch_interop.py``.

A user of torchdistx's deferred init builds a model with ``deferred_init``
and then loads weights into it.  ``from_torch_state_dict`` streams the
state dict's tensors one at a time, torch to torch, straight onto each
target's device (a fake's claimed device, or a real tensor's own): one
``copy_`` per tensor, bf16 included, so the host holds one source tensor
at a time beside the state dict.  A target that is still deferred (fake)
is replaced by the loaded tensor and its recorded initialization is never
replayed; ``materialize_module`` afterwards makes only the tensors the
map left out.

Every loaded tensor is a new tensor (a new ``nn.Parameter`` for a
parameter, with the old one's ``requires_grad``) at every path that held
the old one, so tied tensors stay tied: build the optimizer after loading,
as after ``materialize_module``.

Key maps are provided for the five HF families the port ships (GPT-2,
Llama, Mixtral, T5, ViT), the JAX package's maps entry for entry.  Each
entry is ``ours -> (theirs, transform)``, or ``ours -> [(theirs,
transform), ...]`` when one of our tensors stacks several torch tensors
along a new leading axis (Mixtral's per-expert ``experts.{e}.w1/w2/w3``
become our stacked ``(E, ...)`` MoE weights).  The transforms are
transposes (HF's Conv1D stores (in, out)) or None, and work on torch
tensors and numpy arrays alike.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from ..fake import is_fake

__all__ = [
    "from_torch_state_dict",
    "to_torch_state_dict",
    "gpt2_key_map",
    "llama_key_map",
    "mixtral_key_map",
    "t5_key_map",
    "vit_key_map",
]

Transform = Optional[Callable[[Any], Any]]
KeyEntry = Union[tuple[str, Transform], list[tuple[str, Transform]]]
KeyMap = dict[str, KeyEntry]

_T = lambda a: a.T  # noqa: E731  (HF Conv1D stores (in, out))


def _holders(module: torch.nn.Module) -> dict:
    """``{name: (tensor, is_param, refs)}`` for every parameter and buffer
    path; ``refs``, the ``(store, key)`` pairs holding the tensor, is one
    list shared by all the paths of a tied tensor."""
    refs_of: dict = {}
    out = {}
    for prefix, mod in module.named_modules(remove_duplicate=False):
        for store, is_param in ((mod._parameters, True), (mod._buffers, False)):
            for key, t in store.items():
                if t is None:
                    continue
                refs = refs_of.setdefault(id(t), [])
                refs.append((store, key))
                out[f"{prefix}.{key}" if prefix else key] = (t, is_param, refs)
    return out


def _source(state_dict, name, transform):
    t = torch.as_tensor(state_dict[name])
    return transform(t) if transform is not None else t


def from_torch_state_dict(
    module: torch.nn.Module,
    state_dict: dict[str, Any],
    key_map: KeyMap,
    *,
    sharding_rule: Optional[Callable[[str, Any], Any]] = None,
    dtype: Optional[torch.dtype] = None,
    strict: bool = True,
) -> torch.nn.Module:
    """Load a torch state dict into ``module`` in place.

    Args:
      key_map: ``{our_name: (torch_name, transform|None)}``; an entry may
        instead be a LIST ``[(torch_name, transform), ...]`` whose tensors
        stack along a new leading axis into one of our tensors, filled
        slice by slice on the target's device.
      sharding_rule: ``rule(our_name, current_tensor) -> NamedSharding``
        (or None), as ``materialize_module`` takes it: each rank keeps its
        piece of the loaded tensor (``parallel.mesh.shard_tensor``).
      dtype: the dtype of every loaded tensor (default: the target's).
      strict: raise if a mapped torch key is missing; without it a missing
        tensor is skipped, but a stacked group with only some of its keys
        present still raises.
    """
    own = _holders(module)
    missing = [k for k in key_map if k not in own]
    if missing:
        raise KeyError(f"key_map targets not in module: {missing[:5]}")
    with torch.no_grad():
        for ours, entry in key_map.items():
            _load_entry(ours, entry, own[ours], state_dict, sharding_rule, dtype, strict)
    return module


def _load_entry(ours, entry, held, state_dict, sharding_rule, dtype, strict) -> None:
    """Load one key-map entry into the tensor ``held`` describes."""
    from ..deferred_init import _resolve_claim
    from ..parallel.mesh import mark_sharded, shard_tensor

    stacked = isinstance(entry, list)
    sources = entry if stacked else [entry]
    absent = [t for t, _ in sources if t not in state_dict]
    if absent:
        if strict:
            raise KeyError(f"torch state dict is missing {absent[0]!r}")
        if len(absent) < len(sources):
            # a PARTIALLY present stacked group is a broken checkpoint, not
            # an intentionally omitted tensor: skipping it would leave every
            # expert at its random init
            raise KeyError(
                f"{ours}: stacked group has {len(absent)} of {len(sources)} "
                f"source keys missing (e.g. {absent[0]!r}); refusing to skip "
                "a partial group"
            )
        return
    expected, is_param, refs = held
    device = _resolve_claim(expected) if is_fake(expected) else expected.device
    value = torch.empty(expected.shape, dtype=dtype or expected.dtype, device=device)
    for j, (theirs, transform) in enumerate(sources):
        src = _source(state_dict, theirs, transform)
        got = (len(sources), *src.shape) if stacked else tuple(src.shape)
        if got != tuple(expected.shape):
            desc = f"{len(sources)} stacked keys [{theirs}, ...]" if stacked else theirs
            raise ValueError(f"{ours}: shape {got} from {desc} does not match "
                             f"module shape {tuple(expected.shape)}")
        (value[j] if stacked else value).copy_(src)
        del src
    sharding = sharding_rule(ours, expected) if sharding_rule is not None else None
    if sharding is not None:
        value = shard_tensor(value, sharding)
    if is_param:
        value = torch.nn.Parameter(value, requires_grad=expected.requires_grad)
        if sharding is not None:
            mark_sharded(value, sharding, expected.shape)
    for store, key in refs:
        store[key] = value


def to_torch_state_dict(module: torch.nn.Module, key_map: KeyMap) -> dict[str, torch.Tensor]:
    """Export ``module``'s weights under the torch/HF naming, the inverse of
    :func:`from_torch_state_dict` with the same key maps (their transforms
    are transposes or None, each its own inverse).  Each tensor is copied
    to the host, contiguous, one at a time; a stacked entry is unstacked
    along its leading axis.  Fake and sharded tensors raise."""
    from ..parallel.mesh import sharding_of

    own = _holders(module)
    missing = [k for k in key_map if k not in own]
    if missing:
        raise KeyError(f"key_map sources not in module: {missing[:5]}")
    out: dict[str, torch.Tensor] = {}

    def emit(theirs, t, transform):
        t = transform(t) if transform is not None else t
        out[theirs] = t.to("cpu", memory_format=torch.contiguous_format, copy=True)

    for ours, entry in key_map.items():
        t = own[ours][0]
        if is_fake(t):
            raise ValueError(f"{ours} is not materialized")
        if sharding_of(t) is not None:
            raise NotImplementedError(f"{ours} is sharded: gather it before exporting")
        t = t.detach()
        if isinstance(entry, list):
            if t.shape[0] != len(entry):
                raise ValueError(f"{ours}: leading dim {t.shape[0]} != "
                                 f"{len(entry)} mapped keys")
            for slice_, (theirs, transform) in zip(t, entry):
                emit(theirs, slice_, transform)
        else:
            theirs, transform = entry
            emit(theirs, t, transform)
    return out


def gpt2_key_map(n_layers: int) -> KeyMap:
    """HF ``GPT2LMHeadModel`` (``transformer.*``) -> our :class:`GPT2`.

    HF's Conv1D stores weights (in, out); our Linear stores (out, in),
    hence the transposes.
    """
    m: KeyMap = {
        "tok_emb.weight": ("transformer.wte.weight", None),
        "pos_emb.weight": ("transformer.wpe.weight", None),
        "ln_f.weight": ("transformer.ln_f.weight", None),
        "ln_f.bias": ("transformer.ln_f.bias", None),
    }
    for i in range(n_layers):
        h, b = f"transformer.h.{i}", f"blocks.{i}"
        m.update(
            {
                f"{b}.ln1.weight": (f"{h}.ln_1.weight", None),
                f"{b}.ln1.bias": (f"{h}.ln_1.bias", None),
                f"{b}.attn_qkv.weight": (f"{h}.attn.c_attn.weight", _T),
                f"{b}.attn_qkv.bias": (f"{h}.attn.c_attn.bias", None),
                f"{b}.attn_out.weight": (f"{h}.attn.c_proj.weight", _T),
                f"{b}.attn_out.bias": (f"{h}.attn.c_proj.bias", None),
                f"{b}.ln2.weight": (f"{h}.ln_2.weight", None),
                f"{b}.ln2.bias": (f"{h}.ln_2.bias", None),
                f"{b}.mlp_up.weight": (f"{h}.mlp.c_fc.weight", _T),
                f"{b}.mlp_up.bias": (f"{h}.mlp.c_fc.bias", None),
                f"{b}.mlp_down.weight": (f"{h}.mlp.c_proj.weight", _T),
                f"{b}.mlp_down.bias": (f"{h}.mlp.c_proj.bias", None),
            }
        )
    return m


def llama_key_map(n_layers: int) -> KeyMap:
    """HF ``LlamaForCausalLM`` (``model.*``) -> our :class:`Llama`.

    Both sides store Linear weights (out, in); the RoPE conventions also
    match (rotate-half), so the map is 1:1 renames.
    """
    m: KeyMap = {
        "tok_emb.weight": ("model.embed_tokens.weight", None),
        "norm.weight": ("model.norm.weight", None),
        "lm_head.weight": ("lm_head.weight", None),
    }
    for i in range(n_layers):
        h, b = f"model.layers.{i}", f"blocks.{i}"
        m.update(
            {
                f"{b}.attn_norm.weight": (f"{h}.input_layernorm.weight", None),
                f"{b}.attn.wq.weight": (f"{h}.self_attn.q_proj.weight", None),
                f"{b}.attn.wk.weight": (f"{h}.self_attn.k_proj.weight", None),
                f"{b}.attn.wv.weight": (f"{h}.self_attn.v_proj.weight", None),
                f"{b}.attn.wo.weight": (f"{h}.self_attn.o_proj.weight", None),
                f"{b}.mlp_norm.weight": (
                    f"{h}.post_attention_layernorm.weight",
                    None,
                ),
                f"{b}.mlp.w_gate.weight": (f"{h}.mlp.gate_proj.weight", None),
                f"{b}.mlp.w_up.weight": (f"{h}.mlp.up_proj.weight", None),
                f"{b}.mlp.w_down.weight": (f"{h}.mlp.down_proj.weight", None),
            }
        )
    return m


def mixtral_key_map(n_layers: int, n_experts: int) -> KeyMap:
    """HF ``MixtralForCausalLM`` (``model.*``) -> our :class:`Mixtral`.

    Attention/norm naming follows Llama.  HF stores each expert's SwiGLU
    as separate ``experts.{e}.w1/w3/w2`` Linears with (out, in) weights;
    ours stack them as (E, D, F) / (E, F, D) einsum operands: each
    expert transposes and the loader stacks along the new leading axis.
    Routing math matches: HF's softmax-over-top-k logits equals our
    renormalized top-k of the full softmax.
    """
    m: KeyMap = {
        "tok_emb.weight": ("model.embed_tokens.weight", None),
        "norm.weight": ("model.norm.weight", None),
        "lm_head.weight": ("lm_head.weight", None),
    }
    for i in range(n_layers):
        h, b = f"model.layers.{i}", f"blocks.{i}"
        moe = f"{h}.block_sparse_moe"
        m.update(
            {
                f"{b}.attn_norm.weight": (f"{h}.input_layernorm.weight", None),
                f"{b}.attn.wq.weight": (f"{h}.self_attn.q_proj.weight", None),
                f"{b}.attn.wk.weight": (f"{h}.self_attn.k_proj.weight", None),
                f"{b}.attn.wv.weight": (f"{h}.self_attn.v_proj.weight", None),
                f"{b}.attn.wo.weight": (f"{h}.self_attn.o_proj.weight", None),
                f"{b}.mlp_norm.weight": (
                    f"{h}.post_attention_layernorm.weight",
                    None,
                ),
                f"{b}.mlp.router.weight": (f"{moe}.gate.weight", None),
                f"{b}.mlp.w_gate": [
                    (f"{moe}.experts.{e}.w1.weight", _T)
                    for e in range(n_experts)
                ],
                f"{b}.mlp.w_up": [
                    (f"{moe}.experts.{e}.w3.weight", _T)
                    for e in range(n_experts)
                ],
                f"{b}.mlp.w_down": [
                    (f"{moe}.experts.{e}.w2.weight", _T)
                    for e in range(n_experts)
                ],
            }
        )
    return m


def t5_key_map(n_layers: int) -> KeyMap:
    """HF ``T5Model``/``T5ForConditionalGeneration`` -> our :class:`T5`."""
    m: KeyMap = {
        "shared_emb.weight": ("shared.weight", None),
        "enc_norm.weight": ("encoder.final_layer_norm.weight", None),
        "dec_norm.weight": ("decoder.final_layer_norm.weight", None),
    }
    for i in range(n_layers):
        e, b = f"encoder.block.{i}", f"enc_blocks.{i}"
        m.update(
            {
                f"{b}.ln1.weight": (f"{e}.layer.0.layer_norm.weight", None),
                f"{b}.self_attn.q.weight": (f"{e}.layer.0.SelfAttention.q.weight", None),
                f"{b}.self_attn.k.weight": (f"{e}.layer.0.SelfAttention.k.weight", None),
                f"{b}.self_attn.v.weight": (f"{e}.layer.0.SelfAttention.v.weight", None),
                f"{b}.self_attn.o.weight": (f"{e}.layer.0.SelfAttention.o.weight", None),
                f"{b}.ln2.weight": (f"{e}.layer.1.layer_norm.weight", None),
                f"{b}.wi.weight": (f"{e}.layer.1.DenseReluDense.wi.weight", None),
                f"{b}.wo.weight": (f"{e}.layer.1.DenseReluDense.wo.weight", None),
            }
        )
        d, c = f"decoder.block.{i}", f"dec_blocks.{i}"
        m.update(
            {
                f"{c}.ln1.weight": (f"{d}.layer.0.layer_norm.weight", None),
                f"{c}.self_attn.q.weight": (f"{d}.layer.0.SelfAttention.q.weight", None),
                f"{c}.self_attn.k.weight": (f"{d}.layer.0.SelfAttention.k.weight", None),
                f"{c}.self_attn.v.weight": (f"{d}.layer.0.SelfAttention.v.weight", None),
                f"{c}.self_attn.o.weight": (f"{d}.layer.0.SelfAttention.o.weight", None),
                f"{c}.ln_cross.weight": (f"{d}.layer.1.layer_norm.weight", None),
                f"{c}.cross_attn.q.weight": (f"{d}.layer.1.EncDecAttention.q.weight", None),
                f"{c}.cross_attn.k.weight": (f"{d}.layer.1.EncDecAttention.k.weight", None),
                f"{c}.cross_attn.v.weight": (f"{d}.layer.1.EncDecAttention.v.weight", None),
                f"{c}.cross_attn.o.weight": (f"{d}.layer.1.EncDecAttention.o.weight", None),
                f"{c}.ln2.weight": (f"{d}.layer.2.layer_norm.weight", None),
                f"{c}.wi.weight": (f"{d}.layer.2.DenseReluDense.wi.weight", None),
                f"{c}.wo.weight": (f"{d}.layer.2.DenseReluDense.wo.weight", None),
            }
        )
    m["enc_blocks.0.self_attn.rel_bias.weight"] = (
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
        None,
    )
    m["dec_blocks.0.self_attn.rel_bias.weight"] = (
        "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
        None,
    )
    return m


def vit_key_map(n_layers: int) -> KeyMap:
    """HF ``ViTForImageClassification`` (``vit.*``) -> our :class:`ViT`.

    Layouts coincide (torch Linear (out, in) == ours; Conv2d
    (out, in, kh, kw) == ours), so no transforms are needed."""
    m: KeyMap = {
        "cls_token": ("vit.embeddings.cls_token", None),
        "pos_emb": ("vit.embeddings.position_embeddings", None),
        "patch_embed.weight": (
            "vit.embeddings.patch_embeddings.projection.weight", None
        ),
        "patch_embed.bias": (
            "vit.embeddings.patch_embeddings.projection.bias", None
        ),
        "ln_f.weight": ("vit.layernorm.weight", None),
        "ln_f.bias": ("vit.layernorm.bias", None),
        "head.weight": ("classifier.weight", None),
        "head.bias": ("classifier.bias", None),
    }
    for i in range(n_layers):
        h, b = f"vit.encoder.layer.{i}", f"blocks.{i}"
        att = f"{h}.attention.attention"
        m.update(
            {
                f"{b}.ln1.weight": (f"{h}.layernorm_before.weight", None),
                f"{b}.ln1.bias": (f"{h}.layernorm_before.bias", None),
                f"{b}.q.weight": (f"{att}.query.weight", None),
                f"{b}.q.bias": (f"{att}.query.bias", None),
                f"{b}.k.weight": (f"{att}.key.weight", None),
                f"{b}.k.bias": (f"{att}.key.bias", None),
                f"{b}.v.weight": (f"{att}.value.weight", None),
                f"{b}.v.bias": (f"{att}.value.bias", None),
                f"{b}.proj.weight": (
                    f"{h}.attention.output.dense.weight", None
                ),
                f"{b}.proj.bias": (f"{h}.attention.output.dense.bias", None),
                f"{b}.ln2.weight": (f"{h}.layernorm_after.weight", None),
                f"{b}.ln2.bias": (f"{h}.layernorm_after.bias", None),
                f"{b}.fc1.weight": (f"{h}.intermediate.dense.weight", None),
                f"{b}.fc1.bias": (f"{h}.intermediate.dense.bias", None),
                f"{b}.fc2.weight": (f"{h}.output.dense.weight", None),
                f"{b}.fc2.bias": (f"{h}.output.dense.bias", None),
            }
        )
    return m
