"""The port's torch/HF state-dict interop against the JAX package's, on the
CPU.

Without ``transformers``: the port's five key maps equal the JAX package's
entry for entry, and each transform gives the same array on random
inputs; strictness, a shape mismatch and a partially present stacked
group raise; ``to_torch_state_dict`` -> ``from_torch_state_dict`` is
exact; loading into a module that is still deferred replays none of its
recorded initialization, and ``materialize_module`` afterwards makes only
what the map left out, bit for bit as an eager construction would;
``dtype=``, ``sharding_rule=`` and tied parameters.

With ``transformers`` (skipped without it): one HF model of each family
(GPT-2, Llama, Mixtral, T5, ViT) is built in the test from a local config
with random init (no download), and its state dict is loaded into the JAX
package's model and into the port's.  Their logits agree at atol = rtol =
1e-5 in f32 (the same math; sums in another order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.interop import torch_interop as jinterop
from torchdistx_tpu.nn import functional_call
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch import _graph
from torchdistx_tpu_torch.interop import (
    from_torch_state_dict,
    gpt2_key_map,
    llama_key_map,
    mixtral_key_map,
    t5_key_map,
    to_torch_state_dict,
    vit_key_map,
)
from torchdistx_tpu_torch.models import GPT2, Mixtral
from torchdistx_tpu_torch.parallel.mesh import Axis, NamedSharding, sharding_of

F32 = dict(atol=1e-5, rtol=1e-5)
MAPS = {
    "gpt2": (gpt2_key_map, jinterop.gpt2_key_map, (3,)),
    "llama": (llama_key_map, jinterop.llama_key_map, (2,)),
    "mixtral": (mixtral_key_map, jinterop.mixtral_key_map, (2, 4)),
    "t5": (t5_key_map, jinterop.t5_key_map, (2,)),
    "vit": (vit_key_map, jinterop.vit_key_map, (2,)),
}


@pytest.mark.parametrize("family", sorted(MAPS))
def test_key_maps_equal_jax_entry_for_entry(family):
    ours_fn, jax_fn, args = MAPS[family]
    ours, theirs = ours_fn(*args), jax_fn(*args)
    assert list(ours) == list(theirs)
    x = np.random.RandomState(0).randn(5, 7).astype(np.float32)
    for key, entry in ours.items():
        jentry = theirs[key]
        assert isinstance(entry, list) == isinstance(jentry, list), key
        pairs = zip(entry, jentry) if isinstance(entry, list) else [(entry, jentry)]
        for (name, fn), (jname, jfn) in pairs:
            assert name == jname, key
            assert (fn is None) == (jfn is None), key
            if fn is not None:
                np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), jfn(x))


def _gpt2(seed, **kw):
    tt.manual_seed(seed)
    return GPT2.from_name("tiny", device="cpu", **kw)


def test_round_trip_is_exact_and_exports_hf_layouts():
    src = _gpt2(0)
    kmap = gpt2_key_map(src.cfg.n_layers)
    exported = to_torch_state_dict(src, kmap)
    qkv = dict(src.named_parameters())["blocks.0.attn_qkv.weight"]
    # HF's Conv1D layout: our (out, in) exports as (in, out), contiguous, on the host
    out = exported["transformer.h.0.attn.c_attn.weight"]
    assert out.shape == qkv.shape[::-1] and out.is_contiguous() and out.device.type == "cpu"
    dst = _gpt2(99)
    from_torch_state_dict(dst, exported, kmap)
    for (k, a), (_, b) in zip(src.named_parameters(), dst.named_parameters()):
        assert torch.equal(a, b), k
    assert all(p.requires_grad for p in dst.parameters())


def test_stacked_round_trip_and_partial_group_raises_even_nonstrict():
    tt.manual_seed(3)
    src = Mixtral.from_name("tiny", device="cpu")
    kmap = mixtral_key_map(src.cfg.n_layers, src.cfg.n_experts)
    sd = to_torch_state_dict(src, kmap)
    w = dict(src.named_parameters())["blocks.0.mlp.w_gate"]
    # stacked (E, D, F) exports as per-expert HF (F, D) Linears
    assert sd["model.layers.0.block_sparse_moe.experts.0.w1.weight"].shape == w.shape[1:][::-1]
    tt.manual_seed(77)
    dst = Mixtral.from_name("tiny", device="cpu")
    from_torch_state_dict(dst, sd, kmap)
    for (k, a), (_, b) in zip(src.named_parameters(), dst.named_parameters()):
        assert torch.equal(a, b), k
    del sd["model.layers.0.block_sparse_moe.experts.1.w1.weight"]
    with pytest.raises(KeyError, match="partial group"):
        from_torch_state_dict(dst, sd, kmap, strict=False)


def test_strictness_and_shape_mismatch_raise():
    m = _gpt2(1)
    kmap = {"tok_emb.weight": ("transformer.wte.weight", None)}
    with pytest.raises(KeyError, match="missing"):
        from_torch_state_dict(m, {}, kmap)
    before = m.tok_emb.weight
    from_torch_state_dict(m, {}, kmap, strict=False)  # skipped
    assert m.tok_emb.weight is before
    with pytest.raises(ValueError, match="shape"):
        from_torch_state_dict(m, {"transformer.wte.weight": torch.zeros(257, 64)}, kmap)
    with pytest.raises(KeyError, match="not in module"):
        from_torch_state_dict(m, {}, {"no.such.weight": ("x", None)})
    with pytest.raises(ValueError, match="shape"):
        bad = to_torch_state_dict(m, gpt2_key_map(2))
        bad["transformer.h.1.attn.c_attn.weight"] = bad["transformer.h.1.attn.c_attn.weight"].T
        from_torch_state_dict(m, bad, gpt2_key_map(2))


def test_loading_into_a_deferred_module_replays_no_random_init(monkeypatch):
    sd = to_torch_state_dict(_gpt2(5), gpt2_key_map(2))
    replays = []
    real = _graph.RecordingSession.materialize_many

    def counting(self, targets, device):
        replays.append(len(targets))
        return real(self, targets, device)

    monkeypatch.setattr(_graph.RecordingSession, "materialize_many", counting)
    tt.manual_seed(6)
    full = tt.deferred_init(GPT2.from_name, "tiny", device="cpu")
    from_torch_state_dict(full, sd, gpt2_key_map(2))
    assert not tt.is_deferred(full) and replays == []
    tt.materialize_module(full)  # nothing left: a no-op
    assert replays == []
    for k, v in to_torch_state_dict(full, gpt2_key_map(2)).items():
        assert torch.equal(v, sd[k]), k

    # leave one tensor out: only it replays, as an eager build draws it
    partial = dict(sd)
    del partial["transformer.h.1.mlp.c_fc.weight"]
    tt.manual_seed(6)
    model = tt.deferred_init(GPT2.from_name, "tiny", device="cpu")
    from_torch_state_dict(model, partial, gpt2_key_map(2), strict=False)
    fakes = [k for k, p in model.named_parameters() if tt.is_fake(p)]
    assert fakes == ["blocks.1.mlp_up.weight"]
    tt.materialize_module(model)
    assert replays == [1]
    eager = _gpt2(6)
    assert torch.equal(model.blocks[1].mlp_up.weight, eager.blocks[1].mlp_up.weight)
    assert torch.equal(model.blocks[0].mlp_up.weight, sd["transformer.h.0.mlp.c_fc.weight"].T)


def test_dtype_ties_and_sharding_rule():
    sd = to_torch_state_dict(_gpt2(8), gpt2_key_map(2))
    m = _gpt2(9)
    from_torch_state_dict(m, sd, gpt2_key_map(2), dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    torch.testing.assert_close(m.ln_f.bias.float(), sd["transformer.ln_f.bias"],
                               atol=0, rtol=2 ** -8)

    # one Parameter at two paths stays one
    tied = torch.nn.Module()
    tied.a, tied.b = torch.nn.Linear(4, 3, bias=False), torch.nn.Linear(4, 3, bias=False)
    tied.b.weight = tied.a.weight
    w = torch.arange(12.0).reshape(3, 4)
    from_torch_state_dict(tied, {"w": w}, {"a.weight": ("w", None)})
    assert tied.a.weight is tied.b.weight and torch.equal(tied.b.weight, w)

    # rank 1 of a 2-way axis keeps the second half of dim 0
    mesh = types.SimpleNamespace(axes={"fsdp": Axis("fsdp", 2, 1, (0, 1), None)})
    rule = lambda name, t: NamedSharding(mesh, ("fsdp",)) if t.dim() == 2 else None  # noqa: E731
    s = _gpt2(10)
    from_torch_state_dict(s, sd, gpt2_key_map(2), sharding_rule=rule)
    emb = sd["transformer.wte.weight"]
    assert torch.equal(s.tok_emb.weight, emb[emb.shape[0] // 2:])
    assert isinstance(s.tok_emb.weight, torch.nn.Parameter)
    assert sharding_of(s.tok_emb.weight)[1] == tuple(emb.shape)
    assert sharding_of(s.ln_f.bias) is None


# -- HF models built in the test ------------------------------------------------


def _hf_cases():
    transformers = pytest.importorskip("transformers")
    from torchdistx_tpu.models import GPT2 as JGPT2, Llama as JLlama, Mixtral as JMixtral
    from torchdistx_tpu.models import T5 as JT5, ViT as JViT
    from torchdistx_tpu.models.gpt2 import GPT2Config as JGPT2Config
    from torchdistx_tpu.models.llama import LlamaConfig as JLlamaConfig
    from torchdistx_tpu.models.mixtral import MixtralConfig as JMixtralConfig
    from torchdistx_tpu.models.t5 import T5Config as JT5Config
    from torchdistx_tpu.models.vit import ViTConfig as JViTConfig
    from torchdistx_tpu_torch import models as tm

    llama = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
                 max_seq_len=32)
    toks = np.random.RandomState(1).randint(0, 128, (2, 16))
    return {
        "gpt2": (lambda: transformers.GPT2LMHeadModel(transformers.GPT2Config(
                     vocab_size=128, n_positions=32, n_embd=32, n_layer=2, n_head=4)),
                 dict(vocab_size=128, n_positions=32, dim=32, n_layers=2, n_heads=4),
                 JGPT2, JGPT2Config, tm.GPT2, tm.GPT2Config, gpt2_key_map(2), (toks,)),
        "llama": (lambda: transformers.LlamaForCausalLM(transformers.LlamaConfig(
                      vocab_size=128, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=32, tie_word_embeddings=False)),
                  dict(llama, norm_eps=1e-6), JLlama, JLlamaConfig, tm.Llama,
                  tm.LlamaConfig, llama_key_map(2), (toks,)),
        "mixtral": (lambda: transformers.MixtralForCausalLM(transformers.MixtralConfig(
                        vocab_size=128, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        num_local_experts=4, num_experts_per_tok=2,
                        max_position_embeddings=32, tie_word_embeddings=False)),
                    dict(llama, n_experts=4, top_k=2, norm_eps=1e-5), JMixtral,
                    JMixtralConfig, tm.Mixtral, tm.MixtralConfig, mixtral_key_map(2, 4),
                    (toks,)),
        "t5": (lambda: transformers.T5ForConditionalGeneration(transformers.T5Config(
                   vocab_size=128, d_model=32, d_ff=64, d_kv=8, num_heads=4, num_layers=2,
                   relative_attention_num_buckets=8, relative_attention_max_distance=16,
                   tie_word_embeddings=True)),
               dict(vocab_size=128, dim=32, d_ff=64, d_kv=8, n_heads=4, n_layers=2,
                    rel_pos_buckets=8, rel_pos_max_dist=16),
               JT5, JT5Config, tm.T5, tm.T5Config, t5_key_map(2), (toks[:, :12], toks[:, :6])),
        "vit": (lambda: transformers.ViTForImageClassification(transformers.ViTConfig(
                    image_size=32, patch_size=8, num_channels=3, hidden_size=32,
                    num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                    num_labels=10)),
                dict(image_size=32, patch_size=8, num_classes=10, dim=32, n_layers=2,
                     n_heads=4, mlp_dim=64, norm_eps=1e-12),
                JViT, JViTConfig, tm.ViT, tm.ViTConfig, vit_key_map(2),
                (np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32),)),
    }


@pytest.mark.parametrize("family", ["gpt2", "llama", "mixtral", "t5", "vit"])
def test_hf_state_dict_loads_into_jax_and_port_alike(family):
    build_hf, cfg, jcls, jcfg, tcls, tcfg, kmap, inputs = _hf_cases()[family]
    torch.manual_seed(0)
    sd = build_hf().eval().state_dict()
    with tdx.fake_mode():  # every parameter comes from the state dict
        jm = jcls(jcfg(**cfg, dtype=jnp.float32))
    jinterop.from_torch_state_dict(jm, sd, kmap)
    tm = tcls(tcfg(**cfg, dtype=torch.float32), device="cpu")
    from_torch_state_dict(tm, sd, kmap)
    params = dict(jm.named_parameters())
    jy = np.asarray(jax.jit(lambda p, *x: functional_call(jm, p, x))(
        params, *(jnp.asarray(x) for x in inputs)))
    with torch.no_grad():
        ty = tm(*(torch.from_numpy(x) for x in inputs))
    np.testing.assert_allclose(ty.numpy(), jy, **F32)
