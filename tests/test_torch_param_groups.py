"""The port's parameter groups against the JAX package's, on the CPU.

``decay_labels`` must give every parameter of tiny GPT-2 and tiny Llama the
label the JAX function gives it.  Then the same bf16 parameters and
gradients (numpy, from a seed) go through one step of the JAX
``with_param_groups(anyprecision_adamw, ...)`` (updates installed as
``p + updates``) and of the port's ``with_param_groups(AnyPrecisionAdamW,
...)``, both with Kahan summation and the decay / no_decay recipe: they
must agree within one bf16 ulp (XLA may fuse the f32 update arithmetic
into other roundings than PyTorch's eager ops), as in
``test_torch_optim.py``.  The ulp is that of the larger of the value and
the learning rate: GPT-2's zero biases and small weights move by steps of
about lr, and near zero both sides round a sum that has cancelled below
the step's own precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import GPT2 as JGPT2
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.optimizers import decay_labels as jdecay_labels
from torchdistx_tpu.optimizers import with_param_groups as jwith_param_groups
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.models import GPT2, Llama
from torchdistx_tpu_torch.optimizers import (
    AnyPrecisionAdamW,
    decay_labels,
    label_tree,
    with_param_groups,
)

GROUPS = {"decay": {"weight_decay": 0.01}, "no_decay": {"weight_decay": 0.0}}
STEPS = 1


def _jax_params(cls, dtype=jnp.float32):
    tdx.manual_seed(0)
    return dict(cls.from_name("tiny", dtype=dtype).named_parameters())


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_decay_labels_match_jax(family):
    jcls, tcls = (JGPT2, GPT2) if family == "gpt2" else (JLlama, Llama)
    want = jdecay_labels(_jax_params(jcls))
    tt.manual_seed(0)
    got = decay_labels(tcls.from_name("tiny", device="cpu"))
    assert got == dict(want)
    assert set(got.values()) == {"decay", "no_decay"}


def test_label_tree_sees_lowercased_names():
    p = {"Blocks.0.LN_1.Weight": torch.zeros(3, 3)}
    assert label_tree(p, lambda name, t: name) == {"Blocks.0.LN_1.Weight": "blocks.0.ln_1.weight"}
    assert decay_labels(p) == {"Blocks.0.LN_1.Weight": "no_decay"}


def test_bad_labels_raise():
    tt.manual_seed(0)
    m = GPT2.from_name("tiny", device="cpu")
    with pytest.raises(ValueError, match="undefined groups"):
        with_param_groups(AnyPrecisionAdamW, {"decay": {}}, decay_labels, m)
    with pytest.raises(ValueError, match="no label"):
        with_param_groups(AnyPrecisionAdamW, GROUPS, {"tok_emb.weight": "decay"}, m)


def _assert_within_one_ulp(out, ref, floor, name):
    a, b = out.float(), torch.as_tensor(np.asarray(ref, np.float32))
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # bf16: 8 significant bits
    worst = float(((a - b).abs() / ulp).max())
    assert worst <= 1.0, f"{name}: {worst} bf16 ulps apart"


def test_grouped_kahan_steps_match_jax_within_one_bf16_ulp():
    params = _jax_params(JGPT2, jnp.bfloat16)
    rs = np.random.RandomState(0)
    grads = [{k: (0.1 * rs.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(STEPS)]

    tx = jwith_param_groups(anyprecision_adamw, GROUPS, jdecay_labels,
                            learning_rate=3e-3, use_kahan_summation=True)
    state = tx.init(params)
    jp = params

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return jax.tree_util.tree_map(lambda a, d: a + d, p, u), s

    for g in grads:
        jp, state = step(jp, state, {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()})

    tp = {k: torch.nn.Parameter(torch.from_numpy(np.asarray(v, np.float32)).bfloat16())
          for k, v in params.items()}
    opt = with_param_groups(AnyPrecisionAdamW, GROUPS, decay_labels, tp, lr=3e-3,
                            use_kahan_summation=True)
    assert [g["name"] for g in opt.param_groups] == ["decay", "no_decay"]
    assert [g["weight_decay"] for g in opt.param_groups] == [0.01, 0.0]
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k]).bfloat16()
        opt.step()
    for k, p in tp.items():
        _assert_within_one_ulp(p.detach(), jp[k], 3e-3, k)
        assert "compensation" in opt.state[p]
