"""The port's AnyPrecisionAdamW against the JAX package's, on the CPU.

The same numpy parameters and per-step gradients (from a seed) go through
the JAX ``AnyPrecisionAdamW`` (``anyprecision_adamw`` under ``jax.jit``,
updates installed as ``p + updates``) and the port's ``torch.optim``
optimizer for 5 steps.  bf16 parameters must agree to within one bf16 ulp
(XLA may fuse the f32 update arithmetic into other roundings than
PyTorch's eager ops; most elements are bit-equal); f32 state to rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.optimizers import AnyPrecisionAdamW as JAdamW
from torchdistx_tpu_torch.optimizers import AnyPrecisionAdamW

STEPS = 5
SHAPES = {"w": (16, 24), "b": (24,)}


def _arrays(seed):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (0.1 * rs.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _bf16_bits(x):
    return torch.as_tensor(np.asarray(x, np.float32)).bfloat16().view(torch.int16).int()


def _assert_within_one_ulp(out: torch.Tensor, ref, name):
    a, b = out.view(torch.int16).int(), _bf16_bits(ref)
    diff = (a - b).abs()
    assert int(diff.max()) <= 1, f"{name}: {int(diff.max())} bf16 ulps apart"


def _run(groups_np, grads_np, dtype, jkw, tkw):
    """groups_np: list of (param-name list, group overrides)."""
    params_np = groups_np[0]
    names = list(SHAPES)
    jgroups, tgroups, tparams = [], [], {}
    for keys, over in groups_np[1]:
        jgroups.append({"params": {k: jnp.asarray(params_np[k], jnp.dtype(dtype))
                                   for k in keys}, **over})
        ps = []
        for k in keys:
            tparams[k] = torch.nn.Parameter(torch.from_numpy(params_np[k].copy()).to(
                getattr(torch, dtype)))
            ps.append(tparams[k])
        tover = dict(over)
        tgroups.append({"params": ps, **tover})
    jopt = JAdamW(jgroups, lr=1e-3, **jkw)
    jp = [g["params"] for g in jgroups]
    topt = AnyPrecisionAdamW(tgroups, lr=1e-3, **tkw)
    for g in grads_np:
        jg = [{k: jnp.asarray(g[k], jnp.dtype(dtype)) for k in grp}
              for grp in jp]
        jp = jopt.step(jp, jg)
        for k in names:
            tparams[k].grad = torch.from_numpy(g[k].copy()).to(tparams[k].dtype)
        topt.step()
    jflat = {k: v for grp in jp for k, v in grp.items()}
    return tparams, jflat, topt


@pytest.mark.parametrize("kahan", [False, True], ids=["defaults", "kahan"])
def test_bf16_params_match_jax(kahan):
    params, grads = _arrays(0)
    kw = dict(use_kahan_summation=kahan)
    tparams, jparams, topt = _run((params, [(list(SHAPES), {})]), grads,
                                  "bfloat16", kw, kw)
    for k in SHAPES:
        _assert_within_one_ulp(tparams[k].detach(), np.asarray(jparams[k], np.float32), k)
        state = topt.state[tparams[k]]
        assert state["exp_avg"].dtype == torch.float32
        assert state["exp_avg_sq"].dtype == torch.bfloat16
        assert ("compensation" in state) == kahan


def test_weight_decay_and_two_param_groups_match_jax():
    params, grads = _arrays(1)
    groups = [(["w"], {"weight_decay": 0.1}),
              (["b"], {"lr": 5e-3, "betas": (0.8, 0.99), "eps": 1e-6})]
    tparams, jparams, _ = _run((params, groups), grads, "bfloat16", {}, {})
    for k in SHAPES:
        _assert_within_one_ulp(tparams[k].detach(), np.asarray(jparams[k], np.float32), k)


def test_f32_params_and_state_match_jax():
    """All-f32 (the plain AdamW limit): parameters to rtol 1e-6."""
    params, grads = _arrays(2)
    kw = dict(variance_dtype=jnp.float32)
    tparams, jparams, _ = _run((params, [(list(SHAPES), {"weight_decay": 0.01})]),
                               grads, "float32", kw,
                               dict(variance_dtype=torch.float32))
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)


def test_update_rounds_twice_like_the_jax_step():
    """One bf16 step: the f32 delta is rounded to bf16, then added in bf16
    (``p + round(delta)``), not ``p.add_(delta_f32)``."""
    rs = np.random.RandomState(3)
    p0 = rs.randn(4096).astype(np.float32)
    g = rs.randn(4096).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0).bfloat16())
    ref = p.detach().clone()
    opt = AnyPrecisionAdamW([p], lr=3e-3)
    p.grad = torch.from_numpy(g).bfloat16()
    opt.step()
    m = torch.from_numpy(g).bfloat16().float() * (1 - 0.9)
    v = (torch.from_numpy(g).bfloat16().float() ** 2 * (1 - 0.999)).bfloat16().float()
    bc1 = 1 - torch.tensor(0.9) ** 1
    bc2 = 1 - torch.tensor(0.999) ** 1
    delta = -(3e-3 / bc1) * (m / (torch.sqrt(v) / torch.sqrt(bc2) + 1e-8))
    expect = ref + delta.bfloat16()
    assert torch.equal(p.detach(), expect)
