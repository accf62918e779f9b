"""``remat_policy="dots"`` in the port against the JAX package's
``dots_with_no_batch_dims_saveable``, on the CPU.

The policy's decisions are recorded on a tiny Llama: in the forward it
saves exactly the outputs of each block's seven projections (q, k, v, o,
gate, up, down; the recorded ``aten.mm`` calls give back, bit for bit, the
outputs the ``Linear`` modules return) and nothing of attention, plain or
through the flash ``autograd.Function``.  Gradients under ``dots``: the
port against the JAX model with the same weights (f32, atol = rtol =
1e-5), and against the port without remat (1e-6); Mixtral's
``forward_with_aux`` likewise against its own run without remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Mixtral as TMixtral
from torchdistx_tpu_torch.models import llama as tllama
from torchdistx_tpu_torch.nn import functional as tF

TOL = dict(atol=1e-5, rtol=1e-5)
PROJECTIONS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate", "mlp.w_up",
               "mlp.w_down")


def _tokens(seed, *shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.int32)


def _pair(**kw):
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", **kw)
    tm = tllama.Llama.from_name("tiny", device="cpu", **kw)
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _torch_grads(tm, toks, labels):
    tm.zero_grad(set_to_none=True)
    loss = tF.cross_entropy(tm(torch.from_numpy(toks).long()),
                            torch.from_numpy(labels).long())
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in tm.named_parameters()}


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_dots_saves_exactly_the_projections(monkeypatch, use_flash):
    _, tm = _pair(remat=True, remat_policy="dots", use_flash=use_flash)
    decisions = []
    policy = tllama._dots_policy

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, args, kwargs, out))
        return out

    monkeypatch.setattr(tllama, "_dots_policy", recording)
    outputs = {}
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: outputs.__setitem__(name, o.detach().clone()))
        for name, mod in tm.named_modules() if name.startswith("blocks.")
        and name.split(".", 2)[-1] in PROJECTIONS]
    try:
        _torch_grads(tm, _tokens(0, 2, 16), _tokens(1, 2, 16))
    finally:
        for h in hooks:
            h.remove()
    from torch.utils.checkpoint import CheckpointPolicy

    saved = [d for d in decisions if d[3] == CheckpointPolicy.MUST_SAVE]
    assert len(decisions) > len(saved) > 0
    assert len(saved) == len(PROJECTIONS) * tm.cfg.n_layers == len(outputs)
    assert {d[0] for d in saved} <= {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    left = dict(outputs)
    for op, args, kwargs, _ in saved:
        with torch.no_grad():
            val = op(*args, **kwargs)
        match = [n for n, o in left.items()
                 if o.reshape(-1, o.shape[-1]).shape == val.shape
                 and torch.equal(o.reshape(-1, o.shape[-1]), val)]
        assert len(match) == 1, (op, val.shape, match)
        del left[match[0]]
    assert not left
    recomputed = {d[0] for d in decisions if d[3] != CheckpointPolicy.MUST_SAVE}
    assert torch.ops.aten.bmm.default in recomputed  # the attention products


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_dots_gradients_match_jax(use_flash):
    jm, tm = _pair(remat=True, remat_policy="dots", use_flash=use_flash)
    toks, labels = _tokens(2, 2, 24), _tokens(3, 2, 24)
    params = dict(jm.named_parameters())

    def jloss(p):
        return jF.cross_entropy(functional_call(jm, p, (jnp.asarray(toks),)),
                                jnp.asarray(labels))

    jl, jg = jax.value_and_grad(jloss)(params)
    loss, grads = _torch_grads(tm, toks, labels)
    np.testing.assert_allclose(loss, float(jl), **TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]), err_msg=name, **TOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_dots_gradients_match_no_remat(use_flash):
    _, dots = _pair(remat=True, remat_policy="dots", use_flash=use_flash)
    _, plain = _pair(remat=False, use_flash=use_flash)
    toks, labels = _tokens(4, 2, 24), _tokens(5, 2, 24)
    loss_d, gd = _torch_grads(dots, toks, labels)
    loss_p, gp = _torch_grads(plain, toks, labels)
    assert abs(loss_d - loss_p) <= 1e-6
    for name in gd:
        torch.testing.assert_close(gd[name], gp[name], atol=1e-6, rtol=1e-6, msg=name)


def test_mixtral_dots_gradients_match_no_remat():
    toks = torch.from_numpy(_tokens(6, 2, 16)).long()
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = TMixtral.from_name("tiny", device="cpu", remat=remat, remat_policy="dots")
        torch.manual_seed(1)
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.randn_like(p) * 0.05)
        logits, aux = m.forward_with_aux(toks)
        (tF.cross_entropy(logits, toks) + 1e-2 * aux).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=1e-6, rtol=1e-6,
                                   msg=name)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        tllama._remat_policy("offload")
