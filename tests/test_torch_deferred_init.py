"""The port's fake tensors and deferred init, on the CPU.

Counterparts of the applicable cases of ``tests/test_deferred_init.py``.
The port's init RNG gives other bits than ``jax.random``, so each case
holds the port against its own eager construction from the same
``manual_seed`` (bit-identical); the two packages meet on shared weights in
``tests/test_torch_train.py``.
"""

import pytest
import torch

import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch import nn
from torchdistx_tpu_torch.fake import FakeTensor, meta_like
from torchdistx_tpu_torch.models import Llama


class MLP(torch.nn.Module):
    def __init__(self, din=16, dh=32, dout=8):
        super().__init__()
        self.fc1 = nn.Linear(din, dh, device="cpu")
        self.fc2 = nn.Linear(dh, dout, device="cpu")
        self.norm = nn.RMSNorm(dh, device="cpu")

    def forward(self, x):
        return self.fc2(self.norm(torch.relu(self.fc1(x))))


def _params(m):
    return dict(m.named_parameters())


def test_materialize_noop_on_real():
    x = torch.ones(3, 3)
    assert tt.materialize_tensor(x) is x


def test_deferred_module_has_fake_params():
    m = tt.deferred_init(MLP)
    assert tt.is_deferred(m)
    for p in m.parameters():
        assert tt.is_fake(p) and tt.can_materialize(p)
        assert isinstance(p, torch.nn.Parameter)
        assert p.device == torch.device("cpu")
    assert meta_like(m.fc1.weight).device.type == "meta"


def test_fake_mode_allocates_nothing_and_cannot_materialize():
    with tt.fake_mode():
        big = torch.empty(1 << 20, 1 << 20)  # 4 TiB if it were real
        y = big.sum(0)
    assert tt.is_fake(big) and tuple(y.shape) == (1 << 20,)
    assert not tt.can_materialize(big)
    with pytest.raises(RuntimeError, match="outside"):
        tt.materialize_tensor(big)
    with pytest.raises(RuntimeError, match="no storage"):
        float(y[0])


@pytest.mark.parametrize("build", [MLP, lambda: Llama.from_name("tiny", device="cpu")],
                         ids=["mlp", "llama_tiny"])
def test_materialize_matches_eager_init(build):
    tt.manual_seed(42)
    m = tt.deferred_init(build)
    tt.materialize_module(m)
    tt.manual_seed(42)
    eager = build()
    assert list(_params(m)) == list(_params(eager))
    for (k, a), b in zip(_params(m).items(), eager.parameters()):
        assert type(a) is torch.nn.Parameter and a.requires_grad, k
        assert torch.equal(a, b), k
    assert not tt.is_deferred(m)


def test_identity_same_fake_same_tensor():
    m = tt.deferred_init(nn.Linear, 4, 4, device="cpu")
    w = m._parameters["weight"]
    assert tt.materialize_tensor(w) is tt.materialize_tensor(w)


def test_shared_parameter_aliasing():
    class Tied(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(10, 6, device="cpu",
                                    weight_init=lambda s, d, dev: nn.init.normal(s, dtype=d, device=dev))
            self.head = torch.nn.Module()
            self.head.weight = self.emb.weight

    t = tt.deferred_init(Tied)
    assert t.head.weight is t.emb.weight
    tt.materialize_module(t)
    assert t.head._parameters["weight"] is t.emb._parameters["weight"]
    assert not tt.is_fake(t.emb.weight)


def test_is_deferred_lifecycle_partial_materialization():
    m = tt.deferred_init(MLP)
    tt.materialize_module(m.fc1)
    assert not tt.is_deferred(m.fc1)
    assert tt.is_deferred(m)
    tt.materialize_module(m)
    assert not tt.is_deferred(m)


def test_forward_after_materialize():
    m = tt.deferred_init(MLP)
    tt.materialize_module(m)
    y = m(torch.ones(2, 16))
    assert y.shape == (2, 8) and not tt.is_fake(y)


def test_buffers_only():
    class WithBuf(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4, device="cpu")
            self.register_buffer("scale", torch.ones(4))

    m = tt.deferred_init(WithBuf)
    tt.materialize_module(m, buffers_only=True)
    assert torch.equal(m.scale, torch.ones(4)) and not tt.is_fake(m.scale)
    assert tt.is_fake(m.fc.weight)


def test_check_fn_selective():
    m = tt.deferred_init(MLP)
    tt.materialize_module(m, check_fn=lambda mod: not isinstance(mod, nn.RMSNorm))
    assert tt.is_fake(m.norm.weight)
    assert not tt.is_fake(m.fc1.weight)


def test_dependent_ops_and_views_replay():
    """An op chain on a parameter, an in-place init on a view, and a real
    tensor mixed with a fake: all replay to the eager values."""
    real = torch.arange(4.0)

    def build():
        lin = nn.Linear(4, 4, bias=False, device="cpu")
        with torch.no_grad():
            lin.weight[0].zero_()
        lin.register_buffer("wx2", lin.weight * 2.0 + 1.0)
        lin.register_buffer("mixed", lin.weight + real)
        return lin

    tt.manual_seed(7)
    m = tt.deferred_init(build)
    tt.materialize_module(m)
    tt.manual_seed(7)
    eager = build()
    for name in ("weight", "wx2", "mixed"):
        assert torch.equal(getattr(m, name), getattr(eager, name)), name
    assert torch.equal(m.weight[0], torch.zeros(4))


def test_terminal_op_inside_deferred_context():
    def build():
        w = torch.zeros(4)
        s = float(w.sum())  # materializes w mid-context
        t = torch.ones(2)  # recording still works afterwards
        return w, s, t

    w, s, t = tt.deferred_init(build)
    assert s == 0.0
    assert torch.equal(tt.materialize_tensor(w), torch.zeros(4))
    assert torch.equal(tt.materialize_tensor(t), torch.ones(2))


def test_real_tensor_mutated_before_materialize_raises():
    src = torch.ones(3)
    fake = tt.deferred_init(lambda: torch.zeros(3) + src)
    src.add_(1.0)
    with pytest.raises(RuntimeError, match="mutated"):
        tt.materialize_tensor(fake)


def test_nested_deferred_rejected():
    with pytest.raises(RuntimeError, match="nested"):
        tt.deferred_init(lambda: tt.deferred_init(MLP))


def test_mixing_sessions_rejected():
    w1 = tt.deferred_init(nn.Linear, 4, 4, device="cpu").weight
    with pytest.raises(RuntimeError, match="different deferred-init session"):
        tt.deferred_init(lambda: w1 + 0.0)


def test_double_materialize_is_stable_noop():
    m = tt.deferred_init(MLP)
    tt.materialize_module(m)
    first = _params(m)
    tt.materialize_module(m)
    assert all(first[k] is v for k, v in _params(m).items())


def test_sharding_rule_not_ported():
    m = tt.deferred_init(MLP)
    with pytest.raises(NotImplementedError, match="parallel"):
        tt.materialize_module(m, sharding_rule=lambda path, fake: None)


def test_fake_cuda_claims_cuda_and_needs_device_to_materialize():
    """On a host without a card, fake_cuda lets the model claim cuda:0;
    materializing then needs an explicit device=, and replay on the CPU
    matches an eager CPU construction from the same seed."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the claim would resolve")

    def build(device):
        return Llama.from_name("tiny", device=device)

    def fake_cuda_build():
        with tt.fake_mode(fake_cuda=True):
            return build("cuda")

    tt.manual_seed(3)
    m = tt.deferred_init(fake_cuda_build)
    assert all(p.device == torch.device("cuda", 0) for p in m.parameters())
    assert isinstance(m.tok_emb.weight, FakeTensor)
    with pytest.raises(RuntimeError, match="device="):
        tt.materialize_module(m)
    tt.materialize_module(m, device="cpu")
    tt.manual_seed(3)
    eager = build("cpu")
    for a, b in zip(m.parameters(), eager.parameters()):
        assert a.device.type == "cpu" and torch.equal(a, b)
