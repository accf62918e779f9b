"""The port's ``Trainer`` accounting against the JAX loop's: the
``metrics`` keys (``mfu_xla``, ``flop_attribution``, ``goodput``), the
wall-time split goodput reads, the counted card's ``flop_attribution``
and ``metrics_collector``'s families (the numerics book's and the failure
detector's included), over tiny Llama on the CPU.

The band of ``flop_attribution``: the analytic formula counts
``6 N + 12 L dim seq`` FLOPs a token; the counted card (``obs.cost``)
counts what the step multiplies: 6 a weight of every matrix product
(forward, dX and dW) and the plain attention's ``12 L dim seq``, none for
the embedding (a gather) or the norms' scales.  So the attribution is
``(6 N + 12 L dim seq) / (6 (N - V dim - norms) + 12 L dim seq)``, above 1
by the embedding's share: 1.0 < it <= 1.25 for tiny Llama (V = 256, dim
64), and equal to that closed form.
"""

import gc
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
import torchdistx_tpu_torch as tt
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.parallel import ShardedTrainStep as JShardedTrainStep
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.trainer import Trainer as JTrainer
from torchdistx_tpu.utils.failure import FailureDetector as JFailureDetector
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.nn import functional as F
from torchdistx_tpu_torch.trainer import Trainer, TrainStep
from torchdistx_tpu_torch.utils.failure import FailureDetector

STEPS = 3
B, S = 2, 32
BAND = (1.0, 1.25)


@pytest.fixture(autouse=True)
def cards_on(monkeypatch):
    """The suite's conftest turns cost cards off (``TDX_COST_CARDS=0``)."""
    monkeypatch.delenv("TDX_COST_CARDS", raising=False)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (B, S)).astype(np.int32),
            rs.randint(0, 256, (B, S)).astype(np.int32))


def _jax_llama():
    tdx.manual_seed(0)
    m = JLlama.from_name("tiny")
    return m, {k: np.asarray(v) for k, v in m.named_parameters()}


def _flops_per_token(n_params, cfg):
    return 6 * n_params + 12 * cfg.n_layers * cfg.dim * S


def _jax_trainer():
    """JAX's loop over its ``ShardedTrainStep`` with the numerics digests,
    one CPU device, SGD, a failure detector, the cost card on."""
    jm, init = _jax_llama()

    def loss_fn(p, batch):
        return jF.cross_entropy(functional_call(jm, p, (batch[0],)), batch[1])

    mesh = jcreate_mesh({"fsdp": 1}, devices=jax.devices()[:1])
    step = JShardedTrainStep(loss_fn, optax.sgd(1e-2), mesh, shard_axis="fsdp",
                             numerics=True)
    params = step.shard_params(dict(jm.named_parameters()))
    n = sum(int(np.prod(v.shape)) for v in init.values())
    tr = JTrainer(step, params, log_every=1, log_fn=lambda m: None,
                  failure_detector=JFailureDetector(), tokens_per_batch=B * S,
                  flops_per_token=_flops_per_token(n, jm.cfg), cost_card=True)
    tr.fit(itertools.repeat(tuple(jnp.asarray(a) for a in _batch())), STEPS)
    return tr, init


def _port_trainer(init, **kw):
    tm = load_jax_params(TLlama.from_name("tiny", device="cpu"), init)
    step = TrainStep(tm, torch.optim.SGD(tm.parameters(), lr=1e-2),
                     lambda m, b: F.cross_entropy(m(b[0]), b[1]), numerics=True)
    n = sum(p.numel() for p in tm.parameters())
    tr = Trainer(step, log_every=1, log_fn=lambda m: None, tokens_per_batch=B * S,
                 flops_per_token=_flops_per_token(n, tm.cfg), cost_card=True, **kw)
    tr.fit(itertools.repeat(tuple(torch.from_numpy(a).long() for a in _batch())), STEPS)
    return tr


@pytest.fixture(scope="module")
def jax_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("TDX_COST_CARDS", raising=False)
        return _jax_trainer()


def test_metrics_keys_equal_jax(jax_run):
    jtr, init = jax_run
    tr = _port_trainer(init, failure_detector=FailureDetector())
    assert list(tr.metrics) == list(jtr.metrics)
    for key in ("mfu", "mfu_xla", "flop_attribution", "goodput"):
        assert tr.metrics[key] is not None and jtr.metrics[key] is not None, key
    assert tr.metrics["steps_total"] == jtr.metrics["steps_total"] == STEPS


def test_goodput_books_a_checkpoint_to_its_bucket(jax_run, tmp_path):
    tr = _port_trainer(jax_run[1], checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert tr.metrics["checkpoints_total"] == 1 and tr._t_checkpoint > 0
    assert tr._t_compile > 0 and tr._t_productive > 0
    assert tr._t_rollback == 0 and tr._t_reshard == 0
    total = tr._t_productive + tr._t_compile + tr._t_checkpoint
    assert 0 < tr.metrics["goodput"] <= 1
    assert tr.metrics["goodput"] == pytest.approx(tr._t_productive / total)


def test_flop_attribution_is_the_closed_form_within_the_band(jax_run):
    tr = _port_trainer(jax_run[1])
    model, cfg = tr.step.model, tr.step.model.cfg
    n = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() for name, p in model.named_parameters()
                  if p.dim() == 2 and not name.startswith("tok_emb"))
    attention = 12 * cfg.n_layers * cfg.dim * S
    card = tr.cost_card
    assert card.flops == B * S * (6 * weights + attention)  # counted, exactly
    assert card.analytic_flops == B * S * _flops_per_token(n, cfg)
    want = (6 * n + attention) / (6 * weights + attention)
    assert tr.metrics["flop_attribution"] == pytest.approx(want, rel=1e-12)
    assert BAND[0] < tr.metrics["flop_attribution"] <= BAND[1]
    assert tr.metrics["mfu_xla"] == pytest.approx(
        tr.metrics["steps_per_sec"] * card.flops / tr.peak_flops)


def _families(collect):
    return sorted(f.name for f in collect())


def test_metrics_collector_families_equal_jax(jax_run):
    jtr, init = jax_run
    tr = _port_trainer(init, failure_detector=FailureDetector())
    assert tr.numerics_book.harvests and jtr.numerics_book.harvests
    for prefix in ("tdx_train", "job7"):
        got = _families(tr.metrics_collector(prefix))
        assert got == _families(jtr.metrics_collector(prefix))
        assert f"{prefix}_failure_events_total" in got and f"{prefix}_mfu_xla" in got
        assert any(name.startswith(f"{prefix}_numerics") for name in got)


def test_metrics_collector_holds_the_trainer_weakly():
    tr = Trainer(lambda p, s, b: (p, s, torch.tensor(float(b))), None, None, log_every=1,
                 log_fn=lambda m: None, flight=False)
    tr.fit(iter([1.0, 2.0]), 2)
    collect = tr.metrics_collector()
    assert "tdx_train_steps_total" in _families(collect)
    del tr
    gc.collect()
    assert collect() == []
