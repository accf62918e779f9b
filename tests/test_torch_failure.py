"""The port's failure handling (``utils/failure.py``, ``Trainer(
failure_detector=, on_failure=)``) against the JAX package's, on the CPU.

Both trainers drive the JAX failure tests' problem: ``Linear(4, 1)``
(the JAX weights carried into the port), SGD at lr 1e-2, a mean-square
loss multiplied by NaN at one call of the step, log and checkpoint every
one and two steps.  Under ``on_failure`` ``"raise"``, ``"continue"`` and
``"restore"`` the port's log records equal the JAX ``Trainer``'s: the
failure records ``{"step", "failure", "action", "resumed_from"}`` and the
health gate's skips exactly, the metric records' steps exactly and their
losses within rtol 1e-6 (f32; the timing keys differ by nature).
``guard_nonfinite_updates`` against ``optax.apply_if_finite``: parameters
and the three counters after each step of a NaN pattern that crosses
``max_consecutive_errors``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu import nn as jnn
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.trainer import Trainer as JTrainer
from torchdistx_tpu.utils.failure import FailureDetector as JFailureDetector
from torchdistx_tpu.utils.failure import StepFailure as JStepFailure
from torchdistx_tpu.utils.failure import guard_nonfinite_updates as jguard
from torchdistx_tpu_torch import nn as tnn
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.trainer import Trainer, TrainStep
from torchdistx_tpu_torch.utils.failure import (
    FailureDetector,
    Heartbeat,
    StepFailure,
    apply_failure_policy,
    guard_nonfinite_updates,
)

BATCH = (np.ones((2, 4), np.float32), np.zeros((2, 1), np.float32))


class _JM(jnn.Module):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(4, 1)

    def forward(self, x):
        return self.fc(x)


class _TM(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(4, 1, device="cpu")

    def forward(self, x):
        return self.fc(x)


def _jax_params():
    tdx.manual_seed(0)
    m = tdx.deferred_init(_JM)
    tdx.materialize_module(m)
    return m, dict(m.named_parameters())


def _jax_trainer(tmp_path, inject_at, on_failure, detector):
    """``tests/test_failure.py``'s trainer."""
    m, params = _jax_params()
    tx = optax.sgd(1e-2)
    calls = {"n": 0}

    def loss_fn(p, batch):
        xb, yb = batch
        return jnp.mean((functional_call(m, p, (xb,)) - yb) ** 2)

    def step(p, s, batch):
        calls["n"] += 1
        loss, g = jax.value_and_grad(loss_fn)(p, batch)
        u, s = tx.update(g, s, p)
        p = jax.tree_util.tree_map(lambda a, b: a + b, p, u)
        if calls["n"] == inject_at:
            loss = loss * jnp.float32(float("nan"))
        return p, s, loss

    logs = []
    tr = JTrainer(step, params, tx.init(params), log_every=1, log_fn=logs.append,
                  checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=2,
                  failure_detector=detector, on_failure=on_failure)
    return tr, logs


def _torch_trainer(tmp_path, inject_at, on_failure, detector):
    _, params = _jax_params()
    model = _TM()
    load_jax_params(model, {k: np.asarray(v) for k, v in params.items()})
    calls = {"n": 0}

    def loss_fn(m, batch):
        xb, yb = batch
        calls["n"] += 1
        loss = torch.mean((m(xb) - yb) ** 2)
        return loss

    class NanStep(TrainStep):
        def __call__(self, params, opt_state, batch):
            params, opt_state, loss = super().__call__(params, opt_state, batch)
            if calls["n"] == inject_at:
                loss = loss * float("nan")
            return params, opt_state, loss

    logs = []
    step = NanStep(model, torch.optim.SGD(model.parameters(), lr=1e-2), loss_fn)
    tr = Trainer(step, log_every=1, log_fn=logs.append,
                 checkpoint_dir=str(tmp_path / "torch"), checkpoint_every=2,
                 failure_detector=detector, on_failure=on_failure)
    return tr, logs


def _assert_same_records(tlogs, jlogs):
    assert len(tlogs) == len(jlogs), (tlogs, jlogs)
    for t, j in zip(tlogs, jlogs):
        assert set(t) == set(j), (t, j)
        if "loss" in j:
            assert t["step"] == j["step"]
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-6)
        else:
            assert t == j


def _torch_batches(n):
    return [tuple(torch.from_numpy(a) for a in BATCH)] * n


def _jax_batches(n):
    return [tuple(jnp.asarray(a) for a in BATCH)] * n


@pytest.mark.parametrize("policy,inject_at,n_batches,num_steps", [
    ("continue", 3, 6, 6),
    ("restore", 5, 12, 8),
    ("restore", 3, 12, 6),
])
def test_policy_log_records_match_jax(tmp_path, policy, inject_at, n_batches, num_steps):
    tr, tlogs = _torch_trainer(tmp_path, inject_at, policy, FailureDetector())
    jtr, jlogs = _jax_trainer(tmp_path, inject_at, policy, JFailureDetector())
    tr.fit(_torch_batches(n_batches), num_steps=num_steps)
    jtr.fit(_jax_batches(n_batches), num_steps=num_steps)
    _assert_same_records(tlogs, jlogs)
    assert [m["action"] for m in tlogs if "failure" in m] == [
        {"continue": "continued", "restore": "restored"}[policy]]
    assert tr.global_step == jtr.global_step == num_steps
    for k in ("checkpoints_total", "failures_total"):
        assert tr.metrics[k] == jtr.metrics[k], k
    for name, p in tr.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jtr.params[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_raise_policy_matches_jax(tmp_path):
    tr, tlogs = _torch_trainer(tmp_path, 4, "raise", FailureDetector())
    jtr, jlogs = _jax_trainer(tmp_path, 4, "raise", JFailureDetector())
    with pytest.raises(StepFailure, match="non-finite"):
        tr.fit(_torch_batches(8))
    with pytest.raises(JStepFailure, match="non-finite"):
        jtr.fit(_jax_batches(8))
    _assert_same_records(tlogs, jlogs)
    assert tr.global_step == jtr.global_step == 4


def test_health_gate_matches_jax(tmp_path):
    tr, tlogs = _torch_trainer(tmp_path, 4, "continue", FailureDetector(nan_tolerance=10))
    jtr, jlogs = _jax_trainer(tmp_path, 4, "continue", JFailureDetector(nan_tolerance=10))
    tr.fit(_torch_batches(6), num_steps=6)
    jtr.fit(_jax_batches(6), num_steps=6)
    _assert_same_records(tlogs, jlogs)
    assert {"step": 4, "checkpoint": "skipped_nonfinite_loss"} in tlogs


def test_restore_without_checkpoint_raises(tmp_path):
    tr, _ = _torch_trainer(tmp_path, 2, "restore", FailureDetector())
    tr.checkpoint_dir = None
    with pytest.raises(StepFailure, match="no checkpoint"):
        tr.fit(_torch_batches(4))


def test_reshard_is_not_ported(tmp_path):
    # ported (tests/test_torch_reshard.py holds it over ranks): the policy is
    # accepted, and a step without a mesh cannot shrink, as in JAX
    Trainer(lambda p, s, b: (p, s, 0.0), on_failure="reshard")
    tr, _ = _torch_trainer(tmp_path, 0, "raise", FailureDetector())
    with pytest.raises(StepFailure, match="no mesh"):
        apply_failure_policy(tr, StepFailure("device_loss", "x"), "reshard")
    with pytest.raises(ValueError, match="policy"):
        Trainer(lambda p, s, b: (p, s, 0.0), on_failure="ignore")


@pytest.mark.parametrize("max_errors", [0, 2])
def test_guard_nonfinite_updates_matches_apply_if_finite(max_errors):
    rs = np.random.RandomState(7)
    w0 = rs.randn(5).astype(np.float32)
    pattern = [True, False, False, True, False, False, False, True, True]
    grads = []
    for finite in pattern:
        g = rs.randn(5).astype(np.float32)
        if not finite:
            g[rs.randint(5)] = np.nan
        grads.append(g)
    tx = jguard(optax.sgd(0.1), max_errors)
    jp = {"w": jnp.asarray(w0)}
    js = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = guard_nonfinite_updates(torch.optim.SGD([w], lr=0.1), max_errors)
    for g in grads:
        u, js = tx.update({"w": jnp.asarray(g)}, js, jp)
        jp = optax.apply_updates(jp, u)
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["w"]), rtol=1e-6,
                                   equal_nan=True)
        assert opt.notfinite_count == int(js.notfinite_count)
        assert opt.last_finite == bool(js.last_finite)
        assert opt.total_notfinite == int(js.total_notfinite)
    assert opt.param_groups[0]["lr"] == 0.1  # the wrapped optimizer's
    state = opt.state_dict()
    assert state["total_notfinite"] == pattern.count(False)


def test_detector_tolerance_and_window():
    det = FailureDetector(nan_tolerance=1, step_deadline_s=0.01)
    det.check_loss(1, 1.0)
    det.check_loss(2, float("nan"))
    with pytest.raises(StepFailure) as e:
        det.check_loss(3, float("inf"))
    assert e.value.kind == "nonfinite" and det.consecutive_nonfinite == 2
    det.reset()
    det.check_loss(4, float("nan"))
    with pytest.raises(StepFailure, match="budget"):
        det.check_window(5, elapsed_s=0.5, n_steps=4)
    det.check_window(6, elapsed_s=0.03, n_steps=4)
    assert det.counts_by_kind() == {"nonfinite": 3, "deadline": 1}


def test_heartbeat_stamps(tmp_path):
    path = str(tmp_path / "hb")
    with Heartbeat(path, interval_s=0.05) as hb:
        hb.step = 3
        assert not Heartbeat.is_stale(path, max_age_s=5.0)
    assert Heartbeat.is_stale(path, max_age_s=0.0)
    assert Heartbeat.is_stale(str(tmp_path / "missing"), 5.0)
