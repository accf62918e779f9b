"""The port's checkpoint / resume (``utils/checkpoint.py``, ``Trainer.save``
/ ``restore``), on the CPU.

Tiny Llama (f32) through ``build_train_workload`` with the 8-bit AdamW:
a run saved at step 2 and resumed from that checkpoint (in place, and by a
second workload as a restarted job would) takes steps 3-6 with the same
bits in every loss, parameter and optimizer code as the uninterrupted run.
The health gate: no checkpoint is written at a non-finite loss.
"""

import os

import pytest
import torch

from torchdistx_tpu_torch import nn as tnn
from torchdistx_tpu_torch.trainer import Trainer
from torchdistx_tpu_torch.utils.benchmarks import build_train_workload
from torchdistx_tpu_torch.utils.checkpoint import (
    load_module,
    restore_checkpoint,
    save_checkpoint,
    save_module,
)
from torchdistx_tpu_torch.utils.failure import FailureDetector


def _workload():
    return build_train_workload("tiny", batch=2, seq=16, device="cpu",
                                optimizer="adamw_8bit", remat=True, remat_policy="dots")


def _snapshot(w):
    params = {n: p.detach().clone() for n, p in w["model"].named_parameters()}
    state = {i: {k: v.clone() for k, v in st.items()}
             for i, st in enumerate(w["optimizer"].state.values())}
    return params, state


def _assert_same(a, b):
    (pa, sa), (pb, sb) = a, b
    assert pa.keys() == pb.keys() and sa.keys() == sb.keys()
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    for i in sa:
        for k in sa[i]:
            assert sa[i][k].dtype == sb[i][k].dtype and torch.equal(sa[i][k], sb[i][k]), (i, k)


@pytest.mark.parametrize("resume", ["in_place", "new_job"])
def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path, resume):
    ref = _workload()
    ref_losses = ref["run"](6)
    w = _workload()
    w["trainer"].checkpoint_dir = str(tmp_path)
    w["trainer"].checkpoint_every = 2
    first = w["run"](2)
    assert first == ref_losses[:2]
    saved = _snapshot(w)
    w["run"](2)
    assert w["trainer"].metrics["checkpoints_total"] == 2
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_4"]
    if resume == "new_job":
        w = _workload()
        w["run"](1)  # moves the fresh state off the checkpoint's
    w["trainer"].restore(str(tmp_path / "step_2"))
    assert w["trainer"].global_step == 2 and w["optimizer"].count == 2
    _assert_same(_snapshot(w), saved)
    resumed = w["run"](4)
    assert resumed == ref_losses[2:]
    _assert_same(_snapshot(w), _snapshot(ref))


def _nan_step(inject_at):
    calls = {"n": 0}

    def step(params, opt_state, batch):
        calls["n"] += 1
        loss = torch.tensor(1.0 / calls["n"])
        return params, opt_state, loss * float("nan") if calls["n"] == inject_at else loss

    return step


def test_health_gate_skips_a_nonfinite_checkpoint(tmp_path):
    logs = []
    tr = Trainer(_nan_step(4), {"w": torch.ones(3)}, None, log_every=1, log_fn=logs.append,
                 checkpoint_dir=str(tmp_path), checkpoint_every=2,
                 failure_detector=FailureDetector(nan_tolerance=10), on_failure="continue")
    tr.fit(iter(range(6)), num_steps=6)
    assert {"step": 4, "checkpoint": "skipped_nonfinite_loss"} in logs
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_6"]
    assert tr.metrics["checkpoints_total"] == 2
    # without a detector there is no gate
    tr = Trainer(_nan_step(2), {"w": torch.ones(3)}, None, log_every=1,
                 log_fn=lambda m: None, checkpoint_dir=str(tmp_path / "ungated"),
                 checkpoint_every=2)
    tr.fit(iter(range(2)))
    assert os.listdir(tmp_path / "ungated") == ["step_2"]


def test_save_is_atomic_and_overwrites(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"a": torch.arange(3), "step": 1})
    save_checkpoint(path, {"a": torch.arange(4), "step": 2})
    out = restore_checkpoint(path)
    assert out["step"] == 2 and torch.equal(out["a"], torch.arange(4))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    with pytest.raises(ValueError, match="keys"):
        restore_checkpoint(path, like={"a": torch.zeros(4)})
    live = {"a": torch.zeros(4, dtype=torch.float64), "step": 0}
    got = restore_checkpoint(path, like=live)
    assert got["step"] == 2 and got["a"].dtype == torch.float64


def test_save_module_and_load_module(tmp_path):
    torch.manual_seed(0)
    a = tnn.Linear(4, 3, device="cpu")
    b = tnn.Linear(4, 3, device="cpu")
    save_module(str(tmp_path / "m"), a)
    load_module(str(tmp_path / "m"), b)
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
