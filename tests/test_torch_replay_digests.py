"""The materialize's replay digests (``_graph.RecordingSession.numerics_book``,
site ``replay/chunk``): the port's counterparts of JAX's
``tests/test_numerics.py::TestReplayDigests``.

With ``TDX_NUMERICS`` on, a replay digests every floating output of every
recorded op it runs into one digest on the device, read once at the end.
The cases are JAX's: a book with ``count > 0`` and no nonfinite value, two
sessions' books bit-identical, no book with numerics off, and deferred init
against eager construction as digest equality per parameter.  Counts are
NOT held to JAX's: JAX's chunks digest the outputs of jnp-level closures,
the port's replay digests aten ops (``normal_`` in place, then the views
and scalings of ``nn.init``), so the two tally other tensors of the same
init.
"""

import torch

import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch import nn
from torchdistx_tpu_torch._graph import REPLAY_SITE
from torchdistx_tpu_torch.obs.numerics import fetch_digests, tree_digest


class _MLPModule(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32, device="cpu")
        self.fc2 = nn.Linear(32, 16, device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _materialize(monkeypatch, numerics):
    monkeypatch.setenv("TDX_NUMERICS", "1" if numerics else "0")
    tt.manual_seed(0)
    m = tt.deferred_init(_MLPModule)
    sess = m.fc1.weight._ref[0]
    tt.materialize_module(m)
    return m, sess


def _host(tree):
    (out,) = fetch_digests([tree])
    return out


def test_chunk_digests_and_deferred_vs_eager(monkeypatch):
    m, sess = _materialize(monkeypatch, True)
    book = sess.numerics_book
    assert book is not None and book.sites() == [REPLAY_SITE] == ["replay/chunk"]
    d = book.digest(REPLAY_SITE)
    assert d.count > 0 and d.nonfinite == 0
    # every parameter's values were among the digested outputs
    assert d.count >= sum(p.numel() for p in m.parameters())
    # deferred init equals eager init, restated as digest equality per
    # parameter
    tt.manual_seed(0)
    eager = _MLPModule()
    td = _host(tree_digest(dict(m.named_parameters()), prefix="params"))
    te = _host(tree_digest(dict(eager.named_parameters()), prefix="params"))
    assert set(td) == set(te)
    for k in td:
        assert td[k] == te[k] and td[k].max_abs == te[k].max_abs, k


def test_two_sessions_bit_identical(monkeypatch):
    _, s1 = _materialize(monkeypatch, True)
    _, s2 = _materialize(monkeypatch, True)
    d1, d2 = (s.numerics_book.digest(REPLAY_SITE) for s in (s1, s2))
    assert d1 == d2 and d1.hist_hash == d2.hist_hash
    assert d1.max_abs == d2.max_abs and d1.sumsq == d2.sumsq


def test_off_leaves_no_book(monkeypatch):
    _, sess = _materialize(monkeypatch, False)
    assert sess.numerics_book is None


def test_off_calls_no_observatory(monkeypatch):
    """With numerics off a replay touches nothing of ``obs.numerics`` (the
    package imports it elsewhere, so the module being loaded proves
    nothing): every digest function it could reach raises here."""
    from torchdistx_tpu_torch.obs import numerics

    def boom(*a, **k):
        raise AssertionError("the observatory was called with numerics off")

    for name in ("zero_digest", "array_digest", "merge_digests", "StagedDigests"):
        monkeypatch.setattr(numerics, name, boom)
    m, sess = _materialize(monkeypatch, False)
    assert sess.numerics_book is None
    assert all(not tt.is_fake(p) for p in m.parameters())
