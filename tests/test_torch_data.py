"""The port's token loader against the JAX package's, on the CPU.

The same numpy stream goes into both packages' ``TokenDataset`` and
``DataLoader``: items and batches must be equal exactly, across epochs and
across a ``state_dict`` resume (the JAX side with ``prefetch=0``).
"""

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.data import DataLoader as JLoader
from torchdistx_tpu.data import TokenDataset as JDataset
from torchdistx_tpu_torch.data import DataLoader, TokenDataset, prefetch_to_device

SEQ, BATCH = 16, 4
STREAM = np.random.RandomState(0).randint(0, 50257, 30 * SEQ + 5)


def _np(batch):
    return [np.asarray(b) for b in batch]


def _loaders(prefetch=0, **kw):
    j = JLoader(JDataset(STREAM, SEQ), BATCH, prefetch=0, **kw)
    t = DataLoader(TokenDataset(STREAM, SEQ), BATCH, prefetch=prefetch, device="cpu", **kw)
    return j, t


def test_items_match_jax():
    jd, td = JDataset(STREAM, SEQ), TokenDataset(STREAM, SEQ)
    assert len(td) == len(jd) == 30
    for i in (0, 1, 17, 29):
        for a, b in zip(td[i], jd[i]):
            assert np.array_equal(a, b)
    x, y = td[3]
    assert np.array_equal(y[:-1], x[1:])
    with pytest.raises(ValueError, match="1-d"):
        TokenDataset(STREAM.reshape(5, -1), SEQ)


@pytest.mark.parametrize("prefetch", [0, 2], ids=["inline", "prefetch"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
def test_two_epochs_of_batches_match_jax(shuffle, prefetch):
    jl, tl = _loaders(prefetch, shuffle=shuffle, seed=3)
    assert len(tl) == len(jl) == 7
    for epoch in range(2):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == 7
        for a, b in zip(tb, jb):
            assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in a)
            for x, y in zip(_np(a), _np(b)):
                assert x.shape == (BATCH, SEQ) and np.array_equal(x, y)
        assert tl.epoch == jl.epoch == epoch + 1
    if shuffle:  # the two epochs are different permutations
        assert not np.array_equal(_np(list(tl)[0])[0], _np(tb[0])[0])


def test_state_dict_resume_mid_epoch():
    jl, tl = _loaders(shuffle=True, seed=1)
    it = iter(tl)
    for _ in range(3):
        next(it)
    sd = tl.state_dict()
    assert sd == {"epoch": 0, "pos": 3, "seed": 1}
    rest = [_np(b) for b in it]
    fresh = DataLoader(TokenDataset(STREAM, SEQ), BATCH, shuffle=True, seed=99,
                       prefetch=0, device="cpu")
    fresh.load_state_dict(sd)
    resumed = [_np(b) for b in fresh]
    jl.load_state_dict(sd)
    jrest = [_np(b) for b in jl]
    assert len(rest) == len(resumed) == len(jrest) == 4
    for a, b, c in zip(rest, resumed, jrest):
        for x, y, z in zip(a, b, c):
            assert np.array_equal(x, y) and np.array_equal(x, z)
    assert fresh.state_dict() == {"epoch": 1, "pos": 0, "seed": 1}


def test_partial_batch_and_unported_sharding():
    jl, tl = _loaders(drop_last=False)
    assert len(tl) == len(jl) == 8
    last_t, last_j = list(tl)[-1], list(jl)[-1]
    assert last_t[0].shape == (2, SEQ) and np.array_equal(_np(last_t)[0], _np(last_j)[0])
    with pytest.raises(NotImplementedError, match="sharding"):
        DataLoader(TokenDataset(STREAM, SEQ), BATCH, sharding=object())


def test_prefetch_propagates_errors_and_stops_early():
    def bad():
        yield (np.zeros(2),)
        raise RuntimeError("boom")

    it = prefetch_to_device(bad(), "cpu", 1)
    assert next(it)[0].shape == (2,)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    endless = prefetch_to_device(((np.ones(3),) for _ in iter(int, 1)), "cpu", 2)
    assert next(endless)[0].sum() == 3
    endless.close()  # the worker notices and exits
