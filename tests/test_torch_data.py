"""The port's token loader against the JAX package's, on the CPU.

The same numpy stream goes into both packages' ``TokenDataset`` and
``DataLoader``: items and batches must be equal exactly, across epochs and
across a ``state_dict`` resume (the JAX side with ``prefetch=0``).  With
``sharding=`` (a ``parallel.NamedSharding``) each rank's batches are its
slice of the JAX loader's batch, bit for bit, marked with the global
shape, inline and through the prefetch thread: at world size 1 here, and
at world size 4 on ``gloo`` (the ``data`` suite of
``tests/_torch_dist_worker.py``) over ``{"dp": 2, "tp": 2}``, sharded over
dp and over (dp, tp).
"""

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.data import DataLoader as JLoader
from torchdistx_tpu.data import TokenDataset as JDataset
from _torch_dist_worker import spawn_world
from torchdistx_tpu_torch.data import DataLoader, TokenDataset, prefetch_to_device
from torchdistx_tpu_torch.parallel import NamedSharding, create_mesh
from torchdistx_tpu_torch.parallel.mesh import sharding_of

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
    # sharding= is ported: at world size 1 the piece is the whole batch, marked
    sh = NamedSharding(create_mesh({"dp": 1}), ("dp",))
    for prefetch in (0, 2):
        loader = DataLoader(TokenDataset(STREAM, SEQ), BATCH, sharding=sh, prefetch=prefetch,
                            device="cpu")
        for a, b in zip(loader, JLoader(JDataset(STREAM, SEQ), BATCH, prefetch=0)):
            for x, y in zip(a, _np(b)):
                assert np.array_equal(x.numpy(), y)
                assert sharding_of(x) == (sh, (BATCH, SEQ))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    payload = {"stream": STREAM, "seq": SEQ, "batch": BATCH}
    return spawn_world("data", tmp_path_factory.mktemp("data"), payload)


@pytest.mark.parametrize("case", ["dp_p0", "dp_p2", "dp_tp_p0", "dp_tp_p2"])
def test_sharded_batches_are_slices_of_the_jax_batches(world, case):
    jl = JLoader(JDataset(STREAM, SEQ), BATCH, shuffle=True, seed=3, prefetch=0)
    want = [_np(b) for _ in range(2) for b in jl]
    assert len(want) == 14
    spec = ("dp",) if case.startswith("dp_p") else (("dp", "tp"),)
    for rank, res in enumerate(world):
        r = res[case]
        assert "error" not in r, r["error"]
        c = r["coords"]
        n, idx = (2, c["dp"]) if spec == ("dp",) else (4, 2 * c["dp"] + c["tp"])
        assert c == {"dp": rank // 2, "tp": rank % 2}
        assert len(r["batches"]) == len(want)
        for got, full in zip(r["batches"], want):
            assert got["tensors"]
            assert [tuple(s) for s in got["specs"]] == [spec, spec]
            assert [tuple(s) for s in got["shapes"]] == [(BATCH, SEQ)] * 2
            for x, y in zip(got["arrays"], full):
                assert np.array_equal(x, np.split(y, n, axis=0)[idx])


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
