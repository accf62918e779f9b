"""The port's numerics observatory (``torchdistx_tpu_torch.obs.numerics``)
against the JAX package's, on the CPU.

- The digest: the same numpy arrays (NaN, both infinities, zeros,
  subnormals, 80 decades of magnitude) through JAX's ``array_digest`` and
  the port's; every integer field and ``max_abs`` exact, ``sumsq`` to rtol
  1e-6.  Merges, the zero identity, the tape and ``provenance_key``; the
  book's JSON, ``counter_rows`` and ``drift_rows`` equal to JAX's for the
  same updates.
- Serving: tiny Llama with the JAX model's weights, chunked, K-step,
  persistent, speculative, paged int8 (chunked and persistent) and chunked
  prefill: the port engine's book equals the JAX engine's site for site
  (integer fields exact, ``max_abs`` and rms to rtol 1e-5); numerics adds
  no host sync, no dispatch and changes no stream; it joins the static key.
- Training: the port's ``TrainStep`` digests tiny Llama's JAX parameter
  groups exactly as JAX's ``tree_group_digest`` does, and its whole
  digest tree (``params/``, ``act/``, ``loss``, ``grads/``) equals the JAX
  step's on the same weights and batch; ``ShardedTrainStep`` and
  ``GSPMDTrainStep`` (``dp`` and TP) at world 1 and world 2 over ``gloo``
  (``tests/_torch_dist_worker.py``) give equal integer fields, and each
  step's trees equal the JAX step of the same kind on as many devices
  (integer fields and ``hist_hash`` exact, ``max_abs`` and rms to rtol
  1e-5); the FSDP step's comm audit equals the JAX step's (the digests'
  ``psum`` and ``pmax`` included), and a poisoned parameter is named as
  the JAX step names it.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import spawn_world
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.obs import comm_audit as jcomm_audit
from torchdistx_tpu.obs import numerics as jn
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torchdistx_tpu.parallel import GSPMDTrainStep as JGSPMDTrainStep
from torchdistx_tpu.parallel import ShardedTrainStep as JShardedTrainStep
from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
from torchdistx_tpu.parallel import llama_tp_plan as jllama_tp_plan
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.nn import functional as F
from torchdistx_tpu_torch.obs import numerics as tn
from torchdistx_tpu_torch.serve import ServeEngine
from torchdistx_tpu_torch.trainer import Trainer, TrainStep
from torchdistx_tpu_torch.utils.benchmarks import build_train_workload

INT_FIELDS = ("nonfinite", "zeros", "count", "exp_hist")


def _messy(seed, n=4096, dtype=np.float32):
    """JAX's test input: normals over 80 decades, exact zeros, subnormals,
    NaNs and both infinities."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(n) * np.exp2(rs.randint(-40, 40, n))).astype(np.float32)
    x[::97] = 0.0
    x[1::97] = 1e-42
    x[2::197] = np.nan
    x[3::197] = np.inf
    x[4::197] = -np.inf
    return x.astype(dtype)


def _jhost(d):
    return jn.HostDigest.from_device(jax.device_get(d))


def _thost(d):
    return tn.HostDigest.from_device(d)


def _same(t, j, float_rtol=None, what=""):
    """Port and JAX host digests: integer fields exact, floats as asked."""
    for f in INT_FIELDS:
        assert getattr(t, f) == getattr(j, f), (what, f)
    assert t.hist_hash == j.hist_hash, what
    if float_rtol is None:
        assert t.max_abs == j.max_abs, what
    else:
        np.testing.assert_allclose(t.max_abs, j.max_abs, rtol=float_rtol, err_msg=what)
        np.testing.assert_allclose(t.rms, j.rms, rtol=float_rtol, err_msg=what)


# -- the digest ---------------------------------------------------------------


@pytest.mark.parametrize("seed,n,dtype", [(0, 4096, np.float32), (1, 1, np.float32),
                                          (2, 100_003, np.float32), (3, 4096, "bfloat16"),
                                          (4, 0, np.float32)])
def test_array_digest_equals_jax(seed, n, dtype):
    x = _messy(seed, n)
    if dtype == "bfloat16":
        j = _jhost(jn.array_digest(jnp.asarray(x).astype(jnp.bfloat16)))
        t = _thost(tn.array_digest(torch.from_numpy(x).to(torch.bfloat16)))
    else:
        j = _jhost(jn.array_digest(jnp.asarray(x)))
        t = _thost(tn.array_digest(torch.from_numpy(x)))
    _same(t, j)
    np.testing.assert_allclose(t.sumsq, j.sumsq, rtol=1e-6)
    assert t.count == n == t.nonfinite + t.zeros + sum(t.exp_hist)
    if n:
        assert t.nonfinite == int(np.sum(~np.isfinite(x.astype(np.float32)))) or dtype != np.float32
        assert t.zeros == int(np.sum(x == 0.0)) or dtype != np.float32


def test_error_digest_equals_jax():
    x, y = _messy(5), _messy(6)
    y[~np.isfinite(y)] = 1.0
    x[~np.isfinite(x)] = 2.0
    j = _jhost(jn.error_digest(jnp.asarray(x), jnp.asarray(y)))
    t = _thost(tn.error_digest(torch.from_numpy(x), torch.from_numpy(y)))
    _same(t, j)


def test_merge_and_zero_identity():
    x = _messy(7)
    a, b = tn.array_digest(torch.from_numpy(x[:1000])), tn.array_digest(torch.from_numpy(x[1000:]))
    whole = _thost(tn.array_digest(torch.from_numpy(x)))
    dev = _thost(tn.merge_digests(a, b))
    host = _thost(a).merge(_thost(b))
    assert dev == host == whole and dev.max_abs == whole.max_abs
    assert dev.hist_hash == whole.hist_hash
    z = _thost(tn.zero_digest())
    assert z.count == 0 and z.merge(whole) == whole and whole.merge(z) == whole
    tree = tn.merge_digest_trees({"s": a}, {"s": b})
    assert _thost(tree["s"]) == whole
    with pytest.raises(ValueError, match="site mismatch"):
        tn.merge_digest_trees({"s": a}, {"t": b})
    stacked = {"s": {k: torch.stack([a[k], b[k]]) for k in a}}
    assert _thost(tn.reduce_stacked_digests(stacked)["s"]) == whole


def test_tape_tap_and_provenance():
    x = torch.from_numpy(_messy(8))
    assert tn.tap("nobody", x) is x and tn.active_tape() is None
    with tn.numerics_tape(sites=("a", "b")) as tape:
        assert tn.tap("a", x) is x
        tn.tap("c", x)  # not declared: ignored
        tn.tap("a", torch.arange(5))  # not floating: ignored
        with tn.numerics_tape() as inner:
            tn.tap("a", x)
        assert tn.active_tape() is tape
    digs = tape.digests()
    assert list(digs) == ["a", "b"] and _thost(digs["b"]).count == 0
    assert _thost(digs["a"]).count == x.numel() == _thost(inner.digests()["a"]).count
    # the deferred tape: one pass a site, the same exact fields
    with tn.numerics_tape(sites=("a",), defer=True) as deferred:
        tn.tap("a", x[:100])
        tn.tap("a", x[100:])
        tn.tap_error("a", x[:3], x[:3] + 0.5)
    eager = tn.merge_digests(tn.array_digest(x), tn.error_digest(x[:3], x[:3] + 0.5))
    assert _thost(deferred.digests()["a"]) == _thost(eager)
    # tap_made: the parts concatenated over the taps, made once
    rows = [torch.from_numpy(_messy(s, 64)).view(8, 8) for s in (12, 13)]

    def made(a, b):
        return a * 2.0 - b

    with tn.numerics_tape(defer=True) as deferred:
        tn.tap_made("m", made, rows[0], rows[1])
        tn.tap_made("m", made, rows[1], rows[0])
    want = tn.merge_digests(tn.array_digest(made(rows[0], rows[1])),
                            tn.array_digest(made(rows[1], rows[0])))
    assert _thost(deferred.digests()["m"]) == _thost(want)
    sites = ["grads/w", "loss", "act/block10", "logits", "act/block2", "params/w", "kv_quant_err"]
    assert sorted(sites, key=tn.provenance_key) == sorted(sites, key=jn.provenance_key)


def test_staged_digests_read_what_from_device_reads():
    """One packed copy for many trees: every field as ``HostDigest`` reads
    it from the tensors, the f32 gauges exactly, the tree order kept."""
    trees = [{"a": tn.array_digest(torch.from_numpy(_messy(7))),
              "b": tn.zero_digest()},
             {},
             {"c": tn.error_digest(torch.from_numpy(_messy(8)), torch.from_numpy(_messy(9)))}]
    got = tn.StagedDigests(trees).read()
    assert [list(t) for t in got] == [["a", "b"], [], ["c"]]
    for g, t in zip(got, trees):
        for site, d in t.items():
            want = tn.HostDigest.from_device(d)
            assert g[site] == want and g[site].hist_hash == want.hist_hash
            assert (g[site].max_abs, g[site].sumsq) == (want.max_abs, want.sumsq)
    assert tn.fetch_digests([]) == [] and tn.fetch_digests([{}]) == [{}]


def test_book_json_counter_and_drift_rows_equal_jax():
    tb, jb = tn.NumericsBook(), jn.NumericsBook()
    for step, seed in enumerate((9, 10, 11)):
        x = _messy(seed)
        x[:] = np.where(np.isfinite(x), x, 0.0) if step == 0 else x
        tb.update_tree({"params/w": tn.array_digest(torch.from_numpy(x)),
                        "act/block1": tn.array_digest(torch.from_numpy(x[:50]))}, step=step)
        jb.update_tree({"params/w": jn.array_digest(jnp.asarray(x)),
                        "act/block1": jn.array_digest(jnp.asarray(x[:50]))}, step=step)
    assert tb.sites() == jb.sites() and tb.harvests == jb.harvests == 3
    assert tb.first_nonfinite_site() == jb.first_nonfinite_site() == "params/w"
    assert tb.first_nonfinite_step == jb.first_nonfinite_step == 1
    assert tb.counter_rows() == jb.counter_rows()
    got, want = tb.to_json(), jb.to_json()
    for s in got["sites"]:
        for k in ("max_abs", "rms"):
            np.testing.assert_allclose(got["sites"][s].pop(k), want["sites"][s].pop(k), rtol=1e-6)
    assert got == want
    back = tn.NumericsBook.from_json(json.loads(tb.dumps()))  # sites sorted by name
    assert sorted(back.counter_rows(), key=str) == sorted(tb.counter_rows(), key=str)
    assert jn.NumericsBook.from_json(tb.to_json()).counter_rows() == tb.counter_rows()
    pins = {"params/w": {"count": 1, "nonfinite": tb.digest("params/w").nonfinite},
            "missing/site": {"count": 0}}
    assert tb.drift_rows(pins) == jb.drift_rows(pins) and len(tb.drift_rows(pins)) == 2
    fams = {f.name: f for f in tb.collector()()}
    assert fams["tdx_numerics_harvests_total"].samples[0][2] == 3


def test_numerics_enabled_reads_the_environment(monkeypatch):
    monkeypatch.delenv("TDX_NUMERICS", raising=False)
    assert not tn.numerics_enabled() and tn.numerics_enabled(True)
    for v, want in (("1", True), ("0", False), ("false", False), ("yes", True)):
        monkeypatch.setenv("TDX_NUMERICS", v)
        assert tn.numerics_enabled() == jn.numerics_enabled() == want


# -- serving ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _requests(temps=(0.0,) * 5):
    rs = np.random.RandomState(5)
    return [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32), "max_new_tokens": 8,
             "temperature": t, "seed": 100 + i}
            for i, (n, t) in enumerate(zip((5, 9, 12, 20, 7), temps))]


SERVE_MODES = {
    "chunked": {},
    "k3": {"decode_chunk": 3},
    "persistent": {"decode_mode": "persistent"},
    "spec2": {"speculate": 2},
    "persistent_spec2": {"speculate": 2, "decode_mode": "persistent"},
    "paged_int8": {"page_size": 8, "kv_dtype": "int8"},
    "persistent_paged_int8": {"page_size": 8, "kv_dtype": "int8", "decode_mode": "persistent"},
    "slab_int8": {"kv_dtype": "int8"},
    "chunked_prefill_paged": {"chunked_prefill": 8, "prefill_buckets": (8, 16, 32),
                              "page_size": 8},
}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
def test_serve_book_equals_jax_engine(models, mode):
    jm, tm = models
    kw = dict(num_slots=3, max_len=64, prefill_buckets=(16, 32), numerics=True)
    kw.update(SERVE_MODES[mode])
    je, te = JServeEngine(jm, **kw), ServeEngine(tm, **kw)
    ref, out = je.run(_requests()), te.run(_requests())
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    jb, tb = je.numerics_book, te.numerics_book
    assert tb.sites() == jb.sites() == ["logits", "kv_quant_err", "kv_quant_scale"]
    assert tb.harvests == jb.harvests
    for site in jb.sites():
        _same(tb.digest(site), jb.digest(site), float_rtol=1e-5, what=(mode, site))
    quant = tb.digest("kv_quant_err")
    assert bool(quant.count) == ("int8" in mode)
    if quant.count:
        assert quant.max_abs <= 0.5 * tb.digest("kv_quant_scale").max_abs
        assert te.metrics.kv_quant_err_max == quant.max_abs
    assert te.numerics_harvest_errors == 0


@pytest.mark.parametrize("mode", ["chunked", "persistent", "spec2", "persistent_paged_int8"])
def test_numerics_adds_no_sync_and_changes_no_stream(models, mode):
    """The JAX engine's zero-overhead pin: with numerics on, the same
    streams (greedy and sampled) and exactly the same counters."""
    _, tm = models
    kw = dict(num_slots=3, max_len=64, prefill_buckets=(16, 32), **SERVE_MODES[mode])
    reqs = _requests((0.0, 0.8, 0.0, 1.1, 0.0))
    off = ServeEngine(tm, numerics=False, **kw)
    on = ServeEngine(tm, numerics=True, **kw)
    for a, b in zip(off.run(reqs), on.run(reqs)):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert a.finish_reason == b.finish_reason
    assert on.metrics.counters == off.metrics.counters
    assert off.numerics_book.sites() == [] and on.numerics_book.digest("logits").count
    # the closed form of the logits count: a row a prefill, every slot's
    # rows each decode step (finished slots included)
    c = on.metrics.counters
    rows = 3 * (SERVE_MODES[mode].get("speculate", 0) + 1)
    assert on.numerics_book.digest("logits").count == tm.cfg.vocab_size * (
        c["prefill_calls"] + rows * c["decode_steps"])


def test_numerics_joins_the_static_key(models, monkeypatch):
    _, tm = models
    on, off = ServeEngine(tm, max_len=64, numerics=True), ServeEngine(tm, max_len=64)
    assert on._static_key() != off._static_key() and on._static_key()[-1] is True
    monkeypatch.setenv("TDX_NUMERICS", "1")
    assert ServeEngine(tm, max_len=64).numerics
    assert not ServeEngine(tm, max_len=64, numerics=False).numerics


def test_kv_quant_anomaly_is_recorded_once(models, monkeypatch):
    """An error above half the largest scale breaks the quantizer's
    round-to-nearest bound: one ``kv_quant_err`` flight anomaly an engine."""
    from torchdistx_tpu_torch.obs.flight import get_flight_recorder
    from torchdistx_tpu_torch.serve import kv_cache

    _, tm = models
    real = kv_cache.dequantize_kv
    monkeypatch.setattr(kv_cache, "dequantize_kv", lambda q, s: real(q, s) + s)
    engine = ServeEngine(tm, max_len=64, prefill_buckets=(16, 32), kv_dtype="int8",
                         numerics=True)
    flight = get_flight_recorder()
    before = sum(1 for e in flight.records() if e.get("anomaly") == "kv_quant_err")
    engine.run(_requests())
    after = sum(1 for e in flight.records() if e.get("anomaly") == "kv_quant_err")
    assert engine._kv_quant_alarmed and after - before == 1


# -- training --------------------------------------------------------------------


def _batch(seed=0, b=4, s=16):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, (b, s)).astype(np.int64), rs.randint(0, 256, (b, s)).astype(np.int64))


def _jax_llama():
    tdx.manual_seed(0)
    m = JLlama.from_name("tiny")
    return m, {k: np.asarray(v) for k, v in m.named_parameters()}


def test_train_step_param_digests_equal_jax_groups():
    jm, init = _jax_llama()
    tm = load_jax_params(TLlama.from_name("tiny", device="cpu"), init)
    step = TrainStep(tm, torch.optim.SGD(tm.parameters(), lr=1e-2),
                     lambda m, b: F.cross_entropy(m(b[0]), b[1]), numerics=True)
    step(tm, step.optimizer, tuple(torch.from_numpy(a) for a in _batch()))
    (got,) = tn.fetch_digests([step.last_digests])
    want = jn.tree_group_digest(dict(jm.named_parameters()), "params/")
    params = [s for s in got if s.startswith("params/")]
    assert sorted(params) == sorted(want)
    for site in params:
        _same(got[site], _jhost(want[site]), what=site)
    names = {s.split("/")[0] for s in got}
    assert names == {"params", "act", "loss", "grads"}
    assert sorted(s for s in got if s.startswith("act/")) == [
        "act/block0", "act/block1", "act/logits", "act/tok_emb"]
    assert got["loss"].count == 1
    assert TrainStep(tm, step.optimizer, step.loss_fn).last_digests is None


def _same_json(got, want, what):
    """One site's digest JSON, port against JAX: the integer fields and
    ``hist_hash`` exact, ``max_abs`` and rms to rtol 1e-5."""
    for f in ("nonfinite", "zeros", "count", "exp_hist", "hist_hash"):
        assert got[f] == want[f], (what, f)
    for f in ("max_abs", "rms"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-5, err_msg=f"{what} {f}")


def _same_trees(got, want, what):
    """A port step's digest trees against the JAX step's, step by step:
    the same sites in program order (``provenance_key``; jit hands JAX's
    dict back key-sorted), each site as :func:`_same_json`."""
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert (sorted(g, key=tn.provenance_key) == sorted(w, key=jn.provenance_key)), (what, i)
        for site in w:
            _same_json(g[site], w[site], f"{what} step {i} {site}")


@functools.lru_cache(maxsize=None)
def _jax_step(kind, n, poison=None, steps=2):
    """The JAX step of ``kind`` on ``n`` CPU devices, tiny Llama from
    :func:`_jax_llama`, SGD 1e-2 on :func:`_batch`: each step's digest tree
    as JSON, and the first step's comm audit.  ``fsdp``: ShardedTrainStep;
    ``gspmd_dp``: GSPMDTrainStep with the batch over ``dp``; ``gspmd_tp``:
    GSPMDTrainStep under ``llama_tp_plan``."""
    jm, _ = _jax_llama()

    def loss_fn(p, batch):
        return jF.cross_entropy(functional_call(jm, p, (batch[0],)), batch[1])

    params = dict(jm.named_parameters())
    if poison:
        params[poison] = params[poison] * jnp.float32(np.nan)
    mesh = jcreate_mesh({{"fsdp": "fsdp", "gspmd_dp": "dp"}.get(kind, "tp"): n},
                        devices=jax.devices()[:n])
    if kind == "fsdp":
        step = JShardedTrainStep(loss_fn, optax.sgd(1e-2), mesh, shard_axis="fsdp",
                                 numerics=True)
        params = step.shard_params(params)
    elif kind == "gspmd_dp":
        step = JGSPMDTrainStep(loss_fn, optax.sgd(1e-2), mesh, batch_spec=P("dp"),
                               numerics=True)
        params = jax.device_put(params, NamedSharding(mesh, P()))
    else:
        plan = jllama_tp_plan(mesh)
        step = JGSPMDTrainStep(loss_fn, optax.sgd(1e-2), mesh, plan=plan, numerics=True)
        params = plan.apply(params)
    opt = step.init_optimizer(params)
    batch = tuple(jnp.asarray(a) for a in _batch())
    trees, profile, book = [], None, jn.NumericsBook()
    for i in range(steps):
        with jcomm_audit() as prof:
            params, opt, _ = step(params, opt, batch)
        profile = profile or prof.to_json()
        host = jax.device_get(step.last_digests)
        book.update_tree(host, step=i)
        trees.append({site: _jhost(d).to_json() for site, d in host.items()})
    return trees, profile, book.first_nonfinite_site()


def test_one_rank_train_step_digests_equal_the_jax_step():
    """The one-rank ``TrainStep``'s whole digest tree, two steps, against
    the JAX GSPMD step on one device."""
    _, init = _jax_llama()
    tm = load_jax_params(TLlama.from_name("tiny", device="cpu"), init)
    step = TrainStep(tm, torch.optim.SGD(tm.parameters(), lr=1e-2),
                     lambda m, b: F.cross_entropy(m(b[0]), b[1]), numerics=True)
    batch = tuple(torch.from_numpy(a) for a in _batch())
    got = []
    for _ in range(2):
        step(tm, step.optimizer, batch)
        (tree,) = tn.fetch_digests([step.last_digests])
        got.append({site: d.to_json() for site, d in tree.items()})
    want, _, _ = _jax_step("gspmd_dp", 1)
    _same_trees(got, want, "TrainStep")


def test_trainer_harvests_and_names_the_poisoned_site():
    from torchdistx_tpu_torch.obs.flight import FlightRecorder
    from torchdistx_tpu_torch.utils.failure import FailureDetector

    _, init = _jax_llama()
    tm = load_jax_params(TLlama.from_name("tiny", device="cpu"), init)
    step = TrainStep(tm, torch.optim.SGD(tm.parameters(), lr=1e-2),
                     lambda m, b: F.cross_entropy(m(b[0]), b[1]), numerics=True)
    flight = FlightRecorder()
    tr = Trainer(step, log_every=1, log_fn=lambda m: None, flight=flight,
                 failure_detector=FailureDetector(), on_failure="continue")
    batch = tuple(torch.from_numpy(a) for a in _batch())
    tr.fit([batch] * 2, 2)
    assert tr.numerics_book.harvests == 1 and tr.numerics_book.first_nonfinite_site() is None
    with torch.no_grad():
        tm.get_parameter("blocks.1.mlp.w_up.weight").fill_(float("nan"))
    tr.fit([batch] * 2, 3)
    failure = next(e for e in flight.records() if e["kind"] == "failure")
    rollback = next(e for e in flight.records() if e["kind"] == "rollback")
    assert failure["nonfinite_site"] == rollback["nonfinite_site"] == "params/blocks.1"


def test_train_workload_numerics_no_longer_raises():
    w = build_train_workload("tiny", batch=2, seq=16, device="cpu", numerics=True)
    w["run"](2)
    book = w["trainer"].numerics_book
    assert book.harvests == 1 and {s.split("/")[0] for s in book.sites()} == {
        "params", "act", "loss", "grads"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    _, init = _jax_llama()
    payload = {"init": init, "batch": _batch(), "lr": 1e-2, "steps": 2,
               "poison": "blocks.0.attn.wk.weight"}
    out = {}
    for n in (1, 2):
        out[n] = spawn_world("numerics", tmp_path_factory.mktemp(f"numerics{n}"), payload,
                             world=n, timeout=240.0)
    return out


def _case(worlds, n, name):
    res = [r[name] for r in worlds[n]]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _ints(tree):
    return {s: {f: d[f] for f in ("nonfinite", "zeros", "count", "exp_hist", "hist_hash")}
            for s, d in tree.items()}


@pytest.mark.parametrize("name", ["fsdp", "gspmd_dp", "gspmd_tp"])
def test_train_step_digests_equal_at_world_1_and_2(worlds, name):
    """JAX's cross-mesh claim: the integer fields of every step's digests
    are the same at world 1 and world 2, on every rank, and in every step
    type; the first step's parameter digests are the JAX groups'."""
    ref = _case(worlds, 1, "fsdp")[0]["trees"]
    for n in (1, 2):
        for rank in _case(worlds, n, name):
            assert len(rank["trees"]) == 2
            for got, want in zip(rank["trees"], ref):
                assert list(got) == list(want)
                assert _ints(got) == _ints(want), (name, n)
                for s in got:
                    np.testing.assert_allclose(got[s]["max_abs"], want[s]["max_abs"], rtol=1e-5)
    jm, _ = _jax_llama()
    want = jn.tree_group_digest(dict(jm.named_parameters()), "params/")
    first = ref[0]
    for site, d in want.items():
        j = _jhost(d)
        assert first[site]["count"] == j.count and first[site]["hist_hash"] == j.hist_hash


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", ["fsdp", "gspmd_dp", "gspmd_tp"])
def test_sharded_train_step_digests_equal_the_jax_step(worlds, name, n):
    """Every rank's digest trees, both steps, against the JAX step of the
    same kind on as many devices: the activation digests folded over the
    batch, the gradient digests taken where JAX takes them."""
    want, _, _ = _jax_step(name, n)
    for rank in _case(worlds, n, name):
        _same_trees(rank["trees"], want, f"{name} world {n}")


def test_sharded_step_comm_audit_equals_jax(worlds):
    """The FSDP step's audit at world 2, the digests' ``psum`` (count 2)
    and ``pmax`` over the batch axis included, equals the JAX step's, and
    so do the digests that the audited collectives folded."""
    trees, want, _ = _jax_step("fsdp", 2)
    kinds = {e["kind"] for e in want["entries"]}
    assert {"psum", "pmax"} <= kinds
    for rank in _case(worlds, 2, "fsdp"):
        got = rank["profile"]
        assert got["entries"] == want["entries"]
        assert got["bytes_by_axis"] == want["bytes_by_axis"]
        _same_trees(rank["trees"], trees, "fsdp world 2")


def test_poisoned_parameter_is_named_at_every_world(worlds):
    _, _, jax_site = _jax_step("fsdp", 2, poison="blocks.0.attn.wk.weight", steps=1)
    assert jax_site == "params/blocks.0"
    for n in (1, 2):
        for rank in _case(worlds, n, "fsdp_poison"):
            assert rank["book"]["first_nonfinite_site"] == "params/blocks.0"
            assert rank["book"]["first_nonfinite_step"] == 0
            assert rank["trees"][0]["params/blocks.0"]["nonfinite"] == 64 * 64  # wk
            assert rank["trees"][0]["params/blocks.1"]["nonfinite"] == 0


def test_numerics_on_a_tp_engine_is_refused(worlds):
    """The name is that of the refusal the engine once raised, kept so that
    the test's record runs on.  What it checks now: over a ``gloo`` tp
    group a TP engine with numerics builds, serves and books the declared
    sites (the folded books: test_torch_serve_tp_numerics.py); only an
    NCCL tp group is still refused."""
    for rank in _case(worlds, 2, "tp_engine"):
        assert rank["refused"] is None
        assert rank["sites"] == ["logits", "kv_quant_err", "kv_quant_scale"]
        assert rank["logits_count"] > 0 and rank["errors"] == 0
