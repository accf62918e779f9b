"""Numerics under tensor-parallel serving: ``ServeEngine(numerics=True,
mesh=)`` on two ``gloo`` ranks against the whole tensors and the JAX
engine's book on a ``{"tp": 2}`` CPU mesh.

The port runs in ONE spawned world of two ranks (the ``serve_tp_numerics``
suite of ``tests/_torch_dist_worker.py``, its own 240 s deadline), tiny
f32 Llama with 2 KV heads (one a rank) and the JAX model's weights, each
of a bf16 slab chunked, a paged int8 cache chunked and the same persistent
(eager on the CPU), with numerics on and off.  Held:

- the partition identity: each rank's folded KV digest (the int8
  dequantization error and the scales) equals the digest of the whole
  tensors, every tap all-gathered over ``tp`` in the worker: integer
  fields and ``max_abs`` exact, ``sumsq`` within 1e-5 relative;
- the two ranks' books are equal, and ``logits.count`` is the closed form
  (a vocabulary row a prefill, every slot's row a decode step): the
  gathered logits digested once, not summed over the ranks;
- numerics changes no stream, no ``ServeMetrics`` counter and no row of
  the comm audit (the fold books nothing);
- the JAX engine with ``numerics=True`` on a two-device ``tp`` mesh lists
  the same sites with the same ``count`` a site.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import (TP_NUMERICS_FOLDED, TP_NUMERICS_KW, TP_NUMERICS_RUNS,
                                digest_fields, spawn_world, tp_numerics_requests)
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.serve import ServeEngine as JServeEngine

RUNS = sorted(TP_NUMERICS_RUNS)
SUMSQ_RTOL = 1e-5


@pytest.fixture(scope="module")
def jmodel():
    tdx.manual_seed(0)
    return JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)


@pytest.fixture(scope="module")
def world(tmp_path_factory, jmodel):
    weights = {n: np.asarray(v) for n, v in jmodel.named_parameters()}
    return spawn_world("serve_tp_numerics", tmp_path_factory.mktemp("serve_tp_numerics"),
                       {"weights": weights}, world=2, timeout=240.0)


def _ranks(world, run):
    out = [r[run] for r in world]
    for r in out:
        assert "error" not in r, r["error"]
    return out


def _zero():
    return (0, 0, 0, (0,) * 32, 0.0, 0.0)


@pytest.mark.parametrize("run", RUNS)
def test_folded_kv_digests_equal_the_gathered_whole_tensors(world, run):
    int8 = TP_NUMERICS_RUNS[run].get("kv_dtype") == "int8"
    for rank in _ranks(world, run):
        on = rank["on"]
        assert on["errors"] == 0
        for site in TP_NUMERICS_FOLDED:
            got, want = on["book"][site], on["whole"].get(site, _zero())
            assert got[:4] == want[:4], (run, site)  # nonfinite, zeros, count, buckets
            assert got[4] == want[4], (run, site)  # max_abs
            assert got[5] == pytest.approx(want[5], rel=SUMSQ_RTOL, abs=0.0), (run, site)
            assert bool(got[2]) == int8, (run, site)
        if int8:
            err, scale = on["book"]["kv_quant_err"], on["book"]["kv_quant_scale"]
            assert err[4] <= 0.5 * scale[4]  # the round-to-nearest bound, folded
            assert on["kv_quant_err_max"] == err[4]


@pytest.mark.parametrize("run", RUNS)
def test_both_ranks_hold_one_book_with_the_closed_form_logits_count(world, run):
    a, b = (r["on"] for r in _ranks(world, run))
    assert a["sites"] == b["sites"] == ["logits", "kv_quant_err", "kv_quant_scale"]
    assert a["book"] == b["book"]
    c = a["counters"]
    vocab = 256
    assert a["book"]["logits"][2] == vocab * (
        c["prefill_calls"] + TP_NUMERICS_KW["num_slots"] * c["decode_steps"])


@pytest.mark.parametrize("run", RUNS)
def test_numerics_changes_no_stream_counter_or_audit_row(world, run):
    for rank in _ranks(world, run):
        on, off = rank["on"], rank["off"]
        for x, y in zip(on["tokens"], off["tokens"]):
            np.testing.assert_array_equal(x, y)
        assert on["counters"] == off["counters"]
        assert on["profile"]["entries"] == off["profile"]["entries"]
        assert on["profile"]["bytes_by_axis"] == off["profile"]["bytes_by_axis"]
        assert off["sites"] == []


@pytest.mark.parametrize("run", RUNS)
def test_jax_tp_engine_lists_the_same_sites_and_counts(world, jmodel, run):
    eng = JServeEngine(jmodel, mesh=Mesh(np.asarray(jax.devices()[:2]), ("tp",)),
                       numerics=True, **TP_NUMERICS_KW, **TP_NUMERICS_RUNS[run])
    res = eng.run(tp_numerics_requests())
    book = eng.numerics_book
    for rank in _ranks(world, run):
        on = rank["on"]
        for x, y in zip(on["tokens"], res):
            np.testing.assert_array_equal(x, np.asarray(y.tokens))
        assert on["sites"] == book.sites()
        for site in book.sites():
            assert on["book"][site][2] == digest_fields(book.digest(site))[2], (run, site)
