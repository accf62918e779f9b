"""The port's counted cost: ``ops._cost``'s one formula per kernel, the
counted cost card (``obs.cost.compute_cost_card`` / ``counted_card``),
``span_mfu``, ``default_book`` and ``utils.profiling.cost_summary``.

Every formula is held EXACTLY to ``FlopCounterMode``'s count of its
kernel's plain version at small shapes, in every variant: what the CPU
counts when the wrappers run their plain versions is what the card books
when they launch.  The cards and summaries are held against the JAX
package's on the same step and the same card values.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
import torchdistx_tpu_torch as tt
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.obs import cost as jcost
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.utils.profiling import cost_summary as jcost_summary
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.nn import functional as F
from torchdistx_tpu_torch.obs import cost
from torchdistx_tpu_torch.ops import _cost
from torchdistx_tpu_torch.ops import decode_attention as da
from torchdistx_tpu_torch.ops import flash_attention as fa
from torchdistx_tpu_torch.ops import fused_ce as fce
from torchdistx_tpu_torch.utils.profiling import cost_summary


def _counted(fn, *args, **kw):
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kw)
    return counter.get_total_flops()


def _qkv(b, sq, skv, hq, hkv, d, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=g)
    k = torch.randn(b, skv, hkv, d, generator=g)
    v = torch.randn(b, skv, hkv, d, generator=g)
    if grad:
        for t in (q, k, v):
            t.requires_grad_(True)
    return q, k, v


BUCKET_CFG = (8, 16, False)
# (b, sq, skv, hq, hkv, d, causal): square and rectangular, MHA and GQA
FWD_SHAPES = [(2, 8, 8, 4, 2, 16, True), (1, 5, 9, 4, 4, 8, True), (2, 6, 6, 2, 1, 8, False)]


def _bias_kw(mode, hq, sq, skv, seed=1):
    g = torch.Generator().manual_seed(seed)
    if mode == "bias":
        return dict(bias=torch.randn(hq, sq, skv, generator=g))
    if mode == "table":
        return dict(table=torch.randn(hq, BUCKET_CFG[0], generator=g), bucket_cfg=BUCKET_CFG)
    return {}


def _fwd_variants():
    """Every forward variant the kernel takes at each shape: the bucket
    table needs Sq == Skv, the window causal, the residuals neither."""
    for shape in FWD_SHAPES:
        _, sq, skv, *_, causal = shape
        for mode in (None, "bias", "table", "window"):
            if mode == "table" and sq != skv or mode == "window" and not causal:
                continue
            for out in ("plain", "lse", "residuals"):
                if not (out == "residuals" and mode in ("table", "window")):
                    yield shape, mode, out


@pytest.mark.parametrize("shape,mode,out", list(_fwd_variants()))
def test_flash_forward_formula_counts_its_plain_version(shape, mode, out):
    b, sq, skv, hq, hkv, d, causal = shape
    q, k, v = _qkv(b, sq, skv, hq, hkv, d)
    kw = dict(causal=causal, **_bias_kw(mode, hq, sq, skv))
    if mode == "window":
        kw["window"] = 3
    ref = {"plain": fa.flash_attention_reference, "lse": fa.flash_attention_lse_reference,
           "residuals": fa.flash_attention_residuals_reference}[out]
    want = _cost.flash_fwd(b, sq, skv, hq, hkv, d, out=out,
                           bias=mode if mode in ("bias", "table") else None,
                           buckets=BUCKET_CFG[0]).flops
    assert _counted(ref, q, k, v, **kw) == want


BWD_SHAPES = [(2, 8, 4, 2, 16), (1, 13, 4, 4, 8)]


def _bwd_inputs(b, s, hq, hkv, d, mode, causal=True, window=None):
    q, k, v = _qkv(b, s, s, hq, hkv, d)
    kw = dict(causal=causal, **_bias_kw(mode, hq, s, s))
    if window:
        kw["window"] = window
    o, lse = fa.flash_attention_lse_reference(q, k, v, **kw)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(2))
    return (q, k, v, o, lse, do), kw


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("mode", [None, "bias", "table", "window"])
@pytest.mark.parametrize("f32", [False, True])
def test_flash_backward_formulas_count_its_plain_version(shape, mode, f32):
    """Rows 2-3: dK/dV's formula plus dQ's is the plain backward's count,
    in every variant (the f32 partials multiply the same)."""
    b, s, hq, hkv, d = shape
    args, kw = _bwd_inputs(b, s, hq, hkv, d, mode, window=3 if mode == "window" else None)
    dt = dict(dq_dtype=torch.float32, part_dtype=torch.float32) if f32 else {}
    bias = mode if mode in ("bias", "table") else None
    want = (_cost.flash_bwd_dkv(b, s, hq, hkv, d, bias=bias, buckets=BUCKET_CFG[0]).flops
            + _cost.flash_bwd_dq(b, s, hq, hkv, d, bias=bias, buckets=BUCKET_CFG[0]).flops)
    assert _counted(fa.flash_bwd_reference, *args, **kw, **dt) == want
    assert _counted(fa.flash_bwd_delta_reference, args[3], args[5]) == 0 == \
        _cost.flash_bwd_delta(b, s, hq, d).flops


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["bias", "table"])
def test_bias_and_table_gradient_formulas_count_their_plain_version(shape, causal, mode):
    """Rows 4-5: the dbias and dtable kernels' plain version."""
    b, s, hq, hkv, d = shape
    args, kw = _bwd_inputs(b, s, hq, hkv, d, mode, causal=causal)
    want = (_cost.flash_bwd_dbias(b, s, hq, hkv, d) if mode == "bias"
            else _cost.flash_bwd_dtable(b, s, hq, hkv, d, BUCKET_CFG[0])).flops
    assert _counted(fa.flash_bias_grad_reference, *args, **kw) == want


@pytest.mark.parametrize("mode", [None, "bias", "table", "window"])
def test_the_cpu_flash_path_counts_the_kernels_the_card_launches(mode):
    """``flash_attention`` with its gradient on CPU tensors: the lse
    forward, dK/dV, dQ and (with a bias or table) its gradient, exactly the
    formulas of the launches the card makes for the same call."""
    b, s, hq, hkv, d = 2, 8, 4, 2, 16
    q, k, v = _qkv(b, s, s, hq, hkv, d, grad=True)
    extra = _bias_kw(mode, hq, s, s)
    kw = {}
    if mode == "bias":
        kw["bias"] = extra["bias"].requires_grad_(True)
    elif mode == "table":
        kw.update(rel_bias_table=extra["table"].requires_grad_(True),
                  rel_bias_buckets=BUCKET_CFG[0], rel_bias_max_dist=BUCKET_CFG[1])
    elif mode == "window":
        kw["window"] = 3

    def run():
        fa.flash_attention(q, k, v, **kw).sum().backward()

    bias = mode if mode in ("bias", "table") else None
    want = (_cost.flash_fwd(b, s, s, hq, hkv, d, out="lse", bias=bias).flops
            + _cost.flash_bwd_dkv(b, s, hq, hkv, d, bias=bias).flops
            + _cost.flash_bwd_dq(b, s, hq, hkv, d, bias=bias).flops)
    if mode == "bias":
        want += _cost.flash_bwd_dbias(b, s, hq, hkv, d).flops
    elif mode == "table":
        want += _cost.flash_bwd_dtable(b, s, hq, hkv, d, BUCKET_CFG[0]).flops
    with _cost.tally() as kernels:
        assert _counted(run) == want
    assert kernels.flops == 0 and kernels.launches == {}  # CPU tensors launch nothing


def test_the_cpu_backward_keeps_the_bias_gradients_bits():
    """The CPU backward takes the bias's and the table's gradient from
    their own plain version: the same bits as the fused plain backward's."""
    for mode in ("bias", "table"):
        args, kw = _bwd_inputs(2, 8, 4, 2, 16, mode)
        fused = fa.flash_bwd_reference(*args, **kw)
        split = fa.flash_backward(*args, **kw)
        for a, b in zip(fused, split):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n,d,v", [(7, 16, 40), (12, 8, 300)])
def test_fused_ce_formulas_count_their_plain_versions(n, d, v):
    """Rows 6-8: the forward; the backward in one chunk and in several."""
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(n, d, generator=g), torch.randn(v, d, generator=g)
    labels = torch.randint(0, v, (n,), generator=g)
    assert _counted(fce.fused_ce_fwd_reference, x, w, labels) == _cost.fused_ce_fwd(n, d, v).flops
    _, lse = fce.fused_ce_fwd_reference(x, w, labels)
    for chunk in (None, 16):
        got = _counted(fce.fused_ce_bwd_reference, x, w, labels, lse, torch.ones(()), chunk=chunk)
        assert got == _cost.fused_ce_bwd(n, d, v).flops


def _cache(b, rows, hkv, d, int8, seed=3):
    g = torch.Generator().manual_seed(seed)
    ck, cv = (torch.randn(b, rows, hkv, d, generator=g) for _ in range(2))
    if not int8:
        return dict(ck=ck, cv=cv)
    from torchdistx_tpu_torch.serve.kv_cache import quantize_kv

    (kc, ks), (vc, vs) = quantize_kv(ck), quantize_kv(cv)
    return dict(ck=kc, cv=vc, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_formulas_count_their_plain_versions(s, int8, paged):
    """Rows 9-12: slab or paged, one token or a verify block, bf16 or int8."""
    b, hq, hkv, d, max_len, ps = 3, 4, 2, 8, 24, 4
    g = torch.Generator().manual_seed(1)
    q = torch.randn(b, s, hq, d, generator=g)
    positions = torch.tensor([0, 9, 20])
    if paged:
        pp = max_len // ps
        pools = _cache(1, b * pp + 1, hkv, d, int8)
        pools = {k: t.reshape(b * pp + 1, 1, hkv, -1).repeat_interleave(ps, 1)
                 .reshape(-1, ps, hkv, t.shape[-1])[:b * pp + 1] for k, t in pools.items()}
        tables = torch.randperm(b * pp, generator=g).reshape(b, pp) + 1
        ref = (da.paged_decode_attention_reference if s == 1
               else da.paged_decode_attention_block_reference)
        got = _counted(lambda: ref(q, pools.pop("ck"), pools.pop("cv"), tables, positions,
                                   **pools))
        want = _cost.paged_decode_attention(b, s, hq, hkv, d, pp, ps, int8=int8)
    else:
        cache = _cache(b, max_len, hkv, d, int8)
        ref = da.decode_attention_reference if s == 1 else da.decode_attention_block_reference
        got = _counted(lambda: ref(q, cache.pop("ck"), cache.pop("cv"), positions, **cache))
        want = _cost.decode_attention(b, s, hq, hkv, d, max_len, int8=int8)
    assert got == want.flops


def test_launch_bytes_are_the_bound_columns_operands():
    """The bytes of a launch are the operands ``PERF.md`` §6's bound column
    lists (here at one shape each)."""
    assert _cost.flash_fwd(1, 4, 4, 2, 2, 8).bytes == 2 * 4 * (4 * 2 * 8)
    assert _cost.flash_fwd(1, 4, 4, 2, 2, 8, out="lse").bytes == 2 * 4 * 64 + 4 * 8
    assert _cost.fused_ce_fwd(3, 8, 10).bytes == 2 * (24 + 80) + 12 * 3
    assert _cost.fused_ce_bwd(3, 8, 10).bytes == 4 * (24 + 80) + 8 * 3 + 6 * 30
    # int8 rows carry their f32 scales; pages their int32 tables
    assert (_cost.decode_attention(2, 1, 4, 2, 8, 16, int8=True).bytes
            == 2 * 2 * 2 * 4 * 8 + 4 * 2 + 2 * 16 * 2 * 2 * (8 + 4))
    assert (_cost.paged_decode_attention(2, 1, 4, 2, 8, 4, 4).bytes
            == _cost.decode_attention(2, 1, 4, 2, 8, 16).bytes + 4 * 2 * 4)


def test_tallies_add_what_is_booked_while_open():
    with _cost.tally() as outer:
        _cost.book("flash_fwd_cuda", _cost.Cost(10, 3))
        with _cost.tally() as inner:
            _cost.book("fused_ce_bwd_cuda", _cost.Cost(5, 1))
    _cost.book("flash_fwd_cuda", _cost.Cost(7, 1))  # none open: nothing counts
    assert (outer.flops, inner.flops) == (15, 5)
    assert (outer.bytes, inner.bytes) == (4, 1)
    assert outer.launches == {"flash_fwd_cuda": 1, "fused_ce_bwd_cuda": 1}
    assert inner.launches == {"fused_ce_bwd_cuda": 1}


@pytest.mark.parametrize("m,k,n", [(4, 8, 16), (3, 5, 7)])
def test_counted_bytes_of_a_matmul_and_an_add_are_the_closed_form(m, k, n):
    """``x @ w + b`` in f32: the product reads x and w and writes y, the add
    reads y and b and writes z; the transpose of a view and a detach move
    nothing; a booked launch adds its own bytes."""
    g = torch.Generator().manual_seed(0)
    x, w, b = (torch.randn(*s, generator=g) for s in ((m, k), (n, k), (n,)))

    def body():
        y = x @ w.t().detach()
        return y + b

    with cost.counted_card("body") as card:
        z = body()
    want = 4 * (m * k + k * n + m * n) + 4 * (m * n + n + m * n)
    assert card.bytes_accessed == want
    assert card.flops == 2 * m * k * n
    np.testing.assert_array_equal(z.numpy(), (x @ w.t() + b).numpy())
    with cost.counted_card("body+launch") as card:
        body()
        _cost.book("flash_fwd_cuda", _cost.Cost(11, 13))
    assert card.bytes_accessed == want + 13 and card.flops == 2 * m * k * n + 11
    assert cost.validate_cost_card(card.to_json()) == [
        "card: peak_bytes source not named ('unavailable')"]


def test_a_counted_card_needs_its_bytes_as_jax_cards_do():
    card = cost.CostCard(program="step", flops=8.0, peak_bytes=1, peak_source="cuda_allocator",
                         flops_source=cost.COUNTED_FLOPS)
    assert cost.validate_cost_card(card.to_json()) == ["card: missing bytes_accessed"]
    card.bytes_accessed = 4.0
    assert cost.validate_cost_card(card.to_json()) == []
    # an allocator card that nothing counted keeps its nulls
    assert cost.validate_cost_card(cost.CostCard(
        program="serve/decode", peak_bytes=1, peak_source="cuda_allocator").to_json()) == []


@pytest.mark.parametrize("source", ["xla_peak", "arg+out+temp", "cuda_allocator", "unavailable"])
def test_counter_fields_keys_equal_jax(source):
    """The same fields filled: JAX's keys, except that on an allocator card
    ``temp_bytes`` is a runtime watermark and never gates."""
    kw = dict(program="p", flops=1.0e9, bytes_accessed=2.0e6, transcendentals=3.0,
              arg_bytes=4, out_bytes=5, temp_bytes=6, peak_bytes=7, peak_source=source)
    got, want = cost.CostCard(**kw).counter_fields(), jcost.CostCard(**kw).counter_fields()
    if source == "cuda_allocator":
        assert want.pop("cost_temp_bytes") == 6
    assert got == want
    assert ("cost_peak_bytes" in got) == (source in ("xla_peak", "arg+out+temp"))
    assert cost.CostCard(program="q").counter_fields() == jcost.CostCard(
        program="q").counter_fields() == {}


# -- the counted card against the JAX package's --------------------------------

# a width at which the matrix products dominate the step: XLA's count also
# holds every elementwise op (norms, RoPE, SiLU, softmax, the optimizer's
# update), which FlopCounterMode does not count, so the port's count is the
# smaller by that share, a few per cent here
WIDE = dict(dim=256, n_layers=2, n_heads=4, vocab_size=1024, max_seq_len=64)
COUNT_RTOL = 0.05


def _batch(b=4, s=64, vocab=1024, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (b, s)).astype(np.int32),
            rs.randint(0, vocab, (b, s)).astype(np.int32))


@pytest.fixture(scope="module")
def wide_cards():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny", use_flash=False, **WIDE)
    tdx.materialize_module(jm)
    params = dict(jm.named_parameters())
    tx = anyprecision_adamw(1e-3, variance_dtype=jnp.float32)

    def step(p, s, b):
        loss, g = jax.value_and_grad(
            lambda p: jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1]))(p)
        u, s = tx.update(g, s, p)
        return jax.tree_util.tree_map(lambda a, d: a + d, p, u), s, loss

    batch = _batch()
    jcard = jcost.compute_cost_card(step, params, tx.init(params),
                                    tuple(jnp.asarray(x) for x in batch), name="step")
    tt.manual_seed(0)
    tm = tt.deferred_init(TLlama.from_name, "tiny", device="cpu", use_flash=False, **WIDE)
    tt.materialize_module(tm)
    load_jax_params(tm, {k: np.asarray(v) for k, v in params.items()})
    opt = tt.AnyPrecisionAdamW(tm.parameters(), lr=1e-3, variance_dtype=torch.float32)
    tstep = tt.TrainStep(tm, opt, lambda m, b: F.cross_entropy(m(b[0]), b[1]))
    tb = tuple(torch.from_numpy(x).long() for x in batch)
    book = cost.CostBook()
    tcard = cost.compute_cost_card(tstep, tm, opt, tb, name="step", book=book)
    return dict(jcard=jcard, tcard=tcard, book=book, tstep=tstep, model=tm)


def test_counted_step_flops_match_jax_within_the_elementwise_share(wide_cards):
    j, t = wide_cards["jcard"], wide_cards["tcard"]
    assert t.flops_source == cost.COUNTED_FLOPS == "flop_counter+kernels"
    assert t.kernel_flops == 0.0 and t.kernel_launches == {}  # CPU: plain versions
    # counted, never invented: every aten op's tensor bytes (views none)
    assert isinstance(t.bytes_accessed, float) and t.bytes_accessed > 0
    assert t.flops <= j.flops  # XLA counts the elementwise ops too
    assert t.flops == pytest.approx(j.flops, rel=COUNT_RTOL)
    assert wide_cards["book"].get("step") is t
    assert len(wide_cards["tstep"].losses) == 1  # the card executed the step once
    assert cost.validate_cost_card(t.to_json()) == [
        "card: peak_bytes source not named ('unavailable')"]  # no allocator on the CPU


def test_counted_step_flops_are_the_closed_form(wide_cards):
    """6 FLOPs a parameter a token for every matrix product's weight (the
    embedding is a gather: none), and the plain attention's 12 L dim seq a
    token: the count is exact."""
    m, cfg = wide_cards["model"], wide_cards["model"].cfg
    b, s = 4, 64
    weights = sum(p.numel() for n, p in m.named_parameters()
                  if p.dim() == 2 and not n.startswith("tok_emb"))
    want = b * s * (6 * weights + 12 * cfg.n_layers * cfg.dim * s)
    assert wide_cards["tcard"].flops == want


def test_a_counted_step_keeps_its_bits_and_counts_what_flop_counter_mode_counts():
    """The card counts by ``FlopCounterMode``'s per-op formulas but runs
    every op as dispatched: ``FlopCounterMode`` itself decomposes
    ``silu_backward``, which changes the step's bits (the 8-bit AdamW, the
    fused loss and the numerics taps here, as phase 30 (e) trains)."""
    from torchdistx_tpu_torch.utils.benchmarks import build_train_workload

    def params_after(mode):
        w = build_train_workload("tiny", batch=2, seq=32, device="cpu", optimizer="adamw_8bit",
                                 fused_ce=True, numerics=True)
        args = (w["model"], w["optimizer"], w["batch"])
        if mode == "card":
            with cost.counted_card("step", device="cpu") as card:
                w["step"](*args)
            counted = card.flops
        elif mode == "flop_counter":
            counted = _counted(w["step"], *args)
        else:
            w["step"](*args)
            counted = None
        return counted, {n: p.detach().clone() for n, p in w["model"].named_parameters()}

    _, plain = params_after(None)
    flops, carded = params_after("card")
    fcm_flops, _ = params_after("flop_counter")
    assert flops == fcm_flops > 0
    assert all(torch.equal(plain[n], carded[n]) for n in plain)


def test_span_mfu_and_default_book_behave_as_jax():
    for flops, execs, secs, peak in ((2e12, 10, 4.0, 989e12), (None, 1, 1.0, 1e12),
                                     (1e9, 0, 1.0, 1e12), (1e9, 3, None, 1e12),
                                     (1e9, 3, 2.0, None)):
        got = cost.span_mfu(cost.CostCard("p", flops=flops), executions=execs, seconds=secs,
                            peak_flops=peak)
        want = jcost.span_mfu(jcost.CostCard("p", flops=flops), executions=execs,
                              seconds=secs, peak_flops=peak)
        assert got == want
    assert cost.default_book() is cost.default_book()
    assert isinstance(cost.default_book(), cost.CostBook)
    assert jcost.default_book() is jcost.default_book()


def test_cost_summary_keys_equal_jax():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    w = np.ones((4, 5), np.float32)
    for peak in (None, 1e12):
        kw = {} if peak is None else dict(peak_flops=peak)
        got = cost_summary(lambda a, b: a @ b, torch.from_numpy(x), torch.from_numpy(w), **kw)
        want = jcost_summary(lambda a, b: a @ b, jnp.asarray(x), jnp.asarray(w), **kw)
        assert sorted(got) == sorted(want)
        assert got["flops"] == want["flops"] == 2 * 3 * 4 * 5


def test_counted_card_counts_a_train_step_under_the_trainer(monkeypatch):
    """``Trainer(cost_card=True)`` counts its first real step: no extra
    execution, the card in ``default_book()``.  (The suite's conftest
    turns cards off with ``TDX_COST_CARDS=0``.)"""
    monkeypatch.delenv("TDX_COST_CARDS", raising=False)
    tt.manual_seed(0)
    m = TLlama.from_name("tiny", device="cpu")
    opt = tt.AnyPrecisionAdamW(m.parameters(), lr=1e-3)
    step = tt.TrainStep(m, opt, lambda mm, b: F.cross_entropy(mm(b[0]), b[1]))
    tb = tuple(torch.from_numpy(x).long() for x in _batch(2, 32, 256))
    tr = tt.Trainer(step, log_every=1, log_fn=lambda m: None, cost_card=True)
    tr.fit(itertools.repeat(tb), 2)
    assert len(step.losses) == 2
    assert tr.cost_card is cost.default_book().get("trainer/step")
    assert tr.cost_card.flops > 0 and tr.cost_card.platform == "cpu"


def test_format_memory_stats_equals_jax():
    from torchdistx_tpu.utils.profiling import format_memory_stats as jformat

    from torchdistx_tpu_torch.utils.profiling import format_memory_stats

    stats = {"cuda:0": {"bytes_in_use": 3.5e9, "peak_bytes_in_use": 7e9, "bytes_limit": 80e9},
             "cpu": {}}
    assert format_memory_stats(stats) == jformat(stats)
    assert format_memory_stats() == "cpu: (no memory stats)"  # no card here


def test_trace_writes_a_chrome_trace(tmp_path):
    from torchdistx_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8, 2)
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    assert "traceEvents" in path.read_text()


def test_warm_to_steady_state_stops_at_the_first_call_that_sets_up_nothing():
    """The JAX helper's contract: ``(carry, warm_times, converged)``; a
    call that notes a new program (``obs.recompile``) or captures a CUDA
    graph is not steady."""
    from torchdistx_tpu_torch.obs.recompile import RecompileWatcher, note_compile
    from torchdistx_tpu_torch.serve.graph_loop import GraphLoop
    from torchdistx_tpu_torch.utils.benchmarks import warm_to_steady_state

    def run_settling(carry):  # programs on the first two calls, then none
        if carry < 2:
            note_compile()
        return carry + 1, carry

    carry, times, ok = warm_to_steady_state(run_settling, 0, lambda aux: None)
    assert (carry, len(times), ok) == (3, 3, True)

    def run_capturing(carry):  # a new graph every call: never steady
        GraphLoop.captures_total += 1
        return carry + 1, None

    carry, times, ok = warm_to_steady_state(run_capturing, 0, lambda aux: None, max_calls=4)
    assert (carry, len(times), ok) == (4, 4, False)

    with RecompileWatcher() as watcher:
        warm_to_steady_state(run_settling, 0, lambda aux: None, watcher=watcher, label="warm")
    assert watcher.counts == {"warm": 2}
