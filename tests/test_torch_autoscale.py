"""The port's open-loop traffic generator and autoscaler against the JAX
package's on the CPU.

``workload.generate`` must give the JAX request lists bit for bit for
every catalog scenario (arrival ticks, groups, prompts, budgets: integer
equality), since both draw from the same SHA-256 counter stream.  The
``AutoscaleController`` must make the JAX controller's decisions — tick,
action, mode, replica, reason, replica counts, sustain runs and cooldown —
on the same replayed signal vectors, and on a seeded scenario under the
default ``LoadSignal`` (whose pressure values are rounded to 6 places on
both sides and compared exactly).
"""

import numpy as np
import pytest
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.serve import AutoscaleController as JController
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu.serve import ServeFleet as JServeFleet
from torchdistx_tpu.serve import generate as jgenerate
from torchdistx_tpu.serve import replay_signal as jreplay
from torchdistx_tpu.serve import workload_counters as jworkload_counters
from torchdistx_tpu.utils.rng import next_host_uniform as j_uniform
from torchdistx_tpu.utils.rng import rng_scope as j_scope
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.serve import (
    SCENARIOS,
    AutoscaleController,
    ScalingPolicy,
    ServeEngine,
    ServeFleet,
    generate,
    replay_signal,
    scenario,
    workload_counters,
)
from torchdistx_tpu_torch.utils.rng import next_host_uniform, rng_scope

WARN = {"state": "warn"}
OK = {"state": "ok"}
POLICY = dict(min_replicas=1, max_replicas=3, up_sustain=2, down_sustain=4,
              up_cooldown=2, down_cooldown=4)


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(7)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return {"jax": jm, "torch": tm}


def test_host_uniform_stream_equals_jax():
    with j_scope(5):
        ref = [j_uniform() for _ in range(64)]
    with rng_scope(5):
        out = [next_host_uniform() for _ in range(64)]
    assert out == ref


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_generate_equals_jax_bit_for_bit(name):
    from torchdistx_tpu.serve import scenario as jscenario

    out, ref = generate(scenario(name)), jgenerate(jscenario(name))
    assert len(out) == len(ref) > 0
    for o, r in zip(out, ref):
        assert (o.index, o.arrival_tick, o.group, o.max_new_tokens, o.deadline_ticks) == (
            r.index, r.arrival_tick, r.group, r.max_new_tokens, r.deadline_ticks)
        assert o.prompt.dtype == r.prompt.dtype
        np.testing.assert_array_equal(o.prompt, r.prompt)
        assert o.submit_kwargs()["seed"] == r.submit_kwargs()["seed"]
    assert workload_counters(out) == jworkload_counters(ref)
    assert scenario(name).to_json() == jscenario(name).to_json()


def test_generate_leaves_the_ambient_stream_untouched():
    with rng_scope(123):
        u1 = next_host_uniform()
        generate(scenario("poisson"))
        u2 = next_host_uniform()
    with rng_scope(123):
        assert (u1, u2) == (next_host_uniform(), next_host_uniform())


def _engine(models, side, **kw):
    kw = dict(dict(num_slots=2, max_len=64, prefill_buckets=(32,), decode_chunk=4), **kw)
    if side == "jax":
        return JServeEngine(models["jax"], cost_cards=False, **kw)
    return ServeEngine(models["torch"], **kw)


def _controller(models, side, signal, *, n_start=1, policy=None):
    fleet_cls, ctrl_cls = ((JServeFleet, JController) if side == "jax"
                           else (ServeFleet, AutoscaleController))
    if side == "jax":
        from torchdistx_tpu.serve import ScalingPolicy as JPolicy

        pol = JPolicy(**(policy or POLICY))
    else:
        pol = ScalingPolicy(**(policy or POLICY))
    fleet = fleet_cls([_engine(models, side) for _ in range(n_start)])
    ctrl = ctrl_cls(fleet, pol, engine_factory=lambda role: _engine(models, side),
                    signal_fn=signal, flight=False)
    return fleet, ctrl


def _decision(d):
    sig = d["signal"]
    return (d["tick"], d["action"], d["mode"], d["replica"], d["role"], d["reason"],
            d["replicas_before"], d["replicas_after"], d["sustain"],
            d["cooldown_remaining"], d["policy"], sig["state"], sig.get("pressure"),
            sig["windows"], sig["headroom_ok"],
            [{k: v for k, v in r.items()} for r in sig["replicas"]])


VECTORS = {
    "oscillating": [WARN, OK] * 5,
    "up-fast-down-slow": [WARN] * 2 + [OK] * 8,
    "cooldown": [WARN] * 5,
    "cycle": ([WARN] * 3 + [OK] * 7) * 2,
}


@pytest.mark.parametrize("case", sorted(VECTORS))
def test_replay_decisions_equal_jax(models, case):
    vec = VECTORS[case]
    streams = {}
    for side, replay in (("jax", jreplay), ("torch", replay_signal)):
        fleet, ctrl = _controller(models, side, replay(vec),
                                  n_start=2 if case != "cooldown" else 1)
        decisions = []
        for _ in vec:
            fleet.step()
            decisions.append(_decision(ctrl.tick()))
        streams[side] = (decisions, dict(ctrl.counters), ctrl.metrics_json())
    assert streams["torch"] == streams["jax"]


def _open_loop(models, side, spec, policy):
    """Drive a seeded scenario open loop: each tick submits that tick's
    arrivals, steps the fleet, then lets the controller decide."""
    work = (generate if side == "torch" else jgenerate)(spec)
    # signal_fn=None: the controller's default LoadSignal
    fleet, ctrl = _controller(models, side, None, policy=policy)
    handles, decisions, k = [], [], 0
    for tick in range(spec.horizon_ticks + 24):
        while k < len(work) and work[k].arrival_tick == tick:
            handles.append(fleet.submit(**work[k].submit_kwargs()))
            k += 1
        fleet.step()
        decisions.append(_decision(ctrl.tick()))
        if k == len(work) and all(h.done() for h in handles):
            break
    assert all(h.done() for h in handles)  # no drop, scale-downs included
    return decisions, [h.result().tokens for h in handles], dict(ctrl.counters)


def test_load_signal_on_a_seeded_scenario_equals_jax(models):
    spec = scenario("flash_crowd", horizon_ticks=20, flash_tick=4, flash_len=5,
                    output_lens=(4, 6))
    policy = dict(POLICY, windows=(2, 4), up_threshold=0.9)
    ref = _open_loop(models, "jax", spec, policy)
    out = _open_loop(models, "torch", spec, policy)
    assert out[0] == ref[0]
    for a, b in zip(out[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    assert out[2] == ref[2]
    assert out[2]["autoscale_scale_ups"] >= 1
    # and the port's decision stream replays identically
    again = _open_loop(models, "torch", spec, policy)
    assert again[0] == out[0] and again[2] == out[2]


def test_controller_collector_text_equals_jax(models):
    from torchdistx_tpu.obs.metrics import MetricsRegistry as JRegistry
    from torchdistx_tpu_torch.obs.metrics import MetricsRegistry

    text = {}
    for side, replay, reg_cls in (("jax", jreplay, JRegistry),
                                  ("torch", replay_signal, MetricsRegistry)):
        fleet, ctrl = _controller(models, side, replay(VECTORS["cycle"]))
        for _ in VECTORS["cycle"]:
            fleet.step()
            ctrl.tick()
        reg = reg_cls()
        reg.register_collector(ctrl.collector(), obj=ctrl)
        text[side] = reg.render()
    assert text["torch"] == text["jax"]
