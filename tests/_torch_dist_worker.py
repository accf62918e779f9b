"""The ranks of the port's multi-rank CPU tests.

``spawn_world(suite, tmp_path, payload)`` starts one ``gloo`` world of 4
processes (``spawn``, a ``FileStore`` in ``tmp_path``, one thread each),
runs every case of ``suite`` on every rank, and returns each rank's
``{case: result}`` (numpy arrays, or ``{"error": traceback}``).  A world
that does not finish within ``timeout`` seconds is killed and raises, so a
hung collective fails the tests instead of stalling the run.

This module imports torch, numpy and the port only: the JAX side of each
comparison runs in the parent.  The inputs are made here from seeds with
numpy, so both sides can make the same ones.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np

WORLD = 4


def spawn_world(suite: str, tmp_path, payload=None, world: int = WORLD,
                timeout: float = 120.0) -> list:
    ctx = mp.get_context("spawn")
    store = os.path.join(str(tmp_path), f"store-{suite}")
    procs = [ctx.Process(target=_main, args=(r, world, store, str(tmp_path), suite, payload))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    if hung:
        raise TimeoutError(f"{suite}: {len(hung)} ranks still running after {timeout} s")
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(str(tmp_path), f"{suite}-{r}.pkl")
        if p.exitcode != 0 or not os.path.exists(path):
            raise RuntimeError(f"{suite}: rank {r} exited with {p.exitcode}")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _main(rank, world, store_path, out_dir, suite, payload):
    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch.parallel import init_multihost

    torch.set_num_threads(1)
    init_multihost(num_processes=world, process_id=rank, device="cpu",
                   store=dist.FileStore(store_path, world), timeout_s=90)
    results = {}
    try:
        for name, case in SUITES[suite](payload):
            try:
                results[name] = case()
            except Exception:
                results[name] = {"error": traceback.format_exc()}
    finally:
        with open(os.path.join(out_dir, f"{suite}-{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_np(v) for v in t)
    return t


# -- inputs, shared with the parent -------------------------------------------------


def coll_input(seed: int, shape=(2, 8), world: int = WORLD) -> np.ndarray:
    """Rank r's operand of a collective case: (world, *shape), row r."""
    return np.random.RandomState(seed).randn(world, *shape).astype(np.float32)


def attn_inputs(b, s, hq, hkv, d, seed=0, bias=False):
    """Global q, k, v (and a (hq, s, s) bias), f32."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for h in (hq, hkv, hkv))
    out = [q, k, v]
    if bias:
        out.append((0.5 * rs.randn(hq, s, s)).astype(np.float32))
    return out


RING_CASES = [(4, 4, True), (8, 2, True), (4, 4, False)]
RING_SHAPE = dict(b=2, s=64, d=8)


def lm_batch(b, s, vocab=256, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (b, s)).astype(np.int64),
            rs.randint(0, vocab, (b, s)).astype(np.int64))


# -- the suites ---------------------------------------------------------------------


def _collectives(payload):
    import torch

    from torchdistx_tpu_torch.parallel import collectives as C
    from torchdistx_tpu_torch.parallel import create_mesh

    import torch.distributed as dist

    rank = dist.get_rank()
    sp = create_mesh({"sp": WORLD})
    grid = create_mesh({"dp": 2, "sp": 2})

    def x(seed, shape=(2, 8)):
        return torch.from_numpy(coll_input(seed, shape)[rank])

    def on(mesh, fn):
        def case():
            with mesh:
                return _np(fn())
        return case

    def vjp(fn, seed):
        def case():
            with sp:
                a = x(seed).requires_grad_()
                y = fn(a, "sp")
                ct = torch.from_numpy(coll_input(seed + 100)[rank])
                (g,) = torch.autograd.grad(y, a, ct)
                return {"y": _np(y), "g": _np(g)}
        return case

    send_ring = [1, 2, 3, 0]
    send_partial = [2, -1, 0, -1]
    recv_partial = [2, -1, 0, -1]
    yield "all_reduce", on(sp, lambda: C.all_reduce(x(0), "sp"))
    yield "all_mean", on(sp, lambda: C.all_mean(x(1), "sp"))
    yield "broadcast", on(sp, lambda: C.broadcast(x(2), "sp", source=2))
    yield "exchange_ring", on(sp, lambda: C.exchange(x(3), "sp", send_ring, [3, 0, 1, 2]))
    yield "exchange_self", on(sp, lambda: C.exchange(x(4), "sp", send_partial, recv_partial))
    yield "exchange_zero", on(sp, lambda: C.exchange(x(4), "sp", send_partial, recv_partial,
                                                     fill="zero"))
    yield "shift_1", on(sp, lambda: C.shift(x(5), "sp"))
    yield "shift_m1", on(sp, lambda: C.shift(x(5), "sp", -1))
    yield "all_gather_0", on(sp, lambda: C.all_gather(x(6), "sp"))
    yield "all_gather_1", on(sp, lambda: C.all_gather(x(6), "sp", tiled_axis=1))
    yield "reduce_scatter_0", on(sp, lambda: C.reduce_scatter(x(7, (8, 4)), "sp"))
    yield "reduce_scatter_1", on(sp, lambda: C.reduce_scatter(x(7), "sp", scatter_axis=1))
    yield "axis_index_size", on(sp, lambda: np.array([C.axis_index("sp"), C.axis_size("sp")]))
    yield "tree", on(sp, lambda: C.all_reduce({"a": x(8), "b": [x(9), x(10)]}, "sp"))
    yield "allreduce_linear", vjp(C.allreduce_linear, 11)
    yield "copy_psum_grad", vjp(C.copy_psum_grad, 12)
    yield "grid_all_reduce_dp", on(grid, lambda: C.all_reduce(x(13), "dp"))
    yield "grid_all_mean_both", on(grid, lambda: C.all_mean(x(14), ("dp", "sp")))
    yield "grid_shift_sp", on(grid, lambda: C.shift(x(15), "sp"))
    yield "grid_all_gather_dp", on(grid, lambda: C.all_gather(x(16), "dp"))
    yield "grid_reduce_scatter_sp", on(grid, lambda: C.reduce_scatter(x(17, (4, 8)), "sp"))
    yield "grid_broadcast_dp", on(grid, lambda: C.broadcast(x(18), "dp", source=1))
    yield "grid_axis_index", on(grid, lambda: np.array([C.axis_index("dp"), C.axis_index("sp")]))

    def mesh_helpers():
        from torchdistx_tpu_torch.parallel import hierarchical_mesh, mesh_sharding, replicated
        from torchdistx_tpu_torch.parallel.mesh import local_mesh_size

        hier = hierarchical_mesh(2)
        wild = create_mesh({"dp": -1, "sp": 2})
        cut = mesh_sharding(wild, ("dp", "sp"), None).shard_slices((8, 3))
        return {"hier": dict(hier.shape), "hier_index": [hier.axes[a].index for a in hier.shape],
                "wild": dict(wild.shape), "local": local_mesh_size(wild, "sp"),
                "cut": [cut[0].start, cut[0].stop],
                "replicated": replicated(wild).shard_slices((8, 3)) == (slice(None),) * 2}

    yield "mesh_helpers", mesh_helpers


def _shard(t, rank, n=WORLD, dim=1):
    return np.split(t, n, axis=dim)[rank]


def _ring(payload):
    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch.ops import attention as A
    from torchdistx_tpu_torch.parallel import create_mesh

    rank = dist.get_rank()
    sp = create_mesh({"sp": WORLD})

    def run(fn, hq, hkv, causal, bias=False, grads=True):
        def case():
            arrays = attn_inputs(**RING_SHAPE, hq=hq, hkv=hkv, seed=hq + hkv, bias=bias)
            local = [_shard(a, rank) for a in arrays[:3]]
            if bias:
                local.append(_shard(arrays[3], rank, dim=1))
            ts = [torch.from_numpy(a.copy()).requires_grad_() for a in local]
            with sp:
                kw = {"bias": ts[3]} if bias else {}
                out = fn(*ts[:3], axis="sp", causal=causal, **kw)
                res = {"out": _np(out)}
                if grads:
                    torch.sin(out).sum().backward()
                    res["grads"] = [_np(t.grad) for t in ts]
            return res
        return case

    for fn_name in ("ring_flash_attention", "ring_attention"):
        fn = getattr(A, fn_name)
        for hq, hkv, causal in RING_CASES:
            yield f"{fn_name}-{hq}-{hkv}-{causal}", run(fn, hq, hkv, causal)
        for causal in (True, False):
            yield f"{fn_name}-bias-{causal}", run(fn, 4, 4, causal, bias=True)
    for causal in (True, False):
        yield f"ulysses-{causal}", run(
            lambda *a, **k: A.ulysses_attention(*a, use_flash=False, **k), 8, 4, causal)
        yield f"ulysses_flash-{causal}", run(
            lambda *a, **k: A.ulysses_attention(*a, use_flash=True, **k), 8, 4, causal)
    yield "sp_ring", run(lambda *a, **k: A.sp_attention(*a, use_flash=True, **k), 8, 2, True)
    yield "sp_ring_plain", run(lambda *a, **k: A.sp_attention(*a, use_flash=False, **k),
                               8, 2, True)
    yield "sp_ulysses", run(lambda *a, **k: A.sp_attention(*a, mode="ulysses", **k),
                            8, 4, True)

    def error(fn):
        def case():
            with sp:
                try:
                    fn()
                except ValueError as e:
                    return {"message": str(e)}
            return {"message": None}
        return case

    z = torch.zeros((1, 8, 4, 8))
    yield "err_ulysses_heads", error(lambda: A.ulysses_attention(
        torch.zeros((1, 8, 6, 8)), torch.zeros((1, 8, 2, 8)), torch.zeros((1, 8, 2, 8)),
        axis="sp"))
    yield "err_ring_bias", error(lambda: A.ring_flash_attention(
        z, z, z, axis="sp", bias=torch.zeros((4, 8, 8))))
    yield "err_ring_attention_bias", error(lambda: A.ring_attention(
        z, z, z, axis="sp", bias=torch.zeros((4, 8, 8))))


# the 8-bit cases of the fsdp suite: tiny GPT-2 at this vocabulary cuts its
# embedding on dim 1 at fsdp 2 (257 is odd), and at these positions its
# position table on dim 0 into pieces of 2240 values, not whole blocks
FSDP8_GPT2 = dict(vocab_size=257, n_positions=70)
FSDP8_LR, FSDP8_WD = 1e-3, 0.01
VIT_STEPS = 3  # the ViT example's loop, cut from its 30 steps
# the card case: (shape, dtype) of parameters at fsdp 2, every placement
FSDP8_CARD = (((257, 64), "bfloat16"), ((70, 64), "bfloat16"), ((256, 64), "bfloat16"),
              ((64,), "bfloat16"), ((1000, 8), "float32"))


def fsdp8_placed_update(device="cuda", axes=None):
    """A placed ``AdamW8bit`` at fsdp 2 (a dim-1 cut with its block dim
    sharded, a misaligned dim-0 cut, an aligned one, a replicated
    parameter, an f32 one) for 3 steps from seeded gradients, against an
    unsharded ``AdamW8bit`` over the whole parameters and gradients on the
    same device: each rank's pieces of the codes, scales and parameters
    bit for bit.  On the card: two ranks on cuda:0 over ``gloo``."""
    import torch

    from torchdistx_tpu_torch.optimizers import AdamW8bit
    from torchdistx_tpu_torch.parallel import create_mesh, fsdp_partition_spec
    from torchdistx_tpu_torch.parallel.mesh import NamedSharding, shard_tensor

    mesh = create_mesh(axes or {"fsdp": 2})
    rs = np.random.RandomState(4)
    full = [torch.from_numpy(rs.randn(*s).astype(np.float32)).to(device, getattr(torch, dt))
            for s, dt in FSDP8_CARD]
    grads = [[torch.from_numpy((0.01 * rs.randn(*s)).astype(np.float32)).to(
        device, getattr(torch, dt)) for s, dt in FSDP8_CARD] for _ in range(3)]
    shards = [NamedSharding(mesh, fsdp_partition_spec(t.shape, mesh, "fsdp")) for t in full]
    mine = [torch.nn.Parameter(shard_tensor(t.clone(), sh)) for t, sh in zip(full, shards)]
    for p, sh, t in zip(mine, shards, full):
        p._tdx_sharding, p._tdx_global_shape = sh, tuple(t.shape)
    whole = [torch.nn.Parameter(t.clone()) for t in full]
    opt = AdamW8bit(mine, lr=FSDP8_LR, weight_decay=FSDP8_WD).place(mesh, "fsdp")
    ref = AdamW8bit(whole, lr=FSDP8_LR, weight_decay=FSDP8_WD)
    for gs in grads:
        for p, q, g, sh in zip(mine, whole, gs, shards):
            p.grad = g[sh.shard_slices(g.shape)].clone()
            q.grad = g.clone()
        opt.step()
        ref.step()
    out = {"placements": [], "equal": {}}
    for i, (p, q, sh) in enumerate(zip(mine, whole, shards)):
        pl = opt.placement(p)
        out["placements"].append({"local": pl.local, "state_dim": pl.state_dim,
                                  "param_dim": pl.param_dim})
        out["equal"][f"{i}/param"] = bool(torch.equal(p.detach(),
                                                      q.detach()[sh.shard_slices(q.shape)]))
        for k in ("m_codes", "m_scales", "v_codes", "v_scales"):
            out["equal"][f"{i}/{k}"] = bool(torch.equal(opt.state[p][k],
                                                        pl.piece(k, ref.state[q][k])))
    return out


def _fsdp(payload):
    import torch
    import torch.distributed as dist

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import GPT2, Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.optimizers import AdamW8bit
    from torchdistx_tpu_torch.parallel import (
        ShardedTrainStep,
        allreduce_hook,
        create_mesh,
        fsdp_partition_spec,
        fsdp_shard_rule,
        noop_hook,
    )
    from torchdistx_tpu_torch.parallel.fsdp import contiguous_split
    from torchdistx_tpu_torch.parallel.mesh import sharding_of
    from torchdistx_tpu_torch.parallel.plan import gather_full

    if payload.get("part") == "cuda":
        yield "on_the_card", fsdp8_placed_update
        return
    rank = dist.get_rank()
    fsdp = create_mesh({"fsdp": WORLD})
    grid = create_mesh({"dp": 2, "fsdp": 2})

    def specs():
        return {"specs": [fsdp_partition_spec(s, fsdp, "fsdp") for s in payload["shapes"]]}

    def materialize():
        tt.manual_seed(7)
        m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
        session = m.tok_emb.weight._ref[0]
        tt.materialize_module(m, sharding_rule=fsdp_shard_rule(fsdp))
        # what the record session still holds: the uncut tensors only
        cache = session._devices[torch.device("cpu")].cache
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in cache.values()}
        out = {"_cached_bytes": sum(storages.values())}
        for name, p in m.named_parameters():
            sh, shape = sharding_of(p)
            out[name] = {"piece": _np(p), "spec": sh.spec, "shape": shape,
                         "is_param": type(p) is torch.nn.Parameter}
        return out

    def train(mesh, remat=False, **kw):
        def case():
            tt.manual_seed(0)
            m = tt.deferred_init(Llama.from_name, "tiny", device="cpu", remat=remat)
            tt.materialize_module(m)
            load_jax_params(m, payload["init"])
            opt = tt.AnyPrecisionAdamW(m.parameters(), lr=payload["lr"],
                                       variance_dtype=torch.float32)
            step = ShardedTrainStep(
                m, opt, lambda mod, b: F.cross_entropy(mod(b[0]), b[1]), mesh, **kw)
            batch = tuple(torch.from_numpy(a) for a in payload["batch"])
            trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
            trainer.fit([batch] * payload["steps"], payload["steps"])
            return {"losses": [float(x) for x in step.losses],
                    "params": _np(step.full_params()),
                    "coords": {k: a.index for k, a in mesh.axes.items()}}
        return case

    def train8(mesh, kind, **kw):
        """3 steps of ``AdamW8bit`` through the sharded step, its state
        made by ``init_optimizer`` in JAX's ZeRO layout: losses, the whole
        parameters, the whole codes and scales (``adam8bit_state`` by sorted
        name, gathered), each piece's spec, the trainer's comm audit."""
        def case():
            tt.manual_seed(0)
            if kind == "gpt2":
                m = tt.deferred_init(GPT2.from_name, "tiny", device="cpu", **FSDP8_GPT2)
                init = payload["gpt2_init"]
            else:
                m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
                init = payload["init"]
            tt.materialize_module(m)
            load_jax_params(m, init)
            opt = AdamW8bit(m.parameters(), lr=FSDP8_LR, weight_decay=FSDP8_WD)
            step = ShardedTrainStep(
                m, opt, lambda mod, b: F.cross_entropy(mod(b[0]), b[1]), mesh, **kw)
            step.init_optimizer()
            state = opt.adam8bit_state(m)
            specs = {k: [tuple(sharding_of(x)[0].spec) for x in getattr(state, k)]
                     for k in ("m_codes", "m_scales", "v_codes", "v_scales")}
            batch = tuple(torch.from_numpy(a) for a in payload["batch"])
            trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
            trainer.fit([batch] * payload["steps"], payload["steps"])
            state = opt.adam8bit_state(m)
            whole = {k: [_np(gather_full(x)) for x in getattr(state, k)]
                     for k in ("m_codes", "m_scales", "v_codes", "v_scales")}
            return {"losses": [float(x) for x in step.losses],
                    "params": _np(step.full_params()), "state": whole,
                    "count": int(state.count), "specs": specs,
                    "local": [opt.placement(p).local for _, p in sorted(m.named_parameters())],
                    "comm": trainer.comm_profile.to_json()["entries"]}
        return case

    def helpers():
        x = torch.arange(48).reshape(12, 4)
        return {"contiguous_split": _np(contiguous_split(x, 12, 3)),
                "param_sharding": {k: tuple(v.spec) for k, v in ShardedTrainStep(
                    Llama.from_name("tiny", device="cpu"), torch.optim.SGD([torch.zeros(1)],
                                                                            lr=0.1),
                    lambda mod, b: None, fsdp).param_sharding(
                        {str(s): torch.zeros(s) for s in payload["shapes"]}).items()}}

    def examples():
        from torchdistx_tpu_torch.examples import deferred_init_7b, vit_train

        quiet = lambda *_: None  # noqa: E731
        d = deferred_init_7b.main("tiny", device="cpu", log_fn=quiet)
        v = vit_train.main("tiny", steps=VIT_STEPS, device="cpu", mesh=fsdp,
                           params=payload["vit_init"], log_fn=quiet)
        return {"deferred": {k: d[k] for k in ("fake_params", "fake_bytes_held", "n_params",
                                              "sharded", "card_bytes")},
                "tok_emb": tuple(sharding_of(d["model"].tok_emb.weight)[0].spec),
                "vit_losses": v["losses"], "vit_fake_params": v["fake_params"],
                "vit_n_params": v["n_params"],
                "vit_slots": sorted(next(iter(v["step"].optimizer.state.values())))}

    yield "specs", specs
    yield "helpers", helpers
    yield "examples", examples
    yield "placed_update", lambda: fsdp8_placed_update("cpu", {"dp": 2, "fsdp": 2})
    yield "materialize", materialize
    yield "train_fsdp4_8bit", train8(fsdp, "llama", shard_axis="fsdp")
    yield "train_fsdp2_8bit_misaligned", train8(grid, "gpt2", shard_axis="fsdp",
                                                replica_axes=("dp",), comm_hook=allreduce_hook)
    yield "train_fsdp4", train(fsdp, shard_axis="fsdp")
    yield "train_dp2_fsdp2_allreduce", train(grid, shard_axis="fsdp", replica_axes=("dp",),
                                             comm_hook=allreduce_hook)
    yield "train_dp2_fsdp2_noop", train(grid, shard_axis="fsdp", replica_axes=("dp",),
                                        comm_hook=noop_hook)
    yield "train_fsdp4_accum2", train(fsdp, shard_axis="fsdp", accum_steps=2,
                                      batch_axes=("fsdp",))
    # remat recomputes each block from the gathered parameters
    yield "train_fsdp4_remat", train(fsdp, remat=True, shard_axis="fsdp")


def _sp_llama(payload):
    import torch
    import torch.distributed as dist

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import ShardedTrainStep, create_mesh

    rank = dist.get_rank()
    sp = create_mesh({"sp": WORLD})
    grid = create_mesh({"fsdp": 2, "sp": 2})

    def model(**kw):
        m = tt.deferred_init(Llama.from_name, "tiny", device="cpu", max_seq_len=64,
                             sp_axis="sp", **kw)
        tt.materialize_module(m)
        return load_jax_params(m, payload["init"])

    def logits(**kw):
        def case():
            m = model(**kw)
            toks = torch.from_numpy(_shard(payload["tokens"], rank))
            with sp, torch.no_grad():
                return {"logits": _np(m(toks))}
        return case

    def train(mesh, **kw):
        def case():
            m = model(**kw)
            opt = tt.AnyPrecisionAdamW(m.parameters(), lr=payload["lr"],
                                       variance_dtype=torch.float32)
            step = ShardedTrainStep(
                m, opt, lambda mod, b: F.cross_entropy(mod(b[0]), b[1]), mesh,
                shard_axis="fsdp" if "fsdp" in mesh.shape else None, batch_spec=(None, "sp"))
            batch = tuple(torch.from_numpy(a) for a in payload["batch"])
            trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
            trainer.fit([batch] * payload["steps"], payload["steps"])
            return {"losses": [float(x) for x in step.losses], "params": _np(step.full_params())}
        return case

    yield "logits_ring_flash", logits(use_flash=True)
    yield "logits_ring_plain", logits(use_flash=False)
    yield "logits_ulysses", logits(use_flash=False, sp_mode="ulysses")
    yield "train_ring_flash", train(sp, use_flash=True)
    yield "train_ring_plain_fsdp2_sp2", train(grid, use_flash=False)
    yield "train_ulysses", train(sp, use_flash=True, sp_mode="ulysses")


# GossipGraD's hook on a pinned topology: (mesh nodes, topology, permutation,
# iteration); world 4 but "cube_6x1", a world of 6
GOSSIP_HOOKS = {
    "cube_2x2": (2, "CUBE", [0, 1], 0),
    "dissemination_4x1_power1": (4, "DISSEMINATION", [0, 1, 2, 3], 1),
    "dissemination_4x1_permuted": (4, "DISSEMINATION", [2, 0, 3, 1], 0),
    "cube_6x1_power2": (6, "CUBE", [0, 1, 2, 3, 4, 5], 2),
}


def gossip_grads(name: str, world: int = WORLD) -> dict:
    """Every rank's gradient tree of a hook case: two leaves, (world, ...)."""
    seed = 40 + 2 * list(GOSSIP_HOOKS).index(name) if name in GOSSIP_HOOKS else 30
    return {"a": coll_input(seed, (2, 8), world), "b": coll_input(seed + 1, (3,), world)}


def _gossip(payload):
    """GossipGraD and SlowMo: their hooks on pinned inputs, the slow update
    on closed forms, and divergent-replica training of tiny Llama.  The
    cases of ``payload["part"]``: "gossip" and "slowmo" at world 4,
    "cube6" at world 6, "cuda" (CUDA tensors on one card) at world 2."""
    import functools
    import itertools

    import torch
    import torch.distributed as dist

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import (
        GossipGraDState,
        ShardedTrainStep,
        Topology,
        gossip_grad_hook,
        hierarchical_mesh,
        noop_hook,
    )
    from torchdistx_tpu_torch.parallel.comm_hooks import HookContext
    from torchdistx_tpu_torch.slowmo import SlowMomentumOptimizer, SlowMoState, slowmo_hook

    rank, world = dist.get_rank(), dist.get_world_size()

    def grads(name):
        return {k: torch.from_numpy(v[rank]) for k, v in gossip_grads(name, world).items()}

    def gossip_hook(name):
        nodes, topology, perm, iteration = GOSSIP_HOOKS[name]

        def case():
            state = GossipGraDState(nodes, topology=Topology[topology], seed=0)
            state.topologies_set = [tuple(perm)]
            state.topology_cycle = itertools.cycle([0])
            state.iteration = iteration
            with hierarchical_mesh(nodes):
                ctx = HookContext(replica_axes=("node", "local"), step=state.step_args())
                return _np(gossip_grad_hook(state, grads(name), ctx))
        return case

    def slowmo_hook_case(sync_grads):
        def case():
            with hierarchical_mesh(2):
                ctx = HookContext(replica_axes=("node", "local"))
                return _np(slowmo_hook(SlowMoState(sync_grads=sync_grads), grads("slowmo"), ctx))
        return case

    def replica_average():
        # two replicas [1] and [3], no gradient: the slow step meets at 2
        mesh = hierarchical_mesh(2)
        w = torch.nn.Parameter(torch.tensor([1.0 + 2.0 * mesh.axes["node"].index]))
        w.grad = torch.zeros(1)
        opt = SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1), slowmo_freq=1,
                                    base_lr=0.1, slowmo_lr=1.0, slowmo_factor=0.0)
        with mesh:
            opt.step()
        return {"w": _np(w)}

    def loaded_freq_governs():
        # the loaded slowmo_freq (2, not the default 48) times the slow step
        mesh = hierarchical_mesh(2)
        w = torch.nn.Parameter(torch.tensor([1.0 + 2.0 * mesh.axes["node"].index]))
        w.grad = torch.zeros(1)
        sd = SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1), slowmo_freq=2, base_lr=0.1,
                                   slowmo_factor=0.0, slowmo_lr=1.0).state_dict()
        opt = SlowMomentumOptimizer(torch.optim.SGD([w], lr=0.1), base_lr=0.1)
        opt.load_state_dict(sd)
        out = {}
        with mesh:
            for i in (1, 2):
                opt.step()
                out[f"after_{i}"] = _np(w).copy()
        return out

    def train(nodes, steps, hook, state, slowmo_freq=None, **kw):
        def case():
            mesh = hierarchical_mesh(nodes)
            tt.manual_seed(0)
            m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
            tt.materialize_module(m)
            load_jax_params(m, payload["init"])
            # node 0's weights reach every node only through stack_replicas
            with torch.no_grad():
                for p in m.parameters():
                    p.add_(float(mesh.axes["node"].index))
            opt = tt.AnyPrecisionAdamW(m.parameters(), lr=payload["lr"],
                                       variance_dtype=torch.float32)
            if slowmo_freq:
                opt = SlowMomentumOptimizer(opt, slowmo_freq=slowmo_freq, base_lr=payload["lr"])
            step = ShardedTrainStep(
                m, opt, lambda mod, b: F.cross_entropy(mod(b[0]), b[1]), mesh,
                replica_axes=("node",), comm_hook=hook, hook_state=state(),
                divergent_replicas=True, **kw)
            step.stack_replicas()
            batch = tuple(torch.from_numpy(a) for a in payload["batch"])
            trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
            snapshots = []
            for i in range(steps):
                trainer.fit([batch], i + 1)
                # copies: an unsharded parameter comes back as itself
                snapshots.append({k: _np(t).copy() for k, t in step.full_params().items()})
            return {"losses": [float(x) for x in step.losses], "snapshots": snapshots,
                    "consensus": _np(step.consensus()), "node": mesh.axes["node"].index}
        return case

    def full_node_batch():
        # noop hook, batch over (node, local): each node's update is the
        # mean of its own rows (w = -lr * mean)
        mesh = hierarchical_mesh(2)
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.zeros(1))
        step = ShardedTrainStep(m, torch.optim.SGD(m.parameters(), lr=1.0),
                                lambda mod, b: torch.mean(mod.w * b), mesh, shard_axis=None,
                                replica_axes=("node",), comm_hook=noop_hook,
                                divergent_replicas=True, batch_axes=("node", "local"))
        step.stack_replicas()
        step(m, step.optimizer, torch.arange(16.0))
        return {"w": _np(m.w), "node": mesh.axes["node"].index}

    def staged_on_the_card():
        # gloo's sends take no CUDA tensor: exchange and the hook stage
        # through pinned host buffers, counted in _permute.staged_bytes
        from torchdistx_tpu_torch.parallel import collectives as C

        mesh = hierarchical_mesh(2)
        tree = {k: v.to("cuda") for k, v in grads("cube_2x2").items()}
        tree["c"] = torch.full((5,), float(rank + 1), dtype=torch.bfloat16, device="cuda")
        before = C._permute.staged_bytes
        with mesh:
            out = C.exchange(tree, "node", [1, 0], [1, 0])
            staged = C._permute.staged_bytes - before
            state = GossipGraDState(2)
            hooked = gossip_grad_hook(state, tree, HookContext(("node",), state.step_args()))
            shifted = C.shift(tree["a"], "node")
        return {"out": _np({k: t.float() for k, t in out.items()}),
                "hooked": _np({k: t.float() for k, t in hooked.items()}),
                "shifted": _np(shifted),
                "devices": sorted({str(t.device) for t in (*out.values(), *hooked.values())}),
                "dtype_c": str(out["c"].dtype), "staged": staged,
                "tree_bytes": sum(t.numel() * t.element_size() for t in tree.values())}

    part = payload["part"]
    if part == "cuda":
        yield "staged_on_the_card", staged_on_the_card
    if part == "cube6":
        yield "hook_cube_6x1_power2", gossip_hook("cube_6x1_power2")
    if part == "gossip":
        for name in ("cube_2x2", "dissemination_4x1_power1", "dissemination_4x1_permuted"):
            yield f"hook_{name}", gossip_hook(name)
        yield "full_node_batch", full_node_batch
        for name, (nodes, kw, topology) in GOSSIP_TRAINS.items():
            if topology is None:
                yield name, train(nodes, payload["steps"], noop_hook, lambda: None, **kw)
                continue
            yield name, train(nodes, payload["steps"], gossip_grad_hook, functools.partial(
                GossipGraDState, nodes, topology=Topology[topology]), **kw)
    if part == "slowmo":
        yield "slowmo_hook_sync", slowmo_hook_case(True)
        yield "slowmo_hook_no_sync", slowmo_hook_case(False)
        yield "replica_average", replica_average
        yield "loaded_freq_governs", loaded_freq_governs
        yield "slowmo_2x2", train(2, payload["steps"], slowmo_hook, SlowMoState,
                                  slowmo_freq=payload["slowmo_freq"], shard_axis=None,
                                  batch_axes=("node", "local"))


# divergent training of tiny Llama: (mesh nodes, ShardedTrainStep kwargs,
# GossipGraD topology or None for noop_hook)
GOSSIP_TRAINS = {
    "gossip_2x2_shard_local": (2, dict(shard_axis="local"), "DISSEMINATION"),
    "gossip_4x1_dissemination": (4, dict(shard_axis=None), "DISSEMINATION"),
    "gossip_4x1_cube": (4, dict(shard_axis=None), "CUBE"),
    "noop_2x2_node_local_batch": (2, dict(shard_axis=None, batch_axes=("node", "local")), None),
}


# -- plans, tensor and expert parallelism, the sharded loader -------------------------


# TestRuleResolution of tests/test_plan.py: (rules, default_axis) and the
# (path, shape) queries, on {"fsdp": WORLD}
PLAN_RESOLUTION = {
    "first_match": (((r"\.weight$", ("fsdp", None)), (r"attn\..*\.weight$", (None, "fsdp"))),
                    None, [("blocks.0.attn.wq.weight", (64, 64)),
                           ("deep.nesting.attn.weight", (64, 64))]),
    "no_match": (((r"\.weight$", ("fsdp", None)),), None, [("something.bias", (64,))]),
    "default_axis": ((), "fsdp", [("h", (4096, 64)), ("tiny.bias", (8,))]),
    "explicit_beats_min_elems": (((r"bias$", ("fsdp",)),), "fsdp", [("tiny.bias", (8,))]),
}
TP_RULE_PATHS = [("blocks.0.attn.wq.weight", (64, 64)), ("blocks.0.attn.wo.weight", (64, 64)),
                 ("blocks.0.mlp.w_down.weight", (64, 64)), ("tok_emb.weight", (64, 64)),
                 ("norm.weight", (64,))]
TP_LR, TP_STEPS = 1e-1, 3
# name: (mesh axes, batch_spec, plan: "llama", "llama_2d" or "custom")
TP_TRAINS = {
    "train_dp2_tp2": ({"dp": 2, "tp": 2}, ("dp",), "llama"),
    "train_tp4": ({"tp": 4}, (), "llama"),
    "train_fsdp2_tp2_2d": ({"fsdp": 2, "tp": 2}, ("fsdp",), "llama_2d"),
    "train_dp2_tp2_gathered": ({"dp": 2, "tp": 2}, ("dp",), "custom"),
}
# rules no local path knows, ahead of llama_tp_plan's: the norms over tp
# (gathered at use), the head row-parallel (its input cut)
CUSTOM_RULES = ((r"norm\.weight$", ("tp",)), (r"lm_head\.weight$", (None, "tp")))


def tp_batch(b=4, s=16, vocab=256):
    """test_tp.py's ``_data``."""
    rs = np.random.RandomState(0)
    return (rs.randint(0, vocab, (b, s)).astype(np.int64),
            rs.randint(0, vocab, (b, s)).astype(np.int64))


MOE_SHAPE = dict(dim=16, ffn=32, experts=8, top_k=2)
# name: (mesh axes, capacity_factor, dispatch_mode)
MOE_CASES = {
    "dense_ep4": ({"ep": 4}, None, "einsum"),
    "dense_dp2_ep2": ({"dp": 2, "ep": 2}, None, "einsum"),
    "einsum_c2_ep4": ({"ep": 4}, 2.0, "einsum"),
    "einsum_c1_dp2_ep2": ({"dp": 2, "ep": 2}, 1.0, "einsum"),
    "gather_c1_ep4": ({"ep": 4}, 1.0, "gather"),
}
MIXTRAL_LR, MIXTRAL_STEPS = 1e-2, 3
MIXTRAL_TRAINS = {"mixtral_ep4": {"ep": 4}, "mixtral_dp2_ep2": {"dp": 2, "ep": 2}}


def moe_input(seed=1):
    return np.random.RandomState(seed).randn(4, 8, 16).astype(np.float32)


# the card's EP check: (capacity_factor, dispatch_mode) of each mode, at
# dim 64, ffn 128, 8 experts, top-2, 2 x 16 tokens
CARD_MOE_MODES = [(None, "einsum"), (2.0, "einsum"), (1.25, "gather")]


def moe_weights(seed, dim=64, ffn=128, experts=8):
    """Named f32 weights of an ``nn.MoE``, made with numpy."""
    rs = np.random.RandomState(seed)
    w = lambda *s: (rs.randn(*s) / np.sqrt(s[-2] if len(s) > 2 else s[-1])).astype(np.float32)
    return {"router.weight": w(experts, dim), "w_gate": w(experts, dim, ffn),
            "w_up": w(experts, dim, ffn), "w_down": w(experts, ffn, dim)}


def mixtral_batch():
    """test_mixtral.py's ``_tokens(seed=7)`` and ``_tokens(seed=8)``."""
    return tuple(np.random.RandomState(s).randint(0, 256, (2, 32)).astype(np.int64)
                 for s in (7, 8))


def _specs(model):
    from torchdistx_tpu_torch.parallel.mesh import sharding_of

    return {n: tuple(sharding_of(p)[0].spec) for n, p in model.named_parameters()}


def _plan(payload):
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.parallel import (
        PlanError,
        ShardingPlan,
        create_mesh,
        donated_carry_shardings,
        fsdp_partition_spec,
        llama_tp_plan,
        llama_tp_rule,
        optimizer_state_shardings,
        shard_params,
        tree_path_str,
    )
    from torchdistx_tpu_torch.parallel.fsdp import accumulate_grads, strided_split
    from torchdistx_tpu_torch.parallel.mesh import sharding_of

    fsdp = create_mesh({"fsdp": WORLD})
    grid = create_mesh({"dp": 2, "tp": 2})
    other = create_mesh({"dp": 2, "fsdp": 2})

    def resolution():
        out = {}
        for name, (rules, default, queries) in PLAN_RESOLUTION.items():
            plan = ShardingPlan(fsdp, rules=rules, default_axis=default)
            out[name] = [(plan.spec_for(p, s), plan.maybe_spec_for(p, s)) for p, s in queries]
        out["fsdp_partition_spec"] = fsdp_partition_spec((4096, 64), fsdp, "fsdp", 1024)
        return out

    def errors():
        out = {}
        for key, make in (("default_axis", lambda: ShardingPlan(fsdp, default_axis="nope")),
                          ("rule_axis", lambda: ShardingPlan(fsdp, rules=((r".", ("tp",)),))),
                          ("zero2", lambda: ShardingPlan(fsdp, zero2=True)),
                          ("with_mesh", lambda: ShardingPlan(fsdp, default_axis="fsdp")
                           .with_mesh(grid))):
            try:
                make()
                out[key] = None
            except PlanError as e:
                out[key] = str(e)
        return out

    def with_mesh():
        plan = ShardingPlan(fsdp, rules=((r"w", ("fsdp",)),), default_axis="fsdp")
        moved = plan.with_mesh(other)
        return {"rules_equal": moved.rules == plan.rules, "spec": moved.spec_for("w", (8, 8)),
                "size": moved.mesh.shape["fsdp"]}

    def tp_rule():
        rule = llama_tp_rule(grid, "tp")
        return [tuple(rule(p, torch.empty(s)).spec) for p, s in TP_RULE_PATHS]

    def eager():
        tt.manual_seed(7)
        return dict(Llama.from_name("tiny", device="cpu").named_parameters())

    def materialize():
        tt.manual_seed(7)
        m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
        plan = llama_tp_plan(grid)
        tt.materialize_module(m, sharding_rule=plan.as_rule())
        return {"pieces": _np(dict(m.named_parameters())), "specs": _specs(m),
                "describe": plan.describe(m), "per_device_bytes": plan.per_device_bytes(m),
                "coords": {k: a.index for k, a in grid.axes.items()}}

    def apply():
        tt.manual_seed(7)
        m = Llama.from_name("tiny", device="cpu")
        plan = llama_tp_plan(grid)
        before = {n: p for n, p in m.named_parameters()}
        plan.apply(m)
        same_objects = all(p is before[n] for n, p in m.named_parameters())
        pieces = _np(dict(m.named_parameters()))
        data = {n: p.data_ptr() for n, p in m.named_parameters()}
        plan.apply(m)  # placed already: nothing moves
        again = all(p.data_ptr() == data[n] for n, p in m.named_parameters())
        # re-cut to the 2-D plan: gathered, then cut again
        plan2d = llama_tp_plan(grid, "tp", fsdp_axis="dp")
        plan2d.apply(m)
        d = shard_params({n: t.detach() for n, t in eager().items()}, plan2d.as_rule())
        return {"same_objects": same_objects, "pieces": pieces, "reapplied_in_place": again,
                "pieces_2d": _np(dict(m.named_parameters())), "specs_2d": _specs(m),
                "dict_pieces_2d": _np(d),
                "dict_specs_2d": {n: tuple(sharding_of(t)[0].spec) for n, t in d.items()}}

    def opt_state():
        tt.manual_seed(7)
        m = Llama.from_name("tiny", device="cpu")
        plan = llama_tp_plan(grid)
        plan.apply(m)
        opt = tt.AnyPrecisionAdamW(m.parameters(), lr=1e-3)
        for p in m.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        derived = plan.optimizer_state_shardings(opt, m)
        actual = optimizer_state_shardings(opt, m, grid)
        carry = donated_carry_shardings({"w": m.tok_emb.weight, "x": torch.zeros(2)})
        return {"derived": {n: {k: tuple(v.spec) for k, v in row.items()}
                            for n, row in derived.items()},
                "actual": {n: {k: tuple(v.spec) for k, v in row.items()}
                           for n, row in actual.items()},
                "carry": [tuple(carry[0]["w"].spec), carry[0]["x"]]}

    def unported():
        plan = llama_tp_plan(grid)
        out = {}
        for key, fn in (("validate", lambda: plan.validate({})),
                        ("price_step", lambda: plan.price_step({})),
                        ("record_step_collectives", lambda: plan.record_step_collectives({})),
                        ("zero2", lambda: ShardingPlan(grid, dp_axis="dp", zero2=True))):
            try:
                fn()
                out[key] = None
            except NotImplementedError as e:
                out[key] = str(e)
        return out

    def accumulate():
        # accumulate_grads against one backward over the whole batch
        w = torch.nn.Parameter(torch.from_numpy(coll_input(3, (4, 3))[0]))
        x = torch.from_numpy(coll_input(4, (8, 4))[0])

        def loss_fn(b):
            return ((b @ w) ** 2).mean()

        whole = torch.autograd.grad(loss_fn(x), [w])[0]
        loss2, g2 = accumulate_grads(loss_fn, [w], x, 2, strided_split)
        pieces = strided_split(torch.arange(8), 4)
        return {"whole": _np(whole), "accum2": _np(g2[0]), "loss": float(loss_fn(x)),
                "loss2": float(loss2), "strided": [_np(p) for p in pieces],
                "path": tree_path_str(("blocks", 0, "attn"))}

    yield "resolution", resolution
    yield "errors", errors
    yield "with_mesh", with_mesh
    yield "tp_rule", tp_rule
    yield "materialize", materialize
    yield "apply", apply
    yield "opt_state", opt_state
    yield "unported", unported
    yield "accumulate", accumulate


def _tp(payload):
    import warnings

    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import (
        GSPMDTrainStep,
        ShardingPlan,
        collectives,
        create_mesh,
        llama_tp_plan,
        llama_tp_rule,
    )
    from torchdistx_tpu_torch.parallel.mesh import NamedSharding, mark_sharded

    meshes = {}

    def mesh_of(axes):
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = create_mesh(axes)
        return meshes[key]

    def loss_fn(mod, b):
        return F.cross_entropy(mod(b[0]), b[1])

    def plan_of(mesh, kind):
        if kind == "llama":
            return llama_tp_plan(mesh)
        if kind == "llama_2d":
            return llama_tp_plan(mesh, "tp", fsdp_axis="fsdp")
        return ShardingPlan(mesh, rules=CUSTOM_RULES + llama_tp_plan(mesh).rules)

    def loaded(**kw):
        m = tt.deferred_init(Llama.from_name, "tiny", device="cpu", **kw)
        tt.materialize_module(m)
        return load_jax_params(m, payload["init"])

    def run(step, batch, steps):
        trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
        trainer.fit([batch] * steps, steps)
        return {"losses": [float(x) for x in step.losses], "params": _np(step.full_params()),
                "specs": _specs(step.model),
                "local_shapes": {n: tuple(p.shape) for n, p in step.model.named_parameters()}}

    def train(axes, batch_spec, kind):
        def case():
            mesh = mesh_of(axes)
            m = loaded()
            step = GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=TP_LR), loss_fn, mesh,
                                  batch_spec=batch_spec, plan=plan_of(mesh, kind))
            before = dict(collectives.payload_bytes)
            out = run(step, tuple(torch.from_numpy(a) for a in tp_batch()), TP_STEPS)
            out["payload_bytes"] = {k: v - before[k] for k, v in collectives.payload_bytes.items()}
            out["local_forwards"] = len(step._layout.forwards)
            return out
        return case

    def born_sharded():
        # materialized under the rule, trained without a plan, against the
        # port's own unsharded steps from the same seed
        mesh = mesh_of({"dp": 2, "tp": 2})
        tt.manual_seed(5)
        m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
        tt.materialize_module(m, sharding_rule=llama_tp_rule(mesh, "tp"))
        step = GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=TP_LR), loss_fn, mesh,
                              batch_spec=("dp",))
        batch = tuple(torch.from_numpy(a) for a in tp_batch())
        out = run(step, batch, TP_STEPS)
        tt.manual_seed(5)
        ref = Llama.from_name("tiny", device="cpu")
        rstep = tt.TrainStep(ref, torch.optim.SGD(ref.parameters(), lr=TP_LR), loss_fn)
        for _ in range(TP_STEPS):
            rstep(ref, rstep.optimizer, batch)
        out.update(ref_losses=[float(x) for x in rstep.losses],
                   ref_params=_np(dict(ref.named_parameters())))
        return out

    def accum():
        mesh = mesh_of({"dp": 2, "tp": 2})
        batch = tuple(torch.from_numpy(a) for a in tp_batch(b=8))
        out = {}
        for n in (1, 2):
            m = loaded()
            step = GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-2), loss_fn, mesh,
                                  batch_spec=("dp",), accum_steps=n, plan=llama_tp_plan(mesh))
            out[f"accum{n}"] = run(step, batch, 1)
        m = loaded()
        step = GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-2), loss_fn, mesh,
                              batch_spec=("dp",), accum_steps=3, plan=llama_tp_plan(mesh))
        try:
            step(m, step.optimizer, batch)
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
        return out

    def presharded():
        # a batch distributed over tp, not the step's dp: gathered, cut
        # again, and warned about once per layout
        mesh = mesh_of({"dp": 2, "tp": 2})
        glob = tuple(torch.from_numpy(a) for a in tp_batch(b=8))
        wrong = NamedSharding(mesh, ("tp",))
        pieces = tuple(mark_sharded(t[wrong.shard_slices(t.shape)].clone(), wrong, t.shape)
                       for t in glob)
        out = {}
        for key, batch in (("global", glob), ("tp_sharded", pieces)):
            m = loaded()
            step = GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-3), loss_fn, mesh,
                                  batch_spec=("dp",), plan=llama_tp_plan(mesh))
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                step(m, step.optimizer, batch)
                step(m, step.optimizer, batch)
            out[key] = {"losses": [float(x) for x in step.losses],
                        "warnings": sum("batch_spec" in str(w.message) for w in rec)}
        return out

    def kv_heads():
        mesh = mesh_of({"tp": 4})
        tt.manual_seed(0)
        m = Llama.from_name("tiny", device="cpu", n_kv_heads=2)
        try:
            GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-3), loss_fn, mesh,
                           plan=llama_tp_plan(mesh))
            return {"message": None}
        except ValueError as e:
            return {"message": str(e)}

    for name, (axes, batch_spec, kind) in TP_TRAINS.items():
        yield name, train(axes, batch_spec, kind)
    yield "born_sharded", born_sharded
    yield "accum", accum
    yield "presharded", presharded
    yield "kv_heads", kv_heads


def _moe_ep(payload):
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Mixtral
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.nn.moe import MoE, moe_shard_rule
    from torchdistx_tpu_torch.parallel import GSPMDTrainStep, ShardingPlan, create_mesh
    from torchdistx_tpu_torch.parallel import collectives as C
    from torchdistx_tpu_torch.parallel import shard_params
    from torchdistx_tpu_torch.parallel.mesh import sharding_of
    from torchdistx_tpu_torch.parallel.plan import gather_full

    meshes = {}

    def mesh_of(axes):
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = create_mesh(axes)
        return meshes[key]

    def moe(axes, capacity_factor, mode):
        def case():
            mesh = mesh_of(axes)
            sh = MOE_SHAPE
            m = MoE(sh["dim"], sh["ffn"], sh["experts"], top_k=sh["top_k"],
                    capacity_factor=capacity_factor, dispatch_mode=mode, device="cpu")
            load_jax_params(m, payload["moe"][(capacity_factor, mode)])
            shard_params(m, moe_shard_rule(mesh, "ep"))
            x_full = moe_input()
            dp = mesh.axes["dp"] if "dp" in mesh.axes else None
            rows = slice(None) if dp is None else slice(dp.index * 2, dp.index * 2 + 2)
            x = torch.from_numpy(x_full[rows].copy()).requires_grad_()
            y, aux = m(x, return_aux=True)
            # the dp-sharded cases hold sum(y^2), whose gradient adds over dp
            loss = (y * y).sum() + (aux if dp is None else 0.0)
            loss.backward()
            with mesh:
                grads = {}
                for n, p in m.named_parameters():
                    g = p.grad if dp is None else C.all_reduce(p.grad, "dp")
                    found = sharding_of(p)
                    grads[n] = _np(gather_full(g, found[0]) if found else g)
            return {"y": _np(y), "aux": float(aux), "x_grad": _np(x.grad), "rows": [
                rows.start, rows.stop], "grads": grads, "local_experts": m.w_gate.shape[0],
                "spec": tuple(sharding_of(m.w_up)[0].spec)}
        return case

    def loss_fn(mod, b):
        logits, aux = mod.forward_with_aux(b[0])
        return F.cross_entropy(logits, b[1]) + 1e-2 * aux

    def mixtral(axes):
        def case():
            mesh = mesh_of(axes)
            m = tt.deferred_init(Mixtral.from_name, "tiny", device="cpu")
            tt.materialize_module(m)
            load_jax_params(m, payload["mixtral"])
            plan = ShardingPlan(mesh, rules=((r"\.mlp\.(w_gate|w_up|w_down)$",
                                              ("ep", None, None)),))
            step = GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=MIXTRAL_LR), loss_fn,
                                  mesh, plan=plan)
            batch = tuple(torch.from_numpy(a) for a in mixtral_batch())
            trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
            trainer.fit([batch] * MIXTRAL_STEPS, MIXTRAL_STEPS)
            return {"losses": [float(x) for x in step.losses], "params": _np(step.full_params()),
                    "specs": _specs(m), "local_experts": m.blocks[0].mlp.w_gate.shape[0]}
        return case

    def on_the_card():
        # f32 on cuda:0, two ranks over gloo, each holding 4 of 8 experts
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = mesh_of({"ep": 2})
        out = {}
        for cf, mode in CARD_MOE_MODES:
            m = MoE(64, 128, 8, top_k=2, capacity_factor=cf, dispatch_mode=mode, device="cuda")
            load_jax_params(m, moe_weights(0))
            shard_params(m, moe_shard_rule(mesh, "ep"))
            x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 64).astype(np.float32))
            x = x.to("cuda").requires_grad_()
            y = m(x)
            (y * y).sum().backward()
            grads = {n: _np(gather_full(p.grad, sharding_of(p)[0]))
                     for n, p in m.named_parameters()}
            out[f"{cf}-{mode}"] = {"y": _np(y), "x_grad": _np(x.grad), "grads": grads,
                                   "device": str(y.device), "local": m.w_gate.shape[0]}
        return out

    if payload.get("part") == "cuda":
        yield "on_the_card", on_the_card
        return

    def born_sharded():
        mesh = mesh_of({"dp": 2, "ep": 2})
        tt.manual_seed(15)
        m = tt.deferred_init(Mixtral.from_name, "tiny", device="cpu")
        tt.materialize_module(m, sharding_rule=m.shard_rule(mesh))
        return {"pieces": _np(dict(m.named_parameters())), "specs": _specs(m),
                "ep_index": mesh.axes["ep"].index}

    for name, (axes, cf, mode) in MOE_CASES.items():
        yield name, moe(axes, cf, mode)
    for name, axes in MIXTRAL_TRAINS.items():
        yield name, mixtral(axes)
    yield "born_sharded", born_sharded


def _data(payload):
    import torch

    from torchdistx_tpu_torch.data import DataLoader, TokenDataset
    from torchdistx_tpu_torch.parallel import create_mesh
    from torchdistx_tpu_torch.parallel.mesh import NamedSharding, sharding_of

    mesh = create_mesh({"dp": 2, "tp": 2})

    def load(spec, prefetch):
        def case():
            sh = NamedSharding(mesh, spec)
            dl = DataLoader(TokenDataset(payload["stream"], payload["seq"]), payload["batch"],
                            shuffle=True, seed=3, sharding=sh, prefetch=prefetch, device="cpu")
            out = []
            for _ in range(2):
                for b in dl:
                    marks = [sharding_of(t) for t in b]
                    out.append({"arrays": [_np(t) for t in b],
                                "specs": [tuple(m[0].spec) for m in marks],
                                "shapes": [m[1] for m in marks],
                                "tensors": all(isinstance(t, torch.Tensor) for t in b)})
            return {"batches": out, "coords": {k: a.index for k, a in mesh.axes.items()}}
        return case

    for prefetch in (0, 2):
        yield f"dp_p{prefetch}", load(("dp",), prefetch)
        yield f"dp_tp_p{prefetch}", load((("dp", "tp"),), prefetch)


# -- sequence-parallel GPT-2 and T5, ZeRO-2, pipelines, resharding ------------------


# GPT-2 and T5 under sp: (mesh axes, model kwargs); {"dp": 2, "sp": 2} runs two
# 2-way rings, one a batch row, {"sp": 4} one 4-way ring
SP_MESHES = {"sp2": {"dp": 2, "sp": 2}, "sp4": {"sp": WORLD}}
SP_GPT2_CASES = {"ring_plain": dict(use_flash=False), "ring_flash": dict(use_flash=True),
                 "ulysses": dict(use_flash=False, sp_mode="ulysses")}
SP_T5_CASES = {"plain": dict(use_flash=False), "flash": dict(use_flash=True)}


def sp_batch(kind):
    """test_models.py's SP inputs: GPT-2 (2, 64) tokens and labels; T5
    (2, 64) sources and (2, 32) targets (unequal: the cross ring's q and k
    shards differ)."""
    rs = np.random.RandomState(9 if kind == "gpt2" else 7)
    if kind == "gpt2":
        return (rs.randint(0, 256, (2, 64)).astype(np.int64),
                rs.randint(0, 256, (2, 64)).astype(np.int64))
    return (rs.randint(0, 256, (2, 64)).astype(np.int64),
            rs.randint(0, 256, (2, 32)).astype(np.int64))


def _sp_models(payload):
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import GPT2, T5
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import collectives, create_mesh

    meshes = {k: create_mesh(v) for k, v in SP_MESHES.items()}

    def run(kind, mesh_key, kw):
        def case():
            mesh = meshes[mesh_key]
            cls = GPT2 if kind == "gpt2" else T5
            m = tt.deferred_init(cls.from_name, "tiny", device="cpu", sp_axis="sp", **kw)
            tt.materialize_module(m)
            load_jax_params(m, payload[kind])
            sp, dp = mesh.axes["sp"], mesh.axes.get("dp")
            rows = slice(None) if dp is None else slice(dp.index, dp.index + 1)
            a, b = (torch.from_numpy(x[rows]) for x in sp_batch(kind))
            a, b = (torch.from_numpy(np.split(x.numpy(), sp.size, axis=1)[sp.index].copy())
                    for x in (a, b))
            with mesh:
                logits = m(a) if kind == "gpt2" else m(a, b)
                F.cross_entropy(logits, b).backward()
                grads = collectives.all_mean({n: p.grad for n, p in m.named_parameters()},
                                             tuple(mesh.axis_names))
            return {"logits": _np(logits), "grads": _np(grads), "rows": [rows.start, rows.stop],
                    "sp_index": sp.index, "sp_size": sp.size}
        return case

    for mesh_key in SP_MESHES:
        for name, kw in SP_GPT2_CASES.items():
            yield f"gpt2-{name}-{mesh_key}", run("gpt2", mesh_key, kw)
        for name, kw in SP_T5_CASES.items():
            yield f"t5-{name}-{mesh_key}", run("t5", mesh_key, kw)

    def n_positions():
        m = GPT2.from_name("tiny", device="cpu", sp_axis="sp")
        with meshes["sp4"]:
            try:
                m(torch.zeros((1, 17), dtype=torch.long))
            except ValueError as e:
                return {"message": str(e)}
        return {"message": None}

    yield "err_n_positions", n_positions


ZERO2_STEPS, ZERO2_LR, ZERO2_MOMENTUM = 10, 1e-1, 0.9
ZERO2_INJECT, ZERO2_AFTER = 3, 2  # the bounce: a loss at step 4, then 2 steps


def zero2_batch(vocab=256, b=8, s=16, seed=0):
    """test_plan.py's ``_data``: globally unique tokens."""
    rs = np.random.RandomState(seed)
    tokens = rs.permutation(vocab)[: b * s].reshape(b, s).astype(np.int64)
    labels = rs.randint(0, vocab, (b, s)).astype(np.int64)
    return tokens, labels


def _zero2(payload):
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import GSPMDTrainStep, ShardingPlan, create_mesh
    from torchdistx_tpu_torch.parallel.mesh import sharding_of
    from torchdistx_tpu_torch.utils.benchmarks import build_train_workload, optimizer_bytes

    def loss_fn(mod, b):
        return F.cross_entropy(mod(b[0]), b[1])

    if payload.get("part") == "cuda":
        # two ranks on cuda:0 over gloo, bf16 tiny Llama at head_dim 64 (the
        # kernels take 64 or 128) through the flash kernels,
        # AnyPrecisionAdamW: ZeRO-2 against the replicated oracle
        def on_the_card():
            mesh = create_mesh({"dp": 2})
            out = {}
            batch = tuple(torch.from_numpy(a[:4]).to("cuda") for a in zero2_batch())
            for key, plan in (("zero2", ShardingPlan(mesh, dp_axis="dp", zero2=True)),
                              ("oracle", None)):
                tt.manual_seed(3)
                m = tt.materialize_module(tt.deferred_init(
                    Llama.from_name, "tiny", dim=128, n_heads=2, dtype=torch.bfloat16,
                    device="cuda"))
                opt = tt.AnyPrecisionAdamW(m.parameters(), lr=1e-3)
                step = GSPMDTrainStep(m, opt, loss_fn, mesh, batch_spec=("dp",), plan=plan)
                for _ in range(3):
                    step(m, opt, batch)
                out[key] = {"params": _np({n: p.float() for n, p in m.named_parameters()}),
                            "losses": [float(x) for x in step.losses],
                            "bytes": optimizer_bytes(opt), "sliced": len(step._zero2)}
            return out

        yield "on_the_card", on_the_card
        return
    mesh = create_mesh({"dp": WORLD})

    def model():
        m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
        tt.materialize_module(m)
        return load_jax_params(m, payload["init"])

    def train(plan):
        m = model()
        opt = torch.optim.SGD(m.parameters(), lr=ZERO2_LR, momentum=ZERO2_MOMENTUM)
        step = GSPMDTrainStep(m, opt, loss_fn, mesh, batch_spec=("dp",), plan=plan)
        batch = tuple(torch.from_numpy(a) for a in zero2_batch())
        trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
        trainer.fit([batch] * ZERO2_STEPS, ZERO2_STEPS)
        return m, opt, step

    def ten_steps():
        plan = ShardingPlan(mesh, dp_axis="dp", zero2=True, min_shard_elems=1)
        m, opt, step = train(plan)
        om, oopt, ostep = train(None)
        derived = plan.optimizer_state_shardings(opt, m)
        return {"params": _np(dict(m.named_parameters())),
                "oracle": _np(dict(om.named_parameters())),
                "losses": [float(x) for x in step.losses],
                "oracle_losses": [float(x) for x in ostep.losses],
                "bytes": optimizer_bytes(opt), "oracle_bytes": optimizer_bytes(oopt),
                "sliced": len(step._zero2),
                "derived": {n: {k: tuple(v.spec) for k, v in row.items()}
                            for n, row in derived.items()},
                "participating": plan.zero2_participating_bytes(m),
                "specs": {n: tuple(p._tdx_sharding.spec) for n, p in m.named_parameters()}}

    def workload():
        w = build_train_workload("tiny", batch=2, seq=16, device="cpu", zero2=True)
        losses = w["run"](2)
        return {"losses": losses, "plan": w["plan"], "zero2_dp": w["zero2_dp"],
                "participating": w["zero2_participating_bytes"],
                "step_wire": w["zero2_step_wire_bytes"], "bytes": w["optimizer_bytes"]()}

    def eight_bit():
        plan = ShardingPlan(mesh, dp_axis="dp", zero2=True, min_shard_elems=1)
        m = model()
        step = GSPMDTrainStep(m, tt.optimizers.adamw_8bit(m.parameters(), 1e-3), loss_fn, mesh,
                              batch_spec=("dp",), plan=plan)
        return {"sliced": len(step._zero2)}

    def bounce(tmp):
        """ZeRO-2 on ``{"dp": 4}`` loses ranks 2 and 3 after step
        ``ZERO2_INJECT + 1``: the momentum's ``dp`` slices bounce through the
        checkpoint and are cut again over ``{"dp": 2}``, then
        ``ZERO2_AFTER`` steps."""
        def case():
            from torchdistx_tpu_torch.parallel.plan import gather_full
            from torchdistx_tpu_torch.parallel.reshard import optimizer_state_tree
            from torchdistx_tpu_torch.utils.failure import FailureDetector

            plan = ShardingPlan(mesh, dp_axis="dp", zero2=True, min_shard_elems=1)
            m = model()
            opt = torch.optim.SGD(m.parameters(), lr=ZERO2_LR, momentum=ZERO2_MOMENTUM)
            step = GSPMDTrainStep(m, opt, loss_fn, mesh, batch_spec=("dp",), plan=plan)
            det, logs = FailureDetector(), []
            tr = tt.Trainer(step, log_every=1, log_fn=logs.append, checkpoint_dir=tmp,
                            checkpoint_every=100, failure_detector=det, on_failure="reshard")
            batch = tuple(torch.from_numpy(a) for a in zero2_batch())
            tr.fit([batch] * ZERO2_INJECT)
            det.inject_device_loss(2)
            total = ZERO2_INJECT + 1 + ZERO2_AFTER
            tr.fit([batch] * (total - ZERO2_INJECT), total)
            out = {"logs": [x for x in logs if "failure" in x], "last": tr.last_reshard,
                   "departed": tr.departed, "global_step": tr.global_step}
            if not tr.departed:
                new = tr.step
                tree = optimizer_state_tree(opt, m)
                with new.mesh:
                    momentum = {n: _np(gather_full(row["momentum_buffer"]))
                                for n, row in tree.items()}
                out.update(params=_np(dict(m.named_parameters())), momentum=momentum,
                           losses=[float(x) for x in new.losses], mesh=dict(new.mesh.shape),
                           bytes=optimizer_bytes(opt), sliced=len(new._zero2),
                           specs={n: tuple(sharding_of(row["momentum_buffer"])[0].spec)
                                  for n, row in tree.items()})
            return out
        return case

    yield "ten_steps", ten_steps
    yield "workload", workload
    yield "eight_bit", eight_bit
    yield "bounce", bounce(os.path.join(payload["tmp"], "zero2_bounce"))


PP_D = 8


def pp_stages(n, d, key, h=None):
    """test_pp.py's ``_stages`` (w, b), or the 3-D test's MLP stages (w1,
    b1, w2, b2) with ``h``."""
    rs = np.random.RandomState(key)
    if h is None:
        return [{"w": (rs.randn(d, d) * 0.1).astype(np.float32),
                 "b": (rs.randn(d) * 0.1).astype(np.float32)} for _ in range(n)]
    return [{"w1": (rs.randn(h, d) * 0.1).astype(np.float32),
             "b1": (rs.randn(h) * 0.1).astype(np.float32),
             "w2": (rs.randn(d, h) * 0.1).astype(np.float32),
             "b2": (rs.randn(d) * 0.1).astype(np.float32)} for _ in range(n)]


# name: (mesh axes, stage key, d, microbatch shape (n_micro, b), dp_axis)
PP_TRAINS = {"loss_grads_pp4": ({"pp": 4}, 10, 16, (6, 8), None),
             "fewer_micro_pp4": ({"pp": 4}, 12, 8, (2, 4), None),
             "dp2_pp2": ({"dp": 2, "pp": 2}, 14, 8, (4, 8), "dp")}
PP_APPLY = {"forward_pp4": (16, 6, 8, 1, 4), "micro_not_multiple_pp4": (8, 5, 4, 3, 2)}
PP_TP_SPECS = {"w1": ("pp", "tp", None), "b1": ("pp", "tp"), "w2": ("pp", None, "tp"),
               "b2": ("pp", None)}


def pp_inputs(seed, shape, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape, d).astype(np.float32), rs.randn(*shape, d).astype(np.float32))


def _pp(payload):
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models.llama import LlamaConfig, pp_stage
    from torchdistx_tpu_torch.parallel import collectives as C
    from torchdistx_tpu_torch.parallel import create_mesh
    from torchdistx_tpu_torch.parallel.plan import gather_full
    from torchdistx_tpu_torch.parallel.pp import (pipeline_apply, pipeline_train_step,
                                                 split_microbatches, stack_pipeline_stages)

    meshes = {}

    def mesh_of(axes):
        key = tuple(axes.items())
        if key not in meshes:
            meshes[key] = create_mesh(axes)
        return meshes[key]

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def mse(y, t):
        return ((y - t) ** 2).mean()

    def torch_stages(stages):
        return [{k: torch.from_numpy(v) for k, v in st.items()} for st in stages]

    def whole(g):
        return {k: _np(gather_full(v)) for k, v in g.items()}

    def train(axes, key, d, shape, dp):
        def case():
            mesh = mesh_of(axes)
            stacked = stack_pipeline_stages(torch_stages(pp_stages(mesh.shape["pp"], d, key)),
                                            mesh)
            mb, tgt = (torch.from_numpy(a) for a in pp_inputs(key + 1, shape, d))
            before = C.payload_bytes["pipe"]
            loss, g = pipeline_train_step(stacked, mb, tgt, mesh=mesh, stage_fn=stage_fn,
                                          loss_fn=mse, dp_axis=dp)
            return {"loss": float(loss), "grads": whole(g),
                    "pipe_bytes": C.payload_bytes["pipe"] - before,
                    "grad_shape": tuple(g["w"].shape)}
        return case

    def apply(d, n_micro, b, key, seed):
        def case():
            mesh = mesh_of({"pp": WORLD})
            stacked = stack_pipeline_stages(torch_stages(pp_stages(WORLD, d, key)), mesh)
            micro = torch.from_numpy(
                np.random.RandomState(seed).randn(n_micro, b, d).astype(np.float32))
            return {"out": _np(pipeline_apply(stacked, micro, mesh=mesh, stage_fn=stage_fn))}
        return case

    def autodiff():
        # test_pp.py's gradients through pipeline_apply, and its training loop
        out = {}
        mesh = mesh_of({"dp": 2, "pp": 2})  # two 2-stage pipelines, the same inputs
        stacked = stack_pipeline_stages(torch_stages(pp_stages(2, 8, 4)), mesh)
        for t in stacked.values():
            t.requires_grad_()
        micro = torch.from_numpy(np.random.RandomState(5).randn(4, 4, 8).astype(np.float32))
        (pipeline_apply(stacked, micro, mesh=mesh, stage_fn=stage_fn) ** 2).mean().backward()
        out["grads"] = whole({k: _marked(t.grad, t) for k, t in stacked.items()})
        mesh4 = mesh_of({"pp": WORLD})
        stacked = stack_pipeline_stages(torch_stages(pp_stages(WORLD, 8, 6)), mesh4)
        params = {k: t.clone().requires_grad_() for k, t in stacked.items()}
        opt = torch.optim.SGD(params.values(), lr=0.1)
        micro = torch.from_numpy(np.random.RandomState(7).randn(4, 8, 8).astype(np.float32))
        losses = []
        for _ in range(5):
            opt.zero_grad()
            loss = ((pipeline_apply({k: _marked(v, stacked[k]) for k, v in params.items()},
                                    micro, mesh=mesh4, stage_fn=stage_fn) - 1.0) ** 2).mean()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        out["losses"] = losses
        # the 1F1B step's training loop (test_training_reduces_loss)
        stacked = stack_pipeline_stages(torch_stages(pp_stages(WORLD, 8, 16)), mesh4)
        rs = np.random.RandomState(17)
        mb = split_microbatches(torch.from_numpy(rs.randn(16, 8).astype(np.float32)), 4)
        tgt = split_microbatches(torch.zeros((16, 8)), 4)
        params = {k: v.clone() for k, v in stacked.items()}
        losses = []
        for _ in range(8):
            loss, g = pipeline_train_step({k: _marked(v, stacked[k]) for k, v in params.items()},
                                          mb, tgt, mesh=mesh4, stage_fn=stage_fn, loss_fn=mse)
            for k in params:
                params[k] -= 0.3 * g[k]
            losses.append(float(loss))
        out["train_losses"] = losses
        try:
            stack_pipeline_stages(torch_stages(pp_stages(3, 8, 0)), mesh4)
            out["wrong_count"] = None
        except ValueError as e:
            out["wrong_count"] = str(e)
        return out

    def tp_stage_fn(p, x):
        xin = C.copy_psum_grad(x, "tp")
        h = torch.relu(xin @ p["w1"].T + p["b1"])
        return x + C.allreduce_linear(h @ p["w2"].T, "tp") + p["b2"]

    def tp(train_step):
        def case():
            mesh = mesh_of({"tp": 2, "pp": 2})
            stages = pp_stages(2, 8, 21 if train_step else 20, h=16)
            stacked = stack_pipeline_stages(torch_stages(stages), mesh)
            rs = np.random.RandomState(22 if train_step else 23)
            if not train_step:
                mb = torch.from_numpy(rs.randn(3, 4, 8).astype(np.float32))
                out = pipeline_apply(stacked, mb, mesh=mesh, stage_fn=tp_stage_fn,
                                     param_specs=PP_TP_SPECS)
                return {"out": _np(out)}
            mb, tgt = (torch.from_numpy(rs.randn(4, 4, 8).astype(np.float32)) for _ in range(2))
            loss, g = pipeline_train_step(stacked, mb, tgt, mesh=mesh, stage_fn=tp_stage_fn,
                                          loss_fn=mse, param_specs=PP_TP_SPECS)
            return {"loss": float(loss), "grads": whole(g),
                    "local_w1": tuple(g["w1"].shape)}
        return case

    def llama():
        # deferred-init Llama blocks, one a stage, against the port's own
        # unpipelined run of the same stages (test_pp.py's TestLlamaPipeline)
        cfg = LlamaConfig(vocab_size=64, dim=32, n_layers=4, n_heads=4, n_kv_heads=2,
                          max_seq_len=16, dtype=torch.float32, use_flash=False)
        Stage = pp_stage(cfg)
        mesh = mesh_of({"dp": 2, "pp": 2})
        stages = []
        for i in range(2):
            tt.manual_seed(100 + i)
            m = tt.deferred_init(Stage, device="cpu")
            tt.materialize_module(m)
            stages.append(dict(m.named_parameters()))
        template = Stage(device="cpu")
        fn = lambda p, x: torch.func.functional_call(template, p, (x,))  # noqa: E731
        rs = np.random.RandomState(21)
        hidden = torch.from_numpy(rs.randn(4, 4, 8, 32).astype(np.float32))
        tgt = torch.from_numpy(rs.randn(4, 4, 8, 32).astype(np.float32))
        stacked = stack_pipeline_stages(stages, mesh)
        loss, g = pipeline_train_step(stacked, hidden, tgt, mesh=mesh, stage_fn=fn, loss_fn=mse,
                                      dp_axis="dp")
        # the unpipelined reference: every microbatch through both stages
        params = [{k: v.detach().clone().requires_grad_() for k, v in st.items()}
                  for st in stages]
        total = 0.0
        for i in range(hidden.shape[0]):
            x = hidden[i]
            for p in params:
                x = fn(p, x)
            total = total + mse(x, tgt[i])
        total = total / hidden.shape[0]
        total.backward()
        return {"loss": float(loss), "ref_loss": float(total), "grads": whole(g),
                "ref_grads": [{k: _np(v.grad) for k, v in p.items()} for p in params]}

    for name, (axes, key, d, shape, dp) in PP_TRAINS.items():
        yield name, train(axes, key, d, shape, dp)
    for name, (d, n_micro, b, key, seed) in PP_APPLY.items():
        yield name, apply(d, n_micro, b, key, seed)
    yield "autodiff", autodiff
    yield "tp_apply", tp(False)
    yield "tp_train", tp(True)
    yield "llama", llama


def _marked(t, like):
    from torchdistx_tpu_torch.parallel.mesh import mark_sharded, sharding_of

    return mark_sharded(t, *sharding_of(like))


RESHARD_STEPS, RESHARD_INJECT = 8, 5
RESHARD_LR8 = 1e-2
SLOTS8 = ("m_codes", "m_scales", "v_codes", "v_scales")


def reshard_batches(n, d=16):
    """test_reshard.py's ``_batches``: (x, x) pairs of (8, 16)."""
    rs = np.random.RandomState(0)
    return [(b, b) for b in (rs.randn(8, d).astype(np.float32) for _ in range(n))]


def _reshard(payload):
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_adam8bit_state, load_jax_params
    from torchdistx_tpu_torch.optimizers import AdamW8bit
    from torchdistx_tpu_torch.parallel import ShardedTrainStep, can_reshard_live, create_mesh
    from torchdistx_tpu_torch.parallel import collectives as C
    from torchdistx_tpu_torch.parallel.mesh import sharding_of
    from torchdistx_tpu_torch.parallel.plan import gather_full
    from torchdistx_tpu_torch.parallel.reshard import optimizer_state_tree
    from torchdistx_tpu_torch.utils.failure import FailureDetector, StepFailure
    import torch.distributed as dist

    rank = dist.get_rank()

    class MLP(torch.nn.Module):
        def __init__(self, d=16, h=64):
            super().__init__()
            self.fc1 = tt.nn.Linear(d, h, device="cpu")
            self.fc2 = tt.nn.Linear(h, d, device="cpu")

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    def mlp():
        m = MLP()
        return load_jax_params(m, payload["mlp"])

    def loss_fn(mod, b):
        return ((mod(b[0]) - b[1]) ** 2).mean()

    def step_on(mesh, m, **kw):
        opt = torch.optim.Adam(m.parameters(), lr=1e-2)
        return ShardedTrainStep(m, opt, loss_fn, mesh, **kw)

    def batches(n):
        return [tuple(torch.from_numpy(a) for a in b) for b in reshard_batches(n)]

    def full_state(step):
        tree = optimizer_state_tree(step.optimizer, step.model)
        with step.mesh:  # copies: an unsharded tensor gathers to itself
            return ({n: gather_full(p).clone() for n, p in step.model.named_parameters()},
                    {n: {k: gather_full(v).clone() for k, v in row.items()}
                     for n, row in tree.items()})

    def transplant(mesh, params, slots, data, **kw):
        """A fresh step on ``mesh`` from whole ``params`` and Adam ``slots``,
        trained on ``data``."""
        m = mlp()
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(params[n])
        step = step_on(mesh, m, **kw)
        names = {id(p): n for n, p in m.named_parameters()}
        for _, p, _ in step._params:
            sh = p._tdx_sharding
            step.optimizer.state[p] = {k: (v[sh.shard_slices(v.shape)].clone()
                                           if v.ndim else v.clone())
                                       for k, v in slots[names[id(p)]].items()}
        trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
        trainer.fit(data)
        return step

    def bounce(tmp):
        def case():
            data = batches(RESHARD_STEPS)
            mesh4 = create_mesh({"fsdp": WORLD})
            # the oracle's first half: a clean 4-rank run to the recovery step
            ref = step_on(mesh4, mlp(), shard_axis="fsdp")
            tt.Trainer(ref, log_every=1, log_fn=lambda _: None).fit(data[:RESHARD_INJECT + 1])
            params, slots = full_state(ref)
            det, logs = FailureDetector(), []
            step = step_on(mesh4, mlp(), shard_axis="fsdp")
            tr = tt.Trainer(step, log_every=1, log_fn=logs.append, checkpoint_dir=tmp,
                            checkpoint_every=100, failure_detector=det, on_failure="reshard")
            tr.fit(data[:RESHARD_INJECT])
            det.inject_device_loss(2)
            tr.fit(data[RESHARD_INJECT:], RESHARD_STEPS)
            out = {"logs": [m for m in logs if "failure" in m], "last": tr.last_reshard,
                   "departed": tr.departed, "t_reshard": tr._t_reshard,
                   "global_step": tr.global_step}
            # the oracle's second half on a fresh {"fsdp": 2} of ranks 0 and 1
            small = create_mesh({"fsdp": 2}, devices=[0, 1], member=False)
            if not tr.departed:
                ostep = transplant(small, params, slots, data[RESHARD_INJECT + 1:],
                                   shard_axis="fsdp")
                out.update(params=_np(tr.step.full_params()), oracle=_np(ostep.full_params()),
                           losses=[float(x) for x in tr.step.losses[RESHARD_INJECT + 1:]],
                           oracle_losses=[float(x) for x in ostep.losses],
                           mesh=dict(tr.step.mesh.shape),
                           local_shapes={n: tuple(p.shape)
                                         for n, p in tr.step.model.named_parameters()})
            return out
        return case

    def step8_on(mesh, m):
        opt = AdamW8bit(m.parameters(), lr=RESHARD_LR8)
        step = ShardedTrainStep(m, opt, loss_fn, mesh, shard_axis="fsdp")
        step.init_optimizer()
        return step

    def whole8(step):
        """``(count, {slot: [whole array]})`` of a placed 8-bit state, by
        sorted parameter name."""
        st = step.optimizer.adam8bit_state(step.model)
        with step.mesh:
            return int(st.count), {k: [gather_full(x).clone() for x in getattr(st, k)]
                                   for k in SLOTS8}

    def bounce8(tmp):
        """The bounce of ``bounce`` with the 8-bit AdamW in JAX's layout:
        the state's pieces leave the 4-rank layout and come back in the
        2-rank one (codes of the 64-value biases cut on the block dim)."""
        def case():
            data = batches(RESHARD_STEPS)
            mesh4 = create_mesh({"fsdp": WORLD})
            ref = step8_on(mesh4, mlp())
            tt.Trainer(ref, log_every=1, log_fn=lambda _: None).fit(data[:RESHARD_INJECT + 1])
            with mesh4:
                params = {n: gather_full(p).clone() for n, p in ref.model.named_parameters()}
            count, state = whole8(ref)
            det, logs = FailureDetector(), []
            step = step8_on(mesh4, mlp())
            tr = tt.Trainer(step, log_every=1, log_fn=logs.append, checkpoint_dir=tmp,
                            checkpoint_every=100, failure_detector=det, on_failure="reshard")
            tr.fit(data[:RESHARD_INJECT])
            det.inject_device_loss(2)
            tr.fit(data[RESHARD_INJECT:], RESHARD_STEPS)
            out = {"last": tr.last_reshard, "departed": tr.departed,
                   "global_step": tr.global_step}
            small = create_mesh({"fsdp": 2}, devices=[0, 1], member=False)
            if not tr.departed:
                m = mlp()
                with torch.no_grad():
                    for n, p in m.named_parameters():
                        p.copy_(params[n])
                ostep = step8_on(small, m)
                load_jax_adam8bit_state(ostep.optimizer, m, {"count": count, **state})
                tt.Trainer(ostep, log_every=1, log_fn=lambda _: None).fit(
                    data[RESHARD_INJECT + 1:])
                opt = tr.step.optimizer
                out.update(
                    params=_np(tr.step.full_params()), oracle=_np(ostep.full_params()),
                    losses=[float(x) for x in tr.step.losses[RESHARD_INJECT + 1:]],
                    oracle_losses=[float(x) for x in ostep.losses],
                    state=_np(whole8(tr.step)), oracle_state=_np(whole8(ostep)),
                    specs={n: {k: tuple(sharding_of(v)[0].spec) for k, v in row.items()}
                           for n, row in optimizer_state_tree(opt, tr.step.model).items()},
                    mesh=dict(tr.step.mesh.shape), state_bytes=opt.state_bytes())
            return out
        return case

    def live():
        data = batches(RESHARD_STEPS)
        mesh = create_mesh({"dp": 2, "fsdp": 2})
        step = step_on(mesh, mlp(), shard_axis="fsdp", replica_axes=("dp",))
        tr = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
        tr.fit(data[:4])
        params, slots = full_state(step)
        mode = tr.reshard(mesh=tt.Trainer._shrunk_mesh(mesh, 2))
        out = {"mode": mode, "last": tr.last_reshard, "departed": tr.departed}
        tr.fit(data[4:], RESHARD_STEPS)
        if not tr.departed:
            ostep = transplant(tr.step.mesh, params, slots, data[4:], shard_axis="fsdp",
                               replica_axes=("dp",))
            out.update(params=_np(tr.step.full_params()), oracle=_np(ostep.full_params()),
                       mesh=dict(tr.step.mesh.shape))
        return out

    def shrunk():
        out = {}
        for key, axes, lost in (("dp_fsdp", {"dp": 2, "fsdp": 2}, 2),
                                ("fsdp", {"fsdp": WORLD}, 2), ("odd", {"fsdp": WORLD}, 1)):
            mesh = create_mesh(axes)
            try:
                small = tt.Trainer._shrunk_mesh(mesh, lost)
                out[key] = {"shape": dict(small.shape), "member": small.is_member,
                            "ranks": small.devices.tolist()}
            except StepFailure as e:
                out[key] = {"error": str(e)}
        return out

    def fallback(tmp):
        def case():
            # "reshard" on a non-device-loss failure rolls back as "restore"
            from torchdistx_tpu_torch.utils.failure import apply_failure_policy

            mesh = create_mesh({"fsdp": WORLD})
            step = step_on(mesh, mlp(), shard_axis="fsdp")
            tr = tt.Trainer(step, log_every=1, log_fn=lambda _: None, checkpoint_dir=tmp,
                            checkpoint_every=2, on_failure="reshard")
            data = batches(4)
            tr.fit(data[:2])
            saved = {n: _np(gather_full(p)) for n, p in step.model.named_parameters()}
            dist.barrier()
            tr.fit(data[2:], 3)
            action = apply_failure_policy(tr, StepFailure("nonfinite", "x"), "reshard")
            return {"action": action, "global_step": tr.global_step, "saved": saved,
                    "restored": {n: _np(gather_full(p))
                                 for n, p in step.model.named_parameters()}}
        return case

    def live_check():
        mesh = create_mesh({"fsdp": WORLD})
        small = create_mesh({"fsdp": 2}, devices=[0, 1], member=False)
        grid = create_mesh({"dp": 2, "fsdp": 2})
        m = step_on(mesh, mlp(), shard_axis="fsdp").model
        r = step_on(grid, mlp(), shard_axis="fsdp", replica_axes=("dp",)).model
        surv = tt.Trainer._shrunk_mesh(grid, 2)
        return {"sharded_onto_2": can_reshard_live(dict(m.named_parameters()), small),
                "sharded_onto_4": can_reshard_live(dict(m.named_parameters()), mesh),
                "replica_onto_2": can_reshard_live(dict(r.named_parameters()), surv)}

    def to_plan():
        # reshard_to_plan: an FSDP-placed MLP and its Adam state onto the
        # replicated plan of the same mesh, live, priced first
        from torchdistx_tpu_torch.parallel import (ShardingPlan, plan_transition_wire_bytes,
                                                   reshard_to_plan)

        mesh = create_mesh({"fsdp": WORLD})
        m = mlp()
        ShardingPlan.fsdp(mesh, min_shard_elems=1).apply(m)
        opt = torch.optim.Adam(m.parameters(), lr=1e-2)
        for p in m.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        target = ShardingPlan.replicated(mesh)
        priced = plan_transition_wire_bytes(m, target, optimizer_state=opt)
        with mesh:
            before = dict(C.payload_bytes)
            reshard_to_plan(m, target, optimizer_state=opt)
            sent = C.payload_bytes["all_gather"] - before["all_gather"]
        return {"priced": priced, "gathered": sent,
                "params": _np(dict(m.named_parameters())),
                "slots": {n: _np(opt.state[p]["exp_avg"]) for n, p in m.named_parameters()}}

    yield "to_plan", to_plan
    yield "bounce", bounce(os.path.join(payload["tmp"], "bounce"))
    yield "bounce_8bit", bounce8(os.path.join(payload["tmp"], "bounce_8bit"))
    yield "live", live
    yield "shrunk", shrunk
    yield "fallback", fallback(os.path.join(payload["tmp"], "fallback"))
    yield "live_check", live_check


# -- the comm audit and the memory audit (tests/test_torch_comm_audit.py) -------------

AUDIT_RING = dict(b=2, s=64, h=4, d=16)
AUDIT_FLASH_RING = dict(b=1, s=64, h=4, d=8)
AUDIT_ULYSSES = dict(b=2, s=64, h=8, d=16)
AUDIT_PP = dict(d=8, b=2, n_micro=6)
AUDIT_TP = dict(d=16, h=64, b=4, n_layers=3)


def audit_inputs(name, seed):
    """The numpy inputs of one audit case, made the same way on both sides."""
    rs = np.random.RandomState(seed)
    if name == "tp":
        c = AUDIT_TP
        w = {f"w1_{i}": rs.randn(c["d"], c["h"]).astype(np.float32)
             for i in range(c["n_layers"])}
        w.update({f"w2_{i}": rs.randn(c["h"], c["d"]).astype(np.float32)
                  for i in range(c["n_layers"])})
        return w, rs.randn(c["b"], c["d"]).astype(np.float32)
    if name == "pp":
        c = AUDIT_PP
        stages = [{"w": (rs.randn(c["d"], c["d"]) * 0.1).astype(np.float32)} for _ in range(4)]
        return stages, rs.randn(c["n_micro"] * c["b"], c["d"]).astype(np.float32)
    c = {"ring": AUDIT_RING, "flash_ring": AUDIT_FLASH_RING, "ulysses": AUDIT_ULYSSES}[name]
    return tuple(rs.randn(c["b"], c["s"], c["h"], c["d"]).astype(np.float32) for _ in range(3))


def _comm_audit(payload):
    """The comm audit of every choke point and step at world 4 (JAX's
    ``tests/test_comm_audit.py`` on 4 of its devices), the Trainer's
    profile and flight digest, ZeRO-2's k-step audit against the plan's
    price, the plan transition's, and the memory audit: ``sharding_report``
    and ``ShardingPlan.validate`` on materialized tensors."""
    import torch

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.obs import FlightRecorder, sharding_report
    from torchdistx_tpu_torch.obs.comm import comm_audit
    from torchdistx_tpu_torch.ops.attention import (ring_attention, ring_flash_attention,
                                                    ulysses_attention)
    from torchdistx_tpu_torch.parallel import (GossipGraDState, GSPMDTrainStep, ShardedTrainStep,
                                               ShardingPlan, collectives, create_mesh,
                                               gossip_grad_hook, hierarchical_mesh)
    from torchdistx_tpu_torch.parallel.mesh import NamedSharding, mark_sharded, shard_tensor
    from torchdistx_tpu_torch.parallel.plan import PlanError
    from torchdistx_tpu_torch.parallel.pp import (pipeline_train_step, split_microbatches,
                                                 stack_pipeline_stages)
    from torchdistx_tpu_torch.parallel.reshard import plan_transition_wire_bytes, reshard_to_plan

    class MLP(torch.nn.Module):
        def __init__(self, d=16, h=64):
            super().__init__()
            self.fc1 = tt.nn.Linear(d, h, device="cpu")
            self.fc2 = tt.nn.Linear(h, d, device="cpu")

        def forward(self, x):
            return self.fc2(torch.relu(self.fc1(x)))

    def mlp():
        return load_jax_params(MLP(), payload["mlp"])

    def mse(mod, b):
        return ((mod(b[0]) - b[1]) ** 2).mean()

    fsdp4 = create_mesh({"fsdp": 4})

    def fsdp():
        m = mlp()
        step = ShardedTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-2), mse, fsdp4)
        x = torch.zeros(8, 16)
        with comm_audit() as prof:
            step(m, step.optimizer, (x, x))
        with comm_audit() as again:
            step(m, step.optimizer, (x, x))
        return {"profile": prof.to_json(), "again": bool(again)}

    def tp():
        w, x = audit_inputs("tp", 0)
        n, rank = 4, collectives.axis_index

        def run(wrt_input):
            with create_mesh({"tp": 4}) as mesh:
                i = rank("tp")
                ws = {k: torch.from_numpy(v[:, i * 16:(i + 1) * 16] if k.startswith("w1")
                                          else v[i * 16:(i + 1) * 16]).requires_grad_()
                      for k, v in w.items()}
                xt = torch.from_numpy(x).requires_grad_(wrt_input)
                h = xt
                with comm_audit() as prof:
                    for j in range(AUDIT_TP["n_layers"]):
                        xin = collectives.copy_psum_grad(h, "tp")
                        mid = torch.relu(xin @ ws[f"w1_{j}"])
                        h = collectives.allreduce_linear(mid @ ws[f"w2_{j}"], "tp")
                    wrt = list(ws.values()) + ([xt] if wrt_input else [])
                    torch.autograd.grad(h.sum(), wrt)
            del mesh
            return prof.to_json()

        assert n == 4
        return {"live": run(True), "dead": run(False)}

    def pp():
        stages, x = audit_inputs("pp", 1)
        with create_mesh({"pp": 4}) as mesh:
            stacked = stack_pipeline_stages([{k: torch.from_numpy(v) for k, v in st.items()}
                                             for st in stages], mesh)
            mb = split_microbatches(torch.from_numpy(x), AUDIT_PP["n_micro"])
            with comm_audit() as prof:
                pipeline_train_step(stacked, mb, torch.zeros_like(mb), mesh=mesh,
                                    stage_fn=lambda p, a: a + torch.tanh(a @ p["w"]),
                                    loss_fn=lambda y, t: ((y - t) ** 2).mean())
        return prof.to_json()

    def gossip():
        m = mlp()
        mesh = hierarchical_mesh(2)
        state = GossipGraDState(2, node_axis="node", local_axis="local")
        step = ShardedTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-2), mse, mesh,
                                shard_axis=None, replica_axes=("node",),
                                comm_hook=gossip_grad_hook, hook_state=state,
                                divergent_replicas=True, batch_axes=("node", "local"))
        step.stack_replicas()
        x = torch.zeros(8, 16)
        with comm_audit() as prof:
            step(m, step.optimizer, (x, x))
        return {"profile": prof.to_json(), "branches": len(state.branch_table()[0])}

    def ring():
        out = {}
        with create_mesh({"fsdp": 4}) as mesh:
            i = collectives.axis_index("fsdp")

            def local(arrs, c, grad=False):
                blk = c["s"] // 4
                return [torch.from_numpy(a[:, i * blk:(i + 1) * blk].copy()).requires_grad_(grad)
                        for a in arrs]

            q, k, v = local(audit_inputs("ring", 0), AUDIT_RING)
            with comm_audit() as prof:
                ring_attention(q, k, v, axis="fsdp", causal=True)
            out["ring"] = prof.to_json()
            q, k, v = local(audit_inputs("flash_ring", 1), AUDIT_FLASH_RING, grad=True)
            with comm_audit() as prof:
                o = ring_flash_attention(q, k, v, axis="fsdp", causal=True)
                torch.autograd.grad(torch.sin(o).sum(), [q, k, v])
            out["flash_ring"] = prof.to_json()
            q, k, v = local(audit_inputs("ulysses", 2), AUDIT_ULYSSES)
            with comm_audit() as prof:
                ulysses_attention(q, k, v, axis="fsdp", causal=True, use_flash=False)
            out["ulysses"] = prof.to_json()
        del mesh
        return out

    def llama(rule=None):
        m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
        tt.materialize_module(m, sharding_rule=rule)
        return load_jax_params(m, payload["llama"]) if rule is None else m

    def zero2():
        mesh = create_mesh({"dp": 4})
        plan = ShardingPlan(mesh, dp_axis="dp", zero2=True, min_shard_elems=1)
        m = llama()
        step = GSPMDTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-2),
                              lambda mod, b: F.cross_entropy(mod(b[0]), b[1]), mesh,
                              batch_spec=("dp",), plan=plan)
        batch = tuple(torch.from_numpy(a) for a in lm_batch(4, 8))
        k = 2
        with comm_audit() as prof:
            for _ in range(k):
                step(m, step.optimizer, batch)
        return {"profile": prof.to_json(), "rows": plan.price_step(m), "k": k,
                "wire": plan.step_wire_bytes(m), "gather_wire": plan.step_wire_bytes(
                    m, "all_gather")}

    def transition():
        src = ShardingPlan.fsdp(fsdp4)
        m = llama(src.as_rule())
        target = ShardingPlan.replicated(fsdp4)
        expected = plan_transition_wire_bytes(m, target)
        with comm_audit() as prof:
            reshard_to_plan(m, target)
        return {"expected": expected, "profile": prof.to_json()}

    def trainer():
        m = mlp()
        step = ShardedTrainStep(m, torch.optim.SGD(m.parameters(), lr=1e-2), mse, fsdp4)
        rs = np.random.RandomState(0)
        batches = [(b, b) for b in (torch.from_numpy(rs.randn(8, 16).astype(np.float32))
                                    for _ in range(3))]
        rec = FlightRecorder()
        tr = tt.Trainer(step, log_every=1, log_fn=lambda _: None, flight=rec)
        with comm_audit() as outer:
            tr.fit(batches)
        steps = [r for r in rec.records() if r["kind"] == "step"]
        return {"profile": tr.comm_profile.to_json(), "outer": outer.to_json(),
                "digest": tr.comm_profile.digest(), "step_comm": [r.get("comm") for r in steps]}

    def report():
        big = mark_sharded(torch.zeros(64, 64), NamedSharding(fsdp4, ()), (64, 64))
        sharded = shard_tensor(torch.zeros(64, 64), NamedSharding(fsdp4, ("fsdp", None)))
        small = mark_sharded(torch.zeros(8), NamedSharding(fsdp4, ()), (8,))
        rep = sharding_report({"big": big, "sharded": sharded, "small": small})
        planned = sharding_report({"big": big},
                                  intended_rule=lambda p, a: NamedSharding(fsdp4, ()))
        mismatch = sharding_report({"big": big}, intended_rule=lambda p, a: NamedSharding(
            fsdp4, ("fsdp", None)))
        m = mlp()
        params = {k: shard_tensor(v.detach(), NamedSharding(fsdp4, ("fsdp", None) if v.ndim == 2
                                                            else ()))
                  for k, v in m.named_parameters()}
        repl = NamedSharding(fsdp4, ())
        bad = {k: {s: mark_sharded(torch.zeros(v.shape), repl, v.shape) for s in ("mu", "nu")}
               for k, v in m.named_parameters()}
        bad_rep = sharding_report(params, optimizer_state=bad)
        pieces = {k: torch.nn.Parameter(v) for k, v in params.items()}
        opt = torch.optim.Adam(pieces.values(), lr=1e-3)
        for v in pieces.values():
            v.grad = torch.zeros_like(v)
        opt.step()
        good = {k: {s: opt.state[v][s] for s in ("exp_avg", "exp_avg_sq")}
                for k, v in pieces.items()}
        good_rep = sharding_report(params, optimizer_state=good)
        return {"report": {k: rep[k] for k in ("flags", "total_bytes", "bytes_per_device")},
                "planned": planned["flags"], "mismatch": mismatch["flags"],
                "bad": bad_rep["flags"], "good": good_rep["flags"],
                "budget": sharding_report(params, budget_bytes_per_device=1)["flags"]}

    def validate():
        plan = ShardingPlan.fsdp(fsdp4)
        x = mark_sharded(torch.zeros(4096, 64), NamedSharding(fsdp4, ()), (4096, 64))
        out = {}
        try:
            plan.validate({"w": x})
            out["mismatch"] = None
        except PlanError as e:
            out["mismatch"] = str(e)
        good = shard_tensor(torch.zeros(4096, 64), plan.sharding_for("w", x))
        out["conforming"] = plan.validate({"w": good})["flags"]
        return out

    yield "fsdp", fsdp
    yield "tp", tp
    yield "pp", pp
    yield "gossip", gossip
    yield "ring", ring
    yield "zero2", zero2
    yield "transition", transition
    yield "trainer", trainer
    yield "report", report
    yield "validate", validate


# -- tensor-parallel serving (tests/test_torch_serve_tp.py) --------------------------


def serve_prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (n,)).astype(np.int32) for n in lengths]


def shared_prefix_prompts(seed, n, prefix_len=16, tail_len=4):
    rs = np.random.RandomState(seed)
    prefix = rs.randint(0, 256, (prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix, rs.randint(0, 256, (tail_len,)).astype(np.int32)])
            for _ in range(n)]


CYCLIC_PROMPTS = ([3, 1, 2, 3, 1, 2, 3], [9, 9, 9, 9], [5, 7, 5, 7, 5])
ELASTIC_MNT = [8, 10, 12, 6]
HANDOFF_MNT = [6, 8, 6, 8]


def _serve_tp(payload):
    """TP serving on two ranks: the cases of JAX's ``TestTPServing``,
    ``TestServeEnginePlan``, the tp=2 -> tp=1 migration and handoff, int8
    under TP and ``TestSpecTP``, each engine next to its world-1 twin; the
    ``"cuda"`` part builds a persistent TP engine on the card over ``gloo``
    and reports the refusal."""
    import warnings

    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.models.llama import LlamaConfig
    from torchdistx_tpu_torch.obs.comm import CommProfile, comm_audit
    from torchdistx_tpu_torch.parallel import create_mesh, llama_tp_plan, llama_tp_rule
    from torchdistx_tpu_torch.parallel.mesh import sharding_of
    from torchdistx_tpu_torch.serve import ServeEngine, ServeFleet

    mesh = create_mesh({"tp": 2})

    def model(kind, device="cpu"):
        if kind == "plan":
            m = Llama(LlamaConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                  max_seq_len=64), device=device)
        elif kind == "kv1":
            return Llama.from_name("tiny", n_kv_heads=1, max_seq_len=64, device=device)
        else:
            m = Llama.from_name("tiny", max_seq_len=64, device=device,
                                **({"n_kv_heads": 2} if kind == "kv2" else {}))
        if kind in payload.get("weights", {}):
            load_jax_params(m, payload["weights"][kind])
        return m

    def toks(results):
        return [np.asarray(r.tokens) for r in results]

    def run(eng, prompts, mnt):
        mnt = mnt if isinstance(mnt, list) else [mnt] * len(prompts)
        return toks(eng.run([{"prompt": p, "max_new_tokens": m} for p, m in zip(prompts, mnt)]))

    if payload.get("part") == "cuda":
        def refused():
            try:
                ServeEngine(model("tp", "cuda"), num_slots=2, max_len=64, mesh=mesh,
                            decode_mode="persistent")
            except RuntimeError as e:
                return {"refused": str(e)}
            return {"refused": None}

        yield "refused", refused
        return

    tp_model = model("tp")
    kv2_model = model("kv2")

    def slab4():
        prompts = serve_prompts(21, (6, 11, 9, 4, 13))
        eng = ServeEngine(tp_model, num_slots=3, max_len=64, prefill_buckets=(16,),
                          decode_chunk=4, mesh=mesh)
        one = ServeEngine(tp_model, num_slots=3, max_len=64, prefill_buckets=(16,),
                          decode_chunk=4)
        kv = eng.cache.kv[0][0]
        return {"tp": eng.tp, "tokens": run(eng, prompts, 6), "world1": run(one, prompts, 6),
                "local_shape": tuple(kv.shape), "global_shape": sharding_of(kv)[1],
                "kv_plan": eng.memory_plan()["components"]["kv_cache"],
                "nbytes": eng.cache.nbytes}

    def paged_persistent():
        prompts = serve_prompts(22, (5, 12, 9))
        kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,), decode_mode="persistent",
                  page_size=16)
        return {"tokens": run(ServeEngine(tp_model, mesh=mesh, **kw), prompts, 6),
                "world1": run(ServeEngine(tp_model, **kw), prompts, 6)}

    def audit():
        kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,))
        eng = ServeEngine(tp_model, decode_chunk=4, mesh=mesh, **kw)
        with comm_audit() as prof:
            run(eng, serve_prompts(23, (7, 10)), 6)
        single = ServeEngine(tp_model, **kw)
        with comm_audit() as empty:
            run(single, serve_prompts(23, (7,)), 4)
        return {"profile": prof.to_json(), "counters": dict(eng.metrics.counters),
                "single_ops": empty.ops()}

    def errors():
        out = {}
        for key, fn in (
                ("divide", lambda: ServeEngine(model("kv1"), num_slots=2, max_len=64, mesh=mesh)),
                ("axis", lambda: ServeEngine(tp_model, num_slots=1, max_len=32,
                                             mesh=create_mesh({"data": 2}))),
                ("rule", lambda: ServeEngine(tp_model, num_slots=1, max_len=32,
                                             tp_rule=llama_tp_rule(mesh))),
                ("plan", lambda: ServeEngine(tp_model, num_slots=1, max_len=32,
                                             plan=llama_tp_plan(mesh))),
                ("both", lambda: ServeEngine(tp_model, num_slots=1, max_len=32, mesh=mesh,
                                             plan=llama_tp_plan(mesh),
                                             tp_rule=llama_tp_rule(mesh)))):
            try:
                fn()
                out[key] = None
            except ValueError as e:
                out[key] = str(e)
        return out

    def plan():
        m = model("plan")
        eng = ServeEngine(m, num_slots=2, max_len=32, mesh=mesh)
        h = eng.submit([1, 2, 3], max_new_tokens=4)
        while not h.done():
            eng.step()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            shim = ServeEngine(m, num_slots=2, max_len=32, mesh=mesh,
                               tp_rule=llama_tp_rule(mesh))
        return {"plan_type": type(eng.plan).__name__,
                "wq_spec": tuple(sharding_of(eng.params["blocks.0.attn.wq.weight"])[0].spec),
                "kv_spec": tuple(eng._kv_sharding.spec),
                "plan_kv_spec": tuple(eng.plan.maybe_spec_for("kv_cache", ())),
                "tokens": np.asarray(h.result().tokens),
                "warned": [x.category.__name__ for x in w], "shim_plan": shim.plan,
                "shim_tokens": run(shim, [np.asarray([1, 2, 3], np.int32)], 4)}

    def elastic(paged):
        def engine(tp, slots):
            kw = dict(max_len=64, prefill_buckets=(16,), decode_chunk=2)
            if paged:
                kw.update(page_size=8, num_pages=32)
            return ServeEngine(kv2_model, num_slots=slots, mesh=mesh if tp > 1 else None, **kw)

        def case():
            prompts = serve_prompts(7, (6, 9, 5, 11))
            ref = run(engine(2, 3), prompts, ELASTIC_MNT)
            src, dst = engine(2, 3), engine(1, 4)
            hs = [src.submit(p, max_new_tokens=m) for p, m in zip(prompts, ELASTIC_MNT)]
            for _ in range(2):
                src.step()
            src.drain()
            prof = CommProfile()
            with comm_audit(prof):
                summary = src.migrate_to(dst)
            while dst.step():
                pass
            return {"ref": ref, "tokens": [np.asarray(h.result().tokens) for h in hs],
                    "reasons": [h.result().finish_reason for h in hs], "summary": summary,
                    "profile": prof.to_json(),
                    "counters": {k: src.metrics.counters[k] for k in
                                 ("migration_wire_bytes", "requests_migrated_out")},
                    "in": dst.metrics.counters["requests_migrated_in"]}

        return case

    def handoff():
        def engine(tp):
            return ServeEngine(kv2_model, num_slots=4, max_len=64, prefill_buckets=(32,),
                               decode_chunk=2, mesh=mesh if tp > 1 else None)

        reqs = [dict(prompt=p, max_new_tokens=m)
                for p, m in zip(shared_prefix_prompts(13, 4), HANDOFF_MNT)]
        ref = toks(engine(1).run(reqs))
        pre, dec = engine(2), engine(1)
        fleet = ServeFleet([pre, dec], disaggregate=True, roles=["prefill", "decode"])
        prof = CommProfile()
        with comm_audit(prof):
            out = toks(fleet.run(reqs))
        c = pre.metrics.counters
        return {"ref": ref, "tokens": out, "profile": prof.to_json(),
                "pre": {k: c[k] for k in ("tokens_generated", "decode_dispatches",
                                          "requests_handed_off", "handoff_wire_bytes")},
                "dec": {k: dec.metrics.counters[k] for k in ("prefill_calls",
                                                             "requests_handed_in")},
                "events_wire": sum(e[2]["wire_bytes"] for e in fleet.events
                                   if e[0] == "handoff")}

    def int8_migrate():
        def engine(tp, slots=3):
            return ServeEngine(kv2_model, num_slots=slots, max_len=64, prefill_buckets=(16,),
                               kv_dtype="int8", decode_chunk=2, mesh=mesh if tp > 1 else None)

        prompts = serve_prompts(7, (6, 9, 5, 11))
        ref = run(engine(2), prompts, ELASTIC_MNT)
        src, dst = engine(2), engine(1, 4)
        hs = [src.submit(p, max_new_tokens=m) for p, m in zip(prompts, ELASTIC_MNT)]
        for _ in range(2):
            src.step()
        src.drain()
        prof = CommProfile()
        with comm_audit(prof):
            summary = src.migrate_to(dst)
        while dst.step():
            pass
        return {"ref": ref, "tokens": [np.asarray(h.result().tokens) for h in hs],
                "summary": summary, "profile": prof.to_json(),
                "scale_shape": tuple(src.cache.kv[0][2].shape)}

    def spec():
        def go(speculate, tp):
            return ServeEngine(tp_model, num_slots=2, max_len=64, prefill_buckets=(16,),
                               decode_mode="persistent", speculate=speculate,
                               mesh=mesh if tp > 1 else None)

        prompts = [np.asarray(p, np.int32) for p in CYCLIC_PROMPTS]
        base = run(go(0, 1), prompts, 16)
        eng = go(2, 2)
        with comm_audit() as prof:
            got = run(eng, prompts, 16)
        return {"base": base, "tokens": got, "profile": prof.to_json(),
                "counters": dict(eng.metrics.counters)}

    yield "slab4", slab4
    yield "paged_persistent", paged_persistent
    yield "audit", audit
    yield "errors", errors
    yield "plan", plan
    yield "elastic_slab", elastic(False)
    yield "elastic_paged", elastic(True)
    yield "handoff", handoff
    yield "int8_migrate", int8_migrate
    yield "spec", spec
    dist.barrier()


def _numerics(payload):
    """The numerics observatory of the train steps at world 1 or 2: each
    step's digests of ``ShardedTrainStep`` (FSDP over every rank) and of
    ``GSPMDTrainStep`` (``dp``, and TP under ``llama_tp_plan``) on tiny
    Llama with JAX weights, the FSDP step's comm audit, a poisoned
    parameter's provenance, and (world 2) the refusal of numerics on a TP
    serving engine."""
    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.obs.comm import comm_audit
    from torchdistx_tpu_torch.obs.numerics import NumericsBook, fetch_digests
    from torchdistx_tpu_torch.parallel import (GSPMDTrainStep, ShardedTrainStep, create_mesh,
                                               llama_tp_plan)
    from torchdistx_tpu_torch.serve import ServeEngine

    world = dist.get_world_size()
    batch = tuple(torch.from_numpy(a) for a in payload["batch"])

    def model():
        m = Llama.from_name("tiny", device="cpu")
        return load_jax_params(m, payload["init"])

    def loss_fn(mod, b):
        return F.cross_entropy(mod(b[0]), b[1])

    def steps(make, poison=None):
        def case():
            m = model()
            if poison:
                with torch.no_grad():
                    m.get_parameter(poison).fill_(float("nan"))
            step = make(m, torch.optim.SGD(m.parameters(), lr=payload["lr"]))
            book, trees, profile = NumericsBook(), [], None
            for i in range(payload["steps"]):
                with comm_audit() as prof:
                    step(m, step.optimizer, batch)
                profile = profile or prof.to_json()
                (tree,) = fetch_digests([step.last_digests])
                book.update_tree(tree, step=i)
                trees.append({k: d.to_json() for k, d in tree.items()})
            return {"trees": trees, "book": book.to_json(), "profile": profile}
        return case

    def fsdp(m, opt):
        return ShardedTrainStep(m, opt, loss_fn, create_mesh({"fsdp": world}),
                                shard_axis="fsdp", numerics=True)

    def gspmd_dp(m, opt):
        return GSPMDTrainStep(m, opt, loss_fn, create_mesh({"dp": world}), batch_spec=("dp",),
                              numerics=True)

    def gspmd_tp(m, opt):
        mesh = create_mesh({"tp": world})
        return GSPMDTrainStep(m, opt, loss_fn, mesh, plan=llama_tp_plan(mesh), numerics=True)

    def tp_engine():
        # ported: numerics on a TP engine builds and serves (its books:
        # tests/test_torch_serve_tp_numerics.py)
        mesh = create_mesh({"tp": world})
        try:
            eng = ServeEngine(model(), max_len=64, mesh=mesh, numerics=True)
        except NotImplementedError as e:
            return {"refused": str(e)}
        eng.run([{"prompt": np.arange(1, 6, dtype=np.int32), "max_new_tokens": 3}])
        return {"refused": None, "sites": eng.numerics_book.sites(),
                "logits_count": eng.numerics_book.digest("logits").count,
                "errors": eng.numerics_harvest_errors}

    yield "fsdp", steps(fsdp)
    yield "gspmd_dp", steps(gspmd_dp)
    yield "gspmd_tp", steps(gspmd_tp)
    yield "fsdp_poison", steps(fsdp, poison=payload["poison"])
    if world > 1:
        yield "tp_engine", tp_engine


#: the runs of the serve_tp_numerics suite: a bf16 slab chunked, a paged
#: int8 cache chunked and persistent (eager on the CPU)
TP_NUMERICS_RUNS = {
    "slab_bf16": {"decode_chunk": 1},
    "paged_int8": {"page_size": 8, "kv_dtype": "int8"},
    "paged_int8_persistent": {"page_size": 8, "kv_dtype": "int8",
                              "decode_mode": "persistent"},
}
TP_NUMERICS_KW = dict(num_slots=3, max_len=64, prefill_buckets=(16, 32))
TP_NUMERICS_FOLDED = ("kv_quant_err", "kv_quant_scale")


def tp_numerics_requests():
    rs = np.random.RandomState(5)
    return [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32), "max_new_tokens": 8}
            for n in (5, 9, 12, 20, 7)]


def digest_fields(d) -> tuple:
    """A host digest as a picklable tuple: the integer fields, then
    ``max_abs`` and ``sumsq``."""
    return (d.nonfinite, d.zeros, d.count, tuple(d.exp_hist), d.max_abs, d.sumsq)


def _serve_tp_numerics(payload):
    """Numerics under TP serving on two ranks (tiny Llama with the JAX
    model's weights, 2 KV heads: one a rank), each run of
    :data:`TP_NUMERICS_RUNS` with numerics on and off.  With it on, every
    KV tap is also all-gathered over ``tp`` and digested whole (the tape's
    ``hold`` wrapped): the reference the folded book must equal."""
    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.obs import numerics as tn
    from torchdistx_tpu_torch.obs.comm import comm_audit
    from torchdistx_tpu_torch.parallel import create_mesh
    from torchdistx_tpu_torch.serve import ServeEngine

    mesh = create_mesh({"tp": 2})
    group = mesh.axes["tp"].group
    m = Llama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(m, payload["weights"])
    hold = tn.Tape.hold

    def run(kw, numerics):
        whole = {}

        def gathering_hold(tape, site, *parts, make=None):
            if site in TP_NUMERICS_FOLDED:
                x = (parts[0] if make is None else make(*parts)).detach().float().reshape(-1)
                pieces = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
                dist.all_gather(pieces, x, group=group)
                d = tn.array_digest(torch.cat(pieces))
                whole[site] = d if site not in whole else tn.merge_digests(whole[site], d)
            return hold(tape, site, *parts, make=make)

        eng = ServeEngine(m, mesh=mesh, numerics=numerics, **TP_NUMERICS_KW, **kw)
        tn.Tape.hold = gathering_hold if numerics else hold
        try:
            with comm_audit() as prof:
                res = eng.run(tp_numerics_requests())
        finally:
            tn.Tape.hold = hold
        book = eng.numerics_book
        return {"tokens": [np.asarray(r.tokens) for r in res],
                "counters": dict(eng.metrics.counters), "profile": prof.to_json(),
                "sites": book.sites(),
                "book": {s: digest_fields(book.digest(s)) for s in book.sites()},
                "whole": {s: digest_fields(tn.HostDigest.from_device(d))
                          for s, d in whole.items()},
                "errors": eng.numerics_harvest_errors,
                "kv_quant_err_max": eng.metrics.kv_quant_err_max}

    for name, kw in TP_NUMERICS_RUNS.items():
        yield name, (lambda kw=kw: {"on": run(kw, True), "off": run(kw, False)})


#: the examples' tiny runs, shared with the parent's world-1 runs
EXAMPLE_GPT2 = dict(batch=8, seq=64, steps=3)
EXAMPLE_SP = dict(seq=64, steps=3)


def _examples(payload):
    """The port's examples in a world of two ranks: ``train_gpt2`` FSDP over
    ``{"fsdp": 2}`` (plain and fused loss, and fused from the payload's JAX
    weights ``gpt2_init`` on its ``gpt2_stream``) and ``long_context_sp``
    over ``{"sp": 2}`` (ring and Ulysses)."""
    from torchdistx_tpu_torch.examples import long_context_sp, train_gpt2
    from torchdistx_tpu_torch.parallel.mesh import sharding_of

    def gpt2(fused, **kw):
        out = train_gpt2.main("tiny", fused_ce=fused, device="cpu", log_fn=lambda m: None,
                              **EXAMPLE_GPT2, **kw)
        return {"losses": out["losses"], "n_params": out["n_params"],
                "pieces": {n: (tuple(p.shape), tuple(sharding_of(p)[1]) if sharding_of(p)
                               else tuple(p.shape))
                           for n, p in out["model"].named_parameters()}}

    def sp(mode):
        out = long_context_sp.main(sp_mode=mode, device="cpu", log_fn=lambda m: None,
                                   **EXAMPLE_SP)
        return {k: out[k] for k in ("ranks", "losses", "biased_out_shape",
                                    "biased_out_finite")}

    yield "gpt2", lambda: gpt2(False)
    yield "gpt2_fused", lambda: gpt2(True)
    yield "gpt2_jax", lambda: gpt2(True, params=payload["gpt2_init"],
                                   stream=payload["gpt2_stream"])
    yield "sp_ring", lambda: sp("ring")
    yield "sp_ulysses", lambda: sp("ulysses")


SUITES = {"collectives": _collectives, "ring": _ring, "fsdp": _fsdp, "sp_llama": _sp_llama,
          "gossip": _gossip, "plan": _plan, "tp": _tp, "moe_ep": _moe_ep, "data": _data,
          "sp_models": _sp_models, "zero2": _zero2, "pp": _pp, "reshard": _reshard,
          "serve_tp": _serve_tp, "comm_audit": _comm_audit, "numerics": _numerics,
          "serve_tp_numerics": _serve_tp_numerics, "examples": _examples}
