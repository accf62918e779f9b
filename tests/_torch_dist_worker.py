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


def _fsdp(payload):
    import torch
    import torch.distributed as dist

    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.interop import load_jax_params
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import (
        ShardedTrainStep,
        allreduce_hook,
        create_mesh,
        fsdp_partition_spec,
        fsdp_shard_rule,
        noop_hook,
    )
    from torchdistx_tpu_torch.parallel.mesh import sharding_of

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

    def train(mesh, **kw):
        def case():
            tt.manual_seed(0)
            m = tt.deferred_init(Llama.from_name, "tiny", device="cpu")
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

    yield "specs", specs
    yield "materialize", materialize
    yield "train_fsdp4", train(fsdp, shard_axis="fsdp")
    yield "train_dp2_fsdp2_allreduce", train(grid, shard_axis="fsdp", replica_axes=("dp",),
                                             comm_hook=allreduce_hook)
    yield "train_dp2_fsdp2_noop", train(grid, shard_axis="fsdp", replica_axes=("dp",),
                                        comm_hook=noop_hook)
    yield "train_fsdp4_accum2", train(fsdp, shard_axis="fsdp", accum_steps=2,
                                      batch_axes=("fsdp",))


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


SUITES = {"collectives": _collectives, "ring": _ring, "fsdp": _fsdp, "sp_llama": _sp_llama,
          "gossip": _gossip}
