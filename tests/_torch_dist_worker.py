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


def coll_input(seed: int, shape=(2, 8)) -> np.ndarray:
    """Rank r's operand of a collective case: (WORLD, *shape), row r."""
    return np.random.RandomState(seed).randn(WORLD, *shape).astype(np.float32)


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


SUITES = {"collectives": _collectives, "ring": _ring, "fsdp": _fsdp, "sp_llama": _sp_llama}
