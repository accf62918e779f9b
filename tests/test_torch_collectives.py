"""The port's collectives (``torchdistx_tpu_torch.parallel.collectives``)
at world size 4 on ``gloo``, against the JAX package's in ``shard_map`` on
4 of the 8 CPU devices: over a 1-D ``sp`` mesh and a (2, 2) ``("dp",
"sp")`` mesh, on tensors and on a dict tree, and the VJPs of
``allreduce_linear`` and ``copy_psum_grad``.

One spawned world runs every case (``tests/_torch_dist_worker.py``); each
case is its own test here.  Tolerance: data movement (shift, exchange,
broadcast, gather) exactly; sums rtol = atol = 1e-6 in f32 (gloo and XLA
add the 4 ranks in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
from _torch_dist_worker import WORLD, coll_input, spawn_world
from torchdistx_tpu.parallel import collectives as C
from torchdistx_tpu.parallel.compat import shard_map

SUM_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_world("collectives", tmp_path_factory.mktemp("collectives"))


def _mesh(grid):
    devs = np.array(jax.devices()[:WORLD])
    return Mesh(devs.reshape(2, 2), ("dp", "sp")) if grid else Mesh(devs, ("sp",))


def _jax(fn, seeds, grid=False, shapes=None):
    """fn over the per-rank operands of ``seeds`` in shard_map; each rank's
    output (the per-device outputs stacked along dim 0, split back)."""
    spec = P(("dp", "sp")) if grid else P("sp")
    shapes = shapes or [(2, 8)] * len(seeds)
    args = [jnp.asarray(coll_input(s, sh).reshape(-1, *sh[1:])) for s, sh in zip(seeds, shapes)]
    out = shard_map(fn, mesh=_mesh(grid), in_specs=tuple(spec for _ in args),
                    out_specs=spec, check_vma=False)(*args)
    return [jax.tree_util.tree_map(lambda a: np.split(np.asarray(a), WORLD, axis=0)[r], out)
            for r in range(WORLD)]


def _got(ranks, name):
    res = [r[name] for r in ranks]
    for r in res:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    return res


SEND_RING, SEND_PARTIAL = [1, 2, 3, 0], [2, -1, 0, -1]
# (case, jax fn, seeds, grid, exact, shapes)
CASES = [
    ("all_reduce", lambda x: C.all_reduce(x, "sp"), [0], False, False, None),
    ("all_mean", lambda x: C.all_mean(x, "sp"), [1], False, False, None),
    ("broadcast", lambda x: C.broadcast(x, "sp", source=2), [2], False, False, None),
    ("exchange_ring", lambda x: C.exchange(x, "sp", SEND_RING, [3, 0, 1, 2]), [3], False,
     True, None),
    ("exchange_self", lambda x: C.exchange(x, "sp", SEND_PARTIAL, SEND_PARTIAL), [4], False,
     True, None),
    ("exchange_zero", lambda x: C.exchange(x, "sp", SEND_PARTIAL, SEND_PARTIAL, fill="zero"),
     [4], False, True, None),
    ("shift_1", lambda x: C.shift(x, "sp"), [5], False, True, None),
    ("shift_m1", lambda x: C.shift(x, "sp", -1), [5], False, True, None),
    ("all_gather_0", lambda x: C.all_gather(x, "sp"), [6], False, True, None),
    ("all_gather_1", lambda x: C.all_gather(x, "sp", tiled_axis=1), [6], False, True, None),
    ("reduce_scatter_0", lambda x: C.reduce_scatter(x, "sp"), [7], False, False, [(8, 4)]),
    ("reduce_scatter_1", lambda x: C.reduce_scatter(x, "sp", scatter_axis=1), [7], False,
     False, None),
    ("tree", lambda a, b, c: C.all_reduce({"a": a, "b": [b, c]}, "sp"), [8, 9, 10], False,
     False, None),
    ("grid_all_reduce_dp", lambda x: C.all_reduce(x, "dp"), [13], True, False, None),
    ("grid_all_mean_both", lambda x: C.all_mean(x, ("dp", "sp")), [14], True, False, None),
    ("grid_shift_sp", lambda x: C.shift(x, "sp"), [15], True, True, None),
    ("grid_all_gather_dp", lambda x: C.all_gather(x, "dp"), [16], True, True, None),
    ("grid_reduce_scatter_sp", lambda x: C.reduce_scatter(x, "sp"), [17], True, False,
     [(4, 8)]),
    ("grid_broadcast_dp", lambda x: C.broadcast(x, "dp", source=1), [18], True, False, None),
]


@pytest.mark.parametrize("name,fn,seeds,grid,exact,shapes", CASES, ids=[c[0] for c in CASES])
def test_collective_matches_jax(ranks, name, fn, seeds, grid, exact, shapes):
    want = _jax(fn, seeds, grid, shapes)
    for r, got in enumerate(_got(ranks, name)):
        w = want[r]
        for g, x in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(w)):
            if exact:
                np.testing.assert_array_equal(g, x, err_msg=f"{name} rank {r}")
            else:
                np.testing.assert_allclose(g, x, **SUM_TOL, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("grid", [False, True], ids=["sp", "dp_sp"])
def test_axis_index_and_size(ranks, grid):
    if grid:
        fn = lambda x: jnp.stack([C.axis_index("dp"), C.axis_index("sp")])[None]  # noqa: E731
        name = "grid_axis_index"
    else:
        fn = lambda x: jnp.stack([C.axis_index("sp"), C.axis_size("sp")])[None]  # noqa: E731
        name = "axis_index_size"
    want = _jax(fn, [0], grid, [(1, 1)])
    for r, got in enumerate(_got(ranks, name)):
        np.testing.assert_array_equal(got, want[r][0])


def test_mesh_helpers_match_jax(ranks):
    from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
    from torchdistx_tpu.parallel import hierarchical_mesh as jhier
    from torchdistx_tpu.parallel.mesh import local_mesh_size as jlocal

    devs = jax.devices()[:WORLD]
    hier, wild = jhier(2, devices=devs), jcreate_mesh({"dp": -1, "sp": 2}, devices=devs)
    for r, got in enumerate(_got(ranks, "mesh_helpers")):
        assert got["hier"] == dict(hier.shape) and got["wild"] == dict(wild.shape)
        assert got["hier_index"] == [r // 2, r % 2]
        assert got["local"] == jlocal(wild, "sp")
        assert got["cut"] == [2 * r, 2 * r + 2] and got["replicated"]


def test_create_mesh_argument_errors():
    from torchdistx_tpu.parallel import create_mesh as jcreate_mesh
    from torchdistx_tpu_torch.parallel import create_mesh

    devs = jax.devices()[:1]
    for axes, match in (({"dp": -1, "sp": -1}, "at most one axis size may be -1"),
                        ({"dp": 3}, "wants 3 devices, have 1"),
                        ({"dp": -1, "sp": 2}, "not divisible by fixed axes product 2")):
        with pytest.raises(ValueError, match=match):
            jcreate_mesh(axes, devices=devs)
        with pytest.raises(ValueError, match=match):
            create_mesh(axes)


@pytest.mark.parametrize("name,seed", [("allreduce_linear", 11), ("copy_psum_grad", 12)])
def test_custom_vjp_matches_jax(ranks, name, seed):
    op = getattr(C, name)

    def fn(a, ct):
        y, pull = jax.vjp(lambda t: op(t, "sp"), a)
        return {"g": pull(ct)[0], "y": y}

    want = _jax(fn, [seed, seed + 100])
    for r, got in enumerate(_got(ranks, name)):
        np.testing.assert_allclose(got["y"], want[r]["y"], **SUM_TOL)
        np.testing.assert_allclose(got["g"], want[r]["g"], **SUM_TOL)


def test_init_multihost_refuses_a_missing_card():
    """Without a CUDA device and without ``device="cpu"`` / ``backend="gloo"``,
    ``init_multihost`` raises instead of falling back to ``gloo``."""
    import torch
    import torch.distributed as dist

    from torchdistx_tpu_torch.parallel import init_multihost

    if torch.cuda.is_available():
        pytest.skip("this host has a card: NCCL would start")
    for kw in ({}, {"backend": "nccl"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
            init_multihost(num_processes=1, process_id=0, **kw)
    assert not dist.is_initialized()


def test_world_one_mesh_needs_no_process_group():
    """A mesh of size-1 axes works without a process group: every collective
    over it is the identity, the ring of one block included."""
    import torch

    from torchdistx_tpu_torch.parallel import collectives as TC
    from torchdistx_tpu_torch.parallel import create_mesh

    x = torch.arange(6.0).reshape(2, 3)
    with create_mesh({"dp": 1, "sp": 1}):
        for out in (TC.all_reduce(x, ("dp", "sp")), TC.all_mean(x, "sp"), TC.shift(x, "sp"),
                    TC.all_gather(x, "dp", 1), TC.reduce_scatter(x, "sp"),
                    TC.broadcast(x, "dp"), TC.exchange(x, "sp", [0], [0])):
            assert torch.equal(out, x)
        assert (TC.axis_index("sp"), TC.axis_size("dp")) == (0, 1)
    with pytest.raises(NameError, match="unbound axis name"):
        TC.axis_index("sp")
