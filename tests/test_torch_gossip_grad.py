"""The port's GossipGraD (``parallel.gossip_grad``) and divergent replicas
(``ShardedTrainStep(divergent_replicas=True)``) against the JAX package.

- The schedule in one process: ``topologies_set``, ``branch_table()`` and
  the sequence of ``(current_topology_idx, current_power, step_args())``
  over three rotation windows equal JAX's exactly, for 2, 4, 6, 17 and 64
  nodes, both topologies (CUBE at even counts), ``num_modules`` 1 and 3;
  the cap's warning at 17 and 64 nodes equals JAX's.  The argument checks
  and ``get_num_modules``.
- The hook on a pinned topology, at world 4 on ``gloo`` (and 6 for CUBE's
  node without a peer), against JAX's ``shard_map`` on 4 (6) of its 8 CPU
  devices: equal exactly (a mean of two and a halved sum, the same
  roundings).
- Divergent training of tiny Llama (f32) at world 4, 5 steps, weights from
  ``load_jax_params``, AnyPrecisionAdamW (lr 1e-3, f32 variance) on both
  sides: GossipGraD with ``shard_axis="local"`` at 2 nodes x 2 local (the
  JAX README's composition), GossipGraD at 4 x 1 in each topology (two
  rotation windows and a third begun), and ``noop_hook`` with the batch
  over ``("node", "local")``.  Each rank at node index i is held against
  ``p[k][i]`` of JAX's stacked parameters after every step, and
  ``consensus()`` against JAX's.  Tolerances those of
  ``tests/test_torch_fsdp.py``: losses rtol = atol = 1e-5; parameters all
  within 1e-4 and 99.9% within 1e-5, the share counted over the whole
  replica (see ``close_params``).
"""

import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from _torch_dist_worker import (
    GOSSIP_HOOKS,
    GOSSIP_TRAINS,
    WORLD,
    gossip_grads,
    lm_batch,
    spawn_world,
)
from torchdistx_tpu import nn as jnn
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.nn import functional as jF
from torchdistx_tpu.nn import functional_call
from torchdistx_tpu.optimizers import anyprecision_adamw
from torchdistx_tpu.parallel import GossipGraDState as JState
from torchdistx_tpu.parallel import ShardedTrainStep as JStep
from torchdistx_tpu.parallel import Topology as JTopology
from torchdistx_tpu.parallel import get_num_modules as jget_num_modules
from torchdistx_tpu.parallel import gossip_grad_hook as jhook
from torchdistx_tpu.parallel import hierarchical_mesh as jhierarchical_mesh
from torchdistx_tpu.parallel import noop_hook as jnoop
from torchdistx_tpu.parallel.comm_hooks import HookContext as JContext
from torchdistx_tpu.parallel.compat import shard_map
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.parallel import INVALID_PEER, GossipGraDState, Topology, get_num_modules

LR, STEPS = 1e-3, 5
SCHEDULES = [(n, t) for n in (2, 4, 6, 17, 64) for t in ("CUBE", "DISSEMINATION")
             if not (t == "CUBE" and n % 2)]


def _made(cls, *args, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = cls(*args, **kw)
    return state, [str(w.message) for w in caught]


@pytest.mark.parametrize("num_modules", [1, 3])
@pytest.mark.parametrize("num_nodes,topology", SCHEDULES)
def test_schedule_matches_jax(num_nodes, topology, num_modules):
    t, t_warned = _made(GossipGraDState, num_nodes, topology=Topology[topology],
                        num_modules=num_modules)
    j, j_warned = _made(JState, num_nodes, topology=JTopology[topology],
                        num_modules=num_modules)
    assert t_warned == j_warned
    assert len(t_warned) == (num_nodes in (17, 64))
    assert [tuple(x) for x in t.topologies_set] == [tuple(x) for x in j.topologies_set]
    assert t.gossip_period == j.gossip_period
    assert t.branch_table() == j.branch_table()
    seq = []
    for _ in range(3 * t.gossip_period * num_modules):
        got = (t.current_topology_idx, t.current_power, t.step_args())
        want = (j.current_topology_idx, j.current_power, int(j.step_args()))
        assert type(got[2]) is int
        seq.append(got)
        assert got == want
        t.advance()
        j.advance()
    # one draw per rotation window, in cycle order
    window = t.gossip_period * num_modules
    assert [idx for idx, _, _ in seq[::window]] == [w % len(t.topologies_set) for w in range(3)]


def test_argument_checks_match_jax():
    for cls, topo in ((GossipGraDState, Topology), (JState, JTopology)):
        with pytest.raises(ValueError, match="uneven number of nodes for CUBE"):
            cls(3, topology=topo.CUBE)
        with pytest.raises(ValueError, match="at least 2 nodes"):
            cls(1)
        with pytest.raises(ValueError, match="cannot hold even one"):
            cls(64, max_branches=4)
        assert cls(4).topology is topo.DISSEMINATION
    assert INVALID_PEER == -1


def test_get_num_modules_matches_jax():
    class TBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(4, 4)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.b1, self.b2 = TBlock(), TBlock()

    class JBlock(jnn.Module):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(4, 4)

    class JNet(jnn.Module):
        def __init__(self):
            super().__init__()
            self.b1, self.b2 = JBlock(), JBlock()

    assert get_num_modules(TNet()) == jget_num_modules(JNet()) == 2
    assert get_num_modules(torch.nn.Linear(4, 4)) == jget_num_modules(jnn.Linear(4, 4)) == 1
    assert get_num_modules(torch.nn.Module()) == jget_num_modules(jnn.Module()) == 1
    tiny = TLlama.from_name("tiny", device="cpu")
    assert get_num_modules(tiny) == jget_num_modules(JLlama.from_name("tiny")) == 21


def _jax_init():
    tdx.manual_seed(0)
    jm = tdx.deferred_init(JLlama.from_name, "tiny")
    tdx.materialize_module(jm)
    return jm, {k: np.asarray(v) for k, v in jm.named_parameters()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    _, init = _jax_init()
    payload = dict(part="gossip", init=init, lr=LR, steps=STEPS, batch=lm_batch(8, 32))
    return spawn_world("gossip", tmp_path_factory.mktemp("gossip"), payload)


@pytest.fixture(scope="module")
def world6(tmp_path_factory):
    return spawn_world("gossip", tmp_path_factory.mktemp("gossip6"), {"part": "cube6"}, world=6)


def got(world, name):
    res = [r[name] for r in world]
    for r in res:
        assert "error" not in r, r["error"]
    return res


def _jax_hook(name):
    nodes, topology, perm, iteration = GOSSIP_HOOKS[name]
    n = 6 if nodes == 6 else WORLD
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(nodes, n // nodes), ("node", "local"))
    state = JState(nodes, topology=JTopology[topology], seed=0)
    state.topologies_set = [tuple(perm)]
    state.topology_cycle = itertools.cycle([0])
    state.iteration = iteration
    spec = P(("node", "local"))

    def body(g):
        ctx = JContext(replica_axes=("node", "local"), step=state.step_args())
        return jhook(state, g, ctx)

    grads = {k: jnp.asarray(v) for k, v in gossip_grads(name, n).items()}
    out = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)(grads)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", ["cube_2x2", "dissemination_4x1_power1",
                                  "dissemination_4x1_permuted"])
def test_hook_matches_jax(world, name):
    want = _jax_hook(name)
    for rank, r in enumerate(got(world, f"hook_{name}")):
        for k in want:
            np.testing.assert_array_equal(r[k], want[k][rank], err_msg=f"{k} rank {rank}")


def test_cube_node_without_peer_keeps_its_gradient(world6):
    want = _jax_hook("cube_6x1_power2")
    mine = gossip_grads("cube_6x1_power2", 6)
    for rank, r in enumerate(got(world6, "hook_cube_6x1_power2")):
        for k in want:
            np.testing.assert_array_equal(r[k], want[k][rank])
            if rank in (2, 3):  # peers 6 and 7 do not exist
                np.testing.assert_array_equal(r[k], mine[k][rank])


def jax_divergent(nodes, kw, hook, state, tx, steps):
    """JAX's divergent ShardedTrainStep of tiny Llama on 4 CPU devices:
    the losses, the stacked parameters after each step and ``consensus``."""
    jm, init = _jax_init()

    def loss_fn(p, b):
        return jF.cross_entropy(functional_call(jm, p, (b[0],)), b[1])

    mesh = jhierarchical_mesh(nodes, devices=jax.devices()[:WORLD])
    step = JStep(loss_fn, tx, mesh, replica_axes=("node",), comm_hook=hook, hook_state=state,
                 divergent_replicas=True, **kw)
    params = step.stack_replicas({k: jnp.asarray(v) for k, v in init.items()})
    opt = step.init_optimizer(params)
    batch = tuple(jnp.asarray(a.astype(np.int32)) for a in lm_batch(8, 32))
    losses, snapshots = [], []
    for _ in range(steps):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        # a copy: the next step donates the buffers np.asarray would view
        snapshots.append({k: np.array(v) for k, v in params.items()})
    consensus = {k: np.asarray(v) for k, v in step.consensus(params).items()}
    return losses, snapshots, consensus


def close_params(got, want, what=""):
    """Every element within 1e-4; 99.9% of the replica's elements within
    1e-5, counted over all its parameters: an element whose first gradient
    is about Adam's eps (1e-8) moves by lr * g / (|g| + eps), which the last
    bits of g decide, and one such element of a 64-wide norm is 1.6% of
    that tensor."""
    near = total = 0
    for name, w in want.items():
        diff = np.abs(got[name] - w)
        assert diff.max() <= 1e-4, (what, name, diff.max())
        near, total = near + np.sum(diff <= 1e-5), total + diff.size
    assert near >= 0.999 * total, (what, near / total)


def hold_divergent(results, losses, snapshots, consensus):
    """Every rank (node index i) against JAX's replica i after each step."""
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5, atol=1e-5)
        i = r["node"]
        for s, (mine, theirs) in enumerate(zip(r["snapshots"], snapshots)):
            close_params(mine, {k: v[i] for k, v in theirs.items()}, f"rank {rank} step {s + 1}")
        close_params(r["consensus"], consensus, f"rank {rank} consensus")


@pytest.mark.parametrize("name", list(GOSSIP_TRAINS))
def test_divergent_training_matches_jax(world, name):
    nodes, kw, topology = GOSSIP_TRAINS[name]
    if topology is None:
        hook, state = jnoop, None
    else:
        hook, state = jhook, JState(nodes, topology=JTopology[topology])
    tx = anyprecision_adamw(LR, variance_dtype=jnp.float32)
    hold_divergent(got(world, name), *jax_divergent(nodes, kw, hook, state, tx, STEPS))


def test_divergent_grads_use_full_node_batch(world):
    batch = np.arange(16.0)
    for r in got(world, "full_node_batch"):
        i = r["node"]
        np.testing.assert_allclose(r["w"], [-np.mean(batch[8 * i:8 * (i + 1)])], rtol=1e-6)


def test_divergent_replicas_needs_one_replica_axis():
    from torchdistx_tpu_torch.parallel import ShardedTrainStep, hierarchical_mesh

    m = torch.nn.Linear(2, 2)
    for axes in ((), ("node", "local")):
        with pytest.raises(ValueError, match="exactly one replica axis"):
            ShardedTrainStep(m, torch.optim.SGD(m.parameters(), lr=0.1), lambda *_: None,
                             hierarchical_mesh(1), shard_axis=None, replica_axes=axes,
                             divergent_replicas=True)
