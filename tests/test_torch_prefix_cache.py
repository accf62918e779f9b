"""The port's ``PagePool`` and ``RadixPrefixIndex`` against the JAX
package's: the same operation sequences through both must give the same
allocations, matches, adoptions and evictions, and leave the same state.
Host-only code; the port keeps its own copy."""

import numpy as np
import pytest
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.serve import prefix_cache as jpc
from torchdistx_tpu_torch.serve import prefix_cache as tpc


def _state(pool, index):
    return (pool.free_count, pool.in_use, pool.high_water,
            [pool.refcount(p) for p in range(pool.num_pages)], len(index))


def _drive(mod, seed, num_pages, page_size, steps=120):
    """A random admit / finish / evict workload over prompts that share
    prefixes, recording every result."""
    rs = np.random.RandomState(seed)
    pool, index = mod.PagePool(num_pages), mod.RadixPrefixIndex(page_size)
    stems = [rs.randint(0, 5, 3 * page_size) for _ in range(3)]
    live, log = [], []
    for _ in range(steps):
        op = rs.randint(4)
        if op < 2:  # admit: match, pin, evict under pressure, allocate, adopt
            stem = stems[rs.randint(len(stems))]
            n = rs.randint(1, 3 * page_size)
            prompt = np.concatenate([stem[: rs.randint(0, stem.size)],
                                     rs.randint(0, 5, n)])
            hit = index.match(prompt)
            probe = index.match_len(prompt)
            need = -(-(prompt.size + 2) // page_size) - len(hit)
            pool.incref(hit)
            evicted = 0
            if pool.free_count < need:
                evicted = index.evict(pool, need - pool.free_count)
            if pool.free_count < need:
                pool.decref(hit)
                log.append(("refused", hit, probe, evicted))
                continue
            pages = hit + pool.alloc(need)
            n_full = prompt.size // page_size
            adopted = index.insert(prompt[: n_full * page_size], pages[:n_full], pool)
            live.append(pages)
            log.append(("admit", hit, probe, evicted, pages, adopted))
        elif op == 2 and live:  # finish
            pages = live.pop(rs.randint(len(live)))
            log.append(("finish", pool.decref(pages)))
        else:  # eviction sweep
            log.append(("evict", index.evict(pool, rs.randint(1, 4))))
        log.append(_state(pool, index))
    return log


@pytest.mark.parametrize("seed,num_pages,page_size",
                         [(0, 16, 2), (1, 9, 4), (2, 40, 3), (3, 12, 1)])
def test_same_operations_same_results(seed, num_pages, page_size):
    ref = _drive(jpc, seed, num_pages, page_size)
    out = _drive(tpc, seed, num_pages, page_size)
    assert out == ref
    assert any(e[0] == "admit" and e[1] for e in ref if isinstance(e[0], str))


def test_scratch_page_and_errors_match():
    assert tpc.SCRATCH_PAGE == jpc.SCRATCH_PAGE == 0
    for mod in (jpc, tpc):
        pool = mod.PagePool(4)
        assert pool.capacity == 3 and pool.alloc(3) == [1, 2, 3]
        with pytest.raises(RuntimeError, match="over-allocated"):
            pool.alloc(1)
        with pytest.raises(RuntimeError, match="incref of free page"):
            mod.PagePool(4).incref([2])
        with pytest.raises(ValueError, match="num_pages"):
            mod.PagePool(1)
        with pytest.raises(ValueError, match="page-aligned"):
            mod.RadixPrefixIndex(4).insert([1, 2, 3], [1], pool)
