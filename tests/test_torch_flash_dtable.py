"""The bucket-table gradient kernel's own algorithm, in plain PyTorch on the
CPU, against the JAX package's table gradient.

``flash_dtable_tiled_reference`` repeats what the dtable kernel of
``torchdistx_tpu_torch/csrc/flash_bwd.cu`` does, with small tiles: per
(block_q x block_k, head) tile the batch sum of ``p * (dP - delta)`` over
inputs zero-filled past S (as TMA fills Q, dO, K and V) with lse and delta
0 for rows past S; every element outside the visible region zeroed (rows
and key columns past S, the causal upper triangle); the tile's diagonals
summed in row order into its distances, the distances into their buckets
in distance order, and the tiles' bucket partials summed in tile order.
The same numpy inputs (from a seed) go through ``jax.vjp`` of the JAX
``flash_attention`` with ``rel_bias_table=`` (the Pallas forward, backward
and dtable kernels in interpret mode); o and lse come from the port's plain
forward.  f32 throughout; rtol 3e-4 and atol 3e-5, the tolerance at which
``tests/test_torch_flash_bias.py`` holds dtable (sums in another order).
Without a causal mask, a fold that leaves the key columns past S unmasked
must miss that tolerance: the trap the kernel's mask guards.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.ops.flash_attention import flash_attention as j_flash
from torchdistx_tpu_torch.ops import flash_attention as tflash

GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
D = 16
B = 2


def flash_dtable_tiled_reference(q, k, v, o, lse, do, table, bucket_cfg, *, causal,
                                 scale=None, block_q=16, block_k=8, mask_keys=True):
    """The dtable kernel's algorithm in f32 (see the module docstring);
    ``mask_keys=False`` leaves the key columns past S unmasked."""
    b, s, hq, d = q.shape
    buckets, max_dist, bidirectional = bucket_cfg
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    ids = tflash.rel_bucket_ids(s, s, bidirectional=bidirectional, buckets=buckets,
                                max_dist=max_dist).long()
    delta = tflash.flash_bwd_delta_reference(o, do)
    nq, nk = -(-s // block_q), -(-s // block_k)

    def rows_padded(x, n):  # (B, S, H, D) f32, zero rows up to n
        return torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, n - s))

    n_rep = hq // k.shape[2]
    qp, dop = rows_padded(q, nq * block_q), rows_padded(do, nq * block_q)
    kp, vp = (rows_padded(x.repeat_interleave(n_rep, dim=2), nk * block_k) for x in (k, v))
    lsep, deltap = (torch.nn.functional.pad(x.float(), (0, nq * block_q - s))
                    for x in (lse, delta))
    parts = []
    for qt in range(nq):
        for kt in range(nk):
            q0, k0 = qt * block_q, kt * block_k
            rows = torch.arange(q0, q0 + block_q)[:, None]
            cols = torch.arange(k0, k0 + block_k)[None, :]
            rel = cols - rows
            in_range = (rel > -s) & (rel < s)
            tile_ids = ids[(rel + s - 1).clamp(0, 2 * s - 2)]
            bias = torch.where(in_range, table.float()[:, tile_ids], 0.0)
            acc = torch.zeros(hq, block_q, block_k)
            for bb in range(b):  # the batch in order
                qs, dos = qp[bb, q0:q0 + block_q], dop[bb, q0:q0 + block_q]
                ks, vs = kp[bb, k0:k0 + block_k], vp[bb, k0:k0 + block_k]
                p = torch.exp(torch.einsum("qhd,khd->hqk", qs, ks) * scale + bias
                              - lsep[bb, :, q0:q0 + block_q, None])
                if causal:
                    p = p.masked_fill(cols > rows, 0.0)
                dp = torch.einsum("qhd,khd->hqk", dos, vs)
                acc = acc + p * (dp - deltap[bb, :, q0:q0 + block_q, None])
            visible = rows < s
            if mask_keys:
                visible = visible & (cols < s)
            if causal:
                visible = visible & (cols <= rows)
            acc = torch.where(visible, acc, 0.0)
            part = torch.zeros(hq, buckets)
            for dd in range(-(block_q - 1), block_k):  # distances in order
                total = torch.zeros(hq)
                for x in torch.diagonal(acc, offset=dd, dim1=1, dim2=2).unbind(-1):
                    total = total + x  # the diagonal in row order
                if -s < k0 - q0 + dd < s:
                    t = int(ids[k0 - q0 + dd + s - 1])
                    part[:, t] = part[:, t] + total
            parts.append(part)
    out = torch.zeros(hq, buckets)
    for part in parts:  # tile order
        out = out + part
    return out.to(table.dtype)


def _case(hq, hkv, s, buckets, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, s, hq, D).astype(np.float32)
    k = rs.randn(B, s, hkv, D).astype(np.float32)
    v = rs.randn(B, s, hkv, D).astype(np.float32)
    do = rs.randn(B, s, hq, D).astype(np.float32)
    table = (0.5 * rs.randn(hq, buckets)).astype(np.float32)
    return q, k, v, do, table


def _jax_dtable(q, k, v, do, table, causal, cfg):
    def jf(q_, k_, v_, t_):
        return j_flash(q_, k_, v_, rel_bias_table=t_, causal=causal, rel_bias_buckets=cfg[0],
                       rel_bias_max_dist=cfg[1], rel_bias_bidirectional=cfg[2], block_q=8,
                       block_k=8, interpret=True)

    _, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v, table)))
    return np.asarray(vjp(jnp.asarray(do))[3])


def _tiled(q, k, v, do, table, causal, cfg, **kw):
    tq, tk, tv, tdo, tt = (torch.from_numpy(x) for x in (q, k, v, do, table))
    o, lse = tflash.flash_attention_lse_reference(tq, tk, tv, causal=causal, table=tt,
                                                  bucket_cfg=cfg)
    return flash_dtable_tiled_reference(tq, tk, tv, o, lse, tdo, tt, cfg, causal=causal,
                                        **kw).numpy()


def _check(hq, hkv, s, buckets, tile, causal, bidir):
    q, k, v, do, table = _case(hq, hkv, s, buckets, seed=s + hq + buckets)
    cfg = (buckets, 4 * buckets, bidir)
    want = _jax_dtable(q, k, v, do, table, causal, cfg)
    got = _tiled(q, k, v, do, table, causal, cfg, block_q=tile[0], block_k=tile[1])
    np.testing.assert_allclose(got, want, **GRAD_TOL)


# (hq, hkv, s, (block_q, block_k)): S not a multiple of the tile, GQA and
# MHA, tiles taller and wider than long, and the kernel's own tile
CASES = [(4, 2, 13, (16, 8)), (4, 2, 37, (16, 8)), (2, 2, 37, (8, 16)), (4, 2, 37, (128, 64))]


@pytest.mark.parametrize("bidir", [True, False], ids=["bidirectional", "unidirectional"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,s,tile", CASES)
def test_tiled_dtable_matches_jax(hq, hkv, s, tile, causal, bidir):
    _check(hq, hkv, s, 32, tile, causal, bidir)


@pytest.mark.parametrize("causal,bidir", [(False, True), (True, False)],
                         ids=["full-bidirectional", "causal-unidirectional"])
def test_tiled_dtable_near_max_buckets_matches_jax(causal, bidir):
    """250 buckets, near MAX_BUCKETS (the JAX kernel unrolls a loop over the
    buckets, so two variants keep it quick)."""
    _check(4, 1, 37, 250, (16, 8), causal, bidir)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fold_without_the_key_column_mask_differs(causal):
    """Past S the kernel's K and V tiles are zero-filled, so S = dP = 0
    there but p = exp(bias - lse) is not.  Without a causal mask (T5's
    encoder), a fold that does not mask those columns adds p * (0 - delta)
    into real buckets and misses JAX's table gradient, while the masked
    fold holds it.  With one (the decoder) those columns lie above the
    diagonal of every row, so the causal mask alone zeroes them."""
    q, k, v, do, table = _case(4, 2, 13, 32, seed=5)
    cfg = (32, 128, not causal)
    want = _jax_dtable(q, k, v, do, table, causal, cfg)
    masked = _tiled(q, k, v, do, table, causal, cfg)
    np.testing.assert_allclose(masked, want, **GRAD_TOL)
    unmasked = _tiled(q, k, v, do, table, causal, cfg, mask_keys=False)
    if causal:
        np.testing.assert_array_equal(unmasked, masked)
    else:
        assert not np.allclose(unmasked, want, **GRAD_TOL)
