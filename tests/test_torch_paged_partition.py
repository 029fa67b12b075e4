"""The paged kernel's work split and in-kernel merge, in plain Python, on the CPU.

``work_partition`` (``tpustack_torch/ops/paged_attention.py``) is the split
that ``csrc/paged_attention.cu`` computes on the device: units of one (row,
kv head, 64-key tile) below each row's length, spread in equal contiguous
ranges over a persistent grid.  Its properties are checked over ragged
lengths (all zero, one row full and the others empty, fewer units than
CTAs, a unit count that is no multiple of the grid, lengths past the
table): every valid unit is covered exactly once, no CTA writes more than
its two workspace slots, and each split pair's piece count is the number of
CTAs whose ranges touch it.

The kernel's arithmetic is then emulated with the plain partial: one piece
per (CTA, pair) over the same partition, merged in piece order with the
kernel's weights ``exp(m_k - max m)``.  It must equal
``paged_attention_partial_ref`` within 1e-5 (float32 on both sides; only
the summation order differs), and the JAX Pallas kernel in interpret mode
on one case, at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustack.ops.pallas.flash_attention import paged_attention_partial as jax_paged
from tpustack_torch.ops.attention import dot_product_attention_partial
from tpustack_torch.ops.paged_attention import (TILE, gather_pool, paged_attention_partial_ref,
                                                work_partition)

TOL = dict(rtol=1e-5, atol=1e-5)

SPLITS = [  # (label, lengths, hkv, nb, blk, grid)
    ("all empty", [0] * 8, 4, 64, 64, 132),
    ("one full, seven empty", [4096] + [0] * 7, 4, 64, 64, 132),
    ("fewer units than ctas", [67, 10, 0], 2, 4, 32, 16),
    ("no multiple of the grid", [4096, 0, 67, 1000, 3, 2500, 64, 129], 4, 64, 64, 132),
    ("lengths past the table", [900, 5000, -3, 64], 2, 8, 16, 5),
    ("one cta", [300, 0, 17], 3, 20, 16, 1),
    ("one unit per cta", [64] * 4, 1, 1, 64, 4),
]


def _tiles(lengths, nb, blk):
    return [-(-min(max(n, 0), nb * blk) // TILE) for n in lengths]


@pytest.mark.parametrize("label,lengths,hkv,nb,blk,grid", SPLITS, ids=[c[0] for c in SPLITS])
def test_every_valid_unit_once_and_the_workspace_holds(label, lengths, hkv, nb, blk, grid):
    part = work_partition(lengths, hkv, nb, blk, grid)
    tiles = _tiles(lengths, nb, blk)
    want = {(b * hkv + k, t) for b, n in enumerate(tiles) for k in range(hkv) for t in range(n)}
    assert part["units"] == len(want)
    # ranges: contiguous, in order, sizes differing by at most one
    ranges = part["ranges"]
    assert ranges[0][0] == 0 and ranges[-1][1] == part["units"] and len(ranges) == grid
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [e - s for s, e in ranges]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    seen = []
    for c, segs in enumerate(part["segments"]):
        assert sum(t1 - t0 for _, t0, t1, _ in segs) == sizes[c]
        slots = [slot for *_, slot in segs if slot is not None]
        # at most two pieces a CTA, in its own two slots of the 2 * grid
        assert len(slots) == len(set(slots)) <= 2
        assert all(2 * c <= slot <= 2 * c + 1 for slot in slots)
        # only the first and the last segment of a range may be pieces
        assert all(slot is None for *_, slot in segs[1:-1])
        for pair, t0, t1, _ in segs:
            seen += [(pair, t) for t in range(t0, t1)]
    assert len(seen) == len(set(seen)) and set(seen) == want
    # pieces: the CTAs whose ranges touch the pair, in key order, covering it
    for pair, pieces in part["pieces"].items():
        n = tiles[pair // hkv]
        touching = sorted({c for c, segs in enumerate(part["segments"])
                           for p, *_ in segs if p == pair})
        assert [c for c, *_ in pieces] == touching and len(pieces) >= 2
        assert pieces[0][2] == 0 and pieces[-1][3] == n
        assert all(a[3] == b[2] for a, b in zip(pieces, pieces[1:]))
    whole = [p for segs in part["segments"] for p, _, _, slot in segs if slot is None]
    assert len(whole) == len(set(whole)) and not set(whole) & set(part["pieces"])
    assert set(whole) | set(part["pieces"]) == {p for p, _ in want}
    assert part["empty"] == {b * hkv + k: (b * hkv + k) % grid
                             for b, n in enumerate(tiles) if n == 0 for k in range(hkv)}


def emulate_kernel(q, pk, pv, bt, lens, grid, ks=None, vs=None):
    """The kernel's output, computed as it computes it: per (CTA, pair) the
    plain partial over the segment's keys, written directly when the CTA
    holds the whole pair, else merged over the pieces in piece order."""
    b, s, h, d = q.shape
    _, blk, hkv, _ = pk.shape
    nb = bt.shape[1]
    g = h // hkv
    part = work_partition(lens.tolist(), hkv, nb, blk, grid)
    dense = [gather_pool(x, bt) if x is not None else None for x in (pk, pv, ks, vs)]
    acc = torch.zeros(b, s, h, d)
    m = torch.full((b, s, h), -1e30)
    l = torch.zeros(b, s, h)

    def piece(pair, t0, t1):
        row, kvh = divmod(pair, hkv)
        lo, hi = t0 * TILE, min(t1 * TILE, int(lens[row]), nb * blk)
        heads = slice(kvh * g, (kvh + 1) * g)
        k, v, ksc, vsc = (None if x is None else x[row:row + 1, lo:hi, kvh:kvh + 1]
                          for x in dense)
        mask = torch.ones(1, s, hi - lo, dtype=torch.bool)
        return dot_product_attention_partial(q[row:row + 1, :, heads], k, v, mask=mask,
                                             k_scale=ksc, v_scale=vsc)

    def put(pair, a, mm, ll):
        row, kvh = divmod(pair, hkv)
        heads = slice(kvh * g, (kvh + 1) * g)
        acc[row, :, heads], m[row, :, heads], l[row, :, heads] = a[0], mm[0], ll[0]

    for segs in part["segments"]:
        for pair, t0, t1, slot in segs:
            if slot is None:
                put(pair, *piece(pair, t0, t1))
    for pair, pieces in part["pieces"].items():
        parts = [piece(pair, t0, t1) for _, _, t0, t1 in pieces]
        mx = parts[0][1]
        for _, mk, _ in parts[1:]:
            mx = torch.maximum(mx, mk)
        a, ll = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][2])
        for ak, mk, lk in parts:  # piece order: the kernel's summation order
            w = torch.exp(mk - mx)
            a = a + ak * w[..., None]
            ll = ll + lk * w
        put(pair, a, mx, ll)
    return acc, m, l


def _inputs(rng, b, s, h, hkv, d, n_pool, blk, nb, lens, int8=False):
    """A scrambled pool with block 0 poisoned, idle table entries at block
    0, and the given lengths (as numpy)."""
    shape = (n_pool, blk, hkv, d)
    if int8:
        pk = rng.randint(-127, 128, shape).astype(np.int8)
        pv = rng.randint(-127, 128, shape).astype(np.int8)
        ks = (rng.rand(*shape[:3]) * 0.02 + 1e-3).astype(np.float32)
        vs = (rng.rand(*shape[:3]) * 0.02 + 1e-3).astype(np.float32)
    else:
        pk = rng.randn(*shape).astype(np.float32)
        pv = rng.randn(*shape).astype(np.float32)
        ks = vs = None
    pk[0] = 127 if int8 else 1e4
    pv[0] = 127 if int8 else 1e4
    lens = np.asarray(lens, np.int32)
    bt = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, n_pool))
    pos = 0
    for i in range(b):
        n = -(-min(max(int(lens[i]), 0), nb * blk) // blk)
        bt[i, :n] = perm[pos:pos + n]
        pos += n
    q = rng.randn(b, s, h, d).astype(np.float32)
    return q, pk, pv, bt, lens, ks, vs


EMULATED = [  # (label, b, s, h, hkv, d, n_pool, blk, nb, lengths, int8, grid)
    ("decode ragged", 4, 1, 8, 2, 16, 40, 16, 16, [256, 0, 67, 130], False, 7),
    ("verify one full", 4, 3, 8, 2, 16, 40, 16, 16, [256, 0, 0, 0], False, 5),
    ("all empty", 3, 2, 4, 2, 16, 8, 16, 4, [0, 0, 0], False, 4),
    ("fewer units than ctas", 2, 2, 6, 3, 16, 12, 32, 4, [67, 10], False, 16),
    ("int8 mqa", 3, 2, 4, 1, 32, 40, 16, 12, [190, 64, 5], True, 3),
    ("tile and block multiples", 3, 1, 4, 4, 16, 40, 32, 8, [64, 128, 32], False, 6),
]


@pytest.mark.parametrize("label,b,s,h,hkv,d,n_pool,blk,nb,lengths,int8,grid", EMULATED,
                         ids=[c[0] for c in EMULATED])
def test_pieces_merged_in_order_equal_the_twin(label, b, s, h, hkv, d, n_pool, blk, nb,
                                               lengths, int8, grid):
    rng = np.random.RandomState(len(label))
    arrays = _inputs(rng, b, s, h, hkv, d, n_pool, blk, nb, lengths, int8)
    q, pk, pv, bt, lens, ks, vs = (None if x is None else torch.from_numpy(x) for x in arrays)
    got = emulate_kernel(q, pk, pv, bt, lens, grid, ks, vs)
    ref = paged_attention_partial_ref(q, pk, pv, bt, lens, k_scale=ks, v_scale=vs)
    keys = ref[2] > 0
    assert torch.equal(got[2] > 0, keys)
    assert (got[1][~keys] <= -1e29).all() and (got[0][~keys] == 0).all()
    torch.testing.assert_close(got[0], ref[0], **TOL)
    torch.testing.assert_close(got[1][keys], ref[1][keys], **TOL)
    torch.testing.assert_close(got[2], ref[2], **TOL)


def test_emulated_kernel_matches_the_pallas_kernel():
    rng = np.random.RandomState(11)
    q, pk, pv, bt, lens, _, _ = _inputs(rng, 3, 2, 8, 2, 16, 40, 16, 16, [256, 67, 0])
    jax_out = jax_paged(*(jnp.asarray(x) for x in (q, pk, pv, bt, lens)), interpret=True)
    got = emulate_kernel(*(torch.from_numpy(x) for x in (q, pk, pv, bt, lens)), grid=5)
    for name, a, j in zip("acc m l".split(), got, jax_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), err_msg=name, **TOL)
