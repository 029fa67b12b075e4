"""The port's paged attention against the JAX package, on the CPU.

``paged_attention_partial`` on CPU tensors runs its plain twin
(``paged_attention_partial_ref``: gather the table-mapped blocks, then the
plain partial); it is held here to the JAX Pallas ``paged_attention_partial``
in interpret mode on the same numpy inputs, in float32.  The cases mirror
``tests/test_paged_flash.py``: a scrambled table over a pool whose reserved
block 0 is poisoned, ragged and zero lengths, int8 pools with scales, GQA
head maps, and the speculative verify (k = 0..4) merged with the in-segment
buffer partial.

Tolerance 1e-5 (relative and absolute): both sides compute float32
softmax partials over the same keys and differ only in summation order (the
Pallas kernel's per-block online carry against the twin's one pass).

The CUDA kernel itself runs only on the card: see
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustack.ops.attention import dot_product_attention as jax_dpa
from tpustack.ops.attention import dot_product_attention_partial as jax_partial
from tpustack.ops.attention import merge_attention_partials as jax_merge
from tpustack.ops.pallas.flash_attention import paged_attention_partial as jax_paged
from tpustack.ops.pallas.flash_attention import paged_bytes_accounting as jax_accounting
from tpustack_torch.ops.attention import (dot_product_attention,
                                          dot_product_attention_partial,
                                          merge_attention_partials)
from tpustack_torch.ops.paged_attention import (paged_attention_partial,
                                                paged_attention_partial_ref,
                                                paged_bytes_accounting,
                                                paged_flash_attention)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pool_setup(rng, *, b=3, hkv=2, d=16, blk=8, nb=6, n_pool=14, int8=False):
    """A scrambled pool (block 0 poisoned), ragged lengths (one full row,
    one mid-block, one zero), idle table entries at block 0."""
    if int8:
        pk = rng.randint(-127, 128, (n_pool, blk, hkv, d)).astype(np.int8)
        pv = rng.randint(-127, 128, (n_pool, blk, hkv, d)).astype(np.int8)
    else:
        pk = rng.randn(n_pool, blk, hkv, d).astype(np.float32)
        pv = rng.randn(n_pool, blk, hkv, d).astype(np.float32)
    pk[0] = 127 if int8 else 1e4
    pv[0] = 127 if int8 else 1e4
    lens = np.zeros(b, np.int32)
    lens[0] = blk * nb
    if b > 1:
        lens[1] = blk + 3
    bt = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, n_pool))
    pos = 0
    for i in range(b):
        n = -(-int(lens[i]) // blk)
        bt[i, :n] = perm[pos:pos + n]
        pos += n
    return pk, pv, bt, lens


def _both(q, pk, pv, bt, lens, ks=None, vs=None):
    """(JAX interpret-mode partial, port partial) as numpy triples."""
    j = jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
                  jnp.asarray(lens), interpret=True,
                  k_scale=None if ks is None else jnp.asarray(ks),
                  v_scale=None if vs is None else jnp.asarray(vs))
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    p = paged_attention_partial(t(q), t(pk), t(pv), t(bt), t(lens), k_scale=t(ks),
                                v_scale=t(vs))
    return [np.asarray(x) for x in j], [x.numpy() for x in p]


def _close(jax_out, port_out):
    for name, a, b in zip("acc m l".split(), jax_out, port_out):
        np.testing.assert_allclose(b, a, err_msg=name, **TOL)


def test_block_table_indirection_and_poisoned_block0():
    rng = np.random.RandomState(0)
    pk, pv, bt, lens = _pool_setup(rng)
    q = rng.randn(3, 1, 4, 16).astype(np.float32)
    _close(*_both(q, pk, pv, bt, lens))


def test_ragged_and_zero_length_rows():
    rng = np.random.RandomState(1)
    pk, pv, bt, lens = _pool_setup(rng)
    assert lens[2] == 0 and lens[1] % pk.shape[1]
    q = rng.randn(3, 1, 4, 16).astype(np.float32)
    jax_out, port_out = _both(q, pk, pv, bt, lens)
    _close(jax_out, port_out)
    acc, m, l = port_out
    assert np.all(acc[2] == 0) and np.all(l[2] == 0) and np.all(m[2] <= -1e29)
    out = paged_flash_attention(*(torch.from_numpy(x) for x in (q, pk, pv, bt, lens))).numpy()
    assert np.all(out[2] == 0)
    np.testing.assert_allclose(out[:2], (acc / np.maximum(l, 1e-30)[..., None])[:2], **TOL)


def test_int8_pool_with_scales():
    rng = np.random.RandomState(2)
    pk, pv, bt, lens = _pool_setup(rng, int8=True)
    ks = (rng.rand(*pk.shape[:3]) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(*pk.shape[:3]) * 0.02 + 1e-3).astype(np.float32)
    q = rng.randn(3, 1, 4, 16).astype(np.float32)
    _close(*_both(q, pk, pv, bt, lens, ks, vs))


@pytest.mark.parametrize("h,hkv", [(8, 2), (6, 6), (4, 1)])
def test_gqa_head_maps(h, hkv):
    rng = np.random.RandomState(3)
    pk, pv, bt, lens = _pool_setup(rng, hkv=hkv)
    q = rng.randn(3, 1, h, 16).astype(np.float32)
    _close(*_both(q, pk, pv, bt, lens))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_verify_merged_with_buffer_partial(k):
    """The fused verify: one pool pass for all k+1 rows merged with the
    in-segment causal buffer partial, against the JAX decomposition and the
    port's own one-pass reference over pool prefix + segment."""
    rng = np.random.RandomState(4 + k)
    pk, pv, bt, lens = _pool_setup(rng)
    s, b, h, d, hkv = k + 1, 3, 4, 16, 2
    q = rng.randn(b, s, h, d).astype(np.float32)
    seg_k = rng.randn(b, s, hkv, d).astype(np.float32)
    seg_v = rng.randn(b, s, hkv, d).astype(np.float32)
    causal = np.broadcast_to(np.arange(s)[None, None, :] <= np.arange(s)[None, :, None],
                             (b, s, s))
    jax_pool = jax_paged(*(jnp.asarray(x) for x in (q, pk, pv, bt, lens)), interpret=True)
    jax_seg = jax_partial(jnp.asarray(q), jnp.asarray(seg_k), jnp.asarray(seg_v),
                          mask=jnp.asarray(causal))
    jax_out = np.asarray(jax_merge(jax_pool, jax_seg, jnp.float32))
    t = torch.from_numpy
    port_pool = paged_attention_partial(t(q), t(pk), t(pv), t(bt), t(lens))
    port_seg = dot_product_attention_partial(t(q), t(seg_k), t(seg_v), mask=t(causal.copy()))
    merged = merge_attention_partials(port_pool, port_seg, torch.float32).numpy()
    np.testing.assert_allclose(merged, jax_out, **TOL)
    # one pass over {pool prefix} + {segment} with the full verify mask
    nb, blk = bt.shape[1], pk.shape[1]
    dense_k = pk[bt.reshape(-1)].reshape(b, nb * blk, hkv, d)
    dense_v = pv[bt.reshape(-1)].reshape(b, nb * blk, hkv, d)
    pool_mask = np.broadcast_to(np.arange(nb * blk)[None, None, :] < lens[:, None, None],
                                (b, s, nb * blk))
    mask = np.concatenate([pool_mask, causal], axis=2)[:, None]
    ref = dot_product_attention(t(q), t(np.concatenate([dense_k, seg_k], 1)),
                                t(np.concatenate([dense_v, seg_v], 1)),
                                mask=t(mask.copy())).numpy()
    np.testing.assert_allclose(merged, ref, **TOL)


def test_partial_and_scaled_attention_match_jax():
    """The plain ops under the kernel's twin: ``dot_product_attention_partial``
    with int8 scales and a fully masked row, and ``dot_product_attention``
    with ``k_scale``/``v_scale``."""
    rng = np.random.RandomState(9)
    b, sq, sk, h, hkv, d = 2, 3, 20, 4, 2, 16
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randint(-127, 128, (b, sk, hkv, d)).astype(np.int8)
    v = rng.randint(-127, 128, (b, sk, hkv, d)).astype(np.int8)
    ks = (rng.rand(b, sk, hkv) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(b, sk, hkv) * 0.02 + 1e-3).astype(np.float32)
    mask = rng.rand(b, sq, sk) < 0.6
    mask[1, 2] = False  # a fully masked row
    j = jax_partial(*(jnp.asarray(x) for x in (q, k, v)), mask=jnp.asarray(mask),
                    k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = torch.from_numpy
    p = dot_product_attention_partial(t(q), t(k), t(v), mask=t(mask), k_scale=t(ks),
                                      v_scale=t(vs))
    _close([np.asarray(x) for x in j], [x.numpy() for x in p])
    assert p[1][1, 2].max() <= -1e29 and p[2][1, 2].abs().max() == 0
    full = jax_dpa(*(jnp.asarray(x) for x in (q, k, v)), mask=jnp.asarray(mask[:, None]),
                   k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    port = dot_product_attention(t(q), t(k), t(v), mask=t(mask[:, None].copy()),
                                 k_scale=t(ks), v_scale=t(vs))
    np.testing.assert_allclose(port.numpy()[:, :2], np.asarray(full)[:, :2], **TOL)


def test_twin_is_the_cpu_path():
    rng = np.random.RandomState(5)
    pk, pv, bt, lens = _pool_setup(rng)
    args = [torch.from_numpy(x) for x in (rng.randn(3, 2, 4, 16).astype(np.float32), pk, pv,
                                          bt, lens)]
    before = paged_attention_partial.launches
    for a, r in zip(paged_attention_partial(*args), paged_attention_partial_ref(*args)):
        assert torch.equal(a, r)
    assert paged_attention_partial.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("valid,int8", [(1, False), (4, False), (8, False), (3, True)])
def test_bytes_accounting_equals_jax(valid, int8):
    kw = dict(n_valid_blocks=valid, blocks_per_seq=8, block=16, kvh=2, hd=16,
              esize=1 if int8 else 2, scale_bytes=8 if int8 else 0, n_steps=8)
    assert paged_bytes_accounting(**kw) == jax_accounting(**kw)
