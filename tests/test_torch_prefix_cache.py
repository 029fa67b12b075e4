"""The port's dense prefix store (``serving/prefix_cache.py``) against the
JAX package's, operation for operation.

The JAX store tests (``tests/test_prefix_cache.py``: miss then snapped hit,
never the whole prompt, idempotent divergent inserts, byte accounting and LRU
eviction, alignment and parent-path checks, stats) run against both classes
with the same operations on the same segment values (numpy for the JAX
store, the same arrays as CPU tensors for the port's), and must give the
same match lengths, byte accounting, evictions and stats.
"""

import numpy as np
import pytest
import torch

from tpustack.serving.prefix_cache import PrefixCache as JaxPrefixCache
from tpustack_torch.serving.prefix_cache import PrefixCache


def _seg_np(n, val, layers=2, kvh=2, hd=4):
    return [{"k": np.full((n, kvh, hd), val + li, np.float32),
             "v": np.full((n, kvh, hd), val - li, np.float32)} for li in range(layers)]


def _seg(kind, n, val):
    seg = _seg_np(n, val)
    if kind == "port":
        return [{k: torch.from_numpy(a) for k, a in layer.items()} for layer in seg]
    return seg


def _store(kind, **kw):
    return (PrefixCache if kind == "port" else JaxPrefixCache)(**kw)


def _first(kv, layer=0, key="k", pos=0):
    return float(kv[layer][key][pos, 0, 0])


def _ops_miss_then_hit(kind):
    pc = _store(kind, chunk_tokens=4, capacity_bytes=1 << 20)
    ids = list(range(20))
    out = [pc.match(ids).length, pc.insert(ids, 0, _seg(kind, 16, 1.0))]
    m = pc.match(ids)
    out += [m.length, tuple(m.kv[0]["k"].shape), _first(m.kv), m.key is not None]
    # the same path twice: the same assembled object (the device memo's key)
    m2 = pc.match(ids)
    out += [m2.key == m.key, m2.kv is m.kv]
    return out


def _ops_never_whole_prompt(kind):
    pc = _store(kind, chunk_tokens=4, capacity_bytes=1 << 20)
    ids = list(range(16))
    pc.insert(ids, 0, _seg(kind, 16, 1.0))
    return [pc.match(ids).length, pc.match(ids + [99]).length]


def _ops_divergent_branches(kind):
    pc = _store(kind, chunk_tokens=4, capacity_bytes=1 << 20)
    a = list(range(16)) + [1, 2, 3, 4]
    b = list(range(16)) + [5, 6, 7, 8]
    out = [pc.insert(a, 0, _seg(kind, 16, 1.0)), pc.insert(b, 0, _seg(kind, 16, 1.0))]
    before = pc.bytes
    out += [pc.insert(a, 16, _seg(kind, 4, 2.0)), pc.insert(b, 16, _seg(kind, 4, 3.0)),
            pc.bytes - before, pc.match(a + [0]).length, pc.match(b + [0]).length,
            _first(pc.match(a + [0]).kv, pos=16), _first(pc.match(b + [0]).kv, pos=16)]
    return out


def _ops_lru_eviction(kind):
    one_chunk = sum(a.nbytes for layer in _seg_np(4, 0) for a in layer.values())
    evicted = []
    pc = _store(kind, chunk_tokens=4, capacity_bytes=3 * one_chunk, on_evict=evicted.append)
    pc.insert(list(range(8)), 0, _seg(kind, 8, 1.0))
    out = [pc.bytes, pc.entries]
    pc.match(list(range(8)) + [0])
    pc.insert([50, 51, 52, 53, 60, 61, 62, 63], 0, _seg(kind, 8, 2.0))
    out += [pc.bytes, pc.entries, pc.evictions, list(evicted), pc.bytes == pc.entries * one_chunk,
            pc.match(list(range(8)) + [0]).length,
            pc.match([50, 51, 52, 53, 60, 61, 62, 63, 0]).length]
    return out


def _ops_alignment(kind):
    pc = _store(kind, chunk_tokens=4, capacity_bytes=1 << 20)
    errors = []
    for ids, start, n in ((list(range(10)), 0, 6), (list(range(10)), 2, 4),
                          (list(range(6)), 4, 4)):
        try:
            pc.insert(ids, start, _seg(kind, n, 1.0))
            errors.append(None)
        except ValueError:
            errors.append("ValueError")
    return errors + [pc.insert(list(range(8)), 4, _seg(kind, 4, 1.0)), pc.entries]


def _ops_stats(kind):
    pc = _store(kind, chunk_tokens=4, capacity_bytes=1 << 20)
    pc.insert(list(range(8)), 0, _seg(kind, 8, 1.0))
    pc.match(list(range(8)) + [9])
    pc.match([200, 201, 202, 203, 204])
    st = dict(pc.stats())
    pc.clear()
    return [st, pc.bytes, pc.entries, pc.match(list(range(8)) + [9]).length]


OPS = {f.__name__[len("_ops_"):]: f for f in (
    _ops_miss_then_hit, _ops_never_whole_prompt, _ops_divergent_branches, _ops_lru_eviction,
    _ops_alignment, _ops_stats)}


@pytest.mark.parametrize("name", sorted(OPS))
def test_store_equals_jax(name):
    assert OPS[name]("port") == OPS[name]("jax")


def test_assembled_bytes_are_capped_and_reported():
    one_chunk = sum(a.nbytes for layer in _seg_np(4, 0) for a in layer.values())
    for kind in ("port", "jax"):
        pc = _store(kind, chunk_tokens=4, capacity_bytes=8 * one_chunk)
        pc.insert(list(range(16)), 0, _seg(kind, 16, 1.0))
        pc.match(list(range(16)) + [0])
        assert pc.stats()["assembled_bytes"] == 4 * one_chunk, kind
