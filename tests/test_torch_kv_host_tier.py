"""The port's host KV tier and chunked prefill against the JAX package's, on
the CPU (the JAX ``tests/test_kv_host_tier.py`` against the port).

- **Tier ledger**: offer, capacity expiry, claim, drop, abandon and clear
  give the JAX tier's counters; an oversized payload is declined; the
  capacity estimate and the restore-vs-recompute crossover behave as the
  JAX tier's.
- **Spill copies**: a spilled block is one packed host buffer whose views
  hold the block's rows (int8 scales included), and the restore writes
  exactly those bytes back.
- **Trie**: eviction spills, a match claims past the device frontier and
  leaves stubs, an insert re-promotes them, a declining crossover leaves
  the chain resident.
- **Engine**: greedy ids with the tier on equal those with it off and the
  JAX engine's, with a working set larger than the pool (spills and
  restores provably happened), across the plain, speculative and int8-KV
  engines; claims are abandoned when the pool is full; the env-built
  runtime constructs no tier at ``TPUSTACK_KV_HOST_TIER_MB=0`` (a fresh
  interpreter per setting).
- **Chunked prefill**: chunked equals monolithic equals the JAX chunked
  engine, with the JAX chunk count, also with speculation on; the knob arms
  a paged engine and the stats key is absent with it off.

The tiny model is ``LlamaConfig.tiny(max_seq=64)`` from seed 3 in float32,
its flax weights carried across by ``params_from_jax``; pools of 8-token
blocks.  The crossover guard is off in the engine runs, as in the JAX tests
(on tiny CPU shapes both averages measure dispatch noise).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustack.models.llama import LlamaConfig as JaxConfig
from tpustack.models.llama import init_kv_pool as jax_init_pool
from tpustack.models.llm_continuous import ContinuousEngine as JaxEngine
from tpustack.models.llm_continuous import SlotRequest as JaxRequest
from tpustack.models.llm_generate import Generator as JaxGenerator
from tpustack.models.llm_generate import SampleConfig as JaxSample
from tpustack.serving import kv_host_tier as jax_tier
from tpustack.serving import kv_pool as jax_kv
from tpustack.serving.speculative import SpecConfig as JaxSpecConfig
from tpustack_torch.models.llama import LlamaConfig, init_kv_pool
from tpustack_torch.models.llama_weights import params_from_jax
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.serving import kv_pool
from tpustack_torch.serving.kv_host_tier import HostKVTier, block_nbytes, pack_block
from tpustack_torch.serving.speculative import SpecConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 8


@pytest.fixture(scope="module")
def gens():
    jgen = JaxGenerator(JaxConfig.tiny(max_seq=64), dtype=jnp.float32, seed=3)
    pgen = Generator(LlamaConfig.tiny(max_seq=64), params=params_from_jax(jgen.params),
                     dtype=torch.float32, device="cpu")
    return jgen, pgen


# ------------------------------------------------------------------ ledger
class _FakeNode:
    _next = iter(range(1, 1 << 20))

    def __init__(self):
        self.uid = next(self._next)
        self.tier = "host"


def _payload(kind, fill=0.0):
    """One layer, 64 bytes (k+v, 8 floats each)."""
    layer = {"k": np.full((2, 4), fill, np.float32), "v": np.full((2, 4), fill, np.float32)}
    if kind == "port":
        layer = {k: torch.from_numpy(a) for k, a in layer.items()}
    return [layer]


def _tier(kind, *args, **kw):
    return (HostKVTier if kind == "port" else jax_tier.HostKVTier)(*args, **kw)


def _ledger(tier):
    st = tier.stats()
    return {k: st[k] for k in ("capacity_blocks", "resident_blocks", "resident_bytes",
                               "block_bytes", "spilled_total", "restored_total",
                               "expired_total", "spill_declined_total")}


def _conserved(tier):
    st = tier.stats()
    return (st["spilled_total"] == st["restored_total"] + st["expired_total"]
            + st["resident_blocks"]) and st["resident_bytes"] <= st["capacity_bytes"]


def _ledger_ops(kind):
    tier = _tier(kind, 128, pool=None, crossover=False)  # holds two payloads
    n1, n2, n3, n4 = (_FakeNode() for _ in range(4))
    trace = [tier.offer(n1, _payload(kind, 1.0)), tier.offer(n2, _payload(kind, 2.0)),
             tier.offer(n3, _payload(kind, 3.0)), _ledger(tier)]
    got = tier.claim(n2)
    trace += [tier.claim(n1) is None, float(got[0]["k"][0, 0]), tier.claim(n2) is None,
              _ledger(tier)]
    tier.drop(n3)
    trace.append(_ledger(tier))
    tier.offer(n4, _payload(kind, 4.0))
    tier.claim(n4)
    tier.abandon(1)
    trace += [_ledger(tier), _conserved(tier)]
    small = _tier(kind, 32, pool=None, crossover=False)  # a 64-byte payload never fits
    trace += [small.offer(_FakeNode(), _payload(kind)), _ledger(small)]
    big = _tier(kind, 1 << 12, pool=None, crossover=False)
    big.offer(_FakeNode(), _payload(kind))
    big.offer(_FakeNode(), _payload(kind))
    trace += [big.clear(), _ledger(big), _conserved(big)]
    return trace


def test_tier_ledger_equals_jax():
    assert _ledger_ops("port") == _ledger_ops("jax")


def test_tier_capacity_estimate_and_crossover_equal_jax(monkeypatch):
    arrays_np = [{"k": np.zeros((4, 8, 2, 3), np.float32), "v": np.zeros((4, 8, 2, 3),
                                                                          np.float32)}]
    arrays = [{k: torch.from_numpy(a) for k, a in layer.items()} for layer in arrays_np]
    per = 8 * 2 * 3 * 4 * 2
    assert block_nbytes(arrays) == jax_tier.block_nbytes(arrays_np) == per
    assert HostKVTier(10 * per, None, arrays_fn=lambda: arrays,
                      crossover=False).capacity_blocks == 10
    for crossover in (True, False):
        verdicts = []
        for kind, arr in (("port", arrays), ("jax", arrays_np)):
            tier = _tier(kind, 1 << 20, None, arrays_fn=lambda a=arr: a, crossover=crossover)
            seq = [tier.should_restore(1), tier.snapshot_block(1) is not None]
            tier.note_prefill(1000, 1e-9)      # recompute far cheaper than the copy
            seq.append(tier.should_restore(1))
            for _ in range(64):
                tier.note_prefill(1, 10.0)     # recompute far dearer again
            seq.append(tier.should_restore(1))
            verdicts.append(seq)
        assert verdicts[0] == verdicts[1], crossover
        assert verdicts[0] == [True, True, not crossover, True]
    monkeypatch.delenv("TPUSTACK_KV_HOST_TIER_CROSSOVER", raising=False)
    assert HostKVTier(1, None)._crossover is True
    monkeypatch.setenv("TPUSTACK_KV_HOST_TIER_CROSSOVER", "0")
    assert HostKVTier(1, None)._crossover is False


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["float-kv", "int8-kv"])
def test_spill_packs_one_buffer_and_restore_writes_it_back(gens, kv_quant):
    """A block's rows of every pool tensor in one host buffer, viewed back
    per layer and tensor (the int8 pool's scales aligned); the restore puts
    the same bytes into another block."""
    pgen = gens[1]
    import dataclasses

    cfg = dataclasses.replace(pgen.cfg, kv_quant=kv_quant)
    arrays = init_kv_pool(cfg, 6, BLOCK, torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    for layer in arrays:
        for t in layer.values():
            t.copy_((torch.randn(t.shape, generator=g) * 50).to(t.dtype))
    payload = pack_block(arrays, 3)
    assert payload.flat.numel() == block_nbytes(arrays)
    assert sum(a.nbytes for layer in payload for a in layer.values()) == block_nbytes(arrays)
    for layer, src in zip(payload, arrays):
        assert set(layer) == set(src)
        for k, t in layer.items():
            assert torch.equal(t, src[k][3]), k
    pgen._restore_blocks_paged(arrays, [5], [payload])
    for layer in arrays:
        for t in layer.values():
            assert torch.equal(t[5], t[3])


# -------------------------------------------------------------------- trie
def _trie(kind, n_blocks=9, block=4, crossover=False):
    mod = kv_pool if kind == "port" else jax_kv
    pool = mod.KVBlockPool(n_blocks, block)
    cache = mod.PagedPrefixCache(pool)
    rng = np.random.default_rng(7)
    arrays = [{"k": rng.random((n_blocks, block, 2)).astype(np.float32),
               "v": rng.random((n_blocks, block, 2)).astype(np.float32)}]
    if kind == "port":
        arrays = [{k: torch.from_numpy(a) for k, a in layer.items()} for layer in arrays]
    cache.host_tier = _tier(kind, 1 << 20, pool, arrays_fn=lambda: arrays,
                            crossover=crossover)
    return pool, cache, cache.host_tier, arrays


def _trie_ops(kind):
    """Spill all, claim all (stubs), re-promote; then a partial spill whose
    match walks past the device frontier; then a declining crossover."""
    pool, cache, tier, arrays = _trie(kind)
    ids = list(range(16))
    blocks = pool.alloc_tokens(16)
    trace = [cache.insert(ids, blocks)]
    pool.decref(blocks)
    trace += [cache.evict(4), _ledger(tier), pool.n_used]
    m = cache.match(ids + [99])
    trace += [m.length, m.block_ids, len(m.host_payloads),
              [bool(np.array_equal(np.asarray(p[0]["k"]), np.asarray(arrays[0]["k"][blocks[d]])))
               for d, p in enumerate(m.host_payloads)], _ledger(tier)]
    m2 = cache.match(ids + [99])
    trace += [m2.length, len(m2.host_payloads)]
    tier.abandon(4)
    fresh = pool.alloc_tokens(16)
    trace.append(cache.insert(ids, fresh))
    pool.decref(fresh)
    m3 = cache.match(ids + [99])
    trace += [m3.length, m3.block_ids == fresh, len(m3.host_payloads), _conserved(tier)]
    pool.decref(m3.block_ids)
    # partial: only the deepest block spills
    pool2, cache2, tier2, _ = _trie(kind)
    b2 = pool2.alloc_tokens(16)
    cache2.insert(ids, b2)
    pool2.decref(b2)
    trace.append(cache2.evict(1))
    m4 = cache2.match(ids + [99])
    trace += [m4.length, m4.block_ids == b2[:3], len(m4.host_payloads)]
    pool2.decref(m4.block_ids)
    tier2.abandon(1)
    trace += [_conserved(tier2), cache2.evictable_blocks(), cache2.stats()["host_hits"]]
    # a guard that answers "recompute" leaves the chain resident
    pool3, cache3, tier3, _ = _trie(kind, crossover=True)
    b3 = pool3.alloc_tokens(16)
    cache3.insert(ids, b3)
    pool3.decref(b3)
    cache3.evict(4)
    tier3.note_prefill(1000, 1e-9)
    m5 = cache3.match(ids + [99])
    trace += [m5.length, len(m5.host_payloads), tier3.stats()["resident_blocks"],
              tier3.stats()["restored_total"], cache3.clear(), _ledger(tier3)]
    return trace


def test_trie_spills_claims_stubs_and_repromotes_as_jax():
    assert _trie_ops("port") == _trie_ops("jax")


# ------------------------------------------------------------------ engine
def _doc_prompts(n_docs=4, rounds=2, doc_tokens=16, base=11):
    """A working set larger than the pool: 2-block docs revisited with a
    fresh 3-token tail each round."""
    return [[(base + d * 31 + j) % 200 + 3 for j in range(doc_tokens)]
            + [220, 221, (r * n_docs + d) % 7 + 2] for r in range(rounds) for d in range(n_docs)]


def _runtime(side, gen, capacity_blocks, tier_mb=0, cache=True):
    mod = kv_pool if side == "port" else jax_kv
    pool = mod.KVBlockPool(capacity_blocks + 1, BLOCK)
    if side == "port":
        arrays = init_kv_pool(gen.cfg, capacity_blocks + 1, BLOCK, torch.float32, "cpu")
    else:
        arrays = jax_init_pool(gen.cfg, capacity_blocks + 1, BLOCK, jnp.float32)
    rt = mod.PagedKVRuntime(arrays, pool, gen.cfg.max_seq,
                            mod.PagedPrefixCache(pool) if cache else None)
    if tier_mb and cache:
        rt.cache.host_tier = _tier(side, int(tier_mb * 1024 * 1024), pool,
                                   arrays_fn=lambda: rt.arrays, crossover=False)
    return rt


def _admit(rt, ids, max_new):
    """The server's paged admission, test side: a prefix hit increfs,
    claimed host payloads get fresh blocks riding the prefix, a full pool
    abandons the claims."""
    cache, prefix, host_restore = rt.cache, None, None
    m = cache.match(ids)
    if m.length:
        prefix = (m.length, m.block_ids)
    if m.host_payloads:
        n_host = len(m.host_payloads)
        try:
            rt.ensure_free(n_host)
            restore_ids = rt.pool.alloc_tokens(n_host * rt.block)
        except (kv_pool.OutOfBlocks, jax_kv.OutOfBlocks):
            cache.host_tier.abandon(n_host)
        else:
            prefix = (m.length + n_host * rt.block, m.block_ids + list(restore_ids))
            host_restore = (restore_ids, m.host_payloads)
    n_shared = len(prefix[1]) if prefix else 0
    fresh = rt.need_tokens(len(ids), max_new) - n_shared * rt.block
    rt.ensure_free(rt.pool.blocks_for(fresh))
    return dict(prefix=prefix, kv_blocks=rt.pool.alloc_tokens(fresh), host_restore=host_restore,
                on_prefill_blocks=lambda bids, c=list(ids): cache.insert(c, bids))


def _run(side, gen, rt, prompts, max_new=4, spec=None, prefill_chunk=None, slots=1,
         admit=True):
    results, queue = {}, list(enumerate(prompts))
    Req = SlotRequest if side == "port" else JaxRequest
    sample = SampleConfig(greedy=True) if side == "port" else JaxSample(greedy=True)

    def feed():
        if not queue:
            return None
        i, ids = queue.pop(0)
        kw = _admit(rt, ids, max_new) if (admit and rt.cache is not None) else {}
        return Req(ids=ids, max_new=max_new, sample=sample, **kw,
                   on_done=lambda t, s, i=i: results.__setitem__(i, (t, s)))

    if side == "port":
        eng = ContinuousEngine(gen, rt, slots=slots, chunk=4, spec=spec,
                               prefill_chunk=prefill_chunk)
    else:
        eng = JaxEngine(gen, slots=slots, chunk=4, paged=rt, spec=spec,
                        prefill_chunk=prefill_chunk)
    stats = eng.run(feed)
    return [results[i][0] for i in sorted(results)], [results[i][1] for i in sorted(results)], \
        stats


@pytest.mark.parametrize("variant", ["plain", "spec", "kv_int8"])
def test_engine_tier_on_equals_off_and_jax(gens, variant):
    jgen, pgen = gens
    if variant == "kv_int8":
        import dataclasses

        jgen = JaxGenerator(dataclasses.replace(JaxConfig.tiny(max_seq=64), kv_quant="int8"),
                            dtype=jnp.float32, seed=3)
        pgen = Generator(dataclasses.replace(LlamaConfig.tiny(max_seq=64), kv_quant="int8"),
                         params=params_from_jax(jgen.params), dtype=torch.float32, device="cpu")
    spec = SpecConfig(tokens=3) if variant == "spec" else None
    prompts = _doc_prompts()
    ref = _run("jax", jgen, _runtime("jax", jgen, 6), prompts)[0]
    outs = {}
    for tier_mb in (0, 8):
        rt = _runtime("port", pgen, 6, tier_mb=tier_mb)
        outs[tier_mb] = _run("port", pgen, rt, prompts, spec=spec)[0]
        tier = rt.cache.host_tier
        if tier is not None:
            st = tier.stats()
            assert st["spilled_total"] > 0 and st["restored_total"] > 0, st
            assert _conserved(tier)
            assert st["block_bytes"] == block_nbytes(rt.arrays)
            rt.cache.host_tier = None  # ledger read; drop the cache without spilling
        rt.cache.clear()
        assert rt.pool.n_used == 0
    assert outs[0] == outs[8] == ref


def test_engine_abandons_claims_when_pool_full(gens):
    pgen = gens[1]
    rt = _runtime("port", pgen, 6, tier_mb=8)
    tier = rt.cache.host_tier
    ids = list(range(3, 19))
    blocks = rt.pool.alloc_tokens(16)
    rt.cache.insert(ids, blocks)
    rt.pool.decref(blocks)
    rt.cache.evict(2)
    assert tier.stats()["resident_blocks"] == 2
    wedge = rt.pool.alloc_tokens(rt.pool.n_free * rt.block)
    with pytest.raises(kv_pool.OutOfBlocks):
        _admit(rt, ids + [99, 98, 97], max_new=2)
    st = tier.stats()
    assert st["restored_total"] == 0 and st["expired_total"] == 2 and _conserved(tier)
    rt.pool.decref(wedge)
    assert rt.pool.n_used == 0


_BISECT = """
import json, sys
import torch
sys.path.insert(0, ".")
from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.serving.llm_server import build_paged

gen = Generator(LlamaConfig.tiny(max_seq=64), dtype=torch.float32, seed=3, device="cpu")
rt = build_paged(gen, 2, block=8)  # the environment decides the tier
cache = rt.cache
prompts = [[(11 + d * 31 + j) % 200 + 3 for j in range(16)] + [220, 221, (r * 4 + d) % 7 + 2]
           for r in range(2) for d in range(4)]
res, queue = {}, list(enumerate(prompts))

def feed():
    if not queue:
        return None
    i, ids = queue.pop(0)
    prefix = host_restore = None
    m = cache.match(ids)
    if m.length:
        prefix = (m.length, m.block_ids)
    if m.host_payloads:
        n = len(m.host_payloads)
        rt.ensure_free(n)
        rids = rt.pool.alloc_tokens(n * rt.block)
        prefix = (m.length + n * rt.block, m.block_ids + list(rids))
        host_restore = (rids, m.host_payloads)
    shared = len(prefix[1]) if prefix else 0
    fresh = rt.need_tokens(len(ids), 4) - shared * rt.block
    rt.ensure_free(rt.pool.blocks_for(fresh))
    return SlotRequest(ids=ids, max_new=4, sample=SampleConfig(greedy=True), prefix=prefix,
                       kv_blocks=rt.pool.alloc_tokens(fresh), host_restore=host_restore,
                       on_prefill_blocks=lambda b, c=list(ids): cache.insert(c, b),
                       on_done=lambda t, s, i=i: res.__setitem__(i, t))

ContinuousEngine(gen, rt, slots=1, chunk=4).run(feed)
tier = cache.host_tier
print(json.dumps({"out": [res[i] for i in sorted(res)], "tier": tier is not None,
                  "stats": tier.stats() if tier else {}}))
"""


def test_host_tier_env_bisection_subprocess():
    """``TPUSTACK_KV_HOST_TIER_MB=0`` constructs no tier in the env-built
    runtime, and its fresh-interpreter output equals the tier-on one, which
    spilled and restored (the JAX ``test_host_tier_env_bisection_subprocess``)."""
    outs = {}
    for mb in ("0", "8"):
        env = dict(os.environ, TPUSTACK_KV_HOST_TIER_MB=mb, TPUSTACK_KV_HOST_TIER_CROSSOVER="0",
                   TPUSTACK_KV_POOL_BLOCKS="6", TPUSTACK_PREFIX_CACHE="1")
        proc = subprocess.run([sys.executable, "-c", _BISECT], env=env, capture_output=True,
                              text=True, timeout=240, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-800:]
        outs[mb] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert outs["0"]["tier"] is False and outs["0"]["stats"] == {}
    assert outs["8"]["tier"] is True
    assert outs["8"]["stats"]["spilled_total"] > 0 and outs["8"]["stats"]["restored_total"] > 0
    assert outs["0"]["out"] == outs["8"]["out"]


# --------------------------------------------------------- chunked prefill
LONG = [(5 + j) % 200 + 3 for j in range(35)]  # spans two 16-token chunks and a remainder


@pytest.mark.parametrize("spec", [False, True], ids=["spec-off", "spec-on"])
def test_chunked_prefill_equals_monolithic_and_jax(gens, spec):
    jgen, pgen = gens
    prompts = [LONG] + [[30 + d, 31, 32, 33, 34] for d in range(4 if not spec else 1)]
    ref, ref_stats, jstats = _run("jax", jgen, _runtime("jax", jgen, 16, cache=False), prompts,
                                  max_new=6, slots=2, admit=False, prefill_chunk=16,
                                  spec=JaxSpecConfig(tokens=3) if spec else None)
    outs = {}
    for chunk in (0, 16):
        rt = _runtime("port", pgen, 16, cache=False)
        outs[chunk], rstats, stats = _run("port", pgen, rt, prompts, max_new=6, slots=2,
                                          admit=False, prefill_chunk=chunk,
                                          spec=SpecConfig(tokens=3) if spec else None)
        if chunk:
            assert stats["prefill_chunks"] == jstats["prefill_chunks"] == 2
            assert rstats[0]["prefill_chunks"] == ref_stats[0]["prefill_chunks"] == 2
            assert rstats[0]["prefill_tokens"] == len(LONG)
        else:
            assert "prefill_chunks" not in stats and "prefill_chunks" not in rstats[0]
        assert rt.pool.n_used == 0
    assert outs[0] == outs[16] == ref


def test_chunked_prefill_knob_arms_paged_engines_only(gens, monkeypatch):
    pgen = gens[1]
    rt = _runtime("port", pgen, 16, cache=False)
    monkeypatch.setenv("TPUSTACK_PREFILL_CHUNK_TOKENS", "16")
    assert ContinuousEngine(pgen, rt, slots=1)._chunk_tokens == 16
    assert ContinuousEngine(pgen, None, slots=1)._chunk_tokens == 0
    monkeypatch.setenv("TPUSTACK_PREFILL_CHUNK_TOKENS", "0")
    assert ContinuousEngine(pgen, rt, slots=1)._chunk_tokens == 0
