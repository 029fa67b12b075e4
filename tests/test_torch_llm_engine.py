"""The port's paged continuous engine against the JAX package's, on the CPU.

Both engines get the same flax parameters (``Generator(LlamaConfig.tiny(
max_seq=64))`` from a seed, carried across by ``params_from_jax``), the same
requests and the same pool shape (32 blocks of 8 tokens), in float32, and must
return the same greedy token ids.  The JAX engine runs its gather body
(``paged_flash=False``; its own tests show it equal to the kernel body); the
port runs both of its views, the gather copy and the in-place view whose
CPU path is the paged kernel's twin.  Covered: plain decode, speculative
verify (``SpecConfig(tokens=3)``), the int8 KV cache, a prefix-cache hit
(masked suffix prefill), and the streaming suffix prefill
(``MASKED_PREFILL_MAX = 0`` on both instances).

The oracle for speculation is the JAX engine with speculation OFF: the
JAX spec-on server test is red at this tree (ROADMAP.md section C), and the
port's spec-on output must equal its spec-off output.  Seeded sampling
cannot match JAX's threefry numbers; the port's own contract is tested
instead: a (prompt, seed) pair gives the same tokens alone or among peers.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from tpustack.models.llama import LlamaConfig as JaxConfig
from tpustack.models.llama import init_kv_pool as jax_init_pool
from tpustack.models.llm_continuous import ContinuousEngine as JaxEngine
from tpustack.models.llm_continuous import SlotRequest as JaxRequest
from tpustack.models.llm_generate import Generator as JaxGenerator
from tpustack.models.llm_generate import SampleConfig as JaxSample
from tpustack.serving import kv_pool as jax_kv
from tpustack_torch.models.llama import LlamaConfig, init_kv_pool
from tpustack_torch.models.llama_weights import params_from_jax
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.serving import kv_pool
from tpustack_torch.serving.speculative import SpecConfig

CAP, BLOCK = 32, 8
SYSTEM = [5, 9, 14, 3, 9, 14, 21, 5, 9, 14, 3, 9, 14, 21, 6, 8]  # two whole blocks


def _prompts(n=4):
    """Repetitive prompts: prompt lookup drafts on them."""
    return [[3 + i, 7, 11, 13 + i, 7, 11, 13 + i, 7] for i in range(n)]


@pytest.fixture(scope="module", params=[None, "int8"], ids=["float-kv", "int8-kv"])
def gens(request):
    jcfg = dataclasses.replace(JaxConfig.tiny(max_seq=64), kv_quant=request.param)
    jgen = JaxGenerator(jcfg, dtype=jnp.float32, seed=3)
    cfg = dataclasses.replace(LlamaConfig.tiny(max_seq=64), kv_quant=request.param)
    pgen = Generator(cfg, params=params_from_jax(jgen.params), dtype=torch.float32,
                     device="cpu")
    return jgen, pgen


def _jax_runtime(jgen):
    pool = jax_kv.KVBlockPool(CAP + 1, BLOCK)
    return jax_kv.PagedKVRuntime(jax_init_pool(jgen.cfg, CAP + 1, BLOCK, jnp.float32), pool,
                                 jgen.cfg.max_seq, jax_kv.PagedPrefixCache(pool))


def _port_runtime(pgen):
    pool = kv_pool.KVBlockPool(CAP + 1, BLOCK)
    return kv_pool.PagedKVRuntime(init_kv_pool(pgen.cfg, CAP + 1, BLOCK, torch.float32, "cpu"),
                                  pool, pgen.cfg.max_seq, kv_pool.PagedPrefixCache(pool))


def _serve(side, gen, rt, waves, *, spec=None, flash=False, max_new=12, sample=None,
           seeds=None):
    """Run one engine per wave of prompts through ``rt`` (prefix-cache
    lookups and inserts as the server does them); returns the outputs of
    every request in order."""
    jax_side = side == "jax"
    Engine, Request = (JaxEngine, JaxRequest) if jax_side else (ContinuousEngine, SlotRequest)
    sample = sample or (JaxSample(greedy=True) if jax_side else SampleConfig(greedy=True))
    out = []
    for wave in waves:
        res = {}
        reqs = []
        for j, ids in enumerate(wave):
            m = rt.cache.match(ids)
            reqs.append(Request(
                ids=list(ids), max_new=max_new, sample=sample,
                seed=None if seeds is None else seeds[len(out) + j],
                prefix=(m.length, m.block_ids) if m.length else None,
                on_prefill_blocks=lambda bids, ids=list(ids): rt.cache.insert(ids, bids),
                on_done=lambda t, s, j=j: res.__setitem__(j, (t, s))))
        if jax_side:
            eng = Engine(gen, slots=2, chunk=4, paged=rt, paged_flash=False, spec=spec)
        else:
            eng = Engine(gen, rt, slots=2, chunk=4, paged_flash=flash, spec=spec)
        stats = eng.run(lambda: reqs.pop(0) if reqs else None)
        out += [res[j] for j in range(len(wave))]
        out[-1] = out[-1] + (stats,)
    return out


def _tokens(results):
    return [r[0] for r in results]


class _OracleDrafter:
    """Drafts the reference greedy continuation of each prompt, with every
    third draft's last token wrong: verify steps then accept, reject and
    take bonus tokens (a random-weight tiny model rarely repeats itself,
    so prompt lookup alone would seldom be accepted)."""

    def __init__(self, prompts, ref):
        self.ref = {tuple(p): r for p, r in zip(prompts, ref)}
        self.calls = 0

    def draft(self, history, k):
        for p, r in self.ref.items():
            if tuple(history[:len(p)]) == p:
                done = len(history) - len(p)
                toks = list(r[done:done + k])
                self.calls += 1
                if toks and self.calls % 3 == 0:
                    toks[-1] = (toks[-1] + 1) % 512
                return toks
        return []


def _leak_free(rt):
    rt.cache.clear()
    assert rt.pool.n_free == rt.pool.capacity_blocks


@pytest.mark.parametrize("spec", [False, True], ids=["spec-off", "spec-on"])
def test_greedy_ids_equal_jax(gens, spec):
    jgen, pgen = gens
    ref = _tokens(_serve("jax", jgen, _jax_runtime(jgen), [_prompts()]))
    assert all(len(t) == 12 for t in ref)
    for flash in (False, True):
        for drafter in ((None, _OracleDrafter(_prompts(), ref)) if spec else (None,)):
            rt = _port_runtime(pgen)
            got = _serve("port", pgen, rt, [_prompts()], flash=flash,
                         spec=SpecConfig(tokens=3, drafter=drafter) if spec else None)
            assert _tokens(got) == ref, (flash, spec, drafter)
            stats = got[-1][2]
            assert stats["decode_kernel"] == ("paged_flash" if flash else "gather")
            if drafter is not None:
                assert 0 < stats["spec_accepted_tokens"] < stats["spec_drafted_tokens"]
            _leak_free(rt)


@pytest.mark.parametrize("masked", [True, False], ids=["masked-suffix", "streaming-suffix"])
def test_prefix_hit_ids_equal_jax(gens, masked):
    """A second wave whose prompts share a cached two-block system prompt:
    the hit rows prefill only their suffix (one masked pass, or the
    streaming flash path when ``MASKED_PREFILL_MAX = 0``)."""
    jgen, pgen = gens
    waves = [[SYSTEM + [40, 41, 42]], [SYSTEM + [50 + i, 7, 50 + i, 7, 9] for i in range(3)]]
    old = (jgen.MASKED_PREFILL_MAX, pgen.MASKED_PREFILL_MAX)
    if not masked:
        jgen.MASKED_PREFILL_MAX = pgen.MASKED_PREFILL_MAX = 0
    try:
        jrt = _jax_runtime(jgen)
        ref = _tokens(_serve("jax", jgen, jrt, waves))
        prt = _port_runtime(pgen)
        got = _serve("port", pgen, prt, waves, flash=True, spec=SpecConfig(tokens=3))
    finally:
        jgen.MASKED_PREFILL_MAX, pgen.MASKED_PREFILL_MAX = old
    assert _tokens(got) == ref
    assert [r[1]["cached_tokens"] for r in got] == [0, 16, 16, 16]
    assert prt.cache.stats()["hits"] == jrt.cache.stats()["hits"] == 3
    _leak_free(prt)


def test_spec_on_equals_spec_off_and_counts_forward_steps(gens):
    _, pgen = gens
    off = _serve("port", pgen, _port_runtime(pgen), [_prompts(3)], flash=True)
    on = _serve("port", pgen, _port_runtime(pgen), [_prompts(3)], flash=True,
                spec=SpecConfig(tokens=3, drafter=_OracleDrafter(_prompts(3), _tokens(off))))
    assert _tokens(on) == _tokens(off)
    assert on[-1][2]["spec_accepted_tokens"] > 0
    for stats in (off[-1][2], on[-1][2]):
        # each forward pass reads the pool once per layer: plain chunks
        # count `chunk` passes, a verify one
        assert stats["kernel_forward_steps"] == \
            stats["decode_weight_passes"] > 0
        assert stats["kernel_paged_flash_dispatches"] > 0
        assert stats["kernel_gather_dispatches"] == 0


def test_seeded_sampling_depends_on_prompt_and_seed_only(gens):
    """A sampled request's tokens are a function of (prompt, seed): alone,
    or admitted beside other requests, they are the same."""
    _, pgen = gens
    sample = SampleConfig(greedy=False, temperature=0.9, top_k=8)
    prompts = _prompts(3)
    alone = _serve("port", pgen, _port_runtime(pgen), [[prompts[1]]], sample=sample,
                   seeds=[42])
    crowd = _serve("port", pgen, _port_runtime(pgen), [prompts], sample=sample,
                   seeds=[7, 42, 9])
    assert _tokens(crowd)[1] == _tokens(alone)[0]
    again = _serve("port", pgen, _port_runtime(pgen), [prompts], sample=sample,
                   seeds=[7, 42, 9])
    assert _tokens(again) == _tokens(crowd)
    other = _serve("port", pgen, _port_runtime(pgen), [[prompts[1]]], sample=sample,
                   seeds=[43])
    assert _tokens(other)[0] != _tokens(alone)[0]


def test_pool_exhaustion_errors_the_request_and_leaks_nothing(gens):
    """A request the pool cannot cover retires with an error and returns
    every reference; the others are served."""
    _, pgen = gens
    pool = kv_pool.KVBlockPool(4 + 1, BLOCK)
    rt = kv_pool.PagedKVRuntime(init_kv_pool(pgen.cfg, 5, BLOCK, torch.float32, "cpu"), pool,
                                pgen.cfg.max_seq)
    res = {}
    reqs = [SlotRequest(ids=[3, 4, 5], max_new=20, sample=SampleConfig(greedy=True),
                        on_done=lambda t, s, j=j: res.__setitem__(j, (t, s)))
            for j in range(2)]
    ContinuousEngine(pgen, rt, slots=2, chunk=4).run(lambda: reqs.pop(0) if reqs else None)
    assert len(res[0][0]) == 20
    assert res[1][0] is None and "out of KV blocks" in res[1][1]["error"]
    assert pool.n_free == pool.capacity_blocks
