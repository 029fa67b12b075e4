"""The port's dense continuous engine (``ContinuousEngine(gen, paged=None)``,
the ``TPUSTACK_PAGED_KV=0`` server) and its draft-model drafter against the
JAX package's, on the CPU.

Both engines get the same flax weights (``LlamaConfig.tiny(max_seq=64)``
from seed 3, carried across by ``params_from_jax``), the same requests and
two slots, in float32, and must return the same greedy token ids: more
requests than slots, a request admitted mid-run, speculation on and off,
the int8 KV cache, and a dense prefix-store hit (restore + suffix prefill,
the stores filled by each engine's own ``kv_extract`` inserts).  The
oracle for speculation is the JAX engine with speculation off (the JAX
spec-on server test is red at this tree, ``ROADMAP.md`` section C).

The draft model: ``DraftModelDrafter`` over a tiny draft with carried
weights proposes what the JAX drafter proposes; a self-draft reaches full
acceptance (the JAX ``test_engine_spec_draft_model_full_acceptance``); spec
on with the drafter equals spec off, on the dense and the paged engine.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from tpustack.models.llama import LlamaConfig as JaxConfig
from tpustack.models.llm_continuous import ContinuousEngine as JaxEngine
from tpustack.models.llm_continuous import SlotRequest as JaxRequest
from tpustack.models.llm_generate import Generator as JaxGenerator
from tpustack.models.llm_generate import SampleConfig as JaxSample
from tpustack.serving.prefix_cache import PrefixCache as JaxPrefixCache
from tpustack.serving.speculative import DraftModelDrafter as JaxDraftModelDrafter
from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llama_weights import params_from_jax
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.serving.llm_server import build_paged
from tpustack_torch.serving.prefix_cache import PrefixCache
from tpustack_torch.serving.speculative import DraftModelDrafter, SpecConfig

SYSTEM = [5, 9, 14, 3, 9, 14, 21, 5, 9, 14, 3, 9, 14, 21, 6, 8]  # two 8-token chunks


def _pair(kv_quant=None, seed=3):
    jcfg = dataclasses.replace(JaxConfig.tiny(max_seq=64), kv_quant=kv_quant)
    jgen = JaxGenerator(jcfg, dtype=jnp.float32, seed=seed)
    cfg = dataclasses.replace(LlamaConfig.tiny(max_seq=64), kv_quant=kv_quant)
    return jgen, Generator(cfg, params=params_from_jax(jgen.params), dtype=torch.float32,
                           device="cpu")


@pytest.fixture(scope="module", params=[None, "int8"], ids=["float-kv", "int8-kv"])
def gens(request):
    return _pair(request.param)


def _prompts(n):
    return [[3 + i, 7, 11, 13 + i, 7, 11, 13 + i, 7, 2 + i] for i in range(n)]


def _serve(side, gen, prompts, *, spec=None, late=(), store=None, max_new=10, paged=None):
    """One engine run over ``prompts`` (``late`` indices join mid-run: feed
    holds them back for its first three calls).  ``store``: a dense prefix
    store looked up and filled as the server does.  Returns the token ids in
    prompt order and the retire stats."""
    jax_side = side == "jax"
    Req = JaxRequest if jax_side else SlotRequest
    sample = JaxSample(greedy=True) if jax_side else SampleConfig(greedy=True)
    res = {}

    def request(j):
        ids = list(prompts[j])
        kw = {}
        if store is not None:
            m = store.match(ids)
            if m.length:
                kw["prefix"] = (m.length, m.kv, m.key)
            upto = store.snap(len(ids))
            if upto > m.length:
                kw["kv_extract"] = (m.length, upto)
                kw["on_prefill_kv"] = lambda kv, s=m.length, ids=ids: store.insert(ids, s, kv)
        return Req(ids=ids, max_new=max_new, sample=sample,
                   on_done=lambda t, s, j=j: res.__setitem__(j, (t, s)), **kw)

    now = [j for j in range(len(prompts)) if j not in late]
    later = [j for j in range(len(prompts)) if j in late]
    calls = [0]

    def feed():
        calls[0] += 1
        if now:
            return request(now.pop(0))
        if later and calls[0] > 3:
            return request(later.pop(0))
        return None

    if jax_side:
        eng = JaxEngine(gen, slots=2, chunk=4, spec=spec)
    else:
        eng = ContinuousEngine(gen, paged, slots=2, chunk=4, spec=spec)
    stats = eng.run(feed)
    if later:  # every held-back request must have been admitted mid-run
        raise AssertionError(f"late requests never admitted: {later}")
    return [res[j][0] for j in range(len(prompts))], [res[j][1] for j in range(len(prompts))], \
        stats


@pytest.mark.parametrize("case", ["more-than-slots", "mid-run-admission"])
def test_dense_engine_greedy_ids_equal_jax(gens, case):
    jgen, pgen = gens
    prompts = _prompts(5) if case == "more-than-slots" else _prompts(2)
    late = () if case == "more-than-slots" else (1,)
    ref = _serve("jax", jgen, prompts, late=late)[0]
    got, _, stats = _serve("port", pgen, prompts, late=late)
    assert got == ref and all(len(t) == 10 for t in ref)
    assert "decode_kernel" not in stats  # the dense engine launches no paged kernel
    assert stats["requests"] == len(prompts)


class _OracleDrafter:
    """Drafts each prompt's reference greedy continuation with every third
    draft's last token wrong, so verify steps accept, reject and take bonus
    tokens (a random tiny model seldom repeats itself for prompt lookup)."""

    def __init__(self, prompts, ref):
        self.ref = {tuple(p): r for p, r in zip(prompts, ref)}
        self.calls = 0

    def draft(self, history, k):
        for p, r in self.ref.items():
            if tuple(history[:len(p)]) == p:
                toks = list(r[len(history) - len(p):][:k])
                self.calls += 1
                if toks and self.calls % 3 == 0:
                    toks[-1] = (toks[-1] + 1) % 512
                return toks
        return []


def test_dense_engine_speculation_equals_spec_off(gens):
    jgen, pgen = gens
    prompts = _prompts(3)
    ref = _serve("jax", jgen, prompts)[0]
    for drafter in (None, _OracleDrafter(prompts, ref)):
        got, _, stats = _serve("port", pgen, prompts, spec=SpecConfig(tokens=3, drafter=drafter))
        assert got == ref, drafter
    assert 0 < stats["spec_accepted_tokens"] < stats["spec_drafted_tokens"]


def test_dense_prefix_hit_equals_jax(gens):
    """A second wave sharing a stored two-chunk prefix: the hit rows restore
    it and prefill only their suffix."""
    jgen, pgen = gens
    waves = [[SYSTEM + [40, 41, 42]], [SYSTEM + [50 + i, 7, 50 + i] for i in range(3)]]
    jstore, pstore = JaxPrefixCache(chunk_tokens=8), PrefixCache(chunk_tokens=8)
    ref, got, cached = [], [], []
    for wave in waves:
        ref += _serve("jax", jgen, wave, store=jstore)[0]
        toks, stats, _ = _serve("port", pgen, wave, store=pstore)
        got += toks
        cached += [s["cached_tokens"] for s in stats]
    assert got == ref
    assert cached == [0, 16, 16, 16]
    assert pstore.stats()["hits"] == jstore.stats()["hits"] == 3
    assert pstore.stats()["entries"] == jstore.stats()["entries"]


# ---------------------------------------------------------------- draft model
@pytest.fixture(scope="module")
def drafts():
    """A tiny draft (seed 11) on both packages, with carried weights."""
    return _pair(seed=11)


def test_draft_model_proposes_what_the_jax_drafter_proposes(drafts):
    jd, pd = drafts
    jdr, pdr = JaxDraftModelDrafter(jd), DraftModelDrafter(pd)
    for history, k in (([5, 6, 7], 4), (list(range(3, 40)), 3), ([9] * 70, 4)):
        assert pdr.draft(history, k) == jdr.draft(history, k), (len(history), k)
    assert pdr.draft([], 4) == [] and pdr.draft([5], 0) == []


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_self_draft_full_acceptance_and_spec_off_equality(drafts, paged):
    """Drafting with the target itself: every draft agrees with the greedy
    argmax, so acceptance is 1.0, and the output is the spec-off engine's
    and the solo path's."""
    _, pgen = drafts
    prompts = [[5, 6, 7]]

    def rt():
        return build_paged(pgen, 2, block=8, n_blocks=16) if paged else None

    solo = pgen.generate_fused([5, 6, 7], max_new_tokens=17, sample=SampleConfig(greedy=True),
                               chunk=4)[0]
    off = _serve("port", pgen, prompts, max_new=17, paged=rt())[0]
    spec = SpecConfig(tokens=4, drafter=DraftModelDrafter(pgen))
    on, _, stats = _serve("port", pgen, prompts, max_new=17, spec=spec, paged=rt())
    assert on == off == [solo]
    assert stats["spec_acceptance"] == 1.0 and stats["spec_dispatches"] >= 3


def test_other_draft_model_keeps_spec_off_output(gens, drafts):
    """A draft model other than the target: proposals are mostly rejected,
    the output is still the spec-off engine's (the JAX engine's ids)."""
    jgen, pgen = gens
    prompts = _prompts(2)
    ref = _serve("jax", jgen, prompts)[0]
    spec = SpecConfig(tokens=3, drafter=DraftModelDrafter(drafts[1]))
    got, _, stats = _serve("port", pgen, prompts, spec=spec)
    assert got == ref
    assert stats["spec_drafted_tokens"] > 0
