"""The port's solo generator (the ``LLM_MAX_BATCH=1`` path) against the JAX
package's, on the CPU.

Both ``Generator`` instances hold the same flax weights (``LlamaConfig.tiny(
max_seq=64)`` from seed 3, carried across by ``params_from_jax``) in float32
and get the same prompts.  ``PREFILL_CHUNK = 16`` on both instances sends a
prompt longer than 16 tokens through the chunked prefill (the JAX
``_prefill_long``): its first chunk on the panel route, the rest through
the streaming flash kernel (the Pallas kernel in interpret mode on the JAX
side, the kernel's plain twin here).
The limit is equal greedy token ids: ``generate`` and ``generate_fused``
against the JAX ``generate_fused``, with stop tokens and the context limit;
``cancel_check`` stops between chunks; a dense prefix-store hit (restore +
suffix prefill, masked or streaming) equals the cold run (the JAX
``test_solo_prefix_restore_matches_cold``).
"""

import jax.numpy as jnp
import pytest
import torch

from tpustack.models.llama import LlamaConfig as JaxConfig
from tpustack.models.llm_generate import Generator as JaxGenerator
from tpustack.models.llm_generate import SampleConfig as JaxSample
from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llama_weights import params_from_jax
from tpustack_torch.models.llm_generate import Generator, SampleConfig

GREEDY, JGREEDY = SampleConfig(greedy=True), JaxSample(greedy=True)
CHUNK = 16  # PREFILL_CHUNK on both generators: prompts past it prefill in chunks


@pytest.fixture(scope="module")
def gens():
    jgen = JaxGenerator(JaxConfig.tiny(max_seq=64), dtype=jnp.float32, seed=3)
    pgen = Generator(LlamaConfig.tiny(max_seq=64), params=params_from_jax(jgen.params),
                     dtype=torch.float32, device="cpu")
    jgen.PREFILL_CHUNK = pgen.PREFILL_CHUNK = CHUNK
    return jgen, pgen


PROMPTS = {
    "short": [5, 6, 7],
    "one-bucket": [3 + (7 * j) % 90 for j in range(14)],
    "long": [3 + (5 * j) % 200 for j in range(40)],  # bucket 64: four 16-token chunks
}


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_generate_and_fused_equal_jax(gens, name):
    jgen, pgen = gens
    prompt = PROMPTS[name]
    ref, jst = jgen.generate_fused(prompt, max_new_tokens=10, sample=JGREEDY, chunk=4)
    fused, st = pgen.generate_fused(prompt, max_new_tokens=10, sample=GREEDY, chunk=4)
    loop, _ = pgen.generate(prompt, max_new_tokens=10, sample=GREEDY)
    assert fused == ref == loop and len(ref) == 10
    assert st["prompt_tokens"] == jst["prompt_tokens"] == len(prompt)
    assert st["cached_tokens"] == 0 and st["prefill_tokens"] == len(prompt)


def test_stop_tokens_and_the_context_limit(gens):
    jgen, pgen = gens
    prompt = PROMPTS["long"]
    free = jgen.generate_fused(prompt, max_new_tokens=8, sample=JGREEDY, chunk=4)[0]
    stop = (free[5],)
    ref = jgen.generate_fused(prompt, max_new_tokens=8, sample=JGREEDY, chunk=4,
                              stop_tokens=stop)[0]
    assert ref == free[:6]
    assert pgen.generate_fused(prompt, max_new_tokens=8, sample=GREEDY, chunk=4,
                               stop_tokens=stop)[0] == ref
    assert pgen.generate(prompt, max_new_tokens=8, sample=GREEDY, stop_tokens=stop)[0] == ref
    # 40 prompt tokens in a 64-token context: 24 new at most, the last 3
    # after the final whole chunk on the one-step tail path
    ref_ctx = jgen.generate_fused(prompt, max_new_tokens=100, sample=JGREEDY, chunk=5)[0]
    got = pgen.generate_fused(prompt, max_new_tokens=100, sample=GREEDY, chunk=5)[0]
    assert got == ref_ctx and len(got) == 64 - len(prompt)
    with pytest.raises(ValueError, match="exceeds ctx"):
        pgen.generate(list(range(3, 67)), max_new_tokens=4, sample=GREEDY)


def test_seeded_sampling_fused_equals_loop(gens):
    _, pgen = gens
    sample = SampleConfig(temperature=0.9, top_k=12)
    a = pgen.generate_fused(PROMPTS["one-bucket"], max_new_tokens=9, sample=sample, seed=7,
                            chunk=4)[0]
    b = pgen.generate(PROMPTS["one-bucket"], max_new_tokens=9, sample=sample, seed=7)[0]
    c = pgen.generate_fused(PROMPTS["one-bucket"], max_new_tokens=9, sample=sample, seed=8,
                            chunk=4)[0]
    assert a == b and a != c


def test_cancel_check_stops_between_chunks(gens):
    _, pgen = gens
    polls = []

    def cancel_after_two():
        polls.append(1)
        return len(polls) > 2

    out, _ = pgen.generate_fused(PROMPTS["short"], max_new_tokens=40, sample=GREEDY, chunk=4,
                                 cancel_check=cancel_after_two)
    # the first token plus at most the chunks fetched before the third poll
    assert 1 <= len(out) <= 1 + 4 and len(out) < 40
    full = pgen.generate_fused(PROMPTS["short"], max_new_tokens=40, sample=GREEDY, chunk=4)[0]
    assert out == full[:len(out)]


@pytest.mark.parametrize("masked", [True, False], ids=["masked-suffix", "streaming-suffix"])
def test_solo_prefix_restore_matches_cold(gens, masked):
    """A restored dense prefix-store segment plus the suffix prefill gives
    the cold run's tokens on both packages; the port's extract is the JAX
    extract's KV within 1e-5."""
    jgen, pgen = gens
    shared = list(range(5, 5 + 24))
    p1, p2 = shared + [40, 41, 42], shared + [50, 51]
    old = (jgen.MASKED_PREFILL_MAX, pgen.MASKED_PREFILL_MAX)
    if not masked:
        jgen.MASKED_PREFILL_MAX = pgen.MASKED_PREFILL_MAX = 0
    try:
        jstore, pstore = {}, {}
        jgen.generate_fused(p1, max_new_tokens=8, sample=JGREEDY, chunk=4, kv_extract=(0, 24),
                            on_prefill_kv=lambda kv: jstore.update(kv=kv))
        cold1, st1 = pgen.generate_fused(p1, max_new_tokens=8, sample=GREEDY, chunk=4,
                                         kv_extract=(0, 24),
                                         on_prefill_kv=lambda kv: pstore.update(kv=kv))
        assert st1["cached_tokens"] == 0 and st1["prefill_tokens"] == len(p1)
        kv = pstore["kv"]
        assert kv[0]["k"].shape[0] == 24
        for jl, pl in zip(jstore["kv"], kv):
            for k in jl:
                torch.testing.assert_close(pl[k], torch.from_numpy(jl[k].astype("float32")),
                                           atol=1e-5, rtol=1e-5)
        ref = jgen.generate_fused(p2, max_new_tokens=8, sample=JGREEDY, chunk=4,
                                  prefix=(24, jstore["kv"]))[0]
        cold2 = pgen.generate_fused(p2, max_new_tokens=8, sample=GREEDY, chunk=4)[0]
        warm2, st2 = pgen.generate_fused(p2, max_new_tokens=8, sample=GREEDY, chunk=4,
                                         prefix=(24, kv, ("key",)))
        warm2b = pgen.generate(p2, max_new_tokens=8, sample=GREEDY, prefix=(24, kv))[0]
    finally:
        jgen.MASKED_PREFILL_MAX, pgen.MASKED_PREFILL_MAX = old
    assert warm2 == cold2 == warm2b == ref
    assert st2["cached_tokens"] == 24 and st2["prefill_tokens"] == 2
    with pytest.raises(ValueError, match="must leave a suffix"):
        pgen.generate(shared, max_new_tokens=2, sample=GREEDY, prefix=(24, kv))
