"""The LLM engine knobs of the port's server take effect, on the CPU.

Fault C4 (``ROADMAP.md`` section C): ``TPUSTACK_PREFILL_CHUNK_TOKENS`` and
``TPUSTACK_KV_HOST_TIER_MB`` were neither refused nor served.  Held here,
on env boots of the tiny preset (``LLM_PRESET=tiny LLM_DEVICE=cpu``):

- chunked prefill arms the engine: a long prompt's run reports
  ``prefill_chunks``, ``tpustack_llm_prefill_chunks_total`` moves, and the
  content equals the unchunked boot's (the JAX
  ``test_chunked_prefill_env_knob_arms_engine`` against the server);
- the host tier is built behind the paged prefix cache: ``/props``
  ``prefix_cache.host_tier`` exists, a working set larger than the pool
  spills and restores, the ``tpustack_llm_kv_host_*`` counters equal the
  tier's ledger, and the content equals the tier-off boot's (the JAX
  ``test_server_tier_onoff_byte_identity_and_counters`` and
  ``test_host_tier_env_bisection_subprocess``);
- the solo engine answers 504 naming ``queued`` (waiting for the device)
  or ``decode`` (generating), and serves again after;
- a configuration whose prefill would reach the streaming flash kernel
  outside its contract is refused at startup;
- the new knobs keep the JAX registry's names, types and defaults, and the
  new metric families the JAX catalog's specs.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tpustack.obs import catalog as jax_catalog
from tpustack.utils import knobs as jax_knobs
from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llm_generate import Generator
from tpustack_torch.models.text_tokenizer import ByteTokenizer
from tpustack_torch.obs import catalog
from tpustack_torch.serving.llm_server import LLMServer
from tpustack_torch.utils import knobs

NEW_KNOBS = ("TPUSTACK_PAGED_KV", "TPUSTACK_PREFIX_CACHE_MB", "TPUSTACK_PREFIX_CACHE_CHUNK",
             "TPUSTACK_KV_HOST_TIER_MB", "TPUSTACK_KV_HOST_TIER_CROSSOVER",
             "TPUSTACK_PREFILL_CHUNK_TOKENS", "TPUSTACK_SPEC_DRAFT", "TPUSTACK_SPEC_DRAFT_DIR")
NEW_FAMILIES = ("tpustack_llm_prefix_cache_evictions_total", "tpustack_llm_prefix_cache_bytes",
                "tpustack_llm_prefix_cache_entries", "tpustack_llm_kv_host_spilled_blocks_total",
                "tpustack_llm_kv_host_restored_blocks_total",
                "tpustack_llm_kv_host_expired_blocks_total",
                "tpustack_llm_kv_host_resident_bytes", "tpustack_llm_prefill_chunks_total")


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if r.headers.get_content_type()
                              == "application/json" else raw.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _metric(text, name):
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.split()[-1])
    return None


def _boot(monkeypatch, env):
    for k, v in dict({"LLM_PRESET": "tiny", "LLM_DEVICE": "cpu"}, **env).items():
        monkeypatch.setenv(k, v)
    srv = LLMServer()
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    return srv


def _serve(srv, prompts, n_predict=6):
    out = []
    for p in prompts:
        st, body = _call(srv.url + "/completion", {"prompt": p, "n_predict": n_predict,
                                                   "temperature": 0})
        assert st == 200, body
        out.append(body["content"])
    return out


LONG = "a long report on device memory bandwidth kernels and queues " * 2  # 121 tokens


def test_chunked_prefill_knob_arms_the_server(monkeypatch):
    outs, runs = {}, {}
    for chunk in ("0", "32"):
        srv = _boot(monkeypatch, {"TPUSTACK_PREFILL_CHUNK_TOKENS": chunk,
                                  "TPUSTACK_PREFIX_CACHE": "0"})
        try:
            m0 = _metric(_call(srv.url + "/metrics")[1], "tpustack_llm_prefill_chunks_total")
            outs[chunk] = _serve(srv, [LONG[:-1], "hello there"])
            m1 = _metric(_call(srv.url + "/metrics")[1], "tpustack_llm_prefill_chunks_total")
            runs[chunk] = list(srv.run_log)
            props = _call(srv.url + "/props")[1]
        finally:
            srv.stop()
        assert props["paged_kv"]["prefill_chunk_tokens"] == int(chunk)
        if chunk == "0":
            assert all("prefill_chunks" not in r for r in runs[chunk])
            assert (m1 or 0) == (m0 or 0)
        else:
            # 112 + 8 = 120 prompt tokens over 32-token chunks: three chunk
            # dispatches, then the 24-token warm start
            chunks = sum(r.get("prefill_chunks", 0) for r in runs[chunk])
            assert chunks == 3 and m1 - (m0 or 0) == chunks
    assert outs["0"] == outs["32"]


def _docs(n=6):
    return [f"document number {d} body padding xyzw" * 2 for d in range(n)] * 2


def _deltas(before, after, names):
    return {n: (_metric(after, n) or 0.0) - (_metric(before, n) or 0.0) for n in names}


HOST_FAMILIES = ("tpustack_llm_kv_host_spilled_blocks_total",
                 "tpustack_llm_kv_host_restored_blocks_total",
                 "tpustack_llm_prefix_cache_evictions_total")


def test_host_tier_knob_builds_the_tier_and_counts(monkeypatch):
    env = {"TPUSTACK_KV_POOL_BLOCKS": "12", "TPUSTACK_KV_HOST_TIER_CROSSOVER": "0"}
    outs = {}
    for mb in ("0", "8"):
        srv = _boot(monkeypatch, dict(env, TPUSTACK_KV_HOST_TIER_MB=mb))
        try:
            m0 = _call(srv.url + "/metrics")[1]
            outs[mb] = _serve(srv, _docs(), n_predict=4)
            props = _call(srv.url + "/props")[1]
            moved = _deltas(m0, _call(srv.url + "/metrics")[1], HOST_FAMILIES)
            srv.paged.cache.clear()
            assert srv.paged.pool.n_free == srv.paged.pool.capacity_blocks
        finally:
            srv.stop()
        cache = props["prefix_cache"]
        assert moved["tpustack_llm_prefix_cache_evictions_total"] == cache["evictions"] > 0
        if mb == "0":
            assert "host_tier" not in cache
            assert moved["tpustack_llm_kv_host_spilled_blocks_total"] == 0
            continue
        st = cache["host_tier"]
        assert st["spilled_total"] > 0 and st["restored_total"] > 0, st
        assert st["spilled_total"] == st["restored_total"] + st["expired_total"] + \
            st["resident_blocks"]
        assert cache["host_hits"] > 0
        assert moved["tpustack_llm_kv_host_spilled_blocks_total"] == st["spilled_total"]
        assert moved["tpustack_llm_kv_host_restored_blocks_total"] == st["restored_total"]
    assert outs["0"] == outs["8"]


def test_dense_store_knobs_and_eviction_counter(monkeypatch):
    srv = _boot(monkeypatch, {"TPUSTACK_PAGED_KV": "0", "TPUSTACK_PREFIX_CACHE_CHUNK": "16",
                              "TPUSTACK_PREFIX_CACHE_MB": "0.07"})
    names = ("tpustack_llm_prefix_cache_evictions_total",)
    try:
        assert srv.paged is None and srv.prefix_cache.chunk == 16
        m0 = _call(srv.url + "/metrics")[1]
        out = _serve(srv, _docs(3))
        cache = _call(srv.url + "/props")[1]["prefix_cache"]
        metrics = _call(srv.url + "/metrics")[1]
    finally:
        srv.stop()
    assert len(out) == 6 and cache["chunk_tokens"] == 16 and cache["hits"] > 0
    assert cache["evictions"] > 0 and cache["resident_bytes"] <= 0.07 * 1024 * 1024
    assert _deltas(m0, metrics, names)[names[0]] == cache["evictions"]
    assert _metric(metrics, "tpustack_llm_prefix_cache_bytes") == cache["resident_bytes"]
    assert _metric(metrics, "tpustack_llm_prefix_cache_entries") == cache["entries"]


def test_solo_deadlines_name_queued_or_decode(monkeypatch):
    srv = _boot(monkeypatch, {"LLM_MAX_BATCH": "1", "TPUSTACK_FAULT_SLOW_PREFILL_S": "0.5"})
    try:
        body = {"prompt": "hello", "n_predict": 8, "temperature": 0}
        st, out = _call(srv.url + "/completion", dict(body, timeout_s=0.1))
        assert st == 504 and out["phase"] == "decode", out
        with srv._device_lock:  # another request holds the device
            st, out = _call(srv.url + "/completion", dict(body, timeout_s=0.1))
        assert st == 504 and out["phase"] == "queued", out
        st, out = _call(srv.url + "/completion", body)
        assert st == 200 and out["tokens_predicted"] >= 1
        health = _call(srv.url + "/healthz")[1]
        assert health["engine"]["engine"] == "solo"
    finally:
        srv.stop()


def test_solo_requests_wait_on_the_device_in_turn(monkeypatch):
    srv = _boot(monkeypatch, {"LLM_MAX_BATCH": "1"})
    try:
        res = [None] * 3

        def go(i):
            res[i] = _call(srv.url + "/completion", {"prompt": f"turn {i}", "n_predict": 6,
                                                     "temperature": 0})

        with srv._device_lock:
            threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for _ in range(200):
                if srv._solo_waiting == 3:
                    break
                threading.Event().wait(0.01)
            assert srv.resilience.queue_depth() == 3  # all three wait for the device
        for t in threads:
            t.join(timeout=60)
        assert [r[0] for r in res] == [200] * 3 and srv._solo_waiting == 0
    finally:
        srv.stop()


def test_stream_route_outside_the_kernel_contract_is_refused():
    """float32 ``tiny`` on CUDA: at ctx 128 no prefill reaches the
    streaming kernel; at ctx 4096 one would, so the server refuses to
    start.  (The check reads the generator's device: a CPU generator is
    relabelled here.)"""
    for ctx, refused in ((128, False), (4096, True)):
        gen = Generator(LlamaConfig.tiny(max_seq=ctx), dtype=torch.float32, device="cpu")
        gen.device = torch.device("cuda")
        why = gen.stream_route_violation()
        assert (why is not None) == refused, why
        if refused:
            assert "bfloat16" in why
            with pytest.raises(ValueError, match="streaming flash prefill"):
                LLMServer(gen, ByteTokenizer(512), max_batch=2, paged=None, spec=None)
    bf16 = Generator(LlamaConfig.tiny(max_seq=4096), dtype=torch.bfloat16, device="cpu")
    bf16.device = torch.device("cuda")
    assert bf16.stream_route_violation() is None


def test_new_knobs_and_families_equal_jax():
    for name in NEW_KNOBS:
        port, ref = knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
        assert (port.type, port.default) == (ref.type, ref.default), name
    ref = {s.name: s for s in jax_catalog.CATALOG}
    port = {s.name: s for s in catalog.CATALOG}
    for name in NEW_FAMILIES:
        assert (port[name].type, port[name].labels, port[name].buckets, port[name].unit) == \
            (ref[name].type, ref[name].labels, ref[name].buckets, ref[name].unit), name
