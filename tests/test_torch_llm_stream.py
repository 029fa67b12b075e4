"""Server-sent-event streaming on the port's LLM server, on the CPU.

Both shapes of the JAX server's ``_stream``: llama.cpp chunks on
``/completion`` (``{content, stop: false}`` deltas, then a final event with
the body's fields and ``timings``) and OpenAI ``chat.completion.chunk``
events plus ``[DONE]`` on ``/v1/chat/completions``.  Held here: the deltas
concatenate to the non-streamed greedy content; the streamed token ids equal
the JAX paged engine's on the tiny fixture of ``test_torch_llm_engine.py``
(the same flax weights carried across); admission errors answer as JSON
before the stream starts; a client that disconnects cancels its row and the
pool ends whole; a deadline ends the stream with an error event; and the
incremental detokeniser never splits a multi-byte character.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

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
from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llama_weights import params_from_jax
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.models.text_tokenizer import ByteTokenizer
from tpustack_torch.obs import Registry, Tracer
from tpustack_torch.serving.llm_server import IncrementalDetokenizer, LLMServer, build_paged
from tpustack_torch.serving.speculative import SpecConfig

CAP, BLOCK = 32, 8
BODY_FIELDS = {"content", "model", "stop", "stopped_eos", "stopped_limit", "tokens_evaluated",
               "tokens_predicted", "timings"}


@pytest.fixture(scope="module")
def gens():
    """The JAX tiny generator (seed 3) and the port's on the same weights."""
    jgen = JaxGenerator(JaxConfig.tiny(max_seq=64), dtype=jnp.float32, seed=3)
    pgen = Generator(LlamaConfig.tiny(max_seq=64), params=params_from_jax(jgen.params),
                     dtype=torch.float32, device="cpu")
    return jgen, pgen


@pytest.fixture(scope="module")
def server(gens):
    pgen = gens[1]
    srv = LLMServer(pgen, ByteTokenizer(512), max_batch=4,
                    paged=build_paged(pgen, 4, block=BLOCK, n_blocks=CAP),
                    spec=SpecConfig(tokens=3), registry=Registry(), tracer=Tracer())
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    yield srv
    srv.stop()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _events(raw: bytes):
    """The ``data:`` payloads of an SSE body, ``[DONE]`` kept as a string."""
    out = []
    for block in raw.decode().split("\n\n"):
        if block.startswith("data: "):
            data = block[len("data: "):]
            out.append(data if data == "[DONE]" else json.loads(data))
    return out


def _pool_whole(srv):
    t_end = time.monotonic() + 10
    while (srv._engine is not None or srv._queue) and time.monotonic() < t_end:
        time.sleep(0.01)
    srv.paged.cache.clear()
    return srv.paged.pool.n_free == srv.paged.pool.capacity_blocks


@pytest.mark.parametrize("prompt,n", [("the quick brown fox", 24), ("abcabcabcabc", 30),
                                      ("héllo wörld ✓", 12)])
def test_completion_stream_equals_the_non_streamed_body(server, prompt, n):
    body = {"prompt": prompt, "n_predict": n, "temperature": 0, "cache_prompt": False}
    st, _, plain = _post(server.url + "/completion", body)
    plain = json.loads(plain)
    st, hd, raw = _post(server.url + "/completion", dict(body, stream=True))
    assert st == 200 and hd["Content-Type"] == "text/event-stream"
    assert len(hd["X-Request-Id"]) == 12 and "X-Trace-Id" in hd
    events = _events(raw)
    assert len(events) >= 2 and all(e["stop"] is False for e in events[:-1])
    final = events[-1]
    assert final["stop"] is True and BODY_FIELDS <= set(final) and final["content"] == ""
    assert set(final["timings"]) == set(plain["timings"])
    assert final["tokens_predicted"] == plain["tokens_predicted"]
    assert final["stopped_eos"] == plain["stopped_eos"]
    assert "".join(e["content"] for e in events[:-1]) == plain["content"]
    assert _pool_whole(server)


def test_chat_stream_equals_the_non_streamed_body(server):
    body = {"messages": [{"role": "user", "content": "hey there"}], "max_tokens": 20,
            "temperature": 0, "cache_prompt": False}
    plain = json.loads(_post(server.url + "/v1/chat/completions", body)[2])
    st, _, raw = _post(server.url + "/v1/chat/completions", dict(body, stream=True))
    events = _events(raw)
    assert st == 200 and events[-1] == "[DONE]"
    chunks = events[:-1]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert len({c["id"] for c in chunks}) == 1 and chunks[0]["id"].startswith("chatcmpl-")
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant", "content": ""}
    assert chunks[-1]["choices"][0]["finish_reason"] == plain["choices"][0]["finish_reason"]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    assert text == plain["choices"][0]["message"]["content"]


def _jax_ids(jgen, prompts, max_new):
    pool = jax_kv.KVBlockPool(CAP + 1, BLOCK)
    rt = jax_kv.PagedKVRuntime(jax_init_pool(jgen.cfg, CAP + 1, BLOCK, jnp.float32), pool,
                               jgen.cfg.max_seq, None)
    streamed = {i: [] for i in range(len(prompts))}
    done = {}
    reqs = [JaxRequest(ids=list(p), max_new=max_new, sample=JaxSample(greedy=True),
                       on_tokens=lambda t, i=i: streamed[i].extend(t),
                       on_done=lambda t, s, i=i: done.__setitem__(i, list(t)))
            for i, p in enumerate(prompts)]
    JaxEngine(jgen, slots=2, chunk=4, paged=rt, paged_flash=False).run(
        lambda: reqs.pop(0) if reqs else None)
    assert all(streamed[i] == done[i] for i in done)
    return [done[i] for i in range(len(prompts))]


def test_streamed_ids_equal_the_jax_paged_engine(gens, server):
    jgen, pgen = gens
    tok = ByteTokenizer(512)
    prompts = [tok.encode(p) for p in ("stream one", "stream two!", "x")]
    want = _jax_ids(jgen, prompts, 12)
    # the port engine's on_tokens, wave by wave, over both paged views
    for flash in (False, True):
        pool_rt = build_paged(pgen, 2, block=BLOCK, n_blocks=CAP, prefix_cache=False)
        streamed = {i: [] for i in range(len(prompts))}
        waves = {i: 0 for i in range(len(prompts))}

        def on_tokens(t, i):
            streamed[i].extend(t)
            waves[i] += 1

        reqs = [SlotRequest(ids=list(p), max_new=12, sample=SampleConfig(greedy=True),
                            on_tokens=lambda t, i=i: on_tokens(t, i))
                for i, p in enumerate(prompts)]
        ContinuousEngine(pgen, pool_rt, slots=2, chunk=4, paged_flash=flash).run(
            lambda: reqs.pop(0) if reqs else None)
        assert [streamed[i] for i in range(len(prompts))] == want
        assert all(1 < waves[i] <= 4 for i in waves)  # one delivery per wave, not per token
    # and through the server's SSE
    for p, ids in zip(("stream one", "stream two!", "x"), want):
        raw = _post(server.url + "/completion", {"prompt": p, "n_predict": 12, "temperature": 0,
                                                 "stream": True, "cache_prompt": False})[2]
        events = _events(raw)
        if ids and ids[-1] == tok.eos_id:
            ids = ids[:-1]
        assert "".join(e["content"] for e in events[:-1]) == tok.decode(ids)


def test_concurrent_streams_ride_one_engine_run(server):
    bodies = [{"prompt": p, "n_predict": 16, "temperature": 0, "cache_prompt": False}
              for p in ("first stream", "second stream", "third")]
    solo = [json.loads(_post(server.url + "/completion", b)[2])["content"] for b in bodies]
    runs0 = len(server.run_log)
    out = [None] * len(bodies)
    server._wake.clear()
    gate = threading.Event()
    orig = server._wake.wait

    def held_wait(timeout=None):  # start the engine only once all three are queued
        gate.wait(10)
        return orig(timeout)

    server._wake.wait = held_wait
    try:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, _post(
            server.url + "/completion", dict(bodies[i], stream=True)))) for i in range(3)]
        for t in threads:
            t.start()
        t_end = time.monotonic() + 10
        while len(server._queue) < 3 and time.monotonic() < t_end:
            time.sleep(0.01)
        gate.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        server._wake.wait = orig
    assert all(o[0] == 200 for o in out)
    texts = ["".join(e["content"] for e in _events(o[2])[:-1]) for o in out]
    assert texts == solo
    assert _pool_whole(server)  # the run is over and logged
    assert [r["requests"] for r in list(server.run_log)[runs0:]] == [3]


def test_admission_errors_answer_json_before_the_stream(server):
    st, hd, raw = _post(server.url + "/completion", {"prompt": "x" * 100, "stream": True})
    assert st == 400 and hd["Content-Type"] == "application/json"
    assert "exceeds ctx" in json.loads(raw)["error"]
    pool = server.paged.pool
    server.paged.cache.clear()
    held = pool.alloc_tokens((pool.n_free - 1) * pool.block)  # one block left
    try:
        st, hd, raw = _post(server.url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x" * 20}], "max_tokens": 20,
            "stream": True})
        assert st == 429 and hd["X-Shed-Reason"] == "out_of_kv_blocks"
        assert int(hd["Retry-After"]) >= 1
        assert "out of KV blocks" in json.loads(raw)["error"]["message"]
    finally:
        pool.decref(held)
    assert _pool_whole(server)


def test_a_disconnected_client_cancels_its_row(gens):
    pgen = gens[1]
    srv = LLMServer(pgen, ByteTokenizer(512), max_batch=2,
                    paged=build_paged(pgen, 2, block=BLOCK, n_blocks=CAP), spec=None,
                    registry=Registry(), tracer=Tracer())
    srv.engine_chunk = 1  # a wave (and a write) per token
    port = srv.start(host="127.0.0.1", port=0)
    try:
        body = json.dumps({"prompt": "bye", "n_predict": 56, "temperature": 0,
                           "stream": True, "cache_prompt": False}).encode()
        sock = socket.create_connection(("127.0.0.1", port))
        sock.sendall(b"POST /completion HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"application/json\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
        got = b""
        while b"data: " not in got:
            got += sock.recv(4096)
        sock.close()  # gone after the first event
        assert _pool_whole(srv)
        assert srv.run_log and srv.run_log[-1]["generated_tokens"] < 56
        # the server still serves
        assert _post(f"http://127.0.0.1:{port}/completion",
                     {"prompt": "next", "n_predict": 3, "temperature": 0})[0] == 200
    finally:
        srv.stop()


def test_a_stream_past_its_deadline_ends_with_an_error_event(gens, monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_SLOW_PREFILL_S", "0.3")
    pgen = gens[1]
    srv = LLMServer(pgen, ByteTokenizer(512), max_batch=2,
                    paged=build_paged(pgen, 2, block=BLOCK, n_blocks=CAP), spec=None,
                    registry=Registry(), tracer=Tracer())
    url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    try:
        st, _, raw = _post(url + "/completion", {"prompt": "slow", "n_predict": 20,
                                                 "stream": True, "timeout_s": 0.05})
        events = _events(raw)
        assert st == 200 and events[-1]["stop"] is True and "deadline" in events[-1]["error"]
        assert _pool_whole(srv)
        assert sum(srv._registry.get_sample_value("tpustack_deadline_exceeded_total", {
            "server": "llm", "phase": p}) or 0 for p in ("queued", "decode")) == 1
    finally:
        srv.stop()


@pytest.mark.parametrize("text", ["héllo wörld — ✓ 日本語 🙂 ok", "ascii only", "🙂🙂🙂"])
def test_the_detokenizer_never_splits_a_character(text):
    tok = ByteTokenizer(512)
    ids = tok.encode(text, add_bos=False)
    detok = IncrementalDetokenizer(tok)
    deltas = [detok.push(t) for t in ids]
    deltas.append(detok.flush())
    assert all("�" not in d for d in deltas)
    assert "".join(deltas) == text
    assert sum(1 for d in deltas if d) > 1  # it streams, it does not hold everything


def test_the_detokenizer_flushes_invalid_bytes_after_its_hold_window():
    tok = ByteTokenizer(512)
    ids = [0xE6 + 3] + tok.encode("a" * 20, add_bos=False)  # a lead byte, then ASCII
    detok = IncrementalDetokenizer(tok)
    deltas = [detok.push(t) for t in ids] + [detok.flush()]
    assert "".join(deltas) == tok.decode(ids)
    held = [i for i, d in enumerate(deltas) if d]
    assert held[0] >= 1  # held back at least while the window ended in U+FFFD
