"""The port's LLM server contract on the CPU, tiny preset, over real HTTP.

The llama.cpp surface of ``tpustack/serving/llm_server.py`` on the port's
standard-library server: the completion body fields, tokenize/detokenize,
the OpenAI chat shape, ``/props``, 429 + ``Retry-After`` when the KV pool
cannot cover a request, the clear refusals of what the port does not serve
yet (tensor parallelism, checkpoints, tokenizer directories, the draft
model's checkpoint directory) and of an unknown ``LLM_QUANT``, the
weight-only int8 boot (``LLM_QUANT=int8``), and the env boots of the solo
engine (``LLM_MAX_BATCH=1``), the dense engine (``TPUSTACK_PAGED_KV=0``) and
the draft-model drafter (``TPUSTACK_SPEC_DRAFT=tiny``), each serving the
default boot's greedy content.  Streaming is held in
``tests/test_torch_llm_stream.py``; the other engine knobs in
``tests/test_torch_llm_modes.py``.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llm_generate import Generator
from tpustack_torch.models.text_tokenizer import ByteTokenizer, load_text_tokenizer
from tpustack_torch.serving import llm_server
from tpustack_torch.serving.llm_server import LLMServer, build_paged
from tpustack_torch.serving.speculative import SpecConfig


@pytest.fixture(scope="module")
def server():
    gen = Generator(LlamaConfig.tiny(max_seq=128), dtype=torch.float32, device="cpu")
    srv = LLMServer(gen, ByteTokenizer(512), max_batch=4, paged=build_paged(gen, 4),
                    spec=SpecConfig(tokens=4))
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    yield srv
    srv.stop()


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_completion_body_and_determinism(server):
    body = {"prompt": "the quick brown fox", "n_predict": 12, "temperature": 0}
    status, _, out = _call(server.url + "/completion", body)
    assert status == 200
    assert set(out) >= {"content", "model", "stop", "stopped_eos", "stopped_limit",
                        "tokens_evaluated", "tokens_predicted", "timings"}
    assert set(out["timings"]) == {"prompt_n", "prompt_ms", "predicted_n", "predicted_ms",
                                   "predicted_per_second"}
    assert out["tokens_evaluated"] == len("the quick brown fox") + 1  # bytes + BOS
    assert out["stopped_eos"] or out["tokens_predicted"] == 12
    assert out["stopped_limit"] == (not out["stopped_eos"])
    again = _call(server.url + "/completion", dict(body, speculative=False))[2]
    assert again["content"] == out["content"]  # greedy: speculation changes nothing


def test_concurrent_completions_share_the_prefix_cache(server):
    system = "Be brief. " * 4  # 41 tokens with BOS: two whole 16-token blocks
    _call(server.url + "/completion", {"prompt": system + "hi", "n_predict": 4,
                                        "temperature": 0})
    hits0 = _call(server.url + "/props")[2]["prefix_cache"]["hits"]
    res = [None] * 4

    def go(i):
        res[i] = _call(server.url + "/completion",
                       {"prompt": system + f"q{i} " * (i + 1), "n_predict": 8,
                        "temperature": 0})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r[0] == 200 and r[2]["tokens_predicted"] >= 1 for r in res)
    props = _call(server.url + "/props")[2]
    assert props["prefix_cache"]["hits"] >= hits0 + 4
    assert props["paged_kv"]["used_blocks"] == props["prefix_cache"]["entries"]


def test_props(server):
    status, _, p = _call(server.url + "/props")
    assert status == 200
    assert p["n_ctx"] == 128 and p["slots"] == 4
    assert p["decode_kernel"] == "gather"  # TPUSTACK_PAGED_FLASH=auto: the kernel on CUDA
    assert p["paged_kv"]["enabled"] and p["paged_kv"]["block_tokens"] == 16
    assert p["speculative"]["enabled"] and p["speculative"]["tokens"] == 4
    assert {"drafted_tokens", "accepted_tokens"} <= set(p["speculative"])
    assert _call(server.url + "/health")[2] == {"status": "ok"}
    assert _call(server.url + "/healthz")[2]["engine"]["paged_kv"] is True


def test_tokenize_round_trip(server):
    toks = _call(server.url + "/tokenize", {"content": "héllo wörld"})[2]["tokens"]
    assert toks[0] != 1  # no BOS
    assert _call(server.url + "/detokenize", {"tokens": toks})[2]["content"] == "héllo wörld"


def test_chat_completion_shape(server):
    status, _, out = _call(server.url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5, "temperature": 0})
    assert status == 200
    assert out["object"] == "chat.completion" and out["id"].startswith("chatcmpl-")
    choice = out["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["finish_reason"] in ("stop", "length")
    u = out["usage"]
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]
    assert _call(server.url + "/v1/chat/completions", {"messages": []})[0] == 400


def test_full_pool_answers_429_with_retry_after(server):
    pool = server.paged.pool
    server.paged.cache.clear()
    held = pool.alloc_tokens((pool.n_free - 1) * pool.block)  # one block left
    try:
        status, headers, out = _call(server.url + "/completion",
                                     {"prompt": "x" * 40, "n_predict": 40})
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        assert headers["X-Shed-Reason"] == "out_of_kv_blocks"
        assert "out of KV blocks" in out["error"]
    finally:
        pool.decref(held)
    assert _call(server.url + "/completion", {"prompt": "x" * 40, "n_predict": 4})[0] == 200
    server.paged.cache.clear()
    assert pool.n_free == pool.capacity_blocks


def test_concurrent_stress_leaves_the_pool_whole(server):
    """More clients than slots and cores, with a short switch interval:
    every request is answered (200, or 429 while the pool is short) and,
    once idle, every block is back."""
    statuses, lock = [], threading.Lock()

    def go(i):
        st = _call(server.url + "/completion", {"prompt": f"stress {i} " * (1 + i % 5),
                                                 "n_predict": 6 + i % 7, "temperature": 0})[0]
        with lock:
            statuses.append(st)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=go, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(statuses) == 24 and set(statuses) <= {200, 429} and 200 in statuses
    server.paged.cache.clear()
    assert server.paged.pool.n_free == server.paged.pool.capacity_blocks


def test_bad_requests_answer_400(server):
    url = server.url + "/completion"
    assert _call(url, {"prompt": ""})[0] == 400
    assert _call(url, {"prompt": "x", "seed": "seven"})[0] == 400
    assert _call(url, {"prompt": "x" * 200})[0] == 400  # longer than ctx 128
    big = _call(url, {"prompt": "x", "n_predict": 10_000})  # clamped to ctx: served
    assert big[0] == 200


@pytest.mark.parametrize("env,what,exc", [
    pytest.param({"LLM_TP": "2"}, "LLM_TP", NotImplementedError, id="env0-LLM_TP"),
    # int8 is served now: a quant mode neither package knows still refuses
    pytest.param({"LLM_QUANT": "int4"}, "LLM_QUANT", ValueError, id="env1-LLM_QUANT"),
    pytest.param({"MODEL_DIR": "/nonexistent"}, "MODEL_DIR", NotImplementedError,
                 id="env2-MODEL_DIR"),
])
def test_unported_options_refuse_at_startup(monkeypatch, env, what, exc):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(exc, match=what):
        llm_server._build_generator()


def test_llm_quant_int8_boots_the_int8_model(monkeypatch):
    from tpustack_torch.ops.quant import Int8Dense, Int8Embed

    for k, v in {"LLM_PRESET": "tiny", "LLM_DEVICE": "cpu", "LLM_QUANT": "int8",
                 "LLM_KV_QUANT": "int8"}.items():
        monkeypatch.setenv(k, v)
    gen, tok, preset = llm_server._build_generator()
    assert gen.cfg.quant == "int8" and gen.cfg.kv_quant == "int8" and preset == "tiny"
    assert isinstance(gen.model.layers[0].self_attn.q_proj, Int8Dense)
    assert isinstance(gen.model.embed_tokens, Int8Embed)
    srv = LLMServer(gen, tok, max_batch=2, paged=build_paged(gen, 2), spec=None)
    url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    try:
        st, _, out = _call(url + "/completion", {"prompt": "int8", "n_predict": 6,
                                                 "temperature": 0})
        props = _call(url + "/props")[2]
    finally:
        srv.stop()
    assert st == 200 and out["tokens_predicted"] >= 1
    assert props["quant"] == "int8" and props["kv_quant"] == "int8"


def _boot_content(monkeypatch, env):
    """Greedy content of two prompts, plain and streamed, from an env boot
    (``LLM_PRESET=tiny LLM_DEVICE=cpu`` plus ``env``), and its ``/props``."""
    for k, v in dict({"LLM_PRESET": "tiny", "LLM_DEVICE": "cpu"}, **env).items():
        monkeypatch.setenv(k, v)
    srv = LLMServer()
    url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    out = []
    try:
        for prompt in ("the quick brown fox jumps over the lazy dog", "hello"):
            body = {"prompt": prompt, "n_predict": 12, "temperature": 0}
            st, _, plain = _call(url + "/completion", body)
            assert st == 200, plain
            out.append(plain["content"])
            req = urllib.request.Request(url + "/completion",
                                         data=json.dumps(dict(body, stream=True)).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                events = [json.loads(line[6:]) for line in r.read().decode().split("\n")
                          if line.startswith("data: ")]
            out.append("".join(e["content"] for e in events))
        props = _call(url + "/props")[2]
    finally:
        srv.stop()
    return out, props


@pytest.fixture(scope="module")
def default_content():
    mp = pytest.MonkeyPatch()
    try:
        return _boot_content(mp, {})[0]
    finally:
        mp.undo()


@pytest.mark.parametrize("env,engine,drafter", [
    pytest.param({"LLM_MAX_BATCH": "1"}, "solo", None, id="solo"),
    pytest.param({"TPUSTACK_PAGED_KV": "0"}, "dense", "prompt_lookup", id="dense"),
    pytest.param({"TPUSTACK_SPEC_DRAFT": "tiny"}, "paged", "DraftModelDrafter", id="draft-model"),
])
def test_engines_and_drafters_boot_and_serve(monkeypatch, default_content, env, engine,
                                             drafter):
    """The solo engine, the dense engine and the draft-model drafter boot
    from the environment and serve the default boot's greedy content,
    plain and streamed."""
    out, props = _boot_content(monkeypatch, env)
    assert out == default_content
    assert out[0] == out[1] and out[2] == out[3]  # streamed deltas = plain content
    assert props["engine"] == engine and props["speculative"]["drafter"] == drafter
    assert props["paged_kv"]["enabled"] == (engine == "paged")


def test_checkpoint_directories_still_refuse(monkeypatch, server):
    monkeypatch.setenv("TPUSTACK_SPEC_DRAFT", "tiny")
    monkeypatch.setenv("TPUSTACK_SPEC_DRAFT_DIR", "/some/draft")
    with pytest.raises(NotImplementedError, match="TPUSTACK_SPEC_DRAFT_DIR"):
        llm_server.build_spec(server.gen)
    monkeypatch.setenv("TPUSTACK_SPEC_DRAFT", "tiny-ish")
    with pytest.raises(ValueError, match="unknown preset"):
        llm_server.build_spec(server.gen)
    monkeypatch.setenv("LLM_TOKENIZER_DIR", "/some/dir")
    with pytest.raises(NotImplementedError, match="LLM_TOKENIZER_DIR"):
        load_text_tokenizer(152064)


def test_env_boot_tiny_on_cpu(monkeypatch):
    """``LLM_PRESET=tiny LLM_DEVICE=cpu``: the README's boot, end to end."""
    monkeypatch.setenv("LLM_PRESET", "tiny")
    monkeypatch.setenv("LLM_DEVICE", "cpu")
    srv = LLMServer()
    try:
        assert srv.gen.cfg.max_seq == 128 and srv.gen.device.type == "cpu"
        assert isinstance(srv.tok, ByteTokenizer)  # vocab 512 < the BPE's
        content, stats, _ = srv.complete("hello", n_predict=3, temperature=0)
        assert stats["generated_tokens"] >= 1 and isinstance(content, str)
    finally:
        srv.stop()
