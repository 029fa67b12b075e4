"""The port's resilience layer on the CPU: the JAX ``tests/test_resilience.py``
cases on the port's three standard-library servers, plus the manager's
parity with the JAX one and the paged-kernel verdict of the LLM engine.

Every failure is driven through the deterministic ``TPUSTACK_FAULT_*``
knobs, and one drain through a real SIGTERM to a server subprocess:

- drain: the state machine, ``POST /admin/drain`` (403 without the token,
  reversible with it), SIGTERM mid-decode (the in-flight completion is
  returned in full with the greedy ids of an undisturbed run, new work gets
  503, the process exits 0);
- deadlines: 504 naming the phase, the row retired and its blocks freed;
  SD ``queued`` vs ``denoise``; graph queued deadlines published in
  ``/history``;
- backpressure: 429 with ``Retry-After`` past ``TPUSTACK_MAX_QUEUE_DEPTH``;
- the watchdog flipping ``/healthz`` on an injected dispatch hang, and a
  transient device error answered 503 then recovered from.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpustack.obs.metrics import Registry as JaxRegistry
from tpustack.serving.resilience import FaultInjector as JaxFaultInjector
from tpustack.serving.resilience import ResilienceManager as JaxManager
from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llm_generate import Generator, resolve_paged_flash
from tpustack_torch.models.text_tokenizer import ByteTokenizer
from tpustack_torch.obs import Registry, Tracer
from tpustack_torch.serving import graph_server as gs
from tpustack_torch.serving.llm_server import LLMServer, build_paged
from tpustack_torch.serving.resilience import (DRAINED, DRAINING, SHED_REASONS, FaultInjector,
                                               InjectedDeviceError, ResilienceManager,
                                               shed_headers)
from tpustack_torch.serving.sd_server import SDServer
from tpustack_torch.serving.speculative import SpecConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    for k in list(os.environ):
        if k.startswith("TPUSTACK_FAULT_") or k in (
                "TPUSTACK_DRAIN_TIMEOUT_S", "TPUSTACK_DRAIN_LINGER_S",
                "TPUSTACK_REQUEST_TIMEOUT_S", "TPUSTACK_MAX_QUEUE_DEPTH",
                "TPUSTACK_WATCHDOG_S", "TPUSTACK_ADMIN_TOKEN", "TPUSTACK_PAGED_FLASH"):
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TPUSTACK_FLIGHT_DUMP_DIR", str(tmp_path / "flight"))


def _wait(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _call(url, body=None, headers=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, dict(r.headers), (json.loads(raw) if raw[:1] in (b"{", b"[")
                                               else raw)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


# ===================================================== the manager, vs JAX
def test_fault_injector_matches_the_jax_one():
    env = {"TPUSTACK_FAULT_DEVICE_ERROR_NTH": "2", "TPUSTACK_FAULT_SIGTERM_AFTER": "3"}
    seqs = []
    for inj, err in ((FaultInjector(env=env), InjectedDeviceError),
                     (JaxFaultInjector(env=env), Exception)):
        fired, trail = [], []
        inj.sigterm_cb = lambda fired=fired: fired.append(True)
        for point in ("prefill", "prefill", "prefill", "wave", "wave", "wave", "wave"):
            try:
                inj.point(point)
                trail.append((point, "ok", len(fired)))
            except err as e:
                trail.append((point, type(e).__name__, len(fired)))
        seqs.append(trail)
    assert seqs[0] == seqs[1]
    assert seqs[0][1][1] == "InjectedDeviceError" and seqs[0][5][2] == 1
    assert not FaultInjector(env={}).active
    with pytest.raises(ValueError, match="TPUSTACK_FAULT_DEVICE_ERROR_NTH"):
        FaultInjector(env={"TPUSTACK_FAULT_DEVICE_ERROR_NTH": "soon"})


@pytest.mark.parametrize("times,depth,conc", [((), 7, 4), ((2.0, 4.0, 6.0), 7, 4),
                                              ((0.3,), 0, 1), ((90.0, 200.0), 63, 2)])
def test_retry_after_math_matches_the_jax_manager(times, depth, conc):
    port = ResilienceManager("llm", Registry(), concurrency=conc, queue_depth=lambda: depth)
    ref = JaxManager("llm", JaxRegistry(), concurrency=conc, queue_depth=lambda: depth)
    try:
        for t in times:
            port.observe_service_time(t)
            ref.observe_service_time(t)
        assert port.retry_after_s() == ref.retry_after_s()
        assert (port.drain_timeout_s, port.request_timeout_s, port.max_queue_depth,
                port.watchdog_s) == (ref.drain_timeout_s, ref.request_timeout_s,
                                     ref.max_queue_depth, ref.watchdog_s)
        for override in (None, 2.5, 0, "3"):
            assert port.deadline(override) == ref.deadline(override)
        assert port.health_payload()[1].keys() == ref.health_payload()[1].keys()
    finally:
        port.close()
        ref.close()


def test_shed_headers_and_reasons():
    assert shed_headers("draining", 3) == {"X-Shed-Reason": "draining", "Retry-After": "3"}
    assert "queue_depth" in SHED_REASONS and "out_of_kv_blocks" in SHED_REASONS
    with pytest.raises(AssertionError):
        shed_headers("made_up")


def test_drain_state_machine_and_admin_drain(monkeypatch):
    monkeypatch.setenv("TPUSTACK_DRAIN_TIMEOUT_S", "2")
    reg, exits = Registry(), []
    mgr = ResilienceManager("llm", reg, on_exit=exits.append)
    try:
        assert mgr.state_name == "serving" and mgr.ready_payload()[0] == 200
        assert mgr.admin_drain() and not mgr.admin_drain()  # idempotent
        assert mgr.draining and mgr.state_name == "draining"
        assert mgr.ready_payload()[0] == 503
        assert mgr.ready_headers(503)["X-Shed-Reason"] == "draining"
        assert mgr.admission_check()[0] == 503
        assert reg.get_sample_value("tpustack_serving_drain_state", {"server": "llm"}) == \
            DRAINING
        assert mgr.admin_undrain() and mgr.ready_payload()[0] == 200
        assert mgr.admission_check() is None
        mgr.begin_drain()
        mgr.begin_drain()  # one-way and idempotent
        assert mgr.ready_payload()[0] == 503 and mgr.health_payload()[0] == 200
        assert _wait(lambda: exits)
        assert exits == [0] and mgr.state == DRAINED
        assert not mgr.admin_undrain() or mgr.draining  # a signal drain stays
    finally:
        mgr.close()


def test_watchdog_flips_liveness_on_a_stall(monkeypatch):
    monkeypatch.setenv("TPUSTACK_WATCHDOG_S", "0.15")
    reg = Registry()
    mgr = ResilienceManager("sd", reg, extra_busy=lambda: True)
    try:
        assert mgr.health_payload()[0] == 200
        assert _wait(lambda: mgr.hung, 5)
        assert mgr.health_payload()[0] == 503 and mgr.ready_payload()[0] == 503
        assert mgr.health_headers(503) == {"X-Shed-Reason": "watchdog"}
        mgr.beat()  # latched: kubernetes owns the restart
        assert mgr.health_payload()[0] == 503
        assert reg.get_sample_value("tpustack_watchdog_stalls_total", {"server": "sd"}) == 1
    finally:
        mgr.close()


# ================================================================= LLM
@pytest.fixture(scope="module")
def gen():
    return Generator(LlamaConfig.tiny(max_seq=128), dtype=torch.float32, device="cpu")


def _llm(gen, **kw):
    srv = LLMServer(gen, ByteTokenizer(512), max_batch=4, paged=build_paged(gen, 4),
                    spec=kw.pop("spec", SpecConfig(tokens=4)), registry=Registry(),
                    tracer=Tracer(), **kw)
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    return srv


def _pool_whole(srv):
    assert _wait(lambda: srv._engine is None and not srv._queue)
    if srv.paged.cache is not None:
        srv.paged.cache.clear()
    return srv.paged.pool.n_free == srv.paged.pool.capacity_blocks


def test_llm_healthz_readyz_and_backpressure(gen):
    srv = _llm(gen)
    try:
        st, _, j = _call(srv.url + "/healthz")
        assert st == 200 and j["ok"] is True and j["state"] == "serving"
        assert j["engine"]["slots"] == 4 and j["watchdog"]["enabled"] is False
        assert {"inflight", "queue_depth"} <= set(j)
        assert _call(srv.url + "/readyz")[0] == 200
        srv.resilience._queue_depth = lambda: 99
        st, hd, _ = _call(srv.url + "/completion", {"prompt": "x"})
        assert st == 429 and int(hd["Retry-After"]) >= 1 and hd["X-Shed-Reason"] == "queue_depth"
        assert _call(srv.url + "/tokenize", {"content": "hi"})[0] == 200  # not gated
        srv.resilience._queue_depth = lambda: len(srv._queue)
        assert _call(srv.url + "/completion", {"prompt": "x", "n_predict": 2,
                                               "temperature": 0})[0] == 200
        assert srv._registry.get_sample_value("tpustack_requests_shed_total", {
            "server": "llm", "reason": "backpressure"}) == 1
    finally:
        srv.stop()


def test_llm_deadline_504_frees_its_slot_and_blocks(gen, monkeypatch):
    ref_srv = _llm(gen)
    try:
        ref = _call(ref_srv.url + "/completion", {"prompt": "hello again", "n_predict": 6,
                                                  "temperature": 0})[2]["content"]
    finally:
        ref_srv.stop()
    monkeypatch.setenv("TPUSTACK_FAULT_SLOW_PREFILL_S", "0.4")  # every dispatch slow
    srv = _llm(gen)
    try:
        st, hd, j = _call(srv.url + "/completion", {"prompt": "deadline me", "n_predict": 40,
                                                    "temperature": 0, "timeout_s": 0.05})
        assert st == 504 and j["phase"] in ("queued", "decode") and "deadline" in j["error"]
        assert hd["X-Shed-Reason"] == "deadline"
        assert _pool_whole(srv)
        st, _, j2 = _call(srv.url + "/completion", {"prompt": "hello again", "n_predict": 6,
                                                    "temperature": 0})
        assert st == 200 and j2["content"] == ref
        assert srv._registry.get_sample_value("tpustack_deadline_exceeded_total", {
            "server": "llm", "phase": j["phase"]}) == 1
        assert _pool_whole(srv)
    finally:
        srv.stop()


def test_llm_deadline_mid_decode_retires_the_row(gen):
    srv = _llm(gen, spec=None)
    srv.engine_chunk = 1  # many chunk boundaries
    try:
        st, _, j = _call(srv.url + "/completion", {"prompt": "long one", "n_predict": 110,
                                                   "temperature": 0, "timeout_s": 0.06})
        assert st == 504 and j["phase"] in ("queued", "decode")
        assert _pool_whole(srv)
        runs = list(srv.run_log)
        if j["phase"] == "decode":
            assert runs and runs[-1]["generated_tokens"] < 110  # retired early
    finally:
        srv.stop()


def test_llm_transient_device_error_503_then_recovers(gen, monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_DEVICE_ERROR_NTH", "1")
    srv = _llm(gen)
    try:
        st, hd, j = _call(srv.url + "/completion", {"prompt": "boom", "n_predict": 4,
                                                    "temperature": 0})
        assert st == 503 and "Retry-After" in hd and "transient" in j["error"]
        assert hd["X-Shed-Reason"] == "device_error"
        assert _pool_whole(srv)
        assert _call(srv.url + "/completion", {"prompt": "boom", "n_predict": 4,
                                               "temperature": 0})[0] == 200
        assert srv._registry.get_sample_value("tpustack_faults_injected_total", {
            "server": "llm", "kind": "device_error"}) == 1
    finally:
        srv.stop()


def test_llm_watchdog_flips_healthz_on_an_injected_hang(gen, monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_HANG_NTH", "1")
    monkeypatch.setenv("TPUSTACK_FAULT_HANG_S", "1.0")
    monkeypatch.setenv("TPUSTACK_WATCHDOG_S", "0.2")
    srv = _llm(gen)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=_call(
        srv.url + "/completion", {"prompt": "hang", "n_predict": 2, "temperature": 0})))
    try:
        t.start()
        assert _wait(lambda: _call(srv.url + "/healthz")[0] == 503, 5)
        st, hd, j = _call(srv.url + "/healthz")
        assert j["hung"] is True and hd["X-Shed-Reason"] == "watchdog"
        t.join(timeout=30)
        assert not t.is_alive() and out["r"][0] == 200  # the hang ends, the request completes
        assert srv._registry.get_sample_value("tpustack_watchdog_stalls_total",
                                              {"server": "llm"}) == 1
    finally:
        srv.stop()


def test_llm_admin_drain_needs_the_token_and_reverses(gen, monkeypatch):
    srv = _llm(gen)
    try:
        assert _call(srv.url + "/admin/drain", {})[0] == 403  # knob unset: surface off
        monkeypatch.setenv("TPUSTACK_ADMIN_TOKEN", "s3cret")
        assert _call(srv.url + "/admin/drain", {}, {"X-Admin-Token": "wrong"})[0] == 403
        st, _, j = _call(srv.url + "/admin/drain", {}, {"X-Admin-Token": "s3cret"})
        assert st == 200 and j["action"] == "drain" and j["draining"] and j["readyz_status"] == 503
        st, hd, _ = _call(srv.url + "/readyz")
        assert st == 503 and hd["X-Shed-Reason"] == "draining"
        st, hd, _ = _call(srv.url + "/completion", {"prompt": "late", "n_predict": 2})
        assert st == 503 and int(hd["Retry-After"]) >= 1
        assert _call(srv.url + "/healthz")[0] == 200  # live while draining
        st, _, j = _call(srv.url + "/admin/drain", {"undrain": True},
                         {"X-Admin-Token": "s3cret"})
        assert st == 200 and j["changed"] and not j["draining"]
        assert _call(srv.url + "/readyz")[0] == 200
        assert _call(srv.url + "/completion", {"prompt": "back", "n_predict": 2,
                                               "temperature": 0})[0] == 200
    finally:
        srv.stop()


def test_llm_injected_sigterm_mid_decode_drains_clean(gen, monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_SIGTERM_AFTER", "2")
    monkeypatch.setenv("TPUSTACK_DRAIN_TIMEOUT_S", "5")
    ref_srv = _llm(gen, spec=None)
    try:
        ref = _call(ref_srv.url + "/completion", {"prompt": "drain me", "n_predict": 12,
                                                  "temperature": 0})[2]["content"]
    finally:
        ref_srv.stop()
    srv = _llm(gen, spec=None)
    srv.engine_chunk = 2  # wave 2 lands mid-decode
    exits = []
    srv.resilience.on_exit = exits.append
    try:
        st, _, j = _call(srv.url + "/completion", {"prompt": "drain me", "n_predict": 12,
                                                   "temperature": 0})
        assert st == 200 and j["content"] == ref and srv.resilience.draining
        st, hd, _ = _call(srv.url + "/completion", {"prompt": "late", "n_predict": 2})
        assert st == 503 and "Retry-After" in hd
        assert _call(srv.url + "/readyz")[0] == 503
        assert _wait(lambda: exits)
        assert exits == [0]
        reg = srv._registry
        assert reg.get_sample_value("tpustack_serving_drain_state", {"server": "llm"}) == DRAINED
        assert reg.get_sample_value("tpustack_requests_shed_total",
                                    {"server": "llm", "reason": "draining"}) == 1
    finally:
        srv.stop()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_llm_real_sigterm_mid_stream_drains_clean_and_exits_0(tmp_path):
    """A real SIGTERM to ``python -m tpustack_torch.serving.llm_server``
    while a streamed completion decodes: the stream ends in full with the
    greedy ids of the undisturbed run before it, new work gets 503, and the
    process exits 0."""
    port = _free_port()
    env = dict(os.environ, LLM_PRESET="tiny", LLM_DEVICE="cpu", PORT=str(port),
               LLM_ENGINE_CHUNK="1", TPUSTACK_SPEC_TOKENS="0", TPUSTACK_DRAIN_TIMEOUT_S="30",
               TPUSTACK_FLIGHT_DUMP_DIR=str(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-m", "tpustack_torch.serving.llm_server"],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        assert _wait(lambda: proc.poll() is None and _ready(url), 90), "server never ready"
        body = {"prompt": "sigterm drill", "n_predict": 60, "temperature": 0,
                "cache_prompt": False}
        ref = _call(url + "/completion", body)[2]["content"]
        req = urllib.request.Request(url + "/completion", data=json.dumps(
            dict(body, stream=True)).encode(), headers={"Content-Type": "application/json"})
        events = []
        with urllib.request.urlopen(req, timeout=60) as r:
            lines = iter(r)
            for line in lines:  # the first token is out: the row decodes
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
                    break
            proc.send_signal(signal.SIGTERM)
            assert _wait(lambda: _call(url + "/readyz")[0] == 503, 10)
            late = _call(url + "/completion", {"prompt": "late", "n_predict": 2})
            for line in lines:
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
        assert late[0] == 503 and "Retry-After" in late[1]
        assert events[-1]["stop"] is True and events[-1]["tokens_predicted"] >= 1
        assert "".join(e["content"] for e in events) == ref
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


def _ready(url):
    try:
        return _call(url + "/readyz", timeout=2)[0] == 200
    except OSError:
        return False


# ---------------------------------------------------------- C2: the verdict
def test_paged_kernel_verdict_holds_only_inside_its_contract(gen, monkeypatch):
    cuda = torch.device("cuda")  # a verdict, no card needed
    qwen = LlamaConfig.qwen25_7b()
    bf16 = torch.bfloat16
    # the smoke's configuration: blk 64, k = 4, group 7 -> R = 35 rows
    assert resolve_paged_flash(cuda, qwen, bf16, 64, 4, 8) is True
    for why, args in (("blk", (qwen, bf16, 8, 4, 8)),       # LLM_CTX=1000 -> blk 8
                      ("query rows", (qwen, bf16, 64, 9, 8)),  # k=9: 7 x 10 = 70 > 64
                      ("bf16", (gen.cfg, torch.float32, 16, 4, 8))):  # LLM_PRESET=tiny
        assert resolve_paged_flash(cuda, *args) is False  # auto declines
        monkeypatch.setenv("TPUSTACK_PAGED_FLASH", "1")
        with pytest.raises(ValueError, match=why):
            resolve_paged_flash(cuda, *args)
        monkeypatch.setenv("TPUSTACK_PAGED_FLASH", "0")
        assert resolve_paged_flash(cuda, *args) is False
        monkeypatch.delenv("TPUSTACK_PAGED_FLASH")
    assert resolve_paged_flash(torch.device("cpu"), qwen, bf16, 64, 4, 8) is False
    monkeypatch.setenv("TPUSTACK_PAGED_FLASH", "1")  # on the CPU: the twin, any geometry
    assert resolve_paged_flash(torch.device("cpu"), gen.cfg, torch.float32, 8, 9, 8) is True
    monkeypatch.setenv("TPUSTACK_PAGED_FLASH", "maybe")
    with pytest.raises(ValueError, match="maybe"):
        resolve_paged_flash(cuda, qwen, bf16, 64, 4, 8)


def test_paged_flash_outside_the_contract_fails_at_startup(gen, monkeypatch):
    """``TPUSTACK_PAGED_FLASH=1`` with a float32 model on a card refuses to
    start, naming the condition, before any thread or request."""
    monkeypatch.setenv("TPUSTACK_PAGED_FLASH", "1")
    paged = build_paged(gen, 4)
    device = gen.device
    gen.device = torch.device("cuda")  # the geometry check reads only the device type
    try:
        with pytest.raises(ValueError, match="bf16"):
            LLMServer(gen, ByteTokenizer(512), max_batch=4, paged=paged, spec=None,
                      registry=Registry())
    finally:
        gen.device = device
    monkeypatch.delenv("TPUSTACK_PAGED_FLASH")
    srv = LLMServer(gen, ByteTokenizer(512), max_batch=4, paged=paged, spec=None,
                    registry=Registry())
    try:
        assert srv.decode_kernel == "gather"  # auto on the CPU
    finally:
        srv.stop()


# ================================================================== SD
class _StubSDPipe:
    """The SD server's pipeline contract; ``generate`` blocks until released."""

    device = "cpu"

    def __init__(self):
        self.release = threading.Event()
        self.calls = 0

    def check_request(self, steps, width, height):
        pass

    def generate(self, prompts, *, steps, guidance_scale, seed, width, height,
                 negative_prompt):
        self.calls += 1
        assert self.release.wait(timeout=20)
        return [np.zeros((height, width, 3), np.uint8) for _ in prompts], 0.01


def _sd(pipe, **kw):
    kw.setdefault("batch_window_ms", 1)
    kw.setdefault("max_batch", 1)
    srv = SDServer(pipe, registry=Registry(), tracer=Tracer(), **kw)
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    return srv


GEN = {"prompt": "p", "steps": 2, "width": 32, "height": 32}


def test_sd_readyz_healthz_metrics():
    pipe = _StubSDPipe()
    pipe.release.set()
    srv = _sd(pipe)
    try:
        st, _, j = _call(srv.url + "/healthz")
        assert st == 200 and j["ok"] and j["state"] == "serving" and j["max_batch"] == 1
        assert _call(srv.url + "/readyz")[0] == 200
        assert _call(srv.url + "/generate", GEN)[0] == 200
        text = _call(srv.url + "/metrics")[2].decode()
        assert 'tpustack_http_requests_total{server="sd",endpoint="/generate",status="200"} 1' \
            in text
        assert "tpustack_sd_images_total 1" in text
    finally:
        srv.stop()


def test_sd_deadline_queued_vs_denoise_phase():
    pipe = _StubSDPipe()
    srv = _sd(pipe, batch_window_ms=300, max_batch=2)  # a lone request waits its window
    try:
        st, hd, j = _call(srv.url + "/generate", dict(GEN, timeout_s=0.05))
        assert st == 504 and j["phase"] == "queued" and hd["X-Shed-Reason"] == "deadline"
        time.sleep(0.4)  # the window ends on an empty group: no dispatch at all
        assert pipe.calls == 0
        srv.batch_window_s = 0.001  # dispatched, then the deadline: denoise
        st, _, j = _call(srv.url + "/generate", dict(GEN, timeout_s=0.2))
        assert st == 504 and j["phase"] == "denoise"
        assert _call(srv.url + "/generate", dict(GEN, timeout_s="soon"))[0] == 422
    finally:
        pipe.release.set()
        srv.stop()
    reg = srv._registry
    for phase in ("queued", "denoise"):
        assert reg.get_sample_value("tpustack_deadline_exceeded_total",
                                    {"server": "sd", "phase": phase}) == 1


def test_sd_backpressure_429_with_retry_after(monkeypatch):
    monkeypatch.setenv("TPUSTACK_MAX_QUEUE_DEPTH", "2")
    pipe = _StubSDPipe()
    srv = _sd(pipe)  # max_batch 1: capacity 1
    out = []
    threads = [threading.Thread(target=lambda: out.append(_call(srv.url + "/generate", GEN)))
               for _ in range(3)]
    try:
        for t in threads:
            t.start()
        assert _wait(lambda: srv.resilience.inflight == 3)
        st, hd, _ = _call(srv.url + "/generate", GEN)  # depth 3 - 1 = 2: shed
        assert st == 429 and int(hd["Retry-After"]) >= 1
        pipe.release.set()
        for t in threads:
            t.join(timeout=30)
        assert sorted(r[0] for r in out) == [200, 200, 200]
    finally:
        pipe.release.set()
        srv.stop()
    assert srv._registry.get_sample_value("tpustack_requests_shed_total", {
        "server": "sd", "reason": "backpressure"}) == 1


def test_sd_sigterm_mid_batch_drains_clean(monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_SIGTERM_AFTER", "1")
    monkeypatch.setenv("TPUSTACK_DRAIN_TIMEOUT_S", "5")
    pipe = _StubSDPipe()  # release stays unset until both requests are admitted
    srv = _sd(pipe)
    exits = []
    srv.resilience.on_exit = exits.append
    out = []
    bodies = [GEN, dict(GEN, prompt="b", width=64, height=64)]  # two batches
    threads = [threading.Thread(target=lambda b=b: out.append(_call(srv.url + "/generate", b)))
               for b in bodies]
    try:
        for t in threads:
            t.start()
        # the first batch is inside generate and the second request is
        # admitted: only then may the first batch finish and start the drain
        assert _wait(lambda: pipe.calls == 1 and srv.resilience.inflight == 2)
        pipe.release.set()
        for t in threads:
            t.join(timeout=30)
        assert [r[0] for r in out] == [200, 200] and srv.resilience.draining
        st, hd, _ = _call(srv.url + "/generate", GEN)
        assert st == 503 and "Retry-After" in hd
        assert _call(srv.url + "/readyz")[0] == 503 and _call(srv.url + "/healthz")[0] == 200
        assert _wait(lambda: exits)
        assert exits == [0]
    finally:
        pipe.release.set()
        srv.stop()
    assert srv._registry.get_sample_value("tpustack_serving_drain_state",
                                          {"server": "sd"}) == DRAINED


def test_sd_transient_device_error_503(monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_DEVICE_ERROR_NTH", "1")
    pipe = _StubSDPipe()
    pipe.release.set()
    srv = _sd(pipe)
    try:
        st, hd, j = _call(srv.url + "/generate", GEN)
        assert st == 503 and hd["X-Shed-Reason"] == "device_error"
        assert _call(srv.url + "/generate", GEN)[0] == 200
    finally:
        srv.stop()


# ================================================================ graph
class _FakeWanPipe:
    """The graph worker's pipeline contract, no device work."""

    last_run = {"text_s": 0.0, "denoise_s": 0.0, "decode_s": 0.0}

    def pixel_frame_count(self, frames):
        return frames

    def is_warm(self, **kw):
        return True

    def generate_many_async(self, items, *, frames, steps, guidance_scale, width, height,
                            sampler):
        return np.zeros((len(items), frames, height, width, 3), np.uint8)


def _graph_server(tmp_path):
    rt = gs.WanRuntime(models_dir=str(tmp_path / "m"), output_dir=str(tmp_path / "o"),
                       pipeline=_FakeWanPipe())
    srv = gs.GraphServer(runtime=rt, registry=Registry(), tracer=Tracer())
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    return srv


def _save_graph(prompt="a panda", seed=3):
    return {
        "pos": {"class_type": "CLIPTextEncode", "inputs": {"text": prompt}},
        "neg": {"class_type": "CLIPTextEncode", "inputs": {"text": "bad"}},
        "latent": {"class_type": "EmptyHunyuanLatentVideo",
                   "inputs": {"width": 32, "height": 32, "length": 5, "batch_size": 1}},
        "sample": {"class_type": "KSampler",
                   "inputs": {"positive": ["pos", 0], "negative": ["neg", 0],
                              "latent_image": ["latent", 0], "seed": seed, "steps": 1,
                              "cfg": 6.0, "sampler_name": "uni_pc", "denoise": 1.0}},
        "decode": {"class_type": "VAEDecode", "inputs": {"samples": ["sample", 0]}},
        "save": {"class_type": "SaveImage",
                 "inputs": {"images": ["decode", 0], "filename_prefix": "res"}},
    }


def _history(srv, pid, timeout=10.0):
    out = {}

    def done():
        h = _call(f"{srv.url}/history/{pid}")[2]
        out.update(h)
        return pid in h and h[pid]["status"]["completed"]

    assert _wait(done, timeout), f"prompt {pid} never completed"
    return out[pid]


def test_graph_sigterm_drains_and_publishes_every_accepted_prompt(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_SIGTERM_AFTER", "1")
    monkeypatch.setenv("TPUSTACK_DRAIN_TIMEOUT_S", "5")
    srv = _graph_server(tmp_path)
    exits = []
    srv.resilience.on_exit = exits.append
    try:
        pids = []
        with srv.hold():  # both accepted before the first dispatch
            for i in range(2):
                st, _, j = _call(srv.url + "/prompt", {"prompt": _save_graph(seed=i),
                                                       "client_id": "t"})
                assert st == 200
                pids.append(j["prompt_id"])
        for pid in pids:
            entry = _history(srv, pid)
            assert entry["status"]["status_str"] == "success" and entry["outputs"], entry
        assert _wait(lambda: srv.resilience.draining)
        st, hd, _ = _call(srv.url + "/prompt", {"prompt": _save_graph(), "client_id": "t"})
        assert st == 503 and "Retry-After" in hd
        assert _call(srv.url + "/readyz")[0] == 503
        assert _wait(lambda: exits)
        assert exits == [0]
    finally:
        srv.shutdown()
    reg = srv._registry
    assert reg.get_sample_value("tpustack_serving_drain_state", {"server": "graph"}) == DRAINED
    assert reg.get_sample_value("tpustack_graph_prompts_total", {"status": "success"}) == 2


def test_graph_queued_deadline_lands_in_history(tmp_path):
    srv = _graph_server(tmp_path)
    try:
        with srv.hold():  # the worker takes nothing until the deadline has passed
            st, _, j = _call(srv.url + "/prompt", {"prompt": _save_graph(), "client_id": "t",
                                                   "timeout_s": 0.01})
            assert st == 200
            time.sleep(0.1)
        entry = _history(srv, j["prompt_id"])
        assert entry["status"]["status_str"] == "error"
        assert any("DeadlineExceeded" in m and "queued" in m
                   for m in entry["status"]["messages"]), entry
        st, _, _ = _call(srv.url + "/prompt", {"prompt": _save_graph(), "timeout_s": "x"})
        assert st == 400
    finally:
        srv.shutdown()
    reg = srv._registry
    assert reg.get_sample_value("tpustack_deadline_exceeded_total",
                                {"server": "graph", "phase": "queued"}) == 1
    assert reg.get_sample_value("tpustack_graph_prompts_total", {"status": "rejected"}) == 1


def test_graph_backpressure_429_and_probes(tmp_path):
    srv = _graph_server(tmp_path)
    try:
        st, _, j = _call(srv.url + "/healthz")
        assert st == 200 and j["worker_alive"] and j["state"] == "serving"
        assert _call(srv.url + "/readyz")[0] == 200
        srv.resilience._queue_depth = lambda: 99
        st, hd, _ = _call(srv.url + "/prompt", {"prompt": _save_graph(), "client_id": "t"})
        assert st == 429 and "Retry-After" in hd
        assert _call(srv.url + "/queue")[0] == 200  # reads stay open
        srv.resilience._queue_depth = srv._queue.qsize
        st, _, j = _call(srv.url + "/prompt", {"prompt": _save_graph(), "client_id": "t"})
        assert st == 200 and _history(srv, j["prompt_id"])["status"]["status_str"] == "success"
        text = _call(srv.url + "/metrics")[2].decode()
        assert '{server="graph",endpoint="/prompt",status="200"} 1' in text
        assert 'endpoint="/history/{prompt_id}"' in text
    finally:
        srv.shutdown()


def test_graph_transient_device_error_fails_its_prompt_and_the_worker_lives(tmp_path,
                                                                             monkeypatch):
    monkeypatch.setenv("TPUSTACK_FAULT_DEVICE_ERROR_NTH", "1")
    srv = _graph_server(tmp_path)
    try:
        pid = _call(srv.url + "/prompt", {"prompt": _save_graph(), "client_id": "t"})[2]
        entry = _history(srv, pid["prompt_id"])
        assert entry["status"]["status_str"] == "error"
        assert any("transient device error" in m for m in entry["status"]["messages"]), entry
        pid = _call(srv.url + "/prompt", {"prompt": _save_graph(), "client_id": "t"})[2]
        assert _history(srv, pid["prompt_id"])["status"]["status_str"] == "success"
        assert _call(srv.url + "/healthz")[2]["worker_alive"] is True
    finally:
        srv.shutdown()
