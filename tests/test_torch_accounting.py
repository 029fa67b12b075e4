"""Tenant accounting in the port (``tpustack_torch.obs.accounting`` and the
three servers' wiring) against the JAX package's, on the CPU.

- ``sanitize_tenant``, ``resolve_tenant`` and ``outcome_from_status`` give
  the JAX functions' answers, and the same charges give the JAX ledger's
  snapshot.
- The cardinality bound: 1000 minted tenants leave at most ``cardinality +
  1`` label values on every tenant-labelled family, ``other`` holding the
  tail; concurrent charges from many threads conserve every total.
- The engine's chip-seconds are charged from its flight records: per-tenant
  chip-seconds sum to the billed waves' wall time, and the flight
  recorder's ``tenant_chip_seconds`` rollup equals the ledger.
- Over HTTP, on all three servers: the tenant comes from ``X-Tenant-Id``,
  else the work body's ``tenant``, else ``TPUSTACK_TENANT_DEFAULT``; the
  root span carries it; ``/debug/tenants`` serves the accounts; and with a
  QoS policy batch requests are shed before interactive ones.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpustack.obs import accounting as jax_accounting
from tpustack.obs.metrics import Registry as JaxRegistry
from tpustack_torch.models.llama import LlamaConfig, init_kv_pool
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.models.text_tokenizer import ByteTokenizer
from tpustack_torch.obs import Registry, Tracer, accounting
from tpustack_torch.obs import flight as obs_flight
from tpustack_torch.serving import graph_server as gs
from tpustack_torch.serving import kv_pool
from tpustack_torch.serving.llm_server import LLMServer, build_paged
from tpustack_torch.serving.sd_server import SDServer


@pytest.mark.parametrize("raw", ["  alice ", "b@d id!", "x" * 200, "", 7, None, "other",
                                 "team.a-1"])
def test_sanitize_and_resolve_equal_jax(raw):
    assert accounting.sanitize_tenant(raw) == jax_accounting.sanitize_tenant(raw)
    for header, body in ((raw, {"tenant": "body"}), (None, {"tenant": raw}), (None, None)):
        assert (accounting.resolve_tenant(header, body)
                == jax_accounting.resolve_tenant(header, body))


@pytest.mark.parametrize("status", [200, 302, 400, 404, 429, 500, 503, 504])
def test_outcome_from_status_equals_jax(status):
    assert accounting.outcome_from_status(status) == jax_accounting.outcome_from_status(status)


def _charge_all(led):
    led.charge_tokens("llm", "a", prompt=10, generated=5)
    led.charge_chip_seconds("llm", "a", 0.5)
    led.charge_kv_block_seconds("a", 2.0)
    led.charge_queue_seconds("sd", "a", 0.25)
    led.charge_flight_wave("llm", {"wave_s": 0.8, "tenants": {"a": 3, "b": 1}})
    led.charge_flight_wave("llm", {"wave_s": None, "tenants": {"a": 1}})  # first wave
    led.charge_flight_wave("sd", {"denoise_vae_s": 0.4, "tenants": {"b": 2}},
                           seconds_key="denoise_vae_s")
    for outcome in ("ok", "shed", "client_error"):
        led.note_outcome("llm", "a", outcome)
    led.note_outcome("graph", "b", "deadline")


def test_ledger_snapshot_equals_jax():
    led = accounting.TenantLedger(Registry(), cardinality=8)
    ref = jax_accounting.TenantLedger(JaxRegistry(), cardinality=8)
    _charge_all(led)
    _charge_all(ref)
    assert led.snapshot() == ref.snapshot()
    a = led.snapshot()["tenants"]["a"]
    assert a["chip_seconds"] == pytest.approx(0.5 + 0.6)
    assert a["goodput_ratio"] == pytest.approx(0.5)  # client_error is not in the ratio


def _tenant_label_values(reg):
    out = {}
    for line in reg.render().splitlines():
        if line.startswith("#") or "tenant=" not in line:
            continue
        out.setdefault(line.split("{", 1)[0], set()).add(
            re.search(r'tenant="([^"]*)"', line).group(1))
    return out


def test_cardinality_bound_under_tenant_flood():
    reg = Registry()
    led = accounting.TenantLedger(reg, cardinality=16)
    for i in range(1000):
        t = f"tenant-{i:04d}"
        led.charge_tokens("llm", t, prompt=1, generated=1)
        led.charge_chip_seconds("llm", t, 0.001)
        led.charge_kv_block_seconds(t, 0.001)
        led.charge_queue_seconds("llm", t, 0.001)
        led.note_outcome("llm", t, "ok")
    families = _tenant_label_values(reg)
    assert set(families) >= {
        "tpustack_tenant_prompt_tokens_total", "tpustack_tenant_generated_tokens_total",
        "tpustack_tenant_chip_seconds_total", "tpustack_tenant_kv_block_seconds_total",
        "tpustack_tenant_queue_seconds_total", "tpustack_tenant_requests_total",
        "tpustack_tenant_goodput_ratio"}
    for name, values in families.items():
        assert len(values) <= 17 and "other" in values, (name, len(values))
    snap = led.snapshot()
    assert snap["tracked_tenants"] <= 17 and snap["overflowed_tenants"] == 1000 - 16
    assert snap["tenants"]["other"]["prompt_tokens"] == 1000 - 16


def test_ledger_thread_safety_conserves_totals():
    led = accounting.TenantLedger(Registry(), cardinality=4)

    def worker(tenant):
        for _ in range(500):
            led.charge_tokens("llm", tenant, prompt=1, generated=2)
            led.charge_chip_seconds("llm", tenant, 0.001)
            led.note_outcome("llm", tenant, "ok")

    threads = [threading.Thread(target=worker, args=(f"t{i}",)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = led.snapshot()["tenants"]
    assert sum(t["prompt_tokens"] for t in snap.values()) == 3000
    assert sum(t["generated_tokens"] for t in snap.values()) == 6000
    assert sum(sum(t["outcomes"].values()) for t in snap.values()) == 3000
    assert sum(t["chip_seconds"] for t in snap.values()) == pytest.approx(3.0, rel=1e-6)


@pytest.fixture(scope="module")
def tiny():
    return Generator(LlamaConfig.tiny(max_seq=128), dtype=torch.float32, device="cpu")


def test_engine_chip_seconds_conservation(tiny):
    """Staggered budgets: requests retire in different waves, so final waves
    carry a mix of tenants and a request's last wave must still bill it."""
    led = accounting.TenantLedger(Registry(), cardinality=8)
    rec = obs_flight.FlightRecorder("conservation", capacity=512)
    pool = kv_pool.KVBlockPool(65, 8)
    rt = kv_pool.PagedKVRuntime(init_kv_pool(tiny.cfg, 65, 8, torch.float32, "cpu"), pool,
                                tiny.cfg.max_seq)
    engine = ContinuousEngine(tiny, rt, slots=4, chunk=4, flight=rec, ledger=led)
    reqs = [SlotRequest(ids=[5 + i] * (6 + i), max_new=8 + 7 * i,
                        sample=SampleConfig(greedy=True),
                        tenant="interactive" if i % 3 else "batch") for i in range(7)]
    it = iter(reqs)
    engine.run(lambda: next(it, None))
    waves = [r for r in rec.recent() if r["kind"] in ("wave", "verify")]
    for r in waves:
        if r["occupancy"]:
            assert sum(r["tenants"].values()) == r["occupancy"], r
    billed = [r for r in waves if r.get("wave_s") and r.get("tenants")]
    assert len(billed) >= 3
    snap = led.snapshot()["tenants"]
    assert sum(t["chip_seconds"] for t in snap.values()) == pytest.approx(
        sum(r["wave_s"] for r in billed), rel=1e-9)
    assert rec.aggregates()["tenant_chip_seconds"] == pytest.approx(
        {t: v["chip_seconds"] for t, v in snap.items()}, abs=1e-5)
    assert set(snap) == {"interactive", "batch"}
    assert all(t["chip_seconds"] > 0 and t["kv_block_seconds"] > 0 for t in snap.values())
    assert pool.n_free == pool.capacity_blocks


# ------------------------------------------------------------------ HTTP
def _call(url, body=None, headers=None, raw=None, ctype="application/json"):
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers=dict({"Content-Type": ctype}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            out = r.read()
            return r.status, dict(r.headers), (json.loads(out) if out[:1] == b"{" else out)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _wait(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_llm_http_tenant_attribution_and_token_conservation(tiny):
    reg, tracer = Registry(), Tracer()
    srv = LLMServer(tiny, ByteTokenizer(512), max_batch=4, paged=build_paged(tiny, 4),
                    spec=None, registry=reg, tracer=tracer)
    url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    tid = "ab" * 16
    try:
        outs = [
            _call(url + "/completion", {"prompt": "header wins", "n_predict": 6,
                                        "temperature": 0, "tenant": "body"},
                  {"X-Tenant-Id": "acme", "traceparent": f"00-{tid}-{'cd' * 8}-01"}),
            _call(url + "/completion", {"prompt": "from the body", "n_predict": 5,
                                        "temperature": 0, "tenant": "beta"}),
            _call(url + "/completion", {"prompt": "nobody", "n_predict": 4,
                                        "temperature": 0}),
            # a body above the instrumentation's limit is not peeked for its
            # tenant (the handler still serves it: a long prompt is a 400)
            _call(url + "/completion", raw=json.dumps(
                {"prompt": "x" * (1 << 20), "tenant": "huge"}).encode()),
        ]
        assert [o[0] for o in outs] == [200, 200, 200, 400]
        dbg = _call(url + "/debug/tenants")[2]
        flight = _call(url + "/debug/flight")[2]
        trace = _call(url + f"/debug/traces/{tid}")[2]
    finally:
        srv.stop()
    t = dbg["tenants"]
    assert set(t) == {"acme", "beta", "anonymous"}
    for name, (_, _, body) in zip(("acme", "beta", "anonymous"), outs):
        assert t[name]["prompt_tokens"] == body["tokens_evaluated"]
        assert t[name]["generated_tokens"] == body["tokens_predicted"]
        assert t[name]["kv_block_seconds"] > 0 and t[name]["queue_seconds"] >= 0
    assert t["anonymous"]["outcomes"] == {"ok": 1, "client_error": 1}
    assert dbg["qos"]["enabled"]
    root = next(s for s in trace["spans"] if s["name"] == "POST /completion")
    assert root["attrs"]["tenant"] == "acme" and root["attrs"]["priority"] == "interactive"
    chip = flight["aggregates"].get("tenant_chip_seconds", {})
    for name, v in chip.items():
        assert v == pytest.approx(t[name]["chip_seconds"], abs=1e-5)
    assert reg.get_sample_value("tpustack_tenant_prompt_tokens_total",
                                {"server": "llm", "tenant": "beta"}) == outs[1][2][
        "tokens_evaluated"]


# ------------------------------------------------------------ SD + graph
class _StubSDPipe:
    device = "cpu"

    def __init__(self):
        self.release = threading.Event()
        self.calls = 0

    def check_request(self, steps, width, height):
        pass

    def generate(self, prompts, *, steps, guidance_scale, seed, width, height, negative_prompt):
        self.calls += 1
        assert self.release.wait(timeout=20)
        return [np.zeros((height, width, 3), np.uint8) for _ in prompts], 0.01


GEN = {"prompt": "p", "steps": 2, "width": 32, "height": 32}
POLICY = json.dumps({"tenants": {"bulk": {"priority": "batch"}}})


def test_sd_tenant_attribution_and_batch_shed_first(monkeypatch):
    monkeypatch.setenv("TPUSTACK_QOS_POLICY", POLICY)
    monkeypatch.setenv("TPUSTACK_MAX_QUEUE_DEPTH", "4")
    pipe = _StubSDPipe()
    srv = SDServer(pipe, batch_window_ms=1, max_batch=1, registry=Registry(), tracer=Tracer())
    url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    out = []

    def send(body, headers):
        n = srv.resilience.inflight
        t = threading.Thread(target=lambda: out.append(_call(url + "/generate", body, headers)))
        t.start()
        assert _wait(lambda: srv.resilience.inflight == n + 1)
        return t

    try:
        # capacity 1: three admitted make a queue depth of 2, the batch wall
        threads = [send(GEN, {"X-Tenant-Id": "bulk"}), send(dict(GEN, tenant="alice"), {}),
                   send(GEN, {})]
        st, hd, _ = _call(url + "/generate", GEN, {"X-Tenant-Id": "bulk"})
        assert st == 429 and hd["X-Shed-Reason"] == "queue_depth"
        threads.append(send(GEN, {"X-Tenant-Id": "alice"}))  # interactive still admits
        pipe.release.set()
        for t in threads:
            t.join(timeout=30)
        dbg = _call(url + "/debug/tenants")[2]
        batches = [r for r in _call(url + "/debug/flight")[2]["records"] if r["kind"] == "batch"]
    finally:
        pipe.release.set()
        srv.stop()
    assert sorted(o[0] for o in out) == [200] * 4
    t = dbg["tenants"]
    assert t["alice"]["outcomes"] == {"ok": 2}
    assert t["bulk"]["outcomes"] == {"ok": 1, "shed": 1}
    assert t["anonymous"]["outcomes"] == {"ok": 1}
    assert dbg["qos"]["counters"]["shed"] == {"batch": 1}
    assert [r["tenants"] for r in batches] and all(sum(r["tenants"].values()) == r["batch"]
                                                   for r in batches)
    total = sum(v["chip_seconds"] for v in t.values())
    assert total == pytest.approx(sum(r["denoise_vae_s"] for r in batches))


class _FakeWanPipe:
    last_run = {"text_s": 0.0, "denoise_s": 0.0, "decode_s": 0.0}

    def pixel_frame_count(self, frames):
        return frames

    def is_warm(self, **kw):
        return True

    def generate_many_async(self, items, *, frames, steps, guidance_scale, width, height,
                            sampler):
        return np.zeros((len(items), frames, height, width, 3), np.uint8)


def _save_graph(seed=3):
    return {
        "pos": {"class_type": "CLIPTextEncode", "inputs": {"text": "a panda"}},
        "neg": {"class_type": "CLIPTextEncode", "inputs": {"text": "bad"}},
        "lat": {"class_type": "EmptyHunyuanLatentVideo",
                "inputs": {"width": 16, "height": 16, "length": 1, "batch_size": 1}},
        "ks": {"class_type": "KSampler",
               "inputs": {"model": ["unet", 0], "positive": ["pos", 0], "negative": ["neg", 0],
                          "latent_image": ["lat", 0], "seed": seed, "steps": 2, "cfg": 5.0,
                          "sampler_name": "euler", "scheduler": "simple", "denoise": 1.0}},
        "unet": {"class_type": "UNETLoader", "inputs": {"unet_name": gs.CANONICAL_UNET}},
        "vae": {"class_type": "VAELoader", "inputs": {"vae_name": gs.CANONICAL_VAE}},
        "dec": {"class_type": "VAEDecode", "inputs": {"samples": ["ks", 0], "vae": ["vae", 0]}},
        "save": {"class_type": "SaveImage",
                 "inputs": {"images": ["dec", 0], "filename_prefix": "t"}},
    }


def test_graph_tenant_attribution_and_batch_shed_first(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSTACK_QOS_POLICY", POLICY)
    monkeypatch.setenv("TPUSTACK_MAX_QUEUE_DEPTH", "4")
    rt = gs.WanRuntime(models_dir=str(tmp_path / "m"), output_dir=str(tmp_path / "o"),
                       pipeline=_FakeWanPipe())
    srv = gs.GraphServer(runtime=rt, registry=Registry(), tracer=Tracer())
    url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    try:
        pids = []
        with srv.hold():  # accepted, not dispatched: the queue fills
            for i, (tenant, hdr) in enumerate((("alice", {}), (None, {"X-Tenant-Id": "bulk"}),
                                               ("alice", {}))):
                body = {"prompt": _save_graph(seed=i), "client_id": "t"}
                if tenant:
                    body["tenant"] = tenant
                st, _, j = _call(url + "/prompt", body, hdr)
                assert st == 200
                pids.append(j["prompt_id"])
            # depth 3 >= the batch wall (2): bulk sheds, interactive admits
            st, hd, _ = _call(url + "/prompt", {"prompt": _save_graph(), "client_id": "t"},
                              {"X-Tenant-Id": "bulk"})
            assert st == 429 and hd["X-Shed-Reason"] == "queue_depth"
            st, _, j = _call(url + "/prompt", {"prompt": _save_graph(seed=9), "client_id": "t"},
                             {"X-Tenant-Id": "carol"})
            assert st == 200
            pids.append(j["prompt_id"])
        assert _wait(lambda: all(srv._history[p].completed for p in pids), 30)
        dbg = _call(url + "/debug/tenants")[2]
        recs = _call(url + "/debug/flight")[2]["records"]
    finally:
        srv.shutdown()
    t = dbg["tenants"]
    assert t["alice"]["outcomes"] == {"ok": 2} and t["carol"]["outcomes"] == {"ok": 1}
    assert t["bulk"]["outcomes"] == {"ok": 1, "shed": 1}
    assert all(t[n]["queue_seconds"] > 0 and t[n]["chip_seconds"] > 0
               for n in ("alice", "bulk", "carol"))
    dispatch = [r for r in recs if r["kind"] == "dispatch"]
    assert sum(sum(r["tenants"].values()) for r in dispatch) == 4
    assert dbg["qos"]["counters"]["shed"] == {"batch": 1}
