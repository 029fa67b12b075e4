"""Multi-tenant QoS in the port (``tpustack_torch.serving.qos`` and its
integration points) against the JAX package's, on the CPU.

The JAX suite's cases (``tests/test_qos.py``) run against the port's
modules: the debt-tolerant token bucket, priority resolution and the
policy's parsing, the ledger driving the quota buckets, priority- and
quota-aware admission, the interactive-first queue, and the acceptance bar
of wave-boundary preemption: a batch row parked for an interactive one and
resumed through the prefix warm start returns greedy ids equal to an
uninterrupted run of its own and to the JAX engine's ids in the same
scenario (float32, the same flax weights on both sides), with the pool
leak-free.  Over HTTP: the quota 429 carries the tenant's own bucket ETA,
``/debug/tenants`` serves the buckets, and ``TPUSTACK_QOS=0`` serves the
same greedy bytes with ``server.qos is None``.
"""

import json
import math
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
from tpustack.serving import qos as jax_qos
from tpustack_torch.models.llama import LlamaConfig, init_kv_pool
from tpustack_torch.models.llama_weights import params_from_jax
from tpustack_torch.models.llm_continuous import ContinuousEngine, SlotRequest
from tpustack_torch.models.llm_generate import Generator, SampleConfig
from tpustack_torch.models.text_tokenizer import ByteTokenizer
from tpustack_torch.obs import Registry, Tracer, accounting
from tpustack_torch.obs import flight as obs_flight
from tpustack_torch.serving import kv_pool
from tpustack_torch.serving import qos as qos_mod
from tpustack_torch.serving.llm_server import LLMServer, _Pending, build_paged
from tpustack_torch.serving.qos import QosPolicy, TokenBucket
from tpustack_torch.serving.resilience import ResilienceManager
from tpustack_torch.serving.speculative import SpecConfig

GREEDY = SampleConfig(greedy=True)


def _status(reply):
    return reply[0]


# ------------------------------------------------------------ token bucket
def test_token_bucket_refill_debt_and_eta():
    clock = {"t": 100.0}
    b = TokenBucket(rate_per_s=10.0, burst=20.0, clock=lambda: clock["t"])
    ref = jax_qos.TokenBucket(rate_per_s=10.0, burst=20.0, clock=lambda: clock["t"])
    assert b.ready() and b.refill_eta_s() == 0.0
    for bucket in (b, ref):
        bucket.charge(50.0)  # measured cost lands as debt: 20 - 50 = -30
    assert not b.ready()
    assert b.refill_eta_s() == pytest.approx(3.0, abs=0.01) == ref.refill_eta_s()
    clock["t"] += 2.0  # refill 20 -> level -10
    assert not b.ready()
    assert b.refill_eta_s() == pytest.approx(1.0, abs=0.01)
    clock["t"] += 1.5  # past zero
    assert b.ready()
    clock["t"] += 100.0  # refill clamps at burst
    b._refill()
    assert b.level == pytest.approx(20.0)
    assert b.snapshot() == ref.snapshot()
    with pytest.raises(ValueError):
        TokenBucket(rate_per_s=0.0, burst=1.0)


def test_queue_wait_recorded_per_server_and_priority():
    reg = Registry()
    p = QosPolicy({"default_priority": "interactive"}, registry=reg)
    p.observe_queue_wait("llm", "interactive", 0.25)
    p.observe_queue_wait("sd", "batch", 1.5)
    p.observe_queue_wait("graph", None, 0.1)  # -> default priority
    wait_lines = [ln for ln in reg.render().splitlines()
                  if ln.startswith("tpustack_qos_queue_wait_seconds")]
    for labels in ('server="llm",priority="interactive"', 'server="sd",priority="batch"',
                   'server="graph",priority="interactive"'):
        assert any(labels in ln for ln in wait_lines), (labels, wait_lines)


# ------------------------------------------------------------------ policy
CFG = {"default_priority": "interactive", "batch_shed_ratio": 0.25,
       "tenants": {"bulk": {"priority": "batch", "tokens_per_s": 100}}}


@pytest.mark.parametrize("header,body,tenant", [
    ("batch", "interactive", "anyone"), (None, "batch", "anyone"), (None, None, "bulk"),
    (None, None, "anyone"), ("URGENT", "nope", "bulk"), (" Interactive ", None, "bulk"),
    (None, "interactive", "bulk"), ("batch", None, "anyone"), (None, None, None)])
def test_priority_resolution_equals_jax(header, body, tenant):
    """header > body > tenant default > policy default; unknown values fall
    through; a policy-pinned batch tenant never self-promotes."""
    p = QosPolicy(CFG, registry=Registry())
    ref = jax_qos.QosPolicy(CFG, registry=None)
    assert p.resolve_priority(header, body, tenant) == ref.resolve_priority(header, body, tenant)


def test_policy_parse_and_priority_resolution():
    p = QosPolicy(CFG, registry=Registry())
    assert p.resolve_priority(None, None, "bulk") == "batch"
    assert p.resolve_priority(" Interactive ", None, "bulk") == "batch"
    assert p.resolve_priority("batch", None, "anyone") == "batch"
    assert p.batch_shed_depth(64) == 16
    assert p.batch_shed_depth(1) == 1
    assert p.snapshot()["tenants"]["bulk"]["buckets"]["tokens"]["burst"] == 200.0
    for bad in ({"default_priority": "urgent"}, {"batch_shed_ratio": 0.0},
                {"tenants": {"a": {"priority": "nope"}}}, {"tenants": ["a"]}):
        with pytest.raises(ValueError):
            QosPolicy(bad, registry=Registry())


def test_policy_from_env_gate_and_file(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSTACK_QOS", "0")
    assert QosPolicy.from_env(registry=Registry()) is None
    monkeypatch.delenv("TPUSTACK_QOS")
    assert QosPolicy.from_env(registry=Registry()) is not None  # on by default
    monkeypatch.setenv("TPUSTACK_QOS", "1")
    monkeypatch.setenv("TPUSTACK_QOS_POLICY", '{"tenants": {"a": {"tokens_per_s": 5}}}')
    assert "a" in QosPolicy.from_env(registry=Registry()).snapshot()["tenants"]
    cfg = tmp_path / "qos.json"
    cfg.write_text(json.dumps({"default_priority": "batch"}))
    monkeypatch.setenv("TPUSTACK_QOS_POLICY", str(cfg))
    assert QosPolicy.from_env(registry=Registry()).default_priority == "batch"
    monkeypatch.setenv("TPUSTACK_QOS_POLICY", "{not json")
    with pytest.raises(ValueError):
        QosPolicy.from_env(registry=Registry())
    monkeypatch.setenv("TPUSTACK_QOS", "maybe")
    with pytest.raises(ValueError):
        QosPolicy.from_env(registry=Registry())


def test_ledger_charges_drive_quota_buckets():
    reg = Registry()
    led = accounting.TenantLedger(reg, cardinality=8)
    p = QosPolicy({"tenants": {"bulk": {
        "tokens_per_s": 10.0, "burst_tokens": 5.0,
        "chip_seconds_per_s": 1.0, "burst_chip_seconds": 2.0}}}, registry=reg)
    led.add_listener(p.on_ledger_charge)
    led.add_listener(p.on_ledger_charge)  # idempotent by identity
    assert len(led._listeners) == 1
    assert p.quota_check("bulk") is None
    assert p.quota_check("unknown-tenant") is None  # no quota configured
    led.charge_tokens("llm", "bulk", prompt=20, generated=15)
    assert p.quota_check("bulk") == pytest.approx(3.0, abs=0.1)  # 5 - 35 at 10/s
    led.charge_chip_seconds("llm", "bulk", 10.0)  # 2 - 10 at 1/s
    assert p.quota_check("bulk") == pytest.approx(8.0, abs=0.2)
    lvl = reg.get_sample_value("tpustack_qos_bucket_level_ratio",
                               {"tenant": "bulk", "dimension": "tokens"})
    assert lvl is not None and lvl < 0


# --------------------------------------------------------------- admission
def test_admission_quota_shed_uses_bucket_eta():
    reg = Registry()
    p = QosPolicy({"tenants": {"bulk": {"priority": "batch", "tokens_per_s": 2.0,
                                        "burst_tokens": 4.0}}}, registry=reg)
    rm = ResilienceManager("llm", reg, qos=p)
    try:
        assert rm.admission_check(priority="batch", tenant="bulk") is None
        p.on_ledger_charge("llm", "bulk", "tokens", 24.0)  # debt 20 -> 10 s
        status, headers, body = rm.admission_check(priority="batch", tenant="bulk")
        assert status == 429 and headers["X-Shed-Reason"] == "quota"
        assert int(headers["Retry-After"]) == math.ceil(
            p._tenants["bulk"].buckets["tokens"].refill_eta_s())
        assert json.loads(body)["reason"] == "quota"
        assert p.counters["quota_throttle"]["batch"] == 1
        assert reg.get_sample_value("tpustack_qos_quota_throttle_total",
                                    {"server": "llm", "priority": "batch"}) == 1
        assert reg.get_sample_value("tpustack_requests_shed_total",
                                    {"server": "llm", "reason": "quota"}) == 1
    finally:
        rm.close()


def test_admission_batch_sheds_before_interactive():
    reg = Registry()
    p = QosPolicy({}, registry=reg)  # batch_shed_ratio 0.5
    depth = {"v": 4}
    rm = ResilienceManager("llm", reg, qos=p, queue_depth=lambda: depth["v"],
                           env={"TPUSTACK_MAX_QUEUE_DEPTH": "8"})
    try:
        assert _status(rm.admission_check(priority="batch", tenant="t")) == 429
        assert rm.admission_check(priority="interactive", tenant="t") is None
        assert p.counters["shed"] == {"batch": 1}
        depth["v"] = 8  # the full cap sheds everyone
        assert _status(rm.admission_check(priority="interactive", tenant="t")) == 429
        assert p.counters["shed"] == {"batch": 1, "interactive": 1}
        assert reg.get_sample_value("tpustack_qos_shed_total",
                                    {"server": "llm", "priority": "batch"}) == 1
    finally:
        rm.close()


def test_admission_unchanged_without_qos():
    depth = {"v": 4}
    rm = ResilienceManager("llm", Registry(), queue_depth=lambda: depth["v"],
                           env={"TPUSTACK_MAX_QUEUE_DEPTH": "8"})
    try:
        assert rm.qos is None
        assert rm.admission_check(priority="batch", tenant="bulk") is None
        depth["v"] = 8
        assert _status(rm.admission_check(priority="batch")) == 429
    finally:
        rm.close()


def test_current_priority_contextvar_default():
    assert qos_mod.current_priority.get() is None
    assert qos_mod.PRIORITIES == jax_qos.PRIORITIES == ("interactive", "batch")


# ------------------------------------------------- the engine: preemption
@pytest.fixture(scope="module")
def gens():
    jgen = JaxGenerator(JaxConfig.tiny(max_seq=64), dtype=jnp.float32, seed=3)
    pgen = Generator(LlamaConfig.tiny(max_seq=64), params=params_from_jax(jgen.params),
                     dtype=torch.float32, device="cpu")
    return jgen, pgen


def _runtime(side, gen):
    if side == "jax":
        pool = jax_kv.KVBlockPool(33, 8)
        return jax_kv.PagedKVRuntime(jax_init_pool(gen.cfg, 33, 8, jnp.float32), pool,
                                     gen.cfg.max_seq)
    pool = kv_pool.KVBlockPool(33, 8)
    return kv_pool.PagedKVRuntime(init_kv_pool(gen.cfg, 33, 8, torch.float32, "cpu"), pool,
                                  gen.cfg.max_seq)


def _preempt_run(side, gen, spec=None, pb=(5, 6, 7, 8), nb=14, pi=(9, 10, 11), ni=6,
                 cancel_parked=False, hooks=True, **engine_kw):
    """A batch request decoding alone in one slot; after its second token an
    interactive request arrives and the engine must park the batch row for
    it.  Returns (results, stats, preempt hook calls, runtime)."""
    Engine, Request = (JaxEngine, JaxRequest) if side == "jax" else (ContinuousEngine,
                                                                      SlotRequest)
    sample = JaxSample(greedy=True) if side == "jax" else GREEDY
    rt = _runtime(side, gen)
    results, trigger, state, cancelled, preempts = {}, {"armed": False}, {}, {"v": False}, []

    def on_b_tokens(toks):
        got = results.setdefault("b_tokens", [])
        got.extend(toks)
        if len(got) >= 2:
            trigger["armed"] = True  # the interactive request arrives

    breq = Request(ids=list(pb), max_new=nb, sample=sample, on_tokens=on_b_tokens,
                   on_done=lambda t, s: results.__setitem__("b", (t, s)),
                   cancelled=lambda: cancelled["v"], tenant="bulk", priority="batch")
    ireq = Request(ids=list(pi), max_new=ni, sample=sample,
                   on_done=lambda t, s: results.__setitem__("i", (t, s)),
                   tenant="alice", priority="interactive")

    def feed():
        if not state.get("b"):
            state["b"] = True
            return breq
        if trigger["armed"] and not state.get("i"):
            state["i"] = True
            cancelled["v"] = cancel_parked
            return ireq
        return None

    hint = lambda: trigger["armed"] and not state.get("i")  # noqa: E731
    if not hooks:
        hint = None
    if side == "jax":
        eng = Engine(gen, slots=1, chunk=4, stop_tokens=(), paged=rt, paged_flash=False,
                     spec=spec, preempt_hint=hint, on_preempt=preempts.append, **engine_kw)
    else:
        eng = Engine(gen, rt, slots=1, chunk=4, stop_tokens=(), spec=spec, preempt_hint=hint,
                     on_preempt=preempts.append, **engine_kw)
    stats = eng.run(feed)
    return results, stats, preempts, rt


def _solo(pgen, prompt, n):
    rt = _runtime("port", pgen)
    out = {}
    reqs = [SlotRequest(ids=list(prompt), max_new=n, sample=GREEDY,
                        on_done=lambda t, s: out.__setitem__("t", t))]
    ContinuousEngine(pgen, rt, slots=1, chunk=4).run(lambda: reqs.pop(0) if reqs else None)
    return out["t"]


@pytest.mark.parametrize("spec", [None, SpecConfig(tokens=3)], ids=["plain", "spec"])
def test_preempt_resume_greedy_byte_identical(gens, spec):
    jgen, pgen = gens
    res, stats, preempts, rt = _preempt_run("port", pgen, spec=spec)
    assert stats["preempted"] == 1 and stats["resumed"] == 1, stats
    assert preempts == ["bulk"]
    solo_b, solo_i = _solo(pgen, (5, 6, 7, 8), 14), _solo(pgen, (9, 10, 11), 6)
    assert res["i"][0] == solo_i
    assert res["b"][0] == solo_b
    bstats = res["b"][1]
    assert bstats["preempted"] == 1 and bstats["prompt_tokens"] == 4
    assert bstats["generated_tokens"] == len(solo_b) == 14
    assert res["b_tokens"] == solo_b  # streamed without gaps or repeats
    assert rt.pool.n_free == rt.pool.capacity_blocks  # retained refs returned
    # the JAX engine in the same scenario, on the same weights
    jres, jstats, jpre, _ = _preempt_run("jax", jgen, spec=None if spec is None
                                         else jax_spec(spec))
    assert jstats["preempted"] == 1 and jpre == ["bulk"]
    assert res["b"][0] == list(jres["b"][0]) and res["i"][0] == list(jres["i"][0])


def jax_spec(spec):
    from tpustack.serving.speculative import SpecConfig as JaxSpec

    return JaxSpec(tokens=spec.tokens)


def test_preempt_conservation_and_flight_records(gens):
    _, pgen = gens
    led = accounting.TenantLedger(Registry(), cardinality=8)
    rec = obs_flight.FlightRecorder("qos-conservation", capacity=512)
    res, stats, _, rt = _preempt_run("port", pgen, pb=(5, 6, 7), nb=12, pi=(9, 10), ni=5,
                                     flight=rec, ledger=led)
    assert stats["preempted"] == 1
    recent = rec.recent()
    assert any(r["kind"] == "preempt" and r["priority"] == "batch" and r["tenant"] == "bulk"
               for r in recent)
    waves = [r for r in recent if r["kind"] in ("wave", "verify")]
    for r in waves:
        if r["occupancy"]:
            assert sum(r["priorities"].values()) == r["occupancy"], r
    billed = [r for r in waves if r.get("wave_s") and r.get("tenants")]
    busy = sum(r["wave_s"] for r in billed)
    snap = led.snapshot()["tenants"]
    assert sum(t["chip_seconds"] for t in snap.values()) == pytest.approx(busy, rel=1e-9)
    assert rec.aggregates()["tenant_chip_seconds"] == pytest.approx(
        {t: round(v["chip_seconds"], 6) for t, v in snap.items()}, abs=1e-5)
    assert snap["bulk"]["chip_seconds"] > 0 and snap["alice"]["chip_seconds"] > 0
    assert snap["bulk"]["kv_block_seconds"] > 0  # both occupancies billed at retire
    assert rt.pool.n_free == rt.pool.capacity_blocks


def test_parked_entry_released_on_cancel(gens):
    _, pgen = gens
    res, stats, _, rt = _preempt_run("port", pgen, pb=(5, 6, 7), nb=12, pi=(9, 10), ni=4,
                                     cancel_parked=True)
    assert stats["preempted"] == 1 and stats["resumed"] == 0
    assert res["i"][0]  # the interactive request was served
    assert res["b"][0] is None  # reported once, never resumed
    assert rt.pool.n_free == rt.pool.capacity_blocks


def test_engine_without_hooks_never_parks(gens):
    """No preempt hint (QoS off): the interactive request waits for the
    batch row, which runs through uninterrupted."""
    _, pgen = gens
    res, stats, preempts, _ = _preempt_run("port", pgen, hooks=False)
    assert stats["preempted"] == 0 and not preempts
    assert res["b"][0] == _solo(pgen, (5, 6, 7, 8), 14)


# ------------------------------------------------ the server: queue + HTTP
@pytest.fixture(scope="module")
def tiny():
    return Generator(LlamaConfig.tiny(max_seq=128), dtype=torch.float32, device="cpu")


def _server(gen, **kw):
    srv = LLMServer(gen, ByteTokenizer(512), max_batch=2, paged=build_paged(gen, 2),
                    spec=None, registry=kw.pop("registry", Registry()), tracer=Tracer())
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    return srv


def _call(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_llm_server_priority_dequeue_and_hint(tiny, monkeypatch):
    monkeypatch.delenv("TPUSTACK_QOS", raising=False)
    srv = _server(tiny)
    try:
        assert srv.qos is not None  # TPUSTACK_QOS defaults on

        def pend(tag, priority):
            r = _Pending([tag], 4, GREEDY, None, None, None, None, False)
            r.priority = priority
            return r

        srv._queue.extend([pend(1, "batch"), pend(2, "interactive"), pend(3, "batch"),
                           pend(4, "interactive")])
        assert srv._interactive_waiting()
        assert [srv._pop_queued().ids[0] for _ in range(4)] == [2, 4, 1, 3]
        assert not srv._interactive_waiting()
        srv.qos = None  # QoS off: strict FIFO
        srv._queue.extend([pend(1, "batch"), pend(2, "interactive")])
        assert [srv._pop_queued().ids[0] for _ in range(2)] == [1, 2]
    finally:
        srv.stop()


def test_llm_http_quota_429_and_debug_buckets(tiny, monkeypatch):
    monkeypatch.setenv("TPUSTACK_QOS_POLICY", json.dumps({
        "tenants": {"bulk": {"priority": "batch", "tokens_per_s": 1.0, "burst_tokens": 4.0}}}))
    reg = Registry()
    srv = _server(tiny, registry=reg)
    try:
        st, _, body1 = _call(srv.url + "/completion",
                             {"prompt": "hello", "n_predict": 8, "temperature": 0},
                             {"X-Tenant-Id": "bulk"})
        assert st == 200
        st, hd, body2 = _call(srv.url + "/completion",
                              {"prompt": "again", "n_predict": 8, "temperature": 0},
                              {"X-Tenant-Id": "bulk"})
        assert st == 429 and hd["X-Shed-Reason"] == "quota" and body2["reason"] == "quota"
        ra = int(hd["Retry-After"])
        # an unconfigured tenant (named in the body) is untouched by bulk's debt
        st, _, _ = _call(srv.url + "/completion",
                         {"prompt": "fine", "n_predict": 4, "temperature": 0,
                          "tenant": "alice"})
        assert st == 200
        dbg = _call(srv.url + "/debug/tenants")[2]
    finally:
        srv.stop()
    spent = body1["tokens_evaluated"] + body1["tokens_predicted"]
    assert abs(ra - math.ceil(spent - 4.0)) <= 1  # the bucket's own refill ETA
    q = dbg["qos"]
    assert q["enabled"] and "bulk" in q["tenants"]
    tok = q["tenants"]["bulk"]["buckets"]["tokens"]
    assert tok["level"] < 0 and tok["refill_eta_s"] > 0
    assert q["counters"]["quota_throttle"] == {"batch": 1}
    assert set(dbg["tenants"]) == {"bulk", "alice"}
    assert dbg["tenants"]["bulk"]["outcomes"] == {"ok": 1, "shed": 1}
    assert reg.get_sample_value("tpustack_qos_requests_total",
                                {"server": "llm", "priority": "batch", "outcome": "shed"}) == 1


def test_qos_off_is_byte_identical(tiny, monkeypatch):
    body = {"prompt": "hello world", "n_predict": 12, "temperature": 0}
    monkeypatch.delenv("TPUSTACK_QOS", raising=False)
    on = _server(tiny)
    try:
        assert on.qos is not None and on.resilience.qos is not None
        expected = _call(on.url + "/completion", body, {"X-Priority": "batch"})[2]["content"]
    finally:
        on.stop()
    monkeypatch.setenv("TPUSTACK_QOS", "0")
    reg = Registry()
    off = _server(tiny, registry=reg)
    try:
        assert off.qos is None and off.resilience.qos is None
        st, _, out = _call(off.url + "/completion", body, {"X-Priority": "batch"})
        dbg = _call(off.url + "/debug/tenants")[2]
    finally:
        off.stop()
    assert st == 200 and out["content"] == expected
    assert "tpustack_qos_requests_total{" not in reg.render()  # X-Priority ignored
    assert dbg["qos"] == {"enabled": False}


def test_malformed_policy_fails_at_startup(tiny, monkeypatch):
    monkeypatch.setenv("TPUSTACK_QOS_POLICY", '{"tenants": {"a": {"priority": "urgent"}}}')
    with pytest.raises(ValueError, match="urgent"):
        LLMServer(tiny, ByteTokenizer(512), max_batch=2, paged=build_paged(tiny, 2), spec=None,
                  registry=Registry(), tracer=Tracer())
