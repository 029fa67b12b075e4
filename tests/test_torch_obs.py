"""The port's observability layer against the JAX package's, on the CPU.

``tpustack_torch.obs`` (metrics, catalog, trace, flight, device, http) and
``tpustack_torch.utils.knobs`` are copies of their JAX counterparts for the
standard-library servers.  Held here: the same metric operations give
byte-equal Prometheus text from both registries; ``traceparent`` parses and
formats alike; every family the port registers has the JAX catalog's name,
kind, labels and buckets; the knobs keep their names and defaults; the flight
recorder aggregates alike; and the fleet's own clients (the JAX autoscaler's
``_fetch_json`` and ``_scrape_metrics``, the router's ``/readyz`` probe)
read a tiny port LLM server.  Then the HTTP instrumentation itself: request
ids, route-template endpoint labels, root spans from an inbound
``traceparent``, untraced probes, ``rid=`` on log lines, and the device
gauges' silence on the CPU.
"""

import json
import logging
import socket
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from tpustack.obs import catalog as jax_catalog
from tpustack.obs import flight as jax_flight
from tpustack.obs import trace as jax_trace
from tpustack.obs.metrics import Registry as JaxRegistry
from tpustack.serving import autoscaler as jax_autoscaler
from tpustack.serving.router import Router as JaxRouter
from tpustack.utils import knobs as jax_knobs
from tpustack_torch.models.llama import LlamaConfig
from tpustack_torch.models.llm_generate import Generator
from tpustack_torch.models.text_tokenizer import ByteTokenizer
from tpustack_torch.obs import catalog, device, flight
from tpustack_torch.obs import http as obs_http
from tpustack_torch.obs import trace
from tpustack_torch.obs.metrics import Registry
from tpustack_torch.serving.llm_server import LLMServer, build_paged
from tpustack_torch.utils import get_logger, knobs


# ------------------------------------------------------------------ parity
def _drive(reg):
    """One fixed sequence of metric operations."""
    c = reg.counter("tpustack_demo_requests_total", "Requests, by code.", ("code",))
    c.labels(code="200").inc()
    c.labels("429").inc(3)
    c.labels(code="we\"ird\n\\").inc(0.5)
    g = reg.gauge("tpustack_demo_depth", "Queue depth.")
    g.set(7)
    g.dec(2.5)
    h = reg.histogram("tpustack_demo_latency_seconds", "Latency.", ("server",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.labels(server="llm").observe(v)
    d = reg.histogram("tpustack_demo_default_seconds", "Default buckets.")
    d.observe(0.3)
    reg.add_collector(lambda r: r.gauge("tpustack_demo_collected_bytes", "At scrape.").set(2**40))


def test_exposition_is_byte_equal_to_the_jax_registry():
    port, ref = Registry(), JaxRegistry()
    _drive(port)
    _drive(ref)
    text = port.render()
    assert text == ref.render()
    assert 'code="we\\"ird\\n\\\\"' in text and "tpustack_demo_collected_bytes 1099511627776" in text
    for name, labels in (("tpustack_demo_latency_seconds_bucket", {"server": "llm", "le": "0.1"}),
                         ("tpustack_demo_requests_total", {"code": "429"}),
                         ("tpustack_demo_depth", None)):
        assert port.get_sample_value(name, labels) == ref.get_sample_value(name, labels)
    assert port.get_sample_value("tpustack_demo_latency_seconds_count", {"server": "llm"}) == 5


@pytest.mark.parametrize("header", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    " 00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00 ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",   # version ff: invalid
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",   # all-zero trace id
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",   # all-zero span id
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",    # short
    "garbage", "", None,
])
def test_traceparent_parse_and_format_agree(header):
    got, want = trace.parse_traceparent(header), jax_trace.parse_traceparent(header)
    assert got == want
    if got is not None:
        assert trace.format_traceparent(got) == jax_trace.format_traceparent(want)
        assert trace.format_traceparent(got).startswith("00-") and got.trace_id.islower()


def test_every_port_family_matches_the_jax_catalog():
    ref = {s.name: s for s in jax_catalog.CATALOG}
    assert len(catalog.CATALOG) >= 30
    for spec in catalog.CATALOG:
        assert spec.name in ref, spec.name
        want = ref[spec.name]
        assert (spec.type, tuple(spec.labels), spec.buckets, spec.unit) == \
            (want.type, tuple(want.labels), want.buckets, want.unit), spec.name
    # the three families the fleet's autoscaler scrapes are among them
    names = {s.name for s in catalog.CATALOG}
    assert {"tpustack_requests_shed_total", "tpustack_llm_kv_free_blocks",
            "tpustack_llm_kv_used_blocks"} <= names


def test_knobs_keep_the_jax_names_types_and_defaults():
    assert len(knobs.REGISTRY) >= 15
    for name, k in knobs.REGISTRY.items():
        ref = jax_knobs.REGISTRY[name]
        assert (k.type, k.default) == (ref.type, ref.default), name
    env = {"TPUSTACK_MAX_QUEUE_DEPTH": " 7 ", "TPUSTACK_WATCHDOG_S": "",
           "TPUSTACK_ADMIN_TOKEN": "s3cret"}
    for getter, name in ((knobs.get_int, "TPUSTACK_MAX_QUEUE_DEPTH"),
                         (knobs.get_float, "TPUSTACK_WATCHDOG_S"),
                         (knobs.get_str, "TPUSTACK_ADMIN_TOKEN")):
        assert getter(name, env=env) == getattr(jax_knobs, getter.__name__)(name, env=env)
    with pytest.raises(ValueError, match="TPUSTACK_MAX_QUEUE_DEPTH"):
        knobs.get_int("TPUSTACK_MAX_QUEUE_DEPTH", env={"TPUSTACK_MAX_QUEUE_DEPTH": "x"})
    with pytest.raises(KeyError):
        knobs.get_int("TPUSTACK_NOT_A_KNOB")
    with pytest.raises(TypeError):
        knobs.get_int("TPUSTACK_WATCHDOG_S")


def test_flight_recorder_aggregates_like_the_jax_one():
    recs = [("prefill", {"prefill_s": 0.2}),
            ("wave", {"tokens": 16, "weight_passes": 16, "occupancy": 2, "wave_s": 0.1,
                      "kv_free": 10, "kv_used": 5, "queue_depth": 1}),
            ("verify", {"tokens": 9, "weight_passes": 1, "drafted": 8, "accepted": 5,
                        "occupancy": 2, "wave_s": 0.05, "slowest_trace_id": "ab" * 16,
                        "slowest_age_s": 0.4}),
            ("batch", {"batch": 4, "denoise_vae_s": 1.5})]
    port, ref = flight.FlightRecorder("llm", capacity=3), jax_flight.FlightRecorder("llm", 3)
    for kind, fields in recs:
        port.record(kind, **fields)
        ref.record(kind, **fields)
    assert len(port) == 3  # the ring keeps the newest
    a, b = port.aggregates(), ref.aggregates()
    for k in ("records", "kinds", "waves", "tokens", "spec_acceptance", "slowest_trace_id",
              "images", "mean_batch"):
        assert a[k] == b[k], k
    assert [r["seq"] for r in port.recent()] == [2, 3, 4]
    assert port.snapshot(n=1)["records"][0]["kind"] == "batch"


def test_flight_dump_writes_the_ring(tmp_path):
    rec = flight.register(flight.FlightRecorder("llm", capacity=8))
    rec.record("wave", tokens=3)
    path = rec.dump("drain", dump_dir=str(tmp_path))
    data = json.loads(open(path).read())
    assert data["reason"] == "drain" and data["records"][0]["tokens"] == 3
    assert rec in flight.recorders()
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    assert rec.dump("x", dump_dir=str(blocker / "sub")) is None  # best-effort: no raise


def test_device_gauges_stay_silent_on_the_cpu():
    reg = Registry()
    device.install(reg)
    device.install(reg)  # idempotent
    text = reg.render()
    assert "# TYPE tpustack_device_hbm_used_bytes gauge" in text
    assert "tpustack_device_hbm_used_bytes{" not in text  # no zeros reported
    assert reg.get_sample_value("tpustack_process_start_time_seconds") > 0


def test_log_lines_carry_the_request_id(caplog):
    log = get_logger("test.rid")
    handler = logging.getLogger("tpustack_torch").handlers[0]
    records = []
    handler_emit = handler.emit
    handler.emit = lambda r: (records.append(handler.format(r)), handler_emit(r))
    try:
        token = trace.current_request_id.set("0123456789ab")
        log.info("inside")
        trace.current_request_id.reset(token)
        log.info("outside")
    finally:
        handler.emit = handler_emit
    assert "[rid=0123456789ab] inside" in records[0] and "[rid=-] outside" in records[1]


# ------------------------------------------------------ HTTP instrumentation
def test_routes_match_templates_and_collapse_the_rest():
    routes = obs_http.Routes()
    routes.add_get("/history/{prompt_id}", lambda r: None)
    routes.add_get("/queue", lambda r: None)
    assert routes.match("GET", "/history/ab%20c")[::2] == ("/history/{prompt_id}",
                                                           {"prompt_id": "ab c"})
    assert routes.match("GET", "/queue")[0] == "/queue"
    for method, path in (("POST", "/queue"), ("GET", "/history/"), ("GET", "/history/a/b"),
                         ("GET", "/nowhere")):
        assert routes.match(method, path)[0] == "__unmatched__"


@pytest.fixture(scope="module")
def llm():
    gen = Generator(LlamaConfig.tiny(max_seq=128), dtype=torch.float32, device="cpu")
    srv = LLMServer(gen, ByteTokenizer(512), max_batch=4, paged=build_paged(gen, 4),
                    spec=None, registry=Registry(), tracer=trace.Tracer())
    srv.url = f"http://127.0.0.1:{srv.start(host='127.0.0.1', port=0)}"
    yield srv
    srv.stop()


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_the_fleets_clients_read_a_port_replica(llm):
    """The JAX autoscaler's scrape and health reads and the router's
    /readyz probe, pointed at a port LLM server."""
    assert _post(llm.url + "/completion", {"prompt": "fleet", "n_predict": 3,
                                           "temperature": 0})[0] == 200
    h = jax_autoscaler._fetch_json(llm.url + "/healthz", timeout=5)
    assert h["ok"] is True and h["inflight"] == 0 and h["queue_depth"] == 0
    assert h["engine"]["paged_kv"] is True
    samples = jax_autoscaler._scrape_metrics(llm.url, (
        "tpustack_requests_shed_total", "tpustack_llm_kv_free_blocks",
        "tpustack_llm_kv_used_blocks"), timeout=5)
    by = {s["name"]: s["value"] for s in samples}
    pool = llm.paged.pool
    assert by["tpustack_llm_kv_free_blocks"] + by["tpustack_llm_kv_used_blocks"] == \
        pool.capacity_blocks
    assert by["tpustack_llm_kv_free_blocks"] == pool.n_free
    probe = types.SimpleNamespace(health_interval_s=2.0)
    assert JaxRouter._probe(probe, llm.url) == "ok"
    llm.resilience.admin_drain()
    try:
        assert JaxRouter._probe(probe, llm.url) == "unready"
    finally:
        llm.resilience.admin_undrain()
    assert JaxRouter._probe(probe, llm.url) == "ok"


def test_request_ids_spans_and_endpoint_labels(llm):
    reg = llm._registry
    st, hd, _ = _post(llm.url + "/completion", {"prompt": "ids", "n_predict": 2,
                                                "temperature": 0},
                      {"X-Request-Id": "client-rid-1"})
    assert st == 200 and hd["X-Request-Id"] == "client-rid-1"
    tid = hd["X-Trace-Id"]  # a work endpoint is always traced
    record = json.loads(_get(f"{llm.url}/debug/traces/{tid}")[2])
    names = [s["name"] for s in record["spans"]]
    assert names[0] == "POST /completion" and {"queue_wait", "prefill", "wave"} <= set(names)
    assert record["tree"][0]["name"] == "POST /completion"
    # probes are untraced unless the caller sends a traceparent
    st, hd, _ = _get(llm.url + "/healthz")
    assert st == 200 and "X-Trace-Id" not in hd and len(hd["X-Request-Id"]) == 12
    tp = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
    st, hd, _ = _get(llm.url + "/readyz", {"traceparent": tp})
    assert hd["X-Trace-Id"] == "c" * 32
    rec = json.loads(_get(llm.url + "/debug/traces/" + "c" * 32)[2])
    assert rec["spans"][0]["parent_id"] == "d" * 16
    assert _get(llm.url + "/debug/traces/" + "e" * 32)[0] == 404
    summary = json.loads(_get(llm.url + "/debug/traces")[2])
    assert {"recent", "slowest", "kept", "captured"} <= set(summary)
    # counters by route template; unknown paths collapse
    assert _get(llm.url + "/no/such/path")[0] == 404
    assert reg.get_sample_value("tpustack_http_requests_total", {
        "server": "llm", "endpoint": "/debug/traces/{trace_id}", "status": "404"}) >= 1
    assert reg.get_sample_value("tpustack_http_requests_total", {
        "server": "llm", "endpoint": "__unmatched__", "status": "404"}) == 1
    assert reg.get_sample_value("tpustack_http_request_latency_seconds_count", {
        "server": "llm", "endpoint": "/completion"}) >= 1
    flight_view = json.loads(_get(llm.url + "/debug/flight?n=2")[2])
    assert flight_view["server"] == "llm" and len(flight_view["records"]) <= 2
    assert flight_view["aggregates"]["waves"] >= 1


def test_metrics_endpoint_serves_the_llm_families(llm):
    st, hd, body = _get(llm.url + "/metrics")
    text = body.decode()
    assert st == 200 and hd["Content-Type"] == "text/plain; version=0.0.4; charset=utf-8"
    for fam in ("tpustack_llm_kv_free_blocks", "tpustack_llm_kv_used_blocks",
                "tpustack_requests_shed_total", "tpustack_http_requests_total",
                "tpustack_llm_generated_tokens_total", "tpustack_serving_drain_state"):
        assert f"# TYPE {fam} " in text, fam
    assert 'tpustack_serving_drain_state{server="llm"} 0' in text


def test_a_stalled_reader_cannot_wedge_a_stream(monkeypatch):
    """``Request.write`` blocks at most the stream's write timeout: a client
    that connects and never reads ends the handler with an OSError."""
    monkeypatch.setattr(obs_http, "STREAM_WRITE_TIMEOUT_S", 0.3)
    ended = []

    def forever(req):
        req.start_stream(200, {"Content-Type": "text/event-stream"})
        try:
            while True:
                req.write(b"data: " + b"x" * 65536 + b"\n\n")
        except OSError as e:
            ended.append(type(e).__name__)
        return None

    routes = obs_http.Routes()
    routes.add_get("/stream", forever)
    dispatch = obs_http.instrument("test", Registry(), trace.Tracer())(
        obs_http.route(obs_http.json_reply(404, {})))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), obs_http.handler_class(routes, dispatch))
    httpd.daemon_threads = True
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    sock = socket.create_connection(httpd.server_address)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    try:
        sock.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
        t_end = time.monotonic() + 20
        while not ended and time.monotonic() < t_end:
            time.sleep(0.05)
        assert ended and ended[0] in ("TimeoutError", "timeout", "BrokenPipeError",
                                      "ConnectionResetError")
    finally:
        sock.close()
        httpd.shutdown()
        httpd.server_close()
