"""HTTP plumbing of the port's servers, on the standard library.

The port's counterpart of ``tpustack/obs/http.py``, for
``http.server.ThreadingHTTPServer`` instead of aiohttp:

- :class:`Routes` maps ``(method, route template)`` to a handler; templates
  take ``{name}`` segments (``/history/{prompt_id}``), and a request's
  endpoint label is its matched template, so label cardinality stays
  bounded; unmatched paths all collapse into ``__unmatched__``.
- :func:`instrument` wraps a dispatch function (``Request -> Reply``): it
  stamps every request with a request id (honouring an inbound
  ``X-Request-Id``), binds it to the logging contextvar, counts the request
  into ``tpustack_http_requests_total`` with the route template as the
  endpoint label, observes ``tpustack_http_request_latency_seconds``, and
  opens the request's root span (honouring an inbound W3C ``traceparent``,
  so the client's trace id follows the request through the engine; the
  trace id is echoed as ``X-Trace-Id``).  Health, metrics and poll
  endpoints are traced only when the caller sent a ``traceparent``.  It
  also resolves the request's tenant once (``X-Tenant-Id``, else the JSON
  body's ``tenant`` field on work endpoints, else
  ``TPUSTACK_TENANT_DEFAULT``), binds it to ``current_tenant`` and
  ``req.tenant``, stamps it on the root span, and counts each work
  request's outcome into the tenant ledger.
- :func:`handler_class` turns routes and a dispatch function into the
  ``BaseHTTPRequestHandler`` a server binds.
- :func:`add_metrics_route`, :func:`add_debug_trace_routes`,
  :func:`add_debug_flight_routes` and :func:`add_debug_tenant_routes`
  mount ``GET /metrics``, ``GET /debug/traces``,
  ``GET /debug/traces/{trace_id}``, ``GET /debug/flight`` and
  ``GET /debug/tenants``.

A handler returns a :data:`Reply` ``(status, headers, body)``, or streams:
:meth:`Request.start_stream` sends the status and headers (``Connection:
close``, no length) and :meth:`Request.write` sends each chunk with the
socket's timeout bounding the write, so a stalled reader cannot wedge the
handler thread.  A streaming handler returns None.
"""

from __future__ import annotations

import json
import socket
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple

from tpustack_torch.obs import accounting as obs_accounting
from tpustack_torch.obs import catalog
from tpustack_torch.obs import trace as obs_trace
from tpustack_torch.obs.metrics import CONTENT_TYPE, REGISTRY, Registry
from tpustack_torch.utils import get_logger

log = get_logger("obs.http")

#: ``(status, headers, body)``
Reply = Tuple[int, Dict[str, str], bytes]

#: endpoints whose steady-state chatter (kubelet probes, Prometheus
#: scrapes, /history polling) must not churn the trace ring buffer; traced
#: only when the caller explicitly sent a traceparent
UNTRACED_ENDPOINTS = frozenset({
    "/metrics", "/health", "/healthz", "/readyz",
    "/debug/traces", "/debug/traces/{trace_id}", "/debug/flight",
    "/debug/tenants", "/debug/kvcache",
    "__unmatched__", "/queue", "/history/{prompt_id}",
})

#: JSON bodies larger than this are not parsed for a ``tenant`` field by
#: the instrumentation (the handler parses them itself)
_TENANT_BODY_MAX = 1 << 20

_UNPARSED = object()

#: seconds a streamed write may block on a reader that stopped reading
STREAM_WRITE_TIMEOUT_S = 60.0


def json_reply(status: int, payload, headers: Optional[Dict[str, str]] = None) -> Reply:
    out = {"Content-Type": "application/json"}
    out.update(headers or {})
    return status, out, json.dumps(payload).encode()


class Request:
    """One parsed HTTP request, handed to a route's handler."""

    def __init__(self, handler: Optional[BaseHTTPRequestHandler], method: str, path: str,
                 query: Dict[str, List[str]], headers, body: bytes, endpoint: str,
                 fn: Optional[Callable], params: Dict[str, str]):
        self._handler = handler
        self.method, self.path, self.query = method, path, query
        self.headers, self.body = headers, body
        self.endpoint, self.fn, self.params = endpoint, fn, params
        self.request_id = "-"
        self.span: Optional[obs_trace.Span] = None
        #: the status sent, once a reply or a stream's head went out
        self.status: Optional[int] = None
        #: the tenant the instrumentation resolved
        self.tenant: Optional[str] = None
        #: the QoS priority class the resilience layer resolved (None: QoS off)
        self.priority: Optional[str] = None
        #: an outcome that overrides the status-derived one in the tenant
        #: accounting (a stream whose 200 went out before it failed)
        self.tenant_outcome: Optional[str] = None
        self._json = _UNPARSED

    def json(self):
        """The body as JSON (an empty body is ``{}``); raises ValueError.
        The instrumentation's parse of a work request is reused."""
        if self._json is _UNPARSED:
            return json.loads(self.body or b"{}")
        return self._json

    def arg(self, name: str, default: str = "") -> str:
        return (self.query.get(name) or [default])[0]

    def _stamp(self, headers: Dict[str, str]) -> Dict[str, str]:
        headers = dict(headers)
        headers.setdefault("X-Request-Id", self.request_id)
        if self.span is not None:
            headers.setdefault("X-Trace-Id", self.span.trace_id)
        return headers

    def send(self, reply: Reply) -> None:
        status, headers, body = reply
        self.status = status
        h = self._handler
        h.send_response(status)
        for k, v in self._stamp(headers).items():
            h.send_header(k, v)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def start_stream(self, status: int, headers: Dict[str, str]) -> None:
        """Send the head of a streamed reply; the connection closes after
        it.  Each later :meth:`write` blocks at most
        :data:`STREAM_WRITE_TIMEOUT_S`."""
        self.status = status
        h = self._handler
        h.close_connection = True
        h.connection.settimeout(STREAM_WRITE_TIMEOUT_S)
        h.send_response(status)
        for k, v in self._stamp(dict(headers, Connection="close")).items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.flush()

    def write(self, data: bytes) -> None:
        """Send one chunk of a stream; raises ``OSError`` (``BrokenPipeError``,
        ``socket.timeout``...) when the client is gone or stalled."""
        self._handler.wfile.write(data)
        self._handler.wfile.flush()


class Routes:
    """``(method, template)`` -> handler; ``{name}`` matches one segment."""

    def __init__(self):
        self._exact: Dict[Tuple[str, str], Callable] = {}
        self._templated: List[Tuple[str, List[str], str, Callable]] = []

    def add(self, method: str, template: str, fn: Callable) -> None:
        if "{" in template:
            self._templated.append((method, template.strip("/").split("/"), template, fn))
        else:
            self._exact[(method, template)] = fn

    def add_get(self, template: str, fn: Callable) -> None:
        self.add("GET", template, fn)

    def add_post(self, template: str, fn: Callable) -> None:
        self.add("POST", template, fn)

    def match(self, method: str, path: str):
        """``(template, handler, params)``; ``("__unmatched__", None, {})``."""
        fn = self._exact.get((method, path))
        if fn is not None:
            return path, fn, {}
        parts = path.strip("/").split("/")
        for m, tparts, template, fn in self._templated:
            if m != method or len(tparts) != len(parts):
                continue
            params = {}
            for t, p in zip(tparts, parts):
                if t.startswith("{") and t.endswith("}"):
                    if not p:
                        break
                    params[t[1:-1]] = urllib.parse.unquote(p)
                elif t != p:
                    break
            else:
                return template, fn, params
        return "__unmatched__", None, {}


def route(not_found: Reply, error_key: str = "error") -> Callable[[Request], Optional[Reply]]:
    """The innermost dispatch: call the matched handler; ``not_found`` for
    an unmatched path, a logged 500 (the message under ``error_key``) for a
    handler that raised."""

    def dispatch(req: Request) -> Optional[Reply]:
        if req.fn is None:
            return not_found
        try:
            return req.fn(req)
        except Exception as e:  # the server stays up; the client gets a 500
            log.exception("%s %s failed", req.method, req.path)
            if req.status is not None:  # a stream already sent its head
                return None
            return json_reply(500, {error_key: f"{type(e).__name__}: {e}"})

    return dispatch


def _extract_tenant(req: Request, read_body: bool) -> str:
    """The request's tenant: ``X-Tenant-Id`` first, else (on work endpoints
    only) a JSON body's ``tenant`` field, else the configured default.  The
    body of a work request is parsed here even when the header is present
    (the QoS layer reads its ``priority`` field), and the parse is cached on
    the request for the handler; bodies above :data:`_TENANT_BODY_MAX` or
    not ``application/json`` are left to the handler."""
    header = req.headers.get("X-Tenant-Id")
    body = None
    ctype = (req.headers.get("Content-Type") or "").split(";")[0].strip().lower()
    if (read_body and req.method == "POST" and req.body and ctype == "application/json"
            and len(req.body) <= _TENANT_BODY_MAX):
        try:
            parsed = json.loads(req.body)
        except (ValueError, UnicodeDecodeError):
            parsed = None  # the handler answers the malformed body
        else:
            req._json = parsed
        body = parsed if isinstance(parsed, dict) else None
    return obs_accounting.resolve_tenant(header, body)


def instrument(server_name: str, registry: Optional[Registry] = None,
               tracer: Optional[obs_trace.Tracer] = None,
               ledger: Optional[obs_accounting.TenantLedger] = None,
               work_endpoints=(), outcome_accounting: str = "full"):
    """Wrap a dispatch function with request ids, the tenant, the root
    span, the HTTP counters and the latency histogram; returns
    ``wrap(dispatch)``.

    Latency covers the handler including a streamed body (an SSE
    completion counts its whole stream: that is the latency its client
    sees).  The root span honours an inbound ``traceparent``, is the
    ``current_span`` of the handler's context and ``req.span``; engine work
    on other threads parents under it through explicitly passed
    :class:`~tpustack_torch.obs.trace.SpanContext` handles.

    Tenant accounting: the tenant is resolved once (:func:`_extract_tenant`),
    bound to ``current_tenant`` and ``req.tenant`` and set as the root
    span's ``tenant`` attribute; for ``work_endpoints`` the request's outcome
    (``req.tenant_outcome``, else the status's) is counted into ``ledger``
    and, when the resilience layer resolved a priority, into
    ``tpustack_qos_requests_total``.  ``outcome_accounting="refusals"``
    counts only the non-``ok`` outcomes here: an accept-and-poll server
    (graph) counts ok/error/deadline where its worker publishes."""
    m = catalog.build(registry)
    tracer = tracer if tracer is not None else obs_trace.TRACER
    ledger = ledger if ledger is not None else obs_accounting.for_registry(registry)
    work_endpoints = frozenset(work_endpoints)
    if tracer is not obs_trace.TRACER or registry is None:
        # capture counting only when tracer and registry pair up: a
        # private-registry server on the PROCESS tracer must not redirect
        # every other server's capture counts into its registry
        tracer.wire_metrics(registry)
    requests_total = m["tpustack_http_requests_total"]
    latency = m["tpustack_http_request_latency_seconds"]
    in_flight = m["tpustack_http_in_flight_requests"]

    def wrap(dispatch: Callable[[Request], Optional[Reply]]) -> Callable[[Request], None]:
        def instrumented(req: Request) -> None:
            rid = req.headers.get("X-Request-Id") or obs_trace.new_request_id()
            rid_token = obs_trace.current_request_id.set(rid)
            req.request_id = rid
            req.tenant = _extract_tenant(req, read_body=req.endpoint in work_endpoints)
            tenant_token = obs_accounting.current_tenant.set(req.tenant)
            remote = obs_trace.parse_traceparent(req.headers.get("traceparent"))
            span_token = None
            if remote is not None or req.endpoint not in UNTRACED_ENDPOINTS:
                req.span = tracer.start_span(
                    f"{req.method} {req.endpoint}", parent=remote,
                    attrs={"server": server_name, "http.method": req.method,
                           "http.endpoint": req.endpoint, "request_id": rid,
                           "tenant": req.tenant})
                span_token = obs_trace.current_span.set(req.span)
            in_flight.labels(server=server_name).inc()
            t0 = time.perf_counter()
            reply = None
            try:
                reply = dispatch(req)
            finally:
                # booked before a reply goes out, so a client that reads
                # /metrics, /debug/tenants or its trace right after its
                # response finds the request counted (a stream's body has
                # already been written by its handler)
                status = reply[0] if reply is not None else (
                    req.status if req.status is not None else 500)
                in_flight.labels(server=server_name).dec()
                requests_total.labels(server=server_name, endpoint=req.endpoint,
                                      status=str(status)).inc()
                latency.labels(server=server_name, endpoint=req.endpoint).observe(
                    time.perf_counter() - t0)
                if req.endpoint in work_endpoints:
                    outcome = req.tenant_outcome or obs_accounting.outcome_from_status(status)
                    if outcome_accounting == "full" or outcome != "ok":
                        ledger.note_outcome(server_name, req.tenant, outcome)
                        if req.priority is not None:
                            m["tpustack_qos_requests_total"].labels(
                                server=server_name, priority=req.priority,
                                outcome=outcome).inc()
                obs_accounting.current_tenant.reset(tenant_token)
                if req.span is not None:
                    obs_trace.current_span.reset(span_token)
                    req.span.set_attribute("http.status", status)
                    req.span.end(status="error" if status >= 500 else "ok")
                obs_trace.current_request_id.reset(rid_token)
            if reply is not None:
                req.send(reply)

        return instrumented

    return wrap


def handler_class(routes: Routes, dispatch: Callable[[Request], None],
                  max_body: int = 16 << 20):
    """The ``BaseHTTPRequestHandler`` subclass serving ``routes`` through
    ``dispatch`` (an :func:`instrument`-wrapped chain)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _serve(self, method: str, body: bytes) -> None:
            url = urllib.parse.urlsplit(self.path)
            endpoint, fn, params = routes.match(method, url.path)
            req = Request(self, method, url.path, urllib.parse.parse_qs(url.query),
                          self.headers, body, endpoint, fn, params)
            try:
                dispatch(req)
            except (BrokenPipeError, ConnectionResetError, socket.timeout):
                self.close_connection = True  # the client went away mid-reply

        def do_GET(self):  # noqa: N802 - stdlib contract
            self._serve("GET", b"")

        def do_POST(self):  # noqa: N802 - stdlib contract
            n = int(self.headers.get("Content-Length") or 0)
            if n > max_body:
                body = json.dumps({"error": "body too large"}).encode()
                self.send_response(413)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)
                self.close_connection = True
                return
            self._serve("POST", self.rfile.read(n))

        def log_message(self, fmt, *args):  # access log off, as in the JAX servers
            pass

    return Handler


def add_metrics_route(routes: Routes, registry: Optional[Registry] = None) -> None:
    """``GET /metrics``: the Prometheus text exposition of ``registry``."""
    reg = registry or REGISTRY
    routes.add_get("/metrics",
                   lambda req: (200, {"Content-Type": CONTENT_TYPE}, reg.render().encode()))


def add_debug_trace_routes(routes: Routes, tracer: Optional[obs_trace.Tracer] = None) -> None:
    """``GET /debug/traces`` (recent + slowest + kept summaries) and
    ``GET /debug/traces/{trace_id}`` (flat spans plus the nested tree)."""
    tr = tracer if tracer is not None else obs_trace.TRACER

    def get_trace(req: Request) -> Reply:
        record = tr.get(req.params["trace_id"])
        if record is None:
            return json_reply(404, {"error": "trace not found (evicted or never finalized)"})
        return json_reply(200, record)

    routes.add_get("/debug/traces", lambda req: json_reply(200, tr.summaries()))
    routes.add_get("/debug/traces/{trace_id}", get_trace)


def add_debug_flight_routes(routes: Routes, recorder) -> None:
    """``GET /debug/flight``: the recorder's recent ring and windowed
    aggregates (``?window=<s>`` bounds the aggregate window, ``?n=<records>``
    the ring slice)."""

    def flight_view(req: Request) -> Reply:
        def num(name, cast):
            try:
                v = cast(req.arg(name))
                return v if v > 0 else None
            except (TypeError, ValueError):
                return None

        return json_reply(200, recorder.snapshot(window_s=num("window", float),
                                                 n=num("n", int)))

    routes.add_get("/debug/flight", flight_view)


def add_debug_tenant_routes(routes: Routes, ledger=None, qos=None) -> None:
    """``GET /debug/tenants``: the tenant ledger's exact per-tenant accounts
    (tokens, chip / KV-block / queue seconds, outcomes, goodput), with a
    ``qos`` section (live bucket levels and ETAs per policy tenant, the
    shed / preempt / throttle counters) when a QoS policy is attached."""
    led = ledger if ledger is not None else obs_accounting.LEDGER

    def tenants_view(req: Request) -> Reply:
        payload = led.snapshot()
        payload["qos"] = qos.snapshot() if qos is not None else {"enabled": False}
        payload["kv_working_set"] = {"enabled": False}
        return json_reply(200, payload)

    routes.add_get("/debug/tenants", tenants_view)
