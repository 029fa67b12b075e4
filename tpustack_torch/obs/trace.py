"""Request tracing: request-ids, phase timings, and distributed span trees.

The port's copy of ``tpustack/obs/trace.py``, the same contract:

- **Request-ids** — a ``contextvars.ContextVar`` the logging formatter
  (``tpustack_torch.utils.logging``) stamps on every line emitted under the
  request's context (``rid=``).  Each HTTP request is handled on its own
  thread; the long-lived engine threads serve many requests at once, so
  their lines carry the neutral ``-``.
- **:class:`Trace`** — flat phase spans feeding the
  ``tpustack_request_phase_latency_seconds`` histogram (aggregate view).
- **Distributed tracing** — span trees with W3C ``traceparent``
  propagation:

  * :class:`Span` — id/parent/attributes/events/status; explicit handles
    so engine threads (no contextvar inheritance) can parent correctly.
  * :class:`Tracer` — starts spans, collects each trace's spans as they
    end, and finalizes the trace into a bounded in-process store once
    every span has ended (so a worker thread finishing after the HTTP
    root — the graph server's accept-and-poll shape — still lands its
    spans in the same trace).
  * **Store** — three bounded views: a ring buffer of recent traces, the
    N slowest, and an always-keep buffer for traces that were slow
    (``TPUSTACK_TRACE_SLOW_S``, default 5 s) or errored.  Served by
    ``GET /debug/traces`` and ``GET /debug/traces/{trace_id}``
    (``tpustack_torch.obs.http``) on all three servers.
  * **Propagation** — clients send ``traceparent``
    (``00-<32hex trace>-<16hex span>-<2hex flags>``); the HTTP
    instrumentation extracts it so the client's trace id is the root of the
    server-side tree and one id follows client -> server -> engine.

Overhead posture: a span is one small object + two ``perf_counter`` reads;
health/metrics endpoints are not traced unless the caller sent a
``traceparent``, so the ring buffer holds real work.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

#: the rid of the HTTP request being handled in this context ("-" outside)
current_request_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "tpustack_request_id", default="-")


def new_request_id() -> str:
    """12-hex request id — short enough for log lines, unique enough for a
    single pod's lifetime (the scope a request-id has to be unique in)."""
    return uuid.uuid4().hex[:12]


class Trace:
    """Phase durations for one request, recorded as (name, seconds) with
    ``add(name, seconds)`` (phases measured elsewhere, e.g. the engine's
    prefill_s).  ``observe_into(histogram, **labels)`` flushes them into a
    labelled histogram family — the labels identify the server, the phase
    name becomes the ``phase`` label.

    This is the AGGREGATE view (histograms); :class:`Tracer` below is the
    per-request causal view (span trees).
    """

    __slots__ = ("spans",)

    def __init__(self):
        self.spans: List[Tuple[str, float]] = []

    def add(self, name: str, seconds: float) -> None:
        self.spans.append((name, max(0.0, float(seconds))))

    def observe_into(self, histogram, **labels) -> None:
        for name, dur in self.spans:
            histogram.labels(**labels, phase=name).observe(dur)


# ===================================================================== spans

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

#: hard cap on events per span — a deep decode must not grow a span
#: unboundedly (overflow is counted in the ``events_dropped`` attribute)
MAX_EVENTS_PER_SPAN = 64


class SpanContext(NamedTuple):
    """The propagatable identity of a span: what ``traceparent`` carries
    and what engine threads hold to parent their spans correctly."""

    trace_id: str  # 32 lowercase hex
    span_id: str   # 16 lowercase hex


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """W3C trace-context ``traceparent`` → :class:`SpanContext`, or None
    for absent/malformed headers (malformed propagation must never fail a
    request — the trace just restarts here)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
    if version == "ff" or set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # spec: all-zero ids and version 0xff are invalid
    return SpanContext(trace_id, span_id)


def format_traceparent(ctx: SpanContext) -> str:
    """Version 00, sampled flag set — every trace we originate is recorded."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


#: the span of the HTTP request being handled in this context (None outside;
#: engine and worker threads see None and use explicitly passed SpanContexts)
current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("tpustack_span", default=None)


class Span:
    """One timed operation in a trace.  Created via :meth:`Tracer.start_span`
    (never directly); thread-safe enough for the stack's usage — one owner
    thread mutates a span, the tracer lock guards the end/finalize edge."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start_unix",
                 "duration_s", "attrs", "events", "status", "_t0", "_tracer",
                 "_ended", "_dropped_events")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None):
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.start_unix = time.time()
        self.duration_s: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.events: List[Dict[str, Any]] = []
        self.status = "ok"
        self._t0 = time.perf_counter()
        self._tracer = tracer
        self._ended = False
        self._dropped_events = 0

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        """Timestamped annotation (offset seconds from span start) — the
        span-tree analog of a log line: prefix-cache hit/miss, shed,
        deadline-exceeded, per-wave token deliveries."""
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            self._dropped_events += 1
            self.attrs["events_dropped"] = self._dropped_events
            return
        ev = {"name": name, "t_offset_s": round(
            time.perf_counter() - self._t0, 6)}
        ev.update(attrs)
        self.events.append(ev)

    def end(self, status: Optional[str] = None) -> None:
        """Idempotent; a span ended twice keeps its first verdict."""
        if self._ended:
            return
        self._ended = True
        if status is not None:
            self.status = status
        self.duration_s = time.perf_counter() - self._t0
        self._tracer._span_ended(self)

    # context-manager sugar: ``with tracer.span("x"): ...``
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.set_attribute("error", f"{exc_type.__name__}: {exc}")
            self.end(status="error")
        else:
            self.end()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_unix": round(self.start_unix, 6),
            "duration_s": (round(self.duration_s, 6)
                           if self.duration_s is not None else None),
            "status": self.status,
            "attrs": self.attrs,
            "events": self.events,
        }


class _LiveTrace:
    """Book-keeping for a trace with unfinished spans."""

    __slots__ = ("spans", "open", "started_at")

    def __init__(self):
        self.spans: List[Span] = []
        self.open = 0
        self.started_at = time.time()


ParentLike = Union[None, Span, SpanContext]
_UNSET = object()


class Tracer:
    """Span factory + bounded in-process trace store.

    A trace finalizes into the store when its last open span ends —
    tolerant of spans outliving the root (the graph worker publishes
    minutes after ``POST /prompt`` returned).  Traces whose spans never
    end (a crashed engine thread) are evicted from the live table at
    ``max_live`` and stored as-is with status ``incomplete``.

    Store views (all bounded):

    - ``recent``  — ring buffer, newest-first (``TPUSTACK_TRACE_BUFFER``).
    - ``slowest`` — the N slowest seen since process start.
    - ``kept``    — always-keep for slow (≥ ``TPUSTACK_TRACE_SLOW_S``
      seconds) or errored traces, so the interesting traces survive the
      ring buffer's churn under healthy high-QPS traffic.
    """

    def __init__(self, *, max_recent: Optional[int] = None,
                 max_slowest: int = 32, max_kept: int = 64,
                 max_live: int = 256, slow_s: Optional[float] = None,
                 env=None):
        from tpustack_torch.utils import knobs

        if max_recent is None:
            max_recent = knobs.get_int("TPUSTACK_TRACE_BUFFER", env=env)
        if slow_s is None:
            slow_s = knobs.get_float("TPUSTACK_TRACE_SLOW_S", env=env)
        self.slow_s = slow_s
        self.max_recent = max(1, max_recent)
        self.max_slowest = max(1, max_slowest)
        self.max_kept = max(1, max_kept)
        self.max_live = max(1, max_live)
        self._lock = threading.Lock()
        self._live: Dict[str, _LiveTrace] = {}
        self._recent: deque = deque(maxlen=self.max_recent)
        self._slowest: List[Dict[str, Any]] = []
        self._kept: deque = deque(maxlen=self.max_kept)
        #: kind → count of finalized traces (rendered by /debug/traces and,
        #: when a registry wires it, the tpustack_traces_captured_total
        #: counter); kinds: ok | slow | error | incomplete
        self.captured: Dict[str, int] = {}
        self._on_capture = None

    def wire_metrics(self, registry=None) -> None:
        """Count finalized traces into ``tpustack_traces_captured_total``
        (catalog-declared).  Separate from __init__ so constructing a Tracer
        never forces a registry."""
        from tpustack_torch.obs import catalog as obs_catalog

        counter = obs_catalog.build(registry)["tpustack_traces_captured_total"]
        self._on_capture = lambda kind: counter.labels(kind=kind).inc()

    # ------------------------------------------------------------- creation
    def start_span(self, name: str, parent: ParentLike = _UNSET,
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Start a span.

        ``parent`` resolution: an explicit :class:`Span`/:class:`SpanContext`
        parents under it (same trace); ``None`` forces a new root trace;
        omitted → the context's current span if any, else a new root.  A
        :class:`SpanContext` parsed from an inbound ``traceparent`` makes
        the new span this process's root of the CLIENT's trace."""
        if parent is _UNSET:
            parent = current_span.get()
        if parent is None:
            trace_id, parent_id = new_trace_id(), None
        elif isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:  # SpanContext (possibly remote)
            trace_id, parent_id = parent.trace_id, parent.span_id
        span = Span(self, name, trace_id, parent_id, attrs)
        with self._lock:
            live = self._live.get(trace_id)
            if live is None:
                live = self._live[trace_id] = _LiveTrace()
                self._evict_live_locked()
            live.spans.append(span)
            live.open += 1
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent: ParentLike = _UNSET, **attrs: Any):
        """``with tracer.span("detokenize"): ...`` — starts a span, makes it
        the context's current span (children nest), ends it on exit with
        error status if the block raised."""
        sp = self.start_span(name, parent=parent, attrs=attrs or None)
        token = current_span.set(sp)
        try:
            with sp:
                yield sp
        finally:
            current_span.reset(token)

    @contextlib.contextmanager
    def span_if_active(self, name: str, **attrs: Any):
        """Like :meth:`span`, but a no-op when the context carries no
        current span — a phase helper called outside any traced request
        (tests, CLI paths) must not mint one-span junk traces."""
        if current_span.get() is None:
            yield None
            return
        with self.span(name, **attrs) as sp:
            yield sp

    def add_span(self, name: str, parent: ParentLike, start_unix: float,
                 duration_s: float, attrs: Optional[Dict[str, Any]] = None,
                 status: str = "ok") -> Span:
        """Record an already-finished span with explicit wall-clock timing —
        for phases measured elsewhere (the SD micro-batcher times a whole
        fused batch, then writes each rider's spans from the shared
        timings)."""
        sp = self.start_span(name, parent=parent, attrs=attrs)
        sp.start_unix = float(start_unix)
        sp._ended = True
        sp.status = status
        sp.duration_s = max(0.0, float(duration_s))
        with self._lock:
            self._close_span_locked(sp)
        return sp

    # ----------------------------------------------------------- finalizing
    def _span_ended(self, span: Span) -> None:
        with self._lock:
            self._close_span_locked(span)

    def _close_span_locked(self, span: Span) -> None:
        live = self._live.get(span.trace_id)
        if live is None:
            return  # trace already finalized/evicted; late span is dropped
        live.open -= 1
        if live.open <= 0:
            del self._live[span.trace_id]
            self._finalize_locked(span.trace_id, live.spans)

    def _evict_live_locked(self) -> None:
        while len(self._live) > self.max_live:
            tid = next(iter(self._live))  # oldest insertion
            live = self._live.pop(tid)
            self._finalize_locked(tid, live.spans, incomplete=True)

    def _find_record_locked(self, trace_id: str) -> Optional[Dict[str, Any]]:
        for pool in (self._kept, self._slowest, self._recent):
            for r in pool:
                if r["trace_id"] == trace_id:
                    return r
        return None

    def _finalize_locked(self, trace_id: str, spans: List[Span],
                         incomplete: bool = False) -> None:
        existing = self._find_record_locked(trace_id)
        if existing is not None:
            # late spans: the trace already finalized (a 504'd request's
            # root ended while engine/batch spans were still coming) —
            # MERGE into the stored record instead of forking a duplicate
            # trace under the same id.  The record dict is shared by
            # reference across the store views, so mutating it updates all
            # of them; capture counters are NOT incremented again.
            existing["spans"].extend(s.to_dict() for s in spans)
            existing["n_spans"] = len(existing["spans"])
            end = max(s["start_unix"] + (s["duration_s"] or 0.0)
                      for s in existing["spans"])
            existing["duration_s"] = round(
                max(0.0, end - existing["start_unix"]), 6)
            if incomplete or any(s.status == "error" for s in spans):
                existing["status"] = "error"
            return
        root = spans[0]
        end = max((s.start_unix + (s.duration_s or 0.0)) for s in spans)
        duration = max(0.0, end - root.start_unix)
        error = incomplete or any(s.status == "error" for s in spans)
        slow = duration >= self.slow_s
        record = {
            "trace_id": trace_id,
            "name": root.name,
            "start_unix": round(root.start_unix, 6),
            "duration_s": round(duration, 6),
            "status": ("incomplete" if incomplete
                       else "error" if error else "ok"),
            "slow": slow,
            "n_spans": len(spans),
            "spans": [s.to_dict() for s in spans],
        }
        kind = record["status"] if record["status"] != "ok" else (
            "slow" if slow else "ok")
        self.captured[kind] = self.captured.get(kind, 0) + 1
        if self._on_capture is not None:
            try:
                self._on_capture(kind)
            except Exception:
                pass  # a metrics hiccup must never lose the trace
        self._recent.append(record)
        if slow or error:
            self._kept.append(record)
        self._slowest.append(record)
        self._slowest.sort(key=lambda r: -r["duration_s"])
        del self._slowest[self.max_slowest:]

    # ------------------------------------------------------------- querying
    @staticmethod
    def _summary(record: Dict[str, Any]) -> Dict[str, Any]:
        return {k: record[k] for k in ("trace_id", "name", "start_unix",
                                       "duration_s", "status", "slow",
                                       "n_spans")}

    def summaries(self) -> Dict[str, Any]:
        """The ``GET /debug/traces`` payload: recent (newest first), the
        slowest, and the always-keep buffer, as summaries."""
        with self._lock:
            return {
                "slow_threshold_s": self.slow_s,
                "captured": dict(self.captured),
                "recent": [self._summary(r) for r in reversed(self._recent)],
                "slowest": [self._summary(r) for r in self._slowest],
                "kept": [self._summary(r) for r in reversed(self._kept)],
            }

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Full record (flat spans + nested tree) for one trace, or None."""
        with self._lock:
            r = self._find_record_locked(trace_id)
            return dict(r, tree=_span_tree(r["spans"])) if r else None


def _span_tree(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Nest flat span dicts by parent link.  Spans whose parent is unknown
    locally (the client's ``traceparent`` span) are roots."""
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: List[Dict[str, Any]] = []
    for s in by_id.values():
        parent = by_id.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None:
            parent["children"].append(s)
        else:
            roots.append(s)
    return roots


#: process-wide default tracer — servers and the train loop share it the way
#: they share the default metrics REGISTRY; tests construct their own
TRACER = Tracer()
