"""Resilience layer shared by the port's three servers.

The port's copy of ``tpustack/serving/resilience.py``.  Kubernetes
inflicts failures on a single-node stack: rolling updates SIGTERM the pod
mid-decode, overload grows unbounded queues until the OOM killer wins, and
a wedged device dispatch leaves a pod Ready-but-dead forever.  This module
gives ``llm_server``, ``sd_server`` and ``graph_server`` one shared answer:

- **Graceful drain** — SIGTERM flips readiness to 503 and stops admitting
  work; in-flight requests finish at their natural wave/batch boundaries;
  the process exits 0 once idle or after ``TPUSTACK_DRAIN_TIMEOUT_S``.
- **Per-request deadlines** — ``TPUSTACK_REQUEST_TIMEOUT_S`` (body override
  ``timeout_s``); a request past its deadline is cancelled (its engine slot
  frees at the next chunk boundary via the existing ``cancelled()`` poll)
  and answered 504 with the phase it died in.
- **Bounded admission with backpressure** — ``TPUSTACK_MAX_QUEUE_DEPTH``
  caps waiting work; excess requests get 429 with a ``Retry-After``
  computed from the observed p50 service time scaled by queue depth, so
  clients back off proportionally to real load instead of hammering.
- **Watchdog** — a monitor thread flips liveness (``/healthz`` → 503) when
  there is in-flight work but no wave progress for ``TPUSTACK_WATCHDOG_S``,
  so Kubernetes restarts a pod whose TPU dispatch hung.
- **Deterministic fault injection** — ``TPUSTACK_FAULT_*`` env knobs insert
  a dispatch hang, a slow prefill, a one-shot transient device error, or a
  mid-request SIGTERM at exact dispatch/wave counts, so every behavior
  above is testable on the CPU.

Env knobs (all optional; defaults are production-shaped):

=============================== ======= ====================================
``TPUSTACK_DRAIN_TIMEOUT_S``    30      max seconds to wait for in-flight
                                        work after SIGTERM before exiting
``TPUSTACK_REQUEST_TIMEOUT_S``  600     default per-request deadline
                                        (0 disables; body ``timeout_s``
                                        overrides per request)
``TPUSTACK_MAX_QUEUE_DEPTH``    64      waiting-work cap before shedding
                                        with 429 (0 disables)
``TPUSTACK_WATCHDOG_S``         0       no-progress seconds before liveness
                                        flips (0 disables; set it above the
                                        worst first dispatch of a shape)
``TPUSTACK_FAULT_SLOW_PREFILL_S``   0   sleep injected before every device
                                        dispatch
``TPUSTACK_FAULT_DEVICE_ERROR_NTH`` 0   the Nth dispatch raises a one-shot
                                        :class:`InjectedDeviceError`
``TPUSTACK_FAULT_HANG_NTH``     0       the Nth dispatch hangs for
                                        ``TPUSTACK_FAULT_HANG_S`` (3600)
``TPUSTACK_FAULT_SIGTERM_AFTER``    0   begin drain after the Nth completed
                                        wave (mid-request SIGTERM)
=============================== ======= ====================================

The servers report *progress points* into the layer
(:meth:`ResilienceManager.progress`): ``"prefill"`` immediately before a
device dispatch (admission prefill for the LLM engine, the fused program
dispatch for sd/graph) and ``"wave"`` at each wave/batch boundary (chunk
fetch, batch completion, prompt dispatch).  Points both feed the watchdog
(a beat) and give the fault injector its deterministic hooks.

The JAX layer's aiohttp middleware becomes :meth:`ResilienceManager.middleware`,
a wrapper around the servers' ``http.server`` dispatch (the request and
reply types of :mod:`tpustack_torch.obs.http`).  With a multi-tenant QoS
policy (:class:`~tpustack_torch.serving.qos.QosPolicy`, on unless
``TPUSTACK_QOS=0``) the middleware resolves each work request's priority
class, a tenant in quota debt gets 429 with its own bucket's refill ETA as
``Retry-After`` (``X-Shed-Reason: quota``), and batch requests shed at
``batch_shed_ratio`` of ``TPUSTACK_MAX_QUEUE_DEPTH``, before interactive
ones; with ``qos=None`` admission is the QoS-free path, unchanged.
"""

from __future__ import annotations

import math
import os
import signal
import statistics
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from tpustack_torch.obs import catalog as obs_catalog
from tpustack_torch.obs.http import Reply, Request, json_reply
from tpustack_torch.serving import qos as qos_mod
from tpustack_torch.utils import get_logger, knobs

log = get_logger("serving.resilience")

#: drain states, exported as ``tpustack_serving_drain_state``
SERVING, DRAINING, DRAINED = 0, 1, 2
_STATE_NAMES = {SERVING: "serving", DRAINING: "draining", DRAINED: "drained"}


#: every reason a serving process refuses/fails work with a non-2xx, as
#: carried in the machine-readable ``X-Shed-Reason`` header the router
#: steers on.  ``quota`` is policy (the tenant's own budget — never
#: spilled to another replica); the rest are capacity/health signals a
#: router may route around.
SHED_REASONS = ("draining", "quota", "queue_depth", "out_of_kv_blocks",
                "deadline", "device_error", "watchdog", "busy",
                "no_backend")


def shed_headers(reason: str, retry_after=None) -> Dict[str, str]:
    """Headers for a shed/refusal response: the machine-readable
    ``X-Shed-Reason`` (one of :data:`SHED_REASONS`) plus ``Retry-After``
    when the caller has a hint.  EVERY non-2xx shed path on the three
    servers builds its headers here — the router's steering table reads
    this header, so a bare status is a contract violation (audited by
    tests/test_router.py)."""
    assert reason in SHED_REASONS, f"undeclared shed reason {reason!r}"
    headers = {"X-Shed-Reason": reason}
    if retry_after is not None:
        headers["Retry-After"] = str(retry_after)
    return headers


class InjectedDeviceError(RuntimeError):
    """The transient device error the fault injector raises at a dispatch
    point.  Handlers map it to 503 + ``Retry-After`` so clients retry —
    the same contract a real transient XLA/runtime error should get."""


class DeadlineExceeded(Exception):
    """A request blew its deadline; ``phase`` is where it died."""

    def __init__(self, phase: str):
        super().__init__(f"request deadline exceeded (phase={phase})")
        self.phase = phase


class FaultInjector:
    """Deterministic failure injection, keyed on dispatch/wave counts.

    All knobs are exact: "the Nth dispatch errors", not "errors with
    probability p" — tier-1 tests must reproduce byte-for-byte.  Counters
    are process-wide per injector instance and thread-safe (dispatch points
    fire from engine/executor threads)."""

    def __init__(self, env=None):
        self.slow_prefill_s = knobs.get_float("TPUSTACK_FAULT_SLOW_PREFILL_S",
                                              env=env)
        self.device_error_nth = knobs.get_int(
            "TPUSTACK_FAULT_DEVICE_ERROR_NTH", env=env)
        self.hang_nth = knobs.get_int("TPUSTACK_FAULT_HANG_NTH", env=env)
        self.hang_s = knobs.get_float("TPUSTACK_FAULT_HANG_S", env=env)
        self.sigterm_after = knobs.get_int("TPUSTACK_FAULT_SIGTERM_AFTER",
                                           env=env)
        #: set by the manager so an injected SIGTERM takes the exact code
        #: path the real signal handler takes; standalone default is a real
        #: kernel signal to our own pid
        self.sigterm_cb: Callable[[], None] = (
            lambda: os.kill(os.getpid(), signal.SIGTERM))
        #: metrics hook (kind -> counted); set by the manager
        self.on_inject: Optional[Callable[[str], None]] = None
        self._lock = threading.Lock()
        self.dispatches = 0  # guarded-by: _lock (writes)
        self.waves = 0  # guarded-by: _lock (writes)
        self._sigterm_fired = False  # guarded-by: _lock (writes)

    @property
    def active(self) -> bool:
        return bool(self.slow_prefill_s or self.device_error_nth
                    or self.hang_nth or self.sigterm_after)

    def _note(self, kind: str) -> None:
        log.warning("fault injected: %s (dispatch=%d wave=%d)", kind,
                    self.dispatches, self.waves)
        if self.on_inject is not None:
            self.on_inject(kind)

    def point(self, name: str) -> None:
        """Fire the faults registered for progress point ``name``.

        ``"prefill"`` (immediately before a device dispatch): slow-prefill
        sleep, then the counted one-shot device error / hang.  ``"wave"``
        (a wave/batch boundary passed): the counted mid-request SIGTERM.
        May sleep or raise — callers invoke it from worker threads, never
        the event loop."""
        if name == "prefill":
            with self._lock:
                self.dispatches += 1
                n = self.dispatches
            if self.slow_prefill_s > 0:
                self._note("slow_prefill")
                time.sleep(self.slow_prefill_s)
            if self.hang_nth and n == self.hang_nth:
                self._note("dispatch_hang")
                time.sleep(self.hang_s)
            if self.device_error_nth and n == self.device_error_nth:
                self._note("device_error")
                raise InjectedDeviceError(
                    f"injected transient device error at dispatch {n}")
        elif name == "wave":
            fire = False
            with self._lock:
                self.waves += 1
                if (self.sigterm_after and not self._sigterm_fired
                        and self.waves >= self.sigterm_after):
                    self._sigterm_fired = fire = True
            if fire:
                self._note("sigterm")
                self.sigterm_cb()


class ResilienceManager:
    """One per server process: drain state machine + watchdog + admission
    control + deadline bookkeeping, exported through the obs catalog.

    Servers construct it with callables describing their own queueing
    (``queue_depth``: requests waiting for capacity; ``extra_busy``:
    server-side work the HTTP in-flight counter cannot see, e.g. the graph
    worker's accepted-but-unfinished prompts) and wire three integration
    points: :meth:`middleware` around their dispatch (it gates the work
    endpoints), :meth:`progress` at dispatch/wave boundaries, and the
    ``/healthz``/``/readyz`` payload helpers."""

    def __init__(self, server: str, registry=None, *, concurrency: int = 1,
                 queue_depth: Optional[Callable[[], int]] = None,
                 extra_busy: Optional[Callable[[], bool]] = None,
                 on_exit: Optional[Callable[[int], None]] = None,
                 env=None, fault: Optional[FaultInjector] = None,
                 observe_http: bool = True,
                 expected_service_s: float = 1.0, qos=None):
        self.server = server
        # the QoS policy (serving.qos.QosPolicy): priority- and quota-aware
        # admission; None (TPUSTACK_QOS=0) keeps admission QoS-free
        self.qos = qos
        # accept-and-poll servers (graph /prompt answers in ~1ms while the
        # work runs minutes) pass observe_http=False and feed real
        # completion times via observe_service_time themselves — otherwise
        # Retry-After would be computed from the accept handler's wall time
        self._observe_http = observe_http
        # the Retry-After p50 until the first real observation: a cold
        # server shedding multi-minute work must not tell clients "retry in
        # seconds" before it has ever completed anything
        self.expected_service_s = max(0.001, expected_service_s)
        self.metrics = obs_catalog.build(registry)
        self.concurrency = max(1, concurrency)
        self.drain_timeout_s = knobs.get_float("TPUSTACK_DRAIN_TIMEOUT_S",
                                               env=env)
        # accept-and-poll servers (graph): keep serving reads for this long
        # AFTER the last accepted prompt publishes, so clients polling
        # /history can still fetch their results before the process exits
        self.drain_linger_s = knobs.get_float("TPUSTACK_DRAIN_LINGER_S",
                                              env=env)
        self.request_timeout_s = knobs.get_float("TPUSTACK_REQUEST_TIMEOUT_S",
                                                 env=env)
        self.max_queue_depth = knobs.get_int("TPUSTACK_MAX_QUEUE_DEPTH",
                                             env=env)
        self.watchdog_s = knobs.get_float("TPUSTACK_WATCHDOG_S", env=env)
        self.fault = fault if fault is not None else FaultInjector(env)
        self.fault.sigterm_cb = self.begin_drain
        self.fault.on_inject = (
            lambda kind: self.metrics["tpustack_faults_injected_total"]
            .labels(server=self.server, kind=kind).inc())
        self.on_exit = on_exit if on_exit is not None else self._default_exit
        self._queue_depth = queue_depth
        self._extra_busy = extra_busy
        self._lock = threading.Lock()
        # drain entry is guarded by a NON-BLOCKING one-shot, not self._lock:
        # the SIGTERM handler runs on the main thread between bytecodes and
        # may interrupt code that holds self._lock — a blocking acquire
        # there would deadlock that thread forever
        self._drain_once = threading.Lock()
        self._state = SERVING
        self._hung = False
        # reversible ADMIN drain (POST /admin/drain): readiness flips 503
        # + X-Shed-Reason: draining and admission sheds, but the process
        # keeps running and can undrain — the autoscaler's scale-down
        # choreography uses it to eject a victim from the router
        # authoritatively BEFORE any signal is sent, so in-flight work
        # finishes with no new arrivals racing it
        self._admin_drained = False  # guarded-by: _lock (writes)
        self._inflight = 0  # guarded-by: _lock (writes)
        self._last_beat = time.monotonic()
        # appended from worker/engine threads, median'd on handler threads —
        # iterating a deque during a concurrent append raises RuntimeError,
        # so BOTH sides hold the lock
        self._service_times: deque = deque(maxlen=64)  # guarded-by: _lock
        self._drain_thread: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        self._watchdog_thread: Optional[threading.Thread] = None
        self.metrics["tpustack_serving_drain_state"].labels(
            server=server).set(SERVING)
        if self.watchdog_s > 0:
            self._watchdog_thread = threading.Thread(
                target=self._watchdog_loop, daemon=True,
                name=f"tpustack-watchdog-{server}")
            self._watchdog_thread.start()

    # ------------------------------------------------------------- lifecycle
    @staticmethod
    def _default_exit(code: int) -> None:
        # os._exit: the drain already waited for in-flight work; a hung
        # flush/atexit must not let the pod outlive its grace period
        log.info("drain complete — exiting %d", code)
        os._exit(code)

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        if self._state == SERVING and self._admin_drained:
            return "draining"
        return _STATE_NAMES[self._state]

    @property
    def draining(self) -> bool:
        return self._state != SERVING or self._admin_drained

    @property
    def hung(self) -> bool:
        return self._hung

    @property
    def inflight(self) -> int:
        return self._inflight

    def install_signal_handlers(self) -> None:
        """SIGTERM → drain.  Only callable from the main thread (python
        signal contract); servers call it in ``main()``.

        The handler itself only sets an Event: python signal handlers run
        on the main thread between bytecodes, possibly mid-critical-
        section, so they must never take a lock another frame of the SAME
        thread could be holding (metrics, thread bookkeeping).  A
        pre-started arm thread does the actual drain work."""
        self._sigterm_event = threading.Event()
        threading.Thread(
            target=lambda: (self._sigterm_event.wait(), self.begin_drain()),
            daemon=True, name=f"tpustack-sigterm-arm-{self.server}").start()
        try:
            signal.signal(signal.SIGTERM,
                          lambda signum, frame: self._sigterm_event.set())
        except ValueError:  # pragma: no cover - non-main thread
            log.warning("not in main thread; SIGTERM drain handler not "
                        "installed")

    def busy(self) -> bool:
        if self._inflight > 0:
            return True
        if self._extra_busy is not None and self._extra_busy():
            return True
        return False

    def begin_drain(self) -> None:
        """Flip to DRAINING and start the drain waiter.  Thread-safe,
        idempotent, and NON-BLOCKING — callable from a signal handler (main
        thread, possibly mid-critical-section), the fault injector's wave
        hook (engine thread), or a test."""
        if not self._drain_once.acquire(blocking=False):
            return  # a drain is already running (or ran)
        self._state = DRAINING
        self._drain_thread = threading.Thread(
            target=self._drain_loop, daemon=True,
            name=f"tpustack-drain-{self.server}")
        self.metrics["tpustack_serving_drain_state"].labels(
            server=self.server).set(DRAINING)
        log.warning("SIGTERM/drain: refusing new work, waiting up to %.0fs "
                    "for in-flight requests", self.drain_timeout_s)
        self._drain_thread.start()

    def admin_drain(self) -> bool:
        """Reversible readiness-level drain (``POST /admin/drain``).

        Unlike :meth:`begin_drain` this never exits the process: it only
        makes ``draining`` true, which flips ``/readyz`` to 503 with
        ``X-Shed-Reason: draining`` and sheds new admissions.  The router
        treats the unready probe as authoritative and ejects the backend
        within one health tick, so in-flight work finishes with no new
        arrivals racing it.  The autoscaler's scale-down choreography
        drains a victim this way, waits for in-flight work, THEN sends
        SIGTERM (which runs the one-shot drain state machine and exits 0).

        Returns True if the call changed state (idempotent otherwise)."""
        with self._lock:
            was = self._admin_drained
            self._admin_drained = True
        if not was and self._state == SERVING:
            self.metrics["tpustack_serving_drain_state"].labels(
                server=self.server).set(DRAINING)
            log.warning("admin drain: readiness now 503/draining; process "
                        "stays up until undrained or signalled")
        return not was

    def admin_undrain(self) -> bool:
        """Undo :meth:`admin_drain`.  No-op if a real (signal) drain has
        started — that one is one-way by design.  Returns True if the call
        changed state."""
        with self._lock:
            was = self._admin_drained
            self._admin_drained = False
        if was and self._state == SERVING:
            self.metrics["tpustack_serving_drain_state"].labels(
                server=self.server).set(SERVING)
            log.warning("admin undrain: readiness restored")
        return was

    def _flight_dump(self, reason: str) -> None:
        """Post-mortem hook: dump every registered flight recorder so the
        engines' last waves survive the pod.  Best-effort — the dump must
        never block or break the drain/watchdog path it rides."""
        try:
            from tpustack_torch.obs import flight

            paths = flight.dump_all(reason)
            if paths:
                log.warning("flight dumps (%s): %s", reason,
                            ", ".join(paths))
        except Exception:
            log.debug("flight dump failed (reason=%s)", reason,
                      exc_info=True)

    def _drain_loop(self) -> None:
        deadline = time.monotonic() + self.drain_timeout_s
        while time.monotonic() < deadline and self.busy():
            time.sleep(0.02)
        clean = not self.busy()
        # in-flight work has finished (or timed out): the recorders now
        # hold the engines' ACTUAL final waves — dump before exiting
        self._flight_dump("drain")
        if clean and self.drain_linger_s > 0:
            # work is published but poll-based clients may not have fetched
            # it yet — keep the read surface (GET /history, /view) alive
            log.info("drain: lingering %.0fs for result pickup",
                     self.drain_linger_s)
            time.sleep(self.drain_linger_s)
        self._state = DRAINED
        self.metrics["tpustack_serving_drain_state"].labels(
            server=self.server).set(DRAINED)
        if clean:
            log.info("drained cleanly (no in-flight work)")
        else:
            log.error("drain timeout after %.0fs with work still in flight",
                      self.drain_timeout_s)
        self.on_exit(0)

    def close(self) -> None:
        """Stop the watchdog thread (tests construct many managers)."""
        self._watchdog_stop.set()
        if self._watchdog_thread is not None:
            self._watchdog_thread.join(timeout=2)

    # -------------------------------------------------------------- watchdog
    def beat(self) -> None:
        self._last_beat = time.monotonic()

    def progress(self, point: str) -> None:
        """Report a progress point from a worker thread: beats the
        watchdog, then fires any injected fault registered at that point
        (a hang injected here therefore starves subsequent beats — exactly
        the failure the watchdog exists to catch)."""
        self.beat()
        self.fault.point(point)

    def beat_age_s(self) -> float:
        return time.monotonic() - self._last_beat

    def _watchdog_loop(self) -> None:
        poll = max(0.01, min(1.0, self.watchdog_s / 4.0))
        while not self._watchdog_stop.wait(poll):
            if self._hung:
                continue
            if self.busy() and self.beat_age_s() > self.watchdog_s:
                self._hung = True
                self.metrics["tpustack_watchdog_stalls_total"].labels(
                    server=self.server).inc()
                log.error("watchdog: no wave progress for %.1fs with work "
                          "in flight — flipping liveness so kubernetes "
                          "restarts the pod", self.beat_age_s())
                # what WAS the engine doing?  The ring's tail — the waves
                # right before progress stopped — is the whole point of
                # the flight recorder; capture it before the pod restarts
                self._flight_dump("watchdog")

    # ---------------------------------------------------- admission control
    def queue_depth(self) -> int:
        if self._queue_depth is not None:
            return self._queue_depth()
        # default: work requests beyond serving capacity are "queued"
        return max(0, self._inflight - self.concurrency)

    def observe_service_time(self, seconds: float) -> None:
        with self._lock:
            self._service_times.append(seconds)

    def retry_after_s(self) -> int:
        """p50 service time scaled by how many service periods the current
        queue represents — a client retrying after this has a real chance
        of admission instead of re-shedding."""
        with self._lock:
            samples = list(self._service_times)
        p50 = (statistics.median(samples)
               if samples else self.expected_service_s)
        periods = (self.queue_depth() + 1) / self.concurrency
        ra = min(max(1, math.ceil(p50 * periods)), 120)
        self.metrics["tpustack_retry_after_seconds"].labels(
            server=self.server).set(ra)
        return ra

    def _shed_event(self, reason: str, retry_after: int) -> None:
        """Annotate the request's span (when one is open — the HTTP
        instrumentation wraps this layer) so a shed shows up in the trace a
        client retrieves with its own trace id, not just in counters."""
        from tpustack_torch.obs import trace as obs_trace

        span = obs_trace.current_span.get()
        if span is not None:
            span.add_event("shed", reason=reason, retry_after_s=retry_after)

    def admission_check(self, priority: Optional[str] = None,
                        tenant: Optional[str] = None) -> Optional[Reply]:
        """None to admit, or a ready 503 (draining) / 429 (quota debt or
        backpressure) reply carrying ``Retry-After``.  With QoS, a tenant in
        debt gets its own bucket's refill ETA, and ``priority`` picks the
        backpressure wall: batch sheds at ``batch_shed_ratio`` of the
        configured depth, interactive at the full depth."""
        if self.draining:
            self.metrics["tpustack_requests_shed_total"].labels(
                server=self.server, reason="draining").inc()
            ra = self.retry_after_s()
            self._shed_event("draining", ra)
            return json_reply(503, {"error": "server draining (shutting down)"},
                              shed_headers("draining", ra))
        if self.qos is not None and tenant is not None:
            eta = self.qos.quota_check(tenant)
            if eta is not None:
                self.metrics["tpustack_requests_shed_total"].labels(
                    server=self.server, reason="quota").inc()
                self.qos.note_quota_throttle(self.server, priority)
                ra = max(1, math.ceil(eta))
                self.metrics["tpustack_retry_after_seconds"].labels(
                    server=self.server).set(ra)
                self._shed_event("quota", ra)
                return json_reply(429, {"error": f"tenant {tenant!r} over quota",
                                        "reason": "quota"}, shed_headers("quota", ra))
        depth_limit = self.max_queue_depth
        if depth_limit and self.qos is not None and priority == "batch":
            # batch hits the wall earlier: under saturation the 429s land
            # on batch while interactive still has queue headroom
            depth_limit = self.qos.batch_shed_depth(self.max_queue_depth)
        if depth_limit and self.queue_depth() >= depth_limit:
            self.metrics["tpustack_requests_shed_total"].labels(
                server=self.server, reason="backpressure").inc()
            if self.qos is not None:
                self.qos.note_shed(self.server, priority)
            ra = self.retry_after_s()
            self._shed_event("backpressure", ra)
            return json_reply(429, {"error": "queue full, retry later"},
                              shed_headers("queue_depth", ra))
        return None

    def _resolve_priority(self, req: Request) -> Optional[str]:
        """The request's priority class (``X-Priority`` > body ``priority``
        from the instrumentation's cached parse > the tenant's policy
        default), set on ``req`` and its root span; None without QoS."""
        if self.qos is None:
            return None
        try:
            body = req.json()
        except (ValueError, UnicodeDecodeError):
            body = None  # the handler answers the malformed body
        priority = self.qos.resolve_priority(
            req.headers.get("X-Priority"),
            body.get("priority") if isinstance(body, dict) else None, req.tenant)
        req.priority = priority
        if req.span is not None:
            req.span.set_attribute("priority", priority)
        return priority

    def middleware(self, work_paths) -> Callable:
        """Wrap a dispatch function so POSTs to ``work_paths`` are gated:
        sheds under drain/backpressure, counts in-flight work (what drain
        waits on), and feeds completed-request wall time into the p50 the
        Retry-After hint is computed from.  Returns ``wrap(dispatch)``."""
        work_paths = frozenset(work_paths)

        def wrap(dispatch: Callable[[Request], Optional[Reply]]):
            def gated(req: Request) -> Optional[Reply]:
                if req.method != "POST" or req.endpoint not in work_paths:
                    return dispatch(req)
                priority = self._resolve_priority(req)
                # carried like the tenant: contextvar in the handler's
                # context, explicit fields across thread boundaries
                prio_token = (qos_mod.current_priority.set(priority)
                              if priority is not None else None)
                try:
                    shed = self.admission_check(priority=priority, tenant=req.tenant)
                    if shed is not None:
                        return shed
                    self.beat()  # arriving work arms the watchdog from "now"
                    with self._lock:
                        self._inflight += 1
                    t0 = time.perf_counter()
                    try:
                        reply = dispatch(req)
                        status = reply[0] if reply is not None else (req.status or 500)
                        if status < 400 and self._observe_http:
                            self.observe_service_time(time.perf_counter() - t0)
                        return reply
                    finally:
                        with self._lock:
                            self._inflight -= 1
                finally:
                    if prio_token is not None:
                        qos_mod.current_priority.reset(prio_token)

            return gated

        return wrap

    # -------------------------------------------------------------- deadlines
    def deadline(self, override=None) -> Optional[float]:
        """Effective per-request timeout in seconds (None = no deadline).
        ``override`` is the request-body value; 0/negative disables."""
        if override is not None:
            t = float(override)
        else:
            t = self.request_timeout_s
        return t if t > 0 else None

    def note_deadline(self, phase: str) -> None:
        self.metrics["tpustack_deadline_exceeded_total"].labels(
            server=self.server, phase=phase).inc()
        # handler-context callers (llm/sd) have the request span open —
        # annotate it; the graph worker thread has none and gets None
        from tpustack_torch.obs import trace as obs_trace

        span = obs_trace.current_span.get()
        if span is not None:
            span.add_event("deadline_exceeded", phase=phase)
        log.warning("request deadline exceeded in phase=%s", phase)

    def transient_error_response(self, exc: Exception) -> Reply:
        """503 + Retry-After for a transient device error — clients retry
        instead of treating the blip as a hard failure."""
        return json_reply(503, {"error": f"transient device error: {exc}"},
                          shed_headers("device_error", self.retry_after_s()))

    # ---------------------------------------------------------- health views
    def health_payload(self, extra: Optional[Dict] = None) -> Tuple[int, Dict]:
        """Liveness view: 503 only when the watchdog declared the process
        hung (draining pods stay live — restarting a draining pod would
        kill the in-flight work drain exists to protect)."""
        payload = {
            "ok": not self._hung,
            "state": self.state_name,
            "hung": self._hung,
            "inflight": self._inflight,
            "queue_depth": self.queue_depth(),
            "watchdog": {
                "enabled": self.watchdog_s > 0,
                "timeout_s": self.watchdog_s,
                "last_progress_age_s": round(self.beat_age_s(), 3),
            },
            "drain_timeout_s": self.drain_timeout_s,
            "request_timeout_s": self.request_timeout_s,
            "max_queue_depth": self.max_queue_depth,
        }
        if extra:
            payload.update(extra)
        return (503 if self._hung else 200), payload

    def ready_payload(self) -> Tuple[int, Dict]:
        """Readiness view: 503 the moment drain begins, so the endpoint
        drops out of Service rotation while in-flight work finishes."""
        ready = not self.draining and not self._hung
        return (200 if ready else 503), {"ready": ready,
                                         "state": self.state_name}

    def health_headers(self, status: int) -> Dict[str, str]:
        """Shed headers for a liveness response: a 503 here is always the
        watchdog (drain keeps liveness green on purpose)."""
        return shed_headers("watchdog") if status != 200 else {}

    def ready_headers(self, status: int) -> Dict[str, str]:
        """Shed headers for a readiness response: drain (with a real
        Retry-After) or a watchdog hang."""
        if status == 200:
            return {}
        if self.draining:
            return shed_headers("draining", self.retry_after_s())
        return shed_headers("watchdog")
