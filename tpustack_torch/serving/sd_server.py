"""SD1.5 REST API server for the PyTorch port, on the standard library.

The REST contract of ``tpustack/serving/sd_server.py`` (itself the reference
sd15-api app's), so ``scripts/batch_generate.py`` drives either server:

- ``GET /healthz``   -> ``{"ok": true, "state", "inflight", "queue_depth",
  ...}``, liveness (503 only when the watchdog fired)
- ``GET /readyz``    -> readiness (503 + ``X-Shed-Reason: draining`` while
  draining); the Deployment's probe
- ``GET /metrics``, ``GET /debug/traces[/{trace_id}]``, ``GET /debug/flight``,
  ``GET /debug/tenants``
- ``GET /``          -> HTML preview of the last image
- ``GET /last``      -> last PNG, or 404 before the first image
- ``POST /generate`` -> PNG + ``X-Gen-Time: <sec>s``; body ``{prompt,
  steps=30, guidance_scale=7.5, seed, width=512, height=512,
  negative_prompt, timeout_s}``; 400 on an empty prompt, a bad size or no
  steps, 422 on a malformed body, 429 past ``TPUSTACK_MAX_QUEUE_DEPTH``,
  503 while draining, 504 past the deadline (``phase`` ``queued`` when the
  request was still in its micro-batch window, which then never pays for
  it, ``denoise`` once dispatched), 500 when the pipeline fails.

``http.server.ThreadingHTTPServer`` serves each request on its own thread.
A micro-batcher groups concurrent requests with the same ``(steps, guidance,
width, height)``: a group's flusher thread waits ``SD15_BATCH_WINDOW_MS``
(default 15) for company, a group reaching ``SD15_MAX_BATCH`` (default 1)
goes at once, and one ``SD15Pipeline.generate`` call serves the whole group.
Dispatch is serialised under one lock.  Batches are not padded to powers of
two as the JAX server's are: eager PyTorch has no compiled signatures whose
number padding would bound.  The resilience layer (``serving.resilience``)
is the JAX server's: SIGTERM drains (the running micro-batch finishes, new
work gets 503, the process exits 0), deadlines, 429 backpressure, the
watchdog and the ``TPUSTACK_FAULT_*`` knobs.  Tenants and QoS, as in the
JAX server: each image's queue-seconds and its share of its fused batch's
denoise+VAE seconds are charged to its tenant, and with QoS on a tenant in
quota debt gets 429 with its bucket's refill ETA and batch requests shed
before interactive ones.

Env: ``PORT`` (8000), ``SD15_PRESET`` (``sd15`` | ``tiny``), ``SD15_DEVICE``
(default the first GPU; ``cpu`` to run on the CPU; no GPU and no such
request raises), ``SD15_MAX_BATCH``, ``SD15_BATCH_WINDOW_MS``,
``SD15_TOKENIZER_DIR``.  Weights are drawn from seed 0, as the JAX server's
are without a checkpoint; ``MODEL_DIR`` (loading a diffusers checkpoint) is
not supported yet and raises.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from tpustack_torch.obs import accounting as obs_accounting
from tpustack_torch.obs import catalog as obs_catalog
from tpustack_torch.obs import device as obs_device
from tpustack_torch.obs import flight as obs_flight
from tpustack_torch.obs import http as obs_http
from tpustack_torch.obs import trace as obs_trace
from tpustack_torch.obs.http import Request, json_reply
from tpustack_torch.serving import qos as qos_mod
from tpustack_torch.serving.resilience import (DeadlineExceeded, InjectedDeviceError,
                                               ResilienceManager, shed_headers)
from tpustack_torch.utils import get_logger
from tpustack_torch.utils.image import array_to_png

log = get_logger("serving.sd_server")

# request fields: name -> (accepted types, default)
_FIELDS = {
    "prompt": ((str,), None),
    "steps": ((int,), 30),
    "guidance_scale": ((int, float), 7.5),
    "seed": ((int,), None),
    "width": ((int,), 512),
    "height": ((int,), 512),
    "negative_prompt": ((str,), ""),
}


class BadRequest(ValueError):
    """A body that does not match the request schema (HTTP 422)."""


def parse_request(body: bytes) -> dict:
    """Validate a ``/generate`` body against the schema of the JAX server's
    ``GenReq``: ``prompt`` is required, ``null`` takes a field's default,
    unknown fields are ignored, and a wrong type raises :class:`BadRequest`."""
    try:
        data = json.loads(body or b"null")
    except (ValueError, UnicodeDecodeError) as e:
        raise BadRequest(f"body is not JSON: {e}") from e
    return validate_request(data)


def validate_request(data) -> dict:
    """:func:`parse_request` on an already parsed body."""
    if not isinstance(data, dict):
        raise BadRequest("body must be a JSON object")
    if "prompt" not in data:
        raise BadRequest("prompt: field required")
    out = {}
    for name, (types, default) in _FIELDS.items():
        val = data.get(name)
        if val is None:
            if name == "prompt":
                raise BadRequest("prompt: field required")
            val = default
        elif isinstance(val, bool) or not isinstance(val, types):
            raise BadRequest(f"{name}: expected {' or '.join(t.__name__ for t in types)}")
        out[name] = val
    out["guidance_scale"] = float(out["guidance_scale"])
    return out


@dataclasses.dataclass(eq=False)  # identity: an abandoned rider leaves its group by itself
class _Pending:
    prompt: str
    negative: str
    seed: Optional[int]
    span_ctx: Optional[obs_trace.SpanContext] = None
    # tenant and QoS priority, captured in the handler's context: the batch
    # thread serves many riders, each charged its share
    tenant: Optional[str] = None
    priority: Optional[str] = None
    t_enqueue: float = dataclasses.field(default_factory=time.perf_counter)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    image: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


@dataclasses.dataclass
class _Group:
    reqs: List[_Pending] = dataclasses.field(default_factory=list)
    closed: bool = False


class SDServer:
    """Micro-batching front of one :class:`SD15Pipeline`."""

    def __init__(self, pipeline=None, *, batch_window_ms: Optional[float] = None,
                 max_batch: Optional[int] = None, registry=None, tracer=None):
        self._registry = registry
        self.metrics = obs_catalog.build(registry)
        obs_device.install(registry)
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        # tenant ledger (process-wide on the default registry) and the QoS
        # policy, whose buckets the ledger's measured charges drive; a
        # malformed TPUSTACK_QOS_POLICY raises here
        self.ledger = obs_accounting.for_registry(registry)
        self.qos = qos_mod.QosPolicy.from_env(registry=registry)
        if self.qos is not None:
            self.ledger.add_listener(self.qos.on_ledger_charge)
        self.pipe = pipeline if pipeline is not None else self._pipeline_from_env()
        if batch_window_ms is None:
            batch_window_ms = float(os.environ.get("SD15_BATCH_WINDOW_MS", "15"))
        if max_batch is None:
            max_batch = int(os.environ.get("SD15_MAX_BATCH", "0") or 0) or 1
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.batch_window_s = batch_window_ms / 1e3
        self.max_batch = max_batch
        self._cv = threading.Condition()
        self._pending: Dict[tuple, _Group] = {}   # guarded by _cv
        self._dispatch_lock = threading.Lock()     # one pipeline call at a time
        self._last_image: Optional[bytes] = None
        # (batch size, seconds) of the most recent pipeline dispatches, in order
        self.batch_log = collections.deque(maxlen=1024)
        # drain on SIGTERM, deadlines, 429 backpressure, the watchdog and the
        # fault hooks; queue depth is the manager's default (work requests
        # in flight beyond one batch)
        self.resilience = ResilienceManager("sd", registry, concurrency=self.max_batch,
                                            expected_service_s=5.0, qos=self.qos)
        self.flight = obs_flight.register(obs_flight.FlightRecorder(
            "sd", meta={"max_batch": self.max_batch}))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _pipeline_from_env():
        from tpustack_torch.models.sd15 import SD15Config, SD15Pipeline

        if os.environ.get("MODEL_DIR"):
            raise NotImplementedError(
                "MODEL_DIR is not supported yet by the PyTorch port: it serves "
                "weights drawn from seed 0; loading a diffusers checkpoint "
                "needs a safetensors reader the port does not have yet")
        preset = os.environ.get("SD15_PRESET", "sd15")
        if preset not in ("sd15", "tiny"):
            raise ValueError(f"SD15_PRESET must be sd15 or tiny, got {preset!r}")
        cfg = SD15Config.tiny() if preset == "tiny" else SD15Config.sd15()
        return SD15Pipeline(cfg, device=os.environ.get("SD15_DEVICE") or None, seed=0)

    # ------------------------------------------------------- micro-batcher
    def submit(self, key: tuple, prompt: str, negative: str, seed: Optional[int],
               deadline_s: Optional[float] = None) -> np.ndarray:
        """Queue one image and block until its batch has run; returns the
        ``[H, W, 3]`` uint8 image or raises the batch's error.  Past
        ``deadline_s`` raises :class:`DeadlineExceeded`: ``queued`` when the
        request was still in its group's window (it leaves the group, so
        the batch never pays for it), ``denoise`` once dispatched."""
        span = obs_trace.current_span.get()
        p = _Pending(prompt, negative, seed, span_ctx=span.context if span else None,
                     tenant=obs_accounting.current_tenant.get(),
                     priority=qos_mod.current_priority.get() if self.qos is not None else None)
        with self._cv:
            group = self._pending.get(key)
            if group is None:
                group = self._pending[key] = _Group()
                threading.Thread(target=self._flush, args=(key, group), daemon=True,
                                 name="sd-batch-window").start()
            group.reqs.append(p)
            if len(group.reqs) >= self.max_batch:  # full: close it, wake its flusher
                self._close(key, group)
            self._set_queue_depth()
        if not p.done.wait(deadline_s):
            with self._cv:
                queued = not group.closed and p in group.reqs
                if queued:
                    group.reqs.remove(p)
                    self._set_queue_depth()
            raise DeadlineExceeded("queued" if queued else "denoise")
        if p.error is not None:
            raise p.error
        return p.image

    def _close(self, key: tuple, group: _Group) -> None:
        """(under ``_cv``) No rider joins ``group`` any more."""
        group.closed = True
        if self._pending.get(key) is group:
            del self._pending[key]
        self._cv.notify_all()

    def _set_queue_depth(self) -> None:
        """(under ``_cv``)"""
        self.metrics["tpustack_sd_queue_depth"].set(
            sum(len(g.reqs) for g in self._pending.values()))

    def _flush(self, key: tuple, group: _Group) -> None:
        """A group's window: wait for company until the window ends or the
        group fills, then run what is left of it (nothing, when every rider
        gave up)."""
        deadline = time.monotonic() + self.batch_window_s
        with self._cv:
            while not group.closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._close(key, group)
                    break
                self._cv.wait(left)
            batch = list(group.reqs)
            self._set_queue_depth()
        if batch:
            self._run_batch(key, batch)

    def _run_batch(self, key: tuple, batch: List[_Pending]) -> None:
        steps, guidance, width, height = key
        if len(batch) > 1:
            log.info("Micro-batch: %d requests in one dispatch", len(batch))
        try:
            with self._dispatch_lock:
                t_start, t_unix = time.perf_counter(), time.time()
                self.resilience.progress("prefill")  # watchdog beat + fault point
                imgs, secs = self.pipe.generate(
                    [r.prompt for r in batch], steps=steps, guidance_scale=guidance,
                    seed=[r.seed for r in batch], width=width, height=height,
                    negative_prompt=[r.negative for r in batch])
                self.batch_log.append((len(batch), secs))
        except Exception as e:  # every rider gets the batch's error
            for r in batch:
                r.error = e
                r.done.set()
            return
        self.metrics["tpustack_sd_batch_size_images"].observe(len(batch))
        # the riders' tenant split rides the record and the chip-seconds
        # charge reads it back: /debug/flight and /debug/tenants agree
        tenants: Dict[str, int] = {}
        for r in batch:
            if r.tenant is not None:
                tenants[r.tenant] = tenants.get(r.tenant, 0) + 1
        rec = dict(batch=len(batch), steps=steps, width=width, height=height,
                   denoise_vae_s=round(secs, 6))
        if tenants:
            rec["tenants"] = tenants
        self.flight.record("batch", **rec)
        self.ledger.charge_flight_wave("sd", rec, seconds_key="denoise_vae_s")
        phases = self.metrics["tpustack_request_phase_latency_seconds"]
        for r, img in zip(batch, imgs):
            wait_s = max(0.0, t_start - r.t_enqueue)
            phases.labels(server="sd", phase="queue_wait").observe(wait_s)
            self.ledger.charge_queue_seconds("sd", r.tenant, wait_s)
            if self.qos is not None:
                self.qos.observe_queue_wait("sd", r.priority, wait_s)
            phases.labels(server="sd", phase="denoise_vae").observe(secs)
            if r.span_ctx is not None:  # each rider's share of the fused batch
                self.tracer.add_span("denoise_vae", r.span_ctx, t_unix, secs,
                                     attrs={"batch": len(batch)})
            r.image = img
            r.done.set()
        # a batch boundary: the fault injector's mid-request SIGTERM point
        self.resilience.progress("wave")

    # ------------------------------------------------------------ handlers
    def generate(self, req: Request):
        """``POST /generate`` -> (status, headers, body bytes)."""
        try:
            try:
                data = req.json() if req.body else None  # the instrumentation's parse
            except (ValueError, UnicodeDecodeError) as e:
                raise BadRequest(f"body is not JSON: {e}") from e
            body = validate_request(data)
            timeout = data.get("timeout_s")
            if timeout is not None and (isinstance(timeout, bool)
                                        or not isinstance(timeout, (int, float))):
                raise BadRequest("timeout_s: expected a number")
            deadline_s = self.resilience.deadline(timeout)
        except BadRequest as e:
            return json_reply(422, {"detail": str(e)})
        if not body["prompt"].strip():
            return json_reply(400, {"detail": "prompt is required"})
        try:
            self.pipe.check_request(body["steps"], body["width"], body["height"])
        except ValueError as e:  # e.g. size not a multiple of the UNet factor
            return json_reply(400, {"detail": str(e)})
        t0 = time.time()
        log.info("Generating prompt='%s' steps=%s guidance=%.2f seed=%s size=%sx%s",
                 body["prompt"], body["steps"], body["guidance_scale"],
                 "auto" if body["seed"] is None else body["seed"], body["width"], body["height"])
        key = (body["steps"], body["guidance_scale"], body["width"], body["height"])
        # a pipeline failure is the server's fault: the handler answers 500
        try:
            img = self.submit(key, body["prompt"], body["negative_prompt"], body["seed"],
                              deadline_s)
        except DeadlineExceeded as e:
            self.resilience.note_deadline(e.phase)
            return json_reply(504, {"detail": str(e), "phase": e.phase},
                              shed_headers("deadline"))
        except InjectedDeviceError as e:
            return self.resilience.transient_error_response(e)
        t_png = time.perf_counter()
        with self.tracer.span_if_active("png_encode"):
            png = array_to_png(img)
        self.metrics["tpustack_request_phase_latency_seconds"].labels(
            server="sd", phase="png_encode").observe(time.perf_counter() - t_png)
        self.metrics["tpustack_sd_images_total"].inc()
        latency = time.time() - t0
        log.info("Completed generation in %.2fs", latency)
        self._last_image = png
        return 200, {"Content-Type": "image/png", "X-Gen-Time": f"{latency:.2f}s"}, png

    def healthz(self, req: Request):
        """Liveness + server state (503 only on a watchdog-declared hang;
        the ``ok`` field keeps the reference configmap's response shape)."""
        status, payload = self.resilience.health_payload(extra={
            "max_batch": self.max_batch, "batch_window_ms": self.batch_window_s * 1e3,
            "device": str(self.pipe.device)})
        return json_reply(status, payload, self.resilience.health_headers(status))

    def readyz(self, req: Request):
        status, payload = self.resilience.ready_payload()
        return json_reply(status, payload, self.resilience.ready_headers(status))

    def index(self, req: Request):
        if self._last_image is None:
            html = ("<h1>SD1.5 API</h1><p>No image generated yet. "
                    "POST /generate to create one.</p>")
        else:
            preview = base64.b64encode(self._last_image).decode("ascii")
            html = f"""
        <html>
          <head><title>SD1.5 Demo</title></head>
          <body style="background:#0b0b0f;color:#f0f0f0;font-family:sans-serif;">
            <h1>Latest image</h1>
            <img src="data:image/png;base64,{preview}" alt="latest image"
                 style="max-width:90vw;height:auto;border:3px solid #333;border-radius:8px;" />
            <p>POST <code>/generate</code> with a prompt to update this preview.</p>
          </body>
        </html>
        """
        return 200, {"Content-Type": "text/html; charset=utf-8"}, html.encode()

    def last(self, req: Request):
        if self._last_image is None:
            return json_reply(404, {"detail": "No image generated yet"})
        return 200, {"Content-Type": "image/png"}, self._last_image

    # ---------------------------------------------------------------- http
    def handler_class(self):
        """The request handler: routes behind the resilience gate and the
        HTTP instrumentation."""
        routes = obs_http.Routes()
        for path, fn in (("/healthz", self.healthz), ("/readyz", self.readyz),
                         ("/", self.index), ("/last", self.last)):
            routes.add_get(path, fn)
        routes.add_post("/generate", self.generate)
        obs_http.add_metrics_route(routes, self._registry)
        obs_http.add_debug_trace_routes(routes, self.tracer)
        obs_http.add_debug_flight_routes(routes, self.flight)
        obs_http.add_debug_tenant_routes(routes, self.ledger, qos=self.qos)
        dispatch = obs_http.instrument("sd", self._registry, self.tracer, ledger=self.ledger,
                                       work_endpoints=("/generate",))(
            self.resilience.middleware(("/generate",))(
                obs_http.route(json_reply(404, {"detail": "Not Found"}), error_key="detail")))
        return obs_http.handler_class(routes, dispatch, max_body=1 << 20)

    def start(self, host: str = "0.0.0.0", port: int = 8000) -> int:
        """Serve on a daemon thread; returns the bound port (0 picks one)."""
        self._httpd = ThreadingHTTPServer((host, port), self.handler_class())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="sd-server", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join()
            self._httpd = self._thread = None
        self.resilience.close()


def main() -> None:
    server = SDServer()
    port = server.start(port=int(os.environ.get("PORT", "8000")))
    # SIGTERM -> drain: readiness 503, the running micro-batch finishes, exit 0
    server.resilience.install_signal_handlers()
    log.info("SD1.5 server on port %d (device %s, max_batch %d)",
             port, server.pipe.device, server.max_batch)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
