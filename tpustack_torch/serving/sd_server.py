"""SD1.5 REST API server for the PyTorch port, on the standard library.

The REST contract of ``tpustack/serving/sd_server.py`` (itself the reference
sd15-api app's), so ``scripts/batch_generate.py`` drives either server:

- ``GET /healthz``   -> ``{"ok": true, ...}``
- ``GET /``          -> HTML preview of the last image
- ``GET /last``      -> last PNG, or 404 before the first image
- ``POST /generate`` -> PNG + ``X-Gen-Time: <sec>s``; body ``{prompt,
  steps=30, guidance_scale=7.5, seed, width=512, height=512,
  negative_prompt}``; 400 on an empty prompt, a bad size or no steps, 422
  on a malformed body, 500 when the pipeline fails.

``http.server.ThreadingHTTPServer`` serves each request on its own thread.
A micro-batcher groups concurrent requests with the same ``(steps, guidance,
width, height)``: the first request of a group waits ``SD15_BATCH_WINDOW_MS``
(default 15) for company, a group reaching ``SD15_MAX_BATCH`` (default 1)
goes at once, and one ``SD15Pipeline.generate`` call serves the whole group.
Dispatch is serialised under one lock.  Batches are not padded to powers of
two as the JAX server's are: eager PyTorch has no compiled signatures whose
number padding would bound.

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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

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


@dataclasses.dataclass
class _Pending:
    prompt: str
    negative: str
    seed: Optional[int]
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
                 max_batch: Optional[int] = None):
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
    def submit(self, key: tuple, prompt: str, negative: str,
               seed: Optional[int]) -> np.ndarray:
        """Queue one image and block until its batch has run; returns the
        ``[H, W, 3]`` uint8 image or raises the batch's error."""
        p = _Pending(prompt, negative, seed)
        with self._cv:
            group = self._pending.get(key)
            leader = group is None
            if leader:
                group = self._pending[key] = _Group()
            group.reqs.append(p)
            if len(group.reqs) >= self.max_batch:  # full: close it, wake its leader
                group.closed = True
                del self._pending[key]
                self._cv.notify_all()
        if leader:
            deadline = time.monotonic() + self.batch_window_s
            with self._cv:
                while not group.closed:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        group.closed = True
                        del self._pending[key]
                        break
                    self._cv.wait(left)
            self._run_batch(key, group.reqs)
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.image

    def _run_batch(self, key: tuple, batch: List[_Pending]) -> None:
        steps, guidance, width, height = key
        if len(batch) > 1:
            log.info("Micro-batch: %d requests in one dispatch", len(batch))
        try:
            with self._dispatch_lock:
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
        for r, img in zip(batch, imgs):
            r.image = img
            r.done.set()

    # ------------------------------------------------------------ handlers
    def generate(self, body: bytes):
        """``POST /generate`` -> (status, headers, body bytes)."""
        try:
            req = parse_request(body)
        except BadRequest as e:
            return _json(422, {"detail": str(e)})
        if not req["prompt"].strip():
            return _json(400, {"detail": "prompt is required"})
        try:
            self.pipe.check_request(req["steps"], req["width"], req["height"])
        except ValueError as e:  # e.g. size not a multiple of the UNet factor
            return _json(400, {"detail": str(e)})
        t0 = time.time()
        log.info("Generating prompt='%s' steps=%s guidance=%.2f seed=%s size=%sx%s",
                 req["prompt"], req["steps"], req["guidance_scale"],
                 "auto" if req["seed"] is None else req["seed"], req["width"], req["height"])
        key = (req["steps"], req["guidance_scale"], req["width"], req["height"])
        # a pipeline failure is the server's fault: the handler answers 500
        img = self.submit(key, req["prompt"], req["negative_prompt"], req["seed"])
        png = array_to_png(img)
        latency = time.time() - t0
        log.info("Completed generation in %.2fs", latency)
        self._last_image = png
        return 200, {"Content-Type": "image/png", "X-Gen-Time": f"{latency:.2f}s"}, png

    def healthz(self):
        return _json(200, {"ok": True, "max_batch": self.max_batch,
                           "batch_window_ms": self.batch_window_s * 1e3,
                           "device": str(self.pipe.device)})

    def index(self):
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

    def last(self):
        if self._last_image is None:
            return _json(404, {"detail": "No image generated yet"})
        return 200, {"Content-Type": "image/png"}, self._last_image

    # ---------------------------------------------------------------- http
    def start(self, host: str = "0.0.0.0", port: int = 8000) -> int:
        """Serve on a daemon thread; returns the bound port (0 picks one)."""
        self._httpd = ThreadingHTTPServer((host, port), _handler_for(self))
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


def _json(status: int, payload: dict):
    return status, {"Content-Type": "application/json"}, json.dumps(payload).encode()


def _handler_for(server: SDServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, status, headers, body):
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            route = {"/healthz": server.healthz, "/": server.index, "/last": server.last}
            fn = route.get(self.path.split("?", 1)[0])
            self._reply(*(fn() if fn else _json(404, {"detail": "Not Found"})))

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            if n > 1 << 20:
                self._reply(*_json(413, {"detail": "body too large"}))
                return
            body = self.rfile.read(n)
            if self.path.split("?", 1)[0] != "/generate":
                self._reply(*_json(404, {"detail": "Not Found"}))
                return
            try:
                reply = server.generate(body)
            except Exception as e:
                log.exception("generate failed")
                reply = _json(500, {"detail": f"{type(e).__name__}: {e}"})
            self._reply(*reply)

        def log_message(self, fmt, *args):  # access log off, as in the JAX server
            pass

    return Handler


def main() -> None:
    server = SDServer()
    port = server.start(port=int(os.environ.get("PORT", "8000")))
    log.info("SD1.5 server on port %d (device %s, max_batch %d)",
             port, server.pipe.device, server.max_batch)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
