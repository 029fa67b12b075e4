"""ComfyUI-compatible node-graph server for Wan T2V, on the standard library.

The API of ``tpustack/serving/graph_server.py`` (itself the surface the
reference client ``generate_wan_t2v.py`` speaks), so that client drives
either server:

- ``GET  /queue``                 -> ``{"queue_running": [...], "queue_pending": [...]}``
- ``GET  /object_info``           -> node schemas incl. the loaders' file options
- ``POST /prompt``                -> ``{"prompt_id", "number"}``; body ``{prompt, client_id}``
- ``GET  /history/{prompt_id}``   -> ``{id: {status, outputs}}`` once known
- ``GET  /view?filename=&subfolder=&type=`` -> an output file (kept inside
  the output dir)
- ``GET  /healthz``               -> liveness and worker state (503 only when
  the watchdog fired); ``GET /readyz`` -> readiness (503 while draining)
- ``GET  /metrics``, ``/debug/traces[/{trace_id}]``, ``/debug/flight``,
  ``/debug/tenants``

Node set: UNETLoader, CLIPLoader, VAELoader, CLIPTextEncode,
EmptyHunyuanLatentVideo (``batch_size`` rows seeded ``seed + i``), KSampler,
VAEDecode, SaveImage (PNGs through ``utils.image.array_to_png``), SaveWEBM
when an ``ffmpeg`` binary exists, and SaveAnimatedWEBP when PIL imports (the
card machine has no PIL; a standard-library WebP writer is queued).

The graph is a serving abstraction: ``KSampler`` returns a sampling spec and
``VAEDecode`` hands it to the worker, which runs ``WanPipeline`` on it.  One
worker thread owns the device.  It takes up to ``WAN_MAX_BATCH`` (4) queued
prompts at once, plans their graphs, fuses the sampling specs with one
signature into one ``generate_many_async`` call under a pixel-frame budget
(``WAN_BATCH_PIXEL_BUDGET``), and runs one wave's deferred saves (the
frames' fetch, PNG encode and write) after the next wave is dispatched.  A
batched dispatch that fails is served row by row on the same device and
kernel, and counted in ``batch_fallbacks``.  Errors surface in
``/history`` with the node's message.

Env: ``PORT`` (8181), ``WAN_PRESET`` (``wan_1_3b`` | ``tiny``),
``WAN_DEVICE`` (default the first GPU; ``cpu`` to run on the CPU),
``WAN_MODELS_DIR``, ``WAN_OUTPUT_DIR``, ``WAN_ALLOW_RANDOM`` (1),
``WAN_TEXT_QUANT`` (unset: the weight-only int8 umt5 tower for every preset
but ``tiny``, as in the JAX server; ``none``/``off`` opts out, ``int8``
asks for it, anything else fails at startup),
``WAN_MAX_BATCH``, ``WAN_BATCH_PIXEL_BUDGET``.  Weights are drawn from seed
0; checkpoint files under ``WAN_MODELS_DIR`` cannot be loaded yet and
raise.

Resilience (``serving.resilience``), as in the JAX server: SIGTERM drains
(``/prompt`` refuses with 503 + Retry-After while the worker publishes every
accepted prompt, then the process exits 0), ``TPUSTACK_MAX_QUEUE_DEPTH``
sheds with 429, a queued prompt past its deadline
(``TPUSTACK_REQUEST_TIMEOUT_S`` or the body's ``timeout_s``) is answered
through ``/history`` instead of taking a dispatch, and
``TPUSTACK_WATCHDOG_S`` flips ``/healthz`` when a dispatch hangs.  Tenants
and QoS, as in the JAX server: a prompt's queue-seconds (submit to worker
pickup) and its finalize fetch (where the asynchronous dispatch's device
time lands) are charged to its tenant, each dispatch's flight record
carries its riders' ``tenants`` split, outcomes are counted where the worker
publishes, and with QoS on a tenant in quota debt gets 429 with its
bucket's refill ETA and batch prompts shed before interactive ones.  Not
ported: the ``/profile`` layer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import mimetypes
import os
import queue
import re
import shutil
import subprocess
import threading
import time
import uuid
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from tpustack_torch.obs import accounting as obs_accounting
from tpustack_torch.obs import catalog as obs_catalog
from tpustack_torch.obs import device as obs_device
from tpustack_torch.obs import flight as obs_flight
from tpustack_torch.obs import http as obs_http
from tpustack_torch.obs import trace as obs_trace
from tpustack_torch.obs.http import Request, json_reply
from tpustack_torch.serving import qos as qos_mod
from tpustack_torch.serving.resilience import ResilienceManager
from tpustack_torch.utils import get_logger
from tpustack_torch.utils.image import array_to_png

log = get_logger("serving.graph_server")

# canonical checkpoint names (what the reference client preflights for)
CANONICAL_UNET = "wan2.1_t2v_1.3B_bf16.safetensors"
CANONICAL_CLIP = "umt5_xxl_fp16.safetensors"
CANONICAL_VAE = "wan_2.1_vae.safetensors"

_SAMPLERS = ["uni_pc", "uni_pc_bh2", "euler", "heun", "dpmpp_2m"]
_SCHEDULERS = ["simple", "normal"]

#: max summed decoded pixel-frames (B*F*H*W) per batched dispatch.
#: Provisional on the H100: the JAX package's default, set for a 16 GB chip
#: (it admits only small shapes) and not yet re-derived for an 80 GB card
DEFAULT_PIXEL_BUDGET = 150_000


def _ffmpeg() -> Optional[str]:
    return shutil.which("ffmpeg")


def _have_pil() -> bool:
    return importlib.util.find_spec("PIL") is not None


# --------------------------------------------------------------------- values
@dataclasses.dataclass(frozen=True)
class Conditioning:
    text: str


@dataclasses.dataclass(frozen=True)
class LatentSpec:
    width: int
    height: int
    frames: int
    batch_size: int


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    latent: LatentSpec
    positive: Conditioning
    negative: Conditioning
    seed: int
    steps: int
    cfg: float
    sampler_name: str
    denoise: float


class GraphError(ValueError):
    pass


@dataclasses.dataclass
class Frames:
    """``[F, H, W, 3]`` uint8: a device tensor until the first ``numpy()``.

    Late-bound: VAEDecode returns an empty Frames that the worker fills with
    a row of a batched dispatch (``array``) or its failure (``error``)
    before any deferred save reads it.  ``record`` is the dispatch's entry
    in ``GraphServer.dispatch_log``; the first fetch stamps it."""

    array: Any = None
    error: Any = None
    n_frames: Optional[int] = None
    record: Optional[dict] = None
    tenant: Optional[str] = None  # the submitting tenant (the dispatch's split)

    @property
    def frame_count(self) -> int:
        if self.array is not None:
            return int(self.array.shape[0])
        if self.n_frames is None:
            raise GraphError("frame count unknown before dispatch (server bug)")
        return self.n_frames

    def numpy(self) -> np.ndarray:
        if self.error is not None:
            raise GraphError(f"sampling failed: {self.error}")
        if self.array is None:
            raise GraphError("frames were never dispatched (server bug)")
        if not isinstance(self.array, np.ndarray):
            self.array = self.array.cpu().numpy()
            if self.record is not None:
                self.record.setdefault("fetched_at", time.perf_counter())
        return self.array


class _ConcatFrames(Frames):
    """ComfyUI batched-latent semantics: a ``batch_size`` B latent decodes to
    the B videos stacked along the frame axis; each row is its own
    late-bound :class:`Frames` (its own seed)."""

    def __init__(self, rows: List[Frames]):
        super().__init__(n_frames=sum(r.frame_count for r in rows))
        self.rows = rows

    def numpy(self) -> np.ndarray:
        if self.array is None:
            errs = [r.error for r in self.rows if r.error is not None]
            if errs:
                raise GraphError(f"sampling failed: {errs[0]}")
            self.array = np.concatenate([r.numpy() for r in self.rows], axis=0)
        return self.array


@dataclasses.dataclass
class OutputFile:
    filename: str
    subfolder: str = ""
    type: str = "output"
    kind: str = "images"  # history key: images | videos

    def as_history(self) -> Dict[str, str]:
        return {"filename": self.filename, "subfolder": self.subfolder, "type": self.type}


# --------------------------------------------------------------------- runtime
def _text_quant(preset: str) -> Optional[str]:
    """``WAN_TEXT_QUANT``, with the JAX server's semantics: unset or empty
    means the weight-only int8 umt5-xxl tower (5.7 GB instead of 11.4 in
    bf16) for every preset but ``tiny``; ``none``/``off`` opts out;
    ``int8`` asks for it; anything else raises.  Called at startup too, so
    a typo fails the pod at deploy time."""
    raw = os.environ.get("WAN_TEXT_QUANT", "").strip().lower()
    if raw in ("none", "off"):
        return None
    if raw == "":
        return None if preset == "tiny" else "int8"
    if raw != "int8":
        raise ValueError(f"WAN_TEXT_QUANT={raw!r} unsupported (int8|none)")
    return raw


class WanRuntime:
    """Owns the (lazily built) pipeline and the models/output directories."""

    def __init__(self, models_dir: Optional[str] = None, output_dir: Optional[str] = None,
                 pipeline=None):
        self.models_dir = models_dir or os.environ.get("WAN_MODELS_DIR", "/models")
        self.output_dir = output_dir or os.environ.get("WAN_OUTPUT_DIR", "/tmp/wan-outputs")
        os.makedirs(self.output_dir, exist_ok=True)
        self._pipeline = pipeline  # guarded by _lock
        self._lock = threading.Lock()

    def _files(self, sub: str) -> List[str]:
        d = os.path.join(self.models_dir, sub)
        if not os.path.isdir(d):
            return []
        return sorted(f for f in os.listdir(d) if f.endswith((".safetensors", ".sft", ".pt")))

    def _list(self, sub: str, canonical: str) -> List[str]:
        # random-weights mode still advertises the canonical names, so the
        # reference client's preflight passes
        return self._files(sub) or ([canonical] if self._allow_random() else [])

    @staticmethod
    def _allow_random() -> bool:
        return os.environ.get("WAN_ALLOW_RANDOM", "1") not in ("0", "false")

    def unet_names(self) -> List[str]:
        return self._list("diffusion_models", CANONICAL_UNET)

    def clip_names(self) -> List[str]:
        return self._list("text_encoders", CANONICAL_CLIP)

    def vae_names(self) -> List[str]:
        return self._list("vae", CANONICAL_VAE)

    def pipeline(self):
        with self._lock:
            if self._pipeline is None:
                from tpustack_torch.models.wan import WanConfig, WanPipeline

                preset = os.environ.get("WAN_PRESET", "wan_1_3b")
                if preset not in ("wan_1_3b", "tiny"):
                    raise ValueError(f"WAN_PRESET must be wan_1_3b or tiny, got {preset!r}")
                tq = _text_quant(preset)
                if self._files("diffusion_models") or self._files("text_encoders"):
                    raise NotImplementedError(
                        f"checkpoints under {self.models_dir}: loading .safetensors is not "
                        "ported yet (the port serves weights drawn from seed 0)")
                if not self._allow_random():
                    raise RuntimeError(
                        f"no Wan checkpoints under {self.models_dir} and WAN_ALLOW_RANDOM=0 "
                        "- refusing to serve random weights")
                cfg = WanConfig.tiny() if preset == "tiny" else WanConfig.wan_1_3b()
                cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, quant=tq))
                log.info("Building Wan pipeline (preset=%s, text_quant=%s)...", preset, tq)
                self._pipeline = WanPipeline(cfg, device=os.environ.get("WAN_DEVICE") or None,
                                             seed=0)
            return self._pipeline


# ----------------------------------------------------------------- graph exec
class GraphExecutor:
    """Resolves a ComfyUI-style ``{id: {class_type, inputs}}`` graph.  Node
    functions are the methods ``node_<ClassType>``."""

    def __init__(self, runtime: WanRuntime):
        self.rt = runtime
        self._counter_lock = threading.Lock()
        self._counter = self._scan_counter()  # guarded by _counter_lock

    def _scan_counter(self) -> int:
        """Resume numbering after the largest ``*_NNNNN_.*`` output, so a
        restart never overwrites earlier files."""
        best = 0
        for name in os.listdir(self.rt.output_dir):
            m = re.search(r"_(\d{5,})_\.\w+$", name)
            if m:
                best = max(best, int(m.group(1)))
        return best

    def _next_counter(self) -> int:
        with self._counter_lock:
            self._counter += 1
            return self._counter

    # -- nodes
    def _loader(self, inputs, key: str, names: List[str], label: str):
        name = inputs.get(key)
        if name not in names:
            raise GraphError(f"{label} not found: {name}")
        return ((label.lower(), name),)

    def node_UNETLoader(self, inputs, _ctx):
        return self._loader(inputs, "unet_name", self.rt.unet_names(), "UNET")

    def node_CLIPLoader(self, inputs, _ctx):
        return self._loader(inputs, "clip_name", self.rt.clip_names(), "CLIP")

    def node_VAELoader(self, inputs, _ctx):
        return self._loader(inputs, "vae_name", self.rt.vae_names(), "VAE")

    def node_CLIPTextEncode(self, inputs, _ctx):
        return (Conditioning(text=str(inputs.get("text", ""))),)

    def node_EmptyHunyuanLatentVideo(self, inputs, _ctx):
        return (LatentSpec(width=int(inputs.get("width", 512)),
                           height=int(inputs.get("height", 320)),
                           frames=int(inputs.get("length", 16)),
                           batch_size=int(inputs.get("batch_size", 1))),)

    def node_KSampler(self, inputs, _ctx):
        latent = inputs.get("latent_image")
        pos, neg = inputs.get("positive"), inputs.get("negative")
        if not isinstance(latent, LatentSpec):
            raise GraphError("KSampler latent_image must come from EmptyHunyuanLatentVideo")
        if not isinstance(pos, Conditioning) or not isinstance(neg, Conditioning):
            raise GraphError("KSampler positive/negative must come from CLIPTextEncode")
        denoise = float(inputs.get("denoise", 1.0))
        if denoise != 1.0:
            raise GraphError("partial denoise (img2vid) not supported yet")
        if not 1 <= latent.batch_size <= 16:
            raise GraphError(f"batch_size {latent.batch_size} out of range [1, 16]")
        return (SampleSpec(latent=latent, positive=pos, negative=neg,
                           seed=int(inputs.get("seed", 0)), steps=int(inputs.get("steps", 25)),
                           cfg=float(inputs.get("cfg", 6.0)),
                           sampler_name=str(inputs.get("sampler_name", "uni_pc")),
                           denoise=denoise),)

    def node_VAEDecode(self, inputs, ctx):
        """Each of the spec's ``batch_size`` rows (seed ``seed + i``, each
        equal to a solo graph at that seed) goes to the worker's sample hook,
        which returns its late-bound Frames."""
        spec = inputs.get("samples")
        if not isinstance(spec, SampleSpec):
            raise GraphError("VAEDecode samples must come from KSampler")
        solo = dataclasses.replace(spec.latent, batch_size=1)
        rows = [dataclasses.replace(spec, latent=solo, seed=spec.seed + i)
                for i in range(spec.latent.batch_size)]
        frames = [ctx["sample_hook"](r) for r in rows]
        return (frames[0] if len(frames) == 1 else _ConcatFrames(frames),)

    def _out_path(self, prefix: str, ext: str) -> Tuple[str, str]:
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", prefix) or "out"
        name = f"{safe}_{self._next_counter():05d}_.{ext}"
        return name, os.path.join(self.rt.output_dir, name)

    @staticmethod
    def _frames(inputs, node: str) -> Frames:
        frames = inputs.get("images")
        if not isinstance(frames, Frames):
            raise GraphError(f"{node} images must come from VAEDecode")
        return frames

    def node_SaveImage(self, inputs, ctx):
        frames = self._frames(inputs, "SaveImage")
        prefix = str(inputs.get("filename_prefix", "out"))
        # names assigned now (deterministic order across the graph); fetch,
        # encode and write deferred so they overlap the next wave's compute
        names_paths = [self._out_path(prefix, "png") for _ in range(frames.frame_count)]

        def write():
            for frame, (_, path) in zip(frames.numpy(), names_paths):
                with open(path, "wb") as f:
                    f.write(array_to_png(frame))

        ctx["deferred"].append(write)
        return ([OutputFile(filename=name, kind="images") for name, _ in names_paths],)

    def node_SaveAnimatedWEBP(self, inputs, ctx):
        frames = self._frames(inputs, "SaveAnimatedWEBP")
        from PIL import Image

        fps = float(inputs.get("fps", 16))
        quality = int(inputs.get("quality", 90))
        lossless = bool(inputs.get("lossless", False))
        name, path = self._out_path(str(inputs.get("filename_prefix", "out")), "webp")

        def write():
            imgs = [Image.fromarray(f) for f in frames.numpy()]
            imgs[0].save(path, format="WEBP", save_all=True, append_images=imgs[1:],
                         duration=max(1, int(round(1000.0 / fps))), loop=0,
                         quality=quality, lossless=lossless)

        ctx["deferred"].append(write)
        return ([OutputFile(filename=name, kind="images")],)

    def node_SaveWEBM(self, inputs, ctx):
        frames = self._frames(inputs, "SaveWEBM")
        exe = _ffmpeg()
        if exe is None:
            raise GraphError("SaveWEBM requires an ffmpeg binary in the image")
        fps = float(inputs.get("fps", 24))
        crf = int(inputs.get("crf", 32))
        codec = str(inputs.get("codec", "vp9"))
        name, path = self._out_path(str(inputs.get("filename_prefix", "out")), "webm")

        def write():
            arr = frames.numpy()
            cmd = [exe, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                   "-s", f"{arr.shape[2]}x{arr.shape[1]}", "-r", str(fps), "-i", "-",
                   "-c:v", "libvpx-vp9" if codec == "vp9" else codec, "-crf", str(crf),
                   "-b:v", "0", "-pix_fmt", "yuv420p", path]
            proc = subprocess.run(cmd, input=arr.tobytes(), capture_output=True, check=False)
            if proc.returncode != 0:
                raise GraphError(f"ffmpeg failed: {proc.stderr[-500:].decode(errors='replace')}")

        ctx["deferred"].append(write)
        return ([OutputFile(filename=name, kind="videos")],)

    # -- schema for /object_info
    def object_info(self) -> Dict[str, Any]:
        def req(**kw):
            return {"input": {"required": kw}}

        info = {
            "UNETLoader": req(unet_name=[self.rt.unet_names()],
                              weight_dtype=[["default", "fp8_e4m3fn"]]),
            "CLIPLoader": req(clip_name=[self.rt.clip_names()],
                              type=[["wan", "stable_diffusion"]], device=[["default", "cpu"]]),
            "VAELoader": req(vae_name=[self.rt.vae_names()]),
            "CLIPTextEncode": req(text=["STRING"], clip=["CLIP"]),
            "EmptyHunyuanLatentVideo": req(width=["INT"], height=["INT"], length=["INT"],
                                           batch_size=["INT"]),
            "KSampler": req(model=["MODEL"], positive=["CONDITIONING"],
                            negative=["CONDITIONING"], latent_image=["LATENT"], seed=["INT"],
                            steps=["INT"], cfg=["FLOAT"], sampler_name=[_SAMPLERS],
                            scheduler=[_SCHEDULERS], denoise=["FLOAT"]),
            "VAEDecode": req(samples=["LATENT"], vae=["VAE"]),
            "SaveImage": req(images=["IMAGE"], filename_prefix=["STRING"]),
        }
        if _have_pil():
            info["SaveAnimatedWEBP"] = req(images=["IMAGE"], filename_prefix=["STRING"],
                                           fps=["FLOAT"], lossless=["BOOLEAN"],
                                           quality=["INT"], method=[["default"]])
        if _ffmpeg() is not None:
            info["SaveWEBM"] = req(images=["IMAGE"], filename_prefix=["STRING"],
                                   codec=[["vp9"]], fps=["FLOAT"], crf=["INT"])
        return info

    def check(self, graph: Any) -> None:
        """Raise :class:`GraphError` for a graph that is not a dict of nodes
        of known, usable classes (``/prompt`` answers 400)."""
        if not isinstance(graph, dict) or not graph:
            raise GraphError("missing prompt graph")
        for nid, node in graph.items():
            if not isinstance(node, dict):
                raise GraphError(f"node {nid} must be an object")
            ct = node.get("class_type")
            if not hasattr(self, f"node_{ct}"):
                raise GraphError(f"unknown node class_type {ct!r} (node {nid})")
            if ct == "SaveWEBM" and _ffmpeg() is None:
                raise GraphError("SaveWEBM requires an ffmpeg binary in the image")
            if ct == "SaveAnimatedWEBP" and not _have_pil():
                raise GraphError("SaveAnimatedWEBP requires PIL, which this image lacks")

    # -- execution
    def execute(self, graph: Dict[str, Any],
                sample_hook: Callable[[SampleSpec], Frames]) -> Tuple[Dict, Callable[[], None]]:
        """Resolve a graph; returns ``(outputs, finish)``.  ``outputs`` is the
        ComfyUI history dict keyed by node id, with final file names;
        ``finish()`` runs the save nodes' deferred writes (they fetch the
        frames the worker bound through ``sample_hook``)."""
        self.check(graph)
        results: Dict[str, Tuple] = {}
        ctx = {"sample_hook": sample_hook, "deferred": []}
        outputs: Dict[str, Dict[str, List[Dict]]] = {}

        def resolve(nid: str, stack: Tuple[str, ...]) -> Tuple:
            if nid in results:
                return results[nid]
            if nid in stack:
                raise GraphError(f"cycle through node {nid}")
            node = graph.get(nid)
            if node is None:
                raise GraphError(f"edge to missing node {nid}")
            inputs = {}
            for key, val in (node.get("inputs") or {}).items():
                if (isinstance(val, list) and len(val) == 2 and isinstance(val[0], str)
                        and isinstance(val[1], int)):
                    src = resolve(val[0], stack + (nid,))
                    if val[1] >= len(src):
                        raise GraphError(f"node {val[0]} has no output {val[1]}")
                    inputs[key] = src[val[1]]
                else:
                    inputs[key] = val
            out = getattr(self, f"node_{node['class_type']}")(inputs, ctx)
            results[nid] = out
            if out and isinstance(out[0], list) and out[0] and isinstance(out[0][0], OutputFile):
                by_kind: Dict[str, List[Dict]] = {}
                for f in out[0]:
                    by_kind.setdefault(f.kind, []).append(f.as_history())
                outputs[nid] = by_kind
            return out

        for nid in sorted(graph, key=lambda s: (len(s), s)):
            resolve(nid, ())

        def finish():
            for write in ctx["deferred"]:
                write()

        return outputs, finish


# -------------------------------------------------------------------- server
@dataclasses.dataclass
class HistoryEntry:
    prompt_id: str
    client_id: str
    completed: bool = False
    status_str: str = "pending"
    messages: List[str] = dataclasses.field(default_factory=list)
    outputs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # set once at submit, read by the worker: the tenant charged and the
    # QoS priority its outcome is counted under
    tenant: Optional[str] = None
    priority: Optional[str] = None

    def as_json(self) -> Dict[str, Any]:
        return {"status": {"completed": self.completed, "status_str": self.status_str,
                           "messages": list(self.messages)},
                "outputs": self.outputs}


class GraphServer:
    """One worker thread that owns the device, behind a standard-library
    HTTP server.  ``dispatch_log`` holds one record per device dispatch
    (batch, streaming decode or not, the pipeline's text/denoise/decode
    seconds, and when its frames were first fetched)."""

    def __init__(self, runtime: Optional[WanRuntime] = None, registry=None, tracer=None):
        self._registry = registry
        self.metrics = obs_catalog.build(registry)
        obs_device.install(registry)
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        # tenant ledger and the QoS policy (a malformed policy raises here)
        self.ledger = obs_accounting.for_registry(registry)
        self.qos = qos_mod.QosPolicy.from_env(registry=registry)
        if self.qos is not None:
            self.ledger.add_listener(self.qos.on_ledger_charge)
        self.rt = runtime or WanRuntime()
        self.executor = GraphExecutor(self.rt)
        self.max_batch = max(1, int(os.environ.get("WAN_MAX_BATCH", "4")))
        self.pixel_budget = int(os.environ.get("WAN_BATCH_PIXEL_BUDGET", str(DEFAULT_PIXEL_BUDGET)))
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._lock = threading.Lock()
        self._pending: Dict[str, Dict] = {}          # guarded by _lock
        self._history: Dict[str, HistoryEntry] = {}  # guarded by _lock
        self._running: List[str] = []                # guarded by _lock
        self._no_batch: set = set()  # signatures whose batched dispatch failed (worker only)
        self.batch_fallbacks = 0     # batched dispatches served row by row (worker only)
        self.dispatch_log: List[dict] = []           # appended by the worker only
        self._open = threading.Event()  # cleared while hold() queues without dispatching
        self._open.set()
        # per-prompt absolute deadlines and submit times (monotonic), and the
        # "prompt" spans that run from submit to publish
        self._deadline_at: Dict[str, float] = {}  # guarded by _lock
        self._t_submit: Dict[str, float] = {}     # guarded by _lock
        self._prompt_spans: Dict[str, obs_trace.Span] = {}  # guarded by _lock
        # drain on SIGTERM, queued-prompt deadlines, 429 backpressure, the
        # watchdog and the fault hooks.  /prompt answers at once, so drain
        # waits on accepted-but-unpublished prompts, and Retry-After comes
        # from submit-to-publish times (observe_http off)
        self.resilience = ResilienceManager(
            "graph", registry, concurrency=self.max_batch, queue_depth=self._queue.qsize,
            extra_busy=self._graph_busy, observe_http=False, expected_service_s=60.0,
            qos=self.qos)
        self.flight = obs_flight.register(obs_flight.FlightRecorder(
            "graph", meta={"max_batch": self.max_batch}))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._worker = threading.Thread(target=self._work, daemon=True, name="wan-graph-worker")
        self._worker.start()

    @contextlib.contextmanager
    def hold(self):
        """Accept prompts without dispatching them until the block ends, so
        prompts submitted inside it share a wave (up to ``max_batch``)."""
        self._open.clear()
        try:
            yield
        finally:
            self._open.set()

    def _graph_busy(self) -> bool:
        """Accepted work the drain must wait for: queued, planned, or
        dispatched-but-unpublished prompts."""
        with self._lock:
            if self._running or self._pending:
                return True
        return not self._queue.empty()

    # ---- worker
    def _work(self):
        """Queue loop with batched dispatch: plan up to ``max_batch`` queued
        graphs (no device work), dispatch their sampling specs grouped by
        signature, then publish the previous wave while this one computes."""
        in_flight: List[Tuple] = []  # (pid, entry, outputs, finish)
        stop = False
        while not stop:
            if in_flight:
                try:
                    pid = self._queue.get_nowait()
                except queue.Empty:  # nothing to overlap with: publish now
                    for f in in_flight:
                        self._finalize(*f)
                    in_flight = []
                    continue
            else:
                pid = self._queue.get()
            if pid is None:
                break
            self._open.wait()
            pids = [pid]
            while len(pids) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                pids.append(nxt)
            self.metrics["tpustack_graph_queue_depth"].set(self._queue.qsize())

            plans = []  # (pid, entry, outputs, finish, specs)
            for pid in pids:
                with self._lock:
                    graph = self._pending.pop(pid, None)
                    self._running.append(pid)
                    entry = self._history[pid]
                    deadline = self._deadline_at.pop(pid, None)
                    t_submit = self._t_submit.get(pid)
                if t_submit is not None:  # queue-seconds: submit to pickup
                    wait_s = time.monotonic() - t_submit
                    self.ledger.charge_queue_seconds("graph", entry.tenant, wait_s)
                    if self.qos is not None:
                        self.qos.observe_queue_wait("graph", entry.priority, wait_s)
                if deadline is not None and time.monotonic() > deadline:
                    # expired while queued: refuse to start it (its device
                    # work would be wasted) and publish the verdict
                    self.resilience.note_deadline("queued")
                    self._publish_error(pid, entry, "DeadlineExceeded: request deadline "
                                        "exceeded (phase=queued)", outcome="deadline")
                    continue
                specs: List[Tuple[SampleSpec, Frames]] = []

                def hook(spec, specs=specs, tenant=entry.tenant):
                    fr = Frames(n_frames=self.rt.pipeline().pixel_frame_count(spec.latent.frames),
                                tenant=tenant)
                    specs.append((spec, fr))
                    return fr

                try:
                    outputs, finish = self.executor.execute(graph, hook)
                except Exception as e:  # noqa: BLE001 - a bad graph fails its prompt only
                    log.exception("prompt %s failed", pid)
                    self._publish_error(pid, entry, f"{type(e).__name__}: {e}")
                    continue
                plans.append((pid, entry, outputs, finish, specs))

            for key, chunk in self._dispatch_plan(self._group_specs(plans)):
                self._dispatch_one(key, chunk)
            for f in in_flight:
                self._finalize(*f)
            in_flight = [p[:4] for p in plans]
        for f in in_flight:
            self._finalize(*f)

    @staticmethod
    def _spec_key(spec: SampleSpec):
        lat = spec.latent
        return (lat.width, lat.height, lat.frames, spec.steps, spec.cfg, spec.sampler_name)

    def _group_specs(self, plans) -> Dict[Tuple, List[Tuple[SampleSpec, Frames]]]:
        groups: Dict[Tuple, List[Tuple[SampleSpec, Frames]]] = {}
        for plan in plans:
            for spec, fr in plan[4]:
                groups.setdefault(self._spec_key(spec), []).append((spec, fr))
        return groups

    def _dispatch_plan(self, groups) -> List[Tuple[Tuple, List]]:
        """Split groups into the dispatches that will run: at most
        ``pixel_budget`` decoded pixel-frames each (16 requested frames are
        13 decoded), one row at a time for signatures whose batch failed."""
        plan = []
        for key, members in groups.items():
            width, height, frames_n = key[:3]
            per = max(1, self.rt.pipeline().pixel_frame_count(frames_n)) * height * width
            max_b = 1 if key in self._no_batch else max(1, self.pixel_budget // per)
            for lo in range(0, len(members), max_b):
                plan.append((key, members[lo:lo + max_b]))
        return plan

    def _dispatch_one(self, key, members) -> None:
        width, height, frames_n, steps, cfg, sampler = key
        pipe = self.rt.pipeline()
        kw = dict(frames=frames_n, steps=steps, guidance_scale=cfg, width=width,
                  height=height, sampler=sampler)
        new = not pipe.is_warm(batch_size=len(members), frames=frames_n, steps=steps,
                               width=width, height=height, sampler=sampler)
        log.info("Sampling%s: %dx%d f=%d steps=%d cfg=%.1f sampler=%s seeds=%s%s",
                 f" BATCH of {len(members)}" if len(members) > 1 else "", width, height,
                 frames_n, steps, cfg, sampler, [s.seed for s, _ in members],
                 " (first run of this signature)" if new else "")
        t0 = time.perf_counter()
        try:
            # watchdog beat + fault point; an injected device error takes the
            # dispatch-failure path below
            self.resilience.progress("prefill")
            vid = pipe.generate_many_async(
                [{"prompt": s.positive.text, "negative_prompt": s.negative.text,
                  "seed": s.seed} for s, _ in members], **kw)
        except Exception as e:  # noqa: BLE001 - a failed dispatch fails its rows only
            if len(members) > 1:
                log.warning("batched dispatch of %d failed (%s); serving its rows one by "
                            "one on the same device", len(members), e)
                self.batch_fallbacks += 1
                self.metrics["tpustack_graph_batch_fallback_total"].inc()
                self._no_batch.add(key)
                for m in members:
                    self._dispatch_one(key, [m])
                return
            log.exception("dispatch failed")
            for _, fr in members:
                fr.error = e
            return
        if int(vid.shape[1]) != members[0][1].n_frames:
            err = GraphError(f"decoded frame count {int(vid.shape[1])} != planned "
                             f"{members[0][1].n_frames} - frame-convention drift between "
                             "pipeline and server")
            log.error("%s", err)
            for _, fr in members:
                fr.error = err
            return
        rec = dict(pipe.last_run, dispatch_s=time.perf_counter() - t0,
                   dispatched_at=time.perf_counter())
        self.dispatch_log.append(rec)
        tenants: Dict[str, int] = {}
        for _, fr in members:
            if fr.tenant is not None:
                tenants[fr.tenant] = tenants.get(fr.tenant, 0) + 1
        self.flight.record("dispatch", batch=len(members), width=width, height=height,
                           frames=frames_n, steps=steps, sampler=sampler,
                           dispatch_s=round(rec["dispatch_s"], 6),
                           queue_depth=self._queue.qsize(), **({"tenants": tenants}
                                                               if tenants else {}))
        self.metrics["tpustack_request_phase_latency_seconds"].labels(
            server="graph", phase="dispatch").observe(rec["dispatch_s"])
        for i, (_, fr) in enumerate(members):
            fr.array, fr.record = vid[i], rec
        # a dispatch boundary: the fault injector's mid-request SIGTERM point
        self.resilience.progress("wave")

    def _note_outcome(self, entry: HistoryEntry, outcome: str) -> None:
        """A prompt's tenant and per-priority outcome, counted where the
        worker publishes or refuses it (the ``/prompt`` 200 said nothing
        about how the work fared)."""
        self.ledger.note_outcome("graph", entry.tenant, outcome)
        if self.qos is not None and entry.priority is not None:
            self.metrics["tpustack_qos_requests_total"].labels(
                server="graph", priority=entry.priority, outcome=outcome).inc()

    def _publish_error(self, pid: str, entry: HistoryEntry, message: str,
                       outcome: str = "error") -> None:
        self.metrics["tpustack_graph_prompts_total"].labels(status="error").inc()
        self._note_outcome(entry, outcome)
        with self._lock:
            entry.status_str = "error"
            entry.messages.append(message)
            entry.completed = True
            if pid in self._running:
                self._running.remove(pid)
            self._t_submit.pop(pid, None)
            span = self._prompt_spans.pop(pid, None)
        if span is not None:  # publishes the trace (its last open span)
            span.set_attribute("error", message)
            span.end(status="error")

    def _finalize(self, pid, entry, outputs, finish) -> None:
        """Run the deferred saves (fetch + encode + write) and publish."""
        self.resilience.beat()  # publishing is progress too
        t_fin = time.perf_counter()
        try:
            finish()
        except Exception as e:  # noqa: BLE001 - surfaced through /history
            log.exception("prompt %s failed", pid)
            self._publish_error(pid, entry, f"{type(e).__name__}: {e}")
            return
        finalize_s = time.perf_counter() - t_fin
        self.flight.record("finalize", prompt_id=pid, status="success",
                           finalize_s=round(finalize_s, 6))
        # the asynchronous dispatch's device time lands in this fetch
        self.ledger.charge_chip_seconds("graph", entry.tenant, finalize_s)
        self._note_outcome(entry, "ok")
        self.metrics["tpustack_request_phase_latency_seconds"].labels(
            server="graph", phase="finalize").observe(finalize_s)
        self.metrics["tpustack_graph_prompts_total"].labels(status="success").inc()
        with self._lock:  # status_str before completed: pollers read both
            entry.outputs = outputs
            entry.status_str = "success"
            entry.completed = True
            self._running.remove(pid)
            t_submit = self._t_submit.pop(pid, None)
            span = self._prompt_spans.pop(pid, None)
        if span is not None:
            span.end()
        if t_submit is not None:  # the Retry-After basis: submit-to-publish time
            self.resilience.observe_service_time(time.monotonic() - t_submit)

    def shutdown(self) -> None:
        """Stop the HTTP server and let the worker publish what it holds."""
        self.stop()
        self._queue.put(None)
        self._worker.join(timeout=600)
        self.resilience.close()

    # ---- handlers: (status, headers, body)
    def queue_state(self, req: Request):
        with self._lock:
            running = [[i, pid] for i, pid in enumerate(self._running)]
            pending = [[0, pid] for pid in self._pending]
        return json_reply(200, {"queue_running": running, "queue_pending": pending})

    def object_info(self, req: Request):
        return json_reply(200, self.executor.object_info())

    def submit(self, req: Request):
        rejected = self.metrics["tpustack_graph_prompts_total"].labels(status="rejected")
        try:
            data = req.json() if req.body else None  # the instrumentation's parse
        except (ValueError, UnicodeDecodeError):
            rejected.inc()
            return json_reply(400, {"error": "invalid JSON"})
        if not isinstance(data, dict):
            rejected.inc()
            return json_reply(400, {"error": "body must be a JSON object"})
        graph = data.get("prompt")
        try:
            self.executor.check(graph)
            deadline_s = self.resilience.deadline(data.get("timeout_s"))
        except GraphError as e:
            rejected.inc()
            return json_reply(400, {"error": str(e)})
        except (TypeError, ValueError) as e:
            rejected.inc()
            return json_reply(400, {"error": f"bad timeout_s: {e}"})
        pid = str(uuid.uuid4())
        parent = obs_trace.current_span.get()
        with self._lock:
            self._history[pid] = HistoryEntry(prompt_id=pid,
                                              client_id=str(data.get("client_id", "")),
                                              tenant=obs_accounting.current_tenant.get(),
                                              priority=req.priority)
            self._pending[pid] = graph
            if parent is not None:
                # ended at publish, so the client's trace covers the
                # prompt's whole submit-to-publish life
                self._prompt_spans[pid] = self.tracer.start_span(
                    "prompt", parent=parent, attrs={"prompt_id": pid})
            if deadline_s is not None:
                self._deadline_at[pid] = time.monotonic() + deadline_s
            self._t_submit[pid] = time.monotonic()
            number = len(self._history)
        self._queue.put(pid)
        self.metrics["tpustack_graph_queue_depth"].set(self._queue.qsize())
        return json_reply(200, {"prompt_id": pid, "number": number})

    def history(self, req: Request):
        pid = req.params["prompt_id"]
        with self._lock:  # serialise under the lock: the worker mutates entries
            entry = self._history.get(pid)
            payload = {} if entry is None else {pid: entry.as_json()}
        return json_reply(200, payload)

    def view(self, req: Request):
        filename, subfolder = req.arg("filename"), req.arg("subfolder")
        base = os.path.realpath(self.rt.output_dir)
        path = os.path.realpath(os.path.join(base, subfolder, filename))
        # keep /view inside the output dir
        if not path.startswith(base + os.sep) or not os.path.isfile(path):
            return json_reply(404, {"error": "not found"})
        with open(path, "rb") as f:
            data = f.read()
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        return 200, {"Content-Type": ctype}, data

    def healthz(self, req: Request):
        """Liveness + worker state (503 only on a watchdog-declared hang)."""
        with self._lock:
            running, pending = len(self._running), len(self._pending)
        status, payload = self.resilience.health_payload(extra={
            "worker_alive": self._worker.is_alive(), "running": running, "pending": pending,
            "max_batch": self.max_batch, "pixel_budget": self.pixel_budget,
            "batch_fallbacks": self.batch_fallbacks})
        return json_reply(status, payload, self.resilience.health_headers(status))

    def readyz(self, req: Request):
        status, payload = self.resilience.ready_payload()
        return json_reply(status, payload, self.resilience.ready_headers(status))

    # ---- http
    def handler_class(self):
        """The request handler: routes behind the resilience gate and the
        HTTP instrumentation."""
        routes = obs_http.Routes()
        for path, fn in (("/queue", self.queue_state), ("/object_info", self.object_info),
                         ("/history/{prompt_id}", self.history), ("/view", self.view),
                         ("/healthz", self.healthz), ("/readyz", self.readyz)):
            routes.add_get(path, fn)
        routes.add_post("/prompt", self.submit)
        obs_http.add_metrics_route(routes, self._registry)
        obs_http.add_debug_trace_routes(routes, self.tracer)
        obs_http.add_debug_flight_routes(routes, self.flight)
        obs_http.add_debug_tenant_routes(routes, self.ledger, qos=self.qos)
        # accept-and-poll: ok/error/deadline are counted where the worker
        # publishes; shed and rejected requests never reach it
        dispatch = obs_http.instrument("graph", self._registry, self.tracer, ledger=self.ledger,
                                       work_endpoints=("/prompt",),
                                       outcome_accounting="refusals")(
            self.resilience.middleware(("/prompt",))(
                obs_http.route(json_reply(404, {"error": "not found"}))))
        return obs_http.handler_class(routes, dispatch, max_body=4 << 20)

    def start(self, host: str = "0.0.0.0", port: int = 8181) -> int:
        """Serve on a daemon thread; returns the bound port (0 picks one)."""
        self._httpd = ThreadingHTTPServer((host, port), self.handler_class())
        self._httpd.daemon_threads = True
        self._http_thread = threading.Thread(target=self._httpd.serve_forever,
                                             name="graph-server", daemon=True)
        self._http_thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join()
            self._httpd = self._http_thread = None


def main() -> None:
    _text_quant(os.environ.get("WAN_PRESET", "wan_1_3b"))  # fail fast on a typo
    server = GraphServer()
    port = server.start(port=int(os.environ.get("PORT", "8181")))
    # SIGTERM -> drain: /prompt refuses, the worker publishes every accepted
    # prompt, exit 0
    server.resilience.install_signal_handlers()
    log.info("Wan graph server on :%d (models=%s, outputs=%s)", port, server.rt.models_dir,
             server.rt.output_dir)
    try:
        server._http_thread.join()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
