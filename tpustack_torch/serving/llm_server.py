"""llama.cpp-style LLM server for the PyTorch port, on the standard library.

The HTTP surface of ``tpustack/serving/llm_server.py`` (itself llama.cpp's
server's), served by ``http.server.ThreadingHTTPServer``:

- ``GET /health`` -> ``{"status": "ok"}``; ``GET /healthz`` -> liveness,
  drain/watchdog state, ``inflight``, ``queue_depth`` and the ``engine``
  block (503 only when the watchdog fired); ``GET /readyz`` -> readiness
  (503 + ``X-Shed-Reason: draining`` from the moment a drain begins)
- ``GET /props`` -> model, ctx, slots, paged pool and prefix-cache stats,
  speculative drafted/accepted, ``decode_kernel``
- ``GET /metrics`` (Prometheus text), ``GET /debug/traces``,
  ``GET /debug/traces/{trace_id}``, ``GET /debug/flight``,
  ``GET /debug/tenants`` (the tenant ledger and the QoS buckets)
- ``POST /completion`` -> ``{content, model, stop, stopped_eos,
  stopped_limit, tokens_evaluated, tokens_predicted, timings}``, or with
  ``"stream": true`` server-sent events of ``{content, stop: false}``
  deltas and a final event carrying the body's fields and ``timings``
- ``POST /v1/chat/completions`` -> an OpenAI ``chat.completion``, or with
  ``"stream": true`` ``chat.completion.chunk`` events then ``[DONE]``
- ``POST /tokenize`` -> ``{tokens}``; ``POST /detokenize`` -> ``{content}``
- ``POST /admin/drain`` -> the reversible readiness drain the fleet's
  autoscaler calls (``X-Admin-Token`` must equal ``TPUSTACK_ADMIN_TOKEN``;
  403 when the knob is unset); body ``{"undrain": true}`` reverses it

The engines, as the JAX server picks them:

- **Paged** (the default): the continuous engine
  (``models.llm_continuous``) over one KV pool; slots hold block tables,
  admission is allocation (a request that the pool cannot cover, even after
  evicting unreferenced cached blocks, gets 429 with ``Retry-After`` from
  the in-flight requests' projected block release), a prefix-cache hit
  shares the cached blocks, and speculation is on.  With
  ``TPUSTACK_KV_HOST_TIER_MB`` evicted prefix blocks spill to host RAM and a
  later hit restores them (``serving.kv_host_tier``); with
  ``TPUSTACK_PREFILL_CHUNK_TOKENS`` a long prompt prefills in chunks
  between decode waves.
- **Dense batched** (``TPUSTACK_PAGED_KV=0``): the same engine over a dense
  cache line per slot, with the dense host prefix store
  (``serving.prefix_cache``, ``TPUSTACK_PREFIX_CACHE_MB`` /
  ``TPUSTACK_PREFIX_CACHE_CHUNK``).
- **Solo** (``LLM_MAX_BATCH=1``): one request at a time on the device, the
  fused chunked decode (``Generator.generate_fused``; streams decode one
  token per step), with the dense prefix store; requests wait on the device
  lock (``solo_waiting``, counted in the queue depth) and a deadline names
  ``queued`` or ``decode``.

In the batched engines one engine thread runs the engine whenever requests
are queued; handler threads wait on their request.  Streams ride the same
engine: each fetched wave hands a row its tokens, and a stream's client that
disconnects cancels its row.  ``TPUSTACK_SPEC_DRAFT=<preset>`` drafts with a
second model drawn from seed 0 (``DraftModelDrafter``) instead of prompt
lookup.

The resilience layer (``serving.resilience``) is the JAX server's:
``TPUSTACK_MAX_QUEUE_DEPTH`` sheds with 429, ``TPUSTACK_REQUEST_TIMEOUT_S``
and the body's ``timeout_s`` answer 504 naming the phase (the row is
retired and its blocks freed), SIGTERM drains (in-flight completions
finish, new work gets 503, the process exits 0), ``TPUSTACK_WATCHDOG_S``
flips liveness on a hung dispatch, and ``TPUSTACK_FAULT_*`` inject faults.

Tenants and QoS, as in the JAX server: each request is charged to its
tenant (``X-Tenant-Id`` or the body's ``tenant``) for tokens, chip-seconds
(from the engine's flight records), KV-block-seconds and queue-seconds.
With QoS on (``TPUSTACK_QOS``, the default; ``TPUSTACK_QOS_POLICY`` sets
per-tenant priorities and token-bucket quotas) a tenant in quota debt gets
429 with its bucket's refill ETA, batch requests shed first under queue
pressure, the queue hands interactive requests to the engine first (FIFO
within a class), and the engine parks a batch row at a wave boundary when an
interactive request waits for a slot.

Env (the JAX server's names): ``LLM_PRESET`` (``qwen25_7b`` | ``llama2_7b``
| ``tiny``), ``LLM_CTX`` (4096), ``LLM_QUANT`` (``int8``: weight-only
int8, ``ops.quant``), ``LLM_KV_QUANT`` (``int8``),
``LLM_MAX_BATCH`` (8 slots; 1 is the solo engine), ``LLM_CHUNK`` /
``LLM_ENGINE_CHUNK`` (engine chunk ``min(LLM_CHUNK, 16)``; the solo decode
chunk is ``LLM_CHUNK``), ``TPUSTACK_PAGED_KV``, ``TPUSTACK_KV_BLOCK``,
``TPUSTACK_KV_POOL_BLOCKS``, ``TPUSTACK_PREFIX_CACHE``,
``TPUSTACK_PREFIX_CACHE_MB``, ``TPUSTACK_PREFIX_CACHE_CHUNK``,
``TPUSTACK_KV_HOST_TIER_MB``, ``TPUSTACK_KV_HOST_TIER_CROSSOVER``,
``TPUSTACK_PREFILL_CHUNK_TOKENS``, ``TPUSTACK_SPEC_TOKENS`` (4),
``TPUSTACK_SPEC_NGRAM`` (3), ``TPUSTACK_SPEC_DRAFT``,
``TPUSTACK_PAGED_FLASH`` (``auto``: the paged kernel on CUDA where the
engine's geometry is inside its contract), ``PORT`` (8080), and
``LLM_DEVICE`` (default the first GPU; ``cpu`` to run on the CPU).  Weights
are drawn from seed 0, as the JAX server's are without a checkpoint.

Refused at startup: ``LLM_TP``, ``MODEL_DIR``, ``LLM_TOKENIZER_DIR`` and
``TPUSTACK_SPEC_DRAFT_DIR`` (not ported yet), and a configuration on CUDA
whose prefill would reach the streaming flash kernel outside its contract
(``Generator.stream_route_violation``).  ``POST /profile`` and
``/debug/kvcache`` answer 404.
"""

from __future__ import annotations

import collections
import dataclasses
import hmac
import json
import math
import os
import queue
import threading
import time
import uuid
from http.server import ThreadingHTTPServer
from typing import List, Optional

import torch

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
from tpustack_torch.utils import get_logger, knobs

log = get_logger("serving.llm_server")

#: the work endpoints: gated by the resilience layer, traced always
WORK_ENDPOINTS = ("/completion", "/v1/chat/completions")


class OutOfKVBlocks(Exception):
    """Paged admission shortfall; ``retry_after_s`` comes from the in-flight
    requests' projected block release."""

    def __init__(self, retry_after_s: int):
        super().__init__(f"out of KV blocks; retry after {retry_after_s}s")
        self.retry_after_s = retry_after_s


class BadRequest(ValueError):
    """A request the server answers with 400."""


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    if raw in ("1", "true", "yes", "on"):
        return True
    if raw in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{name}={raw!r} is not a boolean")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not supported by the PyTorch port yet "
                               "(later work); unset it to serve")


def _normalize_seed(seed):
    """llama.cpp convention: a negative seed means random (None); an
    integral float is an int; anything else raises ValueError."""
    if seed is None:
        return None
    if isinstance(seed, bool) or not isinstance(seed, (int, float)):
        raise ValueError(f"seed must be an integer, got {seed!r}")
    if isinstance(seed, float):
        if not seed.is_integer():
            raise ValueError(f"seed must be an integer, got {seed!r}")
        seed = int(seed)
    return seed if seed >= 0 else None


def _or_default(value, default):
    return default if value is None else value


def _build_generator():
    """``(Generator, tokenizer, preset)`` from the environment."""
    from tpustack_torch.models.llama import LlamaConfig
    from tpustack_torch.models.llm_generate import Generator
    from tpustack_torch.models.text_tokenizer import load_text_tokenizer

    if os.environ.get("MODEL_DIR"):
        raise _not_ported("MODEL_DIR (loading a safetensors checkpoint)")
    if _env_int("LLM_TP", 0) > 1:
        raise _not_ported("LLM_TP (tensor-parallel serving)")
    preset = os.environ.get("LLM_PRESET", "qwen25_7b") or "qwen25_7b"
    ctx = _env_int("LLM_CTX", 4096)
    if preset == "tiny":
        cfg, dtype = LlamaConfig.tiny(max_seq=min(ctx, 128)), torch.float32
    elif preset in ("qwen25_7b", "llama2_7b"):
        cfg = dataclasses.replace(getattr(LlamaConfig, preset)(), max_seq=ctx)
        dtype = torch.bfloat16
    else:
        raise ValueError(f"LLM_PRESET must be qwen25_7b, llama2_7b or tiny, got {preset!r}")
    quant = os.environ.get("LLM_QUANT", "").lower() or None
    if quant not in (None, "int8"):
        raise ValueError(f"LLM_QUANT={quant!r} unsupported (want int8)")
    kv_quant = os.environ.get("LLM_KV_QUANT", "").lower() or None
    if kv_quant not in (None, "int8"):
        raise ValueError(f"LLM_KV_QUANT={kv_quant!r} unsupported (want int8)")
    cfg = dataclasses.replace(cfg, quant=quant, kv_quant=kv_quant)
    gen = Generator(cfg, dtype=dtype, seed=0, device=os.environ.get("LLM_DEVICE") or None)
    return gen, load_text_tokenizer(cfg.vocab_size), preset


def build_paged(gen, max_batch: int, block: Optional[int] = None,
                n_blocks: Optional[int] = None, prefix_cache: Optional[bool] = None):
    """The paged KV runtime: block size ``TPUSTACK_KV_BLOCK`` (default
    ``min(64, max(8, ctx / 8))``, snapped down to divide ctx), pool
    ``TPUSTACK_KV_POOL_BLOCKS`` (default ``max_batch * ctx / block``, dense
    parity) plus the reserved block 0, prefix cache per
    ``TPUSTACK_PREFIX_CACHE``, and behind the cache the host KV tier when
    ``TPUSTACK_KV_HOST_TIER_MB`` is above 0."""
    from tpustack_torch.models.llama import init_kv_pool
    from tpustack_torch.serving.kv_pool import KVBlockPool, PagedKVRuntime, PagedPrefixCache

    max_seq = gen.cfg.max_seq
    if block is None:
        block = _env_int("TPUSTACK_KV_BLOCK", 0)
    if block <= 0:
        block = min(64, max(8, max_seq // 8))
    block = min(block, max_seq)
    while block > 1 and max_seq % block:
        block //= 2
    if n_blocks is None:
        n_blocks = _env_int("TPUSTACK_KV_POOL_BLOCKS", 0)
    if n_blocks <= 0:
        n_blocks = max_batch * (max_seq // block)
    if prefix_cache is None:
        prefix_cache = _env_bool("TPUSTACK_PREFIX_CACHE", True)
    pool = KVBlockPool(n_blocks + 1, block)
    arrays = init_kv_pool(gen.cfg, n_blocks + 1, block, gen.cache_dtype, gen.device)
    rt = PagedKVRuntime(arrays, pool, max_seq, PagedPrefixCache(pool) if prefix_cache else None)
    tier_mb = knobs.get_float("TPUSTACK_KV_HOST_TIER_MB")
    if rt.cache is not None and tier_mb > 0:
        from tpustack_torch.serving.kv_host_tier import HostKVTier

        rt.cache.host_tier = HostKVTier(int(tier_mb * 1024 * 1024), pool,
                                        arrays_fn=lambda: rt.arrays)
        log.info("host KV tier on: %.0f MB arena behind the %d-block pool", tier_mb, n_blocks)
    log.info("paged KV pool: %d blocks x %d tokens (ctx %d), %.2f GB, prefix cache %s",
             n_blocks, block, max_seq, rt.pool_bytes / 1e9, "on" if prefix_cache else "off")
    return rt


def build_prefix_cache():
    """The dense engines' host prefix store from ``TPUSTACK_PREFIX_CACHE``
    (None when off), ``TPUSTACK_PREFIX_CACHE_MB`` and
    ``TPUSTACK_PREFIX_CACHE_CHUNK``."""
    from tpustack_torch.serving.prefix_cache import PrefixCache

    if not _env_bool("TPUSTACK_PREFIX_CACHE", True):
        return None
    mb = knobs.get_float("TPUSTACK_PREFIX_CACHE_MB")
    return PrefixCache(chunk_tokens=knobs.get_int("TPUSTACK_PREFIX_CACHE_CHUNK"),
                       capacity_bytes=max(1, int(mb * 1024 * 1024)))


def build_spec(gen=None):
    """The speculation config from ``TPUSTACK_SPEC_TOKENS`` (0 = off) and
    ``TPUSTACK_SPEC_NGRAM``; ``TPUSTACK_SPEC_DRAFT=<preset>`` drafts with a
    second model of that preset at ``gen``'s context, drawn from seed 0."""
    from tpustack_torch.serving.speculative import SpecConfig

    k = _env_int("TPUSTACK_SPEC_TOKENS", 4)
    if k <= 0:
        return None
    preset = knobs.get_str("TPUSTACK_SPEC_DRAFT").strip()
    drafter = build_draft_drafter(gen, preset) if preset else None
    return SpecConfig(tokens=k, ngram_max=max(1, _env_int("TPUSTACK_SPEC_NGRAM", 3)),
                      drafter=drafter)


def build_draft_drafter(gen, preset: str):
    """A ``DraftModelDrafter`` over a ``preset`` model at ``gen``'s context
    and device (float32 ``tiny``, else bf16), random weights from seed 0."""
    from tpustack_torch.models.llama import LlamaConfig
    from tpustack_torch.models.llm_generate import Generator
    from tpustack_torch.serving.speculative import DraftModelDrafter

    presets = ("tiny", "llama2_7b", "qwen25_7b")
    if preset not in presets:
        raise ValueError(f"TPUSTACK_SPEC_DRAFT={preset!r}: unknown preset (want one of "
                         f"{presets})")
    if knobs.get_str("TPUSTACK_SPEC_DRAFT_DIR"):
        raise _not_ported("TPUSTACK_SPEC_DRAFT_DIR (loading the draft model's checkpoint)")
    if gen is None:
        raise ValueError("TPUSTACK_SPEC_DRAFT needs the target generator (its context and "
                         "device)")
    cfg = (LlamaConfig.tiny(max_seq=gen.cfg.max_seq) if preset == "tiny"
           else dataclasses.replace(getattr(LlamaConfig, preset)(), max_seq=gen.cfg.max_seq))
    dtype = torch.float32 if preset == "tiny" else torch.bfloat16
    draft = Generator(cfg, dtype=dtype, seed=0, device=gen.device)
    log.info("speculative draft model: %s (random weights, %.2f GB)", preset,
             draft.weight_bytes / 1e9)
    return DraftModelDrafter(draft)


class IncrementalDetokenizer:
    """Text deltas of a growing token sequence, never splitting a
    character: the JAX server's ``next_delta`` (the vLLM/TGI sliding-window
    recipe).  Each delta decodes a window that keeps 4 tokens of context
    before the last emitted position, so subword spacing renders as in the
    full text, and holds back while the window ends in U+FFFD (an
    incomplete multi-byte character) for up to 16 tokens; past that the
    bytes are genuinely invalid and are flushed."""

    HOLD_TOKENS = 16
    CONTEXT_TOKENS = 4

    def __init__(self, tok):
        self.tok = tok
        self.ids: List[int] = []
        self.prefix_off = self.read_off = 0

    def push(self, token: int) -> str:
        self.ids.append(token)
        prev = self.tok.decode(self.ids[self.prefix_off:self.read_off])
        text = self.tok.decode(self.ids[self.prefix_off:])
        if len(text) <= len(prev):
            return ""
        if text.endswith("�"):
            if len(self.ids) - self.read_off <= self.HOLD_TOKENS:
                return ""
            # forced flush: the pending bytes leave the window for good, or
            # a later token could re-render them and the prefix arithmetic
            # would drop good characters
            self.prefix_off = self.read_off = len(self.ids)
            return text[len(prev):]
        self.prefix_off = max(self.read_off - self.CONTEXT_TOKENS, 0)
        self.read_off = len(self.ids)
        return text[len(prev):]

    def flush(self) -> str:
        """What is still held back at the end of the stream."""
        window = self.ids[self.prefix_off:]
        return self.tok.decode(window)[len(self.tok.decode(self.ids[self.prefix_off:
                                                                    self.read_off])):]


class _Cancelled(Exception):
    """A solo request's waiter is gone: its generation stops."""


class _Pending:
    """A completion waiting for (or decoding in) the engine or the solo
    device lock.  ``stream``: a queue of the row's tokens (None at the end)
    for a streamed request.  ``prefix``/``kv_blocks``/``on_prefill_blocks``
    /``host_restore``: the paged admission's; ``prefix``/``kv_extract``/
    ``on_prefill_kv``: the dense prefix store's."""

    __slots__ = ("ids", "n_predict", "sample", "seed", "prefix", "kv_blocks",
                 "on_prefill_blocks", "speculative", "phase", "done", "result", "error",
                 "cancel", "stream", "span_ctx", "queue_span", "tenant", "priority",
                 "t_enqueue", "t_kv_alloc", "host_restore", "kv_extract", "on_prefill_kv")

    def __init__(self, ids, n_predict, sample, seed, prefix, kv_blocks, on_prefill_blocks,
                 speculative, stream=None, host_restore=None, kv_extract=None,
                 on_prefill_kv=None):
        self.ids, self.n_predict, self.sample, self.seed = ids, n_predict, sample, seed
        self.prefix, self.kv_blocks = prefix, kv_blocks
        self.on_prefill_blocks = on_prefill_blocks
        self.host_restore = host_restore
        self.kv_extract, self.on_prefill_kv = kv_extract, on_prefill_kv
        self.speculative = speculative
        # the server owns the pool references until "decode", the phase a
        # 504 names once feed() hands the request to a slot
        self.phase = "queued"
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.cancel = threading.Event()  # a deadline or a gone client: retire the row
        self.stream: Optional[queue.Queue] = stream
        self.span_ctx = None
        self.queue_span = None
        # tenant and QoS priority (set at enqueue from the handler's
        # context), the enqueue time (queue-seconds) and the time the pool
        # blocks were allocated (KV-block-seconds)
        self.tenant: Optional[str] = None
        self.priority: Optional[str] = None
        self.t_enqueue: Optional[float] = None
        self.t_kv_alloc: Optional[float] = None


class LLMServer:
    """llama.cpp-surface server over the paged or dense continuous engine,
    or the solo path."""

    _FROM_ENV = object()

    def __init__(self, generator=None, tokenizer=None, model_name: str = "tpustack_torch",
                 max_batch: Optional[int] = None, paged=_FROM_ENV, spec=_FROM_ENV,
                 registry=None, tracer=None):
        """``paged``: a ``PagedKVRuntime``, None for a dense engine, or from
        the environment (none for ``LLM_MAX_BATCH=1`` or
        ``TPUSTACK_PAGED_KV=0``; the dense engines then build their prefix
        store from the environment)."""
        # metrics registry and tracer: tests pass fresh ones for isolation;
        # the defaults are the process-wide ones /metrics and /debug/traces serve
        self._registry = registry
        self.metrics = obs_catalog.build(registry)
        obs_device.install(registry)
        self.tracer = tracer if tracer is not None else obs_trace.TRACER
        # tenant ledger: process-wide on the default registry, private with
        # an injected one (the tracer's isolation contract)
        self.ledger = obs_accounting.for_registry(registry)
        # multi-tenant QoS; None (TPUSTACK_QOS=0) keeps the serving path
        # QoS-free.  A malformed TPUSTACK_QOS_POLICY raises here, at startup
        self.qos = qos_mod.QosPolicy.from_env(registry=registry)
        if self.qos is not None:
            self.ledger.add_listener(self.qos.on_ledger_charge)
        if generator is None:
            generator, tokenizer, model_name = _build_generator()
        self.gen, self.tok, self.model_name = generator, tokenizer, model_name
        self.max_batch = _env_int("LLM_MAX_BATCH", 8) if max_batch is None else max_batch
        if self.max_batch < 1:
            raise ValueError(f"LLM_MAX_BATCH={self.max_batch} must be at least 1")
        # a configuration whose prefill would reach the streaming flash
        # kernel outside its contract is refused here, not mid-request
        why = self.gen.stream_route_violation()
        if why is not None:
            raise ValueError(f"this LLM configuration cannot be served on {self.gen.device}: "
                             f"{why}")
        if paged is LLMServer._FROM_ENV:
            paged = (build_paged(self.gen, self.max_batch)
                     if self.max_batch >= 2 and knobs.get_bool("TPUSTACK_PAGED_KV") else None)
        self.paged = paged
        #: the dense engines' host prefix store (the block trie replaces it
        #: under paging)
        self.prefix_cache = build_prefix_cache() if paged is None else None
        self.spec_cfg = build_spec(self.gen) if spec is LLMServer._FROM_ENV else spec
        drafter = getattr(self.spec_cfg, "drafter", None)
        if drafter is not None and hasattr(drafter, "gen"):
            why = drafter.gen.stream_route_violation()
            if why is not None:
                raise ValueError(f"TPUSTACK_SPEC_DRAFT: the draft model cannot be served on "
                                 f"{drafter.gen.device}: {why}")
        if self.paged is not None:
            from tpustack_torch.models.llm_generate import resolve_paged_flash

            # resolved once at boot, on the engine's geometry: =1 outside
            # the kernel's contract fails here, not on the first decode step
            self.paged_flash = resolve_paged_flash(
                self.gen.device, self.gen.cfg, self.gen.cache_dtype, self.paged.block,
                self.spec_cfg.tokens if self.spec_cfg is not None else 0, self.max_batch)
        else:
            self.paged_flash = False
        self._wire_cache_metrics()
        chunk = max(1, _env_int("LLM_CHUNK", 32))
        #: the solo path's decode chunk
        self.chunk = chunk
        override = _env_int("LLM_ENGINE_CHUNK", 0)
        self.engine_chunk = override if override > 0 else min(chunk, 16)
        self._queue: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._stop = False
        self._engine = None
        self._spec_drafted = self._spec_accepted = 0
        # the solo path: one request on the device at a time; requests
        # waiting for (or holding) the device lock count in the queue depth
        self._device_lock = threading.Lock()
        self._solo_lock = threading.Lock()
        self._solo_waiting = 0  # guarded-by: _solo_lock
        #: stats of every finished engine run, newest last
        self.run_log: collections.deque = collections.deque(maxlen=256)
        # drain on SIGTERM, deadlines, 429 backpressure, the watchdog and
        # the TPUSTACK_FAULT_* hooks; queue depth is what waits for a slot
        self.resilience = ResilienceManager(
            "llm", registry, concurrency=self.max_batch,
            queue_depth=lambda: len(self._queue) + self._solo_waiting,
            expected_service_s=2.0, qos=self.qos)
        self.flight = obs_flight.register(obs_flight.FlightRecorder("llm", meta={
            "model": model_name, "slots": self.max_batch, "chunk": self.engine_chunk,
            "paged_kv": self.paged is not None, "decode_kernel": self.decode_kernel,
            "spec_tokens": self.spec_cfg.tokens if self.spec_cfg is not None else 0}))
        if self.paged is not None:
            self._paged_gauges()
        chunk_tokens = knobs.get_int("TPUSTACK_PREFILL_CHUNK_TOKENS")
        if chunk_tokens > 0 and self.paged is None:
            log.warning("TPUSTACK_PREFILL_CHUNK_TOKENS=%d takes effect on the paged engine "
                        "only (as in the JAX server); this %s engine prefills whole prompts",
                        chunk_tokens, self.engine_kind)
        if knobs.get_float("TPUSTACK_KV_HOST_TIER_MB") > 0 and (
                self.paged is None or self.paged.cache is None):
            log.warning("TPUSTACK_KV_HOST_TIER_MB backs the paged prefix cache only (as in "
                        "the JAX server); this %s engine has none", self.engine_kind)
        log.info("engine %s, decode attention %s (%d slots, speculation %d (%s), %s, weights "
                 "%s, %.2f GB, prefill chunk %d)", self.engine_kind, self.decode_kernel,
                 self.max_batch, self.spec_cfg.tokens if self.spec_cfg is not None else 0,
                 type(drafter).__name__ if drafter is not None else "prompt lookup",
                 self.gen.cache_dtype, self.gen.cfg.quant or "float",
                 self.gen.weight_bytes / 1e9, chunk_tokens if self.paged is not None else 0)
        self._engine_thread = None
        if self.batchable:
            self._engine_thread = threading.Thread(target=self._engine_loop,
                                                   name="llm-engine", daemon=True)
            self._engine_thread.start()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def batchable(self) -> bool:
        """Every request rides the continuous engine; solo only with
        ``LLM_MAX_BATCH=1``."""
        return self.max_batch > 1

    @property
    def engine_kind(self) -> str:
        if not self.batchable:
            return "solo"
        return "paged" if self.paged is not None else "dense"

    @property
    def decode_kernel(self) -> str:
        """What decode attention reads: the pool through the paged kernel
        or a gathered copy (paged engine), or the dense cache lines."""
        if self.paged is None:
            return "dense"
        return "paged_flash" if self.paged_flash else "gather"

    def _wire_cache_metrics(self) -> None:
        """The cache stores' eviction counters and the host tier's
        counters point at this server's metric families."""
        inc = self.metrics["tpustack_llm_prefix_cache_evictions_total"].inc
        if self.prefix_cache is not None and self.prefix_cache._on_evict is None:
            self.prefix_cache._on_evict = inc
        cache = self.paged.cache if self.paged is not None else None
        if cache is not None:
            if cache.on_evict is None:
                cache.on_evict = inc
            if cache.host_tier is not None and cache.host_tier.metrics is None:
                cache.host_tier.metrics = self.metrics

    # ------------------------------------------------------------ engine
    def _note_spec(self, drafted: int, accepted: int) -> None:
        self._spec_drafted += drafted
        self._spec_accepted += accepted
        self.metrics["tpustack_llm_spec_drafted_tokens_total"].inc(drafted)
        self.metrics["tpustack_llm_spec_accepted_tokens_total"].inc(accepted)
        self.metrics["tpustack_llm_spec_acceptance_ratio"].set(
            self._spec_accepted / self._spec_drafted if self._spec_drafted else 0.0)

    def _paged_gauges(self) -> None:
        p = self.paged.pool
        self.metrics["tpustack_llm_kv_free_blocks"].set(p.n_free)
        self.metrics["tpustack_llm_kv_used_blocks"].set(p.n_used)
        self.metrics["tpustack_llm_kv_block_fragmentation_ratio"].set(p.fragmentation())

    def _release(self, r: _Pending) -> None:
        """Give back a queued request's pool references and claimed host
        payloads (it died queued, or its run failed before a slot took it;
        the engine owns them once the request is handed to a slot)."""
        if r.phase != "queued" or self.paged is None:
            return
        ids = list(r.kv_blocks or [])
        if r.prefix:
            ids += list(r.prefix[1])
        r.kv_blocks, r.prefix = None, None
        if r.host_restore is not None:
            # the restore blocks free with the prefix references; the claims
            # go back to the tier's ledger as expired
            self.paged.cache.host_tier.abandon(len(r.host_restore[1]))
            r.host_restore = None
        if ids:
            if r.tenant is not None and r.t_kv_alloc:
                # died queued, but its blocks were resident all along
                self.ledger.charge_kv_block_seconds(
                    r.tenant, len(ids) * max(0.0, time.time() - r.t_kv_alloc))
            self.paged.pool.decref(ids)
            self._paged_gauges()

    def _slot_request(self, r: _Pending):
        from tpustack_torch.models.llm_continuous import SlotRequest

        eos = self.tok.eos_id

        def on_tokens(toks):
            for t in toks:  # the engine already enforced budget and stop
                if t != eos:
                    r.stream.put(t)

        def on_done(tokens, stats):
            self.metrics["tpustack_llm_running_requests"].dec()
            if self.paged is not None:
                self._paged_gauges()  # the engine freed the row's blocks first
            if tokens is None:
                self.metrics["tpustack_llm_requests_rejected_total"].labels(
                    reason="admission").inc()
                r.error = BadRequest(stats.get("error", "bad request"))
            else:
                r.result = (tokens, stats)
            r.done.set()
            if r.stream is not None:
                r.stream.put(None)  # end of stream

        return SlotRequest(ids=r.ids, max_new=r.n_predict, sample=r.sample,
                           on_tokens=on_tokens if r.stream is not None else None,
                           on_done=on_done, cancelled=r.cancel.is_set, seed=r.seed,
                           prefix=r.prefix, span_ctx=r.span_ctx, kv_blocks=r.kv_blocks,
                           on_prefill_blocks=r.on_prefill_blocks, speculative=r.speculative,
                           tenant=r.tenant, t_kv_alloc=r.t_kv_alloc, priority=r.priority,
                           host_restore=r.host_restore, kv_extract=r.kv_extract,
                           on_prefill_kv=r.on_prefill_kv)

    # ------------------------------------------------------ QoS queue helpers
    def _pop_queued(self) -> _Pending:
        """(engine thread) The next queued request: the first interactive
        one when QoS is on (FIFO within each class), else the FIFO head.
        An index scan, since handler threads append concurrently."""
        if self.qos is not None:
            try:
                for idx in range(len(self._queue)):
                    if self._queue[idx].priority == qos_mod.INTERACTIVE:
                        r = self._queue[idx]
                        del self._queue[idx]
                        return r
            except IndexError:
                pass  # racing an append: fall through to FIFO
        return self._queue.popleft()

    def _interactive_waiting(self) -> bool:
        """(engine thread) The engine's preemption hint: an interactive
        request waits in the queue.  Racy by design: a stale answer costs
        one spurious park or one wave of extra wait, never correctness."""
        try:
            for idx in range(len(self._queue)):
                r = self._queue[idx]
                if r.priority == qos_mod.INTERACTIVE and not r.cancel.is_set():
                    return True
        except IndexError:
            pass
        return False

    def _note_preempt(self, tenant) -> None:
        """(engine thread) A batch row was parked for an interactive one."""
        self.qos.note_preempt(qos_mod.BATCH)

    def _fail(self, r: _Pending, exc: BaseException) -> None:
        if r.queue_span is not None:
            r.queue_span.end(status="error")  # idempotent
        self._release(r)
        if not r.done.is_set():
            r.error = exc
            r.done.set()
        if r.stream is not None:
            r.stream.put(None)

    def _engine_loop(self) -> None:
        """Run the engine for every busy period; a run returns when its
        slots drain and the queue is empty."""
        from tpustack_torch.models.llm_continuous import ContinuousEngine

        while not self._stop:
            self._wake.wait()
            self._wake.clear()
            if self._stop or not self._queue:
                continue
            handed: List[_Pending] = []

            def feed():
                while self._queue:
                    r = self._pop_queued()
                    self.metrics["tpustack_llm_queue_depth"].set(len(self._queue))
                    if r.t_enqueue:  # cancelled and admitted alike waited
                        wait_s = time.time() - r.t_enqueue
                        self.ledger.charge_queue_seconds("llm", r.tenant, wait_s)
                        if self.qos is not None:
                            self.qos.observe_queue_wait("llm", r.priority, wait_s)
                    if r.cancel.is_set():  # died queued: its waiter is gone
                        if r.queue_span is not None:
                            r.queue_span.set_attribute("cancelled", True)
                            r.queue_span.end(status="error")
                        self._release(r)
                        if r.stream is not None:
                            r.stream.put(None)
                        continue
                    r.phase = "decode"
                    if r.queue_span is not None:
                        r.queue_span.end()
                    handed.append(r)
                    self.metrics["tpustack_llm_running_requests"].inc()
                    return self._slot_request(r)
                return None

            engine = ContinuousEngine(self.gen, self.paged, slots=self.max_batch,
                                      chunk=self.engine_chunk, stop_tokens=(self.tok.eos_id,),
                                      paged_flash=self.paged_flash, spec=self.spec_cfg,
                                      on_spec=self._note_spec,
                                      on_progress=self.resilience.progress,
                                      tracer=self.tracer, flight=self.flight,
                                      queue_depth=lambda: len(self._queue),
                                      ledger=self.ledger,
                                      # QoS scheduling: None with QoS off keeps the
                                      # engine preemption-free
                                      preempt_hint=(self._interactive_waiting
                                                    if self.qos is not None else None),
                                      on_preempt=(self._note_preempt
                                                  if self.qos is not None else None))
            self._engine = engine
            try:
                stats = engine.run(feed)
                self.run_log.append(stats)
                if stats.get("prefill_chunks"):
                    self.metrics["tpustack_llm_prefill_chunks_total"].inc(stats["prefill_chunks"])
                if stats["requests"]:
                    self.metrics["tpustack_llm_batch_occupancy_slots"].observe(
                        stats["requests"])
                log.info("engine run: %d requests, %d tokens, %.1f tok/s aggregate",
                         stats["requests"], stats["generated_tokens"], stats["tokens_per_s"])
            except Exception as e:  # fail every waiter; the server stays up
                log.exception("engine run failed")
                while self._queue:
                    handed.append(self._queue.popleft())
                for r in handed:
                    self._fail(r, e)
            finally:
                self._engine = None
                # nothing decodes between runs: self-heal the gauges even
                # when a run died before on_done fired for some rows
                self.metrics["tpustack_llm_running_requests"].set(0)
                self.metrics["tpustack_llm_queue_depth"].set(len(self._queue))
                if self.paged is not None:
                    self._paged_gauges()
                if self._queue:
                    self._wake.set()

    # ----------------------------------------------------- paged admission
    def _retry_after(self, shortfall_blocks: int) -> int:
        """Seconds until the live rows' projected block releases cover the
        shortfall, clamped to [1, 120]; the resilience layer's p50 estimate
        when no engine run is live to project from."""
        eng = self._engine
        if eng is None:
            return self.resilience.retry_after_s()
        ra = min(max(1, math.ceil(eng.projected_block_release_s(shortfall_blocks))), 120)
        self.metrics["tpustack_retry_after_seconds"].labels(server="llm").set(ra)
        return ra

    def _paged_admit(self, ids, n_predict: int, cache_prompt: bool):
        """Admission is allocation: a prefix hit increfs the shared blocks,
        claimed host-tier payloads get fresh blocks riding the prefix (a
        full pool abandons them and the hit is the device part alone), the
        rest allocates fresh blocks (evicting unreferenced cached ones
        first); a shortfall raises :class:`OutOfKVBlocks`.  Returns
        ``(prefix, kv_blocks, on_prefill_blocks, host_restore)``."""
        from tpustack_torch.serving.kv_pool import OutOfBlocks

        rt = self.paged
        prefix = host_restore = None
        if rt.cache is not None and cache_prompt:
            m = rt.cache.match(ids)
            hit = bool(m.length or m.host_payloads)
            self.metrics["tpustack_llm_prefix_cache_lookups_total"].labels(
                result="hit" if hit else "miss").inc()
            if m.length:
                prefix = (m.length, m.block_ids)
            host_tokens = 0
            if m.host_payloads:
                n_host = len(m.host_payloads)
                try:
                    rt.ensure_free(n_host)
                    restore_ids = rt.pool.alloc_tokens(n_host * rt.block)
                except OutOfBlocks:
                    rt.cache.host_tier.abandon(n_host)
                else:
                    prefix = (m.length + n_host * rt.block, m.block_ids + list(restore_ids))
                    host_restore = (restore_ids, m.host_payloads)
                    host_tokens = n_host * rt.block
            self.metrics["tpustack_llm_prefix_cached_tokens"].observe(m.length + host_tokens)
            span = obs_trace.current_span.get()
            if span is not None:
                extra = {"host_restored_tokens": host_tokens} if host_tokens else {}
                span.add_event("prefix_cache", result="hit" if hit else "miss",
                               cached_tokens=m.length, **extra)
        n_shared = len(prefix[1]) if prefix else 0

        def give_back():
            if prefix:
                rt.pool.decref(prefix[1])
            if host_restore:  # claimed payloads die unwritten: restored -> expired
                rt.cache.host_tier.abandon(len(host_restore[1]))

        fresh_tokens = rt.need_tokens(len(ids), max(0, n_predict)) - n_shared * rt.block
        need_fresh = rt.pool.blocks_for(fresh_tokens)
        if n_shared + need_fresh > rt.pool.capacity_blocks:
            give_back()
            raise BadRequest(f"request needs {n_shared + need_fresh} KV blocks; the pool "
                             f"holds {rt.pool.capacity_blocks} (TPUSTACK_KV_POOL_BLOCKS)")
        try:
            rt.ensure_free(need_fresh)
            kv_blocks = rt.pool.alloc_tokens(fresh_tokens)
        except OutOfBlocks:
            give_back()
            self.metrics["tpustack_requests_shed_total"].labels(
                server="llm", reason="out_of_kv_blocks").inc()
            raise OutOfKVBlocks(self._retry_after(need_fresh - rt.pool.n_free)) from None
        on_insert = None
        if rt.cache is not None and cache_prompt and (len(ids) // rt.block > n_shared
                                                      or host_restore is not None):
            # a host restore inserts even with no fresh full block: the
            # insert is what re-promotes the claimed stubs onto their blocks
            ids_copy = list(ids)

            def on_insert(bids):
                rt.cache.insert(ids_copy, bids)
        self._paged_gauges()
        return prefix, kv_blocks, on_insert, host_restore

    def _prefix_lookup(self, ids, allow: bool):
        """The dense store's policy: the longest cached prefix (a hit
        restores it and prefills the suffix) and, when the prompt reaches
        past it, an extract range and insert callback so this request's
        prefill fills the store.  ``(prefix, kv_extract, on_prefill_kv)``,
        all None with the store off or the request opted out."""
        pc = self.prefix_cache
        if pc is None or not allow:
            return None, None, None
        m = pc.match(ids)
        self.metrics["tpustack_llm_prefix_cache_lookups_total"].labels(
            result="hit" if m.length else "miss").inc()
        self.metrics["tpustack_llm_prefix_cached_tokens"].observe(m.length)
        span = obs_trace.current_span.get()
        if span is not None:
            span.add_event("prefix_cache", result="hit" if m.length else "miss",
                           cached_tokens=m.length)
        prefix = (m.length, m.kv, m.key) if m.length else None
        upto = pc.snap(len(ids))
        if upto <= m.length:
            return prefix, None, None
        start, ids_copy = m.length, list(ids)

        def on_kv(kv):
            pc.insert(ids_copy, start, kv)
            self.metrics["tpustack_llm_prefix_cache_bytes"].set(pc.bytes)
            self.metrics["tpustack_llm_prefix_cache_entries"].set(pc.entries)

        return prefix, (start, upto), on_kv

    def _admit(self, prompt: str, n_predict: int, temperature: float, top_k: int, seed,
               cache_prompt: bool, speculative: bool, stream: bool = False) -> _Pending:
        """Tokenise, check and allocate one request (not queued yet).
        Raises :class:`BadRequest` or :class:`OutOfKVBlocks`."""
        from tpustack_torch.models.llm_generate import SampleConfig

        ids = self.tok.encode(prompt)
        if not ids:
            self.metrics["tpustack_llm_requests_rejected_total"].labels(
                reason="empty_prompt").inc()
            raise BadRequest("empty prompt")
        if len(ids) >= self.gen.cfg.max_seq:
            raise BadRequest(f"prompt ({len(ids)} tokens) exceeds ctx {self.gen.cfg.max_seq}")
        sample = SampleConfig(temperature=temperature, top_k=top_k, greedy=temperature <= 0)
        q = queue.Queue() if stream else None
        if self.paged is not None and self.batchable:
            prefix, kv_blocks, on_insert, host_restore = self._paged_admit(ids, n_predict,
                                                                           cache_prompt)
            r = _Pending(ids, n_predict, sample, seed, prefix, kv_blocks, on_insert,
                         speculative, stream=q, host_restore=host_restore)
            r.t_kv_alloc = time.time()
            return r
        prefix, extract, on_kv = self._prefix_lookup(ids, cache_prompt)
        return _Pending(ids, n_predict, sample, seed, prefix, None, None, speculative, stream=q,
                        kv_extract=extract, on_prefill_kv=on_kv)

    def _enqueue(self, r: _Pending) -> None:
        # engine threads do not see the handler's contextvars: the root
        # span's context rides on the request
        span = obs_trace.current_span.get()
        if span is not None:
            r.span_ctx = span.context
            r.queue_span = self.tracer.start_span("queue_wait", parent=span)
        r.tenant = obs_accounting.current_tenant.get()
        r.priority = qos_mod.current_priority.get() if self.qos is not None else None
        r.t_enqueue = time.time()
        if not self.batchable:
            with self._solo_lock:
                self._solo_waiting += 1
            threading.Thread(target=self._solo_worker, args=(r,), name="llm-solo",
                             daemon=True).start()
            return
        self._queue.append(r)
        self.metrics["tpustack_llm_queue_depth"].set(len(self._queue))
        self._wake.set()

    def _solo_worker(self, r: _Pending) -> None:
        """The solo path (a worker thread per request): wait for the device
        lock, then generate, the fused chunked decode for a plain request
        (the watchdog beats and the cancel flag is polled per chunk) or one
        step per token for a stream (beats and polls per token).  A request
        whose waiter gave up while it queued never touches the device."""
        try:
            with self._device_lock:
                if r.queue_span is not None:
                    r.queue_span.end()
                if r.cancel.is_set():
                    raise _Cancelled()
                r.phase = "decode"
                if r.t_enqueue:
                    self.ledger.charge_queue_seconds("llm", r.tenant, time.time() - r.t_enqueue)
                self.resilience.progress("prefill")
                try:
                    r.result = self._solo_generate(r)
                finally:
                    if r.stream is None:
                        self.resilience.progress("wave")
        except _Cancelled:
            r.error = DeadlineExceeded(r.phase)
        except Exception as e:  # the waiter reports it; the server stays up
            if not isinstance(e, InjectedDeviceError):
                log.exception("solo generation failed")
            r.error = e
        finally:
            if r.queue_span is not None:
                r.queue_span.end()  # idempotent
            with self._solo_lock:
                self._solo_waiting -= 1
            r.done.set()
            if r.stream is not None:
                r.stream.put(None)

    def _solo_generate(self, r: _Pending):
        """``(token ids, stats)`` of one solo request on the generator."""
        eos = self.tok.eos_id
        hooks = dict(prefix=r.prefix, kv_extract=r.kv_extract, on_prefill_kv=r.on_prefill_kv)
        if r.stream is not None:
            def on_token(t):
                self.resilience.beat()
                if t != eos:
                    r.stream.put(t)
                if r.cancel.is_set():
                    raise _Cancelled()

            return self.gen.generate(r.ids, max_new_tokens=r.n_predict, sample=r.sample,
                                     seed=r.seed, stop_tokens=(eos,), on_token=on_token,
                                     **hooks)

        def chunk_check():
            self.resilience.beat()  # a long healthy solo run keeps beating
            return r.cancel.is_set()

        return self.gen.generate_fused(r.ids, max_new_tokens=r.n_predict, sample=r.sample,
                                       seed=r.seed, stop_tokens=(eos,), chunk=self.chunk,
                                       cancel_check=chunk_check, **hooks)

    def complete(self, prompt: str, n_predict: int = 128, temperature: float = 0.8,
                 top_k: int = 40, seed=None, cache_prompt: bool = True,
                 speculative: bool = True, deadline_s: Optional[float] = None):
        """``(content, stats, stopped_eos)`` for one prompt, through the
        engine.  Raises :class:`BadRequest`, :class:`OutOfKVBlocks`, or
        :class:`DeadlineExceeded` past ``deadline_s`` (the row is cancelled:
        dropped if still queued, retired at the engine's next chunk boundary
        otherwise, and its blocks freed either way)."""
        t0 = time.perf_counter()
        r = self._admit(prompt, n_predict, temperature, top_k, seed, cache_prompt, speculative)
        self._enqueue(r)
        if not r.done.wait(deadline_s):
            r.cancel.set()
            raise DeadlineExceeded(r.phase)
        if r.error is not None:
            raise r.error
        out_ids, stats = r.result
        stopped_eos = bool(out_ids) and out_ids[-1] == self.tok.eos_id
        if stopped_eos:
            out_ids = out_ids[:-1]
        stats = dict(stats)
        t_detok = time.perf_counter()
        with self.tracer.span_if_active("detokenize"):
            content = self.tok.decode(out_ids)
        stats["detokenize_s"] = time.perf_counter() - t_detok
        self._observe_done(len(r.ids), stats, time.perf_counter() - t0)
        return content, stats, stopped_eos

    def _observe_done(self, n_prompt: int, stats: dict, total_s: float) -> None:
        """Token counters, the prompt-length histogram and the phase
        breakdown of one finished completion (queue_wait is the wall time
        the engine's phases do not account for)."""
        m = self.metrics
        m["tpustack_llm_prompt_tokens_total"].inc(stats.get("prompt_tokens", 0))
        m["tpustack_llm_generated_tokens_total"].inc(stats.get("generated_tokens", 0))
        m["tpustack_llm_prompt_length_tokens"].observe(n_prompt)
        # one token charge per completed request, in the handler's context
        # (the instrumentation's tenant contextvar is live here)
        self.ledger.charge_tokens("llm", obs_accounting.current_tenant.get(),
                                  prompt=stats.get("prompt_tokens", 0),
                                  generated=stats.get("generated_tokens", 0))
        prefill, decode = stats.get("prefill_s", 0.0), stats.get("decode_s", 0.0)
        detok = stats.get("detokenize_s", 0.0)
        tr = obs_trace.Trace()
        tr.add("queue_wait", max(0.0, total_s - prefill - decode - detok))
        tr.add("prefill", prefill)
        tr.add("decode", decode)
        tr.add("detokenize", detok)
        tr.observe_into(m["tpustack_request_phase_latency_seconds"], server="llm")

    def _final_payload(self, stats, stopped_eos: bool, content: str) -> dict:
        """The llama.cpp-shaped result body, shared by the non-streamed
        response and the stream's final event."""
        return {
            "content": content,
            "model": self.model_name,
            "stop": True,
            "stopped_eos": stopped_eos,
            "stopped_limit": not stopped_eos,
            "tokens_evaluated": stats["prompt_tokens"],
            "tokens_predicted": stats["generated_tokens"],
            "timings": {
                "prompt_n": stats["prompt_tokens"],
                "prompt_ms": stats["prefill_s"] * 1e3,
                "predicted_n": stats["generated_tokens"],
                "predicted_ms": stats["decode_s"] * 1e3,
                "predicted_per_second": stats["tokens_per_s"],
            },
        }

    # ------------------------------------------------------------ handlers
    def health(self, req: Request):
        return json_reply(200, {"status": "ok"})

    def healthz(self, req: Request):
        """Liveness + engine state: 503 only when the watchdog declared a
        hung dispatch.  Draining pods stay live: they are finishing
        in-flight work on purpose."""
        status, payload = self.resilience.health_payload(extra={"engine": {
            "model": self.model_name, "slots": self.max_batch, "chunk": self.engine_chunk,
            "queue_depth": len(self._queue), "solo_waiting": self._solo_waiting,
            "running": self._engine is not None,
            "prefix_cache": (self.prefix_cache is not None
                             or (self.paged is not None and self.paged.cache is not None)),
            "paged_kv": self.paged is not None, "engine": self.engine_kind,
            "decode_kernel": self.decode_kernel, "device": str(self.gen.device)}})
        return json_reply(status, payload, self.resilience.health_headers(status))

    def readyz(self, req: Request):
        status, payload = self.resilience.ready_payload()
        return json_reply(status, payload, self.resilience.ready_headers(status))

    def admin_drain(self, req: Request):
        """Authenticated reversible drain (``POST /admin/drain``): readiness
        flips 503 with ``X-Shed-Reason: draining`` and admission sheds, while
        in-flight work finishes and the process stays up; ``{"undrain":
        true}`` reverses it.  ``X-Admin-Token`` must equal
        ``TPUSTACK_ADMIN_TOKEN``; an unset knob disables the surface (403)."""
        expected = knobs.get_str("TPUSTACK_ADMIN_TOKEN")
        presented = req.headers.get("X-Admin-Token", "")
        if not expected or not hmac.compare_digest(presented, expected):
            self.metrics["tpustack_llm_requests_rejected_total"].labels(
                reason="admin_forbidden").inc()
            return json_reply(403, {"error": "forbidden", "detail": "missing or bad "
                                    "X-Admin-Token (or TPUSTACK_ADMIN_TOKEN unset)"})
        try:
            body = req.json()
        except ValueError:
            body = {}  # an empty or unparseable body is a plain drain request
        undrain = bool(isinstance(body, dict) and body.get("undrain"))
        changed = (self.resilience.admin_undrain() if undrain
                   else self.resilience.admin_drain())
        status, _ = self.resilience.ready_payload()
        return json_reply(200, {"ok": True, "action": "undrain" if undrain else "drain",
                                "changed": changed, "draining": self.resilience.draining,
                                "state": self.resilience.state_name, "readyz_status": status,
                                "inflight": self.resilience.inflight})

    def props(self, req: Request):
        rt = self.paged
        kernel = self.decode_kernel
        sc = self.spec_cfg
        enabled = sc is not None and self.batchable  # the solo path decodes plain
        if rt is not None:
            paged_kv = dict(rt.stats(), enabled=True, dense_fallback=False, kernel=kernel,
                            prefill_chunk_tokens=knobs.get_int("TPUSTACK_PREFILL_CHUNK_TOKENS"))
            cache = rt.cache.stats() if rt.cache is not None else {"enabled": False}
        else:
            paged_kv = {"enabled": False, "dense_fallback": True}
            cache = (self.prefix_cache.stats() if self.prefix_cache is not None
                     else {"enabled": False})
        return json_reply(200, {
            "model": self.model_name,
            "n_ctx": self.gen.cfg.max_seq,
            "backend": f"torch/{self.gen.device.type}",
            "slots": self.max_batch,
            "engine": self.engine_kind,
            "quant": self.gen.cfg.quant,
            "kv_quant": self.gen.cfg.kv_quant,
            "decode_kernel": kernel,
            "paged_kv": paged_kv,
            "prefix_cache": cache,
            "speculative": {
                "enabled": enabled,
                "tokens": sc.tokens if enabled else 0,
                "drafter": ((type(sc.drafter).__name__ if sc.drafter is not None
                             else "prompt_lookup") if enabled else None),
                "drafted_tokens": self._spec_drafted,
                "accepted_tokens": self._spec_accepted,
                "acceptance_ratio": (self._spec_accepted / self._spec_drafted
                                     if self._spec_drafted else 0.0),
            },
        })

    def _params(self, body, n_key: str):
        n_predict = int(_or_default(body.get(n_key), 128))
        if n_predict < 0:  # llama.cpp: -1 means until EOS / the context limit
            n_predict = self.gen.cfg.max_seq
        return dict(n_predict=n_predict,
                    temperature=float(_or_default(body.get("temperature"), 0.8)),
                    seed=_normalize_seed(body.get("seed")),
                    cache_prompt=bool(_or_default(body.get("cache_prompt"), True)),
                    speculative=bool(_or_default(body.get("speculative"), True)))

    def _run_completion(self, prompt, params, top_k, deadline_s, error_body):
        """``(result, None)`` or ``(None, error reply)``."""
        try:
            return self.complete(prompt, top_k=top_k, deadline_s=deadline_s, **params), None
        except OutOfKVBlocks as e:
            return None, json_reply(429, error_body(str(e)),
                                    shed_headers("out_of_kv_blocks", e.retry_after_s))
        except BadRequest as e:
            return None, json_reply(400, error_body(str(e)))
        except DeadlineExceeded as e:
            self.resilience.note_deadline(e.phase)
            return None, json_reply(504, dict(error_body(str(e)), phase=e.phase),
                                    shed_headers("deadline"))
        except InjectedDeviceError as e:
            return None, self.resilience.transient_error_response(e)

    def _parse(self, req: Request, n_key: str, error_body):
        """``(body, params, deadline_s, None)`` or an error reply last."""
        try:
            body = req.json()
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError):
            self.metrics["tpustack_llm_requests_rejected_total"].labels(
                reason="invalid_json").inc()
            return None, None, None, json_reply(400, error_body("invalid json"))
        try:
            params = self._params(body, n_key)
            deadline_s = self.resilience.deadline(body.get("timeout_s"))
        except (TypeError, ValueError) as e:
            self.metrics["tpustack_llm_requests_rejected_total"].labels(
                reason="bad_parameter").inc()
            return None, None, None, json_reply(400, error_body(f"invalid parameter: {e}"))
        return body, params, deadline_s, None

    def completion(self, req: Request):
        error_body = lambda m: {"error": m}  # noqa: E731
        body, params, deadline_s, err = self._parse(req, "n_predict", error_body)
        if err is not None:
            return err
        prompt = body.get("prompt", "")
        if not isinstance(prompt, str) or not prompt:
            self.metrics["tpustack_llm_requests_rejected_total"].labels(
                reason="empty_prompt").inc()
            return json_reply(400, {"error": "prompt is required"})
        try:
            top_k = int(_or_default(body.get("top_k"), 40))
        except (TypeError, ValueError) as e:
            return json_reply(400, {"error": f"invalid parameter: {e}"})
        if body.get("stream"):
            return self._stream(req, prompt, params, top_k, deadline_s, "llamacpp")
        t0 = time.time()
        res, err = self._run_completion(prompt, params, top_k, deadline_s, error_body)
        if err is not None:
            return err
        content, stats, stopped_eos = res
        log.info("completion: %d prompt tok, %d gen tok, %.2fs", stats["prompt_tokens"],
                 stats["generated_tokens"], time.time() - t0)
        return json_reply(200, self._final_payload(stats, stopped_eos, content))

    def tokenize(self, req: Request):
        body = req.json()
        return json_reply(200, {"tokens": self.tok.encode(str(body.get("content", "")),
                                                          add_bos=False)})

    def detokenize(self, req: Request):
        return json_reply(200, {"content": self.tok.decode(req.json().get("tokens", []))})

    def chat_completions(self, req: Request):
        error_body = lambda m: {"error": {"message": m}}  # noqa: E731
        body, params, deadline_s, err = self._parse(req, "max_tokens", error_body)
        if err is not None:
            return err
        messages = body.get("messages", [])
        if not messages:
            return json_reply(400, error_body("messages required"))
        # the JAX server's generic template (no model-specific tokens)
        prompt = "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}"
                           for m in messages) + "\nassistant:"
        if body.get("stream"):
            return self._stream(req, prompt, params, 40, deadline_s, "openai")
        res, err = self._run_completion(prompt, params, 40, deadline_s, error_body)
        if err is not None:
            return err
        content, stats, stopped_eos = res
        return json_reply(200, {
            "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0, "message": {"role": "assistant", "content": content},
                         "finish_reason": "stop" if stopped_eos else "length"}],
            "usage": {"prompt_tokens": stats["prompt_tokens"],
                      "completion_tokens": stats["generated_tokens"],
                      "total_tokens": stats["prompt_tokens"] + stats["generated_tokens"]},
        })

    def _stream(self, req: Request, prompt: str, params: dict, top_k: int,
                deadline_s: Optional[float], fmt: str):
        """Server-sent events for ``/completion`` (llama.cpp chunks, a final
        event with the body's fields) and ``/v1/chat/completions`` (OpenAI
        ``chat.completion.chunk`` events, then ``[DONE]``).

        Paged admission runs before the SSE head goes out, so a 429 or 400
        is still a JSON reply with its status.  The row's tokens arrive once
        per engine wave; each becomes a text delta
        (:class:`IncrementalDetokenizer`).  A write that fails (the client
        went away) or blocks past the socket timeout cancels the row, which
        the engine retires at its next chunk boundary, freeing its blocks.
        Past the deadline the stream ends with an error event (the status
        already went out as 200)."""
        openai = fmt == "openai"
        error_body = (lambda m: {"error": {"message": m}}) if openai else (lambda m: {"error": m})
        t0 = time.perf_counter()
        try:
            r = self._admit(prompt, params["n_predict"], params["temperature"], top_k,
                            params["seed"], params["cache_prompt"], params["speculative"],
                            stream=True)
        except OutOfKVBlocks as e:
            return json_reply(429, error_body(str(e)),
                              shed_headers("out_of_kv_blocks", e.retry_after_s))
        except BadRequest as e:
            return json_reply(400, error_body(str(e)))
        try:
            req.start_stream(200, {"Content-Type": "text/event-stream",
                                   "Cache-Control": "no-cache"})
        except BaseException:
            self._release(r)  # never queued: nothing else would free its blocks
            raise
        self._enqueue(r)
        chat_id, created = f"chatcmpl-{uuid.uuid4().hex[:12]}", int(time.time())

        def chat_chunk(delta, finish=None):
            return {"id": chat_id, "object": "chat.completion.chunk", "created": created,
                    "model": self.model_name,
                    "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}

        def send(payload) -> None:
            req.write(b"data: " + json.dumps(payload).encode() + b"\n\n")

        def send_text(text: str) -> None:
            send(chat_chunk({"content": text}) if openai else {"content": text, "stop": False})

        def send_error(msg: str) -> None:
            send(dict(chat_chunk({}, finish="error"), error={"message": msg}) if openai
                 else {"content": "", "stop": True, "error": msg})

        detok = IncrementalDetokenizer(self.tok)
        t_end = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            if openai:
                send(chat_chunk({"role": "assistant", "content": ""}))
            while True:
                try:
                    tok = r.stream.get(timeout=None if t_end is None
                                       else max(t_end - time.monotonic(), 0.001))
                except queue.Empty:
                    raise DeadlineExceeded(r.phase) from None
                if tok is None:
                    break
                delta = detok.push(tok)
                if delta:
                    send_text(delta)
            if r.error is not None:  # the stream already started: a final error event
                req.tenant_outcome = "error"
                send_error(str(r.error))
                return None
            tail = detok.flush()
            if tail:
                send_text(tail)
            out_ids, stats = r.result
            stopped_eos = bool(out_ids) and out_ids[-1] == self.tok.eos_id
            self._observe_done(len(r.ids), stats, time.perf_counter() - t0)
            if openai:
                send(chat_chunk({}, finish="stop" if stopped_eos else "length"))
                req.write(b"data: [DONE]\n\n")
            else:
                send(self._final_payload(stats, stopped_eos, content=""))
            log.info("stream %s: %d prompt tok, %d gen tok, %.2fs", fmt,
                     stats["prompt_tokens"], stats["generated_tokens"],
                     time.perf_counter() - t0)
        except DeadlineExceeded as e:
            r.cancel.set()
            req.tenant_outcome = "deadline"  # the 200 already went out
            self.resilience.note_deadline(e.phase)
            send_error(str(e))
        except OSError:
            # the client is gone or stopped reading: retire its row
            r.cancel.set()
            log.info("stream %s: client gone, row cancelled", fmt)
        return None

    # ---------------------------------------------------------------- http
    def handler_class(self):
        """The request handler: routes behind the resilience gate and the
        HTTP instrumentation."""
        routes = obs_http.Routes()
        for path, fn in (("/health", self.health), ("/healthz", self.healthz),
                         ("/readyz", self.readyz), ("/props", self.props)):
            routes.add_get(path, fn)
        for path, fn in (("/completion", self.completion), ("/tokenize", self.tokenize),
                         ("/detokenize", self.detokenize),
                         ("/v1/chat/completions", self.chat_completions),
                         ("/admin/drain", self.admin_drain)):
            routes.add_post(path, fn)
        obs_http.add_metrics_route(routes, self._registry)
        obs_http.add_debug_trace_routes(routes, self.tracer)
        obs_http.add_debug_flight_routes(routes, self.flight)
        obs_http.add_debug_tenant_routes(routes, self.ledger, qos=self.qos)
        dispatch = obs_http.instrument("llm", self._registry, self.tracer, ledger=self.ledger,
                                       work_endpoints=WORK_ENDPOINTS)(
            self.resilience.middleware(WORK_ENDPOINTS)(
                obs_http.route(json_reply(404, {"error": "not found"}))))
        return obs_http.handler_class(routes, dispatch)

    def start(self, host: str = "0.0.0.0", port: int = 8080) -> int:
        """Serve on a daemon thread; returns the bound port (0 picks one)."""
        self._httpd = ThreadingHTTPServer((host, port), self.handler_class())
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="llm-server",
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join()
            self._httpd = self._thread = None
        self._stop = True
        self._wake.set()
        if self._engine_thread is not None:
            self._engine_thread.join(timeout=60)
        self.resilience.close()


def main() -> None:
    server = LLMServer()
    port = server.start(port=_env_int("PORT", 8080))
    # SIGTERM -> drain: readiness 503, in-flight completions finish, exit 0
    server.resilience.install_signal_handlers()
    log.info("LLM server on port %d (model %s, device %s, %d slots, decode kernel %s)", port,
             server.model_name, server.gen.device, server.max_batch, server.decode_kernel)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
