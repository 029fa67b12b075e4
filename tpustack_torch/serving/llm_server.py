"""llama.cpp-style LLM server for the PyTorch port, on the standard library.

The HTTP surface of ``tpustack/serving/llm_server.py`` (itself llama.cpp's
server's), served by ``http.server.ThreadingHTTPServer``:

- ``GET /health`` -> ``{"status": "ok"}``; ``GET /healthz`` -> liveness and
  engine state
- ``GET /props`` -> model, ctx, slots, paged pool and prefix-cache stats,
  speculative drafted/accepted, ``decode_kernel``
- ``POST /completion`` -> ``{content, model, stop, stopped_eos,
  stopped_limit, tokens_evaluated, tokens_predicted, timings}``
- ``POST /tokenize`` -> ``{tokens}``; ``POST /detokenize`` -> ``{content}``
- ``POST /v1/chat/completions`` -> an OpenAI ``chat.completion``

Every completion goes through the paged continuous engine
(``models.llm_continuous``): slots hold block tables into one KV pool,
admission is allocation (a request that the pool cannot cover, even after
evicting unreferenced cached blocks, gets 429 with ``Retry-After`` from the
in-flight requests' projected block release), a prefix-cache hit shares the
cached blocks, and prompt-lookup speculation is on.  One engine thread runs
the engine whenever requests are queued; handler threads wait on their
request.

Env (the JAX server's names): ``LLM_PRESET`` (``qwen25_7b`` | ``llama2_7b``
| ``tiny``), ``LLM_CTX`` (4096), ``LLM_KV_QUANT`` (``int8``),
``LLM_MAX_BATCH`` (8 slots), ``LLM_CHUNK`` / ``LLM_ENGINE_CHUNK`` (engine
chunk ``min(LLM_CHUNK, 16)``), ``TPUSTACK_KV_BLOCK``,
``TPUSTACK_KV_POOL_BLOCKS``, ``TPUSTACK_PREFIX_CACHE``,
``TPUSTACK_SPEC_TOKENS`` (4), ``TPUSTACK_SPEC_NGRAM`` (3),
``TPUSTACK_PAGED_FLASH`` (``auto``: the paged kernel on CUDA), ``PORT``
(8080), and ``LLM_DEVICE`` (default the first GPU; ``cpu`` to run on the
CPU).  Weights are drawn from seed 0, as the JAX server's are without a
checkpoint.

Not ported yet, and refused rather than served some other way: streaming
(``"stream": true`` -> 400), ``LLM_MAX_BATCH < 2`` (the dense solo engine),
``TPUSTACK_PAGED_KV=0`` (the dense engine), ``LLM_TP``, ``LLM_QUANT``,
``MODEL_DIR``, ``LLM_TOKENIZER_DIR`` and ``TPUSTACK_SPEC_DRAFT`` (startup
errors).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import torch

from tpustack_torch.utils import get_logger

log = get_logger("serving.llm_server")


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
    if os.environ.get("LLM_QUANT"):
        raise _not_ported("LLM_QUANT (weight-only int8)")
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
    kv_quant = os.environ.get("LLM_KV_QUANT", "").lower() or None
    if kv_quant not in (None, "int8"):
        raise ValueError(f"LLM_KV_QUANT={kv_quant!r} unsupported (want int8)")
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    gen = Generator(cfg, dtype=dtype, seed=0, device=os.environ.get("LLM_DEVICE") or None)
    return gen, load_text_tokenizer(cfg.vocab_size), preset


def build_paged(gen, max_batch: int, block: Optional[int] = None,
                n_blocks: Optional[int] = None, prefix_cache: Optional[bool] = None):
    """The paged KV runtime: block size ``TPUSTACK_KV_BLOCK`` (default
    ``min(64, max(8, ctx / 8))``, snapped down to divide ctx), pool
    ``TPUSTACK_KV_POOL_BLOCKS`` (default ``max_batch * ctx / block``, dense
    parity) plus the reserved block 0, prefix cache per
    ``TPUSTACK_PREFIX_CACHE``."""
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
    log.info("paged KV pool: %d blocks x %d tokens (ctx %d), %.2f GB, prefix cache %s",
             n_blocks, block, max_seq, rt.pool_bytes / 1e9, "on" if prefix_cache else "off")
    return rt


def build_spec():
    """The speculation config from ``TPUSTACK_SPEC_TOKENS`` (0 = off) and
    ``TPUSTACK_SPEC_NGRAM``."""
    from tpustack_torch.serving.speculative import SpecConfig

    if os.environ.get("TPUSTACK_SPEC_DRAFT"):
        raise _not_ported("TPUSTACK_SPEC_DRAFT (a draft-model drafter)")
    k = _env_int("TPUSTACK_SPEC_TOKENS", 4)
    if k <= 0:
        return None
    return SpecConfig(tokens=k, ngram_max=max(1, _env_int("TPUSTACK_SPEC_NGRAM", 3)))


class _Pending:
    """A completion waiting for (or decoding in) the engine."""

    __slots__ = ("ids", "n_predict", "sample", "seed", "prefix", "kv_blocks",
                 "on_prefill_blocks", "speculative", "phase", "done", "result", "error")

    def __init__(self, ids, n_predict, sample, seed, prefix, kv_blocks, on_prefill_blocks,
                 speculative):
        self.ids, self.n_predict, self.sample, self.seed = ids, n_predict, sample, seed
        self.prefix, self.kv_blocks = prefix, kv_blocks
        self.on_prefill_blocks = on_prefill_blocks
        self.speculative = speculative
        self.phase = "queued"  # the server owns the pool references until "decode"
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class LLMServer:
    """llama.cpp-surface server over the paged continuous engine."""

    _FROM_ENV = object()

    def __init__(self, generator=None, tokenizer=None, model_name: str = "tpustack_torch",
                 max_batch: Optional[int] = None, paged=_FROM_ENV, spec=_FROM_ENV):
        if generator is None:
            generator, tokenizer, model_name = _build_generator()
        self.gen, self.tok, self.model_name = generator, tokenizer, model_name
        self.max_batch = _env_int("LLM_MAX_BATCH", 8) if max_batch is None else max_batch
        if self.max_batch < 2:
            raise _not_ported(f"LLM_MAX_BATCH={self.max_batch} (the dense solo engine)")
        if not _env_bool("TPUSTACK_PAGED_KV", True):
            raise _not_ported("TPUSTACK_PAGED_KV=0 (the dense per-slot engine)")
        self.paged = build_paged(self.gen, self.max_batch) if paged is LLMServer._FROM_ENV \
            else paged
        if self.paged is None:
            raise _not_ported("serving without a paged KV pool (the dense engine)")
        self.spec_cfg = build_spec() if spec is LLMServer._FROM_ENV else spec
        from tpustack_torch.models.llm_generate import resolve_paged_flash

        self.paged_flash = resolve_paged_flash(self.gen.device)
        chunk = max(1, _env_int("LLM_CHUNK", 32))
        override = _env_int("LLM_ENGINE_CHUNK", 0)
        self.engine_chunk = override if override > 0 else min(chunk, 16)
        self._queue: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._stop = False
        self._engine = None
        self._spec_drafted = self._spec_accepted = 0
        #: stats of every finished engine run, newest last
        self.run_log: collections.deque = collections.deque(maxlen=256)
        self._engine_thread = threading.Thread(target=self._engine_loop, name="llm-engine",
                                               daemon=True)
        self._engine_thread.start()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ engine
    def _note_spec(self, drafted: int, accepted: int) -> None:
        self._spec_drafted += drafted
        self._spec_accepted += accepted

    def _release(self, r: _Pending) -> None:
        """Give back a queued request's pool references after a failed run
        (the engine owns them once the request is handed to a slot)."""
        if r.phase != "queued":
            return
        ids = list(r.kv_blocks or [])
        if r.prefix:
            ids += list(r.prefix[1])
        r.kv_blocks, r.prefix = None, None
        if ids:
            self.paged.pool.decref(ids)

    def _slot_request(self, r: _Pending):
        from tpustack_torch.models.llm_continuous import SlotRequest

        def on_done(tokens, stats):
            if tokens is None:
                r.error = BadRequest(stats.get("error", "bad request"))
            else:
                r.result = (tokens, stats)
            r.done.set()

        return SlotRequest(ids=r.ids, max_new=r.n_predict, sample=r.sample, on_done=on_done,
                           seed=r.seed, prefix=r.prefix,
                           kv_blocks=r.kv_blocks, on_prefill_blocks=r.on_prefill_blocks,
                           speculative=r.speculative)

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
                if not self._queue:
                    return None
                r = self._queue.popleft()
                r.phase = "decode"
                handed.append(r)
                return self._slot_request(r)

            engine = ContinuousEngine(self.gen, self.paged, slots=self.max_batch,
                                      chunk=self.engine_chunk, stop_tokens=(self.tok.eos_id,),
                                      paged_flash=self.paged_flash, spec=self.spec_cfg,
                                      on_spec=self._note_spec)
            self._engine = engine
            try:
                stats = engine.run(feed)
                self.run_log.append(stats)
                log.info("engine run: %d requests, %d tokens, %.1f tok/s aggregate",
                         stats["requests"], stats["generated_tokens"], stats["tokens_per_s"])
            except Exception as e:  # fail every waiter; the server stays up
                log.exception("engine run failed")
                while self._queue:
                    handed.append(self._queue.popleft())
                for r in handed:
                    self._release(r)
                    if not r.done.is_set():
                        r.error = e
                        r.done.set()
            finally:
                self._engine = None
                if self._queue:
                    self._wake.set()

    # ----------------------------------------------------- paged admission
    def _retry_after(self, shortfall_blocks: int) -> int:
        eng = self._engine
        est = eng.projected_block_release_s(shortfall_blocks) if eng is not None else 1.0
        return min(max(1, math.ceil(est)), 120)

    def _paged_admit(self, ids, n_predict: int, cache_prompt: bool):
        """Admission is allocation: a prefix hit increfs the shared blocks,
        the rest allocates fresh blocks (evicting unreferenced cached ones
        first); a shortfall raises :class:`OutOfKVBlocks`.  Returns
        ``(prefix, kv_blocks, on_prefill_blocks)``."""
        from tpustack_torch.serving.kv_pool import OutOfBlocks

        rt = self.paged
        prefix = None
        if rt.cache is not None and cache_prompt:
            m = rt.cache.match(ids)
            if m.length:
                prefix = (m.length, m.block_ids)
        n_shared = len(prefix[1]) if prefix else 0
        fresh_tokens = rt.need_tokens(len(ids), max(0, n_predict)) - n_shared * rt.block
        need_fresh = rt.pool.blocks_for(fresh_tokens)
        if n_shared + need_fresh > rt.pool.capacity_blocks:
            if prefix:
                rt.pool.decref(prefix[1])
            raise BadRequest(f"request needs {n_shared + need_fresh} KV blocks; the pool "
                             f"holds {rt.pool.capacity_blocks} (TPUSTACK_KV_POOL_BLOCKS)")
        try:
            rt.ensure_free(need_fresh)
            kv_blocks = rt.pool.alloc_tokens(fresh_tokens)
        except OutOfBlocks:
            if prefix:
                rt.pool.decref(prefix[1])
            raise OutOfKVBlocks(self._retry_after(need_fresh - rt.pool.n_free)) from None
        on_insert = None
        if rt.cache is not None and cache_prompt and len(ids) // rt.block > n_shared:
            ids_copy = list(ids)

            def on_insert(bids):
                rt.cache.insert(ids_copy, bids)
        return prefix, kv_blocks, on_insert

    def complete(self, prompt: str, n_predict: int = 128, temperature: float = 0.8,
                 top_k: int = 40, seed=None, cache_prompt: bool = True,
                 speculative: bool = True):
        """``(content, stats, stopped_eos)`` for one prompt, through the
        engine.  Raises :class:`BadRequest` or :class:`OutOfKVBlocks`."""
        from tpustack_torch.models.llm_generate import SampleConfig

        ids = self.tok.encode(prompt)
        if not ids:
            raise BadRequest("empty prompt")
        if len(ids) >= self.gen.cfg.max_seq:
            raise BadRequest(f"prompt ({len(ids)} tokens) exceeds ctx {self.gen.cfg.max_seq}")
        prefix, kv_blocks, on_insert = self._paged_admit(ids, n_predict, cache_prompt)
        r = _Pending(ids, n_predict, SampleConfig(temperature=temperature, top_k=top_k,
                                                  greedy=temperature <= 0),
                     seed, prefix, kv_blocks, on_insert, speculative)
        self._queue.append(r)
        self._wake.set()
        r.done.wait()
        if r.error is not None:
            raise r.error
        out_ids, stats = r.result
        stopped_eos = bool(out_ids) and out_ids[-1] == self.tok.eos_id
        if stopped_eos:
            out_ids = out_ids[:-1]
        return self.tok.decode(out_ids), stats, stopped_eos

    def _final_payload(self, stats, stopped_eos: bool, content: str) -> dict:
        """The llama.cpp-shaped result body."""
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
    def health(self, body=None):
        return _json(200, {"status": "ok"})

    def healthz(self, body=None):
        return _json(200, {"ok": True, "engine": {
            "model": self.model_name, "slots": self.max_batch, "chunk": self.engine_chunk,
            "queue_depth": len(self._queue), "running": self._engine is not None,
            "prefix_cache": self.paged.cache is not None, "paged_kv": True,
            "device": str(self.gen.device)}})

    def props(self, body=None):
        rt = self.paged
        kernel = "paged_flash" if self.paged_flash else "gather"
        sc = self.spec_cfg
        return _json(200, {
            "model": self.model_name,
            "n_ctx": self.gen.cfg.max_seq,
            "backend": f"torch/{self.gen.device.type}",
            "slots": self.max_batch,
            "decode_kernel": kernel,
            "paged_kv": dict(rt.stats(), enabled=True, dense_fallback=False, kernel=kernel),
            "prefix_cache": rt.cache.stats() if rt.cache is not None else {"enabled": False},
            "speculative": {
                "enabled": sc is not None,
                "tokens": sc.tokens if sc is not None else 0,
                "drafter": "prompt_lookup" if sc is not None else None,
                "drafted_tokens": self._spec_drafted,
                "accepted_tokens": self._spec_accepted,
                "acceptance_ratio": (self._spec_accepted / self._spec_drafted
                                     if self._spec_drafted else 0.0),
            },
        })

    def _params(self, body, n_key: str):
        if body.get("stream"):
            raise BadRequest('"stream": true is not supported by the PyTorch port yet '
                             "(later work); send it without streaming")
        n_predict = int(_or_default(body.get(n_key), 128))
        if n_predict < 0:  # llama.cpp: -1 means until EOS / the context limit
            n_predict = self.gen.cfg.max_seq
        return dict(n_predict=n_predict,
                    temperature=float(_or_default(body.get("temperature"), 0.8)),
                    seed=_normalize_seed(body.get("seed")),
                    cache_prompt=bool(_or_default(body.get("cache_prompt"), True)),
                    speculative=bool(_or_default(body.get("speculative"), True)))

    def _run_completion(self, prompt, params, top_k, error_body):
        try:
            return self.complete(prompt, top_k=top_k, **params), None
        except OutOfKVBlocks as e:
            return None, (429, {"Content-Type": "application/json",
                                "X-Shed-Reason": "out_of_kv_blocks",
                                "Retry-After": str(e.retry_after_s)},
                          json.dumps(error_body(str(e))).encode())
        except BadRequest as e:
            return None, _json(400, error_body(str(e)))

    def completion(self, body):
        prompt = body.get("prompt", "")
        if not isinstance(prompt, str) or not prompt:
            return _json(400, {"error": "prompt is required"})
        try:
            params = self._params(body, "n_predict")
            top_k = int(_or_default(body.get("top_k"), 40))
        except (TypeError, ValueError) as e:
            return _json(400, {"error": f"invalid parameter: {e}"})
        t0 = time.time()
        res, err = self._run_completion(prompt, params, top_k, lambda m: {"error": m})
        if err is not None:
            return err
        content, stats, stopped_eos = res
        log.info("completion: %d prompt tok, %d gen tok, %.2fs", stats["prompt_tokens"],
                 stats["generated_tokens"], time.time() - t0)
        return _json(200, self._final_payload(stats, stopped_eos, content))

    def tokenize(self, body):
        return _json(200, {"tokens": self.tok.encode(str(body.get("content", "")),
                                                     add_bos=False)})

    def detokenize(self, body):
        return _json(200, {"content": self.tok.decode(body.get("tokens", []))})

    def chat_completions(self, body):
        messages = body.get("messages", [])
        if not messages:
            return _json(400, {"error": {"message": "messages required"}})
        # the JAX server's generic template (no model-specific tokens)
        prompt = "\n".join(f"{m.get('role', 'user')}: {m.get('content', '')}"
                           for m in messages) + "\nassistant:"
        try:
            params = self._params(body, "max_tokens")
        except BadRequest as e:
            return _json(400, {"error": {"message": str(e)}})
        except (TypeError, ValueError) as e:
            return _json(400, {"error": {"message": f"invalid parameter: {e}"}})
        res, err = self._run_completion(prompt, params, 40, lambda m: {"error": {"message": m}})
        if err is not None:
            return err
        content, stats, stopped_eos = res
        return _json(200, {
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

    # ---------------------------------------------------------------- http
    def start(self, host: str = "0.0.0.0", port: int = 8080) -> int:
        """Serve on a daemon thread; returns the bound port (0 picks one)."""
        self._httpd = ThreadingHTTPServer((host, port), _handler_for(self))
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
        self._engine_thread.join(timeout=60)


def _json(status: int, payload: dict):
    return status, {"Content-Type": "application/json"}, json.dumps(payload).encode()


def _handler_for(server: LLMServer):
    gets = {"/health": server.health, "/healthz": server.healthz, "/props": server.props}
    posts = {"/completion": server.completion, "/tokenize": server.tokenize,
             "/detokenize": server.detokenize,
             "/v1/chat/completions": server.chat_completions}

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
            fn = gets.get(self.path.split("?", 1)[0])
            self._reply(*(fn() if fn else _json(404, {"error": "not found"})))

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            if n > 16 << 20:
                self._reply(*_json(413, {"error": "body too large"}))
                return
            raw = self.rfile.read(n)
            fn = posts.get(self.path.split("?", 1)[0])
            if fn is None:
                self._reply(*_json(404, {"error": "not found"}))
                return
            try:
                body = json.loads(raw or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError):
                self._reply(*_json(400, {"error": "invalid json"}))
                return
            try:
                reply = fn(body)
            except Exception as e:
                log.exception("%s failed", self.path)
                reply = _json(500, {"error": f"{type(e).__name__}: {e}"})
            self._reply(*reply)

        def log_message(self, fmt, *args):  # access log off, as in the JAX server
            pass

    return Handler


def main() -> None:
    server = LLMServer()
    port = server.start(port=_env_int("PORT", 8080))
    log.info("LLM server on port %d (model %s, device %s, %d slots, decode kernel %s)", port,
             server.model_name, server.gen.device, server.max_batch,
             "paged_flash" if server.paged_flash else "gather")
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
