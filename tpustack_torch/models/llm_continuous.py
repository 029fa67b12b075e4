"""Continuous batching: the port of
``tpustack/models/llm_continuous.py::ContinuousEngine``.

llama.cpp slot semantics: ``B`` persistent slots; a request joins at the
next chunk boundary and a finished row is answered and its slot freed at
once.  With a paged runtime (``serving.kv_pool.PagedKVRuntime``, the
default) each slot's cache line is a block table into the shared pool and a
prefix-cache hit installs the shared blocks in the table and prefills only
the suffix.  With ``paged=None`` (the ``TPUSTACK_PAGED_KV=0`` engine) each
slot owns a dense ``[max_seq]`` cache line for the run, a dense prefix-store
hit (``prefix=(n_cached, kv, key)``) restores the stored KV into the row
before the suffix prefill, and ``kv_extract``/``on_prefill_kv`` hand a
finished prefill's prompt KV to the store.

The loop keeps ``depth`` plain decode chunks in flight (each chunk's first
token is the previous chunk's last, on the device) and fetches one chunk
behind the frontier; admissions are dispatched between chunks and resolved
when their first tokens are fetched.  With ``spec`` set, whenever the host
is caught up and some slot has a prompt-lookup draft, one verify step scores
up to ``spec.tokens`` drafts per slot in one forward pass instead.

The host holds the per-slot frontier ``cur``, ``active`` and the sampling
settings (the JAX engine keeps them on the device); the device holds the
pool, the chunk's first tokens and the token blocks in flight.

Stats keep the JAX engine's ``decode_kernel``,
``kernel_paged_flash_dispatches`` and ``kernel_gather_dispatches``, and add
``kernel_forward_steps``: forward passes that read the pool through the
chosen view (``chunk`` per plain dispatch, one per verify), so a run's paged
kernel launches are exactly ``n_layers * kernel_forward_steps``.

Serving hooks, as in the JAX engine: each request's ``on_tokens`` gets its
accepted tokens once per fetched wave (the SSE cadence), ``cancelled()`` is
polled at every chunk boundary and retires the row, releasing its blocks (a
deadline or a disconnected stream), ``span_ctx`` parents the row's
``prefill`` and ``wave`` spans under its HTTP root span, ``on_progress``
hears ``"prefill"`` before each admission dispatch and ``"wave"`` at each
fetched wave (the watchdog's beats and the fault injector's points), and a
flight recorder gets one record per wave, carrying the wave's ``tenants``
and ``priorities`` splits (``{tenant: slots}``, ``{priority: slots}``).

Tenant accounting (``ledger``, an ``obs.accounting.TenantLedger``): each
wave's chip-seconds are charged FROM its flight record (the wave's wall
time split by its ``tenants`` map, so ``/debug/flight`` and
``/debug/tenants`` hold the same numbers) and each row's KV-block-seconds at
retirement (blocks held x seconds since ``t_kv_alloc``).

QoS preemption (``preempt_hint``, ``on_preempt``): when the hint says an
interactive request waits and every slot is busy, the engine parks one
``batch`` row at a wave boundary, only once no admission wave is pending
(the port overlaps an admission with the next dispatch).  The parked entry
keeps the row's pool block references and its history (prompt + tokens so
far) and re-admits, once a slot is free and the queue is empty, through the
prefix warm start with ``plen = len(history) - 1``: no prefill work is
lost, and a greedy row's output is the uninterrupted run's.  The slot's
speculation state (drafts, the acceptance EMA) is not carried over.
Parked entries are released when their request is cancelled and when a
run fails.

Chunked prefill (``prefill_chunk``, the ``TPUSTACK_PREFILL_CHUNK_TOKENS``
knob; paged only): a prompt whose uncached remainder exceeds the chunk
prefills ONE block-aligned chunk per admission (``_chunk_prefill_step``) and
parks the rest as a warm continuation holding every block of its footprint
(admission charged it up front), so decode waves of the other slots run
between chunks; the final chunk is the ordinary warm start, which samples
the first token as a monolithic prefill would.  Retire stats carry
``prefill_chunks``, and run stats ``prefill_chunks`` when the knob is on.

The host KV tier (``serving.kv_host_tier``): a request whose prefix match
claimed spilled payloads carries ``host_restore=(block_ids, payloads)``;
the engine writes them into their fresh blocks on its stream right before
the warm start that reads them (``_dispatch_restore``) and keeps the
payloads alive until that wave resolves; each resolve reports the wave's
prefill wall per block to the tier's crossover guard.

Left out: the sanitizer.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpustack_torch.models.llama import init_kv_caches
from tpustack_torch.models.llm_generate import Generator, SampleConfig, resolve_paged_flash
from tpustack_torch.serving.kv_pool import OutOfBlocks, eta_until_blocks
from tpustack_torch.utils import get_logger, knobs

log = get_logger("models.llm_continuous")


@dataclasses.dataclass
class SlotRequest:
    """One request.  ``on_tokens(toks)``: the row's accepted new tokens,
    once per fetched wave (a terminal stop token included).
    ``on_done(tokens, stats)``: once, at retirement (``tokens`` None and
    ``stats["error"]`` when admission failed).  ``cancelled()``: polled at
    chunk boundaries; True retires the row without further decode.
    ``seed``: the slot generator's seed (None draws one).  ``span_ctx``: the
    request's trace context (``obs.trace.SpanContext``), passed explicitly
    because engine threads do not inherit the handler's contextvars.

    ``prefix``: ``(n_cached, block_ids)``, shared pool blocks the lookup
    already incref'd (paged), or ``(n_cached, kv[, key])``, a dense
    prefix-store hit's host KV; ``kv_blocks``: fresh blocks the server
    allocated at admission (None lets the engine allocate);
    ``on_prefill_blocks(ids)``: the prompt's full blocks once prefill has
    landed (the paged cache insert); ``kv_extract``/``on_prefill_kv``: the
    dense engine's insert, the ``(start, end)`` positions of the prompt's KV
    handed over as host tensors.  ``speculative=False`` keeps this row from
    drafting."""

    ids: List[int]
    max_new: int
    sample: SampleConfig
    on_tokens: Optional[Callable[[List[int]], None]] = None
    on_done: Optional[Callable[[Optional[List[int]], Dict], None]] = None
    cancelled: Callable[[], bool] = lambda: False
    seed: Optional[int] = None
    prefix: Optional[Tuple[int, list]] = None
    span_ctx: Optional[object] = None
    kv_blocks: Optional[List[int]] = None
    on_prefill_blocks: Optional[Callable[[List[int]], None]] = None
    speculative: bool = True
    # tenant accounting: the request's tenant (resolved once by the HTTP
    # instrumentation, carried here because engine threads do not inherit
    # the contextvar) and the wall clock its pool blocks were allocated at
    # (None: the engine's own admission time)
    tenant: Optional[str] = None
    t_kv_alloc: Optional[float] = None
    # QoS priority class, "interactive" | "batch"; None (QoS off) neither
    # preempts nor can be preempted
    priority: Optional[str] = None
    kv_extract: Optional[Tuple[int, int]] = None
    on_prefill_kv: Optional[Callable[[list], None]] = None
    # host-tier restore: fresh pool blocks (the tail of ``prefix[1]``) and
    # the claimed host payloads the engine writes into them before the warm
    # start; None = no host hit
    host_restore: Optional[Tuple[List[int], list]] = None
    # chunked-prefill continuation: (the original request's cache-hit
    # length, chunk dispatches so far), carried across the park/resume hops
    # a long prompt takes; None = not a continuation
    chunk_cont: Optional[Tuple[int, int]] = None


class _Slot:
    __slots__ = ("req", "out", "budget", "gen_id", "t0", "prefill_s", "dispatched", "done",
                 "pending", "cached", "blocks", "alloc", "spec_ema", "spec_idle",
                 "stride_ema", "span")

    def __init__(self):
        self.req: Optional[SlotRequest] = None
        self.out: List[int] = []
        self.budget = 0
        self.gen_id = -1
        self.t0 = 0.0
        self.prefill_s = 0.0
        self.dispatched = 0   # decode steps dispatched for this occupancy
        self.done = True
        self.pending = False  # admission dispatched, first token not fetched
        self.cached = 0       # prompt tokens served by the prefix cache
        self.blocks: List[int] = []  # pool blocks this slot holds a reference on
        self.alloc = 0        # tokens this slot's allocation covers
        self.spec_ema = 1.0
        self.spec_idle = 0
        self.stride_ema = 1.0
        self.span = None      # the row's open prefill or wave span


class _PendingWave:
    """A dispatched admission group whose first tokens are not fetched yet."""

    __slots__ = ("rows", "firsts_dev", "t0", "ready", "block_inserts", "extracts", "keep")

    def __init__(self, rows, firsts_dev, t0, ready, block_inserts=(), extracts=(), keep=()):
        self.rows = rows                    # [(slot, req, budget)]
        self.firsts_dev = firsts_dev
        self.t0 = t0
        self.ready = ready                  # CUDA event after the admission, or None
        self.block_inserts = list(block_inserts)  # [(req, prompt block ids)]
        self.extracts = list(extracts)      # dense: [(req, device KV slices)]
        self.keep = list(keep)              # host payloads the wave's restore reads


class ContinuousEngine:
    """Drives :class:`Generator`'s paged (``paged`` a runtime) or dense-slot
    (``paged=None``) programs over persistent slots.  ``run(feed)`` decodes
    until every admitted request is answered and ``feed()`` returns None."""

    def __init__(self, gen: Generator, paged=None, slots: int = 8, chunk: int = 16,
                 stop_tokens: Tuple[int, ...] = (), depth: int = 2,
                 paged_flash: Optional[bool] = None, spec=None,
                 on_spec: Optional[Callable[[int, int], None]] = None,
                 on_progress: Optional[Callable[[str], None]] = None, tracer=None,
                 flight=None, queue_depth: Optional[Callable[[], int]] = None, ledger=None,
                 preempt_hint: Optional[Callable[[], bool]] = None,
                 on_preempt: Optional[Callable[[Optional[str]], None]] = None,
                 prefill_chunk: Optional[int] = None):
        if paged is not None and gen.cfg.max_seq != paged.max_seq:
            raise ValueError(f"paged runtime max_seq {paged.max_seq} != engine config "
                             f"{gen.cfg.max_seq}")
        self.gen = gen
        self.paged = paged
        self.B = slots
        self.chunk = chunk
        self.stop_tokens = stop_tokens
        self.depth = depth
        self.spec = spec if (spec is not None and getattr(spec, "tokens", 0) > 0) else None
        self._drafter = None
        if self.spec is not None:
            self._drafter = self.spec.drafter
            if self._drafter is None:
                from tpustack_torch.serving.speculative import PromptLookupDrafter

                self._drafter = PromptLookupDrafter(ngram_max=self.spec.ngram_max,
                                                    ngram_min=self.spec.ngram_min)
        self.on_spec = on_spec
        # the resilience layer's progress points and the observability
        # hooks; all None keeps the engine hook-free
        self._on_progress = on_progress
        self.tracer = tracer
        self.flight = flight
        self._queue_depth_fn = queue_depth
        # the tenant ledger; None keeps the engine accounting-free
        self.ledger = ledger
        # QoS preemption hooks; both None (TPUSTACK_QOS=0) keep the loop
        # the preemption-free engine
        self._preempt_hint = preempt_hint
        self._on_preempt = on_preempt
        self._parked: List[SlotRequest] = []
        self._preempted = self._resumed = 0
        self._last_wave_t: Optional[float] = None
        if paged is None:
            self.paged_flash = False
        elif paged_flash is None:
            self.paged_flash = resolve_paged_flash(
                gen.device, gen.cfg, gen.cache_dtype, paged.block,
                self.spec.tokens if self.spec is not None else 0, slots)
        else:
            self.paged_flash = bool(paged_flash)
        # chunked prefill (paged only): 0 keeps admission the monolithic one
        if prefill_chunk is None:
            prefill_chunk = knobs.get_int("TPUSTACK_PREFILL_CHUNK_TOKENS")
        self._chunk_tokens = max(0, int(prefill_chunk)) if paged is not None else 0
        self._prefill_chunks = 0
        # host payloads of chunk-step restores, held until their copy ran
        self._restore_keep: List[Tuple[object, list]] = []
        self._draft_memo: Dict[int, Tuple[Tuple[int, int, int], List[int]]] = {}
        self._bt = (np.zeros((slots, paged.blocks_per_seq), np.int32) if paged is not None
                    else None)
        self._slots_view = None
        self._pending: List[_PendingWave] = []
        self._to_park: List[int] = []
        self._retired_tokens = 0
        self._marks_lock = threading.Lock()  # guards _wave_ctr/_first/_last (server reads)
        self._reset_counters()

    def _reset_counters(self):
        self._last_wave_t = None
        self._spec_drafted = self._spec_accepted = 0
        self._spec_dispatches = self._plain_steps = 0
        self._gather_dispatches = self._flash_dispatches = 0
        self._forward_steps = 0
        with self._marks_lock:
            self._wave_ctr, self._wave_first, self._wave_last = 0, 0.0, 0.0

    # ------------------------------------------------------------ state
    def _fresh_state(self):
        """Host per-slot state plus the device first-token column (and, for
        the dense engine, the run's slot cache lines).  The pool is the
        persistent store (``self.paged.arrays``), written in place."""
        B = self.B
        extra = {}
        if self.paged is not None:
            self._bt[:] = 0
        else:
            g = self.gen
            extra["caches"] = init_kv_caches(g.cfg, B, g.cache_dtype, g.device)
        return {
            **extra,
            "cur": np.zeros(B, np.int64),
            "active": np.zeros(B, np.int64),
            "temp": np.zeros(B, np.float32),
            "topk": np.zeros(B, np.int64),
            "greedy": np.ones(B, bool),
            "gens": [None] * B,
            "first": torch.zeros((B, 1), dtype=torch.int64, device=self.gen.device),
        }

    # ------------------------------------------------------ paged plumbing
    def _abandon_restore(self, req: SlotRequest) -> None:
        """Hand a request's claimed host payloads back to the tier's ledger
        as expired: they never reached the pool."""
        if req.host_restore is not None:
            tier = getattr(self.paged.cache, "host_tier", None)
            if tier is not None:
                tier.abandon(len(req.host_restore[1]))
            req.host_restore = None

    def _release_blocks(self, req: Optional[SlotRequest]) -> None:
        """Drop the references a not-yet-admitted request carries (and
        abandon its claimed host payloads)."""
        if req is None or self.paged is None:
            return
        self._abandon_restore(req)
        ids = list(req.kv_blocks or [])
        if req.prefix and req.prefix[0] > 0:
            ids += list(req.prefix[1])
        if ids:
            self.paged.pool.decref(ids)

    def _alloc_slot_blocks(self, i: int, s: _Slot, req: SlotRequest, budget: int) -> bool:
        """Install slot ``i``'s table: shared prefix blocks, then fresh ones
        for the rest of ``prompt + budget`` (the server's pre-allocation, or
        allocated here with LRU eviction).  False when the pool is short."""
        rt = self.paged
        s.alloc = len(req.ids) + budget
        prefix_ids = list(req.prefix[1]) if (req.prefix and req.prefix[0] > 0) else []
        fresh_tokens = s.alloc - len(prefix_ids) * rt.block
        fresh = req.kv_blocks
        if fresh is None:
            try:
                rt.ensure_free(rt.pool.blocks_for(fresh_tokens))
                fresh = rt.pool.alloc_tokens(fresh_tokens)
            except OutOfBlocks:
                if prefix_ids:
                    rt.pool.decref(prefix_ids)
                return False
        s.blocks = prefix_ids + list(fresh)
        self._bt[i, :] = 0
        self._bt[i, :len(s.blocks)] = s.blocks
        return True

    def projected_block_release_s(self, need_blocks: int, fallback_rate: float = 50.0) -> float:
        """Seconds until the live slots' projected releases cover
        ``need_blocks``: each slot's remaining budget over its own rate (the
        measured wave rate times its tokens-per-wave EMA).  A hint read from
        the server's threads while the engine runs."""
        with self._marks_lock:
            n, t0, t1 = self._wave_ctr, self._wave_first, self._wave_last
        wave_rate = max(1e-3, (n - 1) / (t1 - t0)) if n >= 2 and t1 > t0 else None
        rel = []
        for s in list(self._slots_view or []):
            req = s.req
            if req is None:
                continue
            remaining = max(1, s.budget - len(s.out))
            rate = (max(1e-3, s.stride_ema) * wave_rate if wave_rate is not None
                    else fallback_rate)
            rel.append((remaining / rate, len(s.blocks)))
        return eta_until_blocks(rel, need_blocks)

    # ---------------------------------------------------------- admission
    def _dispatch_restore(self, req: SlotRequest) -> list:
        """Write the request's claimed host-tier payloads into their fresh
        pool blocks (the tail of ``req.prefix[1]``, already in the slot's
        table) on the engine's stream, ahead of the warm start whose gather
        reads them.  Returns the payloads, which must outlive the copy."""
        ids, payloads = req.host_restore
        req.host_restore = None
        if ids:
            self.gen._restore_blocks_paged(self.paged.arrays, ids, payloads)
        return list(payloads)

    def _chunk_prefill_step(self, slots: List[_Slot], row, t0: float) -> None:
        """Dispatch ONE block-aligned prefill chunk of a long prompt, then
        park the rest as a warm continuation: it keeps every block of the
        slot (prompt + budget, charged at admission) as its prefix, advanced
        past the chunk.  The slot never activates (no sample), so between
        chunks it is free for decode waves and other admissions; once the
        remainder fits the chunk, admission falls through to the ordinary
        warm start, which samples the first token as a monolithic prefill
        would."""
        g = self.gen
        i, req, _ = row
        s = slots[i]
        rt = self.paged
        plen = req.prefix[0] if req.prefix else 0
        step = max(rt.block, (self._chunk_tokens // rt.block) * rt.block)
        new_plen = plen + step
        sbucket = g._bucket(step)
        tokens = np.zeros((1, sbucket), np.int64)
        tokens[0, :step] = req.ids[plen:new_plen]
        if req.host_restore:
            keep = self._dispatch_restore(req)
            ready = torch.cuda.Event() if g.device.type == "cuda" else None
            if ready is not None:
                ready.record()
            self._restore_keep.append((ready, keep))
        g._prefill_chunk_paged(rt.arrays, self._bt[[i]], tokens, plen,
                               np.array([new_plen], np.int64))
        self._prefill_chunks += 1
        orig_cached, n_chunks = req.chunk_cont if req.chunk_cont else (s.cached, 0)
        if s.span is not None:
            s.span.add_event("prefill_chunk", tokens=step, chunks=n_chunks + 1)
            s.span.end()
            s.span = None
        if self.flight is not None:
            self.flight.record("prefill_chunk", slot=i, chunk_tokens=step, prefilled=new_plen,
                               prompt_tokens=len(req.ids), chunks=n_chunks + 1,
                               wall_s=round(time.time() - t0, 6))
        blocks = list(s.blocks)
        s.req, s.done, s.pending = None, True, False
        s.blocks, s.alloc = [], 0
        self._bt[i, :] = 0
        self._parked.append(dataclasses.replace(
            req, prefix=(new_plen, blocks), kv_blocks=None, host_restore=None,
            chunk_cont=(orig_cached, n_chunks + 1)))

    def _admit_dispatch(self, state, slots: List[_Slot], waves, gen_ctr: int) -> int:
        """Dispatch admissions without a host sync: one program per prompt
        bucket group (from position 0), one per prefix hit, one chunk per
        long prompt under chunked prefill; the host picks up their first
        tokens later (``_resolve``)."""
        g, c = self.gen, self.gen.cfg
        t0 = time.time()
        valid = []
        for i, req in waves:
            s = slots[i]
            s.req, s.out, s.dispatched = req, [], 0
            s.blocks, s.alloc = [], 0
            s.spec_ema, s.spec_idle = 1.0, 0
            s.stride_ema = float(self.chunk)
            s.gen_id = gen_ctr = gen_ctr + 1
            s.t0, s.done, s.pending, s.prefill_s = t0, False, False, 0.0
            s.cached = req.prefix[0] if req.prefix else 0
            n_prompt = len(req.ids)
            if n_prompt == 0 or n_prompt >= c.max_seq or s.cached >= n_prompt:
                s.req, s.done = None, True
                self._release_blocks(req)
                if req.on_done is not None:
                    req.on_done(None, {"error": f"prompt length {n_prompt} invalid for ctx "
                                                f"{c.max_seq}"})
                continue
            budget = min(req.max_new, c.max_seq - n_prompt)
            s.budget = budget
            if budget <= 0:
                self._release_blocks(req)
                self._retire(state, slots, i, self._live(slots), park=False)
                continue
            if self.paged is not None and not self._alloc_slot_blocks(i, s, req, budget):
                s.req, s.done = None, True
                self._abandon_restore(req)  # the prefix references are already dropped
                log.warning("paged admission: out of KV blocks for a %d-token request (%s)",
                            n_prompt + budget, self.paged.pool.stats())
                if req.on_done is not None:
                    req.on_done(None, {"error": "out of KV blocks"})
                continue
            valid.append((i, req, budget))
        if not valid:
            return gen_ctr
        if self.tracer is not None:
            for i, req, budget in valid:
                if req.span_ctx is not None:
                    slots[i].span = self.tracer.start_span(
                        "prefill", parent=req.span_ctx,
                        attrs={"slot": i, "prompt_tokens": len(req.ids),
                               "cached_tokens": slots[i].cached, "budget": budget})
        if self._on_progress is not None:
            self._on_progress("prefill")

        if self._chunk_tokens > 0:
            # a row whose block-aligned uncached remainder exceeds the chunk
            # dispatches one chunk and parks; it is not in this wave's groups
            step = max(self.paged.block,
                       (self._chunk_tokens // self.paged.block) * self.paged.block)
            rest = []
            for row in valid:
                plen = row[1].prefix[0] if row[1].prefix else 0
                if plen % self.paged.block == 0 and len(row[1].ids) - plen > step:
                    self._chunk_prefill_step(slots, row, t0)
                else:
                    rest.append(row)
            valid = rest
            if not valid:
                return gen_ctr

        groups: Dict[int, list] = {}
        prefix_rows = []
        for row in valid:
            if row[1].prefix and row[1].prefix[0] > 0:
                prefix_rows.append(row)
            else:
                groups.setdefault(g._bucket(len(row[1].ids)), []).append(row)

        def row_meta(rows):
            seeds = [(r.seed % (2 ** 32)) if r.seed is not None
                     else int(np.random.randint(0, 2 ** 31)) for _, r, _ in rows]
            return (np.array([len(r.ids) for _, r, _ in rows], np.int64), seeds,
                    np.array([r.sample.temperature for _, r, _ in rows], np.float32),
                    np.array([r.sample.top_k for _, r, _ in rows], np.int64),
                    np.array([r.sample.greedy for _, r, _ in rows], bool))

        def block_inserts(rows):
            if self.paged is None:
                return []
            out = []
            for i, r, _ in rows:
                n_full = len(r.ids) // self.paged.block
                if r.on_prefill_blocks is not None and n_full:
                    out.append((r, list(slots[i].blocks[:n_full])))
            return out

        def extracts(rows):
            # dense store inserts: the prompt's KV sliced out of the freshly
            # spliced slot lines, fetched at resolve (prefill has landed)
            if self.paged is not None:
                return []
            out = []
            for i, r, _ in rows:
                if r.kv_extract is not None and r.on_prefill_kv is not None:
                    lo, hi = r.kv_extract
                    if hi > lo:
                        out.append((r, g._extract_kv(state["caches"], i, lo, hi - lo)))
            return out

        def activate(rows, lengths, firsts, gens, temp, topk, greedy, keep=()):
            ids = [i for i, _, _ in rows]
            state["cur"][ids] = lengths
            state["active"][ids] = 1
            state["temp"][ids] = temp
            state["topk"][ids] = topk
            state["greedy"][ids] = greedy
            for i, gen in zip(ids, gens):
                state["gens"][i] = gen
            state["first"][g._h2d(ids, torch.int64)] = firsts[:, None]
            for i in ids:
                slots[i].pending = True
            ready = None
            if g.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record()
            self._pending.append(_PendingWave(rows, firsts, t0, ready, block_inserts(rows),
                                              extracts(rows), keep))

        pool = self.paged.arrays if self.paged is not None else None
        for row in prefix_rows:
            i, req, _ = row
            plen = req.prefix[0]
            n_prompt = len(req.ids)
            sbucket = min(g._bucket(n_prompt - plen), c.max_seq - plen)
            tokens = np.zeros((1, sbucket), np.int64)
            tokens[0, :n_prompt - plen] = req.ids[plen:]
            lengths, seeds, temp, topk, greedy = row_meta([row])
            keep = ()
            if self.paged is not None:
                if req.host_restore:
                    keep = self._dispatch_restore(req)
                firsts, gens = g._admit_prefix_paged(
                    tokens, pool, self._bt[[i]], plen, lengths,
                    np.array([slots[i].alloc], np.int64), seeds, temp, topk, greedy)
            else:
                prefix_dev = g._prefix_to_device(
                    req.prefix[1], req.prefix[2] if len(req.prefix) > 2 else None)
                firsts, gens = g._admit_prefix(tokens, state["caches"], plen, lengths, i,
                                               prefix_dev, seeds, temp, topk, greedy)
            activate([row], lengths, firsts, gens, temp, topk, greedy, keep)

        for bucket, rows in sorted(groups.items()):
            tokens = np.zeros((len(rows), bucket), np.int64)
            for j, (_, r, _) in enumerate(rows):
                tokens[j, :len(r.ids)] = r.ids
            ids = [i for i, _, _ in rows]
            lengths, seeds, temp, topk, greedy = row_meta(rows)
            if self.paged is not None:
                firsts, gens = g._admit_fused_paged(
                    tokens, pool, self._bt[ids], lengths,
                    np.array([slots[i].alloc for i in ids], np.int64), seeds, temp, topk,
                    greedy)
            else:
                firsts, gens = g._admit_fused(tokens, state["caches"], lengths, ids, seeds,
                                              temp, topk, greedy)
            activate(rows, lengths, firsts, gens, temp, topk, greedy)
        return gen_ctr

    def _resolve(self, state, slots: List[_Slot], wave: _PendingWave) -> None:
        """Fetch a wave's first tokens (blocks until its prefill lands),
        hand the prompt blocks to the cache, report the tokens, and retire
        rows that already ended."""
        firsts = [int(t) for t in wave.firsts_dev.cpu().tolist()]
        t_first = time.time() - wave.t0
        wave.keep.clear()  # the fetch synced past the restore that read them
        tier = (getattr(self.paged.cache, "host_tier", None)
                if self.paged is not None and self.paged.cache is not None else None)
        if tier is not None:
            # the crossover's recompute cost: this wave prefilled its rows'
            # uncached tokens in t_first
            n_new = sum(max(0, len(r.ids) - slots[i].cached) for i, r, _ in wave.rows)
            tier.note_prefill(self.paged.pool.blocks_for(n_new), t_first)
        if self.flight is not None:
            self.flight.record("prefill", rows=len(wave.rows),
                               prompt_tokens=sum(len(r.ids) for _, r, _ in wave.rows),
                               cached_tokens=sum(slots[i].cached for i, _, _ in wave.rows),
                               prefill_s=round(t_first, 6))
        for req, ids in wave.block_inserts:
            try:  # a failing cache insert must not fail the run for every peer
                req.on_prefill_blocks(ids)
            except Exception:
                log.exception("on_prefill_blocks failed (prefix-cache insert skipped)")
        for req, dev in wave.extracts:
            try:  # the firsts fetch proved prefill landed: this costs the copy
                req.on_prefill_kv([{k: v.cpu() for k, v in layer.items()} for layer in dev])
            except Exception:
                log.exception("on_prefill_kv failed (prefix-cache insert skipped)")
        live = self._live(slots)
        for (i, req, budget), first in zip(wave.rows, firsts):
            s = slots[i]
            if s.req is not req:
                log.error("resolve: slot %d holds a different request than its wave", i)
                s.pending = False
                continue
            s.pending = False
            s.prefill_s = t_first
            s.out = [first]
            if s.span is not None:
                s.span.set_attribute("prefill_s", round(t_first, 6))
                s.span.end()
                s.span = self.tracer.start_span("wave", parent=req.span_ctx, attrs={"slot": i})
            if req.on_tokens is not None:
                req.on_tokens([first])
            if first in self.stop_tokens or budget <= 1 or req.cancelled():
                s.done = True
                self._retire(state, slots, i, live)

    def _resolve_pending(self, state, slots, only_ready: bool = False, needed_slots=None):
        """Resolve dispatched admissions: all of them (blocking), those whose
        first tokens have landed (``only_ready``), or those touching
        ``needed_slots`` (plus budget-1 rows no chunk will ever carry)."""
        if not self._pending:
            return
        remaining = []
        for wave in self._pending:
            urgent = any(budget <= 1 for _, _, budget in wave.rows)
            if needed_slots is not None:
                must = urgent or any(i in needed_slots for i, _, _ in wave.rows)
            elif only_ready:
                must = urgent or wave.ready is None or wave.ready.query()
            else:
                must = True
            if must:
                self._resolve(state, slots, wave)
            else:
                remaining.append(wave)
        self._pending = remaining

    def _retire(self, state, slots: List[_Slot], i: int, batch_size: int,
                park: bool = True) -> None:
        s = slots[i]
        req, out = s.req, s.out
        s.req, s.done, s.pending = None, True, False
        if s.span is not None:
            s.span.set_attribute("generated_tokens", len(out))
            s.span.end()
            s.span = None
        if self.paged is not None and s.blocks:
            if self.ledger is not None and req is not None and req.tenant is not None:
                # blocks held x wall since allocation, per reference: a
                # shared prefix block bills each tenant for its own hold
                held_s = time.time() - (req.t_kv_alloc if req.t_kv_alloc is not None
                                        else s.t0)
                self.ledger.charge_kv_block_seconds(req.tenant,
                                                    len(s.blocks) * max(0.0, held_s))
            # one decref per reference; blocks the prefix cache also holds
            # survive, the rest are free before on_done fires
            self.paged.pool.decref(s.blocks)
            s.blocks, s.alloc = [], 0
            self._bt[i, :] = 0
        self._retired_tokens += len(out)
        if park:
            self._to_park.append(i)
        if req is not None and req.on_done is not None:
            dt = time.time() - s.t0
            decode_s = max(dt - s.prefill_s, 0.0)
            st = {
                "batch": batch_size,
                "prompt_tokens": len(req.ids),
                "generated_tokens": len(out),
                "cached_tokens": s.cached,
                "prefill_tokens": len(req.ids) - s.cached,
                "prefill_s": s.prefill_s,
                "decode_s": decode_s,
                "tokens_per_s": len(out) / max(decode_s, 1e-9) if out else 0.0,
            }
            if req.chunk_cont is not None:
                # a chunked prefill's continuation: the original request's
                # cache-hit split, and the chunk waves the prompt took
                orig_cached, n_chunks = req.chunk_cont
                st.update(cached_tokens=orig_cached, prefill_tokens=len(req.ids) - orig_cached,
                          prefill_chunks=n_chunks)
            req.on_done(list(out), st)

    # ------------------------------------------------------ QoS preemption
    def _maybe_preempt(self, slots: List[_Slot]) -> None:
        """Park one batch row at the wave boundary when an interactive
        request waits and every slot is busy; the next ``admit_free`` feeds
        the freed slot.  At most one park per boundary, and none while a
        park or an admission wave is pending."""
        if (self.paged is None or self._preempt_hint is None or self._to_park
                or self._pending):
            return
        if any(s.req is None for s in slots):
            return  # a free slot exists: nothing to preempt for
        if not self._preempt_hint():
            return
        victim, best = None, -1
        for i, s in enumerate(slots):
            if s.req is None or s.pending or s.done or s.req.priority != "batch":
                continue
            # the row with the most budget left frees the slot longest
            rem = s.budget - len(s.out)
            if rem > best:
                best, victim = rem, i
        if victim is not None:
            self._park_slot(slots, victim)

    def _park_slot(self, slots: List[_Slot], i: int) -> None:
        """Evict slot ``i``'s row to a parked :class:`SlotRequest` whose
        ``ids`` are its history (prompt + every consumed token) and whose
        ``prefix`` is the slot's pool blocks with ``plen = len(history) -
        1``: positions ``[0, plen)`` hold valid KV, so re-admission is the
        prefix warm start of the one pending token, and its first sample is
        the token an uninterrupted greedy run would produce next.  KV that
        chunks in flight write past ``plen`` is overwritten by that suffix
        prefill and the decode after it before any position is read."""
        s = slots[i]
        req, prior, orig_budget = s.req, list(s.out), s.budget
        # a chunked-prefill continuation carries the original cache-hit length
        orig_cached = req.chunk_cont[0] if req.chunk_cont is not None else s.cached
        blocks = list(s.blocks)
        # the parked entry inherits the slot's pool references: no decref
        s.blocks, s.alloc = [], 0
        s.req, s.done, s.pending = None, True, False
        if s.span is not None:
            s.span.add_event("preempted", tokens_so_far=len(prior))
            s.span.end()
            s.span = None
        self._bt[i, :] = 0
        self._to_park.append(i)
        # the prior occupancy's tokens were delivered; the resumed
        # occupancy's retire counts only its own
        self._retired_tokens += len(prior)
        new_ids = list(req.ids) + prior
        plen = len(new_ids) - 1
        orig_done = req.on_done

        def on_done(tokens, stats):
            if orig_done is None:
                return
            if tokens is None:  # a resume-time admission failure
                orig_done(None, stats)
                return
            # the original request's shape; timings are the resumed
            # occupancy's
            st = dict(stats, prompt_tokens=len(req.ids),
                      generated_tokens=len(prior) + len(tokens), cached_tokens=orig_cached,
                      prefill_tokens=len(req.ids) - orig_cached,
                      preempted=stats.get("preempted", 0) + 1)
            orig_done(prior + tokens, st)

        self._parked.append(SlotRequest(
            ids=new_ids, max_new=orig_budget - len(prior), sample=req.sample,
            on_tokens=req.on_tokens, on_done=on_done, cancelled=req.cancelled,
            # greedy resumes ignore seeds; a seeded sampled row resumes on a
            # history-derived seed (deterministic, not the uninterrupted chain)
            seed=None if req.seed is None else (req.seed + plen) % (2 ** 32),
            prefix=(plen, blocks), span_ctx=req.span_ctx, speculative=req.speculative,
            tenant=req.tenant, t_kv_alloc=req.t_kv_alloc, priority=req.priority,
            chunk_cont=req.chunk_cont))
        self._preempted += 1
        if self.flight is not None:
            self.flight.record("preempt", slot=i, priority=req.priority, tenant=req.tenant,
                               parked_tokens=len(prior), prefix_tokens=plen,
                               blocks=len(blocks))
        if self._on_preempt is not None:
            try:
                self._on_preempt(req.tenant)
            except Exception:
                log.exception("on_preempt hook failed")

    def _pop_parked(self) -> Optional[SlotRequest]:
        """The next parked entry to resume (FIFO); a cancelled entry
        releases its blocks and reports once."""
        while self._parked:
            req = self._parked.pop(0)
            if req.cancelled():
                self._release_blocks(req)
                if req.on_done is not None:
                    req.on_done(None, {"error": "cancelled while parked"})
                continue
            return req
        return None

    def _release_parked(self) -> None:
        """Hand back every parked entry's retained blocks (a failed run)."""
        for req in self._parked:
            try:
                self._release_blocks(req)
            except Exception:
                log.exception("failed releasing parked blocks")
        self._parked = []

    def _flush_park(self, state) -> None:
        """Apply pending slot parks: frontier 0, inactive, greedy."""
        if not self._to_park:
            return
        ids = list(self._to_park)
        self._to_park.clear()
        state["cur"][ids] = 0
        state["active"][ids] = 0
        state["temp"][ids] = 0.0
        state["topk"][ids] = 0
        state["greedy"][ids] = True
        for i in ids:
            state["gens"][i] = None
        state["first"][self.gen._h2d(ids, torch.int64)] = 0

    @staticmethod
    def _live(slots: List[_Slot]) -> int:
        return sum(1 for s in slots if s.req is not None)

    # ----------------------------------------------------------------- run
    def run(self, feed: Callable[[], Optional[SlotRequest]]) -> Dict:
        """Admit -> keep ``depth`` chunks in flight -> fetch -> retire/admit,
        until idle and ``feed()`` is empty.  Returns run stats."""
        state = self._fresh_state()
        slots = [_Slot() for _ in range(self.B)]
        self._slots_view = slots
        chain: deque = deque()
        gen_ctr = 0
        t_start = time.time()
        admitted = 0
        self._to_park, self._pending, self._parked = [], [], []
        self._preempted = self._resumed = 0
        self._prefill_chunks = 0
        self._retired_tokens = 0
        self._reset_counters()

        def admit_free() -> None:
            nonlocal gen_ctr, admitted
            wave = []
            for i in range(self.B):
                if slots[i].req is not None:
                    continue
                req = feed()
                if req is None:
                    # no fresh work: resume parked rows (counted as resumes)
                    req = self._pop_parked()
                    if req is None:
                        break
                    self._resumed += 1
                else:
                    admitted += 1
                wave.append((i, req))
            if wave:
                gen_ctr = self._admit_dispatch(state, slots, wave, gen_ctr)

        def dispatch_ok(s: _Slot) -> bool:
            return s.req is not None and not s.done and 1 + s.dispatched < s.budget

        try:
            if self.spec is not None:
                self._run_loop_spec(state, slots, chain, admit_free, dispatch_ok)
            else:
                self._run_loop(state, slots, chain, admit_free, dispatch_ok)
        except BaseException:
            # the pool outlives this run: leaked references would shrink it
            for s in slots:
                if s.span is not None:
                    s.span.end(status="error")
                    s.span = None
                if self.paged is not None and s.blocks:
                    try:
                        self.paged.pool.decref(s.blocks)
                    except Exception:
                        log.exception("failed releasing slot blocks after engine failure")
                    s.blocks = []
            raise
        finally:
            # parked entries hold references too: none may outlive the run
            self._release_parked()
            self._slots_view = None
            self._restore_keep.clear()

        dt = time.time() - t_start
        n_tok = self._retired_tokens
        stats = {"requests": admitted, "generated_tokens": n_tok, "wall_s": dt,
                 "tokens_per_s": n_tok / dt if dt > 0 else 0.0}
        stats.update({
            "decode_weight_passes": self._plain_steps + self._spec_dispatches,
            "preempted": self._preempted,
            "resumed": self._resumed,
        })
        if self.paged is not None:
            # the decode-attention body and the dispatch split (a dense
            # engine launches no paged kernel and reports none of these)
            stats.update({
                "decode_kernel": "paged_flash" if self.paged_flash else "gather",
                "kernel_gather_dispatches": self._gather_dispatches,
                "kernel_paged_flash_dispatches": self._flash_dispatches,
                "kernel_forward_steps": self._forward_steps,
            })
            if self._chunk_tokens > 0:
                # present only with chunked prefill armed, as in the JAX engine
                stats["prefill_chunks"] = self._prefill_chunks
        if self.spec is not None:
            stats.update({
                "spec_drafted_tokens": self._spec_drafted,
                "spec_accepted_tokens": self._spec_accepted,
                "spec_dispatches": self._spec_dispatches,
                "spec_acceptance": (self._spec_accepted / self._spec_drafted
                                    if self._spec_drafted else 0.0),
            })
        return stats

    def _count_dispatch(self, forward_steps: int) -> None:
        if self.paged_flash:
            self._flash_dispatches += 1
        else:
            self._gather_dispatches += 1
        self._forward_steps += forward_steps

    def _fill_chain(self, state, slots, chain, dispatch_ok) -> None:
        """Keep up to ``depth`` plain decode chunks in flight."""
        g = self.gen
        while len(chain) < self.depth and any(dispatch_ok(s) for s in slots):
            snapshot = [(i, s.gen_id, s.dispatched) for i, s in enumerate(slots)
                        if dispatch_ok(s)]
            if self.paged is not None:
                toks, last, state["cur"] = g._decode_scan_paged(
                    state["first"], state["cur"], state["active"], self.paged.arrays, self._bt,
                    state["gens"], state["temp"], state["topk"], state["greedy"], self.chunk,
                    flash=self.paged_flash)
                self._count_dispatch(self.chunk)
            else:
                toks, last, state["cur"] = g._decode_scan_cont(
                    state["first"], state["cur"], state["active"], state["caches"],
                    state["gens"], state["temp"], state["topk"], state["greedy"], self.chunk)
            state["first"] = last
            self._plain_steps += self.chunk
            for i, _, _ in snapshot:
                slots[i].dispatched += self.chunk
            chain.append((toks, snapshot))

    def _mark_wave(self) -> None:
        """One wave's tokens reached the host (the clock of the release ETA);
        chunk-step restore payloads whose copy has run are let go."""
        self._restore_keep = [(ev, keep) for ev, keep in self._restore_keep
                              if ev is not None and not ev.query()]
        now = time.time()
        with self._marks_lock:
            if self._wave_ctr == 0:
                self._wave_first = now
            self._wave_last = now
            self._wave_ctr += 1

    def _deliver(self, s: _Slot, accepted: List[int]) -> None:
        """Hand a row its accepted tokens of this wave (span event, stream)."""
        if not accepted:
            return
        if s.span is not None:
            s.span.add_event("wave", tokens=len(accepted))
        if s.req.on_tokens is not None:
            s.req.on_tokens(accepted)

    @staticmethod
    def _occupancy(slots, attr: str) -> Dict[str, int]:
        """``{tenant or priority: live slots}``: callers take it at the fetch,
        before retiring finished rows, so a row's last wave still carries
        (and bills) its tenant."""
        out: Dict[str, int] = {}
        for s in slots:
            v = getattr(s.req, attr) if s.req is not None else None
            if v is not None:
                out[v] = out.get(v, 0) + 1
        return out

    def _flight_wave(self, slots, kind: str, tokens: int, weight_passes: int,
                     occupancy: int, drafted: int = 0, accepted: int = 0,
                     tenants: Optional[Dict[str, int]] = None,
                     priorities: Optional[Dict[str, int]] = None) -> None:
        """One flight record for a fetched wave (plain chunk or verify):
        host-side values only, the fetch has already synchronised.  The
        ledger's chip-seconds are charged from this record."""
        if self.flight is None:
            return
        now = time.time()
        rec = {"wave": self._wave_ctr, "occupancy": occupancy, "slots": self.B,
               "tokens": int(tokens), "weight_passes": int(weight_passes),
               "drafted": int(drafted), "accepted": int(accepted),
               "wave_s": (round(now - self._last_wave_t, 6)
                          if self._last_wave_t is not None else None)}
        if self.paged is not None:
            rec.update(kv_free=self.paged.pool.n_free, kv_used=self.paged.pool.n_used,
                       kernel="paged_flash" if self.paged_flash else "gather")
        self._last_wave_t = now
        if self._queue_depth_fn is not None:
            rec["queue_depth"] = int(self._queue_depth_fn())
        slowest, age = None, 0.0
        for s in slots:
            if s.req is not None and now - s.t0 > age:
                age, slowest = now - s.t0, getattr(s.req.span_ctx, "trace_id", None)
        if age > 0.0:
            rec["slowest_age_s"] = round(age, 3)
            rec["slowest_trace_id"] = slowest
        if tenants:
            rec["tenants"] = tenants
        if priorities:
            rec["priorities"] = priorities
        self.flight.record(kind, **rec)
        if self.ledger is not None:
            self.ledger.charge_flight_wave("llm", rec)

    def _consume_block(self, state, slots, block: np.ndarray, snapshot) -> None:
        """Host bookkeeping for one fetched plain chunk."""
        if self._on_progress is not None:
            self._on_progress("wave")
        self._mark_wave()
        live = self._live(slots)
        tenants, priorities = self._occupancy(slots, "tenant"), self._occupancy(slots, "priority")
        wave_tokens = 0
        for i, gid, offset in snapshot:
            s = slots[i]
            if s.req is None or s.gen_id != gid or s.done:
                continue  # the lane is garbage for a retired / reassigned slot
            if s.req.cancelled():
                s.done = True
                self._retire(state, slots, i, live)
                continue
            assert len(s.out) - 1 == offset, (len(s.out), offset)
            accepted = []
            for t in (int(x) for x in block[i]):
                s.out.append(t)
                accepted.append(t)
                if t in self.stop_tokens or len(s.out) >= s.budget:
                    s.done = True
                    break
            wave_tokens += len(accepted)
            s.spec_idle += 1
            s.stride_ema = 0.75 * s.stride_ema + 0.25 * max(1, len(accepted))
            self._deliver(s, accepted)
            if s.done:
                self._retire(state, slots, i, live)
        self._flight_wave(slots, "wave", wave_tokens, self.chunk, live, tenants=tenants,
                          priorities=priorities)

    def _drain_idle(self, state, slots, dispatch_ok) -> None:
        """Nothing in flight: resolve every admission (blocking) and retire
        the rows that are done or out of budget."""
        self._resolve_pending(state, slots)
        for i, s in enumerate(slots):
            if s.req is not None and (s.done or not dispatch_ok(s)):
                self._retire(state, slots, i, self._live(slots))

    def _fetch_next(self, state, slots, chain) -> None:
        block, snapshot = chain.popleft()
        pending_here = {i for i, _, _ in snapshot if slots[i].pending}
        if pending_here or self._pending:
            # this block may carry steps of rows whose first token the host
            # has not picked up: resolve exactly those waves first
            self._resolve_pending(state, slots, needed_slots=pending_here)
        self._consume_block(state, slots, block.cpu().numpy(), snapshot)  # the wave's fetch

    def _run_loop(self, state, slots, chain, admit_free, dispatch_ok) -> None:
        while True:
            # wave boundary: park a batch row first if an interactive
            # request waits, then flush parks before admissions (a park
            # must not zero a new slot)
            self._maybe_preempt(slots)
            self._flush_park(state)
            admit_free()
            if self._live(slots) == 0 and not self._parked:
                break
            self._resolve_pending(state, slots, only_ready=True)
            self._fill_chain(state, slots, chain, dispatch_ok)
            if not chain:
                self._drain_idle(state, slots, dispatch_ok)
                continue
            self._fetch_next(state, slots, chain)

    # --------------------------------------------------- speculative decoding
    def _slot_draft_budget(self, s: _Slot) -> int:
        """Draft length for slot ``s``: the configured max, clamped to its
        remaining budget and throttled by its acceptance EMA (a 1-token probe
        every ``probe_every`` waves once throttled to zero)."""
        req = s.req
        if req is None or not req.speculative:
            return 0
        cap = min(self.spec.tokens, s.budget - len(s.out) - 1)
        if cap <= 0:
            return 0
        k = int(round(s.spec_ema * self.spec.tokens))
        if k <= 0:
            if s.spec_idle < self.spec.probe_every:
                return 0
            k = 1
        return min(cap, k)

    def _spec_plan(self, slots, dispatch_ok, probe_only: bool = False):
        """Drafts for every dispatchable slot (cut after a stop token) when
        at least one slot drafted, else None; ``probe_only`` answers "would
        anyone draft?"."""
        plan, any_draft = [], False
        for i, s in enumerate(slots):
            if s.req is None or s.done or s.pending or not dispatch_ok(s):
                continue
            toks: List[int] = []
            k_i = self._slot_draft_budget(s)
            if k_i > 0:
                key = (s.gen_id, len(s.out), k_i)
                memo = self._draft_memo.get(i)
                if memo is not None and memo[0] == key:
                    toks = memo[1]
                else:
                    toks = self._drafter.draft(s.req.ids + s.out, k_i)[:k_i]
                    for j, t in enumerate(toks):
                        if t in self.stop_tokens:
                            toks = toks[:j + 1]
                            break
                    self._draft_memo[i] = (key, toks)
            if probe_only:
                if toks:
                    return True
                continue
            plan.append((i, toks))
            any_draft = any_draft or bool(toks)
        if probe_only:
            return False
        return plan if any_draft else None

    def _spec_dispatch(self, state, slots, plan) -> None:
        """One verify wave: score the drafts, deliver each row's accepted
        run plus its bonus token.  Only accepted positions reach the pool."""
        g = self.gen
        K = self.spec.tokens
        assert not any(s.pending for s in slots), "verify with pending slots"
        draft = np.zeros((self.B, K), np.int64)
        dlen = np.zeros((self.B,), np.int64)
        rows = []
        for i, toks in plan:
            draft[i, :len(toks)] = toks
            dlen[i] = len(toks)
            rows.append((i, slots[i].gen_id))
        if self.paged is not None:
            block, accs, last, state["cur"] = g._spec_verify_paged(
                state["first"], draft, dlen, state["cur"], state["active"], self.paged.arrays,
                self._bt, state["gens"], state["temp"], state["topk"], state["greedy"], K,
                flash=self.paged_flash)
            self._count_dispatch(1)
        else:
            block, accs, last, state["cur"] = g._spec_verify_cont(
                state["first"], draft, dlen, state["cur"], state["active"], state["caches"],
                state["gens"], state["temp"], state["topk"], state["greedy"], K)
        state["first"] = last
        self._spec_dispatches += 1
        if self._on_progress is not None:
            self._on_progress("wave")
        self._mark_wave()
        alpha = self.spec.ema_alpha
        live = self._live(slots)
        tenants, priorities = self._occupancy(slots, "tenant"), self._occupancy(slots, "priority")
        wave_tokens = wave_drafted = wave_accepted = 0
        for i, gid in rows:
            s = slots[i]
            if s.req is None or s.gen_id != gid or s.done:
                continue
            if s.req.cancelled():
                s.done = True
                self._retire(state, slots, i, live)
                continue
            k_i = int(dlen[i])
            m = min(int(accs[i]), k_i)
            if k_i > 0:
                s.spec_ema = (1 - alpha) * s.spec_ema + alpha * (m / k_i)
                s.spec_idle = 0
                self._spec_drafted += k_i
                self._spec_accepted += m
                wave_drafted += k_i
                wave_accepted += m
                if s.span is not None:
                    s.span.add_event("spec", drafted=k_i, accepted=m)
                if self.on_spec is not None:
                    try:
                        self.on_spec(k_i, m)
                    except Exception:
                        log.exception("on_spec hook failed")
            else:
                s.spec_idle += 1
            accepted = []
            for t in (int(x) for x in block[i, :m + 1]):
                s.out.append(t)
                accepted.append(t)
                if t in self.stop_tokens or len(s.out) >= s.budget:
                    s.done = True
                    break
            wave_tokens += len(accepted)
            s.dispatched = len(s.out) - 1
            s.stride_ema = 0.75 * s.stride_ema + 0.25 * max(1, len(accepted))
            self._deliver(s, accepted)
            if s.done:
                self._retire(state, slots, i, live)
        # one verify dispatch = one weight pass for all its strides
        self._flight_wave(slots, "verify", wave_tokens, 1, live, wave_drafted, wave_accepted,
                          tenants=tenants, priorities=priorities)

    def _run_loop_spec(self, state, slots, chain, admit_free, dispatch_ok) -> None:
        """Variable-stride loop: when the host is caught up and a slot has a
        draft, one verify step; otherwise plain pipelined chunks, refilled
        only while no slot would draft."""
        while True:
            self._maybe_preempt(slots)
            self._flush_park(state)
            admit_free()
            if self._live(slots) == 0 and not self._parked:
                break
            self._resolve_pending(state, slots, only_ready=True)
            plan = None
            if not chain:
                # caught up: a verify needs every row's full history, and must
                # never advance a retired slot whose blocks were released
                self._drain_idle(state, slots, dispatch_ok)
                if self._live(slots) == 0:
                    continue
                self._flush_park(state)
                plan = self._spec_plan(slots, dispatch_ok)
            if plan is not None:
                self._spec_dispatch(state, slots, plan)
                continue
            if not chain or not self._spec_plan(slots, dispatch_ok, probe_only=True):
                self._fill_chain(state, slots, chain, dispatch_ok)
            if not chain:
                self._drain_idle(state, slots, dispatch_ok)
                continue
            self._fetch_next(state, slots, chain)
