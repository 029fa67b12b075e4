"""Prefill, decode and sampling for Llama/Qwen: the port of
``tpustack/models/llm_generate.py::Generator``.

Each JAX program (a jitted function with donated buffers) is one Python
method here, run eagerly; a ``lax.scan`` is a Python loop.  What the JAX
programs donate, the port updates IN PLACE.  Three cache layouts, as in the
JAX package:

- **Solo** (``generate``, ``generate_fused``; the ``LLM_MAX_BATCH=1``
  server): one dense ``[1, max_seq]`` row cache, prefilled from zero (long
  prompts in ``PREFILL_CHUNK``-token chunks, the JAX ``_prefill_long``),
  then one masked decode step per token over the whole line.
- **Dense slots** (``_admit_fused``, ``_decode_scan_cont``,
  ``_spec_verify_cont``; the ``TPUSTACK_PAGED_KV=0`` engine): a
  ``[B, max_seq]`` cache line per slot; a decode chunk reads the frozen
  lines through the plain partial and flushes its chunk buffers into them
  at ``[cur, cur_end)``.
- **Paged** (the ``*_paged`` methods; the default engine): pool tensors
  written by index assignment on a flattened ``[N*blk, Hkv, D]`` view
  (``_pool_scatter``) at host-computed flat indices that hold only the
  valid positions, so nothing is written out of range and block 0 (where
  idle table entries point) is never written.

The small per-slot state (frontier ``cur``, ``active``, sampling settings)
lives on the host, as numpy arrays the engine keeps; the device sees copies
uploaded per dispatch.  That keeps the decode chain free of host syncs: the
host knows every frontier, so the scatter indices and the all-greedy gate
are computed without asking the device.

The dense prefix store's device side (``_extract_kv``, ``_restore_kv_rows``,
``_prefix_to_device``, ``extract_prefix_host``) moves host KV segments (CPU
tensors in the cache dtype) in and out of row caches; the paged pool's host
tier restores spilled blocks with ``_restore_blocks_paged``; chunked prefill
runs one block-aligned chunk at a time through ``_prefill_chunk_paged``.

Sampling draws from one seeded ``torch.Generator`` per request (per slot in
the engines), so a request's output is a function of (prompt, seed) whatever
its batch peers; it cannot match JAX's threefry numbers.  Greedy rows never
draw.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpustack_torch.models.llama import (LlamaConfig, LlamaModel, init_chunk_bufs,
                                         init_kv_caches)
from tpustack_torch.models.llama_weights import init_random_, load_params
from tpustack_torch.ops.flash_attention import contract_violation as flash_contract_violation
from tpustack_torch.ops.paged_attention import gather_pool
from tpustack_torch.ops.quant import quantize_module_
from tpustack_torch.utils import get_logger, resolve_device

log = get_logger("models.llm_generate")

_POOL_TO_BUF = {"k": "ck", "v": "cv", "k_scale": "ck_scale", "v_scale": "cv_scale"}


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    temperature: float = 0.8
    top_k: int = 40
    greedy: bool = False


def resolve_paged_flash(device: torch.device, cfg, dtype: torch.dtype, block: int,
                        spec_tokens: int, slots: int) -> bool:
    """The ``TPUSTACK_PAGED_FLASH`` verdict on an engine's geometry: read the
    pool in place through the paged kernel (True) or gather a dense per-row
    copy every dispatch (False, the bisection path).

    The geometry is the model ``cfg`` (head dim, head ratio), the compute
    ``dtype``, the KV ``block`` size, the speculative draft length (a verify
    step has ``spec_tokens + 1`` query rows per head) and the slot count,
    held to the kernel's contract
    (``ops.paged_attention.contract_violation``).  ``auto`` (the default)
    is on for CUDA where the contract holds and off elsewhere (on the CPU
    the kernel's plain twin is itself a gather); ``1`` on CUDA outside the
    contract raises here, at startup, naming the condition (on the CPU it
    selects the twin, which takes any geometry); ``0`` is off."""
    import os

    from tpustack_torch.ops.paged_attention import contract_violation

    val = os.environ.get("TPUSTACK_PAGED_FLASH", "auto").strip().lower()
    if val in ("0", "false", "no", "off"):
        return False
    if val not in ("", "auto", "1", "true", "yes", "on"):
        raise ValueError(f"TPUSTACK_PAGED_FLASH={val!r} is not auto or a boolean")
    why = contract_violation(
        blk=block, rows=(spec_tokens + 1) * (cfg.n_heads // cfg.n_kv_heads),
        head_dim=cfg.head_dim, q_dtype=dtype, batch=slots, kv_heads=cfg.n_kv_heads)
    if device.type != "cuda":
        return val not in ("", "auto")
    if why is None:
        return True
    if val in ("", "auto"):
        log.info("paged decode attention: gather path (the paged kernel takes %s)", why)
        return False
    raise ValueError(f"TPUSTACK_PAGED_FLASH=1 but this engine's geometry is outside the "
                     f"paged kernel's contract: it takes {why}; unset the knob (auto) to "
                     "serve through the gather path")


class Generator:
    """Holds the model and runs the solo, dense-slot and paged device steps."""

    #: suffix prefills with ``bucket * max_seq`` at most this run as one
    #: masked plain-attention pass over the gathered line; larger ones take
    #: the streaming flash kernel (``_prefill_from``)
    MASKED_PREFILL_MAX = 1 << 21
    #: long prompts prefill in chunks of this many tokens: one chunk's
    #: activations bound prefill memory however long the prompt, and every
    #: chunk after the first is a streaming flash call over the cache
    PREFILL_CHUNK = 8192

    def __init__(self, config: LlamaConfig, params: Optional[Dict[str, torch.Tensor]] = None,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0, device=None):
        """``params``: a state dict (``llama_weights.params_from_jax``); None
        draws the weights from ``seed`` on the device, in ``dtype``."""
        self.cfg = config
        self.device = resolve_device(device)
        self.cache_dtype = dtype
        if params is None and config.quant:
            # random-init the float twin, then quantise it layer by layer
            # (int8 layers start at zero: a degenerate model); the peak is
            # the float model plus one layer's int8
            model = self._random_model(dataclasses.replace(config, quant=None), dtype, seed)
            t0 = time.time()
            quantize_module_(model, quantize_embed=not config.tie_embeddings, dtype=dtype,
                             out_dtypes={"lm_head": torch.float32})
            model.cfg = config
            log.info("Quantised weights to int8 in %.1fs", time.time() - t0)
        elif params is None:
            model = self._random_model(config, dtype, seed)
        else:
            with torch.device("meta"):
                model = LlamaModel(config, dtype)
            model = model.to_empty(device=self.device)
            load_params(model, params)
        self.model = model.eval().requires_grad_(False)
        # device memo of hot dense prefix-store entries, keyed by the
        # store's path identity (``_prefix_to_device``)
        self._prefix_dev: "collections.OrderedDict" = collections.OrderedDict()
        self.prefix_dev_cap = 4

    def stream_route_violation(self) -> Optional[str]:
        """Why this generator's prefill cannot take the streaming flash
        route it would reach on the card, or None.

        The streaming branch (``LlamaAttention._cache_attention`` with an
        offset) calls the kernel directly: a warm start or chunk whose
        ``bucket * max_seq`` exceeds ``MASKED_PREFILL_MAX`` (possible once
        ``max_seq**2`` does) and every chunk of a prompt longer than
        ``PREFILL_CHUNK`` (possible once ``max_seq`` is).  Servers refuse
        such a configuration at startup rather than fail a request."""
        S = self.cfg.max_seq
        if self.device.type != "cuda" or (S * S <= self.MASKED_PREFILL_MAX
                                          and S <= self.PREFILL_CHUNK):
            return None
        why = flash_contract_violation(self.cache_dtype, self.cfg.head_dim)
        if why is None:
            return None
        return (f"ctx {S} reaches the streaming flash prefill, and the flash kernel takes "
                f"{why}")

    def _random_model(self, config: LlamaConfig, dtype: torch.dtype, seed: int) -> LlamaModel:
        log.warning("Initialising %d-layer LLM with RANDOM weights (seed %d)",
                    config.n_layers, seed)
        with torch.device("meta"):
            model = LlamaModel(config, dtype)
        return init_random_(model.to_empty(device=self.device), seed)

    @property
    def weight_bytes(self) -> int:
        """Bytes of the model's parameters and buffers on the device."""
        return sum(t.numel() * t.element_size()
                   for t in list(self.model.parameters()) + list(self.model.buffers()))

    # ------------------------------------------------------------- helpers
    def _h2d(self, x, dtype: torch.dtype) -> torch.Tensor:
        """Host array -> device tensor without a host sync (pinned staging
        and an asynchronous copy on CUDA; a copy on the CPU)."""
        t = torch.tensor(np.asarray(x), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _bucket(self, n: int) -> int:
        p = 16
        while p < n:
            p *= 2
        return min(p, self.cfg.max_seq)

    # ------------------------------------------------------------ sampling
    def _topk_scaled(self, logits, temperature, top_k):
        """Temperature / top-k filter: ``[B, V]`` -> scaled logits with the
        entries below each row's k-th value at -inf (a 64-wide slate, as the
        JAX program; ``top_k <= 0`` disables)."""
        scaled = logits / temperature.clamp_min(1e-4)[:, None]
        slate = min(64, self.cfg.vocab_size)
        topv = torch.topk(scaled, slate, dim=-1).values
        kth = topv.gather(1, (top_k - 1).clamp(0, slate - 1).long()[:, None])
        thresh = torch.where(top_k[:, None] > 0, kth, torch.full_like(kth, -float("inf")))
        return torch.where(scaled >= thresh, scaled, torch.full_like(scaled, -float("inf")))

    def _sample_rows(self, logits, gens: Sequence[Optional[torch.Generator]], temperature,
                     top_k, greedy: np.ndarray) -> torch.Tensor:
        """``[B, V]`` float32 logits -> ``[B]`` tokens.  Greedy rows take the
        argmax; a sampled row draws from its own generator.  When every row
        is greedy (known on the host) the filter and the draws are skipped."""
        am = logits.argmax(dim=-1)
        if greedy.all():
            return am
        probs = torch.softmax(self._topk_scaled(logits, temperature, top_k), dim=-1)
        out = am.clone()
        for i in np.flatnonzero(~greedy):
            out[i] = torch.multinomial(probs[i], 1, generator=gens[i])[0]
        return out

    def _first_sample(self, logits, seeds: Sequence[int], temperature: np.ndarray,
                      top_k: np.ndarray, greedy: np.ndarray):
        """Admission: one generator per request from its seed, then the
        first token.  Returns ``(firsts [n] device, generators)``."""
        gens = []
        for s, g in zip(seeds, greedy):
            if g:
                gens.append(None)
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(int(s))
                gens.append(gen)
        firsts = self._sample_rows(logits, gens, self._h2d(temperature, torch.float32),
                                   self._h2d(top_k, torch.int64), greedy)
        return firsts, gens

    # --------------------------------------------------------- pool access
    def _pool_gather_body(self, pool, bt: torch.Tensor):
        """Pool tensors -> dense per-row views ``[B, nb*blk, ...]`` (copies)."""
        return [{k: gather_pool(v, bt) for k, v in layer.items()} for layer in pool]

    @staticmethod
    def _pool_views(pool, bt: torch.Tensor, lens: torch.Tensor):
        """Per-layer in-place views for the paged kernel: the pool tensors
        under ``pk``/``pv`` (+ scales), the block table and the lengths."""
        def view(layer):
            v = {"pk": layer["k"], "pv": layer["v"], "bt": bt, "lens": lens}
            if "k_scale" in layer:
                v["pk_scale"] = layer["k_scale"]
                v["pv_scale"] = layer["v_scale"]
            return v

        return [view(layer) for layer in pool]

    def _pool_scatter(self, pool, bt_rows: np.ndarray, src_layers, keymap: Dict[str, str],
                      positions: np.ndarray, valid: np.ndarray) -> None:
        """Write ``src[r, j]`` (``[R, L, ...]`` per layer and key) at global
        cache position ``positions[r, j]`` of row ``r`` where ``valid``,
        through the host block tables ``bt_rows [R, nb]``, in place.
        Positions outside the row's allocation (table entry 0: a retiring
        row's overshoot steps) are dropped, so block 0 is never written."""
        blk = pool[0]["k"].shape[1]
        nb = bt_rows.shape[1]
        valid = valid & (positions < nb * blk)
        valid[valid] &= bt_rows[np.nonzero(valid)[0], positions[valid] // blk] > 0
        r_idx, j_idx = np.nonzero(valid)
        if r_idx.size == 0:
            return
        pos = positions[r_idx, j_idx]
        blocks = bt_rows[r_idx, pos // blk]
        flat = self._h2d(blocks.astype(np.int64) * blk + pos % blk, torch.int64)
        rows = self._h2d(r_idx, torch.int64)
        cols = self._h2d(j_idx, torch.int64)
        for layer, src in zip(pool, src_layers):
            for k, dst in layer.items():
                s = src[keymap.get(k, k)][rows, cols]
                dst.view((-1,) + tuple(dst.shape[2:])).index_copy_(0, flat, s.to(dst.dtype))

    def _insert_span(self, pool, bt_rows: np.ndarray, caches, start: int, bucket: int,
                     limits: np.ndarray) -> None:
        """Write cache positions ``[start, start + bucket)`` of R row caches
        into the pool, each row clipped at its allocation ``limits[r]``."""
        R = bt_rows.shape[0]
        positions = start + np.broadcast_to(np.arange(bucket), (R, bucket))
        src = [{k: v[:, start:start + bucket] for k, v in layer.items()} for layer in caches]
        self._pool_scatter(pool, bt_rows, src, {}, positions, positions < limits[:, None])

    # ------------------------------------------------------------- prefill
    def _prefill(self, tokens: np.ndarray, length, caches):
        """From-zero prefill of ``tokens [B, bucket]``: logits at each row's
        ``length - 1`` ``[B, V]``.  One pass of in-bucket causal attention
        (the panel flash kernel for long bf16 prompts on the card) up to
        ``PREFILL_CHUNK`` tokens; past it, the JAX ``_prefill_long``: chunks
        of ``PREFILL_CHUNK``, the first on the panel route and the rest on
        the streaming route over the cache (``_prefill_from``)."""
        return self._prefill_from(tokens, 0, length, caches)

    def _prefill_masked_body(self, tokens, base: int, length, caches):
        """Rows at positions ``base + i`` attend ``[0, base + i]`` through an
        explicit mask over the whole line (the plain attention path).
        Returns the logits at each row's last prompt token ``[B, V]``."""
        b, s = tokens.shape
        positions = base + torch.arange(s, device=self.device).expand(b, s)
        mask = (torch.arange(self.cfg.max_seq, device=self.device)[None, None, None, :]
                <= positions[:, None, :, None])
        local_last = (length - 1 - base).clamp(0, s - 1)
        return self.model(tokens, positions, caches, base, mask, local_last)[:, 0]

    def _prefill_chunk(self, tokens, offset: int, length, caches):
        """One streaming chunk: rows at ``offset + i`` attend the cache
        prefix through the flash kernel (``q_offset``/``kv_len``)."""
        b, s = tokens.shape
        positions = offset + torch.arange(s, device=self.device).expand(b, s)
        local_last = (length - 1 - offset).clamp(0, s - 1)
        return self.model(tokens, positions, caches, offset, None, local_last)[:, 0]

    def _prefill_from(self, tokens: np.ndarray, base: int, length, caches):
        """Prefill ``tokens [B, bucket]`` from cache position ``base`` over
        the populated ``[0, base)``: one masked pass when ``base > 0`` and
        ``bucket * max_seq <= MASKED_PREFILL_MAX``, else ``PREFILL_CHUNK``-
        token chunks through ``_prefill_chunk`` (a chunk at position 0 takes
        the panel route, the others the streaming flash kernel).  ``length``
        (device ``[B]``): the rows' true prompt lengths; each row's logits
        come from the chunk holding its ``length - 1``."""
        bucket = tokens.shape[1]
        if base > 0 and bucket * self.cfg.max_seq <= self.MASKED_PREFILL_MAX:
            return self._prefill_masked_body(self._h2d(tokens, torch.int64), base, length,
                                             caches)
        out, lo = None, 0
        while lo < bucket:
            n = min(self.PREFILL_CHUNK, bucket - lo)
            logits = self._prefill_chunk(self._h2d(tokens[:, lo:lo + n], torch.int64), base + lo,
                                         length, caches)
            hit = ((length - 1 >= base + lo) & (length - 1 < base + lo + n))[:, None]
            out = logits if out is None else torch.where(hit, logits, out)
            lo += n
        return out

    # ------------------------------------------------- dense prefix surgery
    def _extract_kv(self, caches, row: int, start: int, n: int):
        """Copies of cache row ``row`` positions ``[start, start + n)`` of
        every layer and tensor (the device half of a dense prefix-store
        insert)."""
        return [{k: v[row, start:start + n].clone() for k, v in layer.items()}
                for layer in caches]

    @staticmethod
    def _restore_kv_rows(row_caches, prefix) -> None:
        """Write a stored prefix (per-layer ``[n, ...]`` tensors on the
        device) into positions ``[0, n)`` of every row of ``row_caches``."""
        for layer, pre in zip(row_caches, prefix):
            for k, dst in layer.items():
                src = pre[k]
                dst[:, :src.shape[0]] = src[None].to(dst.dtype)

    def _prefix_to_device(self, kv, key=None):
        """Host KV segment -> device tensors, memoised by the store's path
        ``key`` (``prefix_dev_cap`` entries, LRU): a repeat hit on a hot
        prefix moves no bytes.  ``key=None`` transfers uncached."""
        dev = self._prefix_dev.get(key) if key is not None else None
        if dev is None:
            dev = [{k: v.to(self.device, non_blocking=True) for k, v in layer.items()}
                   for layer in kv]
            if key is not None:
                self._prefix_dev[key] = dev
                while len(self._prefix_dev) > max(1, self.prefix_dev_cap):
                    self._prefix_dev.popitem(last=False)
        else:
            self._prefix_dev.move_to_end(key)
        return dev

    def extract_prefix_host(self, caches, row: int, start: int, n: int):
        """``_extract_kv`` fetched to CPU tensors (the layout
        ``serving.prefix_cache`` stores)."""
        if n <= 0:
            return []
        return [{k: v.cpu() for k, v in layer.items()}
                for layer in self._extract_kv(caches, row, start, n)]

    # ------------------------------------------------------------ admission
    @torch.no_grad()
    def _admit_fused_paged(self, tokens: np.ndarray, pool, bt_rows: np.ndarray,
                           lengths: np.ndarray, limits: np.ndarray, seeds, temp, topk,
                           greedy):
        """A same-bucket wave from position 0: prefill into fresh row caches
        of the bucket's length, write them into the pool through the rows'
        block tables, sample the first tokens.  Returns ``(firsts [n],
        generators)``."""
        n, bucket = tokens.shape
        caches = init_kv_caches(self.cfg, n, self.cache_dtype, self.device, length=bucket)
        logits = self._prefill(tokens, self._h2d(lengths, torch.int64), caches)
        self._insert_span(pool, bt_rows, caches, 0, bucket, limits)
        return self._first_sample(logits, seeds, temp, topk, greedy)

    @torch.no_grad()
    def _admit_prefix_paged(self, tokens: np.ndarray, pool, bt_rows: np.ndarray, base: int,
                            lengths: np.ndarray, limits: np.ndarray, seeds, temp, topk,
                            greedy):
        """A prefix hit: gather the row's line (the shared blocks hold what
        prefill wrote), prefill the suffix (masked pass, or the streaming
        kernel past ``MASKED_PREFILL_MAX``), write the suffix span back,
        sample.  Returns ``(firsts [1], generators)``."""
        caches = self._pool_gather_body(pool, self._h2d(bt_rows, torch.int32))
        length = self._h2d(lengths, torch.int64)
        logits = self._prefill_from(tokens, base, length, caches)
        self._insert_span(pool, bt_rows, caches, base, tokens.shape[1], limits)
        return self._first_sample(logits, seeds, temp, topk, greedy)

    @torch.no_grad()
    def _prefill_chunk_paged(self, pool, bt_rows: np.ndarray, tokens: np.ndarray, base: int,
                             limits: np.ndarray) -> None:
        """One chunked-prefill step for a parked long prompt: gather the
        row's line (earlier chunks' KV sits in its blocks), prefill
        ``tokens`` from ``base`` (``_prefill_from``: masked when small, else
        the panel route at position 0 and the streaming kernel after it),
        write the span back up to ``limits`` (``base`` + the chunk).  No
        sample: the slot stays parked, and only the final chunk goes
        through the ordinary warm start for its first token."""
        caches = self._pool_gather_body(pool, self._h2d(bt_rows, torch.int32))
        self._prefill_from(tokens, base, self._h2d(limits, torch.int64), caches)
        self._insert_span(pool, bt_rows, caches, base, tokens.shape[1], limits)

    @torch.no_grad()
    def _restore_blocks_paged(self, pool, ids: Sequence[int], payloads) -> None:
        """Host-tier restore: write ``payloads`` (one per block, host KV in
        the pool's per-layer layout) into pool blocks ``ids``, on the
        current stream ahead of the warm start that reads them.  A payload
        packed by ``serving.kv_host_tier`` (``.flat`` pinned bytes,
        ``.layout``) goes up in one copy per block and lands with one
        ``index_copy_`` per pool tensor; plain per-tensor payloads are
        stacked per tensor.  The caller keeps ``payloads`` alive until the
        copies have run."""
        idx = self._h2d(np.asarray(ids, np.int64), torch.int64)
        R = len(ids)
        flats = [getattr(p, "flat", None) for p in payloads]
        if all(f is not None for f in flats):
            stage = torch.empty((R, flats[0].numel()), dtype=torch.uint8, device=self.device)
            for r, f in enumerate(flats):
                stage[r].copy_(f, non_blocking=True)
            for li, k, off, nbytes, dtype, shape in payloads[0].layout:
                src = stage[:, off:off + nbytes].contiguous().view(dtype).view((R,) + shape)
                pool[li][k].index_copy_(0, idx, src)
            return
        for li, layer in enumerate(pool):
            for k, dst in layer.items():
                src = torch.stack([p[li][k] for p in payloads]).to(self.device)
                dst.index_copy_(0, idx, src.to(dst.dtype))

    # ---------------------------------------------------- dense slot engine
    @staticmethod
    def _splice_rows(slot_caches, row_caches, slot_ids: Sequence[int], n_pos: int) -> None:
        """Copy positions ``[0, n_pos)`` of row ``j`` of ``row_caches`` into
        slot line ``slot_ids[j]`` (every layer, K/V and int8 scales)."""
        ids = torch.as_tensor(list(slot_ids), dtype=torch.int64,
                              device=slot_caches[0]["k"].device)
        for dst_l, src_l in zip(slot_caches, row_caches):
            for k, dst in dst_l.items():
                dst[:, :n_pos].index_copy_(0, ids, src_l[k][:, :n_pos].to(dst.dtype))

    @torch.no_grad()
    def _admit_fused(self, tokens: np.ndarray, slot_caches, lengths: np.ndarray,
                     slot_ids: Sequence[int], seeds, temp, topk, greedy):
        """A same-bucket wave from position 0 on the dense engine: prefill
        fresh row caches of the bucket's length, splice them into the slot
        lines, sample the first tokens.  Returns ``(firsts [n], generators)``."""
        n, bucket = tokens.shape
        caches = init_kv_caches(self.cfg, n, self.cache_dtype, self.device, length=bucket)
        logits = self._prefill(tokens, self._h2d(lengths, torch.int64), caches)
        self._splice_rows(slot_caches, caches, slot_ids, bucket)
        return self._first_sample(logits, seeds, temp, topk, greedy)

    @torch.no_grad()
    def _admit_prefix(self, tokens: np.ndarray, slot_caches, plen: int, lengths: np.ndarray,
                      slot_id: int, prefix_dev, seeds, temp, topk, greedy):
        """A dense prefix-store hit: restore the stored prefix into a fresh
        row cache, prefill the suffix from ``plen`` (``_prefill_from``),
        splice ``[0, plen + bucket)`` into the slot line, sample."""
        caches = init_kv_caches(self.cfg, 1, self.cache_dtype, self.device)
        self._restore_kv_rows(caches, prefix_dev)
        logits = self._prefill_from(tokens, plen, self._h2d(lengths, torch.int64), caches)
        self._splice_rows(slot_caches, caches, [slot_id], plen + tokens.shape[1])
        return self._first_sample(logits, seeds, temp, topk, greedy)

    def _flush_chunk_bufs(self, caches, bufs, cur: np.ndarray, cur_end: np.ndarray,
                          n_steps: int) -> None:
        """Write chunk buffer step ``j`` of row ``r`` at position ``cur[r] +
        j`` of its slot line, for the positions before ``cur_end[r]`` (a
        verify's accepted frontier; overshoot past ``max_seq - 1`` is never
        written)."""
        S = self.cfg.max_seq
        pos = cur[:, None] + np.arange(n_steps)[None, :]
        r_idx, j_idx = np.nonzero(pos < cur_end[:, None])
        if r_idx.size == 0:
            return
        flat = self._h2d(r_idx * S + pos[r_idx, j_idx], torch.int64)
        rows, cols = self._h2d(r_idx, torch.int64), self._h2d(j_idx, torch.int64)
        for cache, buf in zip(caches, bufs):
            for k, dst in cache.items():
                src = buf[_POOL_TO_BUF[k]][rows, cols]
                dst.view((-1,) + tuple(dst.shape[2:])).index_copy_(0, flat, src.to(dst.dtype))

    @torch.no_grad()
    def _decode_scan_cont(self, first_tok, cur: np.ndarray, active: np.ndarray, caches, gens,
                          temperature: np.ndarray, top_k: np.ndarray, greedy: np.ndarray,
                          n_steps: int, teacher=None):
        """One plain decode chunk over the dense slot lines (the frozen view
        through the plain partial), then the chunk buffers flushed into the
        lines at ``[cur, cur_end)``.  Returns ``(toks [B, T] device, last
        [B, 1] device, cur_end host)`` (plus the logits with ``teacher``)."""
        cur0, act, _, temp_d, topk_d = self._dispatch_inputs(cur, active, None, temperature,
                                                             top_k)
        toks, last, bufs, logits = self._decode_cont_body(
            first_tok, cur0, act, caches, gens, temp_d, topk_d, greedy, n_steps, teacher)
        cur_end = np.minimum(cur + n_steps * active, self.cfg.max_seq - 1)
        self._flush_chunk_bufs(caches, bufs, cur, cur_end, n_steps)
        if teacher is not None:
            return toks, last, cur_end, logits
        return toks, last, cur_end

    # --------------------------------------------------------------- decode
    def _decode_cont_body(self, first_tok, cur0, act, view, gens, temperature, top_k,
                          greedy: np.ndarray, n_steps: int, teacher=None):
        """``n_steps`` decode steps over a frozen view, K/V landing in fresh
        chunk buffers.  Returns ``(toks [B, T], last [B, 1], bufs, logits)``;
        ``teacher [B, T]`` feeds those tokens instead of the samples and
        collects the logits ``[B, T, V]`` (else ``logits`` is None)."""
        S = self.cfg.max_seq
        B = first_tok.shape[0]
        bufs = init_chunk_bufs(self.cfg, B, n_steps, self.cache_dtype, self.device)
        merged = [dict(c, **bf) for c, bf in zip(view, bufs)]
        tok, out, kept = first_tok, [], []
        for t in range(n_steps):
            cur_t = (cur0 + t * act).clamp(max=S - 1)
            logits = self.model(tok, cur_t[:, None], merged, (cur0, t))[:, -1]
            nxt = self._sample_rows(logits, gens, temperature, top_k, greedy)
            if teacher is not None:
                kept.append(logits)
                nxt = teacher[:, t]
            out.append(nxt)
            tok = nxt[:, None]
        return (torch.stack(out, dim=1), tok, bufs,
                torch.stack(kept, dim=1) if teacher is not None else None)

    def _dispatch_inputs(self, cur, active, bt, temperature, top_k):
        cur0 = self._h2d(cur, torch.int64)
        return (cur0, self._h2d(active, torch.int64),
                None if bt is None else self._h2d(bt, torch.int32),
                self._h2d(temperature, torch.float32), self._h2d(top_k, torch.int64))

    def _view(self, pool, bt_d, cur0, flash: bool):
        return (self._pool_views(pool, bt_d, cur0.int()) if flash
                else self._pool_gather_body(pool, bt_d))

    @torch.no_grad()
    def _decode_scan_paged(self, first_tok, cur: np.ndarray, active: np.ndarray, pool,
                           bt: np.ndarray, gens, temperature: np.ndarray, top_k: np.ndarray,
                           greedy: np.ndarray, n_steps: int, flash: bool = False,
                           teacher=None):
        """One plain decode chunk over the paged pool; the chunk buffers are
        written back through the block tables at ``[cur, cur_end)``.
        ``flash`` reads the pool in place through the paged kernel, else a
        gathered dense copy feeds the plain partial (the bisection path).
        Returns ``(toks [B, T] device, last [B, 1] device, cur_end host)``
        (plus the logits with ``teacher``)."""
        cur0, act, bt_d, temp_d, topk_d = self._dispatch_inputs(cur, active, bt, temperature,
                                                                top_k)
        toks, last, bufs, logits = self._decode_cont_body(
            first_tok, cur0, act, self._view(pool, bt_d, cur0, flash), gens, temp_d, topk_d,
            greedy, n_steps, teacher)
        cur_end = np.minimum(cur + n_steps * active, self.cfg.max_seq - 1)
        positions = cur[:, None] + np.arange(n_steps)[None, :]
        self._pool_scatter(pool, bt, bufs, _POOL_TO_BUF, positions, positions < cur_end[:, None])
        if teacher is not None:
            return toks, last, cur_end, logits
        return toks, last, cur_end


    # ---------------------------------------------------- speculative verify
    def _spec_verify_parts(self, first_tok, draft: np.ndarray, draft_len: np.ndarray,
                           cur: np.ndarray, active: np.ndarray, view, gens,
                           temperature: np.ndarray, top_k: np.ndarray, greedy: np.ndarray,
                           n_draft: int):
        """The verify step shared by the paged and dense programs: the last
        accepted token plus ``draft [B, K]`` (``draft_len`` valid per row)
        in ONE forward pass, K+1 query rows per slot over the frozen
        ``view`` (the paged pool's, or the dense slot lines) and the
        in-segment causal chunk buffer.  Greedy rows accept drafts while
        they equal the argmax; sampled rows rejection-sample.  Returns host
        ``(toks [B, K+1], n_acc [B], cur_end [B])``, the device ``last
        [B, 1]`` and the chunk buffers (written back by the caller up to
        ``cur_end``)."""
        K, S = n_draft, n_draft + 1
        B = first_tok.shape[0]
        V = self.cfg.vocab_size
        cur0, act, _, temp_d, topk_d = self._dispatch_inputs(cur, active, None, temperature,
                                                             top_k)
        draft_d = self._h2d(draft, torch.int64)
        dlen_d = self._h2d(draft_len, torch.int64)
        seg = torch.cat([first_tok, draft_d], dim=1)                       # [B, S]
        bufs = init_chunk_bufs(self.cfg, B, S, self.cache_dtype, self.device)
        merged = [dict(c, **bf) for c, bf in zip(view, bufs)]
        ar = torch.arange(S, device=self.device)
        positions = (cur0[:, None] + ar[None, :] * act[:, None]).clamp(max=self.cfg.max_seq - 1)
        logits = self.model(seg, positions, merged, (cur0, 0))            # [B, S, V] f32
        outs_greedy = logits.argmax(dim=-1)
        valid = torch.arange(K, device=self.device)[None, :] < dlen_d[:, None]
        acc = (outs_greedy[:, :K] == draft_d) & valid
        draft_pad = torch.cat([draft_d, torch.zeros_like(draft_d[:, :1])], dim=1)
        if greedy.all():
            n_acc = acc.long().cumprod(dim=1).sum(dim=1)
            bonus = outs_greedy.gather(1, n_acc[:, None])[:, 0]
        else:
            scaled = self._topk_scaled(logits.reshape(B * S, V), temp_d.repeat_interleave(S),
                                       topk_d.repeat_interleave(S)).reshape(B, S, V)
            probs = torch.softmax(scaled, dim=-1)
            p_draft = probs[:, :K].gather(2, draft_d[..., None])[..., 0]    # [B, K]
            u = torch.ones((B, K), device=self.device)
            sampled = np.flatnonzero(~greedy)
            for i in sampled:
                u[i] = torch.rand(K, generator=gens[i], device=self.device)
            gr = self._h2d(greedy, torch.bool)
            acc = torch.where(gr[:, None], acc, (u < p_draft) & valid)
            n_acc = acc.long().cumprod(dim=1).sum(dim=1)
            # bonus at n_acc: the residual (rejected draft removed) after a
            # true rejection, the full distribution when drafts ran out
            pj = probs.gather(1, n_acc[:, None, None].expand(B, 1, V))[:, 0]
            rejected = draft_pad.gather(1, n_acc[:, None])[:, 0]
            ran_out = n_acc >= dlen_d
            drop = (torch.arange(V, device=self.device)[None, :] == rejected[:, None]) \
                & ~ran_out[:, None]
            residual = torch.where(drop, torch.zeros_like(pj), pj).clamp_min(1e-38)
            bonus = outs_greedy.gather(1, n_acc[:, None])[:, 0].clone()
            for i in sampled:
                bonus[i] = torch.multinomial(residual[i], 1, generator=gens[i])[0]
        toks = torch.where(ar[None, :] < n_acc[:, None], draft_pad,
                           torch.where(ar[None, :] == n_acc[:, None], bonus[:, None],
                                       torch.zeros_like(draft_pad)))
        toks_h = toks.cpu().numpy()  # the verify wave's one host sync
        n_acc_h = n_acc.cpu().numpy()
        cur_end = np.minimum(cur + (n_acc_h + 1) * active, self.cfg.max_seq - 1)
        return toks_h, n_acc_h, bonus[:, None], cur_end, bufs

    @torch.no_grad()
    def _spec_verify_paged(self, first_tok, draft: np.ndarray, draft_len: np.ndarray,
                           cur: np.ndarray, active: np.ndarray, pool, bt: np.ndarray, gens,
                           temperature: np.ndarray, top_k: np.ndarray, greedy: np.ndarray,
                           n_draft: int, flash: bool = False):
        """One verify step over the paged pool (read in place through the
        paged kernel with ``flash``, else a gathered copy); only the accepted
        positions are written to the pool.  Returns host ``(toks [B, K+1],
        n_acc [B])``, the device ``last [B, 1]`` and host ``cur_end``."""
        bt_d = self._h2d(bt, torch.int32)
        cur0 = self._h2d(cur, torch.int64)
        view = self._view(pool, bt_d, cur0, flash)
        toks_h, n_acc_h, last, cur_end, bufs = self._spec_verify_parts(
            first_tok, draft, draft_len, cur, active, view, gens, temperature, top_k, greedy,
            n_draft)
        pos_h = cur[:, None] + np.arange(n_draft + 1)[None, :]
        self._pool_scatter(pool, bt, bufs, _POOL_TO_BUF, pos_h, pos_h < cur_end[:, None])
        return toks_h, n_acc_h, last, cur_end

    @torch.no_grad()
    def _spec_verify_cont(self, first_tok, draft: np.ndarray, draft_len: np.ndarray,
                          cur: np.ndarray, active: np.ndarray, caches, gens,
                          temperature: np.ndarray, top_k: np.ndarray, greedy: np.ndarray,
                          n_draft: int):
        """Dense verify: the frozen slot lines through the plain partial,
        then the chunk flush clipped at each row's ACCEPTED frontier, so
        rejected draft K/V is never written."""
        toks_h, n_acc_h, last, cur_end, bufs = self._spec_verify_parts(
            first_tok, draft, draft_len, cur, active, caches, gens, temperature, top_k, greedy,
            n_draft)
        self._flush_chunk_bufs(caches, bufs, cur, cur_end, n_draft + 1)
        return toks_h, n_acc_h, last, cur_end

    # ------------------------------------------------------------------ solo
    def _decode_step(self, tok, index: int, caches, gen, temperature, top_k,
                     greedy: np.ndarray):
        """One cached solo decode step: ``tok [1, 1]`` at position ``index``
        over the masked line ``[0, index]`` -> the next token ``[1]``."""
        positions = torch.full((1, 1), index, dtype=torch.int64, device=self.device)
        mask = torch.arange(self.cfg.max_seq, device=self.device)[None, None, None, :] <= index
        logits = self.model(tok, positions, caches, index, mask)[:, -1]
        return self._sample_rows(logits, [gen], temperature, top_k, greedy)

    def _decode_scan(self, first_tok, caches, start_index: int, gen, temperature, top_k,
                     greedy: np.ndarray, n_steps: int):
        """``n_steps`` solo decode steps from ``start_index``; the token
        chain stays on the device.  Returns ``[1, n_steps]``."""
        tok, out = first_tok, []
        for i in range(n_steps):
            nxt = self._decode_step(tok, start_index + i, caches, gen, temperature, top_k,
                                    greedy)
            out.append(nxt)
            tok = nxt[:, None]
        return torch.stack(out, dim=1)

    @staticmethod
    def _run_chunk_chain(scan, first_dev, consume, *, chunk: int, budget: int,
                         cache_room: int, cancel_check, initial_stop: bool = False,
                         depth: int = 2) -> None:
        """The pipelined decode-chunk chain of ``generate_fused``: each
        chunk's first token is the previous chunk's last, on the device; the
        host fetches one chunk behind the frontier, so a stop costs at most
        ``depth`` chunks of discarded work.  ``scan(first_dev, dispatched)``
        dispatches one chunk; ``consume(block)`` takes the fetched ``[1,
        chunk]`` numpy block and returns True to stop; ``cancel_check()`` is
        polled before every dispatch and every fetch.  A full chunk must fit
        ``cache_room`` or the chain drains (the caller finishes one step at
        a time)."""
        chain: List = []
        next_first = first_dev
        dispatched = 0
        stopped = initial_stop or budget <= 0
        while not stopped or chain:
            if cancel_check is not None and cancel_check():
                chain.clear()
                break
            while (not stopped and len(chain) < depth and dispatched < budget
                   and cache_room - dispatched >= chunk):
                if cancel_check is not None and cancel_check():
                    stopped = True
                    chain.clear()
                    break
                toks = scan(next_first, dispatched)
                next_first = toks[:, -1:]
                chain.append(toks)
                dispatched += chunk
            if not chain:
                break
            if consume(chain.pop(0).cpu().numpy()):  # the chain's one fetch per chunk
                stopped = True
                chain.clear()

    def _sampling(self, sample: SampleConfig, seed: Optional[int]):
        """``(generator or None, temperature, top_k, greedy)`` for one solo
        request: a greedy request never draws; a sampled one draws from a
        generator seeded by ``seed`` (None: a fresh random seed)."""
        gen = None
        if not sample.greedy:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(np.random.randint(0, 2 ** 31)) if seed is None
                            else int(seed) % (2 ** 32))
        return (gen, self._h2d([sample.temperature], torch.float32),
                self._h2d([sample.top_k], torch.int64), np.array([sample.greedy]))

    @torch.no_grad()
    def _start_generation(self, prompt_tokens: List[int], max_new_tokens: int,
                          sample: SampleConfig, seed: Optional[int], prefix=None,
                          kv_extract=None, on_prefill_kv=None):
        """The solo prologue: validate, prefill, sample the first token.
        Returns ``(first, caches, sampling, n_prompt, max_new_tokens,
        prefill_s, n_cached)``.

        ``prefix``: ``(n_cached, kv[, key])`` from a dense prefix-store hit:
        the stored KV is restored into ``[0, n_cached)`` and only the suffix
        pays prefill.  ``kv_extract``: ``(start, end)`` positions handed to
        ``on_prefill_kv`` as host tensors after prefill (the store's insert)."""
        c = self.cfg
        n_prompt = len(prompt_tokens)
        if n_prompt == 0:
            raise ValueError("empty prompt")
        if n_prompt + max_new_tokens > c.max_seq:
            max_new_tokens = c.max_seq - n_prompt
            if max_new_tokens <= 0:
                raise ValueError(f"prompt ({n_prompt}) exceeds ctx {c.max_seq}")
        n_cached = 0
        if prefix is not None and prefix[0] > 0:
            n_cached = int(prefix[0])
            if n_cached >= n_prompt:
                raise ValueError(f"cached prefix ({n_cached}) must leave a suffix of prompt "
                                 f"({n_prompt})")
        t0 = time.time()
        length = self._h2d([n_prompt], torch.int64)
        caches = init_kv_caches(c, 1, self.cache_dtype, self.device)
        if n_cached:
            self._restore_kv_rows(caches, self._prefix_to_device(
                prefix[1], prefix[2] if len(prefix) > 2 else None))
            bucket = min(self._bucket(n_prompt - n_cached), c.max_seq - n_cached)
            tokens = np.zeros((1, bucket), np.int64)
            tokens[0, :n_prompt - n_cached] = prompt_tokens[n_cached:]
            logits = self._prefill_from(tokens, n_cached, length, caches)
        else:
            tokens = np.zeros((1, self._bucket(n_prompt)), np.int64)
            tokens[0, :n_prompt] = prompt_tokens
            logits = self._prefill(tokens, length, caches)
        if kv_extract is not None and on_prefill_kv is not None:
            s, e = kv_extract
            if e > s:
                try:  # a failing store insert must not fail a finished prefill
                    on_prefill_kv(self.extract_prefix_host(caches, 0, s, e - s))
                except Exception:
                    log.exception("on_prefill_kv failed (prefix-cache insert skipped)")
        sampling = self._sampling(sample, seed)
        first = int(self._sample_rows(logits, [sampling[0]], *sampling[1:])[0])
        return first, caches, sampling, n_prompt, max_new_tokens, time.time() - t0, n_cached

    @torch.no_grad()
    def generate(self, prompt_tokens: List[int], max_new_tokens: int = 128,
                 sample: SampleConfig = SampleConfig(), seed: Optional[int] = None,
                 stop_tokens: Tuple[int, ...] = (), on_token=None, prefix=None,
                 kv_extract=None, on_prefill_kv=None) -> Tuple[List[int], Dict[str, float]]:
        """``(generated token ids, stats)``, one decode step per token.
        ``on_token(tok)`` hears each token as soon as it is known (stop
        token included): the streaming hook; an exception it raises ends
        the generation.  ``prefix``/``kv_extract``/``on_prefill_kv``: the
        dense prefix-store hooks (``_start_generation``)."""
        tok, caches, (gen, temp, topk, greedy), n_prompt, max_new_tokens, t_prefill, n_cached = (
            self._start_generation(prompt_tokens, max_new_tokens, sample, seed, prefix,
                                   kv_extract, on_prefill_kv))
        t0 = time.time()
        out: List[int] = []
        for i in range(max_new_tokens):
            out.append(tok)
            if on_token is not None:
                on_token(tok)
            if tok in stop_tokens or i + 1 == max_new_tokens:
                break
            nxt = self._decode_step(torch.tensor([[tok]], device=self.device), n_prompt + i,
                                    caches, gen, temp, topk, greedy)
            tok = int(nxt[0])  # the streaming path's per-token fetch
        return out, self._finish_stats(out, n_prompt, t_prefill, t0, n_cached)

    @torch.no_grad()
    def generate_fused(self, prompt_tokens: List[int], max_new_tokens: int = 128,
                       sample: SampleConfig = SampleConfig(), seed: Optional[int] = None,
                       stop_tokens: Tuple[int, ...] = (), chunk: int = 32, cancel_check=None,
                       prefix=None, kv_extract=None,
                       on_prefill_kv=None) -> Tuple[List[int], Dict[str, float]]:
        """Like ``generate`` but ``chunk`` decode steps per dispatch, in the
        pipelined chain (``_run_chunk_chain``): stop tokens are honoured at
        chunk granularity, up to ``depth`` chunks of speculative device work
        discarded.  The same steps and draws as ``generate``, so the output
        is ``generate``'s token for token.  ``cancel_check()`` is polled
        between chunks; True abandons the generation."""
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        first, caches, (gen, temp, topk, greedy), n_prompt, max_new_tokens, t_prefill, \
            n_cached = self._start_generation(prompt_tokens, max_new_tokens, sample, seed,
                                              prefix, kv_extract, on_prefill_kv)
        t0 = time.time()
        out: List[int] = [] if max_new_tokens <= 0 else [first]
        state = {"tok": first}

        def scan(first_dev, dispatched):
            return self._decode_scan(first_dev, caches, n_prompt + dispatched, gen, temp, topk,
                                     greedy, chunk)

        def consume(block) -> bool:
            for t in (int(x) for x in block[0]):
                out.append(t)
                state["tok"] = t
                if t in stop_tokens or len(out) >= max_new_tokens:
                    return True
            return False

        self._run_chunk_chain(scan, torch.tensor([[first]], device=self.device), consume,
                              chunk=chunk, budget=max_new_tokens - 1,
                              cache_room=self.cfg.max_seq - n_prompt, cancel_check=cancel_check,
                              initial_stop=first in stop_tokens)
        # a cache tail shorter than a chunk: finish one step at a time
        tok = state["tok"]
        while (out and len(out) < max_new_tokens and tok not in stop_tokens
               and not (cancel_check is not None and cancel_check())):
            nxt = self._decode_step(torch.tensor([[tok]], device=self.device),
                                    n_prompt + len(out) - 1, caches, gen, temp, topk, greedy)
            tok = int(nxt[0])
            out.append(tok)
        return out, self._finish_stats(out, n_prompt, t_prefill, t0, n_cached)

    @staticmethod
    def _finish_stats(out: List[int], n_prompt: int, t_prefill: float, t0: float,
                      n_cached: int = 0) -> Dict[str, float]:
        t_decode = time.time() - t0
        n_gen = len(out)
        return {
            "prompt_tokens": n_prompt,
            "generated_tokens": n_gen,
            "cached_tokens": n_cached,
            "prefill_tokens": n_prompt - n_cached,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": n_gen / t_decode if t_decode > 0 and n_gen else 0.0,
        }
