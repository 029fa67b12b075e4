"""The device half of the paged continuous engine: the port of the parts of
``tpustack/models/llm_generate.py::Generator`` that the paged engine calls.

Each JAX program (a jitted function with donated buffers) is one Python
method here, run eagerly.  What the JAX programs donate, the port updates IN
PLACE: pool tensors take index assignment on a flattened ``[N*blk, Hkv, D]``
view (``_pool_scatter``) at host-computed flat indices that hold only the
valid positions, so nothing is written out of range and block 0 (where idle
table entries point) is never written.  The small per-slot state (frontier
``cur``, ``active``, sampling settings) lives on the host, as numpy arrays
the engine keeps; the device sees copies uploaded per dispatch.  That keeps
the decode chain free of host syncs: the host knows every frontier, so the
scatter indices and the all-greedy gate are computed without asking the
device.

Sampling draws from one seeded ``torch.Generator`` per slot, so a request's
output is a function of (prompt, seed) whatever its batch peers; it cannot
match JAX's threefry numbers.  Greedy rows never draw.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tpustack_torch.models.llama import (LlamaConfig, LlamaModel, init_chunk_bufs,
                                         init_kv_caches)
from tpustack_torch.models.llama_weights import init_random_, load_params
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
    """Holds the model and runs the paged engine's device steps."""

    #: suffix prefills with ``bucket * max_seq`` at most this run as one
    #: masked plain-attention pass over the gathered line; larger ones take
    #: the streaming flash kernel (``_prefill_from``)
    MASKED_PREFILL_MAX = 1 << 21

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
        the populated ``[0, base)``: one masked pass when small, else one
        streaming pass (the JAX package cuts that into 8192-token chunks, one
        compiled program each; run eagerly, one pass takes any bucket).
        ``length``: the rows' true prompt lengths."""
        bucket = tokens.shape[1]
        fn = (self._prefill_masked_body
              if base > 0 and bucket * self.cfg.max_seq <= self.MASKED_PREFILL_MAX
              else self._prefill_chunk)
        return fn(self._h2d(tokens, torch.int64), base, length, caches)

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
        positions = torch.arange(bucket, device=self.device).expand(n, bucket)
        length = self._h2d(lengths, torch.int64)
        logits = self.model(self._h2d(tokens, torch.int64), positions, caches, 0, None,
                            length - 1)[:, 0]
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
        return (cur0, self._h2d(active, torch.int64), self._h2d(bt, torch.int32),
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
    @torch.no_grad()
    def _spec_verify_paged(self, first_tok, draft: np.ndarray, draft_len: np.ndarray,
                           cur: np.ndarray, active: np.ndarray, pool, bt: np.ndarray, gens,
                           temperature: np.ndarray, top_k: np.ndarray, greedy: np.ndarray,
                           n_draft: int, flash: bool = False):
        """One verify step: the last accepted token plus ``draft [B, K]``
        (``draft_len`` valid per row) in ONE forward pass, K+1 query rows
        per slot (the pool prefix through the kernel, the in-segment causal
        half in the chunk buffer).  Greedy rows accept drafts while they
        equal the argmax; sampled rows rejection-sample.  Only the accepted
        positions are written to the pool.  Returns host ``(toks [B, K+1],
        n_acc [B], cur_end [B])`` and the device ``last [B, 1]``."""
        K, S = n_draft, n_draft + 1
        B = first_tok.shape[0]
        V = self.cfg.vocab_size
        cur0, act, bt_d, temp_d, topk_d = self._dispatch_inputs(cur, active, bt, temperature,
                                                                top_k)
        draft_d = self._h2d(draft, torch.int64)
        dlen_d = self._h2d(draft_len, torch.int64)
        seg = torch.cat([first_tok, draft_d], dim=1)                       # [B, S]
        bufs = init_chunk_bufs(self.cfg, B, S, self.cache_dtype, self.device)
        merged = [dict(c, **bf) for c, bf in zip(self._view(pool, bt_d, cur0, flash), bufs)]
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
        pos_h = cur[:, None] + np.arange(S)[None, :]
        self._pool_scatter(pool, bt, bufs, _POOL_TO_BUF, pos_h, pos_h < cur_end[:, None])
        return toks_h, n_acc_h, bonus[:, None], cur_end
