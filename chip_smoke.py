#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, in order; any failure exits non-zero and prints no result line:

1. The card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
2. Build the CUDA kernels from the sources in ``tpustack_torch/ops/csrc``
   (one ``nvcc`` per source, all started together), print ptxas' registers
   and spills, and count each library's ``HGMMA`` (wgmma), ``UTMALDG``
   (TMA loads), ``SYNCS`` (mbarrier) and ``HMMA`` (mma.sync) instructions
   with ``cuobjdump -sass``.
3. Each kernel against its plain PyTorch twin on the card, in bf16: flash
   attention at the shapes the SD1.5 path gives it plus causal/GQA/offset
   and ragged cases; paged attention at the LLM decode and verify shapes
   over a scrambled pool with block 0 poisoned, int8, MQA/GQA/MHA and a
   16-token block.  Per shape the kernel's and the twin's times, a PyTorch
   library call's where one computes the same function, and the least time
   the card could take (``bound_ms``).  Kernel and library times are device
   time, from calls replayed out of a CUDA graph (``device_ms``);
   ``call_ms`` is a call's time from Python, host included, and the twins
   are timed that way.  The paged shapes also cover the edges of the
   kernel's work split (all rows empty, one full row, lengths on tile
   multiples, one row of one kv head, 32-token blocks) and print the share
   of the bound the kernel reaches.  For flash also ``exp_bound_ms``, the
   exponentials alone on the special-function units.  The LLM path's two
   flash shapes are timed after phase 4b, with the prefix hit's length
   taken from that run.  The Wan DiT's shapes (self- and cross-attention at
   CFG batch 2 and at the batched pair's 4) are timed here too.
4. The SD1.5 path: the port's SD1.5 server in-process at full width
   (``SD15Config.sd15()``, bf16, weights drawn from a seed), one
   ``POST /generate`` at 512x512x30 steps, then 8 concurrent requests that
   ride one micro-batch; PNGs, headers and image content checked, and the
   kernel launch counts read across exactly that run.  Then one request at
   1024x1024 (its level-2 attention, D=160, stays on the plain path: exactly
   10 launches per UNet evaluation again), ``/readyz`` 200, and ``/metrics``
   scraped before and after the phase's requests (the server's request and
   image counters move by the number sent).  Then one full-width
   UNet evaluation with the kernel against the same evaluation on the plain
   attention path, and a torch.profiler breakdown of one UNet evaluation at
   batch 1 and 8 (wall, device kernel time, idle share, top kernels).
4b. The LLM path: the port's LLM server in-process at Qwen2.5-7B full width
   (bf16, weights drawn from seed 0, ctx 4096, 8 slots, KV block 64,
   speculation 4, prefix cache on): one completion carrying a ~256-token
   system prompt, then 8 concurrent completions that share it (a repetitive
   body, a >=1024-token prompt outside the cache, a prefix hit with a
   >512-token suffix).  Statuses, bodies, ``/props``, the exact paged
   kernel launch count, flash launches and a leak-free pool are checked.
   Then the serving surface, with its own exact launch counts: a greedy
   streamed ``/completion`` (a >=1024-token prompt) and a streamed
   ``/v1/chat/completions``, each equal to the same request sent without
   streaming (the time to the first event printed beside ``prompt_ms``);
   the drain drill (``POST /admin/drain`` with ``TPUSTACK_ADMIN_TOKEN`` while
   a 128-token completion decodes: ``/readyz`` 503 draining, a new
   completion 503 with ``Retry-After``, the in-flight one whole, undrain,
   ``/readyz`` 200, a leak-free pool); a ``timeout_s`` far below the decode
   time answering 504 and freeing its blocks; a ``traceparent`` echoed as
   ``X-Trace-Id`` with its span tree at ``/debug/traces/{id}``.  ``/metrics``
   before and after all of 4b: ``/completion`` requests moved by the number
   sent, free + used KV blocks equal to the pool, the fleet autoscaler's
   three families present, and ``/props`` ``decode_kernel`` ``paged_flash``.
   Then one decode chunk teacher-forced through the kernel and through the
   gather path, and a torch.profiler breakdown of one decode step and one
   speculative verify step (4 drafts) at 8 rows of 2048 tokens.  The flash
   launches are split by route: the panel route (the TPU's ``_attn_kernel``)
   and the streaming route (``_attn_kernel_stream``: ``kv_len`` given).
   Phase 3's streaming-route shapes of phase 4e (the second chunk and the
   final warm start of a 1024-token chunked prefill, the solo engine's
   second 8192-token chunk over 16384 keys) are timed after phase 4b too.
4e. The LLM engine's modes on phase 4b's model, each with exact launch
   counts by route: (a) chunked prefill (``TPUSTACK_PREFILL_CHUNK_TOKENS=
   1024``): 7 short rows decode while a 3000-token prompt arrives, chunked
   (exactly 2 chunk dispatches in the engine stats and ``/metrics``) and
   monolithic in one call, the short rows' longest wait spanning the long
   prefill printed for both; then the same prompt prefilled both ways into
   fresh blocks, a decode chunk teacher-forced from each (logits within
   ``LLM_LOGITS_REL_L2``) and the greedy agreement; (b) the host KV tier
   (``TPUSTACK_KV_HOST_TIER_MB=1024``, crossover off, a pool the size of a
   filler's footprint): a ~2000-token prefix evicted by the filler spills,
   a repeat restores it, exact spilled and restored counts, conservation,
   the restored request's ids equal to a large pool's, restore against
   recompute walls and the crossover guard's verdict; (c) the dense engine
   (``TPUSTACK_PAGED_KV=0``): phase 4b's 8 prompts on the paged and on the
   dense engine, agreement and aggregate tokens/s, one dense prefix-store
   hit, a profile of one dense decode step; (d) the solo engine
   (``LLM_MAX_BATCH=1``) at ctx 16384: a 9000-token prompt served plain and
   streamed with equal ids (two 8192-token chunks: the panel route, then the
   streaming route at ``[1,8192,28,128]`` over ``[1,16384,4,128]``);
   (e) the draft-model drafter (``TPUSTACK_SPEC_DRAFT=qwen25_7b``, a seed-0
   twin of the target): acceptance, agreement with speculation off, the
   draft's wall per drafted token.
4c. The Wan T2V path: the port's graph server in-process at Wan2.1 1.3B
   width (DiT 1536 x 30 layers, 12 heads of 128; umt5-xxl; the z=16 VAE;
   bf16, weights drawn on the card from seed 0).  One prompt at the
   reference client's defaults (512x320, 16 frames -> 13, 25 steps, uni_pc
   -> Heun, cfg 6.0), built by the client's ``build_graph`` with SaveImage,
   its 13 PNGs read back through ``/view``; then two prompts queued
   together with the pixel budget raised to admit the pair, which must take
   one dispatch of 2 and the streaming decoder, its row 0 repeating the
   first prompt.  The exact flash launch count (60 per DiT evaluation) and
   a zero batched-dispatch fallback count are checked; then one full-width
   DiT evaluation through the kernel against the plain attention path, the
   full against the streaming decode of one latent, and a torch.profiler
   breakdown of one DiT evaluation at CFG batch 2.  ``/readyz`` 200, and
   ``/metrics`` moved by the three prompts.
5. A JSON line of the end-to-end numbers, then, as the line before the last,
   one JSON line listing every kernel with its numbers: the flash kernel
   once per TPU kernel it stands for (the panel and the streaming route,
   each with its launches by path) and the paged kernel.  Each phase prints
   its wall time.
6. The last line: ``{"ok": true, "device": {...}}``.

Peaks for ``bound_ms`` are the published H100 SXM figures (989 TFLOP/s
dense bf16, 3.35 TB/s HBM3); the card's power limit is printed beside them.
``exp_bound_ms`` takes 16 exp2 per clock per SM over 132 SMs at the card's
maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``, printed).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
H100_SMS, EXP2_PER_CLOCK_PER_SM = 132, 16
# Kernel vs its float32 twin.  Both round the output to bf16 (one ulp is at
# most 2^-7 relative) and the kernel also rounds P to bf16 before P.V; with
# N(0,1) inputs a typical output is ~0.03 at 4096 keys, so the absolute limit
# sits near a tenth of that and a relative-L2 limit catches faults spread thin
# over every row (a dropped K tile, a wrong rescale) that max |err| would not.
ATOL, RTOL = 4e-3, 1e-2
REL_L2 = 1e-2  # ||out - ref|| / ||ref|| per shape
STEPS, SIZE, BATCH = 30, 512, 8
SIZE_LARGE = 1024  # SD1.5's largest served size here: level-2 attention at D=160
DEVICE = "cuda"
KERNEL_SRC = "tpustack_torch/ops/csrc/flash_attention.cu"
KERNEL_REPLACES = "tpustack/ops/pallas/flash_attention.py:38"
KERNEL_ALSO_REPLACES = "tpustack/ops/pallas/flash_attention.py:88"
PAGED_SRC = "tpustack_torch/ops/csrc/paged_attention.cu"
PAGED_REPLACES = "tpustack/ops/pallas/flash_attention.py:409"
# Paged kernel vs its float32 twin (both round p to bf16 before P.V; the
# kernel against its tile's running max, the twin against the row's final
# max, so single elements differ by about a bf16 ulp): the row max m within
# 1e-3 absolute (logits of order 1-5, only the float32 summation order
# differs), the denominator l within 1e-3 relative, acc within 1e-2 relative
# L2, and the normalised output acc / l within ATOL/RTOL per element and
# REL_L2 overall.  Rows with no key must give m = -1e30, l = 0, acc = 0.
PAGED_M_ATOL, PAGED_L_RTOL = 1e-3, 1e-3
# teacher-forced decode chunk at full width, kernel vs gather path: the two
# attention results differ by bf16 roundings of p (~1e-3 relative), carried
# through 28 bf16 layers; the same limit as the UNet check above
LLM_LOGITS_REL_L2 = 5e-2
LLM_SLOTS, LLM_CTX, LLM_NEW = 8, 4096, 128
# phase 4b's deadline drill: far below a 128-token decode at full width
# (~9 s at the ~14 tokens/s a solo row decodes)
LLM_DEADLINE_S = 0.5
# phase 4d: the int8 model against its bf16 twin, held to the JAX package's
# own bounds for weight-only int8 (tests/test_quant.py: logits cosine above
# 0.99, greedy argmax agreement above 0.9)
QUANT_COSINE, QUANT_ARGMAX = 0.99, 0.9
# phase 4d's traffic: 8 batch completions of this many greedy tokens, and
# the batch tenant's token bucket (rate per second, burst)
LLM_BULK_NEW = 256
QUOTA_RATE, QUOTA_BURST = 8.0, 64.0
REPO = os.path.dirname(os.path.abspath(__file__))
# Wan at the reference client's defaults (generate_wan_t2v.py)
WAN_W, WAN_H, WAN_FRAMES, WAN_STEPS, WAN_CFG = 512, 320, 16, 25, 6.0
# limits of the Wan checks, set from bf16 rounding before any card run:
# one DiT evaluation through the kernel vs the plain attention path (the
# UNet check's limit; P rounds to bf16 in the kernel, ~1e-3 relative per
# attention, carried through 30 bf16 layers); the mean |difference| in uint8
# levels of the full and the streaming decode of one latent (the same
# convolutions on chunks: cuDNN may pick other algorithms, bf16 roundings of
# ~0.4% through ~40 conv layers renormalised by RMS norms); and of the
# pair's row 0 against the solo video of the same (prompt, seed) (a batch of
# 4 DiT rows vs 2: other GEMM tilings, their bf16 differences carried
# through 50 evaluations at cfg 6.0, then the streaming vs the full decode)
WAN_DIT_REL_L2 = 5e-2
WAN_STREAM_MEAN_LEVELS = 1.0
WAN_PAIR_MEAN_LEVELS = 4.0


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls captured in one CUDA
    graph and replayed: the host enqueues nothing in the timed window, so a
    short kernel is not timed at the host's launch rate, as ``cuda_ms`` may
    time it.  Launch counters move during the capture, never at replay."""
    import torch

    side = torch.cuda.Stream()  # warm up outside the capture, on a side stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay also uploads the graph
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def _valid_keys(sq, causal, q_offset, kv_len):
    """Valid keys of each q row."""
    return [max(min(kv_len, q_offset + i + 1) if causal else kv_len, 0) for i in range(sq)]


def attention_bound(b, sq, sk, h, hkv, d, causal, q_offset, kv_len):
    """(ms, "operations" | "bytes"): the least time for the work these
    inputs need: 4*D flops per valid (row, key) pair per head, and each
    needed input byte read once and the output written once (bf16)."""
    rows = _valid_keys(sq, causal, q_offset, kv_len)
    pairs = sum(rows)
    keys = max(rows) if rows else 0
    flops = 4.0 * b * h * pairs * d
    nbytes = 2.0 * (2 * b * sq * h * d + 2 * b * keys * hkv * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def exp_bound(b, sq, h, causal, q_offset, kv_len, sm_mhz):
    """ms for one exponential per valid (row, key) pair per head at 16 exp2
    per clock per SM over 132 SMs at ``sm_mhz``."""
    exps = b * h * sum(_valid_keys(sq, causal, q_offset, kv_len))
    return exps / (EXP2_PER_CLOCK_PER_SM * H100_SMS * sm_mhz * 1e6) * 1e3


def png_to_array(png: bytes):
    """Decode the server's PNGs (8-bit RGB, filter 0 on every row)."""
    import numpy as np

    assert png[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        data = png[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any(), "unexpected PNG row filter"
    return raw[:, 1:].reshape(h, w, 3)


def post(url: str, body: dict, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, dict(r.headers), r.read()


def get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def http(url: str, body=None, headers=None, timeout: float = 900):
    """(status, headers, body bytes) of a GET (``body`` None) or a JSON POST,
    error statuses included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST",
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def metric_sum(text: str, name: str, **labels) -> float:
    """Sum of the samples of family ``name`` in a Prometheus exposition whose
    labels include ``labels``."""
    total = 0.0
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if not m or m.group(1) != name:
            continue
        have = dict(_LABEL.findall(m.group(2) or ""))
        if all(have.get(k) == v for k, v in labels.items()):
            total += float(m.group(3))
    return total


def scrape(url: str) -> str:
    status, _, body = http(url + "/metrics")
    assert status == 200, status
    return body.decode()


def check_ready(url: str, label: str) -> None:
    status, _, body = http(url + "/readyz")
    log(f"{label}: GET /readyz {status} {body.decode()}")
    assert status == 200, (status, body)


FLASH_CASES = [  # (label, q shape, kv shape, kwargs, the main path it is on)
    ("sd15 level0 b1", (2, 4096, 8, 40), (2, 4096, 8, 40), {}, "sd15"),
    ("sd15 level0 b8", (16, 4096, 8, 40), (16, 4096, 8, 40), {}, "sd15"),
    ("sd15 level1 b1", (2, 1024, 8, 80), (2, 1024, 8, 80), {}, "sd15"),
    ("sd15 level1 b8", (16, 1024, 8, 80), (16, 1024, 8, 80), {}, "sd15"),
    ("causal gqa offset", (1, 512, 8, 64), (1, 2048, 2, 64),
     dict(causal=True, q_offset=1024, kv_len=1536), None),
    ("ragged", (1, 77, 8, 40), (1, 300, 8, 40), {}, None),
    ("wan self b1", (2, 2560, 12, 128), (2, 2560, 12, 128), {}, "wan"),
    ("wan cross b1", (2, 2560, 12, 128), (2, 512, 12, 128), {}, "wan"),
    ("wan self pair", (4, 2560, 12, 128), (4, 2560, 12, 128), {}, "wan"),
    ("wan cross pair", (4, 2560, 12, 128), (4, 512, 12, 128), {}, "wan"),
]


def llm_flash_cases(prefix: int):
    """The LLM path's flash shapes at Qwen2.5-7B width: the from-zero
    prefill of the 1361-token prompt's 2048 bucket, and the streaming
    prefill of a 1024-row suffix bucket after a ``prefix``-token hit over
    the 4096-token row cache."""
    return [
        ("llm prefill 2048", (1, 2048, 28, 128), (1, 2048, 4, 128), dict(causal=True), "llm"),
        ("llm suffix 1024", (1, 1024, 28, 128), (1, 4096, 4, 128),
         dict(causal=True, q_offset=prefix, kv_len=prefix + 1024), "llm"),
    ]


# the new main-path shapes of the streaming route (row 2): the second chunk
# of a 1024-token chunked prefill and the final warm start after two chunks
# (phase 4e a), and the solo engine's second 8192-token chunk over the
# 16384-token cache (phase 4e d)
LLM_STREAM_CASES = [
    ("llm chunk @1024", (1, 1024, 28, 128), (1, 4096, 4, 128),
     dict(causal=True, q_offset=1024, kv_len=2048), "llm_chunked"),
    ("llm chunk @2048", (1, 1024, 28, 128), (1, 4096, 4, 128),
     dict(causal=True, q_offset=2048, kv_len=3072), "llm_chunked"),
    ("llm solo chunk 8192 @8192", (1, 8192, 28, 128), (1, 16384, 4, 128),
     dict(causal=True, q_offset=8192, kv_len=16384), "llm_solo"),
]
# the twin's float32 scores: up to 2^31 elements in one call (the SD1.5,
# Wan and 4096-context LLM shapes), above that blocks of q rows of at most
# 2^30 (each row's function is unchanged)
TWIN_WHOLE_MAX, TWIN_BLOCK_MAX = 1 << 31, 1 << 30


def twin_attention(q, k, v, kw):
    """``flash_attention_ref`` on the same inputs, in blocks of q rows when
    the scores would be large (a row's result does not depend on the
    others)."""
    import torch

    from tpustack_torch.ops.flash_attention import flash_attention_ref

    b, sq, h, _ = q.shape
    if b * h * sq * k.shape[1] <= TWIN_WHOLE_MAX:
        return flash_attention_ref(q, k, v, **kw)
    rows = max(1, TWIN_BLOCK_MAX // (b * h * k.shape[1]))
    off = kw.get("q_offset") or 0
    return torch.cat([flash_attention_ref(q[:, i:i + rows], k, v,
                                          **dict(kw, q_offset=off + i))
                      for i in range(0, sq, rows)], dim=1)


def library_attention(torch, q, k, v, kw):
    """(fn, name): one SDPA call computing the same function, the yardstick
    (timed here, never used by the port).  Causal over the first kv_len keys
    with q rows ending at kv_len is SDPA's lower-right causal variant."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    _, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    causal, off, klen = kw.get("causal", False), kw.get("q_offset", 0), kw.get("kv_len", sk)
    gqa = hkv != h
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not causal and klen == sk:
        return (lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=gqa)), "sdpa"
    if causal and off + sq == klen:
        kt, vt = kt[:, :, :klen].contiguous(), vt[:, :, :klen].contiguous()
        if sq == klen:
            return (lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                           enable_gqa=gqa)), "sdpa is_causal"
        bias = causal_lower_right(sq, klen)
        return (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias,
                                                       enable_gqa=gqa)), "sdpa lower-right"
    rows = torch.arange(sq, device=q.device)[:, None] + off
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = (cols < klen) & ((cols <= rows) if causal else True)
    return (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=gqa)), "sdpa bool mask"


def phase_kernels(torch, cases, sm_mhz: float):
    """Phase 3: the flash kernel vs its twin on the card; returns per-shape
    records."""
    from tpustack_torch.ops.flash_attention import flash_attention

    g = torch.Generator("cuda").manual_seed(0)
    records = []
    for label, qs, ks, kw, path in cases:
        q, k, v = (torch.randn(s, generator=g, device="cuda").bfloat16() for s in (qs, ks, ks))
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = twin_attention(q, k, v, kw)
        diff = out.float() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
        ok = torch.allclose(out.float(), ref.float(), atol=ATOL, rtol=RTOL) and rel < REL_L2
        b, sq, h, d = qs
        sk, hkv = ks[1], ks[2]
        causal, off, klen = kw.get("causal", False), kw.get("q_offset", 0), kw.get("kv_len", sk)
        bound_ms, bound_by = attention_bound(b, sq, sk, h, hkv, d, causal, off, klen)
        rec = dict(label=label, shape_q=list(qs), shape_kv=list(ks), kw=kw, path=path,
                   max_abs_err=err, rel_l2=rel, ok=bool(ok), bound_ms=bound_ms,
                   bound_by=bound_by,
                   exp_bound_ms=exp_bound(b, sq, h, causal, off, klen, sm_mhz))
        iters = 20 if b * sq * sk > 1e8 else 50
        rec["ms"] = device_ms(lambda: flash_attention(q, k, v, **kw), iters)
        rec["call_ms"] = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters)
        rec["plain_ms"] = cuda_ms(lambda: twin_attention(q, k, v, kw), 3)
        lib, rec["library_call"] = library_attention(torch, q, k, v, kw)
        rec["library_ms"] = device_ms(lib, iters)
        del ref, out, lib
        torch.cuda.empty_cache()
        log(f"kernel flash_attention {label}: q {list(qs)} kv {list(ks)} {kw or ''} "
            f"max_abs_err={err:.3e} (atol {ATOL}, rtol {RTOL}) rel_l2={rel:.3e} "
            f"(limit {REL_L2}) {'OK' if ok else 'MISMATCH'} "
            f"kernel_ms={rec['ms']:.4f} call_ms={rec['call_ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} ({rec['library_call']}) "
            f"kernel/library={rec['ms'] / rec['library_ms']:.3f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) exp_bound_ms={rec['exp_bound_ms']:.4f} "
            f"(at {sm_mhz:.0f} MHz)")
        if not ok:
            raise SystemExit(f"flash_attention disagrees with its twin at {label}")
        records.append(rec)
    return records


def phase_main_path(torch):
    """Phase 4: the SD1.5 server at full width; returns the launch count and
    the measured rates."""
    from tpustack_torch.models.sd15 import SD15Config, SD15Pipeline
    from tpustack_torch.models.sd15.unet import set_attn_impl
    from tpustack_torch.ops.flash_attention import flash_attention
    from tpustack_torch.serving.sd_server import SDServer

    t0 = time.perf_counter()
    pipe = SD15Pipeline(SD15Config.sd15(), device=DEVICE, seed=0)
    log(f"pipeline: SD1.5 full width, {pipe.dtype}, on {pipe.device}, "
        f"built in {time.perf_counter() - t0:.1f}s")
    pipe.generate("warm-up", steps=2, width=SIZE, height=SIZE, seed=0)  # lazy CUDA init
    server = SDServer(pipe, batch_window_ms=0, max_batch=BATCH)
    port = server.start(host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{port}"
    try:
        check_ready(url, "main path")
        metrics0 = scrape(url)
        flash_attention.launches = 0
        # one request, alone
        status, headers, png1 = post(url + "/generate", {
            "prompt": "a lighthouse on a cliff at dusk, oil painting",
            "steps": STEPS, "width": SIZE, "height": SIZE, "seed": 1},
            {"X-Tenant-Id": "sd-a"})
        # eight concurrent requests with one signature: one micro-batch, its
        # riders split between two tenants (header and body)
        server.batch_window_s = 10.0
        results = [None] * BATCH

        def send(i):
            body = {"prompt": f"a red fox in the snow, study {i}", "steps": STEPS,
                    "width": SIZE, "height": SIZE, "seed": 100 + i}
            if i % 2:
                results[i] = post(url + "/generate", dict(body, tenant="sd-b"))
            else:
                results[i] = post(url + "/generate", body, {"X-Tenant-Id": "sd-a"})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        launches = flash_attention.launches
        last_status, last_png = get(url + "/last")
        health_status, health = get(url + "/healthz")
        sizes = [n for n, _ in server.batch_log]
        # 1024x1024: the UNet's level-2 self-attention is [2, 1024, 8, 160],
        # above the kernel's head dim; auto_impl keeps it on the plain path
        server.batch_window_s = 0.0
        flash_attention.launches = 0
        status_1k, headers_1k, png_1k = post(url + "/generate", {
            "prompt": "a harbour at dawn, wide angle", "steps": STEPS, "width": SIZE_LARGE,
            "height": SIZE_LARGE, "seed": 7})
        launches_1k = flash_attention.launches
        s_1k = server.batch_log[-1][1]
        metrics1 = scrape(url)
        tenants = _tenants(url)
        batches = [r for r in json.loads(http(url + "/debug/flight")[2])["records"]
                   if r["kind"] == "batch"]
    finally:
        server.stop()

    assert status == 200, status
    assert all(r is not None and r[0] == 200 for r in results), "a batched request failed"
    pngs = [png1] + [r[2] for r in results]
    gen_times = [headers["X-Gen-Time"]] + [r[1]["X-Gen-Time"] for r in results]
    assert all(t.endswith("s") and float(t[:-1]) > 0 for t in gen_times), gen_times
    imgs = [png_to_array(p) for p in pngs]
    assert all(im.shape == (SIZE, SIZE, 3) for im in imgs), [im.shape for im in imgs]
    assert all(float(im.std()) > 1.0 for im in imgs), "a constant image"
    assert len({p for p in pngs}) == len(pngs), "images repeat across seeds"
    assert last_status == 200 and last_png[:8] == b"\x89PNG\r\n\x1a\n"
    assert health_status == 200 and json.loads(health)["ok"] is True
    assert sizes == [1, BATCH], f"dispatches {sizes}: the 8 requests did not share one batch"
    per_eval = 10  # attn1 at UNet levels 0 and 1: 4 down + 6 up
    expected = per_eval * STEPS * len(sizes)
    log(f"main path: {len(sizes)} dispatches {sizes}, flash_attention launches "
        f"{launches} (expected {per_eval} x {STEPS} steps x {len(sizes)} = {expected})")
    assert launches == expected, (launches, expected)
    s1, s8 = server.batch_log[0][1], server.batch_log[1][1]
    log(f"main path: batch 1 {s1:.3f} s/image; batch {BATCH} {s8:.3f} s -> "
        f"{BATCH / s8:.3f} images/s; X-Gen-Time {gen_times}")
    img_1k = png_to_array(png_1k)
    want_1k = per_eval * STEPS  # levels 0 and 1 again; level 2 (D=160) plain
    log(f"main path: {SIZE_LARGE}x{SIZE_LARGE} request {status_1k}, {s_1k:.3f} s/image (X-Gen-Time "
        f"{headers_1k.get('X-Gen-Time')}), pixel std {img_1k.std():.1f}; flash_attention "
        f"launches {launches_1k} (expected {per_eval} x {STEPS} = {want_1k})")
    assert status_1k == 200 and img_1k.shape == (SIZE_LARGE, SIZE_LARGE, 3)
    assert img_1k.std() > 1.0, "a constant image"
    assert launches_1k == want_1k, (launches_1k, want_1k)
    # /metrics: the phase's requests moved the server's counters
    sent = 1 + BATCH + 1
    moved = {name: metric_sum(metrics1, name, **kw) - metric_sum(metrics0, name, **kw)
             for name, kw in (("tpustack_http_requests_total",
                               dict(server="sd", endpoint="/generate", status="200")),
                              ("tpustack_sd_images_total", {}))}
    log(f"main path: /metrics moved {moved} over {sent} requests")
    assert all(v == sent for v in moved.values()), moved
    sd_acct = {t: tenants["tenants"][t]["servers"]["sd"] for t in ("sd-a", "sd-b")}
    log(f"main path: /debug/tenants {sd_acct}; batch records' tenants "
        f"{[r.get('tenants') for r in batches]}")
    assert sd_acct["sd-a"]["outcomes"] == {"ok": 1 + BATCH // 2}, sd_acct
    assert sd_acct["sd-b"]["outcomes"] == {"ok": BATCH // 2}, sd_acct
    assert batches[1]["tenants"] == {"sd-a": BATCH // 2, "sd-b": BATCH // 2}, batches
    billed = sum(r["denoise_vae_s"] for r in batches[:2])
    assert abs(sum(a["chip_seconds"] for a in sd_acct.values()) - billed) < 1e-6, sd_acct

    # the kernel inside the full-width UNet vs the plain attention path
    g = torch.Generator(DEVICE).manual_seed(1)
    lat = SIZE // 8
    x = torch.randn(2, lat, lat, 4, generator=g, device=DEVICE)
    t = torch.full((2,), 981, device=DEVICE)
    with torch.inference_mode():
        ctx = pipe.text_encoder(torch.as_tensor(pipe.tokenizer(["", "a red fox"])).to(DEVICE))
        eps_kernel = pipe.unet(x.to(pipe.dtype), t, ctx)
        set_attn_impl(pipe.unet, "xla")
        eps_plain = pipe.unet(x.to(pipe.dtype), t, ctx)
        set_attn_impl(pipe.unet, "auto")
    rel = ((eps_kernel - eps_plain).norm() / eps_plain.norm()).item()
    finite = bool(torch.isfinite(eps_kernel).all())
    log(f"main path: full-width UNet eval, kernel vs plain attention: relative L2 "
        f"{rel:.3e} (limit 5e-2), finite={finite}, |eps| mean {eps_plain.abs().mean().item():.3f}")
    assert finite and rel < 5e-2, rel
    for b in (1, BATCH):
        profile_unet(torch, pipe, b)
    return dict(launches=launches + launches_1k, launches_1k=launches_1k, s_per_image_b1=s1,
                images_per_s_b8=BATCH / s8, s_per_image_1024=s_1k, dispatches=sizes,
                unet_rel_l2=rel)


def profile_unet(torch, pipe, batch: int, evals: int = 3) -> None:
    """Where one CFG UNet evaluation's time goes: wall time per eval (host
    clock, synchronised, profiler off), summed device kernel time per eval
    (torch.profiler, device events only), their ratio as the device's idle
    share, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lat = SIZE // 8
    x = torch.randn(2 * batch, lat, lat, 4, device=DEVICE).to(pipe.dtype)
    t = torch.full((2 * batch,), 981, device=DEVICE)
    with torch.inference_mode():
        ctx = pipe.text_encoder(torch.as_tensor(pipe.tokenizer(["a"] * 2 * batch)).to(DEVICE))
        pipe.unet(x, t, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(evals):
            pipe.unet(x, t, ctx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / evals * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(evals):
                pipe.unet(x, t, ctx)
            torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / evals / 1e3, e.count // evals)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if not kernels:
        log(f"profile batch {batch}: device time not measured (the profiler saw no kernels)")
        return
    flash_ms = sum(ms for k, ms, _ in kernels if "flash_attention_kernel" in k)
    log(f"profile batch {batch} (UNet batch {2 * batch}): wall {wall_ms:.2f} ms/eval, device "
        f"kernels {busy_ms:.2f} ms/eval, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{sum(n for _, _, n in kernels)} kernel launches/eval, flash_attention "
        f"{flash_ms:.2f} ms ({flash_ms / busy_ms:.3f} of device time)")
    for k, ms, n in sorted(kernels, key=lambda r: -r[1])[:8]:
        log(f"    {ms:8.3f} ms  x{n:4d}  {k[:100]}")


def paged_bound(b, s, h, hkv, d, lens, blk, nb, int8):
    """(ms, "operations" | "bytes") for one paged call: the valid blocks'
    K+V (+ scales) read once, q, the tables and the outputs once; 4*D flops
    per (query row, valid key) per head."""
    esize, sbytes = (1, 8) if int8 else (2, 0)
    blocks = sum(-(-int(n) // blk) for n in lens)
    nbytes = (blocks * blk * hkv * (2 * d * esize + sbytes) + b * s * h * d * 2
              + b * nb * 4 + b * 4 + b * s * h * (d + 2) * 4)
    flops = 4.0 * d * s * h * sum(int(n) for n in lens)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def paged_inputs(torch, b, s, h, hkv, d, n_pool, blk, ctx, int8, seed=0, lens=None):
    """A scrambled pool with block 0 poisoned (1e4, or 127 in int8), ragged
    lengths up to ``ctx`` (row 0 full, row 1 empty, row 2 mid-block; or
    ``lens``), idle table entries at block 0.  Made on the host from a seed,
    then moved."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (n_pool, blk, hkv, d)
    if int8:
        pk = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        pv = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
        pk[0] = pv[0] = 127
        ks = torch.rand(shape[:3], generator=g) * 0.02 + 1e-3
        vs = torch.rand(shape[:3], generator=g) * 0.02 + 1e-3
    else:
        pk = torch.randn(shape, generator=g).bfloat16()
        pv = torch.randn(shape, generator=g).bfloat16()
        pk[0] = pv[0] = 1e4
        ks = vs = None
    nb = ctx // blk
    lens_given = lens
    lens = torch.randint(1, ctx + 1, (b,), generator=g, dtype=torch.int32)
    lens[0] = ctx
    if b > 1:
        lens[1] = 0
    if b > 2:
        lens[2] = blk + 3
    if lens_given is not None:
        lens = torch.tensor(lens_given, dtype=torch.int32)
    assert sum(-(-int(n) // blk) for n in lens) <= n_pool - 1
    perm = torch.randperm(n_pool - 1, generator=g) + 1
    bt = torch.zeros((b, nb), dtype=torch.int32)
    pos = 0
    for i in range(b):
        n = -(-int(lens[i]) // blk)
        bt[i, :n] = perm[pos:pos + n].int()
        pos += n
    q = torch.randn((b, s, h, d), generator=g).bfloat16()
    to = lambda t: None if t is None else t.to(DEVICE)  # noqa: E731
    return to(q), to(pk), to(pv), to(bt), to(lens), to(ks), to(vs)


PAGED_CASES = [  # (label, B, S, H, Hkv, D, pool blocks, blk, ctx, int8, on the LLM path,
    #                 lengths or None for the ragged default)
    ("decode", 8, 1, 28, 4, 128, 513, 64, 4096, False, True, None),
    ("verify", 8, 5, 28, 4, 128, 513, 64, 4096, False, True, None),
    ("int8 verify", 8, 5, 28, 4, 128, 513, 64, 4096, True, False, None),
    ("mqa", 4, 1, 8, 1, 128, 129, 64, 2048, False, False, None),
    ("gqa 8/2", 4, 5, 8, 2, 128, 129, 64, 2048, False, False, None),
    ("mha", 4, 2, 8, 8, 128, 129, 64, 2048, False, False, None),
    ("blk16 verify", 8, 5, 28, 4, 128, 2049, 16, 4096, False, False, None),
    # the edges of the kernel's work split over one CTA per SM
    ("all empty", 8, 1, 28, 4, 128, 513, 64, 4096, False, False, [0] * 8),
    ("one full, seven empty", 8, 1, 28, 4, 128, 513, 64, 4096, False, False,
     [4096] + [0] * 7),
    ("tile multiples verify", 8, 5, 28, 4, 128, 513, 64, 4096, False, False,
     [64, 128, 640, 1024, 4096, 192, 256, 0]),
    ("b1 hkv1", 1, 1, 8, 1, 128, 65, 64, 4096, False, False, [4095]),
    ("blk32 verify", 8, 5, 28, 4, 128, 1025, 32, 4096, False, False, None),
    ("decode 8 x 2048", 8, 1, 28, 4, 128, 513, 64, 4096, False, True, [2048] * 8),
]


def paged_check(torch, got, ref):
    """(ok, numbers): the paged kernel's partial against its twin's at the
    limits above; rows without keys must be exact."""
    (acc, m, l), (racc, rm, rl) = got, ref
    rows = rl > 0
    empty_ok = bool(torch.equal(l == 0, rl == 0) and (m[~rows] <= -1e29).all()
                    and (acc[~rows] == 0).all())
    m_err = (m[rows] - rm[rows]).abs().max().item() if rows.any() else 0.0
    l_rel = ((l - rl).abs() / rl.abs().clamp_min(1e-6)).max().item()
    acc_rel = ((acc - racc).norm() / racc.norm().clamp_min(1e-30)).item()
    out, rout = acc / l.clamp_min(1e-30)[..., None], racc / rl.clamp_min(1e-30)[..., None]
    diff = out - rout
    err = diff.abs().max().item()
    rel = (diff.norm() / rout.norm().clamp_min(1e-30)).item()
    ok = (empty_ok and m_err <= PAGED_M_ATOL and l_rel <= PAGED_L_RTOL and acc_rel < REL_L2
          and torch.allclose(out, rout, atol=ATOL, rtol=RTOL) and rel < REL_L2)
    return bool(ok), dict(max_abs_err=err, rel_l2=rel, m_err=m_err, l_rel=l_rel,
                          acc_rel_l2=acc_rel, empty_ok=empty_ok)


def phase_paged_kernels(torch):
    """Phase 3, paged attention: kernel vs twin on the card."""
    from tpustack_torch.ops.paged_attention import (gather_pool, paged_attention_partial,
                                                    paged_attention_partial_ref)

    records = []
    for label, b, s, h, hkv, d, n_pool, blk, ctx, int8, on_path, given in PAGED_CASES:
        q, pk, pv, bt, lens, ks, vs = paged_inputs(torch, b, s, h, hkv, d, n_pool, blk, ctx,
                                                   int8, lens=given)
        kw = dict(k_scale=ks, v_scale=vs)
        got = paged_attention_partial(q, pk, pv, bt, lens, **kw)
        torch.cuda.synchronize()
        ok, chk = paged_check(torch, got, paged_attention_partial_ref(q, pk, pv, bt, lens, **kw))
        err, rel, m_err, l_rel, acc_rel = (chk[k] for k in ("max_abs_err", "rel_l2", "m_err",
                                                            "l_rel", "acc_rel_l2"))
        nb = bt.shape[1]
        bound_ms, bound_by = paged_bound(b, s, h, hkv, d, lens.tolist(), blk, nb, int8)
        rec = dict(label=label, shape_q=[b, s, h, d], shape_pool=list(pk.shape),
                   int8=int8, max_abs_err=err, rel_l2=rel, m_err=m_err, l_rel=l_rel,
                   acc_rel_l2=acc_rel, ok=bool(ok), on_llm_path=on_path,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        rec["ms"] = device_ms(lambda: paged_attention_partial(q, pk, pv, bt, lens, **kw), 100)
        rec["call_ms"] = cuda_ms(lambda: paged_attention_partial(q, pk, pv, bt, lens, **kw),
                                 100)
        rec["plain_ms"] = cuda_ms(lambda: paged_attention_partial_ref(q, pk, pv, bt, lens,
                                                                      **kw), 5)
        # the bisection body's copy: one layer's K and V gathered dense
        rec["gather_ms"] = device_ms(lambda: (gather_pool(pk, bt), gather_pool(pv, bt)), 20)
        rec["share_of_bound"] = bound_ms / rec["ms"]
        del got
        torch.cuda.empty_cache()
        log(f"kernel paged_attention {label}: q {rec['shape_q']} pool {rec['shape_pool']} "
            f"{'int8 ' if int8 else ''}max_abs_err={err:.3e} (atol {ATOL}, rtol {RTOL}) "
            f"rel_l2={rel:.3e} (limit {REL_L2}) m_err={m_err:.2e} (limit {PAGED_M_ATOL}) "
            f"l_rel={l_rel:.2e} (limit {PAGED_L_RTOL}) acc_rel_l2={acc_rel:.2e} "
            f"{'OK' if ok else 'MISMATCH'} kernel_ms={rec['ms']:.4f} "
            f"call_ms={rec['call_ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} gather_ms={rec['gather_ms']:.4f} "
            f"library_ms=none bound_ms={bound_ms:.4f} ({bound_by}) "
            f"share_of_bound={rec['share_of_bound']:.3f}")
        if not ok:
            raise SystemExit(f"paged_attention disagrees with its twin at {label}")
        records.append(rec)
    return records


def post_json(url: str, body: dict, timeout: float = 900):
    """(status, headers, decoded JSON) for a POST, error statuses included."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


def _text_of(tok, words, n_tokens: int) -> str:
    """The shortest text cycling ``words`` with at least ``n_tokens`` tokens
    (with BOS).  The count only grows with each word, so the word count is
    found by doubling then bisection: O(log n) encodes of a long prompt, not
    one per word."""
    def text(k):
        return " ".join(words[i % len(words)] for i in range(k))

    def enough(k):
        return len(tok.encode(text(k))) >= n_tokens

    if enough(0):
        return ""
    lo, hi = 0, 1
    while not enough(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if enough(mid) else (mid, hi)
    return text(hi)


BODY_FIELDS = {"content", "model", "stop", "stopped_eos", "stopped_limit", "tokens_evaluated",
               "tokens_predicted", "timings"}


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def wait_engine_idle(server, timeout: float = 120.0) -> None:
    """Wait until the LLM server's engine run has ended and logged its stats:
    a response reaches its client before the run that served it returns."""
    t_end = time.time() + timeout
    while server._engine is not None or server._queue:
        if time.time() > t_end:
            raise SystemExit("llm: the engine did not go idle")
        time.sleep(0.01)


def llm_bodies(tok, sizes, on_card: bool):
    """Phase 4b's prompts: ``(system prompt, long body, the 8 batch bodies)``
    (a repetitive body, a >=``sizes[1]``-token prompt outside the cache, a
    prefix hit with a ``sizes[2]``-token suffix, five questions)."""
    words = ("the cluster schedules every job on the accelerator pool and records its "
             "throughput latency and memory use in the shared ledger").split()
    system = "System: " + _text_of(tok, words, sizes[0])
    rep = " ".join(["alpha beta gamma delta"] * (24 if on_card else 1))
    long_body = _text_of(tok, ("a long report on device memory bandwidth kernels "
                               "and queues").split(), sizes[1])
    suffix = _text_of(tok, "each request shares the cached system prompt".split(), sizes[2])
    bodies = [
        {"prompt": system + " Repeat: " + rep},                         # drafts accepted
        {"prompt": system + " Report: " + long_body, "cache_prompt": False},  # panel flash
        {"prompt": system + " Context: " + suffix},                     # streaming flash
    ] + [{"prompt": system + f" Question {i}: what ran on node {i} today?"}
         for i in range(LLM_SLOTS - 3)]
    return system, long_body, bodies


def phase_llm(torch, preset: str = "qwen25_7b", sizes=(256, 1100, 600), n_new: int = LLM_NEW):
    """Phase 4b: the LLM server at Qwen2.5-7B width; returns the launch
    counts and the measured rates.  ``sizes``: the system prompt's, the
    long prompt's and the long suffix's token counts (a CPU rehearsal
    passes the tiny preset and small sizes)."""
    from tpustack_torch.ops.flash_attention import flash_attention, reset_launches
    from tpustack_torch.ops.paged_attention import paged_attention_partial
    from tpustack_torch.serving.llm_server import LLMServer

    os.environ.update({"LLM_PRESET": preset, "LLM_CTX": str(LLM_CTX),
                       "LLM_MAX_BATCH": str(LLM_SLOTS), "TPUSTACK_SPEC_TOKENS": "4",
                       "TPUSTACK_PREFIX_CACHE": "1", "TPUSTACK_KV_BLOCK": "64"})
    on_card = DEVICE == "cuda"
    t0 = time.perf_counter()
    server = LLMServer()
    sync(torch)
    gen, tok, cfg = server.gen, server.tok, server.gen.cfg
    log(f"llm: Qwen2.5-7B width ({cfg.n_layers} layers, dim {cfg.dim}, vocab "
        f"{cfg.vocab_size}), {gen.cache_dtype}, ctx {cfg.max_seq}, {server.max_batch} slots, "
        f"pool {tuple(server.paged.arrays[0]['k'].shape)}, built in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9 if on_card else 0:.2f} GB allocated; "
        f"tokenizer {type(tok).__name__}")
    url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
    system, long_body, bodies = llm_bodies(tok, sizes, on_card)
    try:
        check_ready(url, "llm")
        # warm-up outside the counts (CUDA and cuBLAS initialisation)
        status, _, _ = post_json(url + "/completion", {"prompt": "warm up", "n_predict": 4,
                                                       "temperature": 0,
                                                       "cache_prompt": False})
        assert status == 200, status
        wait_engine_idle(server)
        sync(torch)
        metrics0 = scrape(url)
        runs0 = len(server.run_log)
        spec0 = (server._spec_drafted, server._spec_accepted)
        paged_attention_partial.launches = 0
        reset_launches()
        # one solo request carrying the system prompt (the cache keeps it)
        t1 = time.perf_counter()
        solo = post_json(url + "/completion", {"prompt": system + " Question: what is the "
                                               "plan?", "n_predict": n_new,
                                               "temperature": 0})
        solo_wall = time.perf_counter() - t1
        results = [None] * LLM_SLOTS

        def send(i):
            results[i] = post_json(url + "/completion",
                                   dict(bodies[i], n_predict=n_new, temperature=0))

        t2 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(LLM_SLOTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        batch_wall = time.perf_counter() - t2
        wait_engine_idle(server)
        sync(torch)
        paged_launches = paged_attention_partial.launches
        flash_launches = flash_attention.launches
        flash_routes = dict(flash_attention.route_launches)
        runs = list(server.run_log)[runs0:]
        props = json.loads(urllib.request.urlopen(url + "/props", timeout=60).read())
        # the serving surface: streams, the drain drill, a deadline, a trace
        surface = llm_serving_surface(torch, server, url, system, long_body, n_new)
        metrics1 = scrape(url)
    finally:
        server.stop()

    statuses = [solo[0]] + [r[0] for r in results]
    log(f"llm: statuses {statuses}")
    assert all(st == 200 for st in statuses), (statuses, [r[2] for r in results])
    for _, _, out in [solo] + results:
        assert BODY_FIELDS <= set(out), sorted(out)
        assert out["tokens_predicted"] >= 1 and isinstance(out["content"], str)
    prompt_tokens = [r[2]["tokens_evaluated"] for r in results]
    log(f"llm: prompt tokens solo {solo[2]['tokens_evaluated']}, batch {prompt_tokens}; "
        f"generated {[r[2]['tokens_predicted'] for r in results]}")
    assert prompt_tokens[1] >= sizes[1], prompt_tokens
    steps = sum(r["kernel_forward_steps"] for r in runs)
    verify_steps = sum(r.get("spec_dispatches", 0) for r in runs)  # one forward step each
    assert all(r["decode_kernel"] == "paged_flash" and r["kernel_gather_dispatches"] == 0
               for r in runs), runs
    spec = props["speculative"]
    accepted = spec["accepted_tokens"] - spec0[1]
    drafted = spec["drafted_tokens"] - spec0[0]
    hits = props["prefix_cache"]["hits"]
    log(f"llm: /props decode_kernel {props['decode_kernel']}, speculative drafted "
        f"{drafted} accepted {accepted}, prefix cache {props['prefix_cache']}")
    # CPU tensors take the twins, which launch nothing
    want_paged = cfg.n_layers * steps if on_card else 0
    want_flash = 2 * cfg.n_layers if on_card else 0
    log(f"llm: {len(runs)} engine run(s), {steps} kernel forward steps; paged_attention "
        f"launches {paged_launches} (expected {cfg.n_layers} x {steps} = {want_paged}: "
        f"{cfg.n_layers} x {steps - verify_steps} decode, {cfg.n_layers} x {verify_steps} "
        f"verify); "
        f"flash_attention launches {flash_launches} (expected {want_flash}: the "
        f">=1024-token prompt's panel prefill and the long suffix's streaming prefill, "
        f"one per layer)")
    assert props["decode_kernel"] == "paged_flash", props["decode_kernel"]
    assert accepted > 0 or not on_card, spec
    assert hits > 0, props["prefix_cache"]
    assert paged_launches == want_paged and steps > 0, (paged_launches, steps)
    assert flash_launches == want_flash, flash_launches
    rt = server.paged
    rt.cache.clear()
    assert rt.pool.n_free == rt.pool.capacity_blocks, rt.pool.stats()
    log(f"llm: after cache.clear() {rt.pool.n_free} of {rt.pool.capacity_blocks} blocks free")
    # /metrics before and after all of phase 4b's traffic
    sent = 1 + LLM_SLOTS + surface["completions_sent"]
    moved = (metric_sum(metrics1, "tpustack_http_requests_total", server="llm",
                        endpoint="/completion")
             - metric_sum(metrics0, "tpustack_http_requests_total", server="llm",
                          endpoint="/completion"))
    free = metric_sum(metrics1, "tpustack_llm_kv_free_blocks")
    used = metric_sum(metrics1, "tpustack_llm_kv_used_blocks")
    fleet = ("tpustack_requests_shed_total", "tpustack_llm_kv_free_blocks",
             "tpustack_llm_kv_used_blocks")
    log(f"llm: /metrics: /completion requests moved by {moved:.0f} (sent {sent}); KV blocks "
        f"free {free:.0f} + used {used:.0f} = {free + used:.0f} (pool "
        f"{rt.pool.capacity_blocks}); shed draining "
        f"{metric_sum(metrics1, 'tpustack_requests_shed_total', server='llm'):.0f}")
    assert moved == sent, (moved, sent)
    assert free + used == rt.pool.capacity_blocks, (free, used)
    assert all(f"# TYPE {f} " in metrics1 for f in fleet), fleet
    st = solo[2]["timings"]
    gen_tokens = sum(r[2]["tokens_predicted"] for r in results)
    e2e = dict(
        solo_ttft_ms=st["prompt_ms"], solo_decode_tokens_per_s=st["predicted_per_second"],
        solo_tokens=solo[2]["tokens_predicted"], solo_wall_s=solo_wall,
        batch_tokens=gen_tokens, batch_wall_s=batch_wall,
        aggregate_tokens_per_s=gen_tokens / batch_wall, spec_drafted=drafted,
        spec_accepted=accepted, prefix_hits=hits, forward_steps=steps,
        verify_forward_steps=verify_steps)
    log(f"llm: solo TTFT {st['prompt_ms']:.1f} ms, decode {st['predicted_per_second']:.2f} "
        f"tokens/s ({solo[2]['tokens_predicted']} tokens, {solo_wall:.2f} s wall); 8 "
        f"concurrent: {gen_tokens} tokens in {batch_wall:.2f} s = "
        f"{gen_tokens / batch_wall:.2f} tokens/s aggregate")
    e2e["teacher_rel_l2"] = teacher_forced_check(torch, gen, rt)
    if on_card:
        e2e.update(profile_decode(torch, gen, rt))
    # every hit shares the system prompt's whole blocks: the streaming
    # suffix prefill's q_offset
    block = props["prefix_cache"]["block_tokens"]
    prefix = props["prefix_cache"]["cached_tokens_served"] // hits // block * block
    log(f"llm: prefix hits of {prefix} tokens ({hits} hits, "
        f"{props['prefix_cache']['cached_tokens_served']} tokens served from the cache)")
    e2e["surface"] = surface["e2e"]
    del server, rt
    steps_all = steps + surface["forward_steps"]
    verify_all = verify_steps + surface["verify_forward_steps"]
    routes = {k: flash_routes[k] + surface["flash_routes"][k] for k in flash_routes}
    log(f"llm: flash_attention launches by route over phase 4b: {routes} (the panel route "
        f"for the from-zero prefills of >=1024-token buckets, the streaming route for the "
        f"long suffix's prefix hit)")
    if on_card:
        assert routes == {"panel": 5 * cfg.n_layers, "stream": cfg.n_layers}, routes
    # the model and tokenizer stay alive for phase 4e, which reuses them
    return dict(paged_launches=paged_launches + surface["paged_launches"],
                flash_launches=flash_launches + surface["flash_launches"], e2e=e2e,
                flash_routes=routes, gen=gen, tok=tok, prefix_hit_tokens=prefix,
                paged_launches_by_step={"decode": cfg.n_layers * (steps_all - verify_all),
                                        "verify": cfg.n_layers * verify_all})


def sse(url: str, body: dict, headers=None):
    """(status, headers, [data payloads], seconds to the first event) of a
    streamed POST; ``[DONE]`` stays a string."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers=dict({"Content-Type": "application/json"},
                                              **(headers or {})))
    t0 = time.perf_counter()
    first, events = None, []
    with urllib.request.urlopen(req, timeout=900) as r:
        for line in r:
            if not line.startswith(b"data: "):
                continue
            if first is None:
                first = time.perf_counter() - t0
            data = line[len(b"data: "):].strip().decode()
            events.append(data if data == "[DONE]" else json.loads(data))
        return r.status, dict(r.headers), events, first


def llm_serving_surface(torch, server, url: str, system: str, long_body: str, n_new: int):
    """Phase 4b, second half: the serving surface at full width, with its own
    exact launch counts.  A greedy streamed ``/completion`` (a >=1024-token
    prompt: the panel flash prefill) and a streamed ``/v1/chat/completions``,
    each equal to the same request sent without streaming, each alone with
    ``cache_prompt: false``, and the stream channel's token ids equal to a
    plain run's; the drain drill (``POST /admin/drain`` while a
    completion decodes, ``/readyz`` 503 draining, new work 503, the in-flight
    completion whole, undrain, a leak-free pool); a 504 that frees its
    blocks; and a ``traceparent`` round trip to ``/debug/traces/{id}``."""
    from tpustack_torch.ops.flash_attention import flash_attention, reset_launches
    from tpustack_torch.ops.paged_attention import paged_attention_partial

    on_card = DEVICE == "cuda"
    cfg, rt = server.gen.cfg, server.paged
    sent = 0

    def completion(body, **kw):
        nonlocal sent
        sent += 1
        return http(url + "/completion", body, **kw)

    def leak_free(label):
        wait_engine_idle(server)
        p = json.loads(http(url + "/props")[2])
        used, entries = p["paged_kv"]["used_blocks"], p["prefix_cache"]["entries"]
        log(f"llm surface: {label}: {used} used blocks, {entries} held by the prefix cache")
        assert used == entries, (label, p["paged_kv"], p["prefix_cache"])

    runs0 = len(server.run_log)
    paged_attention_partial.launches = 0
    reset_launches()
    out = {}

    # 1. streamed vs non-streamed, each alone, greedy, outside the cache
    body = {"prompt": system + " Report: " + long_body, "n_predict": 64, "temperature": 0,
            "cache_prompt": False}
    sent += 1
    st, hd, events, first_s = sse(url + "/completion", dict(body, stream=True))
    wait_engine_idle(server)
    st2, _, plain = completion(body)
    plain = json.loads(plain)
    wait_engine_idle(server)
    final = events[-1]
    text = "".join(e["content"] for e in events[:-1])
    log(f"llm surface: streamed /completion {st}, {len(events) - 1} delta events, first "
        f"event {first_s * 1e3:.1f} ms after the request (timings.prompt_ms "
        f"{final['timings']['prompt_ms']:.1f}; the non-streamed body's "
        f"{plain['timings']['prompt_ms']:.1f}), {final['tokens_predicted']} tokens; equals "
        f"the non-streamed content: {text == plain['content']}")
    assert st == 200 and st2 == 200 and hd["Content-Type"] == "text/event-stream"
    assert final["stop"] is True and BODY_FIELDS <= set(final)
    assert text == plain["content"], (text, plain["content"])
    assert final["tokens_predicted"] == plain["tokens_predicted"]
    # random weights pick mostly ids past the 49408-entry BPE vocab, which
    # decode to no text: hold the stream channel's token ids themselves to a
    # plain run's, through the server's own admission and engine
    eos = server.tok.eos_id

    def ids_of(stream: bool):
        r = server._admit(body["prompt"], 64, 0.0, 40, None, False, True, stream=stream)
        t0 = time.perf_counter()
        server._enqueue(r)
        got, first = [], None
        while stream:
            tok = r.stream.get(timeout=600)
            if tok is None:
                break
            first = first if first is not None else time.perf_counter() - t0
            got.append(tok)
        assert r.done.wait(600) and r.error is None, r.error
        return got, [t for t in r.result[0] if t != eos], first

    streamed_ids, _, first_tok_s = ids_of(True)
    _, plain_ids, _ = ids_of(False)
    wait_engine_idle(server)
    log(f"llm surface: the stream channel's {len(streamed_ids)} token ids equal a plain run's: "
        f"{streamed_ids == plain_ids}; first token on the stream {first_tok_s * 1e3:.1f} ms "
        f"after enqueue; text of the plain body {len(plain['content'])} characters")
    assert streamed_ids == plain_ids and len(plain_ids) >= 1
    out.update(stream_first_event_ms=first_s * 1e3, stream_first_token_ms=first_tok_s * 1e3,
               stream_prompt_ms=final["timings"]["prompt_ms"],
               plain_prompt_ms=plain["timings"]["prompt_ms"],
               stream_tokens_per_s=final["timings"]["predicted_per_second"])

    chat = {"messages": [{"role": "system", "content": "Answer briefly."},
                         {"role": "user", "content": "What ran on node 3 today?"}],
            "max_tokens": 48, "temperature": 0, "cache_prompt": False}
    st, _, events, first_chat = sse(url + "/v1/chat/completions", dict(chat, stream=True))
    wait_engine_idle(server)
    st2, _, plain_chat = http(url + "/v1/chat/completions", chat)
    plain_chat = json.loads(plain_chat)
    wait_engine_idle(server)
    chunks = events[:-1]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    log(f"llm surface: streamed chat {st}, {len(chunks)} chunks then {events[-1]}, first "
        f"event {first_chat * 1e3:.1f} ms; equals the non-streamed content: "
        f"{text == plain_chat['choices'][0]['message']['content']}")
    assert st == 200 and st2 == 200 and events[-1] == "[DONE]"
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert text == plain_chat["choices"][0]["message"]["content"]
    out["chat_first_event_ms"] = first_chat * 1e3

    # 2. the drain drill
    os.environ["TPUSTACK_ADMIN_TOKEN"] = "chip-smoke-admin"
    admin = {"X-Admin-Token": "chip-smoke-admin"}
    assert http(url + "/admin/drain", {}, {"X-Admin-Token": "wrong"})[0] == 403
    inflight = {}
    drill = {"prompt": system + " Question: list every node and its jobs.", "n_predict": 128,
             "temperature": 0, "cache_prompt": False}
    t = threading.Thread(target=lambda: inflight.update(r=completion(drill)))
    t.start()
    t_end = time.time() + 120
    while not (server.resilience.inflight == 1 and server._engine is not None
               and server.metrics["tpustack_llm_running_requests"].value == 1):
        assert time.time() < t_end, "the drill's completion never started decoding"
        time.sleep(0.005)
    st_drain, _, drained = http(url + "/admin/drain", {}, admin)
    st_ready, hd_ready, _ = http(url + "/readyz")
    st_new, hd_new, _ = completion({"prompt": "late arrival", "n_predict": 4})
    t.join(timeout=600)
    st_fly, _, fly = inflight["r"]
    fly = json.loads(fly)
    st_undrain, _, undrained = http(url + "/admin/drain", {"undrain": True}, admin)
    st_ready2 = http(url + "/readyz")[0]
    del os.environ["TPUSTACK_ADMIN_TOKEN"]
    log(f"llm surface: drain drill: /admin/drain {st_drain} {json.loads(drained)}; /readyz "
        f"{st_ready} X-Shed-Reason {hd_ready.get('X-Shed-Reason')}; a new completion "
        f"{st_new} Retry-After {hd_new.get('Retry-After')}; the in-flight completion "
        f"{st_fly} with {fly.get('tokens_predicted')} tokens (eos {fly.get('stopped_eos')}); "
        f"undrain {st_undrain}, /readyz {st_ready2}")
    assert st_drain == 200 and json.loads(drained)["draining"] is True
    assert st_ready == 503 and hd_ready.get("X-Shed-Reason") == "draining"
    assert st_new == 503 and int(hd_new["Retry-After"]) >= 1
    budget = min(128, cfg.max_seq - fly["tokens_evaluated"])
    assert st_fly == 200 and (fly["tokens_predicted"] == budget or fly["stopped_eos"]), fly
    assert st_undrain == 200 and json.loads(undrained)["draining"] is False
    assert st_ready2 == 200
    leak_free("after the drain drill")

    # 3. a deadline far below the decode time: 504, and its blocks freed
    t0 = time.perf_counter()
    st, hd, late = completion({"prompt": system + " Question: summarise the ledger.",
                               "n_predict": 128, "temperature": 0, "cache_prompt": False,
                               "timeout_s": LLM_DEADLINE_S})
    late = json.loads(late)
    log(f"llm surface: timeout_s {LLM_DEADLINE_S} on a 128-token completion: {st} phase "
        f"{late.get('phase')} after {time.perf_counter() - t0:.2f} s")
    assert st == 504 and late["phase"] in ("queued", "decode"), (st, late)
    assert hd.get("X-Shed-Reason") == "deadline"
    leak_free("after the 504")

    # 4. a client's traceparent: X-Trace-Id back, the span tree retrievable
    trace_id, parent = "5ee" + "0" * 26 + "c41", "a1b2c3d4e5f60718"
    st, hd, _ = completion({"prompt": "trace me", "n_predict": 8, "temperature": 0,
                            "cache_prompt": False},
                           headers={"traceparent": f"00-{trace_id}-{parent}-01"})
    wait_engine_idle(server)
    st_t, _, rec = http(f"{url}/debug/traces/{trace_id}")
    rec = json.loads(rec)
    names = [sp["name"] for sp in rec.get("spans", [])]
    log(f"llm surface: traceparent request {st}, X-Trace-Id {hd.get('X-Trace-Id')}; "
        f"/debug/traces/{{id}} {st_t}: spans {names}")
    assert st == 200 and hd.get("X-Trace-Id") == trace_id and st_t == 200
    assert names[0] == "POST /completion" and rec["spans"][0]["parent_id"] == parent
    assert {"queue_wait", "prefill", "wave"} <= set(names)

    wait_engine_idle(server)
    sync(torch)
    paged = paged_attention_partial.launches
    flash = flash_attention.launches
    flash_routes = dict(flash_attention.route_launches)
    runs = list(server.run_log)[runs0:]
    steps = sum(r["kernel_forward_steps"] for r in runs)
    verify = sum(r.get("spec_dispatches", 0) for r in runs)
    want_paged = cfg.n_layers * steps if on_card else 0
    # the long prompt's four from-zero prefills (streamed and not, over HTTP
    # and through the engine) take the panel flash kernel at bucket 2048;
    # every other prompt is under 1024 tokens
    want_flash = 4 * cfg.n_layers if on_card else 0
    log(f"llm surface: {len(runs)} engine runs, {steps} kernel forward steps; paged_attention "
        f"launches {paged} (expected {cfg.n_layers} x {steps} = {want_paged}: "
        f"{cfg.n_layers} x {steps - verify} decode, {cfg.n_layers} x {verify} verify); "
        f"flash_attention launches {flash} (expected {want_flash}); {sent} /completion "
        "requests")
    assert all(r["decode_kernel"] == "paged_flash" for r in runs) or not on_card, runs
    assert paged == want_paged and steps > 0, (paged, want_paged)
    assert flash == want_flash, (flash, want_flash)
    return dict(paged_launches=paged, flash_launches=flash, flash_routes=flash_routes,
                forward_steps=steps, verify_forward_steps=verify, completions_sent=sent, e2e=out)


def _agreement(torch, a, b) -> dict:
    """Cosine (float64) and greedy argmax agreement of two logit tensors."""
    a64, b64 = a.double().flatten(), b.double().flatten()
    return dict(cosine=(a64 @ b64 / (a64.norm() * b64.norm())).item(),
                argmax=(a.argmax(-1) == b.argmax(-1)).float().mean().item(),
                rel_l2=((a64 - b64).norm() / b64.norm()).item())


def _tenants(url: str) -> dict:
    st, _, body = http(url + "/debug/tenants")
    assert st == 200, st
    return json.loads(body)


def phase_llm_int8(torch, bf16: dict, preset: str = "qwen25_7b", n_new: int = LLM_BULK_NEW,
                   sizes=(24, 1100)):
    """Phase 4d: the LLM deployment's configuration (weight-only int8, the
    int8 KV pool, QoS on with a batch tenant under a token bucket) at
    Qwen2.5-7B width; returns the launch counts and the measured numbers.
    ``bf16``: phase 4b's numbers, printed beside this phase's.  ``sizes``:
    the short and the long batch prompts' token counts (a CPU rehearsal
    passes the tiny preset, small sizes and a small ``n_new``)."""
    import dataclasses

    import numpy as np

    from tpustack_torch.models.llm_generate import Generator
    from tpustack_torch.ops.flash_attention import flash_attention
    from tpustack_torch.ops.paged_attention import paged_attention_partial
    from tpustack_torch.serving.llm_server import LLMServer, build_paged

    on_card = DEVICE == "cuda"
    policy = {"tenants": {"bulk": {"priority": "batch", "tokens_per_s": QUOTA_RATE,
                                   "burst_tokens": QUOTA_BURST}}}
    env = {"LLM_PRESET": preset, "LLM_QUANT": "int8", "LLM_KV_QUANT": "int8",
           "LLM_CTX": str(LLM_CTX), "LLM_MAX_BATCH": str(LLM_SLOTS),
           "TPUSTACK_SPEC_TOKENS": "4", "TPUSTACK_QOS": "1",
           "TPUSTACK_QOS_POLICY": json.dumps(policy), "TPUSTACK_PREFIX_CACHE": "1",
           "TPUSTACK_KV_BLOCK": "64", "TPUSTACK_FLIGHT_RECORDS": "8192"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        server = LLMServer()
        sync(torch)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    gen, tok, cfg, rt = server.gen, server.tok, server.gen.cfg, server.paged
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    log(f"llm int8: {cfg.n_layers} layers, dim {cfg.dim}, quant {cfg.quant}, kv {cfg.kv_quant}, "
        f"built (bf16 drawn from seed 0, then quantised) in {time.perf_counter() - t0:.1f} s, "
        f"peak {peak:.2f} GB while quantising; weights {gen.weight_bytes / 1e9:.3f} GB, KV pool "
        f"{rt.pool_bytes / 1e9:.3f} GB ({tuple(rt.arrays[0]['k'].shape)} int8 + scales); "
        f"decode kernel {server.decode_kernel}")

    # accuracy: the int8 model against its bf16 twin from the same seed
    twin = Generator(dataclasses.replace(cfg, quant=None), dtype=gen.cache_dtype, seed=0,
                     device=DEVICE)
    twin_rt = build_paged(twin, LLM_SLOTS, block=rt.block, n_blocks=160, prefix_cache=False)
    ref, _ = teacher_logits(torch, twin, twin_rt)
    got, lengths = teacher_logits(torch, gen, rt)
    acc = _agreement(torch, got[True], ref[True])
    tokens = torch.as_tensor(np.random.RandomState(5).randint(3, cfg.vocab_size, (2, 128)),
                             device=DEVICE)
    with torch.inference_mode():
        full = _agreement(torch, gen.model(tokens), twin.model(tokens))
    twin_bytes = twin.weight_bytes
    del twin, twin_rt, ref, got
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log(f"llm int8: weights {gen.weight_bytes / 1e9:.3f} GB int8 against {twin_bytes / 1e9:.3f} "
        f"GB bf16; teacher-forced 16-step chunk at rows {lengths} against the bf16 twin: "
        f"cosine {acc['cosine']:.6f} (bound {QUANT_COSINE}), argmax agreement "
        f"{acc['argmax']:.4f} (bound {QUANT_ARGMAX}), relative L2 {acc['rel_l2']:.4e}; "
        f"full forward of 2 x 128 tokens (not held to the bounds): cosine "
        f"{full['cosine']:.6f}, argmax agreement {full['argmax']:.4f}")
    assert acc["cosine"] > QUANT_COSINE and acc["argmax"] > QUANT_ARGMAX, acc
    int8_rel = teacher_forced_check(torch, gen, rt)  # phase 4b's check, int8 weights

    # the serving traffic: every row's ids, first-token and finish times
    seen, lock = [], threading.Lock()
    wrapped = server._slot_request

    def spy(r):
        sreq = wrapped(r)
        rec = {"ids": list(r.ids), "tenant": r.tenant, "priority": r.priority, "first": None}
        done, toks = sreq.on_done, sreq.on_tokens

        def on_tokens(t):
            if rec["first"] is None:
                rec["first"] = time.perf_counter()
            if toks is not None:
                toks(t)

        def on_done(tokens, stats):
            rec.update(out=None if tokens is None else list(tokens), stats=dict(stats),
                       done=time.perf_counter())
            with lock:
                seen.append(rec)
            done(tokens, stats)

        sreq.on_tokens, sreq.on_done = on_tokens, on_done
        return sreq

    server._slot_request = spy
    url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
    bulk_h, chat_h = {"X-Tenant-Id": "bulk"}, {"X-Tenant-Id": "chat"}
    words = "the batch job summarises every log line of the night shift".split()
    bodies = [{"prompt": f"Job {i}: " + _text_of(tok, words, sizes[0] - 3)}
              for i in range(LLM_SLOTS - 1)]
    bodies.append({"prompt": "Job 7: " + _text_of(tok, ("a long report on device memory "
                                                        "bandwidth and queues").split(),
                                                  sizes[1])})
    bodies = [dict(b, n_predict=n_new, temperature=0, cache_prompt=False) for b in bodies]
    chat = {"prompt": "What is the status of node 7?", "n_predict": 32, "temperature": 0,
            "cache_prompt": False}
    try:
        check_ready(url, "llm int8")
        st, _, _ = http(url + "/completion", {"prompt": "warm up", "n_predict": 4,
                                              "temperature": 0, "cache_prompt": False}, chat_h)
        assert st == 200, st
        wait_engine_idle(server)
        sync(torch)
        metrics0, tenants0 = scrape(url), _tenants(url)
        runs0 = len(server.run_log)
        with lock:
            seen.clear()
        paged_attention_partial.launches = 0
        flash_attention.launches = 0
        # 1. eight batch completions fill every slot, then one interactive
        results = [None] * LLM_SLOTS

        def send(i):
            results[i] = http(url + "/completion", bodies[i], bulk_h)

        t1 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(LLM_SLOTS)]
        for t in threads:
            t.start()
        t_end = time.time() + 600
        while True:  # every slot holds a batch row that is past its prefill
            eng = server._engine
            slots = list(getattr(eng, "_slots_view", None) or [])
            if len(slots) == LLM_SLOTS and all(s.req is not None and not s.pending
                                               for s in slots):
                break
            assert time.time() < t_end, "the batch rows never filled the slots"
            time.sleep(0.005)
        t_chat = time.perf_counter()
        st_chat, _, chat_out = http(url + "/completion", chat, chat_h)
        chat_wall = time.perf_counter() - t_chat
        for t in threads:
            t.join(timeout=900)
        batch_wall = time.perf_counter() - t1
        wait_engine_idle(server)
        with lock:
            batch_seen = [r for r in seen if r["tenant"] == "bulk"]
            chat_seen = [r for r in seen if r["tenant"] == "chat"]
        # 2. each preempted row again, alone (nothing waits: no preemption)
        reruns = []
        for r in (r for r in batch_seen if r["stats"].get("preempted")):
            body = next(b for b in bodies if tok.encode(b["prompt"]) == r["ids"])
            n0 = len(seen)
            st, _, again_body = http(url + "/completion", body, chat_h)
            assert st == 200, st
            wait_engine_idle(server)
            with lock:
                again = seen[n0]["out"]
            lead = next((j for j, (x, y) in enumerate(zip(r["out"], again)) if x != y),
                        min(len(r["out"]), len(again)))
            again_body = json.loads(again_body)
            reruns.append(dict(prompt_tokens=len(r["ids"]), leading_equal=lead,
                               of=len(again), equal=r["out"] == again,
                               served=again_body["tokens_evaluated"]
                               + again_body["tokens_predicted"]))
        # 3. the batch tenant is in debt now: its own 429; another tenant 200
        st_q, hd_q, body_q = http(url + "/completion", dict(bodies[0], n_predict=8), bulk_h)
        qos_q = _tenants(url)["qos"]
        st_ok, _, ok_out = http(url + "/completion", dict(chat, n_predict=8), chat_h)
        wait_engine_idle(server)
        sync(torch)
        paged_launches = paged_attention_partial.launches
        flash_launches = flash_attention.launches
        runs = list(server.run_log)[runs0:]
        props = json.loads(http(url + "/props")[2])
        tenants1 = _tenants(url)
        flight = json.loads(http(url + "/debug/flight")[2])
        metrics1 = scrape(url)
    finally:
        server.stop()

    # every request whole
    statuses = [r[0] for r in results] + [st_chat]
    outs = [json.loads(r[2]) for r in results]
    chat_out = json.loads(chat_out)
    log(f"llm int8: statuses {statuses}; batch tokens {[o['tokens_predicted'] for o in outs]}, "
        f"interactive {chat_out['tokens_predicted']} in {chat_wall:.2f} s; the batch in "
        f"{batch_wall:.2f} s")
    assert all(st == 200 for st in statuses), statuses
    for o, b in zip(outs + [chat_out], bodies + [chat]):
        assert o["tokens_predicted"] == b["n_predict"] or o["stopped_eos"], o
    # preemption: parked and resumed, the interactive row served first
    preempted = sum(r.get("preempted", 0) for r in runs)
    resumed = sum(r.get("resumed", 0) for r in runs)
    m_pre = (metric_sum(metrics1, "tpustack_qos_preempt_total", priority="batch")
             - metric_sum(metrics0, "tpustack_qos_preempt_total", priority="batch"))
    first_chat = chat_seen[0]["first"]
    first_done = min(r["done"] for r in batch_seen)
    log(f"llm int8: preemptions {preempted} (engine) / {m_pre:.0f} (/metrics "
        f"tpustack_qos_preempt_total), resumes {resumed}; the interactive row's first token "
        f"{(first_chat - t_chat) * 1e3:.1f} ms after its request, "
        f"{(first_done - first_chat):.2f} s before the first batch row finished; "
        f"preempted rows against an uninterrupted run: {reruns}")
    assert preempted >= 1 and resumed == preempted and m_pre == preempted, (preempted, resumed,
                                                                           m_pre)
    assert first_chat < first_done, (first_chat, first_done)
    assert len(reruns) == sum(1 for r in batch_seen if r["stats"].get("preempted"))
    rt.cache.clear()
    assert rt.pool.n_free == rt.pool.capacity_blocks, rt.pool.stats()
    # the quota: the bucket's own ETA as Retry-After
    eta = qos_q["tenants"]["bulk"]["buckets"]["tokens"]["refill_eta_s"]
    log(f"llm int8: quota: bulk {st_q} {hd_q.get('X-Shed-Reason')} Retry-After "
        f"{hd_q.get('Retry-After')} (bucket ETA {eta:.1f} s, level "
        f"{qos_q['tenants']['bulk']['buckets']['tokens']['level']:.0f}); an unconfigured "
        f"tenant {st_ok}; counters {qos_q['counters']}")
    assert st_q == 429 and hd_q.get("X-Shed-Reason") == "quota", (st_q, hd_q)
    assert json.loads(body_q)["reason"] == "quota"
    assert abs(int(hd_q["Retry-After"]) - math.ceil(eta)) <= 1, (hd_q, eta)
    assert st_ok == 200 and json.loads(ok_out)["tokens_predicted"] >= 1
    # tenant accounting: tokens add up, the flight records equal the ledger
    served = {"bulk": sum(o["tokens_evaluated"] + o["tokens_predicted"] for o in outs)}
    served["chat"] = (chat_out["tokens_evaluated"] + chat_out["tokens_predicted"]
                      + sum(r["served"] for r in reruns)
                      + json.loads(ok_out)["tokens_evaluated"]
                      + json.loads(ok_out)["tokens_predicted"])

    def llm_acct(snap, t):
        return snap["tenants"].get(t, {}).get("servers", {}).get("llm", {})

    charged = {t: sum(llm_acct(tenants1, t).get(k, 0) - llm_acct(tenants0, t).get(k, 0)
                      for k in ("prompt_tokens", "generated_tokens")) for t in served}
    chip = flight["aggregates"].get("tenant_chip_seconds", {})
    ledger_chip = {t: llm_acct(tenants1, t).get("chip_seconds", 0.0) for t in chip}
    log(f"llm int8: /debug/tenants tokens charged {charged} against served {served}; "
        f"chip-seconds flight {chip} ledger {ledger_chip}; outcomes "
        f"{ {t: llm_acct(tenants1, t).get('outcomes') for t in served} }")
    assert {"bulk", "chat"} <= set(tenants1["tenants"]), sorted(tenants1["tenants"])
    assert charged == served, (charged, served)
    assert set(chip) == {"bulk", "chat"} and all(
        abs(chip[t] - ledger_chip[t]) <= 1e-4 for t in chip), (chip, ledger_chip)
    # launches: 28 per forward step; flash for each from-zero prefill of a
    # >512-token prompt (the long batch row and its rerun, if it was parked;
    # a resume warm-starts one token on the plain path)
    steps = sum(r["kernel_forward_steps"] for r in runs)
    verify = sum(r.get("spec_dispatches", 0) for r in runs)
    long_prefills = sum(1 for b in bodies if len(tok.encode(b["prompt"])) > 512) + sum(
        1 for r in reruns if r["prompt_tokens"] > 512)
    want_paged = cfg.n_layers * steps if on_card else 0
    want_flash = cfg.n_layers * long_prefills if on_card else 0
    log(f"llm int8: /props decode_kernel {props['decode_kernel']} quant {props['quant']} "
        f"kv_quant {props['kv_quant']}; {len(runs)} engine runs, {steps} kernel forward steps; "
        f"paged_attention launches {paged_launches} (expected {cfg.n_layers} x {steps} = "
        f"{want_paged}: {cfg.n_layers} x {steps - verify} decode, {cfg.n_layers} x {verify} "
        f"verify); flash_attention launches {flash_launches} (expected {want_flash}: "
        f"{long_prefills} from-zero prefill(s) of a >512-token prompt)")
    assert props["quant"] == "int8" and props["kv_quant"] == "int8"
    assert props["decode_kernel"] == "paged_flash" or not on_card, props
    assert all(r["decode_kernel"] == props["decode_kernel"] for r in runs), runs
    assert paged_launches == want_paged and steps > 0, (paged_launches, want_paged)
    assert flash_launches == want_flash, (flash_launches, want_flash)
    e2e = dict(weight_bytes=gen.weight_bytes, bf16_weight_bytes=twin_bytes,
               pool_bytes=rt.pool_bytes, quantise_peak_gb=peak, teacher=acc, full_forward=full,
               int8_kernel_vs_gather_rel_l2=int8_rel, preempted=preempted, resumed=resumed,
               chat_first_token_ms=(first_chat - t_chat) * 1e3, chat_wall_s=chat_wall,
               batch_wall_s=batch_wall, batch_tokens=sum(o["tokens_predicted"] for o in outs),
               reruns=reruns, retry_after=int(hd_q["Retry-After"]), bucket_eta_s=eta,
               forward_steps=steps, verify_forward_steps=verify)
    if on_card:
        prof = profile_decode(torch, gen, rt)
        e2e.update(prof)
        log("llm int8 vs bf16 (one call; bf16 from phase 4b): decode step wall "
            f"{prof.get('decode_step_wall_ms', 0):.2f} vs {bf16.get('decode_step_wall_ms', 0):.2f}"
            f" ms, device {prof.get('decode_step_device_ms', 0):.2f} vs "
            f"{bf16.get('decode_step_device_ms', 0):.2f} ms, idle "
            f"{prof.get('decode_idle_share', 0):.3f} vs {bf16.get('decode_idle_share', 0):.3f}; "
            f"verify wall {prof.get('verify_step_wall_ms', 0):.2f} vs "
            f"{bf16.get('verify_step_wall_ms', 0):.2f} ms, device "
            f"{prof.get('verify_step_device_ms', 0):.2f} vs "
            f"{bf16.get('verify_step_device_ms', 0):.2f} ms")
    del server, rt, gen
    return dict(paged_launches=paged_launches, flash_launches=flash_launches, e2e=e2e,
                paged_launches_by_step={"decode": cfg.n_layers * (steps - verify),
                                        "verify": cfg.n_layers * verify})


def _decode_state(torch, gen, rt, lengths, seed=0):
    """Eight rows prefilled from random prompts of ``lengths`` into fresh
    pool blocks; returns the host state for ``Generator._decode_scan_paged``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    B = len(lengths)
    bt = np.zeros((B, rt.blocks_per_seq), np.int32)
    firsts, blocks = [], []
    for i, n in enumerate(lengths):
        ids = rt.pool.alloc_tokens(n + 16)
        blocks += ids
        bt[i, :len(ids)] = ids
        bucket = gen._bucket(n)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = rng.randint(3, gen.cfg.vocab_size, n)
        f, _ = gen._admit_fused_paged(tokens, rt.arrays, bt[[i]], np.array([n]),
                                      np.array([n + 16]), [0], np.zeros(1, np.float32),
                                      np.zeros(1, np.int64), np.ones(1, bool))
        firsts.append(f)
    state = dict(first=torch.cat(firsts)[:, None], cur=np.array(lengths, np.int64),
                 active=np.ones(B, np.int64), bt=bt, gens=[None] * B,
                 temp=np.zeros(B, np.float32), topk=np.zeros(B, np.int64),
                 greedy=np.ones(B, bool))
    return state, blocks


def teacher_logits(torch, gen, rt, steps: int = 16, flashes=(True,)):
    """``{flash: logits [8, steps, V]}``: one decode chunk from one state of
    eight rows (3000 ... 1 tokens, prompts drawn from seed 0), teacher-forced
    with tokens drawn from seed 1, through the paged kernel (True) and/or
    the gather path with the plain partial (False)."""
    import numpy as np

    lengths = [min(n, gen.cfg.max_seq - steps - 1)
               for n in (3000, 2100, 1500, 900, 513, 64, 17, 1)]
    st, blocks = _decode_state(torch, gen, rt, lengths)
    teacher = torch.as_tensor(np.random.RandomState(1).randint(3, gen.cfg.vocab_size,
                                                               (8, steps)), device=DEVICE)
    out = {}
    for flash in flashes:
        *_, logits = gen._decode_scan_paged(st["first"], st["cur"], st["active"], rt.arrays,
                                            st["bt"], st["gens"], st["temp"], st["topk"],
                                            st["greedy"], steps, flash=flash, teacher=teacher)
        out[flash] = logits
    rt.pool.decref(blocks)
    return out, lengths


def teacher_forced_check(torch, gen, rt, steps: int = 16) -> float:
    """One decode chunk from one state, teacher-forced through the paged
    kernel and through the gather path with the plain partial; returns the
    logits' relative L2 (limit LLM_LOGITS_REL_L2)."""
    out, lengths = teacher_logits(torch, gen, rt, steps, flashes=(True, False))
    a, b = out[True], out[False]
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    finite = bool(torch.isfinite(a).all())
    log(f"llm: teacher-forced {steps}-step chunk at rows {lengths}: logits relative L2 "
        f"kernel vs gather {rel:.3e} (limit {LLM_LOGITS_REL_L2}), argmax agreement "
        f"{agree:.3f}, finite={finite}")
    assert finite and rel < LLM_LOGITS_REL_L2, rel
    return rel


def profile_decode(torch, gen, rt, evals: int = 5) -> dict:
    """Where one decode step and one speculative verify step (4 drafts) at 8
    rows of 2048 tokens go: wall per step (host clock, synchronised), device
    kernel time per step (torch.profiler), the idle share, the paged
    kernel's time and how many kernel names it shows under, and the kernels
    that take the most device time."""
    import numpy as np

    st, blocks = _decode_state(torch, gen, rt, [2048] * 8, seed=2)
    draft = np.random.RandomState(3).randint(3, gen.cfg.vocab_size, (8, 4))

    def decode():
        gen._decode_scan_paged(st["first"], st["cur"], st["active"], rt.arrays, st["bt"],
                               st["gens"], st["temp"], st["topk"], st["greedy"], 1,
                               flash=True)

    def verify():  # accepted drafts land past the prefix, inside the rows' blocks
        gen._spec_verify_paged(st["first"], draft, np.full(8, 4), st["cur"], st["active"],
                               rt.arrays, st["bt"], st["gens"], st["temp"], st["topk"],
                               st["greedy"], 4, flash=True)

    out = {}
    for name, step in (("decode", decode), ("verify", verify)):
        out.update(_profile_step(torch, name, step, evals))
    rt.pool.decref(blocks)
    return out


def _profile_step(torch, name, step, evals) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(evals):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / evals * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(evals):
            step()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / evals / 1e3, e.count // evals)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        log(f"profile {name}: device time not measured (the profiler saw no kernels)")
        return {f"{name}_step_wall_ms": wall_ms}
    busy = sum(ms for _, ms, _ in kernels)
    paged_names = [k for k, _, _ in kernels if "paged_" in k]
    paged = sum(ms for k, ms, _ in kernels if "paged_" in k)
    paged_n = sum(n for k, _, n in kernels if "paged_" in k)
    log(f"profile {name} step (8 rows at 2048 tokens, 1 step): wall {wall_ms:.2f} ms, device "
        f"kernels {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{sum(n for _, _, n in kernels)} kernel launches/step, paged_attention "
        f"{paged:.3f} ms ({paged / busy:.3f} of device time, {paged_n} launches under "
        f"{len(paged_names)} kernel name(s))")
    for k, ms, n in sorted(kernels, key=lambda r: -r[1])[:8]:
        log(f"    {ms:8.3f} ms  x{n:4d}  {k[:100]}")
    return {f"{name}_step_wall_ms": wall_ms, f"{name}_step_device_ms": busy,
            f"{name}_idle_share": 1 - busy / wall_ms, f"{name}_paged_ms": paged,
            f"{name}_paged_kernel_names": len(paged_names)}


def _wan_client():
    """The reference client script of the Wan path, loaded from the checkout."""
    import importlib.util

    path = os.path.join(REPO, "cluster-config", "apps", "llm", "scripts", "generate_wan_t2v.py")
    spec = importlib.util.spec_from_file_location("generate_wan_t2v", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wan_video(client, url, entry, size):
    """The prompt's frames read back through ``/view``, checked for shape."""
    import urllib.parse

    import numpy as np

    frames = []
    for f in client.result_files(entry):
        status, png = get(url + "/view?" + urllib.parse.urlencode(
            {"filename": f["filename"], "subfolder": f["subfolder"], "type": f["type"]}))
        assert status == 200, status
        frames.append(png_to_array(png))
    width, height = size
    assert all(im.shape == (height, width, 3) for im in frames), [im.shape for im in frames]
    return np.stack(frames)


def _levels(a, b) -> dict:
    import numpy as np

    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)), max=int(d.max()))


def _wan_split(rec) -> dict:
    """A dispatch's seconds: text encode, denoise (both end in a device
    synchronise), and decode up to the first fetch of its frames."""
    decode = rec["decode_enqueue_s"] + rec["fetched_at"] - rec["dispatched_at"]
    return dict(text_s=rec["text_s"], denoise_s=rec["denoise_s"], decode_s=decode,
                total_s=rec["text_s"] + rec["denoise_s"] + decode)


def phase_wan(torch, preset: str = "wan_1_3b", size=(WAN_W, WAN_H), frames: int = WAN_FRAMES,
              steps: int = WAN_STEPS):
    """Phase 4c: the Wan graph server at Wan2.1 1.3B width; returns the flash
    launch count and the measured numbers.  A CPU rehearsal passes the tiny
    preset and a small size."""
    import numpy as np

    from tpustack_torch.models.wan import WanConfig, WanPipeline
    from tpustack_torch.models.wan.dit import set_attn_impl
    from tpustack_torch.ops.flash_attention import flash_attention
    from tpustack_torch.serving.graph_server import GraphServer, WanRuntime, _text_quant

    on_card = DEVICE == "cuda"
    client = _wan_client()
    client.TENANT = "wan-client"  # X-Tenant-Id on every request the client sends
    cfg = WanConfig.tiny() if preset == "tiny" else WanConfig.wan_1_3b()
    # WAN_TEXT_QUANT as the server resolves it: unset is the int8 umt5
    # tower for the full-width preset, as in the JAX package
    tq = _text_quant(preset)
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, quant=tq))
    t0 = time.perf_counter()
    pipe = WanPipeline(cfg, device=DEVICE, seed=0)
    sync(torch)
    text_t = list(pipe.text_encoder.parameters()) + list(pipe.text_encoder.buffers())
    n_text = sum(t.numel() for t in text_t)
    text_bytes = sum(t.numel() * t.element_size() for t in text_t)
    n_dit = sum(p.numel() for p in pipe.dit.parameters())
    log(f"wan: {preset} (DiT dim {cfg.dit.dim} x {cfg.dit.num_layers} layers, "
        f"{cfg.dit.num_heads} heads of {cfg.dit.dim // cfg.dit.num_heads}, {n_dit / 1e9:.3f} B "
        f"params; umt5 dim {cfg.text.dim} x {cfg.text.num_layers}, {n_text / 1e9:.3f} B, "
        f"WAN_TEXT_QUANT {os.environ.get('WAN_TEXT_QUANT')!r} -> {tq}: {text_bytes / 1e9:.3f} "
        f"GB against {n_text * 2 / 1e9:.3f} GB in bf16), "
        f"{pipe.dtype}, built on {pipe.device} in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 1e9 if on_card else 0:.2f} GB allocated")
    width, height = size
    # CUDA, cuBLAS and cuDNN initialisation outside the counts
    pipe.generate("warm-up", frames=5, steps=1, width=64, height=64, seed=0)
    sync(torch)
    work = os.path.join(REPO, "build", "wan_smoke")
    shutil.rmtree(work, ignore_errors=True)
    rt = WanRuntime(models_dir=os.path.join(work, "models"),
                    output_dir=os.path.join(work, "outputs"), pipeline=pipe)
    server = GraphServer(rt)
    url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
    n_px = pipe.pixel_frame_count(frames)
    prompts = [("a red panda eating bamboo in a misty forest, cinematic", 1234),
               ("a lighthouse on a cliff at dusk, waves crashing", 77)]
    negative = "blurry, low quality, static"

    def graph(prompt, seed):
        return client.build_graph(prompt=prompt, negative=negative, seed=seed, width=width,
                                  height=height, frames=frames, steps=steps, cfg=WAN_CFG,
                                  sampler="uni_pc", scheduler="simple", denoise=1.0,
                                  save_images=True, filename_prefix="wan_smoke")

    def done(pid):
        return client.wait_for_result(url, pid, timeout=900, poll=0.1, retries=0)

    try:
        check_ready(url, "wan")
        client.preflight(url, client.DEFAULT_UNET, client.DEFAULT_CLIP, client.DEFAULT_VAE)
        sync(torch)
        metrics0 = scrape(url)
        flash_attention.launches = 0
        t1 = time.perf_counter()
        solo = done(client.submit(url, graph(*prompts[0]), "chip_smoke", retries=0))
        solo_wall = time.perf_counter() - t1
        # the pair: both queued before the worker takes either, under a pixel
        # budget that admits 2 x n_px x H x W
        server.pixel_budget = 2 * n_px * height * width
        t2 = time.perf_counter()
        with server.hold():
            pids = [client.submit(url, graph(p, s), "chip_smoke", retries=0)
                    for p, s in (prompts[0], prompts[1])]
        pair = [done(pid) for pid in pids]
        pair_wall = time.perf_counter() - t2
        sync(torch)
        launches = flash_attention.launches
        solo_video = _wan_video(client, url, solo, size)
        pair_videos = [_wan_video(client, url, e, size) for e in pair]
        fallbacks = server.batch_fallbacks
        recs = list(server.dispatch_log)
        metrics1 = scrape(url)
        tenants = _tenants(url)
        flight = [r for r in json.loads(http(url + "/debug/flight")[2])["records"]
                  if r["kind"] == "dispatch"]
    finally:
        server.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    assert [r["batch"] for r in recs] == [1, 2], [r["batch"] for r in recs]
    assert not recs[0]["stream_decode"] and recs[1]["stream_decode"], recs
    assert fallbacks == 0, fallbacks
    for v in [solo_video] + pair_videos:
        assert v.shape[0] == n_px, v.shape
        assert float(v.std()) > 1.0, "a constant video"
        assert len({f.tobytes() for f in v}) > 1, "every frame the same"
    assert not np.array_equal(pair_videos[0], pair_videos[1]), "the pair's videos are equal"
    evals = steps * 2  # uni_pc -> Heun: two DiT evaluations per step
    per_eval = 2 * cfg.dit.num_layers if on_card else 0  # CPU tensors take the twin
    expected = per_eval * evals * len(recs)
    log(f"wan: {len(recs)} dispatches {[r['batch'] for r in recs]} (the pair's "
        f"{2 * n_px * height * width} pixel-frames took the streaming decoder: "
        f"{recs[1]['stream_decode']}), batched-dispatch fallbacks {fallbacks}; flash_attention "
        f"launches {launches} (expected {per_eval} per DiT evaluation x {evals} evaluations x "
        f"{len(recs)} dispatches = {expected})")
    assert launches == expected, (launches, expected)
    moved = {name: metric_sum(metrics1, name, **kw) - metric_sum(metrics0, name, **kw)
             for name, kw in (("tpustack_http_requests_total",
                               dict(server="graph", endpoint="/prompt", status="200")),
                              ("tpustack_graph_prompts_total", dict(status="success")))}
    log(f"wan: /metrics moved {moved} over 3 prompts")
    assert all(v == 3 for v in moved.values()), moved
    acct = tenants["tenants"]["wan-client"]["servers"]["graph"]
    log(f"wan: /debug/tenants wan-client {acct}; dispatch records' tenants "
        f"{[r.get('tenants') for r in flight]}")
    assert acct["outcomes"] == {"ok": 3} and acct["chip_seconds"] > 0, acct
    assert [r.get("tenants") for r in flight] == [{"wan-client": 1}, {"wan-client": 2}], flight
    row0 = _levels(pair_videos[0], solo_video)
    log(f"wan: the pair's row 0 vs the solo video of the same (prompt, seed): |diff| mean "
        f"{row0['mean']:.3f} levels (limit {WAN_PAIR_MEAN_LEVELS}), p99 {row0['p99']:.0f}, max "
        f"{row0['max']}; {n_px} frames of {height}x{width}, pixel std {solo_video.std():.1f}")
    assert row0["mean"] <= WAN_PAIR_MEAN_LEVELS, row0
    b1, b2 = _wan_split(recs[0]), _wan_split(recs[1])
    log(f"wan: batch 1 {b1['total_s']:.3f} s/video (text {b1['text_s']:.3f}, denoise "
        f"{b1['denoise_s']:.3f}, decode {b1['decode_s']:.3f}; client wall {solo_wall:.2f} s); "
        f"pair {b2['total_s']:.3f} s = {b2['total_s'] / 2:.3f} s/video (text "
        f"{b2['text_s']:.3f}, denoise {b2['denoise_s']:.3f}, streaming decode "
        f"{b2['decode_s']:.3f}; client wall {pair_wall:.2f} s); peak {peak_gb:.2f} GB")

    # one full-width DiT evaluation through the kernel vs the plain path
    lat = pipe._lat_shape(frames, height, width)
    g = torch.Generator(DEVICE).manual_seed(1)
    x = torch.randn(2, *lat, generator=g, device=DEVICE)
    t = torch.full((2,), 999.0, device=DEVICE)
    ids, mask = pipe.tokenizer(["", prompts[0][0]])
    with torch.inference_mode():
        ctx = pipe.text_encoder(torch.as_tensor(ids).to(DEVICE), torch.as_tensor(mask).to(DEVICE))
        v_kernel = pipe.dit(x.to(pipe.dtype), t, ctx)
        set_attn_impl(pipe.dit, "xla")
        v_plain = pipe.dit(x.to(pipe.dtype), t, ctx)
        set_attn_impl(pipe.dit, cfg.dit.attn_impl)
    rel = ((v_kernel - v_plain).norm() / v_plain.norm()).item()
    finite = bool(torch.isfinite(v_kernel).all())
    log(f"wan: full-width DiT eval, kernel vs plain attention: relative L2 {rel:.3e} (limit "
        f"{WAN_DIT_REL_L2}), finite={finite}, |v| mean {v_plain.abs().mean().item():.3f}")
    assert finite and rel < WAN_DIT_REL_L2, rel

    # the full and the streaming decode of one latent
    z = torch.randn(1, *lat, generator=g, device=DEVICE)
    full = pipe._decode_fused(z).cpu().numpy()
    streamed = pipe._decode_streaming(z).cpu().numpy()
    dec = _levels(streamed, full)
    log(f"wan: full vs streaming decode of one latent {list(z.shape)}: |diff| mean "
        f"{dec['mean']:.4f} levels (limit {WAN_STREAM_MEAN_LEVELS}), p99 {dec['p99']:.0f}, "
        f"max {dec['max']}")
    assert full.shape == streamed.shape and dec["mean"] <= WAN_STREAM_MEAN_LEVELS, dec
    e2e = dict(s_per_video_b1=b1["total_s"], s_per_video_pair=b2["total_s"] / 2, b1=b1,
               text_quant=tq, text_bytes=text_bytes, text_params=n_text,
               pair=b2, solo_wall_s=solo_wall, pair_wall_s=pair_wall, dit_rel_l2=rel,
               pair_row0_levels=row0, stream_decode_levels=dec, peak_gb=peak_gb,
               dispatches=[r["batch"] for r in recs], batch_fallbacks=fallbacks)
    if on_card:
        e2e.update(profile_dit(torch, pipe, x, t, ctx))
    del pipe, rt
    return dict(launches=launches, e2e=e2e)


def profile_dit(torch, pipe, x, t, ctx, evals: int = 3) -> dict:
    """Where one DiT evaluation at CFG batch 2 goes: wall per evaluation
    (host clock, synchronised, profiler off), device kernel time per
    evaluation (torch.profiler), the idle share, the flash kernel's share,
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xb = x.to(pipe.dtype)
    with torch.inference_mode():
        pipe.dit(xb, t, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(evals):
            pipe.dit(xb, t, ctx)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / evals * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(evals):
                pipe.dit(xb, t, ctx)
            torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / evals / 1e3, e.count // evals)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        log("profile wan DiT: device time not measured (the profiler saw no kernels)")
        return {"dit_eval_wall_ms": wall_ms}
    busy = sum(ms for _, ms, _ in kernels)
    flash = sum(ms for k, ms, _ in kernels if "flash_attention_kernel" in k)
    flash_n = sum(n for k, _, n in kernels if "flash_attention_kernel" in k)
    log(f"profile wan DiT eval (CFG batch 2, {x.shape[1]}x{x.shape[2]}x{x.shape[3]} latent, "
        f"{x.shape[1] * x.shape[2] * x.shape[3] // 4} tokens): wall {wall_ms:.2f} ms, device "
        f"kernels {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f}, "
        f"{sum(n for _, _, n in kernels)} kernel launches/eval, flash_attention {flash:.3f} ms "
        f"x{flash_n} ({flash / busy:.3f} of device time)")
    for k, ms, n in sorted(kernels, key=lambda r: -r[1])[:10]:
        log(f"    {ms:8.3f} ms  x{n:4d}  {k[:100]}")
    return {"dit_eval_wall_ms": wall_ms, "dit_eval_device_ms": busy,
            "dit_idle_share": 1 - busy / wall_ms, "dit_flash_ms": flash,
            "dit_flash_share": flash / busy}


# ----------------------------------------------------------------- phase 4e
# phase 4e's traffic at full width (the CPU rehearsal passes smaller sizes)
MODES_SIZES = dict(
    chunk_tokens=1024,      # (a) TPUSTACK_PREFILL_CHUNK_TOKENS
    long_tokens=3000,       # (a) the long prompt: chunks at 0 and 1024, warm start at 2048
    short_new=96,           # (a) the seven short rows' budgets
    long_new=32,
    prefix_tokens=1984,     # (b) the shared prefix (31 whole blocks of 64)
    filler_tokens=2540,     # (b) the filler whose footprint is the whole pool
    tier_mb=1024,           # (b) TPUSTACK_KV_HOST_TIER_MB
    tier_new=16,
    dense_new=64,           # (c) the 8 concurrent completions' budgets
    store_chunk=256,        # (c) TPUSTACK_PREFIX_CACHE_CHUNK: the system prompt is one
    solo_ctx=16384,         # (d) LLM_CTX of the solo engine
    solo_tokens=9000,       # (d) the long prompt: bucket 16384, two 8192-token chunks
    solo_new=32,
    draft_new=64,           # (e) the draft-model completion's budget
)


@contextlib.contextmanager
def env_set(env: dict):
    """Set environment knobs for a block, restore them after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spy_rows(server) -> list:
    """Wrap ``server._slot_request``: one record per finished row (its ids,
    each wave's delivery time, its output and stats)."""
    seen, lock = [], threading.Lock()
    wrapped = server._slot_request

    def spy(r):
        sreq = wrapped(r)
        # t_slot: when the engine took the request (its admission begins)
        rec = {"ids": list(r.ids), "times": [], "t_slot": time.perf_counter()}
        done, toks = sreq.on_done, sreq.on_tokens

        def on_tokens(t):
            rec["times"].append(time.perf_counter())
            if toks is not None:
                toks(t)

        def on_done(tokens, stats):
            rec.update(out=None if tokens is None else list(tokens), stats=dict(stats),
                       done=time.perf_counter())
            with lock:
                seen.append(rec)
            done(tokens, stats)

        sreq.on_tokens, sreq.on_done = on_tokens, on_done
        return sreq

    server._slot_request = spy
    return seen


def expected_flash(gen, n_prompt: int, base: int = 0) -> dict:
    """Flash launches by route of one prefill of ``n_prompt`` tokens from
    cache position ``base``, by the dispatch rules stated before the run
    (``Generator._prefill_from``, ``LlamaAttention._cache_attention``,
    ``ops.attention.auto_impl``): a suffix from ``base > 0`` whose bucket x
    ctx is at most ``MASKED_PREFILL_MAX`` is one masked plain pass; else
    ``PREFILL_CHUNK``-token chunks, the one at position 0 on the panel route
    (the kernel only for >= 1024 rows: ``auto_impl``) and every other one on
    the streaming route; one launch per layer each.  Zero on the CPU."""
    from tpustack_torch.ops.attention import FLASH_MIN_SQ

    out = {"panel": 0, "stream": 0}
    if DEVICE != "cuda":
        return out
    S, L = gen.cfg.max_seq, gen.cfg.n_layers
    bucket = gen._bucket(n_prompt) if base == 0 else min(gen._bucket(n_prompt - base), S - base)
    if base > 0 and bucket * S <= gen.MASKED_PREFILL_MAX:
        return out
    for lo in range(0, bucket, gen.PREFILL_CHUNK):
        n = min(gen.PREFILL_CHUNK, bucket - lo)
        if base + lo == 0:
            out["panel"] += L if n >= FLASH_MIN_SQ else 0
        else:
            out["stream"] += L
    return out


def _add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _lead(a, b) -> int:
    """Leading equal tokens of two id lists."""
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


class _Counts:
    """The launch counters of one measured window: zeroed at construction,
    read by ``read()`` after the engine went idle."""

    def __init__(self, torch, server):
        from tpustack_torch.ops.flash_attention import reset_launches
        from tpustack_torch.ops.paged_attention import paged_attention_partial

        self.torch, self.server, self.runs0 = torch, server, len(server.run_log)
        sync(torch)
        paged_attention_partial.launches = 0
        reset_launches()

    def read(self):
        from tpustack_torch.ops.flash_attention import flash_attention
        from tpustack_torch.ops.paged_attention import paged_attention_partial

        wait_engine_idle(self.server)
        sync(self.torch)
        runs = list(self.server.run_log)[self.runs0:]
        steps = sum(r.get("kernel_forward_steps", 0) for r in runs)
        return dict(flash=dict(flash_attention.route_launches),
                    paged=paged_attention_partial.launches, steps=steps, runs=runs)


def check_paged(label, gen, counts) -> None:
    """The paged kernel ran once per layer per forward step of the window."""
    want = gen.cfg.n_layers * counts["steps"] if DEVICE == "cuda" else 0
    log(f"{label}: paged_attention launches {counts['paged']} (expected {gen.cfg.n_layers} x "
        f"{counts['steps']} forward steps = {want})")
    assert counts["paged"] == want, (label, counts["paged"], want)


def check_flash(label, counts, want: dict, why: str) -> None:
    log(f"{label}: flash_attention launches by route {counts['flash']} (expected {want}: {why})")
    assert counts["flash"] == want, (label, counts["flash"], want)


def modes_a_chunked(torch, gen, tok, sz) -> dict:
    """(a) Chunked prefill on the paged engine: 7 short rows decode while one
    long prompt arrives, chunked (``TPUSTACK_PREFILL_CHUNK_TOKENS``) and
    monolithic, one run each in this call; then the chunked prefill's
    teacher-forced logits against the monolithic prefill's."""
    from tpustack_torch.serving.llm_server import LLMServer

    cfg, on_card = gen.cfg, DEVICE == "cuda"
    words = "each night shift writes the scheduler log of every queue".split()
    shorts = [{"prompt": f"Row {i}: " + _text_of(tok, words, 24), "n_predict": sz["short_new"],
               "temperature": 0, "cache_prompt": False} for i in range(LLM_SLOTS - 1)]
    long_text = _text_of(tok, "a long audit of every kernel launch and memory copy".split(),
                         sz["long_tokens"])
    long_body = {"prompt": long_text, "n_predict": sz["long_new"], "temperature": 0,
                 "cache_prompt": False}
    L = len(tok.encode(long_text))
    out, rows = {}, {}
    for chunk in (sz["chunk_tokens"], 0):
        with env_set({"TPUSTACK_PREFILL_CHUNK_TOKENS": chunk, "TPUSTACK_PREFIX_CACHE": "1",
                      "TPUSTACK_KV_POOL_BLOCKS": "0"}):
            server = LLMServer(gen, tok, model_name="llm-chunked")
            block = server.paged.block
            seen = spy_rows(server)
            url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
            try:
                m0 = scrape(url)
                counts = _Counts(torch, server)
                res = [None] * LLM_SLOTS

                def send(i, body):
                    res[i] = post_json(url + "/completion", body)

                threads = [threading.Thread(target=send, args=(i, b))
                           for i, b in enumerate(shorts)]
                for t in threads:
                    t.start()
                t_end = time.time() + 300
                while True:  # every short row decoding (or, rehearsed, one done)
                    slots = list(getattr(server._engine, "_slots_view", None) or [])
                    decoding = sum(1 for s in slots if s.req is not None and not s.pending
                                   and len(s.out) > 1)
                    if decoding == len(shorts) or seen:
                        break
                    assert time.time() < t_end, "the short rows never started decoding"
                    time.sleep(0.002)
                send(len(shorts), long_body)
                for t in threads:
                    t.join(timeout=600)
                c = counts.read()
                m1 = scrape(url)
            finally:
                server.stop()
        assert all(r[0] == 200 for r in res), [r[0] for r in res]
        long_rec = next(r for r in seen if len(r["ids"]) == L)
        # the short rows' waits between two deliveries that span part of the
        # long prompt's prefill: from the engine taking it to its first token
        t_in, t_first = long_rec["t_slot"], long_rec["times"][0]
        gaps = [b - a for r in seen if r is not long_rec
                for a, b in zip(r["times"], r["times"][1:]) if b > t_in and a < t_first] or [0.0]
        all_gaps = [b - a for r in seen if r is not long_rec
                    for a, b in zip(r["times"], r["times"][1:])]
        chunks = sum(r.get("prefill_chunks", 0) for r in c["runs"])
        moved = (metric_sum(m1, "tpustack_llm_prefill_chunks_total")
                 - metric_sum(m0, "tpustack_llm_prefill_chunks_total"))
        label = f"llm 4e(a) chunk {chunk}"
        log(f"{label}: {decoding} short rows decoding when the long prompt ({L} tokens) was "
            f"sent; {long_rec['stats'].get('prefill_chunks', 0)} chunk dispatches (engine "
            f"stats {chunks}, /metrics moved {moved:.0f}); the long row's first token "
            f"{(t_first - t_in) * 1e3:.1f} ms after the engine took it (the last admission's "
            f"prefill_s {long_rec['stats']['prefill_s'] * 1e3:.1f} ms); the short rows' "
            f"longest wait between deliveries spanning that prefill {max(gaps) * 1e3:.1f} ms "
            f"({len(gaps)} waits, median {sorted(gaps)[len(gaps) // 2] * 1e3:.1f} ms); longest "
            f"over the whole run {max(all_gaps or [0.0]) * 1e3:.1f} ms (median "
            f"{sorted(all_gaps or [0.0])[len(all_gaps) // 2] * 1e3:.1f} ms)")
        if chunk:
            # block-aligned chunks while the remainder exceeds the chunk
            # (at full width [0, 1024) and [1024, 2048)), then the warm start
            step = max(block, chunk // block * block)
            want_chunks, plen, want = 0, 0, {"panel": 0, "stream": 0}
            while L - plen > step:
                want = _add(want, expected_flash(gen, plen + step, plen))
                want_chunks += 1
                plen += step
            want = _add(want, expected_flash(gen, L, plen))
            assert plen % block == 0, (plen, block)
            assert chunks == moved == want_chunks == long_rec["stats"]["prefill_chunks"], \
                (chunks, moved, want_chunks, long_rec["stats"])
            assert long_rec["stats"]["prefill_tokens"] == L
            why = (f"{want_chunks} chunks of {step} (from position 0 on the panel route, the "
                   f"rest streaming) and the {L - plen}-token warm start at {plen}")
        else:
            want = expected_flash(gen, L, 0)
            assert "prefill_chunks" not in long_rec["stats"] and moved == 0
            why = "one from-zero prefill of the whole bucket on the panel route"
        check_flash(label, c, want, why)
        check_paged(label, gen, c)
        out[f"max_gap_ms_chunk_{chunk}"] = max(gaps) * 1e3
        out[f"median_gap_ms_chunk_{chunk}"] = sorted(gaps)[len(gaps) // 2] * 1e3
        out[f"max_gap_run_ms_chunk_{chunk}"] = max(all_gaps or [0.0]) * 1e3
        out[f"long_ttft_ms_chunk_{chunk}"] = (t_first - t_in) * 1e3
        out[f"flash_chunk_{chunk}"] = c["flash"]
        rows[chunk] = long_rec["out"]
        out.setdefault("paged_launches", 0)
        out["paged_launches"] += c["paged"]
    out["long_prompt_tokens"] = L
    out["served_agreement"] = _lead(rows[sz["chunk_tokens"]], rows[0])
    log(f"llm 4e(a): the long row's served ids, chunked against monolithic: the first "
        f"{out['served_agreement']} of {len(rows[0])} equal")
    out.update(chunk_vs_mono_logits(torch, gen, tok.encode(long_text), step))
    out["flash"] = _add(out["flash_chunk_0"], out[f"flash_chunk_{sz['chunk_tokens']}"])
    return out


def chunk_vs_mono_logits(torch, gen, ids, step, steps=16, greedy=32) -> dict:
    """The long prompt prefilled into fresh pool blocks twice, monolithic
    (``_admit_fused_paged``) and chunked (``_prefill_chunk_paged`` twice,
    then the ``_admit_prefix_paged`` warm start), then one decode chunk of
    ``steps`` teacher-forced tokens from each: logits relative L2 (limit
    ``LLM_LOGITS_REL_L2``) and the greedy continuations' agreement."""
    import numpy as np

    from tpustack_torch.serving.llm_server import build_paged

    L, S = len(ids), gen.cfg.max_seq
    steps = min(steps, (S - L) // 2)
    greedy = min(greedy, S - L - steps)
    rt = build_paged(gen, 1, block=64 if DEVICE == "cuda" else None,
                     n_blocks=2 * (S // (64 if DEVICE == "cuda" else 16)), prefix_cache=False)
    teacher = torch.as_tensor(np.random.RandomState(4).randint(3, gen.cfg.vocab_size,
                                                               (1, steps)), device=DEVICE)
    greedy_args = (np.zeros(1, np.float32), np.zeros(1, np.int64), np.ones(1, bool))
    logits, conts, held = {}, {}, []
    for mode in ("mono", "chunked"):
        blocks = rt.pool.alloc_tokens(L + greedy + steps)
        held += blocks
        bt = np.zeros((1, rt.blocks_per_seq), np.int32)
        bt[0, :len(blocks)] = blocks
        limit = np.array([L + greedy + steps], np.int64)
        if mode == "mono":
            tokens = np.zeros((1, gen._bucket(L)), np.int64)
            tokens[0, :L] = ids
            first, _ = gen._admit_fused_paged(tokens, rt.arrays, bt, np.array([L]), limit, [0],
                                              *greedy_args)
        else:
            plen = 0
            while L - plen > step:
                tokens = np.zeros((1, gen._bucket(step)), np.int64)
                tokens[0, :step] = ids[plen:plen + step]
                gen._prefill_chunk_paged(rt.arrays, bt, tokens, plen,
                                         np.array([plen + step], np.int64))
                plen += step
            tokens = np.zeros((1, min(gen._bucket(L - plen), S - plen)), np.int64)
            tokens[0, :L - plen] = ids[plen:]
            first, _ = gen._admit_prefix_paged(tokens, rt.arrays, bt, plen, np.array([L]), limit,
                                               [0], *greedy_args)
        state = (np.array([L], np.int64), np.ones(1, np.int64))
        *_, lg = gen._decode_scan_paged(first[:, None], *state, rt.arrays, bt, [None],
                                        *greedy_args, steps, flash=True, teacher=teacher)
        logits[mode] = lg
        toks, _, _ = gen._decode_scan_paged(first[:, None], *state, rt.arrays, bt, [None],
                                            *greedy_args, greedy, flash=True)
        conts[mode] = [int(first[0])] + toks[0].cpu().tolist()
    a, b = logits["chunked"].float(), logits["mono"].float()
    rel = ((a - b).norm() / b.norm()).item()
    agree = _lead(conts["chunked"], conts["mono"])
    log(f"llm 4e(a): teacher-forced {steps}-step chunk after a {L}-token prefill, chunked "
        f"({step}-token chunks) against monolithic: logits relative L2 {rel:.3e} (limit "
        f"{LLM_LOGITS_REL_L2}), argmax agreement "
        f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.3f}; greedy continuations "
        f"agree for the first {agree} of {len(conts['mono'])} tokens")
    assert bool(torch.isfinite(a).all()) and rel < LLM_LOGITS_REL_L2, rel
    rt.pool.decref(held)
    del rt
    return dict(chunk_logits_rel_l2=rel, chunk_greedy_agreement=agree)


def modes_b_host_tier(torch, gen, tok, sz) -> dict:
    """(b) The host KV tier: a shared prefix evicted by a filler whose
    footprint is the whole pool spills to host RAM, and a repeat restores
    it; exact spill and restore counts, conservation, and the restored
    request's ids against a pool large enough that nothing is evicted."""
    from tpustack_torch.serving.llm_server import LLMServer

    cfg = gen.cfg
    prefix = _text_of(tok, "the shared operator manual describes every alert and its "
                           "runbook step by step".split(), sz["prefix_tokens"])
    tail_a, tail_b = " Q: alerts on node 3?", " Q: runbook for node 5?"
    filler = _text_of(tok, "an unrelated incident report lists each timeout".split(),
                      sz["filler_tokens"])
    new = sz["tier_new"]
    ids_a, ids_b, ids_f = (tok.encode(t) for t in (prefix + tail_a, prefix + tail_b, filler))
    block = 64 if DEVICE == "cuda" else 16
    blocks_for = lambda n: -(-n // block)  # noqa: E731
    n_pool = blocks_for(len(ids_f) + new)  # the filler's footprint is the whole pool
    n_a = len(ids_a) // block              # A's whole prompt blocks the cache keeps
    n_f = len(ids_f) // block
    shared = _lead(ids_a, ids_b)
    # B's host chain: the whole blocks it shares with A (the trie's match)
    n_s = min(shared // block, (len(ids_b) - 1) // block)
    fresh_b = blocks_for(len(ids_b) + new) - n_s
    # F's footprint is the pool: its admission evicts (spills) all n_a of A;
    # B claims its n_s chunks, and its restore plus fresh blocks evict (and
    # spill) whatever of F the blocks F's retirement freed do not cover
    want_spilled = n_a + max(0, n_s + fresh_b - (n_pool - n_f))
    assert blocks_for(len(ids_a) + new) <= n_pool and 0 < n_s <= n_a, (n_pool, n_a, n_s)
    bodies = {k: {"prompt": t, "n_predict": new, "temperature": 0}
              for k, t in (("A", prefix + tail_a), ("B", prefix + tail_b), ("F", filler))}
    out = {}
    with env_set({"TPUSTACK_KV_POOL_BLOCKS": n_pool, "TPUSTACK_KV_BLOCK": block,
                  "TPUSTACK_KV_HOST_TIER_MB": sz["tier_mb"],
                  "TPUSTACK_KV_HOST_TIER_CROSSOVER": "0", "TPUSTACK_PREFIX_CACHE": "1",
                  "TPUSTACK_PREFILL_CHUNK_TOKENS": "0"}):
        server = LLMServer(gen, tok, model_name="llm-host-tier")
        seen = spy_rows(server)
        url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
        rt = server.paged
        tier = rt.cache.host_tier
        try:
            m0 = scrape(url)
            counts = _Counts(torch, server)
            st = {}
            for k in ("A", "F", "B"):
                st[k], _, body = post_json(url + "/completion", bodies[k])
                wait_engine_idle(server)
                out[f"{k}_prompt_ms"] = body["timings"]["prompt_ms"]
            tier_st = tier.stats()
            cache_st = rt.cache.stats()
            m1 = scrape(url)
            c = counts.read()
            # the recompute wall of the same request, then the guard's
            # verdict on this call's measured costs with the crossover on
            st["B_recompute"], _, body = post_json(url + "/completion",
                                                   dict(bodies["B"], cache_prompt=False))
            wait_engine_idle(server)
            out["B_recompute_prompt_ms"] = body["timings"]["prompt_ms"]
            tier._crossover = True
            verdict = tier.should_restore(n_s)
            guard = tier.stats()
        finally:
            server.stop()
    # one block's spill copy with the pinned buffer warm (the caching host
    # allocator reuses a freed one), and the restore of B's blocks alone
    from tpustack_torch.serving.kv_host_tier import pack_block

    for _ in range(2):
        pack_block(rt.arrays, 1)
    t = time.perf_counter()
    for _ in range(5):
        pack_block(rt.arrays, 1)
    warm_copy_ms = (time.perf_counter() - t) / 5 * 1e3
    payloads = [pack_block(rt.arrays, 1) for _ in range(n_s)]
    sync(torch)
    t = time.perf_counter()
    gen._restore_blocks_paged(rt.arrays, list(range(1, n_s + 1)), payloads)
    sync(torch)
    restore_ms = (time.perf_counter() - t) * 1e3
    del payloads
    restored_ids = next(r["out"] for r in seen if r["ids"] == ids_b)
    moved = {k: metric_sum(m1, f"tpustack_llm_kv_host_{k}_blocks_total")
             - metric_sum(m0, f"tpustack_llm_kv_host_{k}_blocks_total")
             for k in ("spilled", "restored")}
    log(f"llm 4e(b): pool {n_pool} blocks of {block}; prompts A {len(ids_a)}, filler "
        f"{len(ids_f)}, B {len(ids_b)} tokens ({shared} shared with A); statuses {st}; tier "
        f"{ {k: tier_st[k] for k in ('spilled_total', 'restored_total', 'expired_total', 'resident_blocks', 'resident_bytes', 'block_bytes')} } "
        f"(expected spilled {want_spilled}, restored {n_s}); /metrics moved {moved}; cache "
        f"host hits {cache_st.get('host_hits')}")
    assert all(v == 200 for v in st.values()), st
    assert tier_st["spilled_total"] == want_spilled and tier_st["restored_total"] == n_s, tier_st
    assert tier_st["spilled_total"] == (tier_st["restored_total"] + tier_st["expired_total"]
                                        + tier_st["resident_blocks"]), tier_st
    assert moved == {"spilled": want_spilled, "restored": n_s}, moved
    check_flash("llm 4e(b)", c, _add(_add(expected_flash(gen, len(ids_a)),
                                          expected_flash(gen, len(ids_f))),
                                     expected_flash(gen, len(ids_b), n_s * block)),
                "A's and the filler's from-zero prefills; B's warm start after the restore")
    check_paged("llm 4e(b)", gen, c)
    log(f"llm 4e(b): B's time to first token {out['B_prompt_ms']:.1f} ms with {n_s} blocks "
        f"restored from host RAM, {out['B_recompute_prompt_ms']:.1f} ms recomputed; the "
        f"restore alone {restore_ms:.2f} ms for {n_s} blocks; a block's spill copy "
        f"{warm_copy_ms:.3f} ms with a warm pinned buffer; the crossover guard on this "
        f"call's costs (copy {guard['copy_s_per_block']} s/block, averaged over the spills, "
        f"prefill {guard['prefill_s_per_block']} s/block) would "
        f"{'restore' if verdict else 'recompute'}")
    # the same A then B from a pool large enough that nothing is evicted
    with env_set({"TPUSTACK_KV_POOL_BLOCKS": "0", "TPUSTACK_KV_BLOCK": block,
                  "TPUSTACK_KV_HOST_TIER_MB": "0", "TPUSTACK_PREFIX_CACHE": "1",
                  "TPUSTACK_PREFILL_CHUNK_TOKENS": "0"}):
        server = LLMServer(gen, tok, model_name="llm-big-pool")
        seen_big = spy_rows(server)
        url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
        try:
            for k in ("A", "B"):
                assert post_json(url + "/completion", bodies[k])[0] == 200
                wait_engine_idle(server)
            hits = server.paged.cache.stats()["hits"]
        finally:
            server.stop()
    big_ids = next(r["out"] for r in seen_big if r["ids"] == ids_b)
    log(f"llm 4e(b): B's ids after the restore equal B's from the large pool (a device hit of "
        f"{n_s} blocks, {hits} hit): {restored_ids == big_ids}")
    assert restored_ids == big_ids, (restored_ids, big_ids)
    out.update(spilled=tier_st["spilled_total"], restored=tier_st["restored_total"],
               restore_ms=restore_ms, warm_copy_ms=warm_copy_ms,
               copy_s_per_block=guard["copy_s_per_block"],
               prefill_s_per_block=guard["prefill_s_per_block"], guard_restores=verdict,
               flash=c["flash"], paged_launches=c["paged"], pool_blocks=n_pool)
    return out


def profile_dense_decode(torch, gen, evals: int = 5) -> dict:
    """One dense decode step at 8 rows of 2048 tokens: wall vs device time."""
    import numpy as np

    from tpustack_torch.models.llama import init_kv_caches

    B, n = LLM_SLOTS, 2048
    caches = init_kv_caches(gen.cfg, B, gen.cache_dtype, gen.device)
    tokens = np.random.RandomState(2).randint(3, gen.cfg.vocab_size, (B, n))
    greedy = (np.zeros(B, np.float32), np.zeros(B, np.int64), np.ones(B, bool))
    firsts, _ = gen._admit_fused(tokens, caches, np.full(B, n), list(range(B)), [0] * B,
                                 *greedy)
    cur, active = np.full(B, n, np.int64), np.ones(B, np.int64)
    out = _profile_step(torch, "dense_decode", lambda: gen._decode_scan_cont(
        firsts[:, None], cur, active, caches, [None] * B, *greedy, 1), evals)
    del caches
    return out


def modes_c_dense(torch, gen, tok, sz) -> dict:
    """(c) The dense engine (``TPUSTACK_PAGED_KV=0``): phase 4b's 8 prompts
    concurrently on the paged and on the dense engine in this call, then one
    dense prefix-store hit."""
    from tpustack_torch.serving.llm_server import LLMServer

    on_card = DEVICE == "cuda"
    system, _, bodies = llm_bodies(tok, (256, 1100, 600) if on_card else (66, 30, 20), on_card)
    bodies = [dict(b, n_predict=sz["dense_new"], temperature=0) for b in bodies]
    ids = {}
    out = {}
    for kind, env in (("paged", {"TPUSTACK_PAGED_KV": "1"}),
                      ("dense", {"TPUSTACK_PAGED_KV": "0"})):
        with env_set(dict(env, TPUSTACK_PREFIX_CACHE="1", TPUSTACK_KV_POOL_BLOCKS="0",
                          TPUSTACK_KV_HOST_TIER_MB="0", TPUSTACK_PREFILL_CHUNK_TOKENS="0",
                          TPUSTACK_PREFIX_CACHE_CHUNK=sz["store_chunk"])):
            server = LLMServer(gen, tok, model_name=f"llm-{kind}")
            seen = spy_rows(server)
            url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
            try:
                counts = _Counts(torch, server)
                res = [None] * len(bodies)

                def send(i):
                    res[i] = post_json(url + "/completion", bodies[i])

                t0 = time.perf_counter()
                threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
                wall = time.perf_counter() - t0
                hit = None
                if kind == "dense":  # one more sharing the stored system prompt
                    hit = post_json(url + "/completion", {"prompt": system + " Question: "
                                                          "what is the plan?", "n_predict": 8,
                                                          "temperature": 0})
                c = counts.read()
                store = (server.prefix_cache.stats() if kind == "dense"
                         else server.paged.cache.stats())
            finally:
                server.stop()
        assert all(r[0] == 200 for r in res), [r[0] for r in res]
        tokens = sum(r[2]["tokens_predicted"] for r in res)
        ids[kind] = {tuple(r["ids"]): r["out"] for r in seen}
        want = {"panel": 0, "stream": 0}
        for r in seen:
            want = _add(want, expected_flash(gen, len(r["ids"]), r["stats"]["cached_tokens"]))
        check_flash(f"llm 4e(c) {kind}", c, want, "each row's from-zero prefill or warm start "
                    "at the cache hit it got")
        if kind == "paged":
            check_paged("llm 4e(c) paged", gen, c)
        else:
            assert c["paged"] == 0 and hit[0] == 200 and store["hits"] >= 1, (c, hit, store)
            assert all("decode_kernel" not in r for r in c["runs"]), c["runs"]
        out[f"{kind}_tokens_per_s"] = tokens / wall
        log(f"llm 4e(c) {kind}: 8 concurrent completions, {tokens} tokens in {wall:.2f} s = "
            f"{tokens / wall:.2f} tokens/s aggregate; prefix store {store}")
        out[f"flash_{kind}"] = c["flash"]
        out[f"paged_launches_{kind}"] = c["paged"]
    agree = [_lead(ids["dense"][k], ids["paged"][k]) for k in ids["paged"] if k in ids["dense"]]
    out["agreement"] = agree
    log(f"llm 4e(c): dense against paged ids, leading equal tokens per row: {agree} of "
        f"{sz['dense_new']}")
    if on_card:
        out.update(profile_dense_decode(torch, gen))
    out["flash"] = _add(out["flash_paged"], out["flash_dense"])
    return out


def modes_d_solo(torch, gen, tok, sz) -> dict:
    """(d) The solo engine (``LLM_MAX_BATCH=1``) at ctx ``solo_ctx``: a long
    prompt served plain (the fused decode) and streamed (one step per
    token), equal ids, exact flash launches by route."""
    import copy

    from tpustack_torch.serving.llm_server import LLMServer

    solo = copy.copy(gen)  # the same weights at the longer context
    solo.cfg = dataclasses.replace(gen.cfg, max_seq=sz["solo_ctx"])
    solo._prefix_dev = type(gen._prefix_dev)()
    text = _text_of(tok, "the full transcript of the quarterly capacity review".split(),
                    sz["solo_tokens"])
    L = len(tok.encode(text))
    out = {}
    with env_set({"LLM_MAX_BATCH": "1", "TPUSTACK_PREFIX_CACHE": "0"}):
        server = LLMServer(solo, tok, model_name="llm-solo")
        url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
        try:
            counts = _Counts(torch, server)
            st, _, body = post_json(url + "/completion", {"prompt": text,
                                                          "n_predict": sz["solo_new"],
                                                          "temperature": 0})
            assert st == 200, body

            def ids_of(stream):
                r = server._admit(text, sz["solo_new"], 0.0, 40, None, False, True,
                                  stream=stream)
                server._enqueue(r)
                got = []
                while stream:
                    tok_id = r.stream.get(timeout=600)
                    if tok_id is None:
                        break
                    got.append(tok_id)
                assert r.done.wait(600) and r.error is None, r.error
                return got, [t for t in r.result[0] if t != tok.eos_id], r.result[1]

            streamed, _, _ = ids_of(True)
            _, plain, plain_stats = ids_of(False)
            c = counts.read()
        finally:
            server.stop()
    want = {k: 3 * v for k, v in expected_flash(solo, L).items()}
    log(f"llm 4e(d): solo ctx {sz['solo_ctx']}, a {L}-token prompt (bucket "
        f"{solo._bucket(L)}): TTFT {body['timings']['prompt_ms']:.1f} ms over HTTP, "
        f"{plain_stats['prefill_s'] * 1e3:.1f} ms on the engine; decode "
        f"{body['timings']['predicted_per_second']:.2f} tokens/s; streamed ids equal the "
        f"plain ones: {streamed == plain} ({len(plain)} tokens)")
    assert streamed == plain and len(plain) >= 1, (streamed, plain)
    check_flash("llm 4e(d)", c, want, f"three requests, each a {solo.PREFILL_CHUNK}-token chunk "
                "from position 0 on the panel route and the next on the streaming route over "
                f"the {sz['solo_ctx']}-token cache")
    assert c["paged"] == 0, c
    out.update(ttft_ms=body["timings"]["prompt_ms"], engine_prefill_ms=plain_stats["prefill_s"] * 1e3,
               decode_tokens_per_s=body["timings"]["predicted_per_second"], prompt_tokens=L,
               flash=c["flash"])
    return out


def modes_e_draft(torch, gen, tok, sz) -> dict:
    """(e) The draft-model drafter (``TPUSTACK_SPEC_DRAFT``): a seed-0 twin of
    the target drafts one short greedy completion; acceptance, agreement
    with speculation off, the draft's wall time per drafted token."""
    from tpustack_torch.serving.llm_server import LLMServer

    preset = "qwen25_7b" if DEVICE == "cuda" else "tiny"
    body = {"prompt": "Summarise what the scheduler did on node 4 tonight.",
            "n_predict": sz["draft_new"], "temperature": 0, "cache_prompt": False}
    with env_set({"TPUSTACK_SPEC_DRAFT": preset, "TPUSTACK_SPEC_TOKENS": "4",
                  "TPUSTACK_PREFIX_CACHE": "1", "TPUSTACK_KV_POOL_BLOCKS": "0"}):
        t0 = time.perf_counter()
        server = LLMServer(gen, tok, model_name="llm-draft")
        drafter = server.spec_cfg.drafter
        log(f"llm 4e(e): draft model {preset} ({drafter.gen.weight_bytes / 1e9:.3f} GB) built "
            f"in {time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 1e9 if DEVICE == 'cuda' else 0:.2f} GB "
            "allocated with both models")
        timing = {"s": 0.0, "calls": 0, "tokens": 0}
        inner = drafter.draft

        def timed_draft(history, k):
            t = time.perf_counter()
            got = inner(history, k)
            timing["s"] += time.perf_counter() - t
            timing["calls"] += 1
            timing["tokens"] += len(got)
            return got

        drafter.draft = timed_draft
        seen = spy_rows(server)
        url = f"http://127.0.0.1:{server.start(host='127.0.0.1', port=0)}"
        try:
            counts = _Counts(torch, server)
            spec0 = (server._spec_drafted, server._spec_accepted)
            t1 = time.perf_counter()
            st, _, on = post_json(url + "/completion", body)
            wall_on = time.perf_counter() - t1
            wait_engine_idle(server)
            drafted = server._spec_drafted - spec0[0]
            accepted = server._spec_accepted - spec0[1]
            t2 = time.perf_counter()
            st2, _, off = post_json(url + "/completion", dict(body, speculative=False))
            wall_off = time.perf_counter() - t2
            c = counts.read()
        finally:
            server.stop()
    assert st == 200 and st2 == 200, (on, off)
    outs = [r["out"] for r in seen]
    agree = _lead(outs[0], outs[1])
    ratio = accepted / drafted if drafted else 0.0
    log(f"llm 4e(e): acceptance {accepted}/{drafted} = {ratio:.4f}; ids against speculation "
        f"off: the first {agree} of {len(outs[1])} equal; wall {wall_on:.2f} s with the draft "
        f"against {wall_off:.2f} s without; the draft model's wall "
        f"{timing['s'] / max(1, timing['tokens']) * 1e3:.2f} ms per drafted token "
        f"({timing['calls']} proposals)")
    assert drafted > 0 and c["flash"] == {"panel": 0, "stream": 0}, (drafted, c["flash"])
    check_paged("llm 4e(e)", gen, c)
    return dict(acceptance=ratio, drafted=drafted, accepted=accepted, agreement=agree,
                wall_spec_on_s=wall_on, wall_spec_off_s=wall_off,
                draft_ms_per_token=timing["s"] / max(1, timing["tokens"]) * 1e3,
                paged_launches=c["paged"], flash=c["flash"])


def phase_llm_modes(torch, gen, tok, sizes=None) -> dict:
    """Phase 4e: the LLM engine's modes on phase 4b's model (a chunked
    prefill, the host KV tier, the dense engine, the solo engine at a long
    context, the draft-model drafter).  Returns each part's numbers and the
    launch counts by route and path."""
    sz = dict(MODES_SIZES, **(sizes or {}))
    parts = {}
    for name, fn in (("chunked", modes_a_chunked), ("host_tier", modes_b_host_tier),
                     ("dense", modes_c_dense), ("solo", modes_d_solo), ("draft", modes_e_draft)):
        t = time.perf_counter()
        parts[name] = fn(torch, gen, tok, sz)
        parts[name]["wall_s"] = time.perf_counter() - t
        log(f"phase 4e {name}: {parts[name]['wall_s']:.1f} s wall")
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    paged = (parts["chunked"]["paged_launches"] + parts["host_tier"]["paged_launches"]
             + parts["dense"]["paged_launches_paged"] + parts["draft"]["paged_launches"])
    return dict(parts=parts, paged_launches=paged,
                flash_by_path={f"llm_{k}": v["flash"] for k, v in parts.items()})


def build_kernels() -> dict:
    """Phase 2: one nvcc per source, all started together; {name: log}."""
    from tpustack_torch.ops import _build

    logs, errors = {}, []

    def one(name):
        try:
            logs[name] = _build.build(name)
        except Exception as e:  # reported below, after every build has ended
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in ("flash_attention",
                                                                 "paged_attention")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return logs


def sass_counts(name: str) -> dict:
    """{instruction: count} in the built library's SASS (``cuobjdump -sass``),
    or {} when no ``cuobjdump`` is found."""
    from tpustack_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", _build._lib_path(name)], capture_output=True,
                          text=True, check=True).stdout
    ops = re.findall(r"\b(HGMMA|UTMALDG|SYNCS|HMMA)\b", sass)
    return {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "SYNCS", "HMMA")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    sm_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"], capture_output=True,
                                  text=True, check=True).stdout.split()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}; max SM clock {sm_mhz:.0f} MHz")

    # phase 2: build every kernel of the paths, in parallel
    t0 = time.perf_counter()
    logs = build_kernels()
    log(f"kernels built in {time.perf_counter() - t0:.2f}s")
    # ptxas: registers and spills per instantiation
    for name, text in logs.items():
        log("\n".join(f"{name}: {ln.strip()}" for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln))
    # both kernels' main loops are wgmma fed by TMA, with no mma.sync left
    sass = {}
    for name in ("flash_attention", "paged_attention"):
        sass[name] = sass_counts(name)
        if not sass[name]:
            log(f"{name} SASS: not counted (no cuobjdump beside nvcc or on PATH)")
        else:
            log(f"{name} SASS instructions: {sass[name]}")
            assert (sass[name]["HGMMA"] > 0 and sass[name]["UTMALDG"] > 0
                    and sass[name]["HMMA"] == 0), (name, sass[name])

    walls = {"2 build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        log(f"phase {name}: {walls[name]:.1f} s wall")
        return out

    # phase 3: kernels vs their twins (the LLM's flash shapes after phase 4b)
    records = timed("3 flash", phase_kernels, torch, FLASH_CASES, sm_mhz)
    paged_records = timed("3 paged", phase_paged_kernels, torch)

    # phase 4: the SD1.5 path; each path's models are freed before the next loads
    main_path = timed("4 sd15", phase_main_path, torch)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4b: the LLM path
    llm = timed("4b llm", phase_llm, torch)
    gc.collect()
    torch.cuda.empty_cache()
    records += timed("3 flash llm", phase_kernels, torch,
                     llm_flash_cases(llm["prefix_hit_tokens"]) + LLM_STREAM_CASES, sm_mhz)

    # phase 4e: the LLM engine's modes on phase 4b's model, then free it
    modes = timed("4e llm modes", phase_llm_modes, torch, llm.pop("gen"), llm.pop("tok"))
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4d: the deployed LLM configuration (int8 weights and KV, QoS)
    llm8 = timed("4d llm int8", phase_llm_int8, torch, llm["e2e"])
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4c: the Wan T2V path
    wan = timed("4c wan", phase_wan, torch)
    gc.collect()
    torch.cuda.empty_cache()

    # phase 5: the kernels line, each at its main path's most frequent shape
    head = records[0]
    detail = [{k: r[k] for k in ("label", "shape_q", "shape_kv", "kw", "path", "ms",
                                 "call_ms", "plain_ms", "library_ms", "library_call", "bound_ms",
                                 "bound_by", "exp_bound_ms", "max_abs_err", "rel_l2")}
              for r in records]
    paged_head = paged_records[0]
    paged_detail = [{k: r[k] for k in ("label", "shape_q", "shape_pool", "int8", "ms",
                                       "call_ms", "plain_ms", "gather_ms", "bound_ms", "bound_by",
                                       "share_of_bound", "max_abs_err", "rel_l2", "m_err",
                                       "l_rel")}
                    for r in paged_records]
    # flash launches by the TPU kernel each stands for: the panel route
    # (row 1, _attn_kernel) and the streaming route (row 2,
    # _attn_kernel_stream); the SD1.5, Wan and int8 paths run the panel only
    panel_by_path = {"sd15": main_path["launches"], "llm": llm["flash_routes"]["panel"],
                     "llm_int8": llm8["flash_launches"], "wan": wan["launches"]}
    stream_by_path = {"llm": llm["flash_routes"]["stream"]}
    for path, routes in modes["flash_by_path"].items():
        panel_by_path[path] = routes["panel"]
        stream_by_path[path] = routes["stream"]
    stream_records = [r for r in records if r["kw"].get("kv_len") is not None]
    stream_head = next(r for r in stream_records if r["path"] == "llm_chunked")

    def flash_entry(name, replaces, head, recs, by_path):
        return {
            "name": name, "route": "cuda", "source": KERNEL_SRC, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "ok": all(r["ok"] for r in recs),  # every shape within ATOL/RTOL and REL_L2
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "rel_l2": max(r["rel_l2"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "exp_bound_ms": head["exp_bound_ms"], "sm_clock_mhz": sm_mhz,
            "shape": head["label"],
            "shapes": [d for d in detail if d["label"] in {r["label"] for r in recs}],
            "sass": sass["flash_attention"],
        }

    kernels = [
        flash_entry("flash_attention", KERNEL_REPLACES, head,
                    [r for r in records if r not in stream_records], panel_by_path),
        flash_entry("flash_attention_stream", KERNEL_ALSO_REPLACES, stream_head,
                    stream_records, stream_by_path),
        {
            "name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
            "replaces": PAGED_REPLACES,
            "launches": llm["paged_launches"] + llm8["paged_launches"] + modes["paged_launches"],
            "launches_by_path": {"llm": llm["paged_launches"], "llm_int8": llm8["paged_launches"],
                                 "llm_modes": modes["paged_launches"]},
            "launches_by_step": llm["paged_launches_by_step"],
            "launches_by_step_int8": llm8["paged_launches_by_step"],
            "ok": all(r["ok"] for r in paged_records),
            "max_abs_err": max(r["max_abs_err"] for r in paged_records),
            "rel_l2": max(r["rel_l2"] for r in paged_records),
            "ms": paged_head["ms"], "plain_ms": paged_head["plain_ms"],
            "bound_ms": paged_head["bound_ms"], "bound_by": paged_head["bound_by"],
            "library_ms": None, "gather_ms": paged_head["gather_ms"],
            "shape": paged_head["label"], "shapes": paged_detail,
            "sass": sass["paged_attention"],
        }]
    log(json.dumps({"sd15": {k: main_path[k] for k in ("s_per_image_b1", "images_per_s_b8",
                                                       "s_per_image_1024", "dispatches",
                                                       "unet_rel_l2")},
                    "llm": llm["e2e"], "llm_int8": llm8["e2e"], "llm_modes": modes["parts"],
                    "wan": wan["e2e"], "card": smi,
                    "phase_wall_s": walls}))
    log(json.dumps({"kernels": kernels}))  # the line before the last
    # phase 6
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
