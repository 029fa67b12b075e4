#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases, in order; any failure exits non-zero and prints no result line:

1. The card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
2. Build the CUDA kernels from the sources in ``tpustack_torch/ops/csrc``
   (one ``nvcc`` per source, all started together).
3. Each kernel against its plain PyTorch twin on the card, in bf16, at the
   shapes the SD1.5 path gives it plus causal/GQA/offset and ragged cases;
   per shape the kernel's, the twin's and one PyTorch library call's times
   and the least time the card could take (``bound_ms``).
4. The main path: the port's SD1.5 server in-process at full width
   (``SD15Config.sd15()``, bf16, weights drawn from a seed), one
   ``POST /generate`` at 512x512x30 steps, then 8 concurrent requests that
   ride one micro-batch; PNGs, headers and image content checked, and the
   kernel launch counts read across exactly that run.  Then one full-width
   UNet evaluation with the kernel against the same evaluation on the plain
   attention path, and a torch.profiler breakdown of one UNet evaluation at
   batch 1 and 8 (wall, device kernel time, idle share, top kernels).
5. A JSON line of the end-to-end numbers, then, as the line before the last,
   one JSON line listing every kernel with its numbers.
6. The last line: ``{"ok": true, "device": {...}}``.

Peaks for ``bound_ms`` are the published H100 SXM figures (989 TFLOP/s
dense bf16, 3.35 TB/s HBM3); the card's power limit is printed beside them.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel vs its float32 twin.  Both round the output to bf16 (one ulp is at
# most 2^-7 relative) and the kernel also rounds P to bf16 before P.V; with
# N(0,1) inputs a typical output is ~0.03 at 4096 keys, so the absolute limit
# sits near a tenth of that and a relative-L2 limit catches faults spread thin
# over every row (a dropped K tile, a wrong rescale) that max |err| would not.
ATOL, RTOL = 4e-3, 1e-2
REL_L2 = 1e-2  # ||out - ref|| / ||ref|| per shape
STEPS, SIZE, BATCH = 30, 512, 8
DEVICE = "cuda"
KERNEL_SRC = "tpustack_torch/ops/csrc/flash_attention.cu"
KERNEL_REPLACES = "tpustack/ops/pallas/flash_attention.py:38"
KERNEL_ALSO_REPLACES = "tpustack/ops/pallas/flash_attention.py:88"


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


def attention_bound(b, sq, sk, h, hkv, d, causal, q_offset, kv_len):
    """(ms, "operations" | "bytes"): the least time for the work these
    inputs need: 4*D flops per valid (row, key) pair per head, and each
    needed input byte read once and the output written once (bf16)."""
    rows = [min(kv_len, q_offset + i + 1) if causal else kv_len for i in range(sq)]
    pairs = sum(max(r, 0) for r in rows)
    keys = max(rows) if rows else 0
    flops = 4.0 * b * h * pairs * d
    nbytes = 2.0 * (2 * b * sq * h * d + 2 * b * keys * hkv * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, dict(r.headers), r.read()


def get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def phase_kernels(torch):
    """Phase 3: kernel vs twin on the card; returns per-shape records."""
    import torch.nn.functional as F

    from tpustack_torch.ops.flash_attention import flash_attention, flash_attention_ref

    cases = [  # (label, q shape, kv shape, kwargs, on the SD1.5 path)
        ("sd15 level0 b1", (2, 4096, 8, 40), (2, 4096, 8, 40), {}, True),
        ("sd15 level0 b8", (16, 4096, 8, 40), (16, 4096, 8, 40), {}, True),
        ("sd15 level1 b1", (2, 1024, 8, 80), (2, 1024, 8, 80), {}, True),
        ("sd15 level1 b8", (16, 1024, 8, 80), (16, 1024, 8, 80), {}, True),
        ("causal gqa offset", (1, 512, 8, 64), (1, 2048, 2, 64),
         dict(causal=True, q_offset=1024, kv_len=1536), False),
        ("ragged", (1, 77, 8, 40), (1, 300, 8, 40), {}, False),
    ]
    g = torch.Generator("cuda").manual_seed(0)
    records = []
    for label, qs, ks, kw, on_path in cases:
        q, k, v = (torch.randn(s, generator=g, device="cuda").bfloat16() for s in (qs, ks, ks))
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = flash_attention_ref(q, k, v, **kw)
        diff = out.float() - ref.float()
        err = diff.abs().max().item()
        rel = (diff.norm() / ref.float().norm().clamp_min(1e-30)).item()
        ok = torch.allclose(out.float(), ref.float(), atol=ATOL, rtol=RTOL) and rel < REL_L2
        b, sq, h, d = qs
        sk, hkv = ks[1], ks[2]
        off, klen = kw.get("q_offset", 0), kw.get("kv_len", sk)
        bound_ms, bound_by = attention_bound(b, sq, sk, h, hkv, d, kw.get("causal", False),
                                             off, klen)
        rec = dict(label=label, shape_q=list(qs), shape_kv=list(ks), max_abs_err=err, rel_l2=rel,
                   ok=bool(ok), on_sd15_path=on_path, bound_ms=bound_ms, bound_by=bound_by)
        iters = 20 if b * sq * sk > 1e8 else 50
        rec["ms"] = cuda_ms(lambda: flash_attention(q, k, v, **kw), iters)
        rec["plain_ms"] = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), 3)
        # the library yardstick: one SDPA call (timed here, never used by the port)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if kw:
            rows = torch.arange(sq, device="cuda")[:, None] + off
            cols = torch.arange(sk, device="cuda")[None, :]
            mask = (cols < klen) & (cols <= rows)  # the offset case is causal
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=hkv != h), iters)
        del ref, out
        torch.cuda.empty_cache()
        log(f"kernel flash_attention {label}: q {list(qs)} kv {list(ks)} {kw or ''} "
            f"max_abs_err={err:.3e} (atol {ATOL}, rtol {RTOL}) rel_l2={rel:.3e} "
            f"(limit {REL_L2}) {'OK' if ok else 'MISMATCH'} "
            f"kernel_ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f}")
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
        flash_attention.launches = 0
        # one request, alone
        status, headers, png1 = post(url + "/generate", {
            "prompt": "a lighthouse on a cliff at dusk, oil painting",
            "steps": STEPS, "width": SIZE, "height": SIZE, "seed": 1})
        # eight concurrent requests with one signature: one micro-batch
        server.batch_window_s = 10.0
        results = [None] * BATCH

        def send(i):
            results[i] = post(url + "/generate", {
                "prompt": f"a red fox in the snow, study {i}", "steps": STEPS,
                "width": SIZE, "height": SIZE, "seed": 100 + i})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        launches = flash_attention.launches
        last_status, last_png = get(url + "/last")
        health_status, health = get(url + "/healthz")
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
    sizes = [n for n, _ in server.batch_log]
    assert sizes == [1, BATCH], f"dispatches {sizes}: the 8 requests did not share one batch"
    per_eval = 10  # attn1 at UNet levels 0 and 1: 4 down + 6 up
    expected = per_eval * STEPS * len(sizes)
    log(f"main path: {len(sizes)} dispatches {sizes}, flash_attention launches "
        f"{launches} (expected {per_eval} x {STEPS} steps x {len(sizes)} = {expected})")
    assert launches == expected, (launches, expected)
    s1, s8 = server.batch_log[0][1], server.batch_log[1][1]
    log(f"main path: batch 1 {s1:.3f} s/image; batch {BATCH} {s8:.3f} s -> "
        f"{BATCH / s8:.3f} images/s; X-Gen-Time {gen_times}")

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
    return dict(launches=launches, s_per_image_b1=s1, images_per_s_b8=BATCH / s8,
                dispatches=sizes, unet_rel_l2=rel)


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
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")

    # phase 2: build every kernel of the path
    from tpustack_torch.ops import _build

    t0 = time.perf_counter()
    text = _build.build("flash_attention")
    log(f"kernels built in {time.perf_counter() - t0:.2f}s")
    # ptxas: registers and spills per instantiation
    log("\n".join(f"flash_attention: {ln.strip()}" for ln in text.splitlines()
                  if "registers" in ln or "spill" in ln))

    # phase 3: kernels vs their twins
    records = phase_kernels(torch)

    # phase 4: the main path
    main_path = phase_main_path(torch)

    # phase 5: the kernels line, at the main path's batch-1 level-0 shape
    head = records[0]
    detail = [{k: r[k] for k in ("label", "shape_q", "shape_kv", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "max_abs_err", "rel_l2")}
              for r in records]
    kernels = [{
        "name": "flash_attention", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES, "also_replaces": KERNEL_ALSO_REPLACES,
        "launches": main_path["launches"],
        "ok": all(r["ok"] for r in records),  # every shape within ATOL/RTOL and REL_L2
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "rel_l2": max(r["rel_l2"] for r in records),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": head["label"], "shapes": detail,
    }]
    log(json.dumps({"sd15": {k: main_path[k] for k in ("s_per_image_b1", "images_per_s_b8",
                                                       "dispatches", "unet_rel_l2")},
                    "card": smi}))
    log(json.dumps({"kernels": kernels}))  # the line before the last
    # phase 6
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
