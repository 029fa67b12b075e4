#!/usr/bin/env python3
"""Builds of the port's attention kernels compared on one CUDA card, in turns.

    python3 flash_ab.py NAME=[@SOURCE] [NVCC FLAGS ...] ... [--faults] [--test-cases]
                        [--no-timing]
    python3 flash_ab.py --paged NAME=[@SOURCE] [NVCC FLAGS ...] ... [--faults]
                        [--test-cases] [--no-timing]

Each ``NAME=...`` builds ``tpustack_torch/ops/csrc/flash_attention.cu`` (with
``--paged``: ``paged_attention.cu``), or ``SOURCE``, a copy that sits beside
its own ``hopper.cuh`` where it includes one, with the port's nvcc flags plus
the given ones into ``build/flash_ab/``, one ``nvcc`` per build, all started
together, and prints each build's spills and ptxas' performance notes.  With
no ``NAME=`` the source is built as it is.  ``--faults`` adds planted
faults, built from copies of the kernel under ``build/flash_ab/``: for flash
the last K/V tile of every work tile skipped and the rescale of O by the
running max dropped; for paged the five of ``PAGED_FAULTS``.

Flash: every build is held to the plain twin at ``chip_smoke.py``'s flash
shapes (with ``--test-cases`` also at ``tests/test_torch_kernels_gpu.py``'s)
and, unless ``--no-timing``, timed in two rounds of turns beside one SDPA
call (``chip_smoke.cuda_ms``).

Paged: every build is called twice per shape at ``chip_smoke.py``'s paged
shapes (with ``--test-cases`` also the gpu test file's paged cases); both
calls are held to the twin at ``chip_smoke.paged_check``'s limits and must
agree bit for bit.  Unless ``--no-timing``, ``chip_smoke.py``'s paged
shapes are timed as device time replayed from a CUDA graph
(``chip_smoke.device_ms``) in turns A, B, ..., B, A.  A source holding the
split-plan kernel of the port's second slice (it takes ``tiles_per_split``)
is called through that kernel's own C entry and plan, so it can be the A
side; take it from git, which the card's machine does not have, before the
call:

    mkdir -p build/paged_ab && git show e81180c:tpustack_torch/ops/csrc/paged_attention.cu \
        > build/paged_ab/paged_attention.cu
    python3 flash_ab.py --paged old=@build/paged_ab/paged_attention.cu new=

Output: the card's name and power limit, then one JSON line per shape with,
per build, the relative L2 against the twin, whether it is within
``chip_smoke.py``'s limits, and its times in ms.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading

OUT_DIR = os.path.join("build", "flash_ab")
# (name, the line of the kernel that changes, what it becomes)
FAULTS = [
    ("skip_last_tile",
     "wk.n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;",
     "wk.n_tiles = limit > 0 ? (limit + BK - 1) / BK - 1 : 0;"),
    ("no_rescale",
     "        acc[4 * j + 0] *= alpha0;\n        acc[4 * j + 1] *= alpha0;\n"
     "        acc[4 * j + 2] *= alpha1;\n        acc[4 * j + 3] *= alpha1;\n",
     ""),
]


PAGED_FAULTS = [
    ("merge_drops_a_piece",
     "x[e][j] = k + j < kn\n",
     "x[e][j] = k + j < kn - (k0 + kn == np ? 1 : 0)\n"),
    ("no_rescale",
     "        acc[4 * j + 0] *= alpha0;\n        acc[4 * j + 1] *= alpha0;\n"
     "        acc[4 * j + 2] *= alpha1;\n        acc[4 * j + 3] *= alpha1;\n",
     ""),
    ("no_k_scale",
     "            v0 *= ksc;\n            v1 *= ksc;\n",
     ""),
    ("length_mask_off_by_one",
     "if (last && kv0 + col >= len)",
     "if (last && kv0 + col > len)"),
    ("counter_left_unreset",
     "if (tid == 0) P.counters[pair] = 0;",
     ""),
]


def planted_faults(kernel: str, faults) -> dict:
    """{name: [@source]} for copies of the kernel with one fault each."""
    from tpustack_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, f"{kernel}.cu")) as f:
        src = f.read()
    with open(os.path.join(_build.CSRC_DIR, "hopper.cuh")) as f:
        header = f.read()
    out = {}
    for name, old, new in faults:
        if old not in src:
            raise SystemExit(f"fault {name}: its line is not in the kernel any more")
        d = os.path.join(OUT_DIR, f"{kernel}_{name}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{kernel}.cu"), "w") as f:
            f.write(src.replace(old, new))
        with open(os.path.join(d, "hopper.cuh"), "w") as f:
            f.write(header)
        out[name] = ["@" + os.path.join(d, f"{kernel}.cu")]
    return out


def build_all(variants: dict, kernel: str = "flash_attention") -> dict:
    """{name: (the loaded library, its source)}; one nvcc per build, started
    together."""
    from tpustack_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    libs, logs, sources = {}, {}, {}

    def one(name, flags):
        src = os.path.join(_build.CSRC_DIR, f"{kernel}.cu")
        if flags and flags[0].startswith("@"):
            src, flags = flags[0][1:], flags[1:]
        sources[name] = src
        out = os.path.join(OUT_DIR, f"{kernel}_{name}.so")
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", out, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs[name] = proc.stdout
        if proc.returncode == 0:
            libs[name] = out

    threads = [threading.Thread(target=one, args=kv) for kv in variants.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {}
    for name in variants:
        lines = logs[name].splitlines()
        spills = [ln.strip() for ln in lines if "spill" in ln and " 0 bytes spill" not in ln]
        notes = sorted({ln.split("Loss:", 1)[1].strip()[:100] for ln in lines if "Loss:" in ln})
        print(f"build {name}: {'ok' if name in libs else 'FAILED'}; spills {len(spills)}; "
              f"ptxas performance notes {notes}", flush=True)
        if name not in libs:
            print(logs[name][-4000:])
            raise SystemExit(f"build {name} failed")
        out[name] = (ctypes.CDLL(libs[name]), sources[name])
    return out


def flash_entries(builds: dict) -> dict:
    fns = {}
    for name, (lib, _) in builds.items():
        fn = lib.tpst_flash_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def split_plan_call(fn, q, pk, pv, bt, lens, ks, vs):
    """One call of the split-plan paged kernel (a partial kernel over key
    splits planned on the host, then a merge kernel), as its own wrapper
    made it: about 264 CUDA blocks over the table span."""
    import torch

    b, s, h, d = q.shape
    n_pool, blk, hkv, _ = pk.shape
    nb = bt.shape[1]
    tiles = -(-nb * blk // 64)
    want = max(1, min(tiles, -(-264 // max(1, b * hkv))))
    per = -(-tiles // want)
    nsplit = -(-tiles // per)
    rp = 16 * -(-(s * (h // hkv)) // 16)
    acc = torch.empty((b, s, h, d), device=q.device, dtype=torch.float32)
    m = torch.empty((b, s, h), device=q.device, dtype=torch.float32)
    l = torch.empty((b, s, h), device=q.device, dtype=torch.float32)
    ws = (None, None, None)
    if nsplit > 1:
        ws = (torch.empty((b * hkv * nsplit * rp * d,), device=q.device),
              torch.empty((b * hkv * nsplit * rp,), device=q.device),
              torch.empty((b * hkv * nsplit * rp,), device=q.device))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(q.data_ptr(), pk.data_ptr(), pv.data_ptr(), ptr(ks), ptr(vs), bt.data_ptr(),
             lens.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(), *map(ptr, ws), b, s,
             h, hkv, d, blk, nb, n_pool, int(ks is not None), per, nsplit, float(d ** -0.5),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"split-plan paged kernel: cudaError {err}")
    return acc, m, l


def paged_callers(builds: dict) -> dict:
    """{name: fn(q, pk, pv, bt, lens, ks, vs) -> (acc, m, l)} for each build,
    each through its own C entry."""
    import tpustack_torch.ops.paged_attention as pa

    calls = {}
    for name, (lib, src) in builds.items():
        fn = lib.tpst_paged_attention
        with open(src) as f:
            split_plan = "tiles_per_split" in f.read()
        if split_plan:
            fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                                          ctypes.c_void_p]
            fn.restype = ctypes.c_int
            calls[name] = lambda *a, fn=fn: split_plan_call(fn, *a)
        else:
            fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                          ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(q, pk, pv, bt, lens, ks, vs, fn=fn):
                pa._kernel = lambda: fn  # the wrapper's C entry, this build's
                return pa.paged_attention_partial(q, pk, pv, bt, lens, k_scale=ks, v_scale=vs)
            calls[name] = call
    return calls


def main_paged(argv, variants: dict) -> int:
    import torch

    import chip_smoke as smoke
    import tpustack_torch.ops.paged_attention as pa

    if "--faults" in argv:
        variants.update(planted_faults("paged_attention", PAGED_FAULTS))
    calls = paged_callers(build_all(variants, "paged_attention"))
    cases = [(c[0], c[1:10], c[11]) for c in smoke.PAGED_CASES]
    if "--test-cases" in argv:
        sys.path.insert(0, "tests")
        import test_torch_kernels_gpu as gpu_tests

        cases += [(f"test {c[0]}", c[1:], None) for c in gpu_tests.PAGED_CASES]
        cases += [(f"test {label}", case, lens) for label, case, lens in
                  gpu_tests.PAGED_EDGE_CASES]
    timing = "--no-timing" not in argv
    order = list(calls) + list(calls)[::-1]  # A, B, ..., B, A
    n_timed = len(smoke.PAGED_CASES)
    for i, (label, case, lens) in enumerate(cases):
        q, pk, pv, bt, ln, ks, vs = smoke.paged_inputs(torch, *case, lens=lens)
        ref = pa.paged_attention_partial_ref(q, pk, pv, bt, ln, k_scale=ks, v_scale=vs)
        row = {"label": label}
        for name, call in calls.items():
            pa._pair_counters(q.device.index).zero_()  # a faulty build may leave them dirty
            first = call(q, pk, pv, bt, ln, ks, vs)
            # NaN in the allocator's free blocks: an output left unwritten
            # must not pass on the bytes of an earlier build's call
            poison = [torch.full_like(t, float("nan")) for t in first for _ in range(4)]
            del poison
            second = call(q, pk, pv, bt, ln, ks, vs)
            torch.cuda.synchronize()
            ok, chk = smoke.paged_check(torch, second, ref)
            ok1, _ = smoke.paged_check(torch, first, ref)
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            row[name] = {"rel_l2": chk["rel_l2"], "m_err": chk["m_err"], "l_rel": chk["l_rel"],
                         "ok": bool(ok and ok1 and same), "bitwise_repeat": same, "ms": []}
        if timing and i < n_timed:
            for name in order:
                pa._pair_counters(q.device.index).zero_()
                row[name]["ms"].append(smoke.device_ms(
                    lambda call=calls[name]: call(q, pk, pv, bt, ln, ks, vs), 100))
        print(json.dumps(row), flush=True)
    return 0


def main(argv) -> int:
    import torch

    import chip_smoke as smoke
    import tpustack_torch.ops.flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device available", file=sys.stderr)
        return 1
    args = [a for a in argv if not a.startswith("--")]
    variants = {}
    for a in args:
        name, _, rest = a.partition("=")
        variants[name] = rest.split()
    variants = variants or {"kernel": []}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    if "--paged" in argv:
        return main_paged(argv, variants)
    if "--faults" in argv:
        variants.update(planted_faults("flash_attention", FAULTS))
    fns = flash_entries(build_all(variants))
    cases = smoke.FLASH_CASES + smoke.llm_flash_cases(256)
    if "--test-cases" in argv:
        sys.path.insert(0, "tests")
        import test_torch_kernels_gpu as gpu_tests

        cases += [(f"test {qs} {ks} {kw}", qs, ks, kw, None) for qs, ks, kw in gpu_tests.CASES]
    timing = "--no-timing" not in argv
    g = torch.Generator("cuda").manual_seed(0)
    for label, qs, ks, kw, _ in cases:
        q, k, v = (torch.randn(s, generator=g, device="cuda").bfloat16() for s in (qs, ks, ks))
        ref = fa.flash_attention_ref(q, k, v, **kw).float()
        iters = 20 if qs[0] * qs[1] * ks[1] > 1e8 else 50
        row = {"label": label}
        for _ in range(2 if timing else 1):
            for name, fn in fns.items():
                fa._kernel = lambda fn=fn: fn  # the wrapper's C entry, this build's
                out = fa.flash_attention(q, k, v, **kw).float()
                torch.cuda.synchronize()
                rel = ((out - ref).norm() / ref.norm().clamp_min(1e-30)).item()
                ok = torch.allclose(out, ref, atol=smoke.ATOL, rtol=smoke.RTOL) and (
                    rel < smoke.REL_L2)
                row[name] = {"rel_l2": rel, "ok": bool(ok),
                             "ms": row.get(name, {}).get("ms", [])}
                if timing:
                    row[name]["ms"].append(smoke.cuda_ms(
                        lambda: fa.flash_attention(q, k, v, **kw), iters))
            if timing:
                lib, row["library_call"] = smoke.library_attention(torch, q, k, v, kw)
                row.setdefault("library_ms", []).append(smoke.cuda_ms(lib, iters))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
