#!/usr/bin/env python3
"""Builds of the flash-attention kernel compared on one CUDA card, in turns.

    python3 flash_ab.py NAME=[@SOURCE] [NVCC FLAGS ...] ... [--faults] [--test-cases]
                        [--no-timing]

Each ``NAME=...`` builds ``tpustack_torch/ops/csrc/flash_attention.cu`` (or
``SOURCE``, a copy that sits beside its own ``hopper.cuh``) with the port's
nvcc flags plus the given ones into ``build/flash_ab/``, one ``nvcc`` per
build, all started together, and prints each build's spills and ptxas'
performance notes.  With no ``NAME=`` the source is built as it is.
``--faults`` adds two planted faults, built from copies of the kernel under
``build/flash_ab/``: the last K/V tile of every work tile skipped, and the
rescale of O by the running max dropped.

Every build is then held to the plain twin at ``chip_smoke.py``'s flash
shapes (with ``--test-cases`` also at ``tests/test_torch_kernels_gpu.py``'s)
and, unless ``--no-timing``, timed in two rounds of turns beside one SDPA
call (``chip_smoke.cuda_ms``).  Output: the card's name and power limit,
then one JSON line per shape with, per build, the relative L2 against the
twin, whether it is within ``chip_smoke.py``'s limits, and its times in ms.
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


def planted_faults() -> dict:
    """{name: [@source]} for copies of the kernel with one fault each."""
    from tpustack_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    with open(os.path.join(_build.CSRC_DIR, "hopper.cuh")) as f:
        header = f.read()
    out = {}
    for name, old, new in FAULTS:
        if old not in src:
            raise SystemExit(f"fault {name}: its line is not in the kernel any more")
        d = os.path.join(OUT_DIR, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(src.replace(old, new))
        with open(os.path.join(d, "hopper.cuh"), "w") as f:
            f.write(header)
        out[name] = ["@" + os.path.join(d, "flash_attention.cu")]
    return out


def build_all(variants: dict) -> dict:
    """{name: the loaded C entry}; one nvcc per build, started together."""
    from tpustack_torch.ops import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    libs, logs = {}, {}

    def one(name, flags):
        src = os.path.join(_build.CSRC_DIR, "flash_attention.cu")
        if flags and flags[0].startswith("@"):
            src, flags = flags[0][1:], flags[1:]
        out = os.path.join(OUT_DIR, f"{name}.so")
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
    fns = {}
    for name in variants:
        lines = logs[name].splitlines()
        spills = [ln.strip() for ln in lines if "spill" in ln and " 0 bytes spill" not in ln]
        notes = sorted({ln.split("Loss:", 1)[1].strip()[:100] for ln in lines if "Loss:" in ln})
        print(f"build {name}: {'ok' if name in libs else 'FAILED'}; spills {len(spills)}; "
              f"ptxas performance notes {notes}", flush=True)
        if name not in libs:
            print(logs[name][-4000:])
            raise SystemExit(f"build {name} failed")
        fn = ctypes.CDLL(libs[name]).tpst_flash_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


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
    if "--faults" in argv:
        variants.update(planted_faults())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    fns = build_all(variants)
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
