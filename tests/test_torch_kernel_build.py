"""Host-side pieces around the port's CUDA kernels, on the CPU.

``ops/_build.py`` names each library by a hash of what it is compiled from:
the kernel's ``.cu``, every shared ``csrc/*.cuh`` header (the flash kernel
includes ``hopper.cuh``) and the flags, so an edit to any of them rebuilds.
``chip_smoke.py``'s bounds and its SDPA yardstick are plain arithmetic and
plain PyTorch: the bounds are checked against hand-computed values, and each
yardstick variant against the flash kernel's twin (float32, 1e-5: the same
function, another summation order).
"""

import importlib.util
import os

import pytest
import torch

from tpustack_torch.ops import _build
from tpustack_torch.ops.flash_attention import flash_attention_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lib_path_hashes_source_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    first = _build._lib_path("k")
    assert os.path.basename(first).startswith("k-") and first.endswith(".so")
    assert _build._lib_path("k") == first
    (tmp_path / "notes.txt").write_text("edited\n")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "extra.cuh").write_text("// new header\n")
    third = _build._lib_path("k")
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second, third)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-DX=1"])
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "extra.cuh").unlink()
    assert _build._lib_path("k") != second


def test_real_sources_hash_the_shared_header():
    assert os.path.exists(os.path.join(_build.CSRC_DIR, "hopper.cuh"))
    for name in ("flash_attention", "paged_attention"):
        assert _build._lib_path(name).startswith(_build.BUILD_DIR)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    real_exists = os.path.exists
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p == "/usr/local/cuda/bin/nvcc" else real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_attention")


@pytest.mark.parametrize("b,sq,h,causal,off,klen,want_exps", [
    (2, 4096, 8, False, 0, 4096, 2 * 8 * 4096 * 4096),
    (1, 4, 2, True, 0, 4, 2 * (1 + 2 + 3 + 4)),
    (1, 4, 1, True, 2, 5, 3 + 4 + 5 + 5),      # offset rows, capped by kv_len
    (1, 3, 1, True, -2, 8, 0 + 0 + 1),         # rows before the first key
])
def test_exp_bound_counts_valid_pairs(b, sq, h, causal, off, klen, want_exps):
    smoke = _smoke()
    ms = smoke.exp_bound(b, sq, h, causal, off, klen, 1980.0)
    assert ms == pytest.approx(want_exps / (16 * 132 * 1980e6) * 1e3)


def test_bounds_at_the_sd15_level0_shape():
    """The numbers PERF.md quotes: 0.0434 ms on the tensor cores, 0.0642 ms
    of exponentials at 1980 MHz, for [2,4096,8,40]."""
    smoke = _smoke()
    ms, by = smoke.attention_bound(2, 4096, 4096, 8, 8, 40, False, 0, 4096)
    assert by == "operations" and ms == pytest.approx(4 * 2 * 8 * 4096 * 4096 * 40 / 989e12 * 1e3)
    assert round(ms, 4) == 0.0434
    assert round(smoke.exp_bound(2, 4096, 8, False, 0, 4096, 1980.0), 4) == 0.0642


@pytest.mark.parametrize("qs,ks,kw,name", [
    ((1, 24, 4, 16), (1, 24, 4, 16), {}, "sdpa"),
    ((1, 24, 4, 16), (1, 24, 2, 16), dict(causal=True), "sdpa is_causal"),
    ((1, 16, 4, 16), (1, 64, 2, 16), dict(causal=True, q_offset=8, kv_len=24),
     "sdpa lower-right"),
    ((1, 16, 4, 16), (1, 64, 2, 16), dict(kv_len=40), "sdpa bool mask"),
    ((1, 16, 2, 16), (1, 64, 1, 16), dict(causal=True, q_offset=30, kv_len=40),
     "sdpa bool mask"),
])
def test_library_yardstick_computes_the_same_function(qs, ks, kw, name):
    smoke = _smoke()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in (qs, ks, ks))
    fn, got_name = smoke.library_attention(torch, q, k, v, kw)
    assert got_name == name
    out = fn().transpose(1, 2)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, **kw), atol=1e-5, rtol=1e-5)


def test_llm_flash_cases_follow_the_prefix_hit():
    smoke = _smoke()
    (_, q0, k0, kw0, p0), (_, q1, k1, kw1, p1) = smoke.llm_flash_cases(320)
    assert p0 == p1 == "llm"
    assert q0 == (1, 2048, 28, 128) and k0 == (1, 2048, 4, 128) and kw0 == dict(causal=True)
    assert q1[1] == 1024 and k1[1] == 4096
    assert kw1 == dict(causal=True, q_offset=320, kv_len=320 + 1024)


def test_flash_ab_planted_faults_match_the_kernel():
    """``flash_ab.py --faults`` edits one spot of the kernel per fault; each
    spot must still be in the source, once."""
    spec = importlib.util.spec_from_file_location("flash_ab", os.path.join(REPO, "flash_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(_build.CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    assert [name for name, _, _ in mod.FAULTS] == ["skip_last_tile", "no_rescale"]
    for name, old, new in mod.FAULTS:
        assert src.count(old) == 1, name
        assert src.replace(old, new) != src


def test_flash_ab_planted_paged_faults_match_the_kernel():
    """The same for ``flash_ab.py --paged --faults`` and the paged kernel."""
    spec = importlib.util.spec_from_file_location("flash_ab", os.path.join(REPO, "flash_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(_build.CSRC_DIR, "paged_attention.cu")) as f:
        src = f.read()
    assert [name for name, _, _ in mod.PAGED_FAULTS] == [
        "merge_drops_a_piece", "no_rescale", "no_k_scale", "length_mask_off_by_one",
        "counter_left_unreset"]
    for name, old, new in mod.PAGED_FAULTS:
        assert src.count(old) == 1, name
        assert src.replace(old, new) != src


def _paged_twin_inputs(smoke, lens):
    q, pk, pv, bt, ln, _, _ = smoke.paged_inputs(torch, 4, 2, 8, 2, 16, 40, 16, 128, False,
                                                 lens=lens)
    return q.float(), pk.float(), pv.float(), bt, ln


@pytest.mark.parametrize("lens", [None, [0, 0, 0, 0], [128, 0, 0, 0]],
                         ids=["ragged", "all empty", "one full"])
def test_paged_check_passes_the_twin_and_fails_a_dropped_tile(lens):
    """``chip_smoke.paged_check`` holds the kernel to its twin; it takes the
    twin itself, rows without keys included, and refuses a partial that lost
    its last key tile."""
    from tpustack_torch.ops.paged_attention import paged_attention_partial_ref

    smoke = _smoke()
    smoke.DEVICE = "cpu"
    q, pk, pv, bt, ln = _paged_twin_inputs(smoke, lens)
    ref = paged_attention_partial_ref(q, pk, pv, bt, ln)
    ok, chk = smoke.paged_check(torch, ref, ref)
    assert ok and chk["rel_l2"] == 0 and chk["empty_ok"]
    if int(ln.max()) > 64:
        short = paged_attention_partial_ref(q, pk, pv, bt, (ln - 64).clamp_min(0).int())
        assert not smoke.paged_check(torch, short, ref)[0]


def test_paged_bound_counts_the_valid_blocks():
    smoke = _smoke()
    ms, by = smoke.paged_bound(8, 1, 28, 4, 128, [4096] + [0] * 7, 64, 64, False)
    want = (64 * 64 * 4 * 2 * 128 * 2 + 8 * 28 * 128 * 2 + 8 * 64 * 4 + 8 * 4
            + 8 * 28 * 130 * 4) / 3.35e12 * 1e3
    assert by == "bytes" and ms == pytest.approx(want)
