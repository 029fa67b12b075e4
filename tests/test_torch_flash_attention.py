"""The port's flash attention and attention ops against the JAX package.

``flash_attention_ref`` (the plain twin of the CUDA kernel, and the wrapper's
CPU path) is held to the JAX Pallas ``flash_attention`` run in interpret mode
on the CPU, on the same numpy inputs, in float32.  Tolerance 2e-5 absolute:
both compute float32 softmax attention and differ only in summation order
(the Pallas kernel's exp2 with log2(e) folded into the q tile included),
which at these sizes stays near 1e-6 on outputs of order 1 — the same bound
``tests/test_flash_attention.py`` holds the Pallas kernel to.

The CUDA kernel itself runs only on the card: see
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustack.ops.pallas.flash_attention as jfa
from tpustack.ops.attention import dot_product_attention as jax_dpa
from tpustack_torch.ops.attention import auto_impl, dot_product_attention
from tpustack_torch.ops.flash_attention import flash_attention, flash_attention_ref

ATOL = 2e-5


def _inputs(seed, b, sq, sk, h, hkv, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, hkv, d).astype(np.float32)
    v = rng.randn(b, sk, hkv, d).astype(np.float32)
    return q, k, v


def _jax_flash(q, k, v, **kw):
    return np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True, **kw))


def _port(fn, q, k, v, **kw):
    return fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal", [
    (2, 64, 64, 2, 2, 40, False),    # SD1.5 head dim, non-causal
    (1, 64, 64, 2, 2, 80, False),    # SD1.5 level-1 head dim
    (2, 64, 64, 4, 4, 40, True),     # causal, sq == sk
    (1, 64, 64, 4, 2, 16, True),     # GQA
    (1, 64, 64, 4, 1, 16, False),    # MQA
    (1, 77, 300, 2, 2, 40, False),   # ragged: neither length a block multiple
    (1, 40, 40, 2, 2, 16, True),     # ragged causal
])
def test_ref_matches_jax_panel_kernel(b, sq, sk, h, hkv, d, causal):
    q, k, v = _inputs(sq + d, b, sq, sk, h, hkv, d)
    ref = _jax_flash(q, k, v, causal=causal)
    np.testing.assert_allclose(_port(flash_attention_ref, q, k, v, causal=causal), ref, atol=ATOL)
    # the wrapper's CPU path is the twin
    np.testing.assert_allclose(_port(flash_attention, q, k, v, causal=causal), ref, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ref_matches_jax_streaming_kernel(monkeypatch, causal):
    """K beyond PANEL_MAX_KV sends JAX to the k-streaming kernel; a tiny
    ceiling forces it at test size, as tests/test_flash_attention.py does."""
    monkeypatch.setattr(jfa, "PANEL_MAX_KV", 64)
    q, k, v = _inputs(7, 1, 96, 96, 2, 2, 40)
    ref = _jax_flash(q, k, v, causal=causal, block_q=32, block_k=32)
    np.testing.assert_allclose(_port(flash_attention_ref, q, k, v, causal=causal), ref, atol=ATOL)


@pytest.mark.parametrize("q_offset,kv_len,hkv", [(16, 32, 2), (0, 48, 4), (40, 64, 1)])
def test_ref_matches_jax_offset_and_kv_len(q_offset, kv_len, hkv):
    """Chunked-prefill scalars (the streaming kernel): q rows at global
    positions q_offset + i over the first kv_len keys, causal, GQA."""
    q, k, v = _inputs(q_offset + kv_len, 1, 16, 64, 4, hkv, 16)
    ref = _jax_flash(q, k, v, causal=True, block_q=16, block_k=16,
                     q_offset=q_offset, kv_len=kv_len)
    got = _port(flash_attention_ref, q, k, v, causal=True, q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_ref_noncausal_kv_len_and_empty_rows():
    q, k, v = _inputs(3, 1, 32, 64, 2, 2, 16)
    ref = _jax_flash(q, k, v, block_q=16, block_k=16, kv_len=20)
    np.testing.assert_allclose(_port(flash_attention_ref, q, k, v, kv_len=20), ref, atol=ATOL)
    # a row with no valid key returns 0 (the kernel's acc / max(l, 1e-30))
    got = _port(flash_attention_ref, q, k, v, kv_len=0)
    assert np.array_equal(got, np.zeros_like(got))


@pytest.mark.parametrize("mask_shape", [(32, 48), (1, 1, 32, 48), (2, 4, 32, 48), (2, 2, 32, 48)])
def test_dot_product_attention_masks_match_jax(mask_shape):
    """The plain ("xla") path with 2D and 4D masks, GQA 4q/2kv unexpanded."""
    q, k, v = _inputs(11, 2, 32, 48, 4, 2, 16)
    mask = np.random.RandomState(12).rand(*mask_shape) > 0.3
    ref = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask)))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_flash_ref_matches_masked_dot_product_attention():
    """The twin against the port's own plain path with the equivalent 4D mask."""
    q, k, v = _inputs(13, 1, 16, 64, 4, 2, 16)
    rows = 16 + np.arange(16)[None, None, :, None]
    cols = np.arange(64)[None, None, None, :]
    mask = torch.from_numpy((cols <= rows) & (cols < 32))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = dot_product_attention(tq, tk, tv, mask=mask).numpy()
    got = flash_attention_ref(tq, tk, tv, causal=True, q_offset=16, kv_len=32).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("sq,sk,impl", [(24, 96, "flash"), (24, 96, "xla"), (64, 64, "xla")])
def test_dot_product_attention_causal_matches_jax(sq, sk, impl):
    """causal with sq != sk is bottom-right aligned on both paths."""
    q, k, v = _inputs(sq, 1, sq, sk, 2, 2, 16)
    ref = np.asarray(jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, impl="xla"))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                causal=True, impl=impl).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_dot_product_attention_rejects():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="ambiguous"):
        dot_product_attention(q, q, q, mask=torch.ones(1, 8, 8, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        dot_product_attention(q, q, q, mask=torch.ones(8, 8, dtype=torch.bool), impl="flash")
    with pytest.raises(ValueError, match="sq"):
        dot_product_attention(q, q[:, :4], q[:, :4], causal=True, impl="flash")
    with pytest.raises(ValueError, match="unknown"):
        dot_product_attention(q, q, q, impl="sdpa")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros(1, 8, 3, 16), q, q)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("args,want", [
    ((4096, 4096, False, "cuda", BF16, 40), "flash"),   # SD1.5 level 0 self-attention
    ((1024, 1024, False, "cuda", BF16, 80), "flash"),   # level 1
    ((256, 256, False, "cuda", BF16, 160), "xla"),      # level 2 / mid: too short
    ((4096, 77, False, "cuda", BF16, 40), "xla"),       # cross-attention: 77 keys
    ((4096, 4096, True, "cuda", BF16, 40), "xla"),      # masked
    ((4096, 4096, False, "cpu", BF16, 40), "xla"),      # no kernel off the card
    ((4096, 4096, False, "cuda", F32, 40), "xla"),      # the kernel takes bf16 only
    ((32768, 32768, False, "cuda", BF16, 128), "flash"),  # no panel ceiling on Hopper
    ((1024, 256, False, "cuda", BF16, 64), "flash"),    # both bounds inclusive
    ((1023, 4096, False, "cuda", BF16, 64), "xla"),
    # head dims: SD1.5 1024x1024 level 2 is [B, 1024, 8, 160], above the
    # kernel's 128; D=128 (Qwen2.5, the Wan DiT) is the kernel's widest
    ((1024, 1024, False, "cuda", BF16, 160), "xla"),
    ((1024, 1024, False, "cuda", BF16, 128), "flash"),
    ((4096, 4096, False, "cuda", BF16, 136), "xla"),
    ((4096, 4096, False, "cuda", BF16, 36), "xla"),     # not a multiple of 8
])
def test_auto_impl_rule(args, want):
    assert auto_impl(*args) == want


def test_auto_on_cpu_takes_plain_path_and_never_counts():
    q, k, v = map(torch.from_numpy, _inputs(5, 1, 1024, 256, 1, 1, 8))
    before = flash_attention.launches
    out = dot_product_attention(q, k, v, impl="auto")
    flash_attention(q, k, v)  # CPU tensors: the twin, not a launch
    assert flash_attention.launches == before
    np.testing.assert_allclose(out.numpy(), flash_attention_ref(q, k, v).numpy(), atol=ATOL)
