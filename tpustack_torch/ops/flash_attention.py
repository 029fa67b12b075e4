"""Flash attention: the hand-written Hopper kernel and its plain twin.

Counterpart of ``tpustack/ops/pallas/flash_attention.py:flash_attention``
(the Pallas ``_attn_kernel`` panel kernel and ``_attn_kernel_stream``).  On
Hopper one CUDA kernel (``csrc/flash_attention.cu``) serves both: it loops
over K/V tiles inside a block with an online-softmax carry, so there is no
VMEM-driven panel/streaming split and no ``PANEL_MAX_KV``.

:func:`flash_attention` launches the kernel for CUDA tensors, and raises when
it cannot; it never falls back.  For CPU tensors it runs
:func:`flash_attention_ref`, the plain PyTorch version of the same function,
which the tests hold against the JAX package and ``chip_smoke.py`` holds the
kernel against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

KERNEL = "flash_attention"


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[2]}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry, with its ctypes signature (built once)."""
    from tpustack_torch.ops import _build

    fn = _build.load(KERNEL).tpst_flash_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`, in float32.

    Keys ``j < kv_len`` are valid and, when ``causal``, only ``j <= q_offset
    + i`` for q row ``i``; a row with no valid key returns 0 (the kernel's
    ``acc / max(l, 1e-30)``).  GQA contracts grouped queries against the
    unexpanded K/V.  Returns ``q``'s dtype."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d ** -0.5 if scale is None else scale
    off = 0 if q_offset is None else int(q_offset)
    klen = sk if kv_len is None else min(int(kv_len), sk)
    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    col = torch.arange(sk, device=q.device)
    valid = (col < klen)[None, :].expand(sq, sk)
    if causal:
        row = torch.arange(sq, device=q.device) + off
        valid = valid & (col[None, :] <= row[:, None])
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / denom, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: Optional[int] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """``[B, Sq, H, D]`` attention over ``[B, Sk, Hkv, D]`` K/V (``Hkv | H``).

    ``q_offset``/``kv_len`` are the chunked-prefill scalars of the TPU
    kernel: q rows sit at global positions ``q_offset + i`` (causal is judged
    against those) and only the first ``kv_len`` keys are valid.

    CUDA tensors must be contiguous bf16 with ``D <= 128`` a multiple of 8;
    the kernel launches on the current stream and ``flash_attention.launches``
    counts each launch.  CPU tensors take :func:`flash_attention_ref`."""
    _check_shapes(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention kernel takes bfloat16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs 16-byte aligned {name}")
    if d % 8 or d > 128:
        raise ValueError(f"flash_attention kernel takes D <= 128, a multiple of 8; got {d}")
    off = 0 if q_offset is None else int(q_offset)
    klen = sk if kv_len is None else int(kv_len)
    if not 0 <= klen <= sk:
        raise ValueError(f"kv_len {klen} outside [0, {sk}]")
    out = torch.empty_like(q)
    if b * sq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, hkv,
                    d, int(causal), off, klen, float(d ** -0.5 if scale is None else scale),
                    stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
