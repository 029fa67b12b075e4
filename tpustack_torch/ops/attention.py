"""Attention ops: the counterpart of ``tpustack/ops/attention.py``.

``impl="xla"`` is the plain PyTorch path (matmul, masked fill, float32
softmax, matmul), the port of JAX's non-Pallas einsum path; ``"flash"`` is the
hand-written CUDA kernel (:mod:`tpustack_torch.ops.flash_attention`);
``"auto"`` picks between them with :func:`auto_impl`.

Shapes follow the JAX package: ``[batch, seq, heads, head_dim]`` (BSHD).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpustack_torch.ops.flash_attention import flash_attention

# provisional CUDA crossover (not yet measured on H100): the kernel for
# sequences long enough that the [Sq, Sk] score round trip dominates
FLASH_MIN_SQ = 1024
FLASH_MIN_SK = 256


def auto_impl(sq: int, sk: int, has_mask: bool, device_type: str,
              dtype: torch.dtype) -> str:
    """The ``impl="auto"`` rule: the flash kernel on CUDA for unmasked bf16
    attention with ``sq >= 1024`` and ``sk >= 256``, the plain path otherwise
    (the kernel takes bf16 only, so float32 work such as the ``tiny()``
    preset's stays plain).

    Provisional.  The TPU rule also bounds batch*heads and the K/V panel
    length (``PANEL_MAX_KV``); both encode the TPU's sequential grid and
    VMEM, and neither exists on Hopper, so they are dropped.  The crossover
    itself is still the TPU's and is to be measured on the H100.  At SD1.5
    512x512 this sends the level-0 and level-1 UNet self-attention (4096 and
    1024 tokens) to the kernel at every batch size; cross-attention (77
    keys), the level-2/mid attention, CLIP and the VAE stay plain."""
    return ("flash" if device_type == "cuda" and dtype == torch.bfloat16 and not has_mask
            and sq >= FLASH_MIN_SQ and sk >= FLASH_MIN_SK else "xla")


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None, causal: bool = False,
                          scale: Optional[float] = None, impl: str = "xla") -> torch.Tensor:
    """Scaled dot-product attention over BSHD tensors.

    Args:
      q: ``[B, Sq, H, D]``.
      k/v: ``[B, Sk, Hkv, D]``; ``Hkv`` may divide ``H`` (GQA/MQA), and the
        grouped queries contract against the unexpanded K/V.
      mask: optional boolean mask, ``[Sq, Sk]`` or ``[B|1, H|Hkv|1, Sq, Sk]``
        (3D is rejected as ambiguous); True means attend.
      causal: causal mask, bottom-right aligned when ``Sq != Sk``.
      scale: defaults to ``1/sqrt(D)``.
      impl: ``"xla"`` (plain PyTorch), ``"flash"`` (the CUDA kernel; its
        plain twin on CPU tensors) or ``"auto"`` (:func:`auto_impl`).
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if mask is not None and mask.dim() not in (2, 4):
        raise ValueError(
            f"mask must be [Sq, Sk] or [B|1, H|Hkv|1, Sq, Sk]; a {mask.dim()}D "
            f"mask (shape {tuple(mask.shape)}) is ambiguous — add explicit "
            "batch/head axes")

    if impl == "auto":
        impl = auto_impl(sq, sk, mask is not None, q.device.type, q.dtype)
        if impl == "flash" and causal and sq > sk:
            impl = "xla"  # flash rejects this shape (below); auto must not

    if impl == "flash":
        if mask is not None:
            raise NotImplementedError("flash impl supports causal=, not arbitrary mask=")
        if causal and sq > sk:
            raise ValueError(f"flash impl: causal with sq ({sq}) > sk ({sk}) is "
                             "not supported; use impl='xla'")
        # bottom-right causal alignment = q rows shifted by the length gap
        q_off = sk - sq if causal and sk != sq else None
        return flash_attention(q, k, v, causal=causal, scale=scale, q_offset=q_off)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")

    scale = d ** -0.5 if scale is None else scale
    if causal:
        causal_mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        mask = causal_mask if mask is None else mask & causal_mask

    g = h // hkv
    # [B, Hkv, G, Sq, Sk] float32 logits, grouped queries against unexpanded K/V
    q5 = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]          # [B, Hkv, 1, D, Sk]
    logits = torch.matmul(q5, kt) * scale
    if mask is not None:
        if mask.dim() == 4 and mask.shape[-3] == h:
            mask = mask.expand(b, h, sq, sk).reshape(b, hkv, g, sq, sk)
        elif mask.dim() == 4:
            if mask.shape[-3] not in (1, hkv):
                raise ValueError(f"mask head axis {mask.shape[-3]} matches neither "
                                 f"H={h} nor Hkv={hkv} (nor 1)")
            mask = mask[:, :, None]
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3)[:, :, None])  # [B, Hkv, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
