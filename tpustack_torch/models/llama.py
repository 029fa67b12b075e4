"""Llama-2 / Qwen2-family decoder LM in PyTorch: the port of
``tpustack/models/llama.py``.

The same configuration (presets ``tiny``, ``qwen25_7b``, ``llama2_7b``),
parameter names (``layers.{i}.self_attn.q_proj`` ...), layouts and
attention branches as the JAX model, so ``llama_weights.params_from_jax``
carries a flax tree across and the tests compare logits on the same inputs.

KV caches are dicts of tensors that the attention layer writes IN PLACE
(the JAX model returns updated copies that its programs donate):

- ``{"k", "v"}`` (+ ``"k_scale"``, ``"v_scale"`` for ``kv_quant="int8"``):
  a dense ``[B, max_seq|bucket, Hkv, D]`` row cache, written at
  ``cache_index``.  ``cache_index == 0`` with no mask is the from-zero
  prefill (in-bucket causal attention, the flash kernel for long prompts);
  another ``cache_index`` with no mask is the streaming prefill (the flash
  kernel with ``q_offset``/``kv_len``); a mask selects the plain path.
- The chunk-buffer form of the continuous decode step adds ``{"ck", "cv"}``
  (+ scales) to either a dense frozen view (``k``/``v``, the gather path) or
  the pool view (``pk``/``pv`` + block table ``bt``, read in place by the
  paged kernel); ``cache_index`` is then ``(cur0 [B], t)``.

Weight-only int8 (``quant="int8"``, ``ops.quant``): the q/k/v/o and MLP
projections are :class:`~tpustack_torch.ops.quant.Int8Dense`, the embedding
an :class:`~tpustack_torch.ops.quant.Int8Embed` unless the embeddings are
tied, and the ``lm_head`` takes ``x`` in the compute dtype and gives float32
logits.  ``tie_embeddings`` takes the logits from the (float) embedding
table, as flax's ``Embed.attend`` does.

Left out: ring attention and the training branch beyond plain causal
attention.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpustack_torch.ops.attention import (dot_product_attention,
                                          dot_product_attention_partial,
                                          merge_attention_partials)
from tpustack_torch.ops.flash_attention import flash_attention
from tpustack_torch.ops.paged_attention import paged_attention_partial
from tpustack_torch.ops.quant import Int8Dense, Int8Embed, make_dense

KVCache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False       # True for Qwen2
    tie_embeddings: bool = False
    quant: Optional[str] = None  # None (float weights) | "int8" weight-only serving
    kv_quant: Optional[str] = None  # None (cache in the model dtype) | "int8"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def qwen25_7b(cls) -> "LlamaConfig":
        """Qwen2.5-7B-Instruct, the JAX server's default preset."""
        return cls(vocab_size=152064, dim=3584, n_layers=28, n_heads=28,
                   n_kv_heads=4, ffn_dim=18944, rope_theta=1_000_000.0,
                   qkv_bias=True, rms_eps=1e-6)

    @classmethod
    def tiny(cls, max_seq: int = 128) -> "LlamaConfig":
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   ffn_dim=128, max_seq=max_seq)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.eps = eps
        self.out_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.scale.float()).to(self.out_dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over ``[B, S, H, D]`` with ``positions [B, S]``."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions.float()[..., None] * freqs            # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _quantize_kv(x: torch.Tensor):
    """Per-vector symmetric int8: ``[..., D] -> (int8 [..., D], f32 [...])``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _write(cache: KVCache, key: str, index, value: torch.Tensor) -> None:
    """``cache[key][:, index:index + S] = value`` (in place)."""
    cache[key][:, index:index + value.shape[1]] = value.to(cache[key].dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        hd, q = cfg.head_dim, cfg.quant
        self.q_proj = make_dense(q, cfg.dim, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.k_proj = make_dense(q, cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.v_proj = make_dense(q, cfg.dim, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, dtype=dtype)
        self.o_proj = make_dense(q, cfg.n_heads * hd, cfg.dim, bias=False, dtype=dtype)

    def forward(self, x, positions, kv_cache: Optional[KVCache] = None, cache_index=0,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        hd = c.head_dim
        b, s, _ = x.shape
        q = rope(self.q_proj(x).reshape(b, s, c.n_heads, hd), positions, c.rope_theta)
        k = rope(self.k_proj(x).reshape(b, s, c.n_kv_heads, hd), positions, c.rope_theta)
        v = self.v_proj(x).reshape(b, s, c.n_kv_heads, hd)

        if kv_cache is not None and "ck" in kv_cache:
            out = self._chunk_attention(q, k, v, kv_cache, cache_index)
        elif kv_cache is not None:
            out = self._cache_attention(q, k, v, kv_cache, cache_index, attn_mask)
        else:
            out = dot_product_attention(q, k, v, causal=True, mask=attn_mask)
        return self.o_proj(out.reshape(b, s, c.n_heads * hd))

    def _chunk_attention(self, q, k, v, kv_cache, cache_index):
        """Continuous decode (s == 1) or speculative verify (s > 1): this
        call's K/V go into the chunk buffer at ``t``; attention merges the
        frozen main view ``[0, cur0)`` with the buffer ``[0, t + j]``."""
        b, s = q.shape[:2]
        cur0, t = cache_index
        if "ck_scale" in kv_cache:  # the buffer holds what the pool will
            k_q, k_s = _quantize_kv(k)
            v_q, v_s = _quantize_kv(v)
            _write(kv_cache, "ck", t, k_q)
            _write(kv_cache, "cv", t, v_q)
            _write(kv_cache, "ck_scale", t, k_s)
            _write(kv_cache, "cv_scale", t, v_s)
        else:
            _write(kv_cache, "ck", t, k)
            _write(kv_cache, "cv", t, v)
        cbuf = kv_cache["ck"].shape[1]
        ar = torch.arange(cbuf, device=q.device)
        buf_mask = (ar[None, None, :] <= (t + torch.arange(s, device=q.device))[None, :, None]
                    ).expand(b, s, cbuf)
        if "pk" in kv_cache:
            # the pool read in place through the block tables (the kernel)
            part_main = paged_attention_partial(
                q, kv_cache["pk"], kv_cache["pv"], kv_cache["bt"], kv_cache["lens"],
                k_scale=kv_cache.get("pk_scale"), v_scale=kv_cache.get("pv_scale"))
        else:
            main = kv_cache["k"]
            main_mask = (torch.arange(main.shape[1], device=q.device)[None, None, :]
                         < cur0[:, None, None]).expand(b, s, main.shape[1])
            part_main = dot_product_attention_partial(
                q, main, kv_cache["v"], mask=main_mask, k_scale=kv_cache.get("k_scale"),
                v_scale=kv_cache.get("v_scale"))
        part_buf = dot_product_attention_partial(
            q, kv_cache["ck"], kv_cache["cv"], mask=buf_mask,
            k_scale=kv_cache.get("ck_scale"), v_scale=kv_cache.get("cv_scale"))
        return merge_attention_partials(part_main, part_buf, self.dtype)

    def _cache_attention(self, q, k, v, kv_cache, cache_index, attn_mask):
        s = q.shape[1]
        quantized = "k_scale" in kv_cache
        if quantized:
            k_q, k_s = _quantize_kv(k)
            v_q, v_s = _quantize_kv(v)
            _write(kv_cache, "k", cache_index, k_q)
            _write(kv_cache, "v", cache_index, v_q)
            _write(kv_cache, "k_scale", cache_index, k_s)
            _write(kv_cache, "v_scale", cache_index, v_s)
        else:
            _write(kv_cache, "k", cache_index, k)
            _write(kv_cache, "v", cache_index, v)
        k_all, v_all = kv_cache["k"], kv_cache["v"]
        if s > 1 and cache_index == 0 and attn_mask is None:
            # from-zero prefill: in-bucket causal attention ([P, P] scores;
            # the flash kernel for long bf16 prompts on CUDA)
            return dot_product_attention(q, k, v, causal=True, impl="auto")
        if s > 1 and attn_mask is None:
            # streaming prefill: rows at cache_index + i over the cache prefix
            if quantized:
                k_all = k_all.to(self.dtype) * kv_cache["k_scale"][..., None].to(self.dtype)
                v_all = v_all.to(self.dtype) * kv_cache["v_scale"][..., None].to(self.dtype)
            return flash_attention(q, k_all, v_all, causal=True, q_offset=int(cache_index),
                                   kv_len=int(cache_index) + s)
        return dot_product_attention(q, k_all, v_all, mask=attn_mask,
                                     k_scale=kv_cache.get("k_scale"),
                                     v_scale=kv_cache.get("v_scale"))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        q = cfg.quant
        self.gate_proj = make_dense(q, cfg.dim, cfg.ffn_dim, bias=False, dtype=dtype)
        self.up_proj = make_dense(q, cfg.dim, cfg.ffn_dim, bias=False, dtype=dtype)
        self.down_proj = make_dense(q, cfg.ffn_dim, cfg.dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.rms_eps, dtype)
        self.self_attn = LlamaAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.rms_eps, dtype)
        self.mlp = LlamaMLP(cfg, dtype)

    def forward(self, x, positions, kv_cache, cache_index, attn_mask):
        x = x + self.self_attn(self.input_layernorm(x), positions, kv_cache, cache_index,
                               attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """``tokens [B,S] -> logits [B,S,V]`` (float32), with optional per-layer
    KV caches written in place.  Parameters are held in ``dtype`` (the
    layers compute in it); norms and softmax statistics run in float32.
    Build it under ``torch.device("meta")`` and fill it with
    ``llama_weights.init_random_`` or a loaded state dict to skip the
    default initialisation."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        if cfg.quant and not cfg.tie_embeddings:
            # tied models keep the float table: it also gives the logits
            self.embed_tokens = Int8Embed(cfg.vocab_size, cfg.dim, dtype=dtype)
        else:
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=dtype)
        self.layers = nn.ModuleList(LlamaBlock(cfg, dtype) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = make_dense(cfg.quant, cfg.dim, cfg.vocab_size, bias=False,
                                      dtype=dtype, out_dtype=torch.float32)

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[List[KVCache]] = None, cache_index=0,
                attn_mask: Optional[torch.Tensor] = None,
                logits_at: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``logits_at``: optional ``[B]`` positions; logits only there
        (``[B, 1, V]``).  Prefill must use it: full-vocab float32 logits of
        every prompt row would dwarf the model (5 GB at 8 x 1024 x 152064)."""
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self.embed_tokens(tokens).to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, kv_caches[i] if kv_caches is not None else None,
                      cache_index, attn_mask)
        x = self.norm(x)
        if logits_at is not None:
            x = x[torch.arange(b, device=x.device), logits_at.long()][:, None]
        if self.cfg.tie_embeddings:
            # flax's Embed.attend: query and table in the compute dtype
            return F.linear(x.to(self.dtype), self.embed_tokens.weight.to(self.dtype)).float()
        if isinstance(self.lm_head, Int8Dense):
            # the int8 head multiplies x in the compute dtype, float32 logits
            return self.lm_head(x)
        # the JAX model multiplies in float32; a float32 copy of a bf16
        # lm_head would cost 2.2 GB per call at 152k vocab, so half-precision
        # weights multiply in their own type (float32 accumulation on the
        # card) and only the logits are widened
        return self.lm_head(x.to(self.lm_head.weight.dtype)).float()


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _kv_dict(cfg: LlamaConfig, shape, dtype, device, prefix: str = "") -> KVCache:
    if cfg.kv_quant == "int8":
        return {prefix + "k": _zeros(shape, torch.int8, device),
                prefix + "k_scale": _zeros(shape[:-1], torch.float32, device),
                prefix + "v": _zeros(shape, torch.int8, device),
                prefix + "v_scale": _zeros(shape[:-1], torch.float32, device)}
    return {prefix + "k": _zeros(shape, dtype, device), prefix + "v": _zeros(shape, dtype, device)}


def init_kv_caches(cfg: LlamaConfig, batch: int, dtype: torch.dtype, device,
                   length: Optional[int] = None) -> List[KVCache]:
    """Per-layer dense caches ``[batch, length or max_seq, Hkv, D]`` (+ one
    float32 scale per vector when the cache is int8)."""
    shape = (batch, length or cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [_kv_dict(cfg, shape, dtype, device) for _ in range(cfg.n_layers)]


def init_kv_pool(cfg: LlamaConfig, n_blocks: int, block: int, dtype: torch.dtype,
                 device) -> List[KVCache]:
    """Per-layer paged pool tensors ``[n_blocks, block, Hkv, D]`` (+ scales).
    Block 0 is reserved: idle table entries point at it and nothing writes
    it."""
    shape = (n_blocks, block, cfg.n_kv_heads, cfg.head_dim)
    return [_kv_dict(cfg, shape, dtype, device) for _ in range(cfg.n_layers)]


def init_chunk_bufs(cfg: LlamaConfig, batch: int, chunk: int, dtype: torch.dtype,
                    device) -> List[KVCache]:
    """Per-layer chunk-local buffers ``ck``/``cv`` ``[batch, chunk, Hkv, D]``
    (+ scales), in the pool's layout so that a flush is a copy."""
    shape = (batch, chunk, cfg.n_kv_heads, cfg.head_dim)
    return [_kv_dict(cfg, shape, dtype, device, prefix="c") for _ in range(cfg.n_layers)]
