"""Space-time diffusion transformer (the Wan2.1 T2V denoiser), in PyTorch.

Counterpart of ``tpustack/models/wan/dit.py``.  The 3D latent is patchified
into one flat token stream (frames x H/2 x W/2 tokens, in that order), run
through ``num_layers`` blocks of [self-attention over space-time,
cross-attention to the UMT5 text, FFN], each modulated by the flow-matching
timestep, and unpatchified back to a velocity.  Submodules carry the Wan2.1
checkpoint's names (``patch_embedding``, ``blocks.N.self_attn.q``,
``blocks.N.cross_attn.norm_k``, ``time_projection.1``, ``head.head``, ...),
so ``state_dict()`` keys are the checkpoint's.  The public ``forward`` takes
and returns ``[B, F, H, W, C]`` as the JAX module does.

Numerics kept equal to the flax module, which fixes where values round:

- The residual stream is stored in the compute dtype.  LayerNorm statistics,
  the modulation ``x*(1+scale)+shift`` and the gated residual adds run in
  float32 and round when stored; ``norm3`` is the only affine LayerNorm.
- q/k RMS norms (over each head's ``head_dim``) in float32 with a float32
  scale, cast back to the compute dtype.
- RoPE rotates the two *halves* of the head dim against each other (not
  interleaved pairs, as upstream Wan does); ``rope_3d`` splits the head dim
  into frame, height and width slices (44/42/42 at D=128).
- The time embedding, its projections, the per-block ``modulation``, the
  head's modulation, its LayerNorm and ``head.head`` run in float32; GELU is
  the tanh form.

Both attentions go through :func:`tpustack_torch.ops.attention.dot_product_attention`
with ``cfg.attn_impl``; under ``"auto"`` on the card both reach the
hand-written flash kernel (``[B, F*H*W/4, 12, 128]`` self-attention and the
same queries over the 512 text tokens).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpustack_torch.models.wan.config import WanDiTConfig
from tpustack_torch.ops.attention import dot_product_attention


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of continuous ``t`` in [0, 1000] -> ``[B, dim]``
    float32, ``[cos, sin]``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_3d(grid: Tuple[int, int, int], head_dim: int,
            theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Axial 3D RoPE tables: cos/sin ``[F*H*W, head_dim//2]`` float32 (on the
    host, in float64 before the cast, as the JAX package builds them).

    The head dim is split with frames taking the remainder (Wan's split)."""
    f, h, w = grid
    d_h = d_w = 2 * (head_dim // 6)
    d_f = head_dim - 2 * d_h

    def axis_freqs(n, d):
        inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
        return np.outer(np.arange(n, dtype=np.float64), inv)  # [n, d/2]

    full = np.concatenate([
        np.broadcast_to(axis_freqs(f, d_f)[:, None, None, :], (f, h, w, d_f // 2)),
        np.broadcast_to(axis_freqs(h, d_h)[None, :, None, :], (f, h, w, d_h // 2)),
        np.broadcast_to(axis_freqs(w, d_w)[None, None, :, :], (f, h, w, d_w // 2)),
    ], axis=-1).reshape(f * h * w, head_dim // 2)
    return (torch.from_numpy(np.cos(full).astype(np.float32)),
            torch.from_numpy(np.sin(full).astype(np.float32)))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the head dim; ``x`` ``[B, S, H, D]``, tables
    ``[S, D/2]``.  Returns a contiguous tensor in ``x``'s dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm over the last axis, float32 compute, float32 scale."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        out = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (out * self.weight.float()).to(x.dtype)


def _layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Non-affine LayerNorm in float32 (the input is promoted, as flax's
    ``LayerNorm(dtype=f32)`` does)."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str) -> torch.Tensor:
    """BSHD attention -> ``[B, S, H*D]``.  The flash kernel takes contiguous
    bf16 tensors: q/k leave RoPE or the RMS norm contiguous, and the
    projections' views are made contiguous here."""
    b, s, h, d = q.shape
    out = dot_product_attention(q.contiguous(), k.contiguous(), v.contiguous(), impl=impl)
    return out.reshape(b, s, h * d)


class WanAttention(nn.Module):
    """q/k/v/o projections with per-head RMS q/k norms (the checkpoint's
    ``self_attn`` / ``cross_attn``)."""

    def __init__(self, c: WanDiTConfig):
        super().__init__()
        hd = c.dim // c.num_heads
        self.q = nn.Linear(c.dim, c.dim)
        self.k = nn.Linear(c.dim, c.dim)
        self.v = nn.Linear(c.dim, c.dim)
        self.o = nn.Linear(c.dim, c.dim)
        if c.qk_norm:
            self.norm_q = RMSNorm(hd)
            self.norm_k = RMSNorm(hd)
        self.qk_norm, self.heads, self.head_dim = c.qk_norm, c.num_heads, hd

    def qkv(self, h: torch.Tensor, ctx: torch.Tensor):
        b = h.shape[0]
        heads = lambda y: y.view(b, -1, self.heads, self.head_dim)  # noqa: E731
        q, k, v = heads(self.q(h)), heads(self.k(ctx)), heads(self.v(ctx))
        if self.qk_norm:
            q, k = self.norm_q(q), self.norm_k(k)
        return q, k, v


class DiTBlock(nn.Module):
    def __init__(self, c: WanDiTConfig):
        super().__init__()
        self.cfg, self.attn_impl = c, c.attn_impl
        self.modulation = nn.Parameter(torch.zeros(1, 6, c.dim))
        self.self_attn = WanAttention(c)
        self.norm3 = nn.LayerNorm(c.dim, eps=c.eps)
        self.cross_attn = WanAttention(c)
        self.ffn = nn.Sequential(nn.Linear(c.dim, c.ffn_dim), nn.GELU(approximate="tanh"),
                                 nn.Linear(c.ffn_dim, c.dim))

    def forward(self, x: torch.Tensor, text: torch.Tensor, e0: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """``e0`` is the shared time projection ``[B, 6, dim]`` float32; the
        block adds its learned ``modulation`` offset."""
        c, dtype = self.cfg, x.dtype
        e = self.modulation.float() + e0
        sh_sa, sc_sa, g_sa, sh_ff, sc_ff, g_ff = (e[:, i, None] for i in range(6))

        # self-attention over the whole space-time stream
        h = (_layer_norm(x, c.eps) * (1.0 + sc_sa) + sh_sa).to(dtype)
        q, k, v = self.self_attn.qkv(h, h)
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        o = self.self_attn.o(_attention(q, k, v, self.attn_impl))
        x = (x.float() + g_sa * o.float()).to(dtype)

        # cross-attention to the text (affine norm3, no RoPE, no gate)
        h = F.layer_norm(x.float(), (c.dim,), self.norm3.weight.float(),
                         self.norm3.bias.float(), c.eps).to(dtype)
        q, k, v = self.cross_attn.qkv(h, text)
        o = self.cross_attn.o(_attention(q, k, v, self.attn_impl))
        x = (x.float() + o.float()).to(dtype)

        # FFN (GELU-tanh)
        h = (_layer_norm(x, c.eps) * (1.0 + sc_ff) + sh_ff).to(dtype)
        return (x.float() + g_ff * self.ffn(h).float()).to(dtype)


class _Head(nn.Module):
    def __init__(self, c: WanDiTConfig):
        super().__init__()
        pf, ph, pw = c.patch_size
        self.head = nn.Linear(c.dim, pf * ph * pw * c.out_channels)
        self.modulation = nn.Parameter(torch.zeros(1, 2, c.dim))


class WanDiT(nn.Module):
    """(latent ``[B,F,H,W,C]``, t ``[B]``, text ``[B,L,text_dim]``) ->
    velocity ``[B,F,H,W,C]`` float32."""

    #: submodules and parameters that stay float32 when the rest of the
    #: model is cast to the compute dtype (flax's ``dtype=f32`` layers and
    #: float32 params read without a cast)
    FLOAT32 = ("time_embedding", "time_projection", "head", "modulation", "norm_q", "norm_k",
               "norm3")

    def __init__(self, cfg: WanDiTConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embedding = nn.Conv3d(c.in_channels, c.dim, c.patch_size, stride=c.patch_size)
        self.time_embedding = nn.Sequential(nn.Linear(c.freq_dim, c.dim), nn.SiLU(),
                                            nn.Linear(c.dim, c.dim))
        self.time_projection = nn.Sequential(nn.SiLU(), nn.Linear(c.dim, 6 * c.dim))
        self.text_embedding = nn.Sequential(nn.Linear(c.text_dim, c.dim),
                                            nn.GELU(approximate="tanh"), nn.Linear(c.dim, c.dim))
        self.blocks = nn.ModuleList([DiTBlock(c) for _ in range(c.num_layers)])
        self.head = _Head(c)
        self._rope = (None, None)  # (grid, device), tables: the last shape's

    def rope(self, grid: Tuple[int, int, int], device: torch.device):
        """The RoPE tables for ``grid`` on ``device``, kept for the next call
        (the denoise loop's 50 evaluations share one shape)."""
        key = (grid, str(device))
        if self._rope[0] != key:
            cos, sin = rope_3d(grid, self.cfg.dim // self.cfg.num_heads)
            self._rope = (key, (cos.to(device), sin.to(device)))
        return self._rope[1]

    def forward(self, latent: torch.Tensor, t: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dtype = self.patch_embedding.weight.dtype
        b, f, hh, ww, _ = latent.shape
        pf, ph, pw = c.patch_size
        grid = (f // pf, hh // ph, ww // pw)

        x = self.patch_embedding(latent.to(dtype).permute(0, 4, 1, 2, 3))  # [B, dim, f, h, w]
        x = x.flatten(2).transpose(1, 2)  # tokens in (f, h, w) order, as rope_3d assumes

        # shared time embedding + projection to 6 modulation vectors (float32)
        t_emb = self.time_embedding(timestep_embedding(t, c.freq_dim))
        e0 = self.time_projection(t_emb).view(b, 6, c.dim)
        text = self.text_embedding(text.to(dtype))

        rope = self.rope(grid, latent.device)
        for blk in self.blocks:
            x = blk(x, text, e0, rope)

        # head: its own 2-vector modulation over the time embedding, float32
        e = self.head.modulation.float() + t_emb[:, None]
        shift, scale = e[:, 0, None], e[:, 1, None]
        x = _layer_norm(x, c.eps) * (1.0 + scale) + shift
        x = self.head.head(x)
        x = x.view(b, *grid, pf, ph, pw, c.out_channels)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)  # einsum bfhwpqrc->bfphqwrc
        return x.reshape(b, f, hh, ww, c.out_channels)


def set_attn_impl(dit: WanDiT, impl: str) -> None:
    """Switch both attentions of every block to ``impl``."""
    for blk in dit.blocks:
        blk.attn_impl = impl
