"""SD1.5 UNet2DConditionModel in PyTorch.

Counterpart of ``tpustack/models/sd15/unet.py`` (diffusers' SD1.5
architecture): conv_in 4->320; down path (320,640,1280,1280) x 2 resnets with
cross-attention transformers on the first three levels and stride-2 conv
downsamples; mid resnet-transformer-resnet; up path with 3 resnets per level
and nearest x2 + conv upsamples; GroupNorm + SiLU + conv_out back to 4.

Submodules carry the diffusers names (``down_blocks.0.attentions.0.
transformer_blocks.0.attn1.to_q.weight``, ...), so ``state_dict()`` keys are
the checkpoint's.  The public ``forward`` takes and returns NHWC as the JAX
module does; inside, features are NCHW.

Numerics kept equal to the flax module: GroupNorm and LayerNorm ``eps`` 1e-6
(flax's default) with GroupNorm statistics in float32, the tanh-approximate
GELU in the GEGLU feed-forward (flax ``nn.gelu``), ``conv_out`` in float32,
and the ``[cos, sin]`` timestep embedding.  The spatial self-attention
(``attn1``) reaches the flash kernel through ``dot_product_attention``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpustack_torch.models.sd15.config import UNetConfig
from tpustack_torch.ops.attention import dot_product_attention

NORM_EPS = 1e-6  # flax nn.GroupNorm / nn.LayerNorm default


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[B] -> [B, dim]`` (float32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW with float32 statistics (as flax computes them),
    returned in the input dtype."""

    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(groups, out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, g = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(g, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net.0.proj`` / ``net.2`` as in diffusers."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 impl: str = "auto"):
        super().__init__()
        ctx = dim if context_dim is None else context_dim
        self.heads = heads
        self.impl = impl
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx, dim, bias=False)
        self.to_v = nn.Linear(ctx, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, s, d = x.shape
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, d // self.heads)
        out = dot_product_attention(split(self.to_q(x)), split(self.to_k(ctx)),
                                    split(self.to_v(ctx)), impl=self.impl)
        return self.to_out[0](out.reshape(b, s, d))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, impl: str):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn1 = CrossAttention(dim, heads, impl=impl)
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.attn2 = CrossAttention(dim, heads, context_dim, impl=impl)
        self.norm3 = nn.LayerNorm(dim, eps=NORM_EPS)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> 1x1 in -> blocks over HW tokens -> 1x1 out, residual."""

    def __init__(self, ch: int, heads: int, layers: int, groups: int,
                 context_dim: int, impl: str):
        super().__init__()
        self.norm = GroupNorm(groups, ch)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(ch, heads, context_dim, impl) for _ in range(layers))
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class _Sampler(nn.Module):
    """``downsamplers.0`` / ``upsamplers.0``: a 3x3 conv, stride 2 down or
    after a nearest x2 up."""

    def __init__(self, ch: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(ch, ch, 3, stride=2 if down else 1, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x if self.down else upsample_nearest(x))


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class _TimeEmbedding(nn.Module):
    def __init__(self, ch: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(ch, dim)
        self.linear_2 = nn.Linear(dim, dim)


class UNet2DCondition(nn.Module):
    """``(latents [B,H,W,4], t [B], context [B,L,768]) -> noise pred [B,H,W,4]``
    (NHWC in and out, the prediction in float32)."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = c = cfg
        chs = c.block_out_channels
        n = len(chs)
        heads, groups, ctx = c.attention_head_dim, c.norm_num_groups, c.cross_attention_dim
        tdim = chs[0] * c.time_embed_dim_mult
        attn = lambda ch: Transformer2D(ch, heads, c.transformer_layers, groups, ctx, c.attn_impl)

        self.time_embedding = _TimeEmbedding(chs[0], tdim)
        self.conv_in = nn.Conv2d(c.in_channels, chs[0], 3, padding=1)

        skip_chs: List[int] = [chs[0]]
        cur = chs[0]
        self.down_blocks = nn.ModuleList()
        for level, ch in enumerate(chs):
            blk = _Block()
            for _ in range(c.layers_per_block):
                blk.resnets.append(ResnetBlock(cur, ch, tdim, groups))
                cur = ch
                if c.down_block_has_attn[level]:
                    blk.attentions.append(attn(ch))
                skip_chs.append(ch)
            if level < n - 1:
                blk.downsamplers = nn.ModuleList([_Sampler(ch, down=True)])
                skip_chs.append(ch)
            self.down_blocks.append(blk)

        self.mid_block = _Block()
        self.mid_block.resnets.append(ResnetBlock(cur, chs[-1], tdim, groups))
        self.mid_block.attentions.append(attn(chs[-1]))
        self.mid_block.resnets.append(ResnetBlock(chs[-1], chs[-1], tdim, groups))
        cur = chs[-1]

        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(chs)):
            blk = _Block()
            for _ in range(c.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(cur + skip_chs.pop(), ch, tdim, groups))
                cur = ch
                if c.up_block_has_attn[i]:
                    blk.attentions.append(attn(ch))
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([_Sampler(ch, down=False)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(groups, chs[0])
        self.conv_out = nn.Conv2d(chs[0], c.out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        context = context.to(dtype)
        temb = timestep_embedding(t, self.cfg.block_out_channels[0]).to(dtype)
        te = self.time_embedding
        temb = te.linear_2(F.silu(te.linear_1(temb)))

        h = self.conv_in(x.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, temb)

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        h = F.silu(self.conv_norm_out(h))
        h = self.conv_out(h.to(self.conv_out.weight.dtype))  # float32, as in flax
        return h.float().permute(0, 2, 3, 1)


def set_attn_impl(module: nn.Module, impl: str) -> None:
    """Switch every :class:`CrossAttention` under ``module`` to ``impl``."""
    for m in module.modules():
        if isinstance(m, CrossAttention):
            m.impl = impl
