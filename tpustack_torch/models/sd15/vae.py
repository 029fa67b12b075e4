"""SD1.5 AutoencoderKL decoder (f8, 4 latent channels) in PyTorch.

Counterpart of ``VAEDecoder`` in ``tpustack/models/sd15/vae.py`` — the
txt2img half of the VAE (the encoder is not on this path).  Submodules carry
the diffusers names (``post_quant_conv``, ``decoder.up_blocks.0.resnets.0``,
``decoder.mid_block.attentions.0.to_q``, ...).  NHWC in and out; NCHW inside.
The mid-block attention is single-head over the HW tokens, plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpustack_torch.models.sd15.config import VAEConfig
from tpustack_torch.models.sd15.unet import GroupNorm, upsample_nearest
from tpustack_torch.ops.attention import dot_product_attention


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over spatial tokens (mid block)."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Identity()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = dot_product_attention(self.to_q(y)[:, :, None], self.to_k(y)[:, :, None],
                                    self.to_v(y)[:, :, None])
        out = self.to_out[0](out[:, :, 0])
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, groups),
                                      VAEResnetBlock(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttnBlock(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Upsampler(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x))


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, n_res: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            VAEResnetBlock(in_ch if i == 0 else ch, ch, groups) for i in range(n_res))
        if upsample:
            self.upsamplers = nn.ModuleList([_Upsampler(ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for res in self.resnets:
            x = res(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _Decoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        top = c.block_out_channels[-1]
        rev = tuple(reversed(c.block_out_channels))
        self.conv_in = nn.Conv2d(c.latent_channels, top, 3, padding=1)
        self.mid_block = _MidBlock(top, c.norm_num_groups)
        self.up_blocks = nn.ModuleList(
            _UpBlock(rev[i - 1] if i else top, ch, c.layers_per_block + 1,
                     c.norm_num_groups, upsample=i < len(rev) - 1)
            for i, ch in enumerate(rev))
        self.conv_norm_out = GroupNorm(c.norm_num_groups, rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], c.out_channels, 3, padding=1)


class VAEDecoder(nn.Module):
    """``latents [B,h,w,4] (already / scaling_factor) -> images [B,8h,8w,3]``
    in about [-1, 1], float32."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = _Decoder(cfg)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        d = self.decoder
        dtype = d.conv_in.weight.dtype
        h = self.post_quant_conv(z.to(dtype).permute(0, 3, 1, 2))
        h = d.mid_block(d.conv_in(h))
        for blk in d.up_blocks:
            h = blk(h)
        h = F.silu(d.conv_norm_out(h))
        h = d.conv_out(h.to(d.conv_out.weight.dtype))  # float32, as in flax
        return h.float().permute(0, 2, 3, 1)
