"""Wan 2.1 causal 3D VAE decoder (the checkpoint-mapped architecture), in
PyTorch.

Counterpart of the decoder half of ``tpustack/models/wan/wanvae.py``: a
causal 3D conv decoder (z=16, base 96, mults (1,2,4,4), two residual blocks
per stage plus one, per-frame single-head attention at the bottleneck, RMS
channel norms) with 8x spatial / 4x temporal upsampling.  Submodules carry
the ``wan_2.1_vae`` checkpoint's names (top-level ``conv2``, then
``decoder.conv1``, ``decoder.middle.{0,1,2}``, ``decoder.upsamples.N``
with ``residual.{0,2,3,6}`` / ``shortcut`` / ``resample.1`` /
``time_conv``, ``decoder.head.{0,2}``; RMS ``gamma`` stored ``(C,1,1,1)``,
or ``(C,1,1)`` in the attention block), so ``state_dict()`` keys and shapes
are the checkpoint's.  Inside, activations are NCDHW; the public entry
points take ``[B, F', H', W', z]`` and return ``[B, F, H, W, 3]`` as the JAX
modules do.

Two ways to run the same modules:

- :class:`WanVAEDecoder` ``forward``: the whole sequence at once.  Each
  causal conv pads ``kt-1`` zero frames in front; the ``up3d`` resample
  lets frame 0 bypass the time conv (the upstream stream's ``'Rep'`` first
  chunk), so ``F'`` latent frames decode to ``1 + 4(F'-1)``.
- :class:`WanVAEDecoderStream`: latent-frame chunks with a 2-frame cache per
  temporal conv (the JAX package's ``WanCausalConv3dStream``,
  ``WanResBlockStream``, ``WanResampleStream`` are the ``stream`` methods of
  the modules here, on the same parameters).  Chunk 0 with the zero caches
  of :func:`init_decode_caches` reproduces the causal left padding, so the
  chunked decode computes the same values as the whole-sequence one with
  memory bounded by the chunk.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpustack_torch.models.wan.config import WanVAEConfig

Caches = Dict[str, torch.Tensor]


def latent_stats(cfg: WanVAEConfig) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(mean, std) float32 ``[z]`` vectors, or None when the config carries
    no stats (tiny test configs)."""
    if cfg.latent_mean is None or cfg.latent_std is None:
        return None
    for name, vals in (("latent_mean", cfg.latent_mean), ("latent_std", cfg.latent_std)):
        if len(vals) != cfg.z_channels:
            raise ValueError(f"{name} has {len(vals)} entries for z={cfg.z_channels}")
    return (torch.tensor(cfg.latent_mean, dtype=torch.float32),
            torch.tensor(cfg.latent_std, dtype=torch.float32))


def normalize_latents(cfg: WanVAEConfig, mu: torch.Tensor) -> torch.Tensor:
    """VAE-space mu ``[..., z]`` -> the normalized latents the DiT denoises."""
    stats = latent_stats(cfg)
    if stats is None:
        return mu
    mean, std = (s.to(mu.device) for s in stats)
    return ((mu.float() - mean) / std).to(mu.dtype)


def _denormalize(cfg: WanVAEConfig, z: torch.Tensor) -> torch.Tensor:
    """NCDHW normalized latents -> VAE-space (``z*std + mean``, float32 math)."""
    stats = latent_stats(cfg)
    if stats is None:
        return z
    mean, std = (s.to(z.device)[None, :, None, None, None] for s in stats)
    return (z.float() * std + mean).to(z.dtype)


class WanRMSNorm(nn.Module):
    """Upstream ``RMS_norm`` over the channel axis (dim 1):
    ``x / ||x||_C * sqrt(C) * gamma``, float32 compute, no bias."""

    def __init__(self, dim: int, images: bool = False):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, 1, 1) if images else torch.ones(dim, 1, 1, 1))
        self.scale = dim ** 0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = torch.sqrt(torch.clamp_min((x32 * x32).sum(dim=1, keepdim=True), 1e-24))
        return ((x32 / norm) * self.scale * self.gamma.float()).to(x.dtype)


class WanCausalConv3d(nn.Conv3d):
    """3D conv with left-only (causal) temporal zero padding and symmetric
    spatial padding.  ``forward`` pads ``kt-1`` zero frames in front;
    ``stream(x, cache)`` puts the cached ``kt-1`` input frames there instead
    and returns the new cache (the last ``kt-1`` frames it saw)."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3)):
        kt, kh, kw = kernel
        super().__init__(cin, cout, kernel, padding=(0, (kh - 1) // 2, (kw - 1) // 2))
        self.kt = kt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kt > 1:
            x = F.pad(x, (0, 0, 0, 0, self.kt - 1, 0))
        return super().forward(x)

    def stream(self, x: torch.Tensor, cache: Optional[torch.Tensor]):
        if self.kt == 1:
            return super().forward(x), None
        x = torch.cat([cache.to(x.dtype), x], dim=2)
        # a copy, not a view: a view would keep this whole chunk alive
        return super().forward(x), x[:, :, -(self.kt - 1):].clone()


class WanResBlock(nn.Module):
    """``residual = conv(silu(rms)) x2`` with a 1x1x1 ``shortcut`` conv exactly
    when channels change (upstream ``ResidualBlock``; ``residual.{1,4,5}``
    are the SiLUs and a dropout, which hold no parameters)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.residual = nn.Sequential(WanRMSNorm(cin), nn.SiLU(), WanCausalConv3d(cin, cout),
                                      WanRMSNorm(cout), nn.SiLU(), nn.Identity(),
                                      WanCausalConv3d(cout, cout))
        self.shortcut = WanCausalConv3d(cin, cout, (1, 1, 1)) if cin != cout else None

    def _skip(self, x):
        return x if self.shortcut is None else self.shortcut(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._skip(x) + self.residual(x)

    def stream(self, x: torch.Tensor, c1, c2):
        r = self.residual
        h, c1 = r[2].stream(F.silu(r[0](x)), c1)
        h, c2 = r[6].stream(F.silu(r[3](h)), c2)
        return self._skip(x) + h, c1, c2


class WanAttnBlock(nn.Module):
    """Per-frame single-head spatial self-attention over the full channel
    dim (upstream ``AttentionBlock``: 1x1-conv qkv and proj, scale C^-0.5,
    float32 logits and softmax, plain matmuls)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = WanRMSNorm(dim, images=True)
        self.to_qkv = nn.Conv2d(dim, 3 * dim, 1)
        self.proj = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, hh, ww = x.shape
        frames = x.permute(0, 2, 1, 3, 4).reshape(b * f, c, hh, ww)
        qkv = self.to_qkv(self.norm(frames)).flatten(2).transpose(1, 2)  # [BF, HW, 3C]
        q, k, v = qkv.chunk(3, dim=-1)
        logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * (c ** -0.5)
        h = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
        h = self.proj(h.transpose(1, 2).reshape(b * f, c, hh, ww))
        return x + h.reshape(b, f, c, hh, ww).permute(0, 2, 1, 3, 4)


class _Upsample2x(nn.Module):
    """'nearest-exact' at an integer 2x == plain pixel repetition."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")


class WanResample(nn.Module):
    """Upstream ``Resample``, decoder modes: ``up2d`` doubles H and W and
    halves the channels (``resample.1``); ``up3d`` first doubles frames
    ``1..F-1`` with a causal kernel-3 time conv whose 2C outputs interleave
    into frame pairs, frame 0 bypassing it."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        if mode not in ("up2d", "up3d"):
            raise ValueError(f"decoder resample mode must be up2d or up3d, got {mode!r}")
        self.mode = mode
        self.resample = nn.Sequential(_Upsample2x(), nn.Conv2d(dim, dim // 2, 3, padding=1))
        if mode == "up3d":
            self.time_conv = WanCausalConv3d(dim, 2 * dim, (3, 1, 1))

    @staticmethod
    def _pairs(y: torch.Tensor) -> torch.Tensor:
        """``[B, 2C, T, H, W]`` -> ``[B, C, 2T, H, W]``: channels ``[:C]`` then
        ``[C:]`` of each frame become two consecutive frames."""
        b, c2, t, hh, ww = y.shape
        return y.view(b, 2, c2 // 2, t, hh, ww).permute(0, 2, 3, 1, 4, 5).reshape(
            b, c2 // 2, 2 * t, hh, ww)

    def _spatial(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, hh, ww = x.shape
        y = self.resample(x.permute(0, 2, 1, 3, 4).reshape(b * f, c, hh, ww))
        return y.reshape(b, f, c // 2, 2 * hh, 2 * ww).permute(0, 2, 1, 3, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "up3d" and x.shape[2] > 1:
            x = torch.cat([x[:, :, :1], self._pairs(self.time_conv(x[:, :, 1:]))], dim=2)
        return self._spatial(x)

    def stream(self, x: torch.Tensor, tcache: Optional[torch.Tensor], first: bool):
        """``first``: the chunk starts at global frame 0, whose 'Rep' bypass
        skips the time conv; the tail starts from the zero cache."""
        if self.mode == "up3d":
            if first:
                y, tcache = self.time_conv.stream(x[:, :, 1:], tcache)
                x = torch.cat([x[:, :, :1], self._pairs(y)], dim=2)
            else:
                y, tcache = self.time_conv.stream(x, tcache)
                x = self._pairs(y)
        return self._spatial(x), tcache


def _stage_dims(cfg: WanVAEConfig):
    mults = [cfg.channel_mults[-1]] + list(reversed(cfg.channel_mults))
    return [cfg.base_channels * m for m in mults], tuple(reversed(cfg.temporal_downsample))


class _Decoder3d(nn.Module):
    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        dims, up3d = _stage_dims(cfg)
        self.conv1 = WanCausalConv3d(cfg.z_channels, dims[0])
        self.middle = nn.ModuleList([WanResBlock(dims[0], dims[0]), WanAttnBlock(dims[0]),
                                     WanResBlock(dims[0], dims[0])])
        ups, ch = [], dims[0]
        for i, out_dim in enumerate(dims[1:]):
            for _ in range(cfg.num_res_blocks + 1):
                ups.append(WanResBlock(ch, out_dim))
                ch = out_dim
            if i < len(cfg.channel_mults) - 1:
                ups.append(WanResample(ch, "up3d" if up3d[i] else "up2d"))
                ch //= 2
        self.upsamples = nn.ModuleList(ups)
        self.head = nn.Sequential(WanRMSNorm(ch), nn.SiLU(), WanCausalConv3d(ch, 3))


class WanVAEDecoder(nn.Module):
    """Normalized latents ``[B, F', H', W', z]`` -> frames
    ``[B, 1+4(F'-1), 8H', 8W', 3]`` (unclamped; callers clip to [-1, 1]).

    Owns the pre-decoder pieces of the upstream top level (the latent
    de-normalization and the 1x1x1 ``conv2``), so one call is the whole
    ComfyUI ``VAEDecode`` node."""

    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.conv2 = WanCausalConv3d(cfg.z_channels, cfg.z_channels, (1, 1, 1))
        self.decoder = _Decoder3d(cfg)

    def _in(self, z: torch.Tensor) -> torch.Tensor:
        # de-normalize in the latents' own dtype (float32 from the sampler),
        # then round to the compute dtype, as flax's Conv(dtype=...) does
        z = _denormalize(self.cfg, z.permute(0, 4, 1, 2, 3))
        return self.conv2(z.to(self.conv2.weight.dtype))

    @staticmethod
    def _out(h: torch.Tensor) -> torch.Tensor:
        return h.permute(0, 2, 3, 4, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        d = self.decoder
        h = d.conv1(self._in(z))
        for m in d.middle:
            h = m(h)
        for m in d.upsamples:
            h = m(h)
        return self._out(d.head(h))


class WanVAEDecoderStream:
    """The chunked decode over a :class:`WanVAEDecoder`'s own parameters:
    ``(z chunk [B, n, H', W', z], caches, first) -> (frames chunk, caches)``.
    Chunk 0 must carry >= 2 latent frames (the frame-0 bypass plus a
    non-empty tail for the up3d time conv)."""

    def __init__(self, decoder: WanVAEDecoder):
        self.vae = decoder

    def __call__(self, z: torch.Tensor, caches: Caches, first: bool):
        if first and z.shape[1] < 2:
            raise ValueError(
                f"chunk 0 needs >= 2 latent frames (got {z.shape[1]}): the frame-0 "
                "'Rep' bypass leaves the up3d time conv an empty tail stream")
        d, new = self.vae.decoder, dict(caches)
        h, new["conv_in"] = d.conv1.stream(self.vae._in(z), caches["conv_in"])
        h, new["mid_res_0/1"], new["mid_res_0/2"] = d.middle[0].stream(
            h, caches["mid_res_0/1"], caches["mid_res_0/2"])
        h = d.middle[1](h)
        h, new["mid_res_1/1"], new["mid_res_1/2"] = d.middle[2].stream(
            h, caches["mid_res_1/1"], caches["mid_res_1/2"])
        for n, m in enumerate(d.upsamples):
            if isinstance(m, WanResample):
                h, tc = m.stream(h, caches.get(f"up_{n}/t"), first)
                if m.mode == "up3d":
                    new[f"up_{n}/t"] = tc
            else:
                h, new[f"up_{n}/1"], new[f"up_{n}/2"] = m.stream(
                    h, caches[f"up_{n}/1"], caches[f"up_{n}/2"])
        h, new["head_conv"] = d.head[2].stream(F.silu(d.head[0](h)), caches["head_conv"])
        return self.vae._out(h), new


def init_decode_caches(cfg: WanVAEConfig, b: int, h_lat: int, w_lat: int,
                       dtype=torch.float32, device=None) -> Caches:
    """Zero history ``[B, C, 2, H, W]`` for every temporal conv of the
    streaming decoder, keyed as :class:`WanVAEDecoderStream` reads them.
    The spatial size doubles after every resample; the up3d time conv caches
    its input (stage channels, pre-upsample resolution)."""
    dims, up3d = _stage_dims(cfg)
    z2 = lambda hh, ww, ch: torch.zeros((b, ch, 2, hh, ww), dtype=dtype, device=device)  # noqa: E731
    hh, ww = h_lat, w_lat
    caches = {"conv_in": z2(hh, ww, cfg.z_channels)}
    for i in (0, 1):
        caches[f"mid_res_{i}/1"] = z2(hh, ww, dims[0])
        caches[f"mid_res_{i}/2"] = z2(hh, ww, dims[0])
    n, ch = 0, dims[0]
    for i, out_dim in enumerate(dims[1:]):
        for _ in range(cfg.num_res_blocks + 1):
            caches[f"up_{n}/1"] = z2(hh, ww, ch)  # conv 1's input channels
            caches[f"up_{n}/2"] = z2(hh, ww, out_dim)
            ch = out_dim
            n += 1
        if i < len(cfg.channel_mults) - 1:
            if up3d[i]:
                caches[f"up_{n}/t"] = z2(hh, ww, ch)
            hh, ww, ch = 2 * hh, 2 * ww, ch // 2
            n += 1
    caches["head_conv"] = z2(hh, ww, ch)
    return caches
