"""Wan2.1 text-to-video model configuration.

The same dataclasses and presets as ``tpustack/models/wan/config.py``, so a
configuration means the same architecture in both packages; only
``compute_dtype`` is a ``torch.dtype`` here.  ``wan_1_3b()`` is the Wan2.1
1.3B T2V shape (DiT dim 1536, 30 layers, 12 heads of 128; umt5-xxl text
tower; the z=16 causal 3D VAE), bf16 compute on the card; ``tiny()`` is a
shape-preserving miniature for CPU tests and fast server boots.

``UMT5Config.quant="int8"`` is the weight-only int8 text tower
(``ops.quant``).  Not ported yet: the ``"tpu"`` VAE arch (``vae3d``); it
raises here rather than being ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Per-channel stats of the z=16 Wan 2.1 latent space (code-side constants
# upstream as well; they are not stored in the VAE checkpoint file).
WAN21_LATENT_MEAN: Tuple[float, ...] = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921)
WAN21_LATENT_STD: Tuple[float, ...] = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160)


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    """UMT5 encoder (the google/umt5-xxl shape of the real checkpoint)."""

    vocab_size: int = 256384
    dim: int = 4096
    ffn_dim: int = 10240
    num_heads: int = 64
    head_dim: int = 64
    num_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    max_length: int = 512
    dropout: float = 0.0
    # "int8": the weight-only quantised tower (ops.quant; umt5-xxl's
    # projections and embedding table, 5.7 GB instead of 11.4 in bf16)
    quant: Optional[str] = None

    def __post_init__(self):
        if self.quant not in (None, "int8"):
            raise ValueError(f"UMT5Config.quant={self.quant!r} unsupported (None or 'int8')")


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    """Causal 3D video VAE: 8x spatial, 4x temporal compression, z=16.

    Only ``arch="wan"`` (the checkpoint-mapped Wan 2.1 architecture) is
    ported; ``"tpu"`` raises."""

    z_channels: int = 16
    base_channels: int = 96
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    # encoder stages whose downsample also halves time; the decoder mirrors
    # them reversed (Wan 2.1: temperal_upsample = [True, True, False])
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    arch: str = "wan"
    # the DiT works on (mu - mean) / std; None means identity (tiny, z != 16)
    latent_mean: Optional[Tuple[float, ...]] = WAN21_LATENT_MEAN
    latent_std: Optional[Tuple[float, ...]] = WAN21_LATENT_STD
    scaling_factor: float = 1.0

    def __post_init__(self):
        if self.arch != "wan":
            raise NotImplementedError(
                f"WanVAEConfig.arch={self.arch!r}: only the checkpoint-mapped "
                "'wan' VAE is ported; the 'tpu' arch (vae3d) is queued")

    @property
    def spatial_scale(self) -> int:
        return 2 ** (len(self.channel_mults) - 1)

    @property
    def temporal_scale(self) -> int:
        return 2 ** sum(self.temporal_downsample)


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    """Space-time diffusion transformer (Wan2.1 1.3B shape)."""

    dim: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    num_layers: int = 30
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)  # (frames, h, w)
    qk_norm: bool = True
    eps: float = 1e-6
    # "auto" | "xla" | "flash": ops.attention.dot_product_attention's impl
    attn_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class WanConfig:
    text: UMT5Config
    vae: WanVAEConfig
    dit: WanDiTConfig
    # flow-matching timestep shift (Wan T2V default 5.0)
    flow_shift: float = 5.0
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def wan_1_3b() -> "WanConfig":
        return WanConfig(text=UMT5Config(), vae=WanVAEConfig(), dit=WanDiTConfig())

    @staticmethod
    def tiny() -> "WanConfig":
        """Shape-preserving miniature for tests (CPU, float32)."""
        return WanConfig(
            text=UMT5Config(vocab_size=512, dim=32, ffn_dim=64, num_heads=2,
                            head_dim=16, num_layers=2, max_length=16),
            vae=WanVAEConfig(z_channels=4, base_channels=8,
                             channel_mults=(1, 2, 4, 4), num_res_blocks=1,
                             temporal_downsample=(False, True, True),
                             latent_mean=None, latent_std=None),
            dit=WanDiTConfig(dim=32, ffn_dim=64, num_heads=2, num_layers=2,
                             in_channels=4, out_channels=4, text_dim=32,
                             freq_dim=32),
            flow_shift=5.0,
            compute_dtype=torch.float32,
        )

    def latent_shape(self, frames: int, height: int, width: int) -> Tuple[int, int, int, int]:
        """``[F', H', W', C]`` latent shape for a pixel-space request."""
        ts, ss = self.vae.temporal_scale, self.vae.spatial_scale
        if (frames - 1) % ts:
            raise ValueError(f"frames must be 1 + multiple of {ts}, got {frames}")
        if height % (ss * self.dit.patch_size[1]) or width % (ss * self.dit.patch_size[2]):
            raise ValueError(
                f"height/width must be multiples of {ss * self.dit.patch_size[1]}")
        return ((frames - 1) // ts + 1, height // ss, width // ss,
                self.vae.z_channels)
