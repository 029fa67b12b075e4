"""Stable Diffusion 1.5 model configuration.

The same dataclasses and presets as ``tpustack/models/sd15/config.py``, so a
configuration means the same architecture in both packages; only
``compute_dtype`` is a ``torch.dtype`` here.  ``sd15()`` is the full SD1.5
architecture (bf16 compute on the card), ``tiny()`` toy widths for CPU tests
and fast server boots on the same code path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP ViT-L/14 text encoder (the SD1.5 text tower)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    layer_norm_eps: float = 1e-5
    # SD1.5's CLIP uses quick_gelu (x * sigmoid(1.702 x)).
    activation: str = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """UNet2DConditionModel as configured for SD1.5."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # True = block has cross-attention transformers (SD1.5: first three down
    # blocks and last three up blocks).
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    attention_head_dim: int = 8  # heads per attention (diffusers name kept)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    time_embed_dim_mult: int = 4  # time_embed_dim = block_out[0] * 4
    transformer_layers: int = 1
    # attention dispatch for the spatial transformers: "auto"
    # (ops.attention.auto_impl), "xla" (plain PyTorch) or "flash" (the kernel)
    attn_impl: str = "auto"

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL as configured for SD1.5 (f8, 4 latent channels)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2  # encoder; decoder uses layers_per_block + 1
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class SD15Config:
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    dtype: str = "bfloat16"  # compute dtype; params are held in it too

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def vae_scale(self) -> int:
        return 2 ** (len(self.vae.block_out_channels) - 1)

    @classmethod
    def sd15(cls, dtype: str = "bfloat16") -> "SD15Config":
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls, dtype: str = "float32") -> "SD15Config":
        """Toy widths for tests/debug servers; same code path as sd15()."""
        return cls(
            text=CLIPTextConfig(
                # >= the vendored BPE's 6514 ids, so the tiny tower takes the
                # real tokenizer as sd15() does
                vocab_size=6656, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, max_length=16,
            ),
            unet=UNetConfig(
                block_out_channels=(32, 32, 64, 64),
                layers_per_block=1,
                down_block_has_attn=(True, True, True, False),
                attention_head_dim=4,
                cross_attention_dim=64,
                norm_num_groups=8,
            ),
            # the real f8 geometry (4 levels), so width/height semantics and
            # the latent token counts attention sees match sd15()
            vae=VAEConfig(
                block_out_channels=(16, 16, 32, 32),
                layers_per_block=1,
                norm_num_groups=8,
            ),
            dtype=dtype,
        )
