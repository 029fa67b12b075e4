"""Wan2.1 text-to-video in PyTorch: the port of ``tpustack.models.wan``.

The serving path only: the UMT5 text encoder, the space-time DiT, the
causal 3D VAE decoder (whole-sequence and streaming) and the pipeline.  The
VAE encoder and the ``"tpu"`` VAE arch are not ported yet.
"""

from tpustack_torch.models.wan.config import UMT5Config, WanConfig, WanDiTConfig, WanVAEConfig
from tpustack_torch.models.wan.pipeline import WanPipeline
from tpustack_torch.models.wan.wanvae import WanVAEDecoder

__all__ = ["WanConfig", "WanDiTConfig", "WanVAEConfig", "UMT5Config", "WanPipeline",
           "WanVAEDecoder"]
