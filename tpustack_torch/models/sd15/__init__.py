"""Stable Diffusion 1.5 in PyTorch: the port of ``tpustack.models.sd15``."""

from tpustack_torch.models.sd15.config import SD15Config
from tpustack_torch.models.sd15.pipeline import SD15Pipeline

__all__ = ["SD15Config", "SD15Pipeline"]
