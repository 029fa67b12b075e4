"""tpustack_torch: the PyTorch and CUDA port of ``tpustack`` for NVIDIA H100.

A package of its own beside the JAX one: it imports ``torch``, numpy and the
standard library, never ``jax`` or ``tpustack``.  Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path is a hand-written CUDA
kernel under ``ops/csrc/``, built at first use.

Entry points run on CUDA unless the caller asks for ``device="cpu"``, and
raise when there is no GPU and no such request.
"""

from tpustack_torch.utils import get_logger, resolve_device

__version__ = "0.1.0"
__all__ = ["get_logger", "resolve_device"]
