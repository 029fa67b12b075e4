from tpustack_torch.utils.logging import get_logger, resolve_device

__all__ = ["get_logger", "resolve_device"]
