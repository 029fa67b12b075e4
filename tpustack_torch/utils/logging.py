"""Logging and device resolution for the port.

``get_logger`` writes plain text lines to stdout under ``tpustack_torch.*``,
each carrying the current request id (``rid=<12 hex>``, ``-`` outside a
request; :mod:`tpustack_torch.obs.trace`); ``TPUSTACK_LOG_LEVEL`` picks the
level (default INFO), as in the JAX package.

``resolve_device`` is how every entry point picks its device: CUDA unless
the caller asks for the CPU, and an error when there is no GPU and no such
request.  It never drops to the CPU on its own.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Union

import torch

_FORMAT = "%(asctime)s %(levelname)s [%(name)s] [rid=%(request_id)s] %(message)s"
_configured = False


class _RequestIdFilter(logging.Filter):
    """Stamp the context's request id on every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        from tpustack_torch.obs.trace import current_request_id

        record.request_id = current_request_id.get()
        return True


def get_logger(name: str) -> logging.Logger:
    global _configured
    root = logging.getLogger("tpustack_torch")
    if not _configured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(_RequestIdFilter())
        root.addHandler(handler)
        root.setLevel(os.environ.get("TPUSTACK_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _configured = True
    return root.getChild(name)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the first GPU.

    Raises when a CUDA device is wanted (explicitly or by default) and none
    is available: pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(or SD15_DEVICE=cpu for the server) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
