"""Device-memory gauges for a port server, read at scrape time.

The port's counterpart of ``tpustack/obs/device.py``: a collector
(``Registry.add_collector``) that sets ``tpustack_device_hbm_used_bytes``
(the caching allocator's allocated bytes, ``torch.cuda.memory_stats``) and
``tpustack_device_hbm_limit_bytes`` (``torch.cuda.mem_get_info``'s total)
per CUDA device, labelled ``cuda:<index>``, when Prometheus asks.  A
process with no CUDA device, or one that has not initialised CUDA yet,
writes no sample: the families stay sample-less (HELP/TYPE only) rather
than report zeros.  The JAX module's compile-cache gauges have no
counterpart: eager PyTorch keeps no persistent compile cache.
"""

from __future__ import annotations

import time
import weakref
from typing import Optional

from tpustack_torch.obs import catalog
from tpustack_torch.obs.metrics import REGISTRY, Registry

# WeakSet, not id()s: a recycled id from a collected test registry must not
# make a fresh registry skip installation
_installed: "weakref.WeakSet[Registry]" = weakref.WeakSet()


def install(registry: Optional[Registry] = None) -> None:
    """Idempotently stamp the start time and wire the device collector into
    ``registry`` (servers call it once at startup)."""
    registry = registry or REGISTRY
    if registry in _installed:
        return
    _installed.add(registry)
    catalog.build(registry)["tpustack_process_start_time_seconds"].set(time.time())
    registry.add_collector(_collect_device_memory)


def _collect_device_memory(registry: Registry) -> None:
    import torch

    # a scrape thread must not be the one that creates a CUDA context
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    m = catalog.build(registry)
    used = m["tpustack_device_hbm_used_bytes"]
    limit = m["tpustack_device_hbm_limit_bytes"]
    for i in range(torch.cuda.device_count()):
        name = f"cuda:{i}"
        stats = torch.cuda.memory_stats(i)
        used.labels(device=name).set(stats.get("allocated_bytes.all.current", 0))
        limit.labels(device=name).set(torch.cuda.mem_get_info(i)[1])
