"""tpustack_torch.obs: metrics, tracing and the flight recorder of the port.

The port's copies of the JAX package's ``tpustack/obs`` modules this slice
serves, standard library only:

- :mod:`~tpustack_torch.obs.metrics`: Counter / Gauge / Histogram, the
  Prometheus text exposition and the process-wide ``REGISTRY``.
- :mod:`~tpustack_torch.obs.catalog`: every family the port exports, with
  the JAX catalog's names, kinds, labels and buckets.
- :mod:`~tpustack_torch.obs.trace`: request ids (``rid=`` on log lines),
  phase timings, span trees and W3C ``traceparent``.
- :mod:`~tpustack_torch.obs.flight`: the engine flight recorder behind
  ``GET /debug/flight``.
- :mod:`~tpustack_torch.obs.device`: scrape-time device-memory gauges.
- :mod:`~tpustack_torch.obs.http`: routes, request instrumentation and the
  ``/metrics`` and ``/debug/*`` endpoints for ``http.server``.
"""

from tpustack_torch.obs.metrics import (CONTENT_TYPE, DEFAULT_BUCKETS, REGISTRY, Counter, Gauge,
                                        Histogram, Registry)
from tpustack_torch.obs.trace import (TRACER, Span, SpanContext, Trace, Tracer,
                                      current_request_id, current_span, format_traceparent,
                                      new_request_id, parse_traceparent)

__all__ = [
    "CONTENT_TYPE", "DEFAULT_BUCKETS", "REGISTRY", "TRACER", "Counter",
    "Gauge", "Histogram", "Registry", "Span", "SpanContext", "Trace",
    "Tracer", "current_request_id", "current_span",
    "format_traceparent", "new_request_id", "parse_traceparent",
]
