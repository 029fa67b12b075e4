"""Typed registry of the ``TPUSTACK_*`` environment knobs the port reads.

The port's copy of ``tpustack/utils/knobs.py``: the same names, types,
defaults and parsing, for the knobs of the serving surface (resilience,
fault injection, tracing, the flight recorder, the admin token, tenant
accounting, multi-tenant QoS) and of the LLM engine's modes (the dense
engine, the dense prefix store, the host KV tier, chunked prefill, the
draft-model drafter).  Every
knob is declared once in :data:`REGISTRY` and read through the typed
accessors, which raise on an undeclared name, a wrong type or a value that
does not parse.  The older port modules read their model and engine knobs
(``LLM_*``, ``SD15_*``, ``WAN_*``) directly.

Parsing: int/float unset or blank -> default, else ``int()``/``float()``
with a ``ValueError`` naming the knob; bool unset or blank -> default, else
one of ``1/true/yes/on`` or ``0/false/no/off`` (case-insensitive), anything
else a ``ValueError``; str unset -> default.  Accessors take
an optional ``env`` mapping (default ``os.environ``) so components built
with an injected environment (``FaultInjector``, ``Tracer``,
``ResilienceManager``) keep to it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str
    type: type  # str | int | float | bool
    default: object
    doc: str


REGISTRY: Dict[str, Knob] = {}


def _declare(name: str, type_: type, default, doc: str) -> None:
    if name in REGISTRY:
        raise ValueError(f"duplicate knob declaration {name}")
    if not isinstance(default, type_) or (type_ is int and isinstance(default, bool)):
        raise TypeError(f"{name}: default {default!r} is not {type_.__name__}")
    REGISTRY[name] = Knob(name, type_, default, doc)


# --------------------------------------------------------------- resilience
_declare("TPUSTACK_DRAIN_TIMEOUT_S", float, 30.0,
         "Max seconds to wait for in-flight work after SIGTERM before "
         "exiting.")
_declare("TPUSTACK_DRAIN_LINGER_S", float, 0.0,
         "Accept-and-poll servers: keep the read surface alive this long "
         "after the last prompt publishes so pollers can fetch results.")
_declare("TPUSTACK_REQUEST_TIMEOUT_S", float, 600.0,
         "Default per-request deadline in seconds (0 disables; request "
         "body timeout_s overrides).")
_declare("TPUSTACK_MAX_QUEUE_DEPTH", int, 64,
         "Waiting-work cap before shedding with 429 + Retry-After "
         "(0 disables).")
_declare("TPUSTACK_WATCHDOG_S", float, 0.0,
         "No-progress seconds before liveness flips 503 (0 disables; set "
         "above the worst cold-compile dispatch).")
_declare("TPUSTACK_ADMIN_TOKEN", str, "",
         "Shared secret for the authenticated admin surface (POST "
         "/admin/drain).  Empty disables the surface entirely — every "
         "request 403s, so an unconfigured fleet exposes nothing.")

# ------------------------------------------------------------ fault injection
_declare("TPUSTACK_FAULT_SLOW_PREFILL_S", float, 0.0,
         "Sleep injected before every device dispatch (deterministic "
         "fault).")
_declare("TPUSTACK_FAULT_DEVICE_ERROR_NTH", int, 0,
         "The Nth dispatch raises a one-shot transient device error.")
_declare("TPUSTACK_FAULT_HANG_NTH", int, 0,
         "The Nth dispatch hangs for TPUSTACK_FAULT_HANG_S.")
_declare("TPUSTACK_FAULT_HANG_S", float, 3600.0,
         "Hang duration for the injected dispatch hang.")
_declare("TPUSTACK_FAULT_SIGTERM_AFTER", int, 0,
         "Begin drain after the Nth completed wave (mid-request SIGTERM).")

# ------------------------------------------------------------ observability
_declare("TPUSTACK_TRACE_BUFFER", int, 128,
         "Recent-traces ring buffer size in the in-process trace store.")
_declare("TPUSTACK_TRACE_SLOW_S", float, 5.0,
         "Traces at or above this duration are always kept (survive the "
         "ring buffer's churn).")
_declare("TPUSTACK_FLIGHT_RECORDS", int, 512,
         "Flight-recorder ring capacity: per-dispatch engine records "
         "retained for /debug/flight and post-mortem dumps.")
_declare("TPUSTACK_FLIGHT_DUMP_DIR", str, "/tmp/tpustack-flight",
         "Directory for flight-recorder JSON dumps (watchdog fire, SIGTERM "
         "drain, fatal engine error, sanitizer violation); empty disables "
         "dumping.")
_declare("TPUSTACK_TENANT_CARDINALITY", int, 32,
         "Max distinct tenant label values on tenant-labelled metrics; "
         "tenants beyond the first N collapse into the 'other' overflow "
         "bucket (bounds scrape cardinality under hostile tenant ids).")
_declare("TPUSTACK_TENANT_DEFAULT", str, "anonymous",
         "Tenant charged for requests that carry no X-Tenant-Id header "
         "and no body 'tenant' field.")

# --------------------------------------------------------------------- QoS
_declare("TPUSTACK_QOS", bool, True,
         "Multi-tenant QoS layer (tpustack_torch.serving.qos): priority "
         "classes at admission/scheduling, per-tenant token-bucket quotas, "
         "and SLO-aware shedding; 0 is the bisection flag — the admission "
         "path and engine outputs are byte-for-byte the QoS-free stack.")
_declare("TPUSTACK_QOS_POLICY", str, "",
         "QoS policy: inline JSON (starts with '{') or a path to a JSON "
         "file — per-tenant priority defaults and token-bucket quotas; "
         "empty = priorities only, no quotas.")


# ------------------------------------------------------------- LLM engine
_declare("TPUSTACK_PAGED_KV", bool, True,
         "Paged KV substrate for batched serving (block pool + block "
         "tables); 0 falls back to the dense per-slot engine (bisection).")
_declare("TPUSTACK_PREFIX_CACHE_MB", float, 512.0,
         "Resident host-byte cap for the DENSE prefix cache store.")
_declare("TPUSTACK_PREFIX_CACHE_CHUNK", int, 256,
         "Snap granularity in tokens for the dense prefix cache.")
_declare("TPUSTACK_KV_HOST_TIER_MB", float, 0.0,
         "Host-RAM second tier for the paged prefix cache: evicted "
         "refcount-0 prefix blocks spill device->host into an LRU arena "
         "of this many megabytes instead of dying, and a warm match "
         "restores them pool-side in one copy (no prefill FLOPs).  0 is "
         "the bisection flag: no tier constructs, eviction and match are "
         "byte-for-byte the tier-free paths.")
_declare("TPUSTACK_KV_HOST_TIER_CROSSOVER", bool, True,
         "Restore-vs-recompute crossover guard for the host KV tier: when "
         "on (default), a warm host-tier match only restores if the "
         "measured per-block copy cost undercuts the measured per-block "
         "prefill cost.  0 restores unconditionally (tiny/CPU shapes, "
         "where both averages measure dispatch noise).")
_declare("TPUSTACK_PREFILL_CHUNK_TOKENS", int, 0,
         "Chunked prefill for the paged continuous engine: a prompt whose "
         "uncached remainder exceeds this many tokens prefills in "
         "block-aligned chunks of (at most) this size, parking between "
         "chunks so decode waves of other slots interleave.  Admission "
         "still charges the full block footprint up front.  0 disables "
         "(admission is byte-for-byte the monolithic prefill).")
_declare("TPUSTACK_SPEC_DRAFT", str, "",
         "Draft-model preset (tiny | llama2_7b | qwen25_7b); empty keeps "
         "the n-gram prompt-lookup drafter.")
_declare("TPUSTACK_SPEC_DRAFT_DIR", str, "",
         "Safetensors dir for the draft model; empty = random weights "
         "(rehearsal-grade).")


# ------------------------------------------------------------------ readers
def _knob(name: str, expect: type) -> Knob:
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"unknown knob {name!r}: declare it in tpustack_torch/utils/knobs.py")
    if knob.type is not expect:
        raise TypeError(f"knob {name} is declared {knob.type.__name__}, "
                        f"read as {expect.__name__}")
    return knob


def get_str(name: str, env: Optional[Mapping[str, str]] = None) -> str:
    knob = _knob(name, str)
    val = (os.environ if env is None else env).get(name)
    return knob.default if val is None else val


def get_int(name: str, env: Optional[Mapping[str, str]] = None) -> int:
    knob = _knob(name, int)
    val = (os.environ if env is None else env).get(name)
    if val is None or not val.strip():
        return knob.default
    try:
        return int(val)
    except ValueError:
        raise ValueError(f"{name}={val!r} is not an integer") from None


_TRUTHY = frozenset({"1", "true", "yes", "on"})
_FALSY = frozenset({"0", "false", "no", "off"})


def get_bool(name: str, env: Optional[Mapping[str, str]] = None) -> bool:
    knob = _knob(name, bool)
    val = (os.environ if env is None else env).get(name)
    if val is None or not val.strip():
        return knob.default
    low = val.strip().lower()
    if low in _TRUTHY:
        return True
    if low in _FALSY:
        return False
    raise ValueError(f"{name}={val!r} is not a boolean (want 1/true/yes/on or 0/false/no/off)")


def get_float(name: str, env: Optional[Mapping[str, str]] = None) -> float:
    knob = _knob(name, float)
    val = (os.environ if env is None else env).get(name)
    if val is None or not val.strip():
        return knob.default
    try:
        return float(val)
    except ValueError:
        raise ValueError(f"{name}={val!r} is not a number") from None
