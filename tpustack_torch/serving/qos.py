"""Multi-tenant QoS: priority classes, token-bucket quotas, SLO-aware shedding.

The port's copy of ``tpustack/serving/qos.py``: the enforcement half of
tenant accounting (:mod:`tpustack_torch.obs.accounting` measures who spends
the card; this module acts on it), wired into all three servers at three
points:

1. **Admission** (``ResilienceManager.middleware``): every work request
   resolves a *priority class* (``X-Priority`` header > body ``priority``
   field > per-tenant default in the policy > the policy's
   ``default_priority``), and
   - a tenant whose token bucket is in debt is shed 429 with a
     tenant-specific ``Retry-After``: that bucket's own refill ETA;
   - under ``TPUSTACK_MAX_QUEUE_DEPTH`` pressure, batch sheds before
     interactive: batch requests hit the 429 wall at ``batch_shed_ratio``
     (default 0.5) of the configured depth.
2. **Scheduling** (the llm ``ContinuousEngine``): the engine's refill pops
   interactive queue entries first, and when an interactive request would
   otherwise wait, a batch slot is preempted at a wave boundary: its state
   parks with its paged block refs retained and re-admits later through the
   prefix warm start, so no prefill work is lost (a greedy resumed row is
   byte-identical to an uninterrupted run).
3. **Observability**: priority lands as a root-span attribute and a
   flight-record field, the ``tpustack_qos_*`` catalog metrics count sheds,
   preemptions, throttles and per-priority goodput, and ``GET
   /debug/tenants`` reports the live bucket state.

**Quota model** (debt-tolerant token buckets): admission requires a
positive bucket balance; the actual cost (tokens and chip-seconds, the
ledger's own dimensions) is charged after the fact through a
:class:`~tpustack_torch.obs.accounting.TenantLedger` listener and may drive
the balance negative (debt).  A tenant in debt is refused until refill
clears it, and the 429's ``Retry-After`` is exactly that clearing time.

``TPUSTACK_QOS=0`` disables the whole layer: ``from_env`` returns None and
every integration point does nothing, so the admission path and engine
outputs are byte-for-byte the QoS-free stack.  ``TPUSTACK_QOS_POLICY`` is
inline JSON or a file path (the JAX package's ``docs/QOS.md`` documents the
schema).
"""

from __future__ import annotations

import json
import math
import threading
import time
from contextvars import ContextVar
from typing import Dict, Mapping, Optional

from tpustack_torch.utils import get_logger, knobs

log = get_logger("serving.qos")

__all__ = ["BATCH", "INTERACTIVE", "PRIORITIES", "QosPolicy", "TokenBucket",
           "current_priority"]

#: the two priority classes.  interactive preempts batch; batch sheds
#: first under queue pressure; the SLO burn-rate alert watches only
#: interactive.
INTERACTIVE = "interactive"
BATCH = "batch"
PRIORITIES = (INTERACTIVE, BATCH)

#: the request's resolved priority for the duration of its handler (set
#: by the resilience middleware when QoS is on).  Engine/worker threads
#: do NOT inherit it — they read the priority carried explicitly on the
#: request object (``SlotRequest.priority`` etc.), the same contract as
#: ``current_tenant`` and ``span_ctx``.
current_priority: ContextVar[Optional[str]] = ContextVar(
    "tpustack_priority", default=None)


class TokenBucket:
    """Debt-tolerant token bucket over one ledger cost dimension.

    ``level`` refills at ``rate`` per second up to ``burst`` and is
    *charged after the fact* with measured cost, so it may go negative
    (debt).  Admission asks :meth:`ready` (level > 0 — any positive
    balance admits; the eventual charge lands as debt) and a refused
    tenant gets :meth:`refill_eta_s` — the exact seconds until the
    bucket is positive again — as its Retry-After.
    """

    def __init__(self, rate_per_s: float, burst: float, clock=time.monotonic):
        if rate_per_s <= 0:
            raise ValueError(f"bucket rate must be > 0, got {rate_per_s}")
        self.rate = float(rate_per_s)
        self.burst = max(float(burst), 1e-9)
        self._clock = clock
        self.level = self.burst
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self.level = min(self.burst, self.level + (now - self._t) * self.rate)
        self._t = now

    def ready(self) -> bool:
        self._refill()
        return self.level > 0.0

    def charge(self, amount: float) -> None:
        if amount <= 0:
            return
        self._refill()
        self.level -= float(amount)

    def refill_eta_s(self) -> float:
        """Seconds until ``level`` crosses zero (0.0 when already
        positive) — the tenant-specific Retry-After for a quota shed."""
        self._refill()
        if self.level > 0.0:
            return 0.0
        # the epsilon puts the retry strictly past the zero crossing
        return (-self.level) / self.rate + 1e-3

    def snapshot(self) -> Dict:
        self._refill()
        return {"rate_per_s": self.rate, "burst": self.burst,
                "level": round(self.level, 6),
                "level_ratio": round(self.level / self.burst, 6),
                "refill_eta_s": round(self.refill_eta_s(), 3)}


class _TenantSpec:
    """One tenant's policy entry: a priority default plus optional
    buckets over the two ledger dimensions QoS meters."""

    __slots__ = ("priority", "buckets")

    def __init__(self, name: str, cfg: Mapping, default_priority: str,
                 clock=time.monotonic):
        prio = str(cfg.get("priority", default_priority)).strip().lower()
        if prio not in PRIORITIES:
            raise ValueError(f"QoS policy tenant {name!r}: priority "
                             f"{prio!r} not in {PRIORITIES}")
        self.priority = prio
        self.buckets: Dict[str, TokenBucket] = {}
        for dim, rate_key, burst_key in (
                ("tokens", "tokens_per_s", "burst_tokens"),
                ("chip_seconds", "chip_seconds_per_s", "burst_chip_seconds")):
            rate = cfg.get(rate_key)
            if rate is None:
                continue
            rate = float(rate)
            # default burst: 2 seconds of rate — enough headroom that a
            # single in-quota request never trips its own bucket
            burst = float(cfg.get(burst_key, 2.0 * rate))
            self.buckets[dim] = TokenBucket(rate, burst, clock=clock)


class QosPolicy:
    """The policy object one server process threads through admission,
    scheduling and accounting.  Thread-safe: charges come from engine/
    worker threads, checks from the event loop.

    ``cfg`` schema (``TPUSTACK_QOS_POLICY``, inline JSON or a file)::

        {
          "default_priority": "interactive",      # optional
          "batch_shed_ratio": 0.5,                # optional, (0, 1]
          "tenants": {
            "bulk-ingest": {
              "priority": "batch",
              "tokens_per_s": 500,  "burst_tokens": 2000,
              "chip_seconds_per_s": 0.5, "burst_chip_seconds": 4.0
            }
          }
        }

    Tenants absent from the policy get ``default_priority`` and NO
    quota.  Policy tenant names are operator-declared config — a bounded
    set, unlike client-minted tenant ids — which is what makes the
    per-tenant bucket gauges safe to export.
    """

    def __init__(self, cfg: Optional[Mapping] = None, registry=None,
                 clock=time.monotonic):
        from tpustack_torch.obs import catalog

        cfg = dict(cfg or {})
        self.default_priority = str(
            cfg.get("default_priority", INTERACTIVE)).strip().lower()
        if self.default_priority not in PRIORITIES:
            raise ValueError(f"QoS policy: default_priority "
                             f"{self.default_priority!r} not in {PRIORITIES}")
        self.batch_shed_ratio = float(cfg.get("batch_shed_ratio", 0.5))
        if not 0.0 < self.batch_shed_ratio <= 1.0:
            raise ValueError(f"QoS policy: batch_shed_ratio "
                             f"{self.batch_shed_ratio} outside (0, 1]")
        tenants = cfg.get("tenants") or {}
        if not isinstance(tenants, Mapping):
            raise ValueError("QoS policy: 'tenants' must be an object")
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantSpec] = {
            str(name): _TenantSpec(str(name), tcfg, self.default_priority,
                                   clock=clock)
            for name, tcfg in tenants.items()}
        m = catalog.build(registry)
        self._m_shed = m["tpustack_qos_shed_total"]
        self._m_preempt = m["tpustack_qos_preempt_total"]
        self._m_throttle = m["tpustack_qos_quota_throttle_total"]
        self._m_bucket = m["tpustack_qos_bucket_level_ratio"]
        self._m_queue_wait = m["tpustack_qos_queue_wait_seconds"]
        # exact internal counters, per priority: what snapshot() reports
        # without reading the metric families back
        self.counters: Dict[str, Dict[str, int]] = {
            k: {} for k in ("shed", "preempt", "quota_throttle")}

    # ------------------------------------------------------- construction
    @staticmethod
    def from_env(registry=None, env=None) -> Optional["QosPolicy"]:
        """The serving entry point: None when ``TPUSTACK_QOS=0`` (every
        integration point then no-ops — the bisection contract), else a
        policy from ``TPUSTACK_QOS_POLICY`` (inline JSON when the value
        starts with ``{``, otherwise a file path; empty = priorities
        only, no quotas).  A malformed policy raises at startup — a
        silently-dropped quota is an outage waiting for load."""
        if not knobs.get_bool("TPUSTACK_QOS", env=env):
            return None
        raw = knobs.get_str("TPUSTACK_QOS_POLICY", env=env).strip()
        cfg: Dict = {}
        if raw:
            if raw.startswith("{"):
                cfg = json.loads(raw)
            else:
                with open(raw) as f:
                    cfg = json.load(f)
        policy = QosPolicy(cfg, registry=registry)
        if cfg:
            log.info("QoS policy: default=%s, batch sheds at %.0f%% depth, "
                     "%d quota tenant(s)", policy.default_priority,
                     100 * policy.batch_shed_ratio, len(policy._tenants))
        return policy

    # ---------------------------------------------------------- priorities
    def resolve_priority(self, header: Optional[str] = None,
                         body_value=None,
                         tenant: Optional[str] = None) -> str:
        """Per-request priority class: ``X-Priority`` header > body
        ``priority`` field > the tenant's policy default > the policy
        default.  Unknown values fall through to the next source — a
        typo'd priority must degrade to the default, not 500 the
        request.

        A tenant the operator pinned to ``batch`` in the policy can
        never self-promote: client-supplied values are clamped to batch
        for it (self-DEMOTION to batch is always honoured — an
        interactive tenant marking bulk requests batch is cooperative).
        Without the clamp, one ``X-Priority: interactive`` header from
        the saturating batch tenant would reinstate exactly the
        starvation this module exists to prevent."""
        spec = self._tenants.get(tenant) if tenant else None
        for cand in (header, body_value):
            if isinstance(cand, str) and cand.strip().lower() in PRIORITIES:
                p = cand.strip().lower()
                if spec is not None and spec.priority == BATCH:
                    return BATCH
                return p
        return spec.priority if spec is not None else self.default_priority

    def batch_shed_depth(self, max_queue_depth: int) -> int:
        """The queue depth at which BATCH requests shed: a fraction of
        the configured cap, so batch backpressure starts while
        interactive still has headroom."""
        return max(1, int(math.ceil(max_queue_depth * self.batch_shed_ratio)))

    # -------------------------------------------------------------- quotas
    def quota_check(self, tenant: Optional[str]) -> Optional[float]:
        """None to admit; else the tenant-specific Retry-After in seconds
        (the max refill ETA over that tenant's exhausted buckets)."""
        spec = self._tenants.get(tenant) if tenant else None
        if spec is None or not spec.buckets:
            return None
        eta = 0.0
        with self._lock:
            for dim, bucket in spec.buckets.items():
                if not bucket.ready():
                    eta = max(eta, bucket.refill_eta_s())
                self._export_bucket(tenant, dim, bucket)
        return eta if eta > 0.0 else None

    def on_ledger_charge(self, server: str, tenant: Optional[str],
                         dimension: str, amount: float) -> None:
        """TenantLedger listener: measured cost drives the tenant's
        bucket into (possibly negative) balance.  ``dimension`` is the
        ledger's own name — only ``tokens`` and ``chip_seconds`` are
        metered; the rest pass through."""
        spec = self._tenants.get(tenant) if tenant else None
        if spec is None:
            return
        bucket = spec.buckets.get(dimension)
        if bucket is None:
            return
        with self._lock:
            bucket.charge(amount)
            self._export_bucket(tenant, dimension, bucket)

    def _export_bucket(self, tenant: str, dim: str,
                       bucket: TokenBucket) -> None:
        # (lock held) policy tenants are operator-declared config, a
        # bounded set by construction, so this tenant label cannot be
        # minted by clients; everything client-supplied still goes
        # through the ledger's bounded canonicalisation
        self._m_bucket.labels(tenant=tenant, dimension=dim).set(bucket.level / bucket.burst)

    # ------------------------------------------------------------- metrics
    def _count(self, kind: str, priority: str) -> None:
        with self._lock:
            c = self.counters[kind]
            c[priority] = c.get(priority, 0) + 1

    def note_shed(self, server: str, priority: Optional[str]) -> None:
        p = priority or self.default_priority
        self._m_shed.labels(server=server, priority=p).inc()
        self._count("shed", p)

    def note_preempt(self, priority: Optional[str] = BATCH) -> None:
        p = priority or BATCH
        self._m_preempt.labels(priority=p).inc()
        self._count("preempt", p)

    def note_quota_throttle(self, server: str,
                            priority: Optional[str]) -> None:
        p = priority or self.default_priority
        self._m_throttle.labels(server=server, priority=p).inc()
        self._count("quota_throttle", p)

    def observe_queue_wait(self, server: str, priority: Optional[str],
                           seconds: float) -> None:
        """Admission-queue wall time per priority class — recorded at
        each server's own pickup point: llm at ``feed()``'s queue pop,
        sd at the micro-batch build, graph at the worker's pickup (the
        three places a request stops waiting and starts costing chip)."""
        self._m_queue_wait.labels(
            server=server,
            priority=priority or self.default_priority).observe(seconds)

    # ------------------------------------------------------------- reading
    def snapshot(self) -> Dict:
        """Live policy + bucket state, merged into ``GET /debug/tenants``."""
        with self._lock:
            tenants = {}
            for name, spec in self._tenants.items():
                tenants[name] = {
                    "priority": spec.priority,
                    "buckets": {dim: b.snapshot()
                                for dim, b in spec.buckets.items()},
                }
            return {
                "enabled": True,
                "default_priority": self.default_priority,
                "batch_shed_ratio": self.batch_shed_ratio,
                "counters": {k: dict(v) for k, v in self.counters.items()},
                "tenants": tenants,
            }
