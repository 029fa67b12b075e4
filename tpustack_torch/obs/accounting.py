"""Tenant-attributed cost accounting: who is spending the card.

The port's copy of ``tpustack/obs/accounting.py``.  Every request is
charged to a *tenant*, taken from an ``X-Tenant-Id`` header or a body
``tenant`` field, once, in the :func:`~tpustack_torch.obs.http.instrument`
wrapper, and the :class:`TenantLedger` accumulates five cost dimensions per
tenant:

- **tokens**: prompt tokens prefilled and tokens generated (llm);
- **chip-seconds**: each engine wave's wall time split across the slots it
  served, charged FROM the same flight records ``/debug/flight`` serves
  (``charge_flight_wave`` takes the record dict itself), so live
  attribution and the flight recorder cannot disagree;
- **KV-block-seconds**: paged pool blocks held x seconds held,
  alloc -> release;
- **queue-seconds**: admission-queue wall time;
- **goodput**: request outcomes (``ok`` = completed in-deadline, vs
  ``shed``/``deadline``/``error``).

Label cardinality is bounded: the first ``TPUSTACK_TENANT_CARDINALITY``
distinct tenants get their own label value; every later arrival aggregates
into the ``other`` overflow bucket, so a client minting a fresh tenant id
per request adds at most one series per metric.

The ledger is the single writer of the ``tpustack_tenant_*`` catalog
metrics and keeps its own exact totals, served as ``GET /debug/tenants`` on
all three servers.  Listeners (the QoS layer's quota buckets) hear the
metered charges.  Thread-safety: one lock around the account table;
charges come from handler threads, the engine thread, the SD batch threads
and the graph worker.  Charging is a dict update and a few counter
increments, never a device sync.
"""

from __future__ import annotations

import re
import threading
from contextvars import ContextVar
from typing import Dict, Mapping, Optional

from tpustack_torch.utils import knobs

__all__ = [
    "LEDGER", "OVERFLOW_TENANT", "TenantLedger", "current_tenant",
    "for_registry", "outcome_from_status", "resolve_tenant",
    "sanitize_tenant",
]

#: the request's tenant for the duration of its handler (set by the
#: ``instrument()`` middleware).  Engine/worker threads do NOT inherit it
#: — they read the tenant carried explicitly on the request object
#: (``SlotRequest.tenant`` etc.), same contract as ``span_ctx``.
current_tenant: ContextVar[Optional[str]] = ContextVar(
    "tpustack_tenant", default=None)

#: the bounded-cardinality overflow bucket every tenant past the cap
#: collapses into
OVERFLOW_TENANT = "other"

#: goodput outcomes: ok / (ok + shed + deadline + error).  client_error
#: (a 4xx the CLIENT caused) is tracked but excluded from the ratio — a
#: malformed request is not the server failing the tenant.
GOODPUT_OUTCOMES = ("ok", "shed", "deadline", "error")

_TENANT_BAD_CHARS = re.compile(r"[^a-zA-Z0-9._-]")
_TENANT_MAX_LEN = 64


def sanitize_tenant(raw) -> Optional[str]:
    """Normalise a client-supplied tenant id into a safe label value:
    non-string/blank → None; otherwise strip, replace anything outside
    ``[a-zA-Z0-9._-]``, cap at 64 chars.  A client claiming the literal
    overflow bucket name is renamed — ``other`` must only ever mean "the
    cardinality cap's tail", never a tenant someone chose."""
    if not isinstance(raw, str):
        return None
    t = raw.strip()
    if not t:
        return None
    t = _TENANT_BAD_CHARS.sub("_", t)[:_TENANT_MAX_LEN]
    if t == OVERFLOW_TENANT:
        t = "other_"
    return t


def resolve_tenant(header: Optional[str] = None,
                   body: Optional[Mapping] = None) -> str:
    """The extraction order ``instrument()`` uses: ``X-Tenant-Id`` header
    first, then a JSON body's ``tenant`` field, then the configured
    default (``TPUSTACK_TENANT_DEFAULT``) — a request always HAS a
    tenant, so the accounting has no unattributed bucket to hide cost
    in."""
    t = sanitize_tenant(header)
    if t is None and isinstance(body, Mapping):
        t = sanitize_tenant(body.get("tenant"))
    return t if t is not None else knobs.get_str("TPUSTACK_TENANT_DEFAULT")


def outcome_from_status(status: int) -> str:
    """HTTP status → goodput outcome: 2xx/3xx ``ok``; 429/503 ``shed``
    (the resilience layer refused the work); 504 ``deadline``; other 4xx
    ``client_error`` (excluded from goodput); 5xx ``error``."""
    s = int(status)
    if s < 400:
        return "ok"
    if s in (429, 503):
        return "shed"
    if s == 504:
        return "deadline"
    if s < 500:
        return "client_error"
    return "error"


def _fresh_account() -> Dict:
    return {
        "prompt_tokens": 0,
        "generated_tokens": 0,
        "chip_seconds": 0.0,
        "kv_block_seconds": 0.0,
        "queue_seconds": 0.0,
        "outcomes": {},
    }


class TenantLedger:
    """Bounded per-tenant cost accounts + the single writer of every
    ``tpustack_tenant_*`` metric.

    ``cardinality`` caps DISTINCT tenant label values (the ``other``
    overflow bucket is the +1); None reads
    ``TPUSTACK_TENANT_CARDINALITY``.  Accounts nest tenant → server →
    totals so one ledger serves a multi-server process and ``/debug/
    tenants`` can show the split.
    """

    def __init__(self, registry=None, cardinality: Optional[int] = None):
        from tpustack_torch.obs import catalog

        if cardinality is None:
            cardinality = knobs.get_int("TPUSTACK_TENANT_CARDINALITY")
        self.cardinality = max(1, int(cardinality))
        m = catalog.build(registry)
        self._m_prompt = m["tpustack_tenant_prompt_tokens_total"]
        self._m_gen = m["tpustack_tenant_generated_tokens_total"]
        self._m_chip = m["tpustack_tenant_chip_seconds_total"]
        self._m_kv = m["tpustack_tenant_kv_block_seconds_total"]
        self._m_queue = m["tpustack_tenant_queue_seconds_total"]
        self._m_req = m["tpustack_tenant_requests_total"]
        self._m_goodput = m["tpustack_tenant_goodput_ratio"]
        # the account table and the overflow election both ride this lock
        # (handlers + engine thread + batch/worker threads all charge)
        self._lock = threading.Lock()
        self._accounts: Dict[str, Dict[str, Dict]] = {}
        self._overflowed = 0  # distinct tenant ids collapsed into 'other'
        # distinct-overflow tracking is itself BOUNDED: the threat model
        # is a client minting a fresh tenant id per request, and an
        # unbounded seen-set would leak process memory under exactly that
        # flood.  Past the cap the set freezes and _overflowed becomes an
        # overestimate (repeats of post-cap ids recount) — the snapshot
        # labels it approximate.
        self._seen_overflow: set = set()
        self._seen_overflow_cap = 8192
        # charge listeners (the QoS layer's quota buckets): called OUTSIDE
        # the account lock with the RAW sanitized tenant (pre-overflow
        # canonicalisation — quota policy is keyed on real tenant ids, not
        # the bounded label) as (server, tenant, dimension, amount).
        # Listeners must be cheap and must never raise into a charge path.
        self._listeners: list = []

    def add_listener(self, fn) -> None:
        """Subscribe to charges (idempotent by identity).  Fired for the
        metered dimensions (``tokens``, ``chip_seconds``) after each
        charge lands in the accounts."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def _notify(self, server: str, tenant: Optional[str], dimension: str,
                amount: float) -> None:
        if not self._listeners:
            return
        t = sanitize_tenant(tenant)
        if t is None:
            t = knobs.get_str("TPUSTACK_TENANT_DEFAULT")
        for fn in self._listeners:
            try:
                fn(server, t, dimension, amount)
            except Exception:
                from tpustack_torch.utils import get_logger

                get_logger("obs.accounting").exception(
                    "ledger charge listener failed")

    # ------------------------------------------------------------- labels
    def _canon_locked(self, t: str) -> str:
        if t in self._accounts:
            return t
        if len(self._accounts) < self.cardinality:
            self._accounts[t] = {}
            return t
        if t not in self._seen_overflow:
            self._overflowed += 1
            if len(self._seen_overflow) < self._seen_overflow_cap:
                self._seen_overflow.add(t)
        return OVERFLOW_TENANT

    def _account(self, tenant: Optional[str], server: str):
        """(lock held by caller) → ``(canonical label, totals dict)``."""
        t = sanitize_tenant(tenant)
        if t is None:
            t = knobs.get_str("TPUSTACK_TENANT_DEFAULT")
        t = self._canon_locked(t)
        per_server = self._accounts.setdefault(t, {})
        acct = per_server.get(server)
        if acct is None:
            acct = per_server[server] = _fresh_account()
        return t, acct

    # ------------------------------------------------------------ charges
    def charge_tokens(self, server: str, tenant: Optional[str],
                      prompt: int = 0, generated: int = 0) -> None:
        if prompt <= 0 and generated <= 0:
            return
        with self._lock:
            label, acct = self._account(tenant, server)
            acct["prompt_tokens"] += int(prompt)
            acct["generated_tokens"] += int(generated)
        if prompt > 0:
            self._m_prompt.labels(server=server, tenant=label).inc(prompt)
        if generated > 0:
            self._m_gen.labels(server=server, tenant=label).inc(generated)
        self._notify(server, tenant, "tokens",
                     max(0, int(prompt)) + max(0, int(generated)))

    def charge_chip_seconds(self, server: str, tenant: Optional[str],
                            seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            label, acct = self._account(tenant, server)
            acct["chip_seconds"] += float(seconds)
        self._m_chip.labels(server=server, tenant=label).inc(seconds)
        self._notify(server, tenant, "chip_seconds", float(seconds))

    def charge_flight_wave(self, server: str, record: Mapping,
                           seconds_key: str = "wave_s") -> None:
        """Chip-seconds from ONE engine flight record: the record's
        ``seconds_key`` field (llm wave ``wave_s``; sd batch
        ``denoise_vae_s``) split across its occupied slots by the
        record's own ``tenants`` map ({tenant: slots}).  Charging FROM
        the record — the same dict the /debug/flight ring holds — is
        what makes the conservation property structural: per-tenant
        chip-seconds sum to the flight recorder's wave wall time
        exactly, because they are the same numbers."""
        wave_s = record.get(seconds_key)
        tenants = record.get("tenants")
        if not wave_s or not tenants:
            return
        occupancy = sum(tenants.values())
        if occupancy <= 0:
            return
        for tenant, n in tenants.items():
            self.charge_chip_seconds(server, tenant, wave_s * n / occupancy)

    def charge_kv_block_seconds(self, tenant: Optional[str],
                                block_seconds: float) -> None:
        if block_seconds <= 0:
            return
        with self._lock:
            label, acct = self._account(tenant, "llm")
            acct["kv_block_seconds"] += float(block_seconds)
        self._m_kv.labels(tenant=label).inc(block_seconds)

    def charge_queue_seconds(self, server: str, tenant: Optional[str],
                             seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            label, acct = self._account(tenant, server)
            acct["queue_seconds"] += float(seconds)
        self._m_queue.labels(server=server, tenant=label).inc(seconds)

    def note_outcome(self, server: str, tenant: Optional[str],
                     outcome: str) -> None:
        """Count one finished/refused request and refresh the tenant's
        goodput gauge (ok over the goodput outcomes; ``client_error``
        rides the counter but not the ratio)."""
        with self._lock:
            label, acct = self._account(tenant, server)
            out = acct["outcomes"]
            out[outcome] = out.get(outcome, 0) + 1
            good = out.get("ok", 0)
            total = sum(out.get(k, 0) for k in GOODPUT_OUTCOMES)
            ratio = good / total if total else 1.0
        self._m_req.labels(server=server, tenant=label,
                           outcome=outcome).inc()
        self._m_goodput.labels(server=server, tenant=label).set(ratio)

    # ------------------------------------------------------------ reading
    def tenants(self) -> list:
        with self._lock:
            return sorted(self._accounts)

    def snapshot(self) -> Dict:
        """The ``GET /debug/tenants`` payload: exact per-tenant totals,
        per server and rolled up, plus the cardinality-bound state."""
        with self._lock:
            tenants: Dict[str, Dict] = {}
            for tenant, per_server in self._accounts.items():
                total = _fresh_account()
                servers = {}
                for server, acct in per_server.items():
                    servers[server] = {k: (dict(v) if isinstance(v, dict)
                                           else v)
                                       for k, v in acct.items()}
                    for k, v in acct.items():
                        if k == "outcomes":
                            for o, n in v.items():
                                total["outcomes"][o] = (
                                    total["outcomes"].get(o, 0) + n)
                        else:
                            total[k] += v
                good = total["outcomes"].get("ok", 0)
                denom = sum(total["outcomes"].get(k, 0)
                            for k in GOODPUT_OUTCOMES)
                total["goodput_ratio"] = good / denom if denom else 1.0
                tenants[tenant] = dict(total, servers=servers)
            return {
                "cardinality": self.cardinality,
                "tracked_tenants": len(self._accounts),
                # exact while distinct overflowed ids fit the bounded
                # seen-set; an overestimate beyond it (see __init__)
                "overflowed_tenants": self._overflowed,
                "overflow_count_exact": (len(self._seen_overflow)
                                         < self._seen_overflow_cap),
                "tenants": tenants,
            }


#: process-wide ledger: servers on the default registry share it, so one
#: /debug/tenants shows the whole process
LEDGER = TenantLedger()


def for_registry(registry=None) -> TenantLedger:
    """The ledger for a server's registry: the process-wide one for the
    default registry (shared /debug/tenants), a private one when a test
    injects its own Registry (isolation, same contract as the tracer)."""
    return LEDGER if registry is None else TenantLedger(registry)
