"""Engine flight recorder: what the engine was doing, per dispatch.

The port's copy of the recorder half of ``tpustack/obs/flight.py``.
:class:`FlightRecorder` is a lock-cheap ring buffer
(``TPUSTACK_FLIGHT_RECORDS``, default 512) that each serving engine feeds
one structured host-side record per dispatch: the LLM continuous engine per
wave (occupancy, tokens, drafted/accepted, KV pool free/used, queue depth,
wave wall time, the trace id of the slowest in-flight request), SD per
micro-batch, graph per dispatch and publish.  The ring is served as
``GET /debug/flight`` (recent records + windowed aggregates) on all three
servers, and dumped to a JSON file (``TPUSTACK_FLIGHT_DUMP_DIR``) when the
watchdog fires and when a SIGTERM drain ends, so "what were the last 512
things the engine did" survives the pod.

Recording a wave costs one dict build and one deque append under an
uncontended lock, and never synchronises the device.  Dumps are
best-effort: a full disk or an unwritable directory logs and returns None.

Not ported: the live roofline gauges (``llm_wave_arith``,
``tpustack_llm_mfu_ratio`` and the like), which read the JAX device kind.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional

from tpustack_torch.utils import knobs

__all__ = ["FlightRecorder", "register", "recorders", "dump_all"]

#: every live recorder in the process, weakly held — ``dump_all`` (the
#: watchdog / drain post-mortem hook) walks these; a recorder dies with its
#: server, so a test's dead servers never dump
_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_REG_LOCK = threading.Lock()
#: process-global dump counter: several recorders may share a server name
#: (tests, multi-engine processes) and dump in the same event — filenames
#: must never collide and overwrite one another's post-mortem
_DUMP_SEQ = [0]


class FlightRecorder:
    """Ring buffer of per-dispatch engine records for ONE server.

    ``meta`` is static context stamped into every snapshot/dump (model
    name, slot count, chunk — whatever makes the artifact readable on
    its own).  Records are plain JSON-able dicts; ``record`` stamps a
    monotonically increasing ``seq`` and a wall-clock ``ts``.
    """

    def __init__(self, server: str, capacity: Optional[int] = None,
                 meta: Optional[Dict] = None):
        if capacity is None:
            capacity = knobs.get_int("TPUSTACK_FLIGHT_RECORDS")
        self.server = server
        self.capacity = max(1, int(capacity))
        self.meta: Dict = dict(meta or {})
        # ring/seq mutations all hold _lock (engine threads feed while
        # handlers snapshot)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._dumps = 0

    # ------------------------------------------------------------- feeding
    def record(self, kind: str, **fields) -> Dict:
        """Append one record.  Cheap and lock-bounded — safe from engine
        threads at wave cadence."""
        rec = {"kind": kind, "ts": time.time()}
        rec.update(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
        return rec

    # ------------------------------------------------------------- reading
    def recent(self, n: Optional[int] = None) -> List[Dict]:
        """Newest-last copy of the ring (the last ``n`` when given)."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-max(0, int(n)):]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def aggregates(self, window_s: Optional[float] = None) -> Dict:
        """Windowed aggregates over the ring (``window_s`` None = all
        retained records).  Per-kind counts always; engine-shape rollups
        (wave rates, occupancy, spec efficiency, SD batch rates) when the
        matching records exist.  Rates use the first→last record span, so
        they read as "over the recent window", idle gaps included."""
        records = self.recent()
        if window_s:
            cutoff = time.time() - float(window_s)
            records = [r for r in records if r["ts"] >= cutoff]
        out: Dict = {"records": len(records), "window_s": window_s,
                     "kinds": {}}
        for r in records:
            out["kinds"][r["kind"]] = out["kinds"].get(r["kind"], 0) + 1
        waves = [r for r in records if r["kind"] in ("wave", "verify")]
        if waves:
            span = waves[-1]["ts"] - waves[0]["ts"]
            tokens = sum(r.get("tokens", 0) for r in waves)
            passes = sum(r.get("weight_passes", 0) for r in waves)
            drafted = sum(r.get("drafted", 0) for r in waves)
            accepted = sum(r.get("accepted", 0) for r in waves)
            occ = [r["occupancy"] for r in waves if "occupancy" in r]
            wave_s = [r["wave_s"] for r in waves
                      if r.get("wave_s") is not None]
            out.update({
                "waves": len(waves),
                "tokens": tokens,
                "mean_occupancy": (sum(occ) / len(occ)) if occ else None,
                "tokens_per_s": tokens / span if span > 0 else None,
                "weight_passes_per_s": passes / span if span > 0 else None,
                "tokens_per_weight_pass": (tokens / passes if passes
                                           else None),
                "mean_wave_s": (sum(wave_s) / len(wave_s)) if wave_s
                else None,
                "spec_drafted": drafted,
                "spec_accepted": accepted,
                "spec_acceptance": accepted / drafted if drafted else None,
            })
            # per-tenant slot-occupancy rollup: summing each wave's
            # tenants map weighted by its wall time gives the same
            # chip-second split the tenant ledger charges (the records
            # ARE the ledger's source) — /debug/flight can answer "who
            # was on the chip this window" without the ledger
            tenant_s: Dict[str, float] = {}
            for r in waves:
                if r.get("tenants") and r.get("wave_s"):
                    occ = sum(r["tenants"].values())
                    for tenant, n in r["tenants"].items():
                        tenant_s[tenant] = (tenant_s.get(tenant, 0.0)
                                            + r["wave_s"] * n / occ)
            if tenant_s:
                out["tenant_chip_seconds"] = {
                    t: round(v, 6) for t, v in sorted(tenant_s.items())}
            lastw = waves[-1]
            for k in ("queue_depth", "kv_free", "kv_used",
                      "kv_fragmentation"):
                if k in lastw:
                    out[f"{k}_last"] = lastw[k]
            slow = [r for r in waves if r.get("slowest_trace_id")]
            if slow:
                out["slowest_trace_id"] = slow[-1]["slowest_trace_id"]
                out["slowest_age_s"] = slow[-1].get("slowest_age_s")
        prefills = [r for r in records if r["kind"] == "prefill"]
        if prefills:
            ts = [r["prefill_s"] for r in prefills if "prefill_s" in r]
            out["prefills"] = len(prefills)
            out["mean_prefill_s"] = (sum(ts) / len(ts)) if ts else None
        batches = [r for r in records if r["kind"] == "batch"]
        if batches:
            span = batches[-1]["ts"] - batches[0]["ts"]
            images = sum(r.get("batch", 0) for r in batches)
            denoise = sum(r.get("denoise_vae_s", 0.0) for r in batches)
            # the FLOP-rate numerator and denominator must cover the SAME
            # batches: an uncostable signature (cost analysis failed →
            # flops None) contributes neither, or its busy seconds would
            # deflate the MFU below the true utilization
            costed = [r for r in batches if r.get("flops") is not None]
            flops = sum(r["flops"] for r in costed)
            costed_busy = sum(r.get("denoise_vae_s", 0.0) for r in costed)
            out.update({
                "batches": len(batches),
                "images": images,
                "images_per_s": images / span if span > 0 else None,
                "mean_batch": images / len(batches),
                "device_busy_s": denoise,
                "flops": flops if costed else None,
                "device_flops_per_s": (flops / costed_busy
                                       if costed and costed_busy > 0
                                       else None),
            })
        nodes = [r for r in records if r["kind"] == "node"]
        if nodes:
            per: Dict[str, Dict] = {}
            for r in nodes:
                c = per.setdefault(str(r.get("class_type")),
                                   {"count": 0, "seconds": 0.0})
                c["count"] += 1
                c["seconds"] += r.get("seconds", 0.0)
            out["nodes"] = per
        return out

    def snapshot(self, window_s: Optional[float] = None,
                 n: Optional[int] = None) -> Dict:
        """The ``GET /debug/flight`` payload: recent ring + aggregates."""
        return {
            "server": self.server,
            "capacity": self.capacity,
            "meta": dict(self.meta),
            "aggregates": self.aggregates(window_s),
            "records": self.recent(n),
        }

    # ------------------------------------------------------------- dumping
    def dump(self, reason: str, dump_dir: Optional[str] = None,
             ) -> Optional[str]:
        """Write the full snapshot to a JSON artifact; returns the path or
        None.  Best-effort by contract: a post-mortem writer must never be
        the thing that takes the server down, so every failure logs at
        warning and returns None."""
        try:
            d = dump_dir or knobs.get_str("TPUSTACK_FLIGHT_DUMP_DIR")
            if not d:
                return None
            os.makedirs(d, exist_ok=True)
            with _REG_LOCK:
                _DUMP_SEQ[0] += 1
                n = _DUMP_SEQ[0]
            with self._lock:
                self._dumps += 1
            safe = "".join(c if (c.isalnum() or c in "-_") else "_"
                           for c in reason)
            path = os.path.join(
                d, f"flight-{self.server}-{safe}-{os.getpid()}-{n}.json")
            payload = self.snapshot()
            payload["reason"] = reason
            payload["dumped_at"] = time.time()
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)  # pollers never see a half-written dump
            _log().warning("flight recorder dumped %d records to %s "
                           "(reason=%s)", len(payload["records"]), path,
                           reason)
            return path
        except Exception:
            _log().warning("flight dump failed (reason=%s)", reason,
                           exc_info=True)
            return None


def _log():
    from tpustack_torch.utils import get_logger

    return get_logger("obs.flight")


# ------------------------------------------------------- process registry
def register(recorder: FlightRecorder) -> FlightRecorder:
    """Track ``recorder`` for process-wide post-mortem dumps
    (:func:`dump_all`) and the sidecar's ``/debug/flight``."""
    with _REG_LOCK:
        _RECORDERS.add(recorder)
    return recorder


def recorders() -> List[FlightRecorder]:
    with _REG_LOCK:
        return list(_RECORDERS)


def dump_all(reason: str) -> List[str]:
    """Dump every registered non-empty recorder (the watchdog / drain
    hook).  Empty recorders are skipped — a pod that never
    served a wave has nothing post-mortem-worthy to say."""
    paths = []
    for rec in recorders():
        if len(rec) == 0:
            continue
        p = rec.dump(reason)
        if p:
            paths.append(p)
    return paths
