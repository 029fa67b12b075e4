"""The metric catalog of the port: every family its servers register.

The port's copy of the part of ``tpustack/obs/catalog.py`` this package
exports.  Each spec's name, kind, labels and buckets equal the JAX
catalog's, so dashboards, the ``PodMonitoring`` scrapes and the fleet's
autoscaler read the same series from a port replica as from a JAX one
(``tests/test_torch_obs.py`` holds the two catalogs together).  Families of
the JAX catalog that no port module writes yet are not declared here.

Take families from the dict :func:`build` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from tpustack_torch.obs.metrics import REGISTRY, Registry

#: batch-size style buckets: micro-batchers cap out at small powers of two
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
#: token-count buckets for prompt/generation length histograms
TOKEN_BUCKETS = (1, 8, 32, 128, 512, 2048, 8192, 32768)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    type: str  # counter | gauge | histogram
    help: str
    labels: Tuple[str, ...] = ()
    unit: str = ""
    buckets: Optional[Tuple[float, ...]] = None  # histograms only


CATALOG: Tuple[MetricSpec, ...] = (
    MetricSpec("tpustack_http_requests_total", "counter",
               "HTTP requests served, by endpoint and status code.",
               ("server", "endpoint", "status"), unit="total"),
    MetricSpec("tpustack_http_request_latency_seconds", "histogram",
               "End-to-end HTTP request latency (ingress to last byte).",
               ("server", "endpoint"), unit="seconds"),
    MetricSpec("tpustack_http_in_flight_requests", "gauge",
               "Requests currently being handled.",
               ("server",), unit="requests"),
    MetricSpec("tpustack_request_phase_latency_seconds", "histogram",
               "Per-phase request latency: llm "
               "queue_wait/prefill/decode/detokenize; sd "
               "queue_wait/denoise_vae/png_encode; graph "
               "queued/dispatch/finalize.",
               ("server", "phase"), unit="seconds"),
    MetricSpec("tpustack_llm_queue_depth", "gauge",
               "Completions parked in the admission queue (not yet in a slot).",
               unit="depth"),
    MetricSpec("tpustack_llm_running_requests", "gauge",
               "Requests admitted to engine slots and still decoding.",
               unit="requests"),
    MetricSpec("tpustack_llm_prompt_tokens_total", "counter",
               "Prompt tokens prefilled.",
               unit="total"),
    MetricSpec("tpustack_llm_generated_tokens_total", "counter",
               "Tokens generated (decode output).",
               unit="total"),
    MetricSpec("tpustack_llm_requests_rejected_total", "counter",
               "Requests rejected at admission, by reason.",
               ("reason",), unit="total"),
    MetricSpec("tpustack_llm_batch_occupancy_slots", "histogram",
               "Requests served per continuous-engine busy period.",
               buckets=BATCH_BUCKETS, unit="slots"),
    MetricSpec("tpustack_llm_prompt_length_tokens", "histogram",
               "Prompt length distribution.",
               buckets=TOKEN_BUCKETS, unit="tokens"),
    MetricSpec("tpustack_llm_prefix_cache_lookups_total", "counter",
               "Prefix-cache lookups, by result (hit|miss).  A hit means at "
               "least one chunk of the prompt's KV was reused.",
               ("result",), unit="total"),
    MetricSpec("tpustack_llm_prefix_cached_tokens", "histogram",
               "Prompt tokens served from the prefix cache per request "
               "(prefill FLOPs skipped; 0 on a miss).",
               buckets=TOKEN_BUCKETS, unit="tokens"),
    MetricSpec("tpustack_llm_prefix_cache_evictions_total", "counter",
               "Cached chunks evicted under capacity pressure (LRU leaves).",
               unit="total"),
    MetricSpec("tpustack_llm_prefix_cache_bytes", "gauge",
               "Resident bytes of cached KV segments (host RAM, the dense "
               "store).",
               unit="bytes"),
    MetricSpec("tpustack_llm_prefix_cache_entries", "gauge",
               "Chunk nodes resident in the dense radix store.",
               unit="entries"),
    MetricSpec("tpustack_llm_kv_host_spilled_blocks_total", "counter",
               "Prefix blocks copied device->host at eviction time (the "
               "block's device memory is freed; its bytes live on in the host "
               "arena).",
               unit="total"),
    MetricSpec("tpustack_llm_kv_host_restored_blocks_total", "counter",
               "Host-tier blocks copied back into fresh pool blocks on a warm "
               "prefix match: a block of prefill the engine did not pay for.",
               unit="total"),
    MetricSpec("tpustack_llm_kv_host_expired_blocks_total", "counter",
               "Host-tier blocks dropped under the arena's byte cap (LRU) or "
               "retired with their trie subtree: their next reuse is a full "
               "recompute.",
               unit="total"),
    MetricSpec("tpustack_llm_kv_host_resident_bytes", "gauge",
               "Bytes resident in the host KV arena (<= "
               "TPUSTACK_KV_HOST_TIER_MB).",
               unit="bytes"),
    MetricSpec("tpustack_llm_prefill_chunks_total", "counter",
               "Non-final chunked-prefill dispatches (each parks its slot "
               "again instead of monopolising the wave).",
               unit="total"),
    MetricSpec("tpustack_llm_kv_free_blocks", "gauge",
               "Free blocks in the paged KV pool — what capacity-true "
               "admission checks against (plus evictable cached blocks).",
               unit="blocks"),
    MetricSpec("tpustack_llm_kv_used_blocks", "gauge",
               "Pool blocks held by live slots and/or the refcounted prefix "
               "cache.",
               unit="blocks"),
    MetricSpec("tpustack_llm_kv_block_fragmentation_ratio", "gauge",
               "Reserved-but-unfillable token slack in used blocks (block-size"
               " rounding): 0 = tight fit, rises with larger TPUSTACK_KV_BLOCK"
               " against short requests.",
               unit="ratio"),
    MetricSpec("tpustack_llm_spec_drafted_tokens_total", "counter",
               "Draft tokens proposed to verify steps (prompt-lookup n-gram or"
               " draft-model).  Zero with TPUSTACK_SPEC_TOKENS=0 or when the "
               "acceptance throttle has every slot on plain decode.",
               unit="total"),
    MetricSpec("tpustack_llm_spec_accepted_tokens_total", "counter",
               "Draft tokens the verify step accepted (agreed with what the "
               "model would have produced).  Each accepted token is one decode"
               " weight-pass the engine did NOT pay for.",
               unit="total"),
    MetricSpec("tpustack_llm_spec_acceptance_ratio", "gauge",
               "Running accepted/drafted ratio since process start — the "
               "traffic-predictability signal the per-slot EMA throttle acts "
               "on (low ratio = drafting is wasted verify positions).",
               unit="ratio"),
    MetricSpec("tpustack_sd_queue_depth", "gauge",
               "Generate requests waiting in micro-batch groups.",
               unit="depth"),
    MetricSpec("tpustack_sd_batch_size_images", "histogram",
               "Real (un-padded) images per fused dispatch.",
               buckets=BATCH_BUCKETS, unit="images"),
    MetricSpec("tpustack_sd_images_total", "counter",
               "Images generated (pad rows excluded).",
               unit="total"),
    MetricSpec("tpustack_graph_queue_depth", "gauge",
               "Prompts queued for the worker (submitted, not dispatched).",
               unit="depth"),
    MetricSpec("tpustack_graph_prompts_total", "counter",
               "Prompt graphs finished, by outcome (success|error|rejected).",
               ("status",), unit="total"),
    MetricSpec("tpustack_graph_batch_fallback_total", "counter",
               "Batched dispatches that failed (typically device memory) and "
               "degraded to per-row serial dispatch.",
               unit="total"),
    MetricSpec("tpustack_serving_drain_state", "gauge",
               "Lifecycle: 0 serving, 1 draining (SIGTERM received, finishing "
               "in-flight work), 2 drained (about to exit).",
               ("server",), unit="state"),
    MetricSpec("tpustack_requests_shed_total", "counter",
               "Work refused at admission, by reason (backpressure 429 | "
               "draining 503 | out_of_kv_blocks 429, llm paged mode).  All "
               "responses carry Retry-After.",
               ("server", "reason"), unit="total"),
    MetricSpec("tpustack_deadline_exceeded_total", "counter",
               "Requests cancelled at their deadline (504), by the phase they "
               "died in (queued|decode|denoise).",
               ("server", "phase"), unit="total"),
    MetricSpec("tpustack_watchdog_stalls_total", "counter",
               "Watchdog detections of in-flight work with no wave progress — "
               "each flips liveness so kubernetes restarts the pod.",
               ("server",), unit="total"),
    MetricSpec("tpustack_retry_after_seconds", "gauge",
               "Last Retry-After hint handed to a shed client: p50 service "
               "time scaled by queue depth over capacity.",
               ("server",), unit="seconds"),
    MetricSpec("tpustack_faults_injected_total", "counter",
               "Deterministic TPUSTACK_FAULT_* injections fired, by kind "
               "(slow_prefill|device_error|dispatch_hang|sigterm).  Nonzero "
               "outside a chaos drill is a config bug.",
               ("server", "kind"), unit="total"),
    MetricSpec("tpustack_traces_captured_total", "counter",
               "Traces finalized into the in-process store, by kind (ok | slow"
               " = past TPUSTACK_TRACE_SLOW_S, always kept | error = a span "
               "errored, always kept | incomplete = spans never ended, evicted"
               " from the live table).",
               ("kind",), unit="total"),
    MetricSpec("tpustack_device_hbm_used_bytes", "gauge",
               "Device memory in use, per CUDA device (the caching allocator's"
               " allocated bytes, torch.cuda.memory_stats).",
               ("device",), unit="bytes"),
    MetricSpec("tpustack_device_hbm_limit_bytes", "gauge",
               "Device memory capacity, per CUDA device "
               "(torch.cuda.mem_get_info total).",
               ("device",), unit="bytes"),
    MetricSpec("tpustack_process_start_time_seconds", "gauge",
               "Unix time the server process installed its device gauges.",
               unit="seconds"),

    # ---- tenant cost accounting (obs.accounting; the tenant label is
    # BOUNDED: the first TPUSTACK_TENANT_CARDINALITY distinct tenants plus
    # an 'other' overflow bucket; written only through the TenantLedger) ----
    MetricSpec("tpustack_tenant_prompt_tokens_total", "counter",
               "Prompt tokens prefilled, charged to the requesting tenant "
               "(X-Tenant-Id header / body tenant field).",
               ("server", "tenant"), unit="total"),
    MetricSpec("tpustack_tenant_generated_tokens_total", "counter",
               "Tokens generated for the tenant's completed requests.",
               ("server", "tenant"), unit="total"),
    MetricSpec("tpustack_tenant_chip_seconds_total", "counter",
               "Device wall seconds attributed to the tenant: each engine "
               "wave's wall time (the flight recorder's wave_s) split across "
               "the slots it served; sd charges each fused batch's "
               "denoise+VAE seconds split across its riders; graph charges "
               "the finalize fetch per prompt.",
               ("server", "tenant"), unit="total"),
    MetricSpec("tpustack_tenant_kv_block_seconds_total", "counter",
               "Paged-KV residency bill: pool blocks held x seconds held "
               "(allocation at admission to release at retire), per tenant.",
               ("tenant",), unit="total"),
    MetricSpec("tpustack_tenant_queue_seconds_total", "counter",
               "Admission-queue wall seconds the tenant's requests spent "
               "waiting (llm slot queue, sd batch window, graph worker "
               "queue).", ("server", "tenant"), unit="total"),
    MetricSpec("tpustack_tenant_requests_total", "counter",
               "Requests finished per tenant, by outcome (ok | shed | "
               "deadline | error | client_error, excluded from goodput).",
               ("server", "tenant", "outcome"), unit="total"),
    MetricSpec("tpustack_tenant_goodput_ratio", "gauge",
               "Lifetime goodput per tenant: ok / (ok + shed + deadline + "
               "error).", ("server", "tenant"), unit="ratio"),

    # ---- multi-tenant QoS (serving.qos; priority is interactive|batch.
    # The bucket gauge's tenant label is bounded by the operator-declared
    # policy, never client-minted) ----
    MetricSpec("tpustack_qos_shed_total", "counter",
               "Requests shed by the priority-aware backpressure wall: "
               "batch sheds at batch_shed_ratio of TPUSTACK_MAX_QUEUE_"
               "DEPTH, interactive at the full depth.",
               ("server", "priority"), unit="total"),
    MetricSpec("tpustack_qos_preempt_total", "counter",
               "Engine slots preempted at a wave boundary so a waiting "
               "interactive request could run; the batch slot parks with "
               "its paged block refs retained and resumes through the "
               "prefix warm start.", ("priority",), unit="total"),
    MetricSpec("tpustack_qos_quota_throttle_total", "counter",
               "Requests 429'd because the tenant's token bucket (tokens/s "
               "or chip-seconds/s, TPUSTACK_QOS_POLICY) was in debt; "
               "Retry-After is that bucket's own refill ETA.",
               ("server", "priority"), unit="total"),
    MetricSpec("tpustack_qos_requests_total", "counter",
               "Work requests finished per priority class, by outcome (the "
               "tenant outcome taxonomy).", ("server", "priority", "outcome"),
               unit="total"),
    MetricSpec("tpustack_qos_queue_wait_seconds", "histogram",
               "Admission-queue wall time by priority class: llm engine "
               "queue, sd micro-batch window, graph worker queue.",
               ("server", "priority"), unit="seconds"),
    MetricSpec("tpustack_qos_bucket_level_ratio", "gauge",
               "Live token-bucket balance over burst per policy tenant and "
               "dimension (tokens|chip_seconds): <= 0 = in debt.",
               ("tenant", "dimension"), unit="ratio"),
)


def build(registry: Optional[Registry] = None) -> Dict[str, object]:
    """Instantiate (get-or-create) every catalog metric in ``registry``
    (default: the process-wide one); returns name -> family."""
    registry = registry or REGISTRY
    out: Dict[str, object] = {}
    for spec in CATALOG:
        if spec.type == "counter":
            out[spec.name] = registry.counter(spec.name, spec.help, spec.labels)
        elif spec.type == "gauge":
            out[spec.name] = registry.gauge(spec.name, spec.help, spec.labels)
        elif spec.type == "histogram":
            out[spec.name] = registry.histogram(spec.name, spec.help, spec.labels,
                                                buckets=spec.buckets)
        else:
            raise ValueError(f"{spec.name}: unknown metric type {spec.type}")
    return out
