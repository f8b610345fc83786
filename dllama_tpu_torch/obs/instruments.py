"""The serving-stack metrics catalog — every dllama_* series in one place.

One definition site so the README table, the scrape output, and the
instrumented code can't drift apart. Import the module and touch the
instruments directly::

    from dllama_tpu_torch.obs import instruments as ins
    ins.TOKENS_GENERATED.inc(4)
    ins.REQUESTS_SHED.labels(reason="queue_full").inc()

Everything lives in the global :data:`dllama_tpu_torch.obs.metrics.REGISTRY`
(what `GET /metrics` renders). Conventions: durations in SECONDS with a
``_seconds`` suffix (Prometheus idiom — the host code's ms values are
converted at the observation site), monotonic counts end in ``_total``.
"""

from __future__ import annotations

import threading
import time

from dllama_tpu_torch.obs import metrics

# ------------------------------------------------------------ request flow

REQUESTS_ADMITTED = metrics.counter(
    "dllama_requests_admitted_total",
    "Requests accepted into the scheduler admission queue")
REQUESTS_SHED = metrics.counter(
    "dllama_requests_shed_total",
    "Requests rejected at admission, by reason "
    "(queue_full=429, draining/unhealthy=503)",
    ("reason",))
REQUESTS_FINISHED = metrics.counter(
    "dllama_requests_finished_total",
    "Requests that reached a terminal state, by finish_reason "
    "(stop/length = success; cancelled, error, shutdown = not)",
    ("reason",))
HTTP_RESPONSES = metrics.counter(
    "dllama_http_responses_total",
    "HTTP responses sent, by normalized endpoint and status code "
    "(covers both serving tiers; streams count at header time)",
    ("endpoint", "code"))

# ------------------------------------------------------------------ tokens

TOKENS_GENERATED = metrics.counter(
    "dllama_tokens_generated_total",
    "Completion tokens emitted to clients (both serving tiers)")
PREFILL_TOKENS = metrics.counter(
    "dllama_prefill_tokens_total",
    "Prompt tokens whose KV rows were computed (cache reuse excluded)")
REUSED_PREFIX_TOKENS = metrics.counter(
    "dllama_reused_prefix_tokens_total",
    "Prompt tokens served from a cached KV prefix instead of prefill")

# ------------------------------------------------ speculative decoding

SPEC_CYCLES = metrics.counter(
    "dllama_spec_cycles_total",
    "Batched speculative verify cycles consumed by the serving tier (one "
    "K+1-wide forward each; emitted/cycles is the realized speedup)")
SPEC_TOKENS = metrics.counter(
    "dllama_spec_tokens_total",
    "Speculative-decoding token flow, by kind: drafted = n-gram draft "
    "tokens verified, accepted = drafts the model agreed with, emitted = "
    "all tokens spec cycles produced (incl. the bonus token and non-spec "
    "rows' single tokens)",
    ("kind",))
SPEC_ACCEPTED_LENGTH = metrics.histogram(
    "dllama_spec_accepted_length",
    "Accepted draft-prefix length per greedy speculative row per verify "
    "cycle (0 = only the bonus token emitted; mean = _sum/_count is the "
    "acceptance rate the spec speedup multiplies from)",
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))

# --------------------------------------------- hybrid prefill & preemption

PREFILL_BUDGET = metrics.gauge(
    "dllama_prefill_budget_tokens",
    "Hybrid chunked prefill: prompt tokens the next fused decode chunk may "
    "co-process for an admitting request (--prefill-budget; 'auto' is "
    "steered online by the windowed ITL headroom against --slo-itl-ms; "
    "0 = legacy phase-split admission)")
PREEMPTIONS = metrics.counter(
    "dllama_preemptions_total",
    "Running requests suspended at a chunk boundary to make room for "
    "higher-priority work, by reason (slot = a higher-priority request "
    "needed the slot, capacity = it needed KV pages). The victim's pages "
    "stay referenced (radix tree / kept rows); it resumes later with its "
    "recorded PRNG key — byte-identical continuation, near-zero recompute",
    ("reason",))
RESUMED = metrics.counter(
    "dllama_resumed_total",
    "Preempted requests that re-entered a slot and continued their stream "
    "(companion of dllama_preemptions_total; a persistent gap between the "
    "two means preempted work is parked behind sustained higher-priority "
    "load)")

# -------------------------------------------------- radix prefix cache

RADIX_LOOKUPS = metrics.counter(
    "dllama_radix_lookups_total",
    "Radix prefix-tree walks at admission, by outcome (hit = at least one "
    "reusable row; retried admissions of a capacity-deferred request count "
    "each walk)",
    ("outcome",))
RADIX_HIT_TOKENS = metrics.counter(
    "dllama_radix_hit_tokens_total",
    "Prompt rows mapped from the radix prefix tree instead of prefilled "
    "(saved-prefill tokens; counted at commit, so aborted admissions "
    "never inflate it)")
RADIX_NODES = metrics.gauge(
    "dllama_radix_nodes",
    "Radix prefix tree: live nodes (page-granular edges; 0 when the cache "
    "is off or the layout is dense)")
RADIX_PAGES = metrics.gauge(
    "dllama_radix_pages",
    "Radix prefix tree: KV pool pages the tree holds references to "
    "(reclaimable by LRU eviction before admissions defer)")

# ---------------------------------------------- router & aio front-end

ROUTER_REQUESTS = metrics.counter(
    "dllama_router_requests_total",
    "Router-proxied completion requests, by replica and outcome (ok = "
    "forwarded and answered, 4xx included — the replica spoke, the client "
    "erred; error = replica answered a 5xx, passed through; busy = "
    "replica shed 429/503, tried elsewhere; rerouted = replica failed "
    "before any response byte, request moved to a survivor; stream_error "
    "= replica died mid-stream, stream failed cleanly with "
    "finish_reason=error; client_gone = client hung up mid-stream; shed = "
    "no replica could take it, replica=none)",
    ("replica", "outcome"))
ROUTER_AFFINITY_HITS = metrics.counter(
    "dllama_router_affinity_hits_total",
    "Requests routed to the replica their prefix fingerprint was pinned "
    "to (the radix-cache-warm replica) — hits/requests is the warm-routing "
    "rate the router's TTFT win comes from")
REPLICA_HEALTHY = metrics.gauge(
    "dllama_replica_healthy",
    "Router's live view of each replica (1 = /health reports live; 0 = "
    "dead or unreachable — flips immediately on a failed proxy attempt, "
    "not a poll later)",
    ("replica",))
FRONTEND_CONNECTIONS = metrics.gauge(
    "dllama_frontend_connections",
    "Open client connections per aio event loop, labeled by the server's "
    "bound address (one process may host several loops: replica + router "
    "fronts). Threads do NOT scale with this — compare "
    "dllama_process_threads; the threads front-end does not move this "
    "gauge",
    ("server",))
REPLICA_CLOCK_OFFSET = metrics.gauge(
    "dllama_replica_clock_offset_seconds",
    "Router's NTP-lite estimate of each replica's monotonic-clock offset "
    "(replica clock minus router clock, min-RTT sample over the health-poll "
    "window) — what GET /router/trace shifts that replica's spans by to "
    "land them on the merged mesh timeline",
    ("replica",))
REPLICA_CLOCK_UNCERTAINTY = metrics.gauge(
    "dllama_replica_clock_uncertainty_seconds",
    "Error bound of the offset estimate (half the min round-trip of the "
    "window: the remote clock read can sit anywhere inside the round-trip) "
    "— merged-trace alignment is only trusted to this resolution",
    ("replica",))
FEDERATION_SCRAPE_SECONDS = metrics.histogram(
    "dllama_router_federation_scrape_seconds",
    "Wall time of one GET /router/metrics federation pass: concurrent "
    "scrape of every live replica + relabel/merge into one exposition "
    "(the router's own registry renders inside this window too)",
    buckets=metrics.LATENCY_BUCKETS_S)
FLEET_SCRAPE_AGE = metrics.gauge(
    "dllama_fleet_scrape_age_seconds",
    "Age of each replica's last SUCCESSFUL /metrics scrape at federation "
    "time — a dead replica's cached series keep federating (last-known "
    "values) while this gauge grows, so the fleet view reads STALE, never "
    "as zero traffic; alert on it instead of on vanishing series",
    ("replica",))
ROUTER_TTFT_SECONDS = metrics.histogram(
    "dllama_router_ttft_seconds",
    "CLIENT-perspective time to first token measured at the router "
    "(request arrival to the first content frame relayed; non-streamed "
    "requests observe their full proxy latency) — includes connect, "
    "routing, queueing, and any failover the replica-side "
    "dllama_ttft_seconds cannot see",
    buckets=metrics.LATENCY_BUCKETS_S)
ROUTER_ITL_SECONDS = metrics.histogram(
    "dllama_router_itl_seconds",
    "CLIENT-perspective mean inter-token latency per proxied stream "
    "(first to last content frame over frames-1, measured at the router) "
    "— a failover's backoff + resume gap lands here, invisible to any "
    "single replica's dllama_itl_seconds",
    buckets=metrics.CHUNK_BUCKETS_S)
ROUTER_SLO_ATTAINMENT = metrics.gauge(
    "dllama_router_slo_attainment",
    "Windowed fraction of proxied requests finishing inside every "
    "configured SLO (--slo-ttft-ms / --slo-itl-ms) as the CLIENT saw "
    "them, per serving replica plus the replica=\"fleet\" rollup; a gap "
    "vs the replicas' own dllama_slo_attainment is network/failover-"
    "induced violation the replicas cannot measure (refreshed at scrape)",
    ("replica",))
ROUTER_FAILOVERS = metrics.counter(
    "dllama_router_failovers_total",
    "Mid-stream cross-replica failovers, by outcome (resumed = the stream "
    "was resubmitted to a survivor and finished from its journal position; "
    "retried = one resume attempt was dispatched, whatever came of it; "
    "exhausted = the per-stream --failover-max budget ran out and the "
    "stream failed with today's exactly-once error; unresumable = no "
    "journal entry / terminal frame already relayed / journal ring full — "
    "same exactly-once error contract)",
    ("outcome",))

# ----------------------------------------------------------------- gauges

BUILD_INFO = metrics.gauge(
    "dllama_tpu_build_info",
    "Always 1; the labels carry what is running — package version, jax "
    "version, jax backend platform, whether the overlapped decode "
    "pipeline is active (on/off, or n/a on the single-engine tier), and "
    "the boot warmup mode (auto = the compiled-shape universe was "
    "precompiled before traffic; off; n/a on the single-engine tier)",
    ("version", "jax", "backend", "overlap", "warmup"))
QUEUE_DEPTH = metrics.gauge(
    "dllama_queue_depth", "Requests waiting in the admission queue")
BUSY_SLOTS = metrics.gauge(
    "dllama_busy_slots", "Cache slots actively decoding")
SLOTS_TOTAL = metrics.gauge(
    "dllama_slots_total", "Configured continuous-batching cache slots")
MODEL_PARAMS_BYTES = metrics.gauge(
    "dllama_model_params_bytes", "Model parameter bytes resident in HBM")
KV_CACHE_BYTES = metrics.gauge(
    "dllama_kv_cache_bytes", "KV-cache bytes resident in HBM")
KV_PAGES_TOTAL = metrics.gauge(
    "dllama_kv_pages_total",
    "Paged KV cache: usable pages in the global pool (0 = dense layout)")
KV_PAGES_USED = metrics.gauge(
    "dllama_kv_pages_used",
    "Paged KV cache: pages currently referenced by at least one slot")
KV_PAGES_SHARED = metrics.gauge(
    "dllama_kv_pages_shared",
    "Paged KV cache: pages with more than one referent — several slots, "
    "or a slot plus the radix prefix tree (copy-on-write prefix sharing)")
KV_HOST_PAGES_TOTAL = metrics.gauge(
    "dllama_kv_host_pages_total",
    "Host-RAM KV spill tier (--kv-host-pages): page slots in the pinned "
    "host buffer pool (0 = tier off; radix eviction discards cold pages)")
KV_HOST_PAGES_USED = metrics.gauge(
    "dllama_kv_host_pages_used",
    "Host-RAM KV spill tier: spilled pages currently resident on the "
    "host — restore-on-hit pops them back to the device at admission, "
    "LRU pressure drops the coldest")
KV_SPILL = metrics.counter(
    "dllama_kv_spill_total",
    "Host-tier page movements by direction (out = device page spilled "
    "d2h at a radix eviction instead of being discarded; in = host page "
    "restored h2d into the radix tree at an admission lookup)",
    ("direction",))

# ------------------------------------------------------------- histograms

TTFT_SECONDS = metrics.histogram(
    "dllama_ttft_seconds",
    "Time to first token, queueing + prefill included (per request)",
    buckets=metrics.LATENCY_BUCKETS_S)
ITL_SECONDS = metrics.histogram(
    "dllama_itl_seconds",
    "Mean inter-token latency after the first token (per request)",
    buckets=metrics.CHUNK_BUCKETS_S)
E2E_SECONDS = metrics.histogram(
    "dllama_e2e_latency_seconds",
    "Submit-to-finish request latency (per request)",
    buckets=metrics.LATENCY_BUCKETS_S)
PREFILL_CHUNK_SECONDS = metrics.histogram(
    "dllama_prefill_chunk_seconds",
    "Host wall time of one prefill chunk (dispatch only unless the caller "
    "syncs; the scheduler syncs whenever decoders would stall)",
    buckets=metrics.CHUNK_BUCKETS_S)
DECODE_CHUNK_SECONDS = metrics.histogram(
    "dllama_decode_chunk_seconds",
    "Wall time of ONE fused decode chunk, observed when its tokens "
    "materialize on host (device-real under the overlapped pipeline too: "
    "the clock starts at the later of the chunk's dispatch and the "
    "previous chunk's consumption, so a chunk dispatched while its "
    "predecessor still runs is not billed the predecessor's tail)",
    buckets=metrics.CHUNK_BUCKETS_S)
DECODE_HOST_GAP_SECONDS = metrics.histogram(
    "dllama_decode_host_gap_seconds",
    "Inter-chunk host gap: wall time from one decode chunk's tokens "
    "materializing to the next chunk's dispatch — the device-idle window "
    "host scheduling inserts; ~0 with --overlap on (the successor "
    "dispatches before the previous chunk is consumed)",
    buckets=metrics.CHUNK_BUCKETS_S)
BATCH_OCCUPANCY = metrics.histogram(
    "dllama_batch_occupancy",
    "Active slots per fused decode chunk (mean = _sum/_count)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
ADMISSION_STALL_SECONDS = metrics.histogram(
    "dllama_admission_stall_seconds",
    "Decode-to-decode gap inserted by admission work between fused chunks "
    "(what batch-mates' ITL degrades by during a join)",
    buckets=metrics.CHUNK_BUCKETS_S)
TOKEN_LATENCY_SECONDS = metrics.histogram(
    "dllama_token_latency_seconds",
    "Per-token host latency recorded by utils.profiling.TokenTimer "
    "(single-engine inference loop)",
    buckets=metrics.CHUNK_BUCKETS_S)

# ------------------------------------------------- SLO & saturation (perf)

SCHEDULER_TIME = metrics.counter(
    "dllama_scheduler_time_seconds_total",
    "Scheduler worker wall time attributed to exactly one exclusive state "
    "(obs/perf.TimeLedger): the per-state totals partition loop wall time "
    "by construction, so fractions answer 'what is the scheduler doing'",
    ("state",))
SLO_VIOLATIONS = metrics.counter(
    "dllama_slo_violations_total",
    "Terminal requests that missed a configured SLO target, by kind "
    "(ttft vs --slo-ttft-ms, itl vs --slo-itl-ms); burn-rate source",
    ("kind",))
SLO_ATTAINMENT = metrics.gauge(
    "dllama_slo_attainment",
    "Fraction of requests finishing inside every configured SLO over the "
    "sliding window (1.0 with no violations; refreshed at scrape time)")
LATENCY_WINDOW = metrics.gauge(
    "dllama_latency_window_seconds",
    "Sliding-window latency quantiles (obs/perf.WindowQuantiles) for "
    "metric=ttft|itl|e2e at quantile=p50|p95|p99 — the live-tail view the "
    "per-request histograms cannot give without a quantile-capable backend",
    ("metric", "quantile"))
BW_ATTAINMENT = metrics.gauge(
    "dllama_decode_bandwidth_attainment",
    "Windowed decode HBM-bandwidth attainment: priced chunk bytes "
    "(experiments/hbm_traffic.py's cost model, one definition site in "
    "obs/perf.decode_step_bytes) / measured device seconds / peak HBM GB/s")
THROUGHPUT = metrics.gauge(
    "dllama_throughput_tok_s",
    "Windowed completion-token rate over finished requests (scrape-time "
    "refresh; companion of the goodput gauge)")
GOODPUT = metrics.gauge(
    "dllama_goodput_tok_s",
    "Windowed GOODPUT token rate: only tokens of requests that finished "
    "stop/length within every configured SLO count (goodput/throughput is "
    "the useful-work fraction)")

# --------------------------------------------- compile & device traffic

JIT_COMPILES = metrics.counter(
    "dllama_jit_compiles_total",
    "Observed XLA jit traces/compiles, by dispatch-site function label "
    "(obs/compile.COMPILE_FNS; 'untracked' = compiles outside any "
    "instrumented site). Steady-state serving must not move this at all — "
    "a nonzero rate mid-traffic is a recompile storm stealing device time",
    ("fn",))
JIT_COMPILE_SECONDS = metrics.counter(
    "dllama_jit_compile_seconds_total",
    "Wall seconds spent tracing/lowering/compiling, by function label "
    "(the jax.monitoring /jax/core/compile/* durations, attributed by the "
    "compile ledger's dispatch-site scopes)",
    ("fn",))
JIT_UNEXPECTED_COMPILES = metrics.counter(
    "dllama_jit_unexpected_compiles_total",
    "Compiles whose shape-bucket key fell OUTSIDE the declared contract "
    "(obs/compile.ShapeContract): each one also logs a structured warning "
    "naming the offending shape. Any nonzero value means the bounded "
    "compiled-shape universe the perf work assumes has been violated",
    ("fn",))
TRANSFERS = metrics.counter(
    "dllama_transfers_total",
    "Host<->device transfers at the engine boundary, by direction "
    "(h2d/d2h) and site (obs/compile.TRANSFER_SITES): uploads happen at "
    "admission/commit/release boundaries only — a per-chunk h2d rate in "
    "steady-state decode is the device-resident state's invariant breaking",
    ("direction", "site"))
TRANSFER_BYTES = metrics.counter(
    "dllama_transfer_bytes_total",
    "Bytes moved by the transfers dllama_transfers_total counts, same "
    "direction/site labels",
    ("direction", "site"))
DEVICE_LIVE_BUFFERS = metrics.gauge(
    "dllama_device_live_buffers",
    "Live jax arrays on the backend (jax.live_arrays), refreshed at "
    "scrape time — a monotone climb under steady traffic is a device-"
    "memory leak showing before the OOM does")
DEVICE_LIVE_BYTES = metrics.gauge(
    "dllama_device_live_bytes",
    "Bytes held by the live jax arrays (companion of "
    "dllama_device_live_buffers; params + KV + decode state + transients)")

# -------------------------------------------------- process self-metrics

PROCESS_UPTIME = metrics.gauge(
    "dllama_process_uptime_seconds",
    "Seconds since the serving process imported its metrics catalog "
    "(refreshed at scrape time)")
PROCESS_RSS = metrics.gauge(
    "dllama_process_rss_bytes",
    "Resident-set size of the serving process (/proc/self/statm; 0 when "
    "the platform exposes neither procfs nor resource.getrusage)")
PROCESS_THREADS = metrics.gauge(
    "dllama_process_threads",
    "Live Python threads (threading.active_count): worker + watchdog + "
    "HTTP handler threads; a leak here shows before the OOM does")

_PROC_START = time.monotonic()
_PAGE_SIZE = 4096
try:  # resource is stdlib but not on every platform
    import resource as _resource
except ImportError:  # pragma: no cover
    _resource = None
try:
    import os as _os

    _PAGE_SIZE = _os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # pragma: no cover
    pass


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        pass
    if _resource is not None:  # pragma: no cover - non-procfs fallback
        # ru_maxrss is the PEAK (not current) — still better than nothing
        # where /proc is absent. Unit is platform-defined: bytes on darwin,
        # kilobytes on linux/BSD (getrusage(2))
        import sys as _sys

        peak = _resource.getrusage(_resource.RUSAGE_SELF).ru_maxrss
        return int(peak) * (1 if _sys.platform == "darwin" else 1024)
    return 0  # pragma: no cover


def refresh_process_gauges() -> dict:
    """Refresh + return the process self-metrics (uptime, RSS, threads).
    Called at scrape time (`/metrics`, `/health`, `/debug/perf`) rather
    than on a timer — gauges are as fresh as their last read."""
    up = time.monotonic() - _PROC_START
    rss = _rss_bytes()
    threads = threading.active_count()
    PROCESS_UPTIME.set(up)
    PROCESS_RSS.set(rss)
    PROCESS_THREADS.set(threads)
    return {"uptime_s": round(up, 3), "rss_bytes": rss, "threads": threads}


# ------------------------------------------------------------ supervision

FAULT_FIRES = metrics.counter(
    "dllama_fault_fires_total",
    "Armed fault-injection activations (utils/faults.py), by point/action",
    ("point", "action"))
WATCHDOG_STALLS = metrics.counter(
    "dllama_watchdog_stalls_total",
    "Watchdog verdicts: worker silent past --stall-deadline-s with work owed")
WATCHDOG_RECOVERIES = metrics.counter(
    "dllama_watchdog_recoveries_total",
    "Watchdog stall flags cleared after heartbeats resumed")
ENGINE_RESTARTS = metrics.counter(
    "dllama_engine_restarts_total",
    "Warm engine restarts after a worker crash: decode state + page pool "
    "rebuilt against resident weights (no model reload), --restart-max "
    "budgeted")
REQUESTS_RECOVERED = metrics.counter(
    "dllama_requests_recovered_total",
    "Requests that survived a warm restart and re-entered a slot (mid-"
    "stream resumes re-prefill prompt + emitted tokens; mid-prefill "
    "admissions restart their prefill)")
KV_AUDIT_FAILURES = metrics.counter(
    "dllama_kv_audit_failures_total",
    "PagePool.audit() invariant violations + double-release guards: any "
    "nonzero value means the paged KV allocator state was corrupt")
