"""Continuous-batching scheduler: one worker thread drives a BatchEngine,
request threads stream tokens from per-request queues.

Requests join a running batch whenever a slot is free, decode together in
device chunks, and leave at EOS/budget: other requests wait only for chunk
boundaries, never for a whole completion.

Token-level stops (EOS ids, budget) are handled here; *string* stop
sequences need decoded text, so the request handler runs its detector on the
stream and calls cancel(): generation overruns by at most one chunk. With the
overlapped pipeline (the default: chunk N+1 is launched off chunk N's device
state before chunk N's tokens are consumed), token-level stops have the same
one-chunk overrun: the in-flight chunk keeps decoding a finished slot, its
tokens are discarded at consumption, and release(keep_rows=) rewinds the slot
to the truly emitted prefix.

**Radix prefix cache** (engine/radix.py; the paged default, as in the JAX
package): a GLOBAL radix tree over the KV page pool is the prefix cache.
Admission walks the tree and maps the longest shared prefix by refcount
(with the host tier on, spilled pages are copied back first), commit
inserts the prompt's full pages at once, so concurrent requests sharing a
system prompt hit it while the first still decodes, and release inserts the
emitted prefix and hands every page of the slot back: idle slots stay
empty. Page pressure evicts LRU tree leaves before a request defers.

**Per-slot prefix reuse** (the dense layout and ``radix_cache="off"``): the
batched NaiveCache (dllama-api.cpp:264-309). Released slots keep their KV
rows and the token history that produced them; admission matches a new
prompt against every slot's history at the token level and prefills only
the delta, copying a longer prefix from another slot first when one holds
it (on the paged layout by sharing its pages).

**Admission policy**: arrivals move from the thread-safe intake queue into a
backlog, picked by priority class first (``priority`` 0 low, 1 normal, 2
high), then by weighted fair queueing across tenants within a class
(start-time fair queueing: each admission charges its tenant
(prompt + max_tokens) / weight of virtual time, ``tenant_weights``), FIFO
within a tenant. **Preempt-to-pages** (``preempt``, on by default): at a
settled chunk boundary, when a strictly higher-priority request waits and is
blocked (no free slot, or its pages), the lowest-priority running request
is suspended: its written prefix enters the tree (or stays in its slot's
rows on dense), and it parks in the backlog with its resume record (emitted
tokens, generator seed and counter). Its resume re-prefills only what the
tree does not hold and continues the stream exactly where it stopped.

**Hybrid chunked prefill** (``prefill_budget``, ``--prefill-budget``; the
JAX package's default): while a request is admitting and others decode,
every device chunk is a hybrid step (``BatchEngine.hybrid_dispatch``) that
prefills up to the budget's worth of the admission's prompt tokens right
before the decode chunk, with no host read between the two, so a long
prompt never stalls the running streams. ``"auto"`` steers the budget from
the windowed ITL against ``slo_itl_ms`` (obs/perf.py; it holds 64 with no
target). ``prefill_budget=0`` keeps the phase-split path: a joining
prompt's prefill chunks run between decode chunks, paced by a stall budget
(``admit_stall_budget_ms``) and an optional TTFT deadline
(``admit_ttft_deadline_ms``), which also overrides the hybrid pacing.

**Batched speculation** (the engine built with ``spec`` = K): while some
live slot can accept drafts (greedy, a draft length ``spec_k`` > 0, a
K+1-row window) and no hybrid admission is mid-prefill, each chunk is a
spec chunk of verify cycles (``decode_dispatch(spec=True)``); sampled,
penalized and ``spec_k`` 0 requests ride its cycles one token at a time.
While a live slot has no window (the context edge, an exhausted pool), spec
and plain chunks alternate. A spec chunk's advance settles only when it is
consumed, so a switch between spec and plain chunks drains the pipeline.

**Supervision** (the JAX package's): with ``restart_max > 0`` a worker
crash warm-restarts the engine in-process (``BatchEngine.warm_restart``:
the cache, pools and per-slot state refilled in place against the resident
weights, so every captured program stays valid), and the requests it held
resume through the preemption resume path: queued ones untouched,
mid-prefill ones from scratch, mid-stream ones by re-prefilling prompt and
emitted tokens with their generator at (seed, counter = tokens emitted),
so no client sees a token lost or repeated. The budget is ``restart_max``
restarts within ``restart_window_s``, with capped exponential backoff;
once it is spent, or a restart itself dies (a sticky device error), every
request fails and ``/health`` reports ``live=false``. With
``stall_deadline_s > 0`` a watchdog thread flags the worker ``stalled``
(``live=false``, new work refused) when it owes progress and has not
stamped its heartbeat for that long, and clears the flag when the
heartbeat resumes. Fault points (utils/faults.py): ``scheduler.queue``,
``scheduler.loop`` and ``engine.restart`` here, the engine's at dispatch.
``submit(resume_tokens=)`` is the router's failover entry: a stream another
replica started re-enters here through the same resume record.

**Observability** (obs/, the JAX package's series): the scheduler is the
single write point of the request counters (admitted, shed, finished by
reason, tokens) and the TTFT/ITL/e2e histograms, records every request's
flight-recorder timeline (``obs/trace``), bills every second of its worker
loop to one state of a time ledger (``dllama_scheduler_time_seconds_total
{state}``), and feeds a perf aggregator with request finishes (latency
windows, SLO verdicts) and consumed decode chunks (bytes priced by the
engine's cost model over each chunk's window: the bandwidth attainment).

The worker thread enters ``torch.no_grad()`` itself (grad mode is
thread-local) and the engine makes every tensor on its own device.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.obs import compile as compile_obs
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import perf, trace
from dllama_tpu_torch.utils import faults, locks

log = logging.getLogger("dllama_tpu_torch.serve")

_END = object()  # sentinel on the token queue


class SchedulerRejected(RuntimeError):
    """Base of the admission-control rejections: the request never entered
    the queue. `retry_after_s` is the hint the API tier forwards as a
    Retry-After header."""

    retry_after_s: float = 1.0


class QueueFull(SchedulerRejected):
    """Shed under load: pending depth reached --max-queue (HTTP 429)."""


class SchedulerDraining(SchedulerRejected):
    """Admission stopped for a graceful shutdown (HTTP 503)."""

    retry_after_s = 5.0


class SchedulerUnhealthy(SchedulerRejected):
    """The worker thread crashed or is gone (HTTP 503)."""

    retry_after_s = 10.0


@dataclass
class Request:
    prompt: list[int]
    temperature: float
    topp: float
    max_tokens: int
    eos_ids: frozenset[int]
    seed: int | None = None
    presence: float = 0.0
    frequency: float = 0.0
    out: queue.Queue = field(default_factory=queue.Queue)
    produced: int = 0
    slot: int = -1
    finish_reason: str | None = None
    req_id: str = ""
    # the finish_reason a cancel() records: "cancelled" for a real client
    # cancellation, "stop" when the API tier releases a stream that ended on
    # a string stop sequence (a success)
    cancel_reason: str = "cancelled"
    cancelled: threading.Event = field(default_factory=threading.Event)
    # per-request deadline: expired queued requests are shed before prefill,
    # running ones finish with finish_reason="timeout" at a chunk boundary
    timeout_s: float | None = None
    deadline_at: float | None = None
    # scheduling class and tenant: `priority` (0 low, 1 normal, 2 high)
    # picks strictly between classes at admission and makes a running
    # lower-class request preemptible by a higher-class waiter; `tenant`
    # keys the weighted fair queue within a class ("" = the shared tenant)
    priority: int = 1
    tenant: str = ""
    # True between a boundary suspension and the commit that resumes it
    preempted: bool = False
    # the WFQ charge is paid once a request, not again at its resume
    wfq_charged: bool = False
    # per-request speculation: the draft length this request's slot runs at
    # (the body's spec_k, or the engine's K; clamped to it; 0 opts out), and
    # the verify cycles it took part in and the tokens they gave it
    spec_k: int = 0
    spec_cycles: int = 0
    spec_tokens: int = 0
    # resume record (preemption, warm restart, router failover): the tokens
    # already emitted (all but the last re-prefill; the last is fed next)
    # and the slot's generator state at the interruption (the request's
    # seed and counter)
    resume_tokens: list[int] | None = None
    resume_seed: int = 0
    resume_counter: int = 0
    # a warm restart's (or a failover's) survivor, counted in
    # dllama_requests_recovered_total when it is back in a slot
    recovered: bool = False
    # latency marks (time.monotonic)
    submitted_at: float = 0.0
    admitted_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None

    @property
    def ttft_ms(self) -> float | None:
        """Time to first token (queueing and prefill included)."""
        if self.first_token_at is None:
            return None
        return (self.first_token_at - self.submitted_at) * 1000.0

    @property
    def itl_ms(self) -> float | None:
        """Mean inter-token latency after the first token."""
        if self.finished_at is None or self.first_token_at is None or self.produced < 2:
            return None
        return (self.finished_at - self.first_token_at) * 1000.0 / (self.produced - 1)

    def timings(self) -> dict:
        """The per-request latency summary clients get back (the `timings`
        object of non-stream responses and of the final SSE event)."""
        qw = (None if self.admitted_at is None
              else round((self.admitted_at - self.submitted_at) * 1000.0, 3))
        ttft = self.ttft_ms
        e2e = (None if self.finished_at is None
               else round((self.finished_at - self.submitted_at) * 1000.0, 3))
        out = {"queue_wait_ms": qw, "ttft_ms": None if ttft is None else round(ttft, 3),
               "e2e_ms": e2e, "decode_tokens": self.produced}
        if self.timeout_s is not None:
            out["timeout_s"] = self.timeout_s
            out["deadline_exceeded"] = self.finish_reason == "timeout"
        if self.spec_k > 0:
            # tokens a verify forward is the speculation's speedup
            out["spec"] = {"spec_k": self.spec_k, "cycles": self.spec_cycles,
                           "tokens": self.spec_tokens,
                           "tokens_per_cycle": (round(self.spec_tokens / self.spec_cycles, 3)
                                                if self.spec_cycles else None)}
        return out

    def tokens(self, poll=None, poll_s: float = 0.25):
        """Blocking iterator over generated tokens (ends on EOS/budget/cancel).
        `poll` (a zero-argument callable) runs every `poll_s` seconds of
        WAITING, so a disconnect probe runs also while no token flows;
        whatever it raises propagates."""
        while True:
            if poll is None:
                item = self.out.get()
            else:
                try:
                    item = self.out.get(timeout=poll_s)
                except queue.Empty:
                    poll()
                    continue
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def poll_tokens(self) -> tuple[list[int], bool]:
        """NON-blocking drain of the token queue: the aio front end's SSE
        pump seam (one thread multiplexes every stream, so nothing may
        block). Returns ``(tokens, done)``: every token available now, and
        whether the stream has ended (``finish_reason`` is authoritative
        once True). A queued exception (shed, shutdown, crash) raises as in
        :meth:`tokens`."""
        toks: list[int] = []
        while True:
            try:
                item = self.out.get_nowait()
            except queue.Empty:
                return toks, False
            if item is _END:
                return toks, True
            if isinstance(item, Exception):
                raise item
            toks.append(item)


#: decode steps per device chunk
DECODE_CHUNK = 4
#: how long an idle worker sleeps between looks at the intake queue
IDLE_WAIT_S = 0.05


class Scheduler:
    def __init__(self, engine: BatchEngine, max_queue: int = 0, overlap: bool = True,
                 warmup: str = "off", prefill_budget="auto",
                 admit_stall_budget_ms: float = 250.0,
                 admit_ttft_deadline_ms: float | None = None,
                 slo_itl_ms: float | None = None, preempt: str = "auto",
                 tenant_weights: dict[str, float] | None = None,
                 slo_ttft_ms: float | None = None, stall_deadline_s: float = 0.0,
                 restart_max: int = 0, restart_window_s: float = 60.0,
                 restart_backoff_s: float = 0.5):
        self.engine = engine
        # overlapped decode pipeline (--overlap): launch chunk N+1 off chunk
        # N's device state BEFORE consuming chunk N's tokens, so the per-chunk
        # Python work runs while the card computes. Token streams are the same
        # either way; False restores the lockstep loop.
        self.overlap = bool(overlap)
        # bounded admission: submit() raises QueueFull once this many requests
        # wait (the API tier answers 429 + Retry-After); 0 = unbounded
        self.max_queue = int(max_queue)
        self.pending: queue.Queue[Request] = queue.Queue()
        # the policy backlog: the worker moves `pending` (the thread-safe
        # intake) here at each admission pass and picks by priority class,
        # then by tenant WFQ virtual time, then FIFO; preempted requests
        # park here too until priority and capacity let them resume
        self._backlog: list[Request] = []
        # per-tenant WFQ finish tags and the global virtual clock
        self._tenant_vt: dict[str, float] = {}
        self._vt_now = 0.0
        self.tenant_weights = dict(tenant_weights or {})
        # capacity-aware admission (paged layout): the head request the pool
        # cannot cover yet waits here; later requests wait behind it
        self._deferred: Request | None = None
        self.slots: dict[int, Request] = {}
        # admissions being pumped chunk by chunk: [(req, Admission, reuse)];
        # their slots are reserved (not engine.active) until commit
        self._inflight: list = []
        # per-slot token history whose KV rows are live (the prefix-cache
        # key); len(slot_tokens[s]) == engine.pos[s] for idle slots
        self.slot_tokens: dict[int, list[int]] = {}
        self.reused_prefix_tokens = 0  # prompt tokens served from the cache
        # the radix tree (paged layout, radix_cache on): when the engine has
        # one, it replaces the per-slot scan as the reuse mechanism
        self._radix = engine.radix
        # decode-to-decode gaps that admission work inserted, and the host
        # gap between one chunk's tokens and the next dispatch
        self._admit_gaps_ms: list[float] = []
        self._host_gap_ms: list[float] = []
        self._t_consumed: float | None = None
        self._t_dec_end: float | None = None
        self._completed: list[Request] = []  # ring of recent requests
        self._metrics_lock = locks.make_lock("scheduler.metrics")
        ins.SLOTS_TOTAL.set(engine.n_slots)
        self.chunks = 0  # decode chunks consumed
        self.chunk_slots = 0  # live slots summed over those chunks (batch occupancy)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.crashed: BaseException | None = None
        self.join_failed = False
        self._draining = threading.Event()
        self._busy_worker = False  # the worker holds a request outside every container
        # phase-split admission (prefill_budget=0, or no decoders to fuse
        # with): while decoders run, each visit pumps a joining prompt's
        # prefill chunks until about admit_stall_budget_ms has passed; an
        # admission older than admit_ttft_deadline_ms pumps to completion
        # whatever the pacing (hybrid included)
        self.admit_stall_budget_ms = float(admit_stall_budget_ms)
        self.admit_ttft_deadline_ms = (None if admit_ttft_deadline_ms is None
                                       else float(admit_ttft_deadline_ms))
        # hybrid chunked prefill: "auto" | int tokens a chunk (0 = phase split)
        if isinstance(prefill_budget, str) and prefill_budget != "auto":
            prefill_budget = int(prefill_budget)
        if prefill_budget != "auto" and prefill_budget < 0:
            raise ValueError(f"prefill_budget must be 'auto' or >= 0, got {prefill_budget}")
        self._hybrid_on = prefill_budget != 0 and engine.supports_hybrid
        # the time ledger bills every second of the worker loop to one state
        # (dllama_scheduler_time_seconds_total{state}); the aggregator joins
        # the latency windows and SLO verdicts (fed at each finish) with the
        # decode chunks' priced bytes over their windows (fed at each
        # consume) against the card's peak bandwidth
        self.ledger = perf.TimeLedger(counter=ins.SCHEDULER_TIME)
        self.perf = perf.PerfAggregator(
            slo=perf.SloPolicy(None if slo_ttft_ms is None else float(slo_ttft_ms),
                               None if slo_itl_ms is None else float(slo_itl_ms)),
            cost_model=engine.chunk_cost_model(),
            peak_gbs=perf.peak_hbm_gbs(engine.device))
        self._budget_ctl: perf.PrefillBudgetController | None = None
        if not self._hybrid_on:
            self._budget_now = 0
            ins.PREFILL_BUDGET.set(0)
        elif prefill_budget == "auto":
            # reads the aggregator's ITL window (perf.itl), as in JAX
            self._budget_ctl = perf.PrefillBudgetController(
                self.perf.slo, hi=max(64, int(engine.max_prefill_chunk)))
            self._budget_now = self._budget_ctl.current
        else:
            self._budget_now = max(1, int(prefill_budget))
            ins.PREFILL_BUDGET.set(self._budget_now)
        self.hybrid_chunks = 0  # decode chunks that carried a prefill slice
        self.hybrid_tokens = 0  # prompt tokens those slices prefilled
        # spec/plain alternation while a live slot has no K+1-row window: the
        # turn is taken only by a dispatch that really launches
        self._spec_tick = False
        # preempt-to-pages: "auto" = on, as in the JAX package
        if preempt not in ("auto", "on", "off"):
            raise ValueError(f"preempt must be auto|on|off, got {preempt!r}")
        self._preempt_on = preempt != "off"
        self.preempt_count = 0
        self.resume_count = 0
        # warm restart (--restart-max within --restart-window-s, backoff
        # restart_backoff_s * 2^(attempt-1) capped at restart_backoff_max_s);
        # 0 keeps the crash fatal: every request fails, /health goes live=false
        self.restart_max = int(restart_max)
        self.restart_window_s = float(restart_window_s)
        self.restart_backoff_s = float(restart_backoff_s)
        self._restarts: list[float] = []  # restart stamps inside the window
        self.restart_count = 0  # lifetime total
        # a restart's survivors, re-admitted before anything else
        self._recover: list[Request] = []
        self.stalled = False  # the watchdog's verdict
        self.stall_count = 0  # lifetime watchdog trips
        # --warmup auto: capture every program this scheduler can ask for
        # (decode n in 1..DECODE_CHUNK, every prefill width, which covers
        # the hybrid slices) BEFORE the worker starts, so the first request
        # replays graphs instead of capturing them
        if warmup not in ("auto", "off"):
            raise ValueError(f"warmup must be auto|off, got {warmup!r}")
        self.warmup = warmup
        # the capture contract: the decode programs this scheduler asks for
        engine.declare_serving_buckets(DECODE_CHUNK)
        self._last_gap_ms: float | None = None  # the decode.dispatch span's host gap
        hybrid_hi = 0
        if self._hybrid_on:
            hybrid_hi = self._budget_ctl.hi if self._budget_ctl is not None else self._budget_now
        self.warmup_report: dict | None = (
            engine.warmup(chunk=DECODE_CHUNK, hybrid_budget_hi=hybrid_hi)
            if warmup == "auto" else None)
        # the worker's heartbeat, stamped once a loop iteration (and during a
        # restart's backoff) by the worker only: a device call that hangs
        # stops it while work exists, which the watchdog reads as a stall
        self._heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._run, name="dllama-scheduler", daemon=True)
        self._thread.start()
        # the stall watchdog (--stall-deadline-s): detection only, as in the
        # JAX package: nothing can preempt a replaying graph; /health says
        # live=false and the operator (or the router) acts on it
        self.stall_deadline_s = float(stall_deadline_s)
        self._watchdog = None
        if self.stall_deadline_s > 0:
            self._watchdog = threading.Thread(target=self._watch, name="dllama-watchdog",
                                              daemon=True)
            self._watchdog.start()

    @property
    def slo(self) -> perf.SloPolicy:
        """The SLO targets (``--slo-ttft-ms``/``--slo-itl-ms``): the
        aggregator's policy, which the budget controller steers by."""
        return self.perf.slo

    # ------------------------------------------------------------------- api

    def submit(self, prompt, temperature, topp, max_tokens, eos_ids, seed: int | None = None,
               presence: float = 0.0, frequency: float = 0.0, req_id: str = "",
               timeout_s: float | None = None, priority: int = 1,
               tenant: str = "", spec_k: int | None = None,
               resume_tokens=None) -> Request:
        self.check_admission()
        # per-request speculation: None takes the engine's K (every greedy
        # request speculates at it), an explicit value clamps to K, 0 opts out
        cap = int(self.engine.spec_k)
        spec_k = cap if spec_k is None else max(0, min(int(spec_k), cap))
        req = Request(list(prompt), float(temperature), float(topp), int(max_tokens),
                      frozenset(eos_ids), seed=seed, presence=float(presence),
                      frequency=float(frequency), submitted_at=time.monotonic(), req_id=req_id,
                      priority=int(priority), tenant=str(tenant), spec_k=spec_k)
        if resume_tokens:
            # cross-replica failover: the router replays a dead replica's
            # journal here. The resume record a warm restart builds, with the
            # generator at the request's seed (an unseeded greedy resume pins
            # 0: greedy rows never read it) and counter = tokens emitted
            n = len(resume_tokens)
            req.resume_tokens = [int(t) for t in resume_tokens]
            req.produced = n
            req.resume_seed = int(seed) if seed is not None else 0
            req.resume_counter = n
            req.recovered = True
        if timeout_s is not None and timeout_s > 0:
            req.timeout_s = float(timeout_s)
            req.deadline_at = req.submitted_at + req.timeout_s
        # the flight-recorder record BEFORE the queue put: the worker may
        # admit the request before this thread runs again
        trace.TRACER.req_submit(req.req_id, prompt_tokens=len(req.prompt), t=req.submitted_at)
        self.pending.put(req)
        ins.REQUESTS_ADMITTED.inc()
        ins.QUEUE_DEPTH.set(self._queue_depth())
        if self.crashed is not None or not self._thread.is_alive():
            # lost the race with a worker crash: nobody would serve it
            raise SchedulerUnhealthy(f"scheduler worker died during submit ({self.crashed!r})")
        self._wake.set()
        return req

    def check_admission(self) -> None:
        """Admission control, cheapest check first; raises a SchedulerRejected
        subclass when no new work may enter. The API tier also calls it to
        shed stream requests before their headers go out."""
        if self.crashed is not None or not self._thread.is_alive():
            ins.REQUESTS_SHED.labels(reason="unhealthy").inc()
            raise SchedulerUnhealthy(f"scheduler worker is dead ({self.crashed!r}); "
                                     "refusing work")
        if self.stalled:
            # the watchdog says the worker is wedged mid-chunk: more work
            # would strand more clients (503 + Retry-After until it clears)
            ins.REQUESTS_SHED.labels(reason="unhealthy").inc()
            raise SchedulerUnhealthy("scheduler worker is stalled (device chunk past "
                                     "--stall-deadline-s); refusing work")
        if self._draining.is_set():
            ins.REQUESTS_SHED.labels(reason="draining").inc()
            raise SchedulerDraining("scheduler is draining; no new requests")
        depth = self._queue_depth()
        if self.max_queue and depth >= self.max_queue:
            ins.REQUESTS_SHED.labels(reason="queue_full").inc()
            raise QueueFull(f"admission queue full ({depth} >= --max-queue {self.max_queue})")
        try:
            faults.fire("scheduler.queue")
        except faults.InjectedFault as e:
            # the drill impersonates overflow, so it counts as overflow
            ins.REQUESTS_SHED.labels(reason="queue_full").inc()
            raise QueueFull(str(e)) from e

    def _queue_depth(self) -> int:
        """Requests owed service but not admitted yet: the intake queue, the
        policy backlog (preempted requests awaiting resume included) and
        the capacity-deferred head (one definition for /health and the
        --max-queue bound)."""
        return (self.pending.qsize() + len(self._backlog)
                + (1 if self._deferred is not None else 0))

    def _busy(self) -> bool:
        """Whether the worker owes anyone progress."""
        return (bool(self.slots) or bool(self._inflight) or self._deferred is not None
                or bool(self._backlog) or bool(self._recover) or not self.pending.empty()
                or self._busy_worker)

    def health(self) -> dict:
        """Liveness + readiness for the API tier's /health: `live` is false
        when the worker cannot make progress (dead, crashed past its restart
        budget, or stalled past the watchdog's deadline), `ready` also while
        draining or saturated."""
        qdepth = self._queue_depth()
        live = (self._thread.is_alive() and self.crashed is None and not self.join_failed
                and not self.stalled)
        saturated = bool(self.max_queue) and qdepth >= self.max_queue
        return {
            "live": live,
            "ready": live and not self._draining.is_set() and not saturated,
            "queue_depth": qdepth,
            "max_queue": self.max_queue,
            "busy_slots": int(np.asarray(self.engine.active).sum()),
            "n_slots": self.engine.n_slots,
            "in_flight_admissions": len(self._inflight),
            "kv_pages": self.engine.kv_page_stats(),
            "admission_deferred": self._deferred is not None,
            # the live hybrid prefill budget a chunk (0 = phase-split admission)
            "prefill_budget": self._budget_now,
            # preemption: lifetime totals, and suspended requests awaiting resume
            "preemptions": self.preempt_count,
            "resumed": self.resume_count,
            "preempted_waiting": sum(1 for r in list(self._backlog) if r.preempted),
            "last_step_age_s": round(time.monotonic() - self._heartbeat, 3),
            "stall_deadline_s": self.stall_deadline_s,
            "stalled": self.stalled,
            "stall_count": self.stall_count,
            # warm-restart supervision: lifetime restarts, the budget, and
            # the recovered requests still awaiting re-admission
            "restarts": self.restart_count,
            "restart_max": self.restart_max,
            "recovering": len(self._recover),
            "draining": self._draining.is_set(),
            "crashed": repr(self.crashed) if self.crashed is not None else None,
            "join_failed": self.join_failed,
            # capture observability: a capture storm shows in the probe
            # without a scrape; unexpected > 0 means the contract broke
            "compile": {
                "warmup": self.warmup,
                "warmed_buckets": (None if self.warmup_report is None
                                   else self.warmup_report["graphs_captured"]),
                "full_coverage": (None if self.warmup_report is None
                                  else self.warmup_report["full_coverage"]),
                "compiles": compile_obs.LEDGER.total_compiles(),
                "unexpected_compiles": compile_obs.LEDGER.total_unexpected(),
            },
        }

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: stop admission (submit raises SchedulerDraining),
        let running and queued requests finish, shut down and audit the page
        pool with the radix tree (and host tier) intact; then return the
        cached pages, the idle slots' and the tree's, so a clean drain
        leaves every page free. True when everything completed inside the
        timeout."""
        self._draining.set()
        self._wake.set()
        trace.TRACER.event("drain.begin", cat="lifecycle", track="scheduler",
                           timeout_s=float(timeout_s))
        deadline = time.monotonic() + max(0.0, timeout_s)
        clean = False
        while time.monotonic() < deadline:
            if not self._busy():
                clean = True
                break
            if self.crashed is not None or not self._thread.is_alive():
                break
            time.sleep(0.02)
        if not clean:
            log.warning("drain timeout (%.1fs): %d slots / %d admissions / %d queued still "
                        "in flight; shutting down anyway", timeout_s, len(self.slots),
                        len(self._inflight), self.pending.qsize())
        trace.TRACER.event("drain.end", cat="lifecycle", track="scheduler", clean=clean)
        self.shutdown()
        pool = self.engine.pool
        if pool is not None:
            report = pool.audit(raise_on_fail=False)
            if not report["ok"]:
                log.error("kv page-pool audit FAILED at drain: %s", "; ".join(report["problems"]))
            if not self._thread.is_alive():
                # nothing is served after a drain: the idle slots' cached
                # prefixes and the tree's pages go back too
                for s in np.flatnonzero(~self.engine.active):
                    self.engine.drop_slot_pages(int(s))
                    self.slot_tokens[int(s)] = []
                if self._radix is not None:
                    self._radix.clear()
                report = pool.audit(raise_on_fail=False)
                if not report["ok"]:
                    log.error("kv page-pool audit FAILED after returning the cached pages: "
                              "%s", "; ".join(report["problems"]))
        return clean

    def reset_latency_stats(self) -> None:
        """Drop the accumulated latency and stall samples (a benchmark calls
        this after its warm-up, so that capture gaps stay out of the
        measured record): the completed-request ring, the admission and
        host-gap samples, the decode-gap anchors (the first gap after the
        reset cannot span back to a chunk before it), and the aggregator's
        sliding windows, swapped for a fresh one with the same SLO policy,
        cost model and peak."""
        with self._metrics_lock:
            self._completed.clear()
            self._admit_gaps_ms.clear()
            self._host_gap_ms.clear()
            self._t_dec_end = None
            self._t_consumed = None
            self.perf = perf.PerfAggregator(slo=self.perf.slo, cost_model=self.perf.cost_model,
                                            peak_gbs=self.perf.peak_gbs)

    def latency_summary(self) -> dict:
        """TTFT / inter-token latency over completed requests, plus the
        admission-stall and host-gap records."""
        with self._metrics_lock:
            done = list(self._completed)
            gaps = list(self._admit_gaps_ms)
            hgaps = list(self._host_gap_ms)
        ttfts = sorted(r.ttft_ms for r in done if r.ttft_ms is not None)
        itls = [r.itl_ms for r in done if r.itl_ms is not None]

        def mean(xs):
            return sum(xs) / len(xs) if xs else None

        def q_ms(w, q):  # the aggregator's sliding windows (obs/perf)
            v = w.quantile(q)
            return None if v is None else round(v * 1000.0, 3)

        return {
            "completed": len(done),
            "ttft_ms_mean": mean(ttfts),
            "ttft_ms_p50": ttfts[len(ttfts) // 2] if ttfts else None,
            "ttft_ms_p95": q_ms(self.perf.ttft, 0.95),
            "ttft_ms_max": ttfts[-1] if ttfts else None,
            "itl_ms_mean": mean(itls),
            "itl_ms_p50": q_ms(self.perf.itl, 0.5),
            "itl_ms_p95": q_ms(self.perf.itl, 0.95),
            "reused_prefix_tokens": self.reused_prefix_tokens,
            "admission_gaps": len(gaps),
            "admission_stall_ms_max": max(gaps) if gaps else None,
            "admission_stall_ms_mean": mean(gaps),
            "decode_host_gaps": len(hgaps),
            "decode_host_gap_ms_mean": mean(hgaps),
            "decode_chunks": self.chunks,
            "decode_slots_mean": self.chunk_slots / self.chunks if self.chunks else None,
            "kv_pages": self.engine.kv_page_stats(),
            # radix prefix-cache accounting (None with the tree off or dense):
            # hit_tokens is the prefill rows the tree saved
            "radix": self.engine.radix_stats(),
            "hybrid": {
                "mode": ("off" if not self._hybrid_on
                         else "auto" if self._budget_ctl is not None else "fixed"),
                "prefill_budget": self._budget_now,
                "chunks": self.hybrid_chunks,
                "tokens": self.hybrid_tokens,
            },
            # preempt-to-pages: lifetime suspensions and resumes
            "preemptions": self.preempt_count,
            "resumed": self.resume_count,
            # the capture ledger: lifetime captures, seconds and unexpected
            # ones, the host-side view of the dllama_jit_* series
            "compile": dict(compile_obs.LEDGER.summary(), warmup_mode=self.warmup),
            # speculation's acceptance record (None with spec off), the
            # dllama_spec_* series' host-side view
            "spec": self.engine.spec_stats(),
        }

    def cancel(self, req: Request, reason: str = "cancelled") -> None:
        """Release a request's slot; `reason` becomes its finish_reason if it
        is still live. A no-op for requests that already finished."""
        req.cancel_reason = reason
        req.cancelled.set()
        self._wake.set()

    #: how long shutdown() waits for the worker before declaring it wedged
    join_timeout_s: float = 10.0

    #: ceiling on the exponential restart backoff (an attribute: drills
    #: shrink it so many injected crashes stay fast)
    restart_backoff_max_s: float = 5.0

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=self.join_timeout_s)
        if self._thread.is_alive():
            self.join_failed = True
            log.warning("scheduler worker failed to join within %.1fs; engine state is "
                        "unrecoverable, /health reports live=false", self.join_timeout_s)

    # ------------------------------------------------------------------ loop

    def _observe_finish(self, req: Request) -> None:
        """The single registry write point for a terminal request: the
        finish counter, the TTFT/ITL/e2e histograms and the aggregator's
        windows and SLO verdicts from the request's own marks, and the
        flight recorder's end record (every terminal path comes here)."""
        ins.REQUESTS_FINISHED.labels(reason=req.finish_reason or "unknown").inc()
        trace.TRACER.req_end(req.req_id, req.finish_reason or "unknown",
                             t=req.finished_at, **req.timings())
        if req.first_token_at is not None:
            ins.TTFT_SECONDS.observe(req.first_token_at - req.submitted_at)
        if req.finished_at is not None:
            ins.E2E_SECONDS.observe(req.finished_at - req.submitted_at)
        itl = req.itl_ms
        if itl is not None:
            ins.ITL_SECONDS.observe(itl / 1000.0)
        self.perf.observe_finish(
            finish_reason=req.finish_reason or "unknown", ttft_ms=req.ttft_ms, itl_ms=itl,
            e2e_ms=(None if req.finished_at is None
                    else (req.finished_at - req.submitted_at) * 1000.0),
            tokens=req.produced)

    def _finish(self, req: Request, reason: str, keep_rows: int | None = None) -> None:
        if req.slot >= 0:
            if self._radix is not None:
                # the tree is the cache: insert the emitted prefix (its full
                # pages gain a tree reference), then hand every page of the
                # slot back. keep_rows=None means the rows are unspecified
                # (error paths): nothing enters the tree.
                if keep_rows:
                    self.engine.radix_insert(
                        req.slot, self.slot_tokens.get(req.slot, [])[:keep_rows])
                self.engine.release(req.slot, None)
                self.slot_tokens[req.slot] = []
            else:
                self.engine.release(req.slot, keep_rows)
                if keep_rows is not None:
                    # only the first keep_rows tokens have live KV rows (the
                    # last emitted token was sampled but never fed back)
                    self.slot_tokens[req.slot] = self.slot_tokens.get(req.slot, [])[:keep_rows]
                else:
                    self.slot_tokens[req.slot] = []  # unknown state: never reuse
            self.slots.pop(req.slot, None)
            req.slot = -1
        req.finish_reason = req.finish_reason or reason
        req.finished_at = time.monotonic()
        with self._metrics_lock:
            self._completed.append(req)
            del self._completed[:-256]
        self._observe_finish(req)
        ins.BUSY_SLOTS.set(len(self.slots))
        req.out.put(_END)

    def _emit(self, req: Request, token: int, row_at_emit: int) -> bool:
        """Queue one token; returns True when the request just finished."""
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
            trace.TRACER.req_first_token(req.req_id, t=req.first_token_at)
        req.out.put(int(token))
        req.produced += 1
        ins.TOKENS_GENERATED.inc()
        if req.slot >= 0:
            self.slot_tokens.setdefault(req.slot, []).append(int(token))
        if token in req.eos_ids:
            self._finish(req, "stop", keep_rows=row_at_emit)
            return True
        if req.produced >= req.max_tokens:
            self._finish(req, "length", keep_rows=row_at_emit)
            return True
        return False

    def _pick_slot(self, prompt: list[int]) -> tuple[int | None, int, int | None]:
        """(slot, reusable prefix length, donor): the idle slot whose cached
        history shares the longest prefix with `prompt`. When ANOTHER slot
        (idle or decoding) holds a longer match, the cheapest idle slot is
        chosen and `donor` names the slot to copy the prefix from. Slots
        reserved by in-flight admissions are neither destinations nor donors.
        Cross-slot donors need the engine's slot copy: on a dp mesh, which
        shards the batch axis, the search stays within the idle slots."""
        reserved = {adm.slot for _, adm, _ in self._inflight}
        idle = [s for s in range(self.engine.n_slots)
                if not self.engine.active[s] and s not in reserved]
        if not idle:
            return None, 0, None
        donors = ([s for s in range(self.engine.n_slots) if s not in reserved]
                  if self.engine.supports_cross_slot_copy else idle)
        lcp = self._lcp_lengths(prompt, donors)
        best_idle = max(idle, key=lcp.__getitem__)
        best_any = max(donors, key=lcp.__getitem__)
        if lcp[best_any] > lcp[best_idle]:
            dst = min(idle, key=lambda s: len(self.slot_tokens.get(s, [])))
            return dst, lcp[best_any], best_any
        if lcp[best_idle] > 0:
            return best_idle, lcp[best_idle], None
        return min(idle, key=lambda s: len(self.slot_tokens.get(s, []))), 0, None

    def _lcp_lengths(self, prompt: list[int], donors: list[int]) -> dict[int, int]:
        """Longest-common-prefix length of `prompt` against every donor's
        cached history, in one padded-matrix comparison; capped so at least
        one prompt token is left to prefill, and one lower for an ACTIVE
        donor (its last emitted token has no KV row yet)."""
        caps = {}
        for s in donors:
            cached = self.slot_tokens.get(s, [])
            n = min(len(cached), len(prompt) - 1)
            if self.engine.active[s]:
                n = min(n, len(cached) - 1)
            caps[s] = max(n, 0)
        width = max(caps.values(), default=0)
        if width <= 0:
            return dict.fromkeys(donors, 0)
        mat = np.full((len(donors), width), -1, np.int64)  # -1 is never a token
        for i, s in enumerate(donors):
            if caps[s]:
                mat[i, : caps[s]] = self.slot_tokens[s][: caps[s]]
        hit = mat == np.asarray(prompt[:width], np.int64)[None, :]
        lens = np.cumprod(hit, axis=1).sum(axis=1)  # leading run of matches
        return {s: int(n) for s, n in zip(donors, lens)}

    def _reclaim_pages(self, needed: int) -> bool:
        """Free KV pages for the all-starved decode rescue: LRU tree leaves
        when the tree is the cache, idle slots' kept pages otherwise. True
        when anything came free."""
        if self._radix is not None:
            return self.engine.radix_evict(needed) > 0
        return self._evict_idle_pages(needed, set())

    def _evict_idle_pages(self, needed: int, exclude: set) -> bool:
        """Paged prefix-cache reclaim: drop idle slots' cached pages
        (smallest caches first) until `needed` pages came free, then stop.
        `exclude` protects the chosen destination and donor. True when
        anything was freed."""
        reserved = {adm.slot for _, adm, _ in self._inflight}
        victims = sorted((s for s in range(self.engine.n_slots)
                          if not self.engine.active[s] and s not in reserved
                          and s not in exclude and self.slot_tokens.get(s)),
                         key=lambda s: len(self.slot_tokens.get(s, [])))
        freed = 0
        for s in victims:
            if freed >= needed:
                break
            freed += self.engine.drop_slot_pages(s)
            self.slot_tokens[s] = []
        return freed > 0

    def _reject(self, req: Request, reason: str, exc: BaseException | None = None) -> None:
        """Terminal finish of a request that holds no slot."""
        if exc is not None:
            req.finish_reason = reason  # before the put: the client reads it at once
            req.out.put(exc)
        self._finish(req, reason)

    def _shed_timeout(self, req: Request, where: str = "queued") -> None:
        """Terminal 'timeout' finish of a request not admitted yet: shed
        before prefill (no slot, no pages, no device work)."""
        ins.REQUESTS_SHED.labels(reason="timeout").inc()
        trace.TRACER.event("request.timeout", cat="deadline", track="requests",
                           req_id=req.req_id, where=where)
        self._finish(req, "timeout")

    def _shed_expired_queued(self) -> None:
        """Deadline sweep over requests not admitted yet, once per boundary:
        a saturated server may pop nothing for a long time, and timeout_s
        must bound the wait all the same."""
        now = time.monotonic()

        def expired(r: Request) -> bool:
            return r.deadline_at is not None and now >= r.deadline_at

        dead: list[Request] = []
        with self.pending.mutex:
            q = self.pending.queue
            if any(expired(r) for r in q):
                dead.extend(r for r in q if expired(r))
                keep = [r for r in q if not expired(r)]
                q.clear()
                q.extend(keep)
        if any(expired(r) for r in self._backlog):
            # preempted requests whose deadline passed while suspended too
            # (a clean 'timeout' finish; their emitted tokens stand)
            dead.extend(r for r in self._backlog if expired(r))
            self._backlog = [r for r in self._backlog if not expired(r)]
        if any(expired(r) for r in self._recover):
            dead.extend(r for r in self._recover if expired(r))
            self._recover = [r for r in self._recover if not expired(r)]
        if self._deferred is not None and expired(self._deferred):
            dead.append(self._deferred)
            self._deferred = None
        for req in dead:
            self._shed_timeout(req)

    # ------------------------------------------------------ admission policy

    def _drain_pending(self) -> None:
        """Move intake-queue arrivals into the policy backlog (worker side;
        submit() keeps the thread-safe queue as its entry point)."""
        while True:
            try:
                self._backlog.append(self.pending.get_nowait())
            except queue.Empty:
                return

    def _tenant_weight(self, tenant: str) -> float:
        return max(float(self.tenant_weights.get(tenant, 1.0)), 1e-6)

    def _select_next(self) -> Request | None:
        """Policy pick from the backlog: the highest priority class present;
        within it the tenant with the smallest WFQ virtual time; within a
        tenant, FIFO. Pops and returns the pick (None on an empty backlog)."""
        if not self._backlog:
            return None
        best_i, best_key = 0, None
        for i, r in enumerate(self._backlog):
            key = (-int(r.priority), self._tenant_vt.get(r.tenant, 0.0), i)
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        return self._backlog.pop(best_i)

    def _charge_tenant(self, req: Request) -> None:
        """Start-time fair queueing charge at admission: the start tag is
        max(the tenant's own finish tag, the virtual clock), the tenant's
        finish tag advances by (prompt + max_tokens) / weight from there,
        and the clock moves to the start tag. A tenant back from idle gets
        one immediate pick and then competes from 'now' (idle time banks no
        credit). Charged once a request: a resume was already paid for."""
        if req.wfq_charged:
            return
        req.wfq_charged = True
        own = self._tenant_vt.get(req.tenant, 0.0)
        start = max(own, self._vt_now)
        cost = len(req.prompt) + max(int(req.max_tokens), 1)
        self._tenant_vt[req.tenant] = start + cost / self._tenant_weight(req.tenant)
        self._vt_now = start

    def _record_resume(self, req: Request, slot: int) -> bool:
        """Stamp `req` with its resume record off `slot`'s settled state:
        the emitted tokens, the request's seed and the slot's generator
        counter, which equals the tokens emitted (one draw at commit, one a
        decode step). False when the emit record disagrees (no trustworthy
        resume)."""
        emitted = self.slot_tokens.get(slot, [])[len(req.prompt):]
        if req.produced < 1 or len(emitted) != req.produced:
            return False
        req.resume_tokens = list(emitted)
        req.resume_seed = int(self.engine.seeds[slot])
        req.resume_counter = req.produced
        return True

    def _preempt(self, req: Request, reason: str) -> bool:
        """Suspend a RUNNING request at this settled boundary: record its
        resume point, then release the slot while its written rows stay
        referenced: the tree adopts their full pages (the resume maps them
        back; only a partial boundary page re-prefills), and on the dense
        layout the slot keeps its rows for the per-slot prefix cache. The
        request parks in the backlog; the policy decides when it resumes.
        False when it has no trustworthy resume record (it runs on)."""
        slot = req.slot
        if not self._record_resume(req, slot):
            return False
        req.preempted = True
        rows = int(self.engine.pos[slot])
        if self._radix is not None:
            self.engine.radix_insert(slot, self.slot_tokens[slot][:rows])
            self.engine.release(slot, None)
            self.slot_tokens[slot] = []
        else:
            self.engine.release(slot, rows)
            self.slot_tokens[slot] = self.slot_tokens.get(slot, [])[:rows]
        self.slots.pop(slot, None)
        req.slot = -1
        self._backlog.append(req)
        self.preempt_count += 1
        ins.BUSY_SLOTS.set(len(self.slots))
        ins.PREEMPTIONS.labels(reason=reason).inc()
        trace.TRACER.event("request.preempted", cat="scheduling", track="requests",
                           req_id=req.req_id, reason=reason, tokens=req.produced)
        log.info("preempted request (reason=%s, %d tokens emitted; its pages stay "
                 "referenced)", reason, req.produced, extra=trace.log_extra(req.req_id))
        return True

    def _maybe_preempt(self) -> None:
        """Boundary preemption check: when a STRICTLY higher-priority
        request waits and is blocked (no free slot: reason 'slot'; or the
        capacity-deferred head out-ranks a runner: 'capacity'), suspend the
        lowest-priority running request (the most recently admitted among
        ties: the least work lost). At most one a boundary; admission in the
        same pass reuses the freed slot and pages."""
        if not self._preempt_on or not self.slots:
            return
        now = time.monotonic()
        waiting = [r for r in self._backlog + ([self._deferred] if self._deferred else [])
                   if not r.cancelled.is_set()
                   and (r.deadline_at is None or now < r.deadline_at)]
        if not waiting:
            return
        top = max(waiting, key=lambda r: int(r.priority))
        victims = [r for r in self.slots.values()
                   if int(r.priority) < int(top.priority) and not r.cancelled.is_set()]
        if not victims:
            return
        reserved = {adm.slot for _, adm, _ in self._inflight}
        free_slots = sum(1 for s in range(self.engine.n_slots)
                         if not self.engine.active[s] and s not in reserved)
        if free_slots <= 0:
            reason = "slot"
        elif (self._deferred is not None
              and int(self._deferred.priority) >= int(top.priority)):
            # a slot is free but the top waiter is parked on KV pages: the
            # runner's release hands its pages to the tree, where admission
            # reclaim can evict them
            reason = "capacity"
        else:
            return
        victim = min(victims, key=lambda r: (int(r.priority), -(r.admitted_at or 0.0)))
        self._preempt(victim, reason)

    def _admit_starts(self, boundary: bool = True) -> None:
        """Move backlog requests, in policy order, into in-flight admissions
        while slots allow. ``boundary=False`` is the overlapped loop's early
        start (hybrid on, a chunk in flight): the admitting slot is inactive
        in that chunk and every device write of the start lands after it in
        stream order; preemption waits for a settled boundary (releasing a
        running slot needs settled mirrors).

        Paged layout: capacity is FREE PAGES as well as free slots. A request
        the pool cannot cover first reclaims cache (LRU tree leaves, the
        matched path protected; or idle slots' kept pages without the tree),
        and if still short waits in `_deferred` until releases free pages."""
        self._drain_pending()
        self._shed_expired_queued()
        if boundary:
            self._maybe_preempt()
        if (self._deferred is not None and self._backlog
                and max(int(r.priority) for r in self._backlog) > int(self._deferred.priority)):
            # a capacity-parked lower-priority head must not gate a higher-
            # priority arrival: it rejoins the backlog (deferral holds no pages)
            self._backlog.append(self._deferred)
            self._deferred = None
        reserved = len(self._inflight)
        while self._recover or self._deferred is not None or self._backlog:
            if int((~self.engine.active).sum()) - reserved <= 0:
                return
            from_recover = False
            if self._recover:
                # a restart's survivors re-admit first (the oldest work)
                req = self._recover.pop(0)
                from_recover = True
            elif self._deferred is not None:
                req, self._deferred = self._deferred, None
            else:
                req = self._select_next()
                self._charge_tenant(req)
            if req.cancelled.is_set():
                self._reject(req, req.cancel_reason)
                continue
            if req.deadline_at is not None and time.monotonic() >= req.deadline_at:
                self._shed_timeout(req)
                continue
            # the rows to write: the prompt, and for a resume every emitted
            # token but the last (it becomes the token fed next)
            toks = (req.prompt if req.resume_tokens is None
                    else req.prompt + req.resume_tokens[:-1])
            if len(toks) >= self.engine.seq_len:
                self._reject(req, "error", ValueError(
                    f"prompt ({len(toks)}) exceeds seq_len {self.engine.seq_len}"))
                continue
            pool = self.engine.pool
            if pool is not None and self.engine.min_pages_for(len(toks)) > pool.n_pages:
                # the prompt's pages (+ the decode reserve) can never all be
                # resident at once: deferring would block the head forever
                self._reject(req, "error", ValueError(
                    f"prompt ({len(toks)}) needs {self.engine.min_pages_for(len(toks))} KV "
                    f"pages; the pool holds {pool.n_pages}"))
                continue
            rhit, cross = None, False
            if self._radix is not None:
                # the GLOBAL tree is the cache: any idle slot serves (all are
                # empty), and a shortfall evicts LRU leaves, the matched path
                # protected, before the request parks
                taken = {adm.slot for _, adm, _ in self._inflight}
                slot = next(s for s in range(self.engine.n_slots)
                            if not self.engine.active[s] and s not in taken)
                reuse, rhit = self.engine.radix_lookup(toks)
                deficit = self.engine.radix_admission_deficit(len(toks), reuse)
                if deficit > 0 and self.engine.radix_evict(deficit, rhit) > 0:
                    deficit = self.engine.radix_admission_deficit(len(toks), reuse)
                if deficit > 0 and not self.slots and not self._inflight:
                    # nothing running will ever free a page, so what the pool
                    # lacks is held by this admission's own matched path:
                    # give up the reuse instead of waiting forever (the JAX
                    # scheduler defers here and never admits)
                    self.engine.radix_evict(self.engine.radix_admission_deficit(len(toks), 0))
                    reuse, rhit = 0, None
                    deficit = self.engine.radix_admission_deficit(len(toks), 0)
            else:
                slot, reuse, donor = self._pick_slot(toks)
                cross = donor is not None and donor != slot and reuse > 0
                deficit = self.engine.admission_deficit(slot, reuse, len(toks), cross)
                if deficit > 0:
                    # reclaim just enough idle cache (keeping the destination
                    # and donor), then pick again: eviction may change the
                    # best donor
                    if self._evict_idle_pages(deficit, {slot, donor}):
                        slot, reuse, donor = self._pick_slot(toks)
                        cross = donor is not None and donor != slot and reuse > 0
                    deficit = self.engine.admission_deficit(slot, reuse, len(toks), cross)
            if deficit > 0:
                # every missing page is held by RUNNING requests: wait at the
                # head until releases free them (a survivor at the recover
                # head: the deferred box may hold the pre-crash head already)
                if from_recover:
                    self._recover.insert(0, req)
                else:
                    self._deferred = req
                return
            try:
                if rhit is not None and reuse:
                    # map the tree prefix by refcount; add_begin's
                    # prepare_admission copy-on-writes a partial boundary page
                    self.engine.radix_map(slot, rhit)
                elif cross:
                    self.engine.copy_prefix_rows(donor, slot, reuse)
                    self.slot_tokens[slot] = list(self.slot_tokens.get(donor, [])[:reuse])
                adm = self.engine.add_begin(slot, toks[reuse:], start_pos=reuse,
                                            req_id=req.req_id)
            except Exception as e:  # a bad request (too long, ...): fail just this one
                log.exception("admission rejected", extra=trace.log_extra(req.req_id))
                # the slot's cache state is unknown now: drop the claim and
                # the pages, losing only this slot's prefix reuse
                self.slot_tokens[slot] = []
                self.engine.drop_slot_pages(slot)
                self._reject(req, "error", e)
                continue
            req.slot = slot
            req.admitted_at = time.monotonic()
            trace.TRACER.req_admitted(req.req_id, slot=slot, reused_tokens=reuse,
                                      t=req.admitted_at)
            self._inflight.append((req, adm, reuse))
            reserved += 1

    def _abort_admission(self, req: Request, adm, reason) -> None:
        """The slot's rows past start_pos may be partly overwritten: its old
        history no longer describes them, and _finish keeps nothing."""
        self.slot_tokens[adm.slot] = []
        if isinstance(reason, Exception):
            req.finish_reason = "error"
            req.out.put(reason)
            reason = "error"
        self._finish(req, reason)

    def _commit_admission(self, req: Request, adm, reuse: int) -> None:
        """Commit the HEAD in-flight admission (fully pumped): activate the
        slot and emit the first token, or for a preempted request install its
        resume record (the last emitted token and the generator state) and
        sample nothing; with the tree on, insert the written rows' full
        pages at once."""
        self.ledger.transition("commit")
        self._inflight.pop(0)
        if req.resume_tokens is not None:
            self.engine.resume_commit(
                adm, req.resume_tokens[-1], req.resume_seed, req.resume_counter,
                req.temperature, req.topp, presence=req.presence, frequency=req.frequency,
                counted=req.resume_tokens[:-1] if (req.presence or req.frequency) else None,
                spec_k=req.spec_k)
            self.slot_tokens[adm.slot] = list(req.prompt) + list(req.resume_tokens)
            self.slots[adm.slot] = req
            if self._radix is not None:
                if reuse:
                    self._radix.note_served(reuse)
                self.engine.radix_insert(adm.slot,
                                         list(req.prompt) + list(req.resume_tokens[:-1]))
            trace.TRACER.req_prefill_done(req.req_id, tokens=len(adm.toks) + reuse,
                                          reused=reuse)
            if req.recovered:
                req.preempted = False
                self._note_recovered(req)
                return
            req.preempted = False
            self.resume_count += 1
            ins.RESUMED.inc()
            trace.TRACER.event("request.resumed", cat="scheduling", track="requests",
                               req_id=req.req_id, tokens=req.produced)
            return
        first = self.engine.add_commit(adm, req.temperature, req.topp, seed=req.seed,
                                       presence=req.presence, frequency=req.frequency,
                                       spec_k=req.spec_k)
        self.reused_prefix_tokens += reuse
        ins.REUSED_PREFIX_TOKENS.inc(reuse)
        self.slot_tokens[adm.slot] = list(req.prompt)
        self.slots[adm.slot] = req
        if self._radix is not None:
            # saved-prefill accounting at commit (rows really served), and
            # the prompt's full pages enter the tree now: concurrent requests
            # sharing it hit it while this one decodes
            if reuse:
                self._radix.note_served(reuse)
            self.engine.radix_insert(adm.slot, req.prompt)
        trace.TRACER.req_prefill_done(req.req_id, tokens=len(req.prompt), reused=reuse)
        self._emit(req, first, int(self.engine.pos[adm.slot]))
        if req.recovered:  # a restart's mid-prefill survivor: no token had reached it
            self._note_recovered(req)

    def _note_recovered(self, req: Request) -> None:
        """A restart's (or a failover's) survivor is back in a slot: counted
        now, not at the restart (it could still fail or be cancelled during
        re-admission)."""
        req.recovered = False
        ins.REQUESTS_RECOVERED.inc()
        trace.TRACER.event("request.recovered", cat="supervision", track="requests",
                           req_id=req.req_id, tokens=req.produced)

    def _overdue(self, req: Request) -> bool:
        """Past the TTFT deadline (admit_ttft_deadline_ms): the admission
        pumps to completion whatever the pacing."""
        return (self.admit_ttft_deadline_ms is not None
                and (time.monotonic() - req.submitted_at) * 1000.0
                >= self.admit_ttft_deadline_ms)

    def _hybrid_now(self) -> bool:
        """Whether in-flight admissions ride hybrid chunks now: hybrid is on
        AND there are decoders to ride with (with none, the phase-split pump
        prefills at full speed: nothing to protect)."""
        return self._hybrid_on and bool(self.slots)

    def _commit_ready_inflight(self) -> None:
        """Early commit (overlapped loop, hybrid on): a fully pumped head
        admission activates its slot while a chunk is in flight, instead of
        draining the pipeline for a whole boundary. Its slot is inactive in
        that chunk, and add_commit's device writes land after it in stream
        order."""
        while self._inflight:
            req, adm, reuse = self._inflight[0]
            if (adm.off < len(adm.toks) or req.cancelled.is_set()
                    or (req.deadline_at is not None and time.monotonic() >= req.deadline_at)):
                return  # mid-pump, or an abort for the boundary to handle
            try:
                self._commit_admission(req, adm, reuse)
            except Exception as e:
                log.exception("commit failed", extra=trace.log_extra(req.req_id))
                if self._inflight and self._inflight[0][1] is adm:
                    self._inflight.pop(0)
                self._abort_admission(req, adm, e)

    def _pump_admissions(self) -> bool:
        """Advance in-flight admissions. Under hybrid an admission's prefill
        rides the decode chunks (_dispatch_chunk): the pump only commits
        fully pumped admissions, and pumps one past the TTFT deadline to
        completion. On the phase-split path (prefill_budget=0, or no
        decoders): while decoders run, pump prefill chunks until
        admit_stall_budget_ms is spent (decode chunks run between calls),
        an overdue admission to completion; with no decoders to protect,
        the whole queue. Returns True if any prefill ran."""
        worked = False
        t0 = time.monotonic()
        while self._inflight:
            req, adm, reuse = self._inflight[0]
            if req.cancelled.is_set():
                self._inflight.pop(0)
                self._abort_admission(req, adm, req.cancel_reason)
                continue
            if req.deadline_at is not None and time.monotonic() >= req.deadline_at:
                # the deadline crossed mid-prefill: stop spending chunks on it
                self._inflight.pop(0)
                trace.TRACER.event("request.timeout", cat="deadline", track="requests",
                                   req_id=req.req_id, where="prefill")
                self._abort_admission(req, adm, "timeout")
                continue
            pumped = adm.off >= len(adm.toks)
            if not pumped and self._hybrid_now() and not self._overdue(req):
                return worked  # the hybrid chunks carry this prefill
            try:
                tr = trace.TRACER
                done = pumped
                if not pumped:
                    t_ch = tr.now() if tr.enabled else 0.0
                    self.ledger.transition("prefill")
                    done = self.engine.add_step(adm)
                    if (self.slots and not self._hybrid_on and adm.logits is not None
                            and adm.logits.is_cuda):
                        # decoders are waiting: let the pacing clock see the
                        # chunk's device time, not just its launch
                        torch.cuda.current_stream(adm.logits.device).synchronize()
                    if tr.enabled:
                        tr.span_at("prefill.chunk", t_ch, tr.now(), cat="prefill",
                                   track="scheduler", req_id=req.req_id, slot=adm.slot,
                                   off=int(adm.off), total=len(adm.toks))
                    worked = True
                if done:
                    self._commit_admission(req, adm, reuse)
            except Exception as e:
                log.exception("prefill failed", extra=trace.log_extra(req.req_id))
                if self._inflight and self._inflight[0][1] is adm:
                    self._inflight.pop(0)
                self._abort_admission(req, adm, e)
                continue
            if not self.slots:
                continue  # no decoders to protect: drain the queue
            # judged after the chunk ran, so a deadline crossed during it
            # counts this visit
            overdue = self._overdue(req)
            if done and overdue:
                return worked  # one overdue admission a visit, then decode
            if (time.monotonic() - t0) * 1000.0 < self.admit_stall_budget_ms:
                continue
            if not done and overdue:
                continue  # the TTFT deadline: finish it despite the budget
            return worked  # the budget is spent: let the decoders run
        return worked

    def _fail_req(self, req: Request, exc: BaseException) -> None:
        """Crash-path finish: mark the request failed and unblock its
        consumer WITHOUT touching the engine (its state is unknown after a
        crash)."""
        req.finish_reason = "error"
        req.finished_at = time.monotonic()
        with self._metrics_lock:
            self._completed.append(req)
            del self._completed[:-256]
        self._observe_finish(req)
        req.out.put(exc)
        req.out.put(_END)

    def _fail_all(self, exc: BaseException) -> None:
        """Fail every queue a client could be blocked on: in-flight
        admissions, decoding slots, a restart's survivors, the backlog, the
        capacity-deferred head and the intake queue. Nobody hangs on a dead
        worker."""
        reqs = ([r for r, _, _ in self._inflight] + list(self.slots.values())
                + self._recover + self._backlog)
        if self._deferred is not None:
            reqs.append(self._deferred)
        self._inflight.clear()
        self.slots.clear()
        self._recover = []
        self._backlog = []
        self._deferred = None
        while True:
            try:
                reqs.append(self.pending.get_nowait())
            except queue.Empty:
                break
        for req in reqs:
            self._fail_req(req, exc)

    def _watch(self) -> None:
        """The stall watchdog: flag `stalled` when the worker owes progress
        and its heartbeat is older than the deadline; clear it when the
        heartbeat resumes (stall_count keeps the record either way)."""
        poll = max(0.01, min(0.25, self.stall_deadline_s / 4.0))
        while not self._stop.is_set():
            time.sleep(poll)
            if self.crashed is not None:
                return  # crash supervision owns the health verdict
            age = time.monotonic() - self._heartbeat
            if self._busy() and age > self.stall_deadline_s:
                if not self.stalled:
                    self.stalled = True
                    self.stall_count += 1
                    ins.WATCHDOG_STALLS.inc()
                    trace.TRACER.event("watchdog.stall", cat="supervision", track="scheduler",
                                       age_s=round(age, 3))
                    log.error("watchdog: scheduler worker silent for %.2fs with work in "
                              "flight (deadline %.2fs); device chunk presumed hung, /health "
                              "reports live=false", age, self.stall_deadline_s)
            elif self.stalled and age <= self.stall_deadline_s:
                self.stalled = False
                ins.WATCHDOG_RECOVERIES.inc()
                trace.TRACER.event("watchdog.recover", cat="supervision", track="scheduler")
                log.warning("watchdog: worker heartbeat resumed; clearing the stall flag "
                            "(%d stalls in all)", self.stall_count)

    def _run(self) -> None:
        """Supervised worker entry: an escape from the serving loop first
        tries a warm restart under the restart budget (engine state rebuilt
        in place against the resident weights, survivors recovered, the loop
        re-entered); with no budget left, or a restart that itself dies,
        every request fails at once (finish_reason 'error', queues
        unblocked) and /health goes live=false for good."""
        try:
            if self.engine.device.type == "cuda" and self.engine.device.index is not None:
                torch.cuda.set_device(self.engine.device)
            with torch.no_grad():
                while True:
                    try:
                        self._loop()
                        return
                    except BaseException as e:  # noqa: BLE001 - supervision must be total
                        try:
                            if self._try_restart(e):
                                continue
                        except BaseException as e2:  # noqa: BLE001 - the restart died too
                            log.exception("warm restart failed; giving up")
                            e = e2
                        self.crashed = e
                        log.exception("scheduler worker crashed; failing all in-flight "
                                      "requests, /health reports live=false")
                        self._fail_all(e)
                        return
        finally:
            # stop the ledger clock with the worker: its last span is billed
            self.ledger.close()

    def _try_restart(self, exc: BaseException) -> bool:
        """Warm restart after a worker crash; False when restarts are off or
        the budget (restart_max within restart_window_s) is spent. Queued
        and capacity-deferred requests survive untouched; mid-prefill
        admissions re-prefill from scratch; mid-stream requests resume by
        re-prefilling prompt and emitted tokens with their generator at
        (seed, counter = tokens emitted), so the stream continues exactly;
        a request whose emit record disagrees fails alone."""
        if self.restart_max <= 0 or self._stop.is_set():
            return False
        now = time.monotonic()
        self._restarts = [t for t in self._restarts if now - t < self.restart_window_s]
        if len(self._restarts) >= self.restart_max:
            log.error("restart budget exhausted (%d within --restart-window-s %.1fs); "
                      "staying down", self.restart_max, self.restart_window_s)
            return False
        self._restarts.append(now)
        # until the loop re-anchors the ledger, every instant is restart time
        self.ledger.transition("restart_backoff")
        self.restart_count += 1
        attempt = len(self._restarts)
        ins.ENGINE_RESTARTS.inc()
        trace.TRACER.event("engine.restart", cat="supervision", track="scheduler",
                           attempt=attempt, error=repr(exc))
        log.warning("scheduler worker crashed (%r); warm restart %d/%d (window %.1fs)",
                    exc, attempt, self.restart_max, self.restart_window_s)
        faults.fire("engine.restart")  # drill: a restart that itself dies
        # capped exponential backoff: the budget, not the backoff, gives up
        delay = min(self.restart_backoff_s * (2 ** min(attempt - 1, 10)),
                    self.restart_backoff_max_s)
        deadline = now + delay
        while time.monotonic() < deadline and not self._stop.is_set():
            # a heartbeat-stamped sleep: restarting is progress, not a hang
            self._heartbeat = time.monotonic()
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
        # the recovery set comes from the host records BEFORE the engine is
        # touched (only device state is suspect)
        recover: list[Request] = []
        for slot, req in sorted(self.slots.items(), key=lambda kv: kv[1].submitted_at):
            ok = self._record_resume(req, slot)
            req.slot = -1
            if not ok:
                self._fail_req(req, RuntimeError(
                    "request not recoverable across the engine restart (its emitted-token "
                    f"record disagrees with produced {req.produced})"))
                continue
            req.recovered = True
            recover.append(req)
        self.slots.clear()
        for req, _adm, _ in self._inflight:
            # mid-prefill: its rows died with the cache; re-prefill it whole
            req.slot = -1
            req.recovered = True
            recover.append(req)
        self._inflight.clear()
        self.slot_tokens.clear()
        # the survivors wait where _fail_all finds them, should the rebuild
        # raise (a mesh whose world a dead rank broke refuses it)
        self._recover = recover + self._recover
        self.engine.warm_restart()
        self._radix = self.engine.radix  # rebuilt empty against the reset pool
        pool = self.engine.pool
        if pool is not None:
            # a reset pool failing its audit means the rebuild is broken:
            # crash the restart (budget-counted) rather than serve from it
            pool.audit()
        self._busy_worker = False
        self._t_dec_end = None
        self._t_consumed = None
        self._heartbeat = time.monotonic()
        self._wake.set()
        log.warning("warm restart complete: %d request(s) recovered for re-admission, %d "
                    "queued untouched", len(recover), self.pending.qsize())
        return True

    def _needs_boundary(self, inflight_chunk=None) -> bool:
        """True when the next chunk must wait for a fully consumed pipeline:
        admission work on the phase-split path (a prefill must not interleave
        with a chunk in flight, and commit/release need settled host
        mirrors), a pending cancel or deadline, a slot at its row limit, or
        an emptied batch. Under hybrid a head admission mid-prefill rides the
        pipelined chunks; its commit (done early by the loop), an abort and
        the TTFT-deadline override need settled state."""
        if self._stop.is_set():
            return True
        if (not self.slots or self._deferred is not None or self._backlog
                or not self.pending.empty()):
            return True
        if self._inflight:
            if not self._hybrid_now():
                return True
            req, adm, _ = self._inflight[0]
            if (adm.off >= len(adm.toks) or req.cancelled.is_set()
                    or (req.deadline_at is not None and time.monotonic() >= req.deadline_at)
                    or self._overdue(req)):
                return True
        now = time.monotonic()
        if any(r.cancelled.is_set() or (r.deadline_at is not None and now >= r.deadline_at)
               for r in self.slots.values()):
            return True
        limit = self.engine._row_limit()
        if any(int(self.engine.pos[s]) >= int(limit[s]) for s in self.slots):
            return True
        if inflight_chunk is not None:
            # budget finishes are predictable on the host (unlike EOS): when
            # every live request runs out within the chunk in flight, a
            # successor would be pure discarded overrun. A spec chunk's counts
            # are still on the card: its optimistic bound (n cycles of K+1)
            # skips a successor at worst one boundary early
            if inflight_chunk.spec:
                bound = inflight_chunk.n * (int(self.engine.spec_k) + 1)
                return all(req.produced + bound >= req.max_tokens
                           for req in self.slots.values())
            return all(req.produced + int(inflight_chunk.advance[slot]) >= req.max_tokens
                       for slot, req in self.slots.items())
        return False

    def _dispatch_chunk(self, pipeline_empty: bool = True, exclude_gap_s: float = 0.0,
                        inflight=None):
        """Launch the next decode chunk -> (chunk, slots snapshot): a hybrid
        step carrying up to ``_budget_now`` prompt tokens of the head
        admission while it is mid-prefill and decoders run; else a spec
        chunk of verify cycles while some live slot can accept drafts
        (alternating with plain chunks while a live slot has no K+1-row
        window); else a plain decode chunk. Returns None, launching nothing,
        when `inflight` (the unconsumed predecessor) is of the other kind
        (spec or not): the host position mirror settles only when a spec
        chunk is consumed, so the switch drains the pipeline first. Records
        the host gap: the time since the last chunk's tokens arrived when
        the pipeline was empty (minus `exclude_gap_s` of admission work), 0
        when a chunk was still in flight. A failure here is not a
        per-request problem (the cache was being written in place): it
        escalates to the worker's crash path."""
        hyb = None
        hyb_req = None
        if self._hybrid_now() and self._inflight:
            req, adm, _ = self._inflight[0]
            if (adm.off < len(adm.toks) and not req.cancelled.is_set()
                    and (req.deadline_at is None or time.monotonic() < req.deadline_at)):
                hyb, hyb_req = adm, req
        use_spec = alternating = False
        if self.engine.spec_k and hyb is None:
            # speculate while some live slot can accept drafts; the others
            # ride the cycles one token at a time (eligibility is per slot,
            # on the card). A live slot with no K+1-row window freezes in
            # spec cycles, so plain chunks alternate in until it finishes
            draft = self.engine.spec_draft_k()
            use_spec = any(draft[s] > 0 for s in self.slots)
            if use_spec:
                elig = self.engine.spec_eligible()
                if not all(elig[s] for s in self.slots):
                    alternating = True
                    use_spec = not self._spec_tick
        if inflight is not None and bool(inflight.spec) != use_spec:
            # a mode switch consumes the chunk in flight first; the
            # alternation's turn is not taken by a dispatch that launches
            # nothing (else every launched chunk would be spec and the
            # frozen slot would starve)
            return None
        if alternating:
            self._spec_tick = use_spec
        n_disp = DECODE_CHUNK
        if use_spec and all(req.max_tokens - req.produced <= int(self.engine.spec_k) + 1
                            for req in self.slots.values()):
            # tail clamp: when every live request fits in one cycle's K+1
            # tokens, one cycle instead of a chunk of overrun (n in {1, chunk})
            n_disp = 1
        self.ledger.transition("hybrid" if hyb is not None else "decode_dispatch")
        self._last_gap_ms = None
        if self._t_consumed is not None:
            gap_s = (max(0.0, time.monotonic() - self._t_consumed - exclude_gap_s)
                     if pipeline_empty else 0.0)
            ins.DECODE_HOST_GAP_SECONDS.observe(gap_s)
            self._last_gap_ms = gap_s * 1000.0
            with self._metrics_lock:
                self._host_gap_ms.append(gap_s * 1000.0)
                del self._host_gap_ms[:-256]
        tr = trace.TRACER
        t0 = tr.now() if tr.enabled else 0.0
        if hyb is None:
            chunk = self.engine.decode_dispatch(n_disp, spec=use_spec)
        else:
            if self._budget_ctl is not None:
                # steered by the live ITL window (rate-limited in the controller)
                self._budget_now = self._budget_ctl.update(self.perf.itl)
            off0 = hyb.off
            try:
                chunk = self.engine.hybrid_dispatch(DECODE_CHUNK, hyb, self._budget_now)
            except faults.InjectedFault as e:
                if e.point != "engine.prefill":
                    raise  # a decode drill keeps the fatal contract
                # the engine.prefill drill fires before hybrid_dispatch moves
                # any state: fail just the joiner and run a plain chunk (a
                # real failure inside the replays stays engine-fatal)
                self._inflight.pop(0)
                self._abort_admission(hyb_req, hyb, e)
                hyb = None
                chunk = self.engine.decode_dispatch(DECODE_CHUNK)
            if hyb is not None:
                self.hybrid_chunks += 1
                self.hybrid_tokens += chunk.hybrid_tokens
        if tr.enabled:
            # the dispatch span is host work; under overlap it lands inside
            # the previous chunk's decode.device span
            tr.span_at("decode.dispatch", t0, tr.now(), cat="decode", track="scheduler",
                       chunk=chunk.seq, n=chunk.n, occupancy=len(self.slots),
                       spec=use_spec, pipelined=not pipeline_empty,
                       hybrid_tokens=(chunk.hybrid_tokens or None),
                       host_gap_ms=(None if self._last_gap_ms is None
                                    else round(self._last_gap_ms, 3)))
            if chunk.hybrid_tokens and hyb is not None:
                # the admitting request's prefill story stays complete under
                # hybrid: each slice is a prefill.chunk span of its own
                tr.span_at("prefill.chunk", t0, tr.now(), cat="prefill", track="scheduler",
                           req_id=hyb_req.req_id, slot=chunk.hybrid_slot, off=int(off0),
                           total=len(hyb.toks), hybrid=True)
        return chunk, dict(self.slots)

    def _consume_chunk(self, chunk, snapshot) -> None:
        """Wait for a dispatched chunk's tokens and emit them to the requests
        captured at dispatch. A slot whose request finished while the chunk
        was in flight is skipped: its tokens are the one-chunk overrun, and
        release(keep_rows=) already rewound the slot."""
        tr = trace.TRACER
        t0 = tr.now() if tr.enabled else 0.0
        self.ledger.transition("decode_wait")
        toks = self.engine.decode_consume(chunk)
        self.chunks += 1
        self.chunk_slots += len(snapshot)
        self._t_dec_end = self._t_consumed = time.monotonic()
        self.ledger.transition("emit")
        if chunk.active.any():
            # roofline feed: the chunk's HBM traffic at its dispatch-time
            # occupancy and mean live-KV horizon, over the window
            # decode_consume measured
            self.perf.observe_chunk(
                occupancy=int(chunk.active.sum()),
                live_rows=float(chunk.start_pos[chunk.active].mean()) + (chunk.n + 1) / 2.0,
                steps=chunk.n, tokens=int(chunk.advance.sum()), device_s=chunk.device_s)
        if tr.enabled:
            tr.span_at("decode.consume", t0, tr.now(), cat="decode", track="scheduler",
                       chunk=chunk.seq, n=chunk.n)
            t_emit = tr.now()
        bad = chunk.nonfinite()  # NaN guard: fail THOSE requests, not the engine
        for slot, req in snapshot.items():
            if self.slots.get(slot) is not req:
                continue
            if bad is not None and bad[slot]:
                log.error("non-finite logits in decode chunk %d (slot %d); failing the "
                          "request, engine stays up", chunk.seq, slot,
                          extra=trace.log_extra(req.req_id))
                self.slot_tokens[slot] = []  # poisoned rows: never reuse
                req.finish_reason = "error"
                req.out.put(RuntimeError(f"non-finite logits in decode chunk {chunk.seq}; "
                                         "request failed (engine healthy)"))
                self._finish(req, "error")
                continue
            if chunk.spec and chunk.advance[slot]:
                # the request's acceptance record (timings()' spec object):
                # the cycles it took part in and the tokens they gave it
                req.spec_cycles += int((chunk.adv_cycles[:, slot] > 0).sum())
                req.spec_tokens += int(chunk.advance[slot])
            if tr.enabled and chunk.advance[slot]:
                # the flight-recorder chunk entry BEFORE the tokens reach the
                # client queue: a response never races its own record
                tr.req_chunk(req.req_id, chunk.seq, int(chunk.advance[slot]))
            for i in range(int(chunk.advance[slot])):
                # the row written when sampling token i: start + i (+1 = prefix length)
                if self._emit(req, toks[i, slot], int(chunk.start_pos[slot]) + i + 1):
                    break
        if tr.enabled:
            tr.span_at("emit.scan", t_emit, tr.now(), cat="decode", track="scheduler",
                       chunk=chunk.seq)

    def _loop(self) -> None:
        # from here until close(), every instant is billed to one state
        self.ledger.start("idle")
        pending = None  # overlap mode: the dispatched, unconsumed chunk
        while not self._stop.is_set():
            self._heartbeat = time.monotonic()
            ins.QUEUE_DEPTH.set(self._queue_depth())
            ins.BUSY_SLOTS.set(len(self.slots))
            faults.fire("scheduler.loop")
            if pending is not None:
                # keep the card busy: launch the successor off the device
                # state BEFORE consuming, unless boundary work needs the
                # settled state first
                if self._hybrid_on and not pending[0].spec:
                    # early commit and early admission start: a fully pumped
                    # admission activates its slot now, and a queued arrival
                    # enters _inflight so its first hybrid slice rides the
                    # very next chunk, neither waiting for a drained pipeline
                    # (the admitting slot is inactive in the chunk in flight,
                    # and every device write lands after it in stream order;
                    # not off a spec chunk, whose advance has not settled)
                    self._busy_worker = True
                    if self._inflight:
                        self._commit_ready_inflight()
                    if self._backlog or not self.pending.empty():
                        self.ledger.transition("admission")
                        self._admit_starts(boundary=False)
                    self._busy_worker = False
                nxt = (None if self._needs_boundary(pending[0])
                       else self._dispatch_chunk(pipeline_empty=False, inflight=pending[0]))
                self._consume_chunk(*pending)
                pending = nxt
                continue
            t_boundary = time.monotonic()
            self._busy_worker = True
            self.ledger.transition("admission")
            self._admit_starts()
            admitted = self._pump_admissions()
            # the boundary scans below are admission-side work; this also
            # bills the pump's open tail
            self.ledger.transition("admission")
            self._busy_worker = False
            for slot, req in list(self.slots.items()):
                if req.cancelled.is_set():
                    self._finish(req, req.cancel_reason, keep_rows=int(self.engine.pos[slot]))
                elif req.deadline_at is not None and time.monotonic() >= req.deadline_at:
                    trace.TRACER.event("request.timeout", cat="deadline", track="requests",
                                       req_id=req.req_id, where="decoding")
                    self._finish(req, "timeout", keep_rows=int(self.engine.pos[slot]))
                elif int(self.engine.pos[slot]) >= self.engine.seq_len:
                    self._finish(req, "length")
            if self.slots:
                # pool exhaustion mid-decode: a starved slot waits frozen while
                # its batch-mates run; when EVERY live slot is starved nothing
                # will free a page, so finish the most advanced one
                starved = self.engine.page_starved()
                if starved.any() and all(starved[s] for s in self.slots):
                    if not self._reclaim_pages(len(self.slots)):
                        victim = max((s for s in self.slots if starved[s]),
                                     key=lambda s: int(self.engine.pos[s]))
                        log.warning("kv page pool exhausted with every active slot starved; "
                                    "finishing slot %d (finish_reason=length)", victim)
                        self._finish(self.slots[victim], "length")
            if not self.slots:
                self._t_dec_end = None
                if not self._inflight:
                    self.ledger.transition("idle")
                    self._wake.wait(timeout=IDLE_WAIT_S)
                    self._wake.clear()
                continue
            if admitted and self._t_dec_end is not None:
                gap_ms = (time.monotonic() - self._t_dec_end) * 1000.0
                with self._metrics_lock:
                    self._admit_gaps_ms.append(gap_ms)
                    del self._admit_gaps_ms[:-256]
                ins.ADMISSION_STALL_SECONDS.observe(gap_ms / 1000.0)
            chunk = self._dispatch_chunk(exclude_gap_s=time.monotonic() - t_boundary)
            if self.overlap:
                pending = chunk
            else:
                self._consume_chunk(*chunk)
        # shutdown with work in flight: the cut requests must surface as
        # FAILURES (a bare end would read as a complete generation)
        if pending is not None:
            self._consume_chunk(*pending)
        cut = [r for r, _, _ in self._inflight] + list(self.slots.values())
        for _, adm, _ in self._inflight:
            self.slot_tokens[adm.slot] = []  # rows are mid-overwrite
        self._inflight.clear()
        if self._deferred is not None:
            cut.append(self._deferred)
            self._deferred = None
        cut.extend(self._recover + self._backlog)
        self._recover = []
        self._backlog = []
        while True:
            try:
                cut.append(self.pending.get_nowait())
            except queue.Empty:
                break
        for req in cut:
            req.finish_reason = "shutdown"
            req.out.put(SchedulerDraining("server shut down before this request completed"))
            self._finish(req, "shutdown")
