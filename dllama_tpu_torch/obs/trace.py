"""Request-flow span tracing: the serving stack's flight recorder.

Aggregate metrics (obs/metrics.py) answer "how slow is the fleet"; this
module answers "why was THIS request slow" and "did dispatch actually
overlap consume on THAT chunk".  Three pieces, all process-global like the
metrics registry:

* a thread-safe **span tracer** with a bounded ring buffer: the scheduler,
  engine, API tier, watchdog, and fault injector record spans (name, track,
  t0..t1, args) and instant events, keyed by the serving-tier ``req_id`` so
  traces, ``/metrics`` series, and structured log lines correlate on the
  same id;
* a **per-request flight recorder**: a bounded map req_id -> timeline
  (queue wait, prefill, TTFT, per-chunk token counts, finish reason) that
  survives ring eviction — ``GET /debug/requests[/{req_id}]`` serves it
  for postmortems;
* a **Chrome trace-event exporter** (:meth:`Tracer.export_chrome`): the
  JSON ``GET /debug/trace`` returns loads directly in Perfetto /
  chrome://tracing, with one named track per subsystem ("scheduler",
  "device", "requests") so the overlapped decode pipeline is *visible* as
  interleaved dispatch/consume/device spans.

Disabled mode (:func:`configure` with capacity 0, CLI ``--trace-buffer 0``)
swaps in a singleton no-op tracer: ``span()`` returns the same null span
every call (no allocation), every record call is a constant-time no-op —
the serving hot path pays one attribute load and an ``enabled`` test.

All timestamps are ``time.monotonic()`` (the scheduler's own mark clock),
exported as microseconds relative to the tracer's construction epoch.
Stdlib-only (threading + collections), like the rest of dllama_tpu_torch.obs:
every layer can import it without cycles or optional-dependency gates.
"""

from __future__ import annotations

import time
import uuid
from collections import OrderedDict, deque

from dllama_tpu_torch.utils import locks

#: the distributed-trace hop header: the router mints one trace
#: context per proxied request and stamps every upstream leg with
#: ``trace_id:parent_span:hop`` — the replica tags its flight-recorder
#: record (and, through the record, its exported spans) with the trace id,
#: so a failover's second replica leg joins the SAME trace
HOP_HEADER = "X-Dllama-Trace"


def new_trace_id() -> str:
    """A fresh 16-hex trace id (distinct from the request id: one trace may
    span several request legs across replicas)."""
    return uuid.uuid4().hex[:16]


def format_hop(trace_id: str, parent_span: str, hop: int) -> str:
    """Serialize a trace context for the hop header."""
    return f"{trace_id}:{parent_span}:{int(hop)}"


def parse_hop(value) -> tuple[str, str, int] | None:
    """Parse a hop-header value -> (trace_id, parent_span, hop), or None
    when absent/malformed (tracing is best-effort: a bad header must never
    fail the request carrying it)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.split(":")
    if len(parts) != 3 or not parts[0]:
        return None
    try:
        return parts[0], parts[1], int(parts[2])
    except ValueError:
        return None

#: span names the serving stack emits — the documented contract between the
#: instrumentation, the README trace-catalog table, and scripts/checks.sh's
#: drift check (adding an emit site means adding a catalog row)
SPAN_CATALOG = {
    "queue.wait": "admission queue wait: submit -> popped for admission (track: requests)",
    "prefill": "whole admission prefill: popped -> first token committed (track: requests)",
    "prefill.chunk": "one pumped prefill chunk, device-synced whenever decoders would stall (track: scheduler)",
    "request": "whole request lifetime: submit -> terminal state (track: requests)",
    "decode.dispatch": "host work to dispatch one fused decode chunk (track: scheduler)",
    "decode.consume": "blocking wait for a dispatched chunk's tokens (track: scheduler)",
    "decode.device": "chunk dispatch -> tokens materialized: the device-side window (track: device)",
    "decode.spec": "one batched speculative propose/verify cycle (track: device)",
    "emit.scan": "post-consume token emit + EOS/budget stop scan (track: scheduler)",
    "compile": "one jit trace/lower/compile attributed to a dispatch site (obs/compile ledger); args carry fn/key/classification — visible in Perfetto as compile stealing device time mid-traffic (track: compile)",
    "proxy": "router: one relay leg of a proxied SSE stream — headers to terminal frame or upstream death; args carry replica/verdict (track: router)",
    "connect": "router: connect + request + response headers of one upstream forwarding attempt; args carry replica/hop (track: router)",
    "poll": "router: one /health poll exchange against a replica — doubles as the NTP-lite clock sample; args carry replica/ok (track: poll)",
    "failover.attempt": "router: one mid-stream failover attempt — the jittered exponential backoff + survivor pick before a resume dispatch; args carry attempt (track: router)",
    "resume": "router: connect + resume request to a survivor replica, journal replay included; args carry replica/tokens (track: router)",
    "journal": "router: a proxied stream's failover-journal hold window, acquire to release; args carry valid (False = ring-capped, unresumable) + tokens journaled + retries (track: router)",
}

#: instant-event names (``ph: "i"`` in the export), same drift contract
EVENT_CATALOG = {
    "first_token": "a request's first token reached its client queue (track: requests)",
    "drain.begin": "graceful drain started: admission stopped (track: scheduler)",
    "drain.end": "graceful drain finished; args carry `clean` (track: scheduler)",
    "watchdog.stall": "watchdog flagged the worker silent past the deadline (track: scheduler)",
    "watchdog.recover": "worker heartbeats resumed; stall flag cleared (track: scheduler)",
    "fault.fire": "an armed fault injection activated; args carry point/action (track: scheduler)",
    "profile.start": "an on-demand torch.profiler capture started; args carry dir (track: profiler)",
    "profile.stop": "the on-demand capture stopped and wrote its files (track: profiler)",
    "engine.restart": "warm restart after a worker crash: decode state + page pool rebuilt, weights resident; args carry attempt/error (track: scheduler)",
    "request.recovered": "a request survived a warm restart and re-entered a slot; args carry resumed token count (track: requests)",
    "request.timeout": "a request hit its per-request deadline (timeout_s / X-Request-Timeout); args carry where (queued/prefill/decoding) (track: requests)",
    "request.preempted": "a running request was suspended at a chunk boundary for higher-priority work; its pages stay referenced and it resumes byte-identical later; args carry reason (slot/capacity) + emitted tokens (track: requests)",
    "request.resumed": "a preempted request re-entered a slot and its stream continued (track: requests)",
    "affinity.pick": "router: one routing decision; args carry replica/warm (affinity hit) — the warm-routing record a merged trace shows next to the replica's radix lookups (track: router)",
}


def _clean(v):
    """JSON-safe scalar: numpy ints/floats become Python scalars, anything
    exotic becomes its repr-ish string (export must never raise)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)  # numpy scalar -> Python scalar
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    return str(v)


class _Span:
    """A live span handle from :meth:`Tracer.span`: record it with
    :meth:`end` (extra args merge into the span's args) or use it as a
    context manager.  The span enters the ring only at end time."""

    __slots__ = ("_tr", "name", "cat", "track", "req_id", "t0", "args")

    def __init__(self, tr, name, cat, track, req_id, args):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.track = track
        self.req_id = req_id
        self.args = args
        self.t0 = time.monotonic()

    def end(self, **extra) -> None:
        if extra:
            self.args.update(extra)
        self._tr._record(self.name, self.cat, self.track, self.req_id,
                         self.t0, time.monotonic(), self.args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class _NullSpan:
    """The shared no-op span of the disabled tracer (never allocated per
    call — ``tracer.span(...) is tracer.span(...)``)."""

    __slots__ = ()

    def end(self, **extra) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """The ``--trace-buffer 0`` fast path: the full :class:`Tracer` surface
    with every method a constant-time no-op and no per-call allocation.
    Hot-path call sites additionally guard on :attr:`enabled` so even the
    kwargs dicts for span args are never built."""

    enabled = False
    capacity = 0

    @staticmethod
    def now() -> float:
        return time.monotonic()

    def span(self, name, **kw):
        return NULL_SPAN

    def span_at(self, *a, **kw):
        pass

    def event(self, *a, **kw):
        pass

    def req_submit(self, *a, **kw):
        pass

    def req_admitted(self, *a, **kw):
        pass

    def req_prefill_done(self, *a, **kw):
        pass

    def req_first_token(self, *a, **kw):
        pass

    def req_chunk(self, *a, **kw):
        pass

    def req_mark(self, *a, **kw):
        pass

    def req_end(self, *a, **kw):
        pass

    def trace_of(self, req_id):
        return None

    def export_chrome(self) -> dict:
        return {"traceEvents": []}

    def requests_summary(self) -> list:
        return []

    def request_timeline(self, req_id):
        return None

    def stats(self) -> dict:
        return {"enabled": False, "capacity": 0, "events": 0, "dropped": 0,
                "requests": 0}

    def reset(self) -> None:
        pass


NULL_TRACER = NullTracer()

#: flight-recorder record template — the /debug/requests/{req_id} schema
#: (underscore keys are internal monotonic marks, stripped from responses)
_REC_TEMPLATE = {
    "req_id": "", "state": "queued", "prompt_tokens": 0,
    "submitted_at_ms": None, "queue_wait_ms": None, "slot": None,
    "reused_tokens": 0, "prefill": None, "ttft_ms": None, "e2e_ms": None,
    "decode_tokens": 0, "finish_reason": None, "chunks": None,
    "chunks_dropped": 0, "_t_submit": None, "_t_admitted": None,
}

#: summary keys for the /debug/requests list view (chunks collapses to a count)
_SUMMARY_KEYS = ("req_id", "state", "prompt_tokens", "submitted_at_ms",
                 "queue_wait_ms", "ttft_ms", "e2e_ms", "decode_tokens",
                 "finish_reason")


class Tracer:
    """Thread-safe span tracer + flight recorder over one bounded ring."""

    enabled = True

    def __init__(self, capacity: int = 2048, max_requests: int = 128,
                 max_chunks_per_request: int = 512):
        if capacity <= 0:
            raise ValueError("capacity must be > 0 (use NULL_TRACER / "
                             "configure(0) for the disabled fast path)")
        self.capacity = int(capacity)
        self.max_requests = int(max_requests)
        self.max_chunks = int(max_chunks_per_request)
        # LEAF rank (utils/locks): record paths do pure ring/dict work and
        # must never acquire anything under it
        self._lock = locks.make_lock("obs.tracer")
        self._events: deque = deque(maxlen=self.capacity)
        self._dropped = 0
        self._tracks: dict[str, int] = {}
        self._requests: OrderedDict[str, dict] = OrderedDict()
        self._epoch = time.monotonic()

    @staticmethod
    def now() -> float:
        return time.monotonic()

    @property
    def epoch(self) -> float:
        """The monotonic instant exported timestamps are relative to —
        published in the /health clock payload so a router can place this
        process's trace on the mesh timeline."""
        return self._epoch

    def _rel_ms(self, t: float | None):
        return None if t is None else round((t - self._epoch) * 1000.0, 3)

    # ---------------------------------------------------------------- spans

    def span(self, name: str, *, cat: str = "", track: str = "scheduler",
             req_id: str = "", **args) -> _Span:
        """Open a span ending at ``end()`` / context-manager exit."""
        return _Span(self, name, cat, track, req_id, args)

    def span_at(self, name: str, t0: float, t1: float, *, cat: str = "",
                track: str = "scheduler", req_id: str = "", **args) -> None:
        """Record an already-finished span from explicit monotonic marks."""
        self._record(name, cat, track, req_id, t0, t1, args)

    def event(self, name: str, *, cat: str = "", track: str = "scheduler",
              req_id: str = "", **args) -> None:
        """Record an instant event (``ph: "i"``) at now."""
        self._record(name, cat, track, req_id, time.monotonic(), None, args)

    def _record(self, name, cat, track, req_id, t0, t1, args) -> None:
        a = {k: _clean(v) for k, v in args.items()} if args else {}
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = self._tracks[track] = len(self._tracks) + 1
            if len(self._events) == self.capacity:
                self._dropped += 1  # deque maxlen evicts the oldest
            self._events.append((name, cat, tid, req_id, t0, t1, a))

    # ------------------------------------------------------ flight recorder

    def _rec(self, req_id: str) -> dict:
        """Get-or-create a request record (caller holds the lock)."""
        rec = self._requests.get(req_id)
        if rec is None:
            rec = dict(_REC_TEMPLATE)
            rec["req_id"] = req_id
            rec["chunks"] = []
            self._requests[req_id] = rec
            while len(self._requests) > self.max_requests:
                self._requests.popitem(last=False)
        return rec

    def req_submit(self, req_id: str, prompt_tokens: int = 0,
                   t: float | None = None) -> None:
        """A request entered the system (queue or single-engine lock wait)."""
        if not req_id:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            rec = self._rec(req_id)
            rec["_t_submit"] = t
            rec["submitted_at_ms"] = self._rel_ms(t)
            if prompt_tokens:
                rec["prompt_tokens"] = int(prompt_tokens)

    def req_admitted(self, req_id: str, slot: int | None = None,
                     reused_tokens: int = 0, t: float | None = None) -> None:
        """Popped for admission; emits the ``queue.wait`` span."""
        if not req_id:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            rec = self._rec(req_id)
            rec["_t_admitted"] = t
            rec["state"] = "prefill"
            if slot is not None:
                rec["slot"] = int(slot)
            if reused_tokens:
                rec["reused_tokens"] = int(reused_tokens)
            t0 = rec["_t_submit"]
            if t0 is not None:
                rec["queue_wait_ms"] = round((t - t0) * 1000.0, 3)
        if t0 is not None:
            self.span_at("queue.wait", t0, t, cat="queue", track="requests",
                         req_id=req_id)

    def req_prefill_done(self, req_id: str, tokens: int = 0, reused: int = 0,
                         t: float | None = None) -> None:
        """Admission committed; emits the whole-``prefill`` span."""
        if not req_id:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            rec = self._rec(req_id)
            rec["state"] = "decoding"
            t0 = rec["_t_admitted"]
            rec["prefill"] = {
                "tokens": int(tokens), "reused_tokens": int(reused),
                "ms": round((t - t0) * 1000.0, 3) if t0 is not None else None,
            }
        if t0 is not None:
            self.span_at("prefill", t0, t, cat="prefill", track="requests",
                         req_id=req_id, tokens=int(tokens), reused=int(reused))

    def req_first_token(self, req_id: str, t: float | None = None) -> None:
        if not req_id:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            rec = self._rec(req_id)
            rec["state"] = "decoding"
            t0 = rec["_t_submit"]
            if t0 is not None and rec["ttft_ms"] is None:
                rec["ttft_ms"] = round((t - t0) * 1000.0, 3)
        self._record("first_token", "request", "requests", req_id, t, None, {})

    def req_chunk(self, req_id: str, chunk: int, tokens: int,
                  t: float | None = None) -> None:
        """One consumed decode chunk contributed `tokens` rows to req_id."""
        if not req_id:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            rec = self._rec(req_id)
            ch = rec["chunks"]
            ch.append({"chunk": int(chunk), "tokens": int(tokens),
                       "at_ms": self._rel_ms(t)})
            if len(ch) > self.max_chunks:
                del ch[0]  # keep the tail: postmortems care how it ENDED
                rec["chunks_dropped"] += 1

    def req_mark(self, req_id: str, **fields) -> None:
        """Merge arbitrary (non-internal) fields into a request's record."""
        if not req_id:
            return
        with self._lock:
            rec = self._rec(req_id)
            for k, v in fields.items():
                if k.startswith("_") or k in ("req_id", "chunks"):
                    continue
                if isinstance(v, dict):
                    rec[k] = {kk: _clean(vv) for kk, vv in v.items()}
                else:
                    rec[k] = _clean(v)

    def req_end(self, req_id: str, finish_reason: str,
                t: float | None = None, **timings) -> None:
        """Terminal state; emits the whole-``request`` span.  `timings`
        (queue_wait_ms / ttft_ms / e2e_ms / decode_tokens, from the caller's
        own marks) override the tracer-derived values when not None."""
        if not req_id:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            rec = self._rec(req_id)
            rec["state"] = "finished"
            rec["finish_reason"] = str(finish_reason)
            t0 = rec["_t_submit"]
            if t0 is not None and rec["e2e_ms"] is None:
                rec["e2e_ms"] = round((t - t0) * 1000.0, 3)
            for k, v in timings.items():
                if v is not None and not k.startswith("_") and k != "chunks":
                    rec[k] = _clean(v)
        if t0 is not None:
            self.span_at("request", t0, t, cat="request", track="requests",
                         req_id=req_id, finish=str(finish_reason))

    def trace_of(self, req_id: str) -> str | None:
        """The distributed trace id a request was marked with (req_mark
        ``trace_id=...`` from the hop header), or None — the hook log
        lines use to carry trace_id next to request_id."""
        if not req_id:
            return None
        with self._lock:
            rec = self._requests.get(req_id)
            tid = None if rec is None else rec.get("trace_id")
        return tid if isinstance(tid, str) and tid else None

    # --------------------------------------------------------------- export

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON (dict, ready for json.dumps): complete
        spans as ``ph:"X"``, instants as ``ph:"i"``, with thread_name
        metadata naming each track.  Events are sorted by start time (ties:
        longer span first, so nesting renders parent-before-child), which
        also guarantees non-decreasing ``ts`` per track."""
        with self._lock:
            events = list(self._events)
            tracks = dict(self._tracks)
            # distributed-trace tagging: events keyed by a req_id
            # whose flight-recorder record carries a trace_id export with it,
            # so a cross-replica merge can group legs under one trace
            traces = {rid: rec["trace_id"] for rid, rec in
                      self._requests.items()
                      if isinstance(rec.get("trace_id"), str)
                      and rec.get("trace_id")}
        meta = [{"ph": "M", "name": "process_name", "pid": 1,
                 "args": {"name": "dllama-tpu"}}]
        for name, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": 1,
                         "tid": tid, "args": {"name": name}})
        body = []
        for name, cat, tid, req_id, t0, t1, args in events:
            ev = {"name": name, "cat": cat or "dllama", "pid": 1, "tid": tid,
                  "ts": round((t0 - self._epoch) * 1e6, 1),
                  "args": dict(args)}
            if req_id:
                ev["args"]["req_id"] = req_id
                tr_id = traces.get(req_id)
                if tr_id and "trace_id" not in ev["args"]:
                    ev["args"]["trace_id"] = tr_id
            if t1 is None:
                ev["ph"] = "i"
                ev["s"] = "t"  # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = max(round((t1 - t0) * 1e6, 1), 0.0)
            body.append(ev)
        body.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        return {"traceEvents": meta + body, "displayTimeUnit": "ms"}

    def requests_summary(self) -> list[dict]:
        """Compact flight-recorder listing (oldest first) for
        ``GET /debug/requests``."""
        with self._lock:
            recs = [(dict(r), len(r["chunks"])) for r in self._requests.values()]
        return [dict({k: r[k] for k in _SUMMARY_KEYS}, chunks=n)
                for r, n in recs]

    def request_timeline(self, req_id: str) -> dict | None:
        """Full record for ``GET /debug/requests/{req_id}`` (None when the
        id was never seen or has been evicted)."""
        with self._lock:
            rec = self._requests.get(req_id)
            if rec is None:
                return None
            rec = dict(rec)
            rec["chunks"] = list(rec["chunks"])
        return {k: v for k, v in rec.items() if not k.startswith("_")}

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": True, "capacity": self.capacity,
                    "events": len(self._events), "dropped": self._dropped,
                    "requests": len(self._requests)}

    def reset(self) -> None:
        """Drop all recorded events and request records (tests/benches)."""
        with self._lock:
            self._events.clear()
            self._requests.clear()
            self._dropped = 0


def merge_chrome(parts: list[tuple[str, dict, float]]) -> dict:
    """Merge several Chrome trace exports onto ONE timeline.

    ``parts`` is ``[(label, export, shift_us), ...]`` — each export a
    :meth:`Tracer.export_chrome` dict, each ``shift_us`` the microseconds to
    ADD to that part's timestamps to land them on the merged clock (the
    router computes it from its NTP-lite per-replica offset estimate; the
    router's own part shifts by 0). Each part becomes one Perfetto process
    (pid = its 1-based position, process_name = its label) keeping its own
    thread tracks, so the merged file shows the router track above one
    process-track per replica. Events are re-sorted globally by (ts, -dur)
    — the same non-decreasing-per-track guarantee export_chrome gives."""
    meta: list[dict] = []
    body: list[dict] = []
    for pid, (label, export, shift_us) in enumerate(parts, start=1):
        for ev in (export or {}).get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    ev["args"] = {"name": label}
                meta.append(ev)
                continue
            try:
                ev["ts"] = round(float(ev.get("ts", 0.0)) + shift_us, 1)
            except (TypeError, ValueError):
                ev["ts"] = shift_us
            body.append(ev)
    body.sort(key=lambda e: (e.get("ts", 0.0), -e.get("dur", 0.0)))
    return {"traceEvents": meta + body, "displayTimeUnit": "ms"}


#: the process-global tracer (CLI: --trace-buffer; 0 installs NULL_TRACER).
#: Call sites read this attribute per use, so configure() can swap it live.
TRACER: Tracer | NullTracer = Tracer()


def configure(capacity: int, max_requests: int = 128,
              max_chunks_per_request: int = 512):
    """Swap the process-global tracer.  capacity <= 0 installs the no-op
    singleton (the ``--trace-buffer 0`` fast path).  Returns the tracer."""
    global TRACER
    if int(capacity) <= 0:
        TRACER = NULL_TRACER
    else:
        TRACER = Tracer(int(capacity), max_requests, max_chunks_per_request)
    return TRACER


def log_extra(req_id: str, **fields) -> dict:
    """Structured-log ``extra`` dict (logging parity with the router): request_id,
    plus the mesh trace id when this request's flight record carries one (a
    router hop header put it there), plus any truthy caller fields — so
    ``--log-format json`` lines from router and replicas join on the same
    trace_id key."""
    x = {"request_id": req_id}
    tid = TRACER.trace_of(req_id)
    if tid:
        x["trace_id"] = tid
    for k, v in fields.items():
        if v:
            x[k] = v
    return x
