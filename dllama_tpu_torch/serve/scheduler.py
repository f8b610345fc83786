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

**Prefix reuse** is the per-slot prefix cache (the batched NaiveCache,
dllama-api.cpp:264-309): released slots keep their KV rows and the token
history that produced them; admission matches a new prompt against every
slot's history at the token level and prefills only the delta, copying a
longer prefix from another slot first when one holds it (on the paged layout
by sharing its pages). Admission is interleaved: a joining prompt's prefill
chunks run between decode chunks, paced by a stall budget.

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


#: decode steps per device chunk
DECODE_CHUNK = 4
#: how long an idle worker sleeps between looks at the intake queue
IDLE_WAIT_S = 0.05
#: interleaved admission: while decoders run, each visit pumps a joining
#: prompt's prefill chunks until about this much time has passed
ADMIT_STALL_BUDGET_MS = 250.0


class Scheduler:
    def __init__(self, engine: BatchEngine, max_queue: int = 0, overlap: bool = True):
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
        # decode-to-decode gaps that admission work inserted, and the host
        # gap between one chunk's tokens and the next dispatch
        self._admit_gaps_ms: list[float] = []
        self._host_gap_ms: list[float] = []
        self._t_consumed: float | None = None
        self._t_dec_end: float | None = None
        self._completed: list[Request] = []  # ring of recent requests
        self._metrics_lock = threading.Lock()
        self.chunks = 0  # decode chunks consumed
        self.chunk_slots = 0  # live slots summed over those chunks (batch occupancy)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.crashed: BaseException | None = None
        self.join_failed = False
        self._draining = threading.Event()
        self._busy_worker = False  # the worker holds a request outside every container
        self._heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._run, name="dllama-scheduler", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------- api

    def submit(self, prompt, temperature, topp, max_tokens, eos_ids, seed: int | None = None,
               presence: float = 0.0, frequency: float = 0.0, req_id: str = "",
               timeout_s: float | None = None) -> Request:
        self.check_admission()
        req = Request(list(prompt), float(temperature), float(topp), int(max_tokens),
                      frozenset(eos_ids), seed=seed, presence=float(presence),
                      frequency=float(frequency), submitted_at=time.monotonic(), req_id=req_id)
        if timeout_s is not None and timeout_s > 0:
            req.timeout_s = float(timeout_s)
            req.deadline_at = req.submitted_at + req.timeout_s
        self.pending.put(req)
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
            raise SchedulerUnhealthy(f"scheduler worker is dead ({self.crashed!r}); "
                                     "refusing work")
        if self._draining.is_set():
            raise SchedulerDraining("scheduler is draining; no new requests")
        depth = self._queue_depth()
        if self.max_queue and depth >= self.max_queue:
            raise QueueFull(f"admission queue full ({depth} >= --max-queue {self.max_queue})")

    def _queue_depth(self) -> int:
        """Requests owed service but not admitted yet: the intake queue and
        the capacity-deferred head (one definition for /health and the
        --max-queue bound)."""
        return self.pending.qsize() + (1 if self._deferred is not None else 0)

    def _busy(self) -> bool:
        """Whether the worker owes anyone progress."""
        return (bool(self.slots) or bool(self._inflight) or self._deferred is not None
                or not self.pending.empty() or self._busy_worker)

    def health(self) -> dict:
        """Liveness + readiness for the API tier's /health: `live` is false
        when the worker cannot make progress, `ready` also while draining or
        saturated."""
        qdepth = self._queue_depth()
        live = self._thread.is_alive() and self.crashed is None and not self.join_failed
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
            "last_step_age_s": round(time.monotonic() - self._heartbeat, 3),
            "draining": self._draining.is_set(),
            "crashed": repr(self.crashed) if self.crashed is not None else None,
            "join_failed": self.join_failed,
        }

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful drain: stop admission (submit raises SchedulerDraining),
        let running and queued requests finish, shut down, return the idle
        slots' cached pages and audit the page pool. True when everything
        completed inside the timeout."""
        self._draining.set()
        self._wake.set()
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
        self.shutdown()
        if self.engine.pool is not None:
            if not self._thread.is_alive():
                # nothing is served after a drain: the idle slots' cached
                # prefixes go back too, so a clean drain leaves every page free
                for s in np.flatnonzero(~self.engine.active):
                    self.engine.drop_slot_pages(int(s))
                    self.slot_tokens[int(s)] = []
            report = self.engine.pool.audit(raise_on_fail=False)
            if not report["ok"]:
                log.error("kv page-pool audit FAILED at drain: %s", "; ".join(report["problems"]))
        return clean

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

        return {
            "completed": len(done),
            "ttft_ms_mean": mean(ttfts),
            "ttft_ms_p50": ttfts[len(ttfts) // 2] if ttfts else None,
            "ttft_ms_max": ttfts[-1] if ttfts else None,
            "itl_ms_mean": mean(itls),
            "reused_prefix_tokens": self.reused_prefix_tokens,
            "admission_gaps": len(gaps),
            "admission_stall_ms_max": max(gaps) if gaps else None,
            "admission_stall_ms_mean": mean(gaps),
            "decode_host_gaps": len(hgaps),
            "decode_host_gap_ms_mean": mean(hgaps),
            "decode_chunks": self.chunks,
            "decode_slots_mean": self.chunk_slots / self.chunks if self.chunks else None,
            "kv_pages": self.engine.kv_page_stats(),
        }

    def cancel(self, req: Request, reason: str = "cancelled") -> None:
        """Release a request's slot; `reason` becomes its finish_reason if it
        is still live. A no-op for requests that already finished."""
        req.cancel_reason = reason
        req.cancelled.set()
        self._wake.set()

    #: how long shutdown() waits for the worker before declaring it wedged
    join_timeout_s: float = 10.0

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=self.join_timeout_s)
        if self._thread.is_alive():
            self.join_failed = True
            log.warning("scheduler worker failed to join within %.1fs; engine state is "
                        "unrecoverable, /health reports live=false", self.join_timeout_s)

    # ------------------------------------------------------------------ loop

    def _finish(self, req: Request, reason: str, keep_rows: int | None = None) -> None:
        if req.slot >= 0:
            self.engine.release(req.slot, keep_rows)
            if keep_rows is not None:
                # only the first keep_rows tokens have live KV rows (the last
                # emitted token was sampled but never fed back)
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
        req.out.put(_END)

    def _emit(self, req: Request, token: int, row_at_emit: int) -> bool:
        """Queue one token; returns True when the request just finished."""
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        req.out.put(int(token))
        req.produced += 1
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
        reserved by in-flight admissions are neither destinations nor donors."""
        reserved = {adm.slot for _, adm, _ in self._inflight}
        idle = [s for s in range(self.engine.n_slots)
                if not self.engine.active[s] and s not in reserved]
        if not idle:
            return None, 0, None
        donors = [s for s in range(self.engine.n_slots) if s not in reserved]
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
        if self._deferred is not None and expired(self._deferred):
            dead.append(self._deferred)
            self._deferred = None
        for req in dead:
            self._reject(req, "timeout")

    def _admit_starts(self) -> None:
        """Move pending requests into in-flight admissions while slots allow.
        Paged layout: capacity is FREE PAGES as well as free slots. A request
        the pool cannot cover first reclaims idle slots' cached pages, and if
        still short waits in `_deferred` until releases free pages."""
        self._shed_expired_queued()
        reserved = len(self._inflight)
        while self._deferred is not None or not self.pending.empty():
            if int((~self.engine.active).sum()) - reserved <= 0:
                return
            if self._deferred is not None:
                req, self._deferred = self._deferred, None
            else:
                try:
                    req = self.pending.get_nowait()
                except queue.Empty:
                    return
            if req.cancelled.is_set():
                self._reject(req, req.cancel_reason)
                continue
            if req.deadline_at is not None and time.monotonic() >= req.deadline_at:
                self._reject(req, "timeout")
                continue
            toks = req.prompt
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
            slot, reuse, donor = self._pick_slot(toks)
            cross = donor is not None and donor != slot and reuse > 0
            deficit = self.engine.admission_deficit(slot, reuse, len(toks), cross)
            if deficit > 0:
                # reclaim just enough idle cache (keeping the destination and
                # donor), then pick again: eviction may change the best donor
                if self._evict_idle_pages(deficit, {slot, donor}):
                    slot, reuse, donor = self._pick_slot(toks)
                    cross = donor is not None and donor != slot and reuse > 0
                deficit = self.engine.admission_deficit(slot, reuse, len(toks), cross)
            if deficit > 0:
                # every missing page is held by RUNNING requests: wait at the
                # head until releases free them
                self._deferred = req
                return
            try:
                if cross:
                    self.engine.copy_prefix_rows(donor, slot, reuse)
                    self.slot_tokens[slot] = list(self.slot_tokens.get(donor, [])[:reuse])
                adm = self.engine.add_begin(slot, toks[reuse:], start_pos=reuse,
                                            req_id=req.req_id)
            except Exception as e:  # a bad request (too long, ...): fail just this one
                log.exception("admission of request %s rejected", req.req_id)
                # the slot's cache state is unknown now: drop the claim and
                # the pages, losing only this slot's prefix reuse
                self.slot_tokens[slot] = []
                self.engine.drop_slot_pages(slot)
                self._reject(req, "error", e)
                continue
            req.slot = slot
            req.admitted_at = time.monotonic()
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
        slot and emit the first token."""
        self._inflight.pop(0)
        first = self.engine.add_commit(adm, req.temperature, req.topp, seed=req.seed,
                                       presence=req.presence, frequency=req.frequency)
        self.reused_prefix_tokens += reuse
        self.slot_tokens[adm.slot] = list(req.prompt)
        self.slots[adm.slot] = req
        self._emit(req, first, int(self.engine.pos[adm.slot]))

    def _pump_admissions(self) -> bool:
        """Advance in-flight admissions. While decoders run, pump prefill
        chunks until ADMIT_STALL_BUDGET_MS is spent (decode chunks run
        between calls); with no decoders to protect, the whole queue.
        Returns True if any admission work ran."""
        worked = False
        t0 = time.monotonic()
        while self._inflight:
            req, adm, reuse = self._inflight[0]
            if req.cancelled.is_set():
                self._inflight.pop(0)
                self._abort_admission(req, adm, req.cancel_reason)
                continue
            if req.deadline_at is not None and time.monotonic() >= req.deadline_at:
                self._inflight.pop(0)
                self._abort_admission(req, adm, "timeout")
                continue
            try:
                done = self.engine.add_step(adm)
                if self.slots and adm.logits is not None and adm.logits.is_cuda:
                    # decoders are waiting: let the pacing clock see the
                    # chunk's device time, not just its launch
                    torch.cuda.current_stream(adm.logits.device).synchronize()
                worked = True
                if done:
                    self._commit_admission(req, adm, reuse)
            except Exception as e:
                log.exception("prefill of request %s failed", req.req_id)
                if self._inflight and self._inflight[0][1] is adm:
                    self._inflight.pop(0)
                self._abort_admission(req, adm, e)
                continue
            if self.slots and (time.monotonic() - t0) * 1000.0 >= ADMIT_STALL_BUDGET_MS:
                return worked  # the budget is spent: let the decoders run
        return worked

    def _fail_all(self, exc: BaseException) -> None:
        """Fail every queue a client could be blocked on, without touching
        the engine (its state is unknown after a crash)."""
        reqs = [r for r, _, _ in self._inflight] + list(self.slots.values())
        if self._deferred is not None:
            reqs.append(self._deferred)
        while True:
            try:
                reqs.append(self.pending.get_nowait())
            except queue.Empty:
                break
        self._inflight.clear()
        self.slots.clear()
        self._deferred = None
        for req in reqs:
            req.finish_reason = "error"
            req.finished_at = time.monotonic()
            req.out.put(exc)
            req.out.put(_END)

    def _run(self) -> None:
        """Worker entry: a crash fails every in-flight request at once
        (finish_reason 'error', queues unblocked) and /health goes unhealthy;
        the process supervisor owns the restart."""
        try:
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            with torch.no_grad():
                self._loop()
        except BaseException as e:  # noqa: BLE001 - supervision must be total
            self.crashed = e
            log.exception("scheduler worker crashed; failing all in-flight requests")
            self._fail_all(e)

    def _needs_boundary(self, inflight_chunk=None) -> bool:
        """True when the next chunk must wait for a fully consumed pipeline:
        admission work (a prefill must not interleave with a chunk in flight,
        and commit/release need settled host mirrors), a pending cancel or
        deadline, a slot at its row limit, or an emptied batch."""
        if self._stop.is_set():
            return True
        if (not self.slots or self._deferred is not None or self._inflight
                or not self.pending.empty()):
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
            # successor would be pure discarded overrun
            return all(req.produced + int(inflight_chunk.advance[slot]) >= req.max_tokens
                       for slot, req in self.slots.items())
        return False

    def _dispatch_chunk(self, pipeline_empty: bool = True, exclude_gap_s: float = 0.0):
        """Launch the next decode chunk -> (chunk, slots snapshot). Records
        the host gap: the time since the last chunk's tokens arrived when the
        pipeline was empty (minus `exclude_gap_s` of admission work), 0 when
        a chunk was still in flight. A failure here is not a per-request
        problem (the cache was being written in place): it escalates to the
        worker's crash path."""
        if self._t_consumed is not None:
            gap_s = (max(0.0, time.monotonic() - self._t_consumed - exclude_gap_s)
                     if pipeline_empty else 0.0)
            with self._metrics_lock:
                self._host_gap_ms.append(gap_s * 1000.0)
                del self._host_gap_ms[:-256]
        return self.engine.decode_dispatch(DECODE_CHUNK), dict(self.slots)

    def _consume_chunk(self, chunk, snapshot) -> None:
        """Wait for a dispatched chunk's tokens and emit them to the requests
        captured at dispatch. A slot whose request finished while the chunk
        was in flight is skipped: its tokens are the one-chunk overrun, and
        release(keep_rows=) already rewound the slot."""
        toks = self.engine.decode_consume(chunk)
        self.chunks += 1
        self.chunk_slots += len(snapshot)
        self._t_dec_end = self._t_consumed = time.monotonic()
        bad = chunk.nonfinite()  # NaN guard: fail THOSE requests, not the engine
        for slot, req in snapshot.items():
            if self.slots.get(slot) is not req:
                continue
            if bad is not None and bad[slot]:
                log.error("non-finite logits in decode chunk %d (slot %d); failing the "
                          "request, engine stays up", chunk.seq, slot)
                self.slot_tokens[slot] = []  # poisoned rows: never reuse
                req.finish_reason = "error"
                req.out.put(RuntimeError(f"non-finite logits in decode chunk {chunk.seq}; "
                                         "request failed (engine healthy)"))
                self._finish(req, "error")
                continue
            for i in range(int(chunk.advance[slot])):
                # the row written when sampling token i: start + i (+1 = prefix length)
                if self._emit(req, toks[i, slot], int(chunk.start_pos[slot]) + i + 1):
                    break

    def _loop(self) -> None:
        pending = None  # overlap mode: the dispatched, unconsumed chunk
        while not self._stop.is_set():
            self._heartbeat = time.monotonic()
            if pending is not None:
                # keep the card busy: launch the successor off the device
                # state BEFORE consuming, unless boundary work needs the
                # settled state first
                nxt = (None if self._needs_boundary(pending[0])
                       else self._dispatch_chunk(pipeline_empty=False))
                self._consume_chunk(*pending)
                pending = nxt
                continue
            t_boundary = time.monotonic()
            self._busy_worker = True
            self._admit_starts()
            admitted = self._pump_admissions()
            self._busy_worker = False
            for slot, req in list(self.slots.items()):
                if req.cancelled.is_set():
                    self._finish(req, req.cancel_reason, keep_rows=int(self.engine.pos[slot]))
                elif req.deadline_at is not None and time.monotonic() >= req.deadline_at:
                    self._finish(req, "timeout", keep_rows=int(self.engine.pos[slot]))
                elif int(self.engine.pos[slot]) >= self.engine.seq_len:
                    self._finish(req, "length")
            if self.slots:
                # pool exhaustion mid-decode: a starved slot waits frozen while
                # its batch-mates run; when EVERY live slot is starved nothing
                # will free a page, so finish the most advanced one
                starved = self.engine.page_starved()
                if starved.any() and all(starved[s] for s in self.slots):
                    if not self._evict_idle_pages(len(self.slots), set()):
                        victim = max((s for s in self.slots if starved[s]),
                                     key=lambda s: int(self.engine.pos[s]))
                        log.warning("kv page pool exhausted with every active slot starved; "
                                    "finishing slot %d (finish_reason=length)", victim)
                        self._finish(self.slots[victim], "length")
            if not self.slots:
                self._t_dec_end = None
                if not self._inflight:
                    self._wake.wait(timeout=IDLE_WAIT_S)
                    self._wake.clear()
                continue
            if admitted and self._t_dec_end is not None:
                gap_ms = (time.monotonic() - self._t_dec_end) * 1000.0
                with self._metrics_lock:
                    self._admit_gaps_ms.append(gap_ms)
                    del self._admit_gaps_ms[:-256]
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
        while True:
            try:
                cut.append(self.pending.get_nowait())
            except queue.Empty:
                break
        for req in cut:
            req.finish_reason = "shutdown"
            req.out.put(SchedulerDraining("server shut down before this request completed"))
            self._finish(req, "shutdown")
