"""SLO and saturation observability: the port's copy of the JAX package's
``obs/perf.py`` (sliding-window latency quantiles, the scheduler time
ledger, decode-step HBM pricing, the SLO policy, the ``--prefill-budget
auto`` controller and the per-scheduler aggregator), with the card's own
bandwidth peak.

* :class:`WindowQuantiles` / :class:`WindowSums`: time-sliced sliding
  windows (bounded reservoirs; exact under the per-slice cap), queried at
  scrape time, never on the hot path.
* :class:`ClockOffset`: the router's NTP-lite estimate of a replica's
  clock offset from its health polls (the merged mesh trace's alignment).
* :class:`TimeLedger`: every second of the scheduler worker loop billed to
  exactly one state of :data:`LEDGER_STATES`; ``transition(s)`` bills the
  time since the previous transition to the previous state, so the
  per-state totals partition the loop's wall time.
* :func:`decode_step_bytes` / :class:`ChunkCostModel`: the per-step HBM
  byte pricing (the same arithmetic as the JAX package's). The scheduler
  prices each consumed decode chunk and divides by its measured window to
  publish bandwidth attainment against :func:`peak_hbm_gbs`, a per-card
  table (the JAX package divides by a TPU constant).
* :class:`SloPolicy`, :class:`PrefillBudgetController`,
  :class:`PerfAggregator`: verdicts, the budget steering and the join that
  ``GET /debug/perf`` and the windowed gauges read.

Host-side only; ``torch`` is imported only by :func:`peak_hbm_gbs`.
"""

from __future__ import annotations

import math
import random
import time
from collections import deque
from dataclasses import dataclass

from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.utils import locks

#: peak HBM bandwidth (GB/s) by ``torch.cuda.get_device_name()``: what the
#: live bandwidth-attainment gauge divides achieved bytes/s by. The H100 SXM5
#: 80 GB figure is NVIDIA's H100 datasheet (3.35 TB/s HBM3), the number the
#: port's kernel bounds are priced with. A card not in the table (or the CPU)
#: has no peak: attainment then reads None / NaN, never a guessed number.
PEAK_HBM_GBS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_hbm_gbs(device=None) -> float | None:
    """The peak HBM GB/s of ``device`` (a torch.device, index or None for
    the current card) from :data:`PEAK_HBM_GBS`; None on the CPU or a card
    the table does not name."""
    import torch

    if isinstance(device, int):
        device = torch.device("cuda", device)
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return PEAK_HBM_GBS.get(torch.cuda.get_device_name(device))


#: the exclusive states of the scheduler worker loop — the label set of
#: dllama_scheduler_time_seconds_total{state}, the JAX package's set.
#: `hybrid` is the dispatch of a hybrid chunked-prefill+decode step: host
#: work that launches BOTH a prefill slice and a decode chunk — neither pure `prefill` nor pure `decode_dispatch`, so it gets
#: its own bucket instead of polluting either attribution.
LEDGER_STATES = ("idle", "admission", "prefill", "hybrid", "decode_dispatch",
                 "decode_wait", "emit", "commit", "restart_backoff")


# ------------------------------------------------------------------ windows


class WindowQuantiles:
    """Sliding-window streaming quantile estimator (see module docstring).

    ``window_s`` of history in ``slices`` ring buckets; each bucket keeps at
    most ``cap`` samples (uniform reservoir past that, unbiased). Quantiles
    use the linear-interpolation definition (``numpy.percentile`` default),
    so under the cap they match an exact sorted-list computation bit for
    bit — the contract tests/test_perf.py checks across adversarial
    streams. ``now_fn`` is injectable for deterministic window-expiry
    tests."""

    def __init__(self, window_s: float = 60.0, slices: int = 6,
                 cap: int = 512, now_fn=time.monotonic):
        if window_s <= 0 or slices <= 0 or cap <= 0:
            raise ValueError("window_s, slices and cap must be positive")
        self.window_s = float(window_s)
        self.slices = int(slices)
        self.cap = int(cap)
        self._slice_s = self.window_s / self.slices
        self._now = now_fn
        self._lock = locks.make_lock("obs.perf")
        # ring of (bucket_index, samples, seen); bucket = floor(now/slice_s)
        self._ring: list[tuple[int, list[float], int]] = []

    def _bucket(self) -> int:
        return int(self._now() / self._slice_s)

    def _live(self, bucket: int):
        """Slices still inside the window (caller holds the lock)."""
        oldest = bucket - self.slices + 1
        return [entry for entry in self._ring if entry[0] >= oldest]

    def observe(self, v: float) -> None:
        v = float(v)
        if v != v:  # NaN never enters the window
            return
        b = self._bucket()
        with self._lock:
            if not self._ring or self._ring[-1][0] != b:
                self._ring = self._live(b)
                self._ring.append((b, [], 0))
            bucket, samples, seen = self._ring[-1]
            if seen < self.cap:
                samples.append(v)
            else:
                # uniform reservoir: every sample of the slice keeps an
                # equal cap/seen chance of being retained
                j = random.randrange(seen + 1)
                if j < self.cap:
                    samples[j] = v
            self._ring[-1] = (bucket, samples, seen + 1)

    def count(self) -> int:
        """Observations currently inside the window (pre-reservoir count)."""
        with self._lock:
            return sum(seen for _, _, seen in self._live(self._bucket()))

    def _merged(self) -> list[float]:
        with self._lock:
            live = self._live(self._bucket())
            return sorted(x for _, samples, _ in live for x in samples)

    def quantile(self, q: float) -> float | None:
        """Windowed quantile, ``q`` in [0, 1]; None on an empty window."""
        xs = self._merged()
        if not xs:
            return None
        if len(xs) == 1:
            return xs[0]
        rank = min(max(q, 0.0), 1.0) * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def snapshot(self) -> dict:
        """{'count', 'p50', 'p95', 'p99'} over one merged window read (a
        p-by-p loop over quantile() would re-sort the window each time)."""
        xs = self._merged()
        out: dict = {"count": self.count()}
        for name, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            if not xs:
                out[name] = None
                continue
            rank = q * (len(xs) - 1)
            lo = int(math.floor(rank))
            hi = min(lo + 1, len(xs) - 1)
            frac = rank - lo
            out[name] = xs[lo] * (1.0 - frac) + xs[hi] * frac
        return out


class WindowSums:
    """Time-sliced sliding-window sums (the rate companion of
    :class:`WindowQuantiles`): ``add(tokens=3, bytes=1e6)`` accumulates into
    the current slice, ``totals()`` merges live slices, ``span_s()`` is the
    window the totals cover (for rate = total / span)."""

    def __init__(self, window_s: float = 60.0, slices: int = 6,
                 now_fn=time.monotonic):
        self.window_s = float(window_s)
        self.slices = int(slices)
        self._slice_s = self.window_s / self.slices
        self._now = now_fn
        self._lock = locks.make_lock("obs.perf")
        self._ring: list[tuple[int, dict]] = []
        self._t0 = now_fn()  # windows younger than window_s rate over age

    def add(self, **fields: float) -> None:
        b = int(self._now() / self._slice_s)
        with self._lock:
            oldest = b - self.slices + 1
            self._ring = [e for e in self._ring if e[0] >= oldest]
            if not self._ring or self._ring[-1][0] != b:
                self._ring.append((b, {}))
            acc = self._ring[-1][1]
            for k, v in fields.items():
                acc[k] = acc.get(k, 0.0) + float(v)

    def totals(self) -> dict:
        b = int(self._now() / self._slice_s)
        with self._lock:
            oldest = b - self.slices + 1
            out: dict = {}
            for bucket, acc in self._ring:
                if bucket < oldest:
                    continue
                for k, v in acc.items():
                    out[k] = out.get(k, 0.0) + v
            return out

    def span_s(self) -> float:
        """Seconds the current totals cover: the full window once the
        process has lived that long, the process age before (rates must not
        read 6x too low during the first minute)."""
        return max(min(self.window_s, self._now() - self._t0), 1e-9)


# ------------------------------------------------------- clock alignment


class ClockOffset:
    """NTP-lite remote-clock offset estimator over request/response
    round-trips — the router runs one per replica, fed by its
    health poller, to place each replica's monotonic clock on the router's
    timeline for the merged mesh trace.

    One :meth:`sample` per poll: ``t_send``/``t_recv`` are the local
    monotonic marks around the round-trip, ``t_remote`` the remote clock
    read the response carried. The classic single-exchange estimate assumes
    the remote read happened at the round-trip midpoint, so

        offset = t_remote - (t_send + t_recv) / 2

    with the true offset inside ``offset ± rtt/2`` (the read can be
    anywhere between send and receive). :meth:`estimate` returns the
    MIN-RTT sample of the sliding window — the exchange least polluted by
    queueing delay, whose error bound ``rtt/2`` is also the smallest.
    Single-writer (the replica's poller thread) / multi-reader; the deque
    append and snapshot are GIL-atomic, so no lock is needed."""

    __slots__ = ("_samples",)

    def __init__(self, window: int = 16):
        self._samples: deque = deque(maxlen=int(window))

    def sample(self, t_send: float, t_recv: float, t_remote: float) -> None:
        rtt = max(float(t_recv) - float(t_send), 0.0)
        offset = float(t_remote) - (float(t_send) + float(t_recv)) / 2.0
        self._samples.append((rtt, offset))

    def estimate(self) -> dict | None:
        """-> {offset_s, uncertainty_s, rtt_s, samples} from the min-RTT
        sample of the window, or None before the first sample."""
        samples = list(self._samples)
        if not samples:
            return None
        rtt, offset = min(samples)
        return {"offset_s": offset, "uncertainty_s": rtt / 2.0,
                "rtt_s": rtt, "samples": len(samples)}


# ------------------------------------------------------------- time ledger


class TimeLedger:
    """Exclusive-state time attribution for one worker loop.

    ``transition(state)`` bills the elapsed time since the last transition
    to the PREVIOUS state and makes ``state`` current — every instant
    between ``start()`` and ``close()`` lands in exactly one state, so the
    per-state totals sum to the loop's wall time by construction. Each
    billed span also increments the
    ``dllama_scheduler_time_seconds_total{state}`` counter (when a counter
    family is supplied), making the invariant scrape-visible.

    Thread-safety: the worker owns the state machine, but ``snapshot()``
    (and the scrape-path ``poke()``, which bills the open span without
    changing state) may run from API threads — all entry points take the
    lock, and billing stays correct because every moment is attributed to
    whatever state was current when it passed."""

    def __init__(self, counter=None, now_fn=time.monotonic,
                 states=LEDGER_STATES):
        self.states = tuple(states)
        self._counter = counter
        self._now = now_fn
        # _bill() increments the scheduler-time counter while holding this
        # (obs.perf ranks below the obs.metrics leaf, so that nesting is
        # rank-legal by construction)
        self._lock = locks.make_lock("obs.perf")
        self.totals = {s: 0.0 for s in self.states}
        self._state: str | None = None
        self._t: float | None = None
        self._t_start: float | None = None
        self._t_close: float | None = None

    def start(self, state: str = "idle") -> None:
        """Anchor the ledger at loop entry (re-entrant: a warm restart
        re-enters the loop without resetting the accumulated record)."""
        with self._lock:
            now = self._now()
            if self._t_start is None:
                self._t_start = now
            self._t_close = None
            self._bill(now)
            self._set(state, now)

    def _bill(self, now: float) -> None:
        if self._state is not None and self._t is not None:
            dt = max(now - self._t, 0.0)
            self.totals[self._state] += dt
            if self._counter is not None:
                self._counter.labels(state=self._state).inc(dt)
            self._t = now

    def _set(self, state: str | None, now: float) -> None:
        if state is not None and state not in self.totals:
            raise ValueError(f"unknown ledger state {state!r} "
                             f"(catalog: {self.states})")
        self._state = state
        self._t = now if state is not None else None

    def transition(self, state: str) -> None:
        with self._lock:
            now = self._now()
            self._bill(now)
            self._set(state, now)

    def state(self) -> str | None:
        """The current exclusive state (None before start()/after close())
        — cross-thread readers (the scheduler's drain/watchdog idleness
        check) join this with container occupancy, closing the false-idle
        window while the worker holds a request BETWEEN containers (popped
        from in-flight, slot not yet assigned)."""
        with self._lock:
            return self._state

    def poke(self) -> None:
        """Bill the open span without changing state (scrape freshness: a
        long idle park should not read as zero until the next transition)."""
        with self._lock:
            self._bill(self._now())

    def close(self) -> None:
        """Bill the tail and stop the clock (loop exit / worker death)."""
        with self._lock:
            now = self._now()
            self._bill(now)
            self._set(None, now)
            if self._t_close is None:
                self._t_close = now

    def wall_s(self) -> float:
        """start() -> now (or close()): the quantity the state totals must
        sum to."""
        with self._lock:
            if self._t_start is None:
                return 0.0
            end = self._t_close if self._t_close is not None else self._now()
            return end - self._t_start

    def snapshot(self) -> dict:
        """Per-state seconds (open span included), fractions of wall time,
        and the current state — the `/debug/perf` ledger view."""
        with self._lock:
            now = self._now()
            totals = dict(self.totals)
            if self._state is not None and self._t is not None:
                totals[self._state] += max(now - self._t, 0.0)
            if self._t_start is None:
                wall = 0.0
            else:
                end = self._t_close if self._t_close is not None else now
                wall = end - self._t_start
        covered = sum(totals.values())
        return {
            "state": self._state,
            "wall_s": round(wall, 6),
            "covered_s": round(covered, 6),
            "seconds": {s: round(v, 6) for s, v in totals.items()},
            "fractions": {s: round(v / wall, 6) if wall > 0 else 0.0
                          for s, v in totals.items()},
        }


# ---------------------------------------------------------- chunk pricing


def decode_step_bytes(*, n_layers: int, dim: int, hidden_dim: int,
                      kv_dim: int, head_size: int, n_kv_heads: int,
                      vocab_size: int, seq_len: int, weight_bytes: int,
                      slots: int, live_rows: float,
                      cache_bytes_per_el: int = 2, paged: bool = False,
                      page_size: int = 128,
                      paged_impl: str = "kernel") -> int:
    """Per-STEP HBM bytes of a ``slots``-wide batched decode: the JAX
    package's cost model, arithmetic for arithmetic. The weight stream is read once per step and serves
    every slot; the KV stream scales with slots; activations scale with
    slots but stay negligible. ``live_rows`` is the per-slot live KV
    horizon in rows (the scheduler passes the chunk's mean position).

    paged=True prices by the routed attention path (``paged_impl``, set
    from ``KernelSelection.attn_route``):

    * ``kernel`` — the paged decode kernel (the port's K9,
      ``paged_attention.cu``): PER-PAGE KV reads (live rows round up to
      whole pages) plus the i32 block tables, read ONCE per fused launch
      per layer (the new rows' scatter rides the same launch, so there is
      no second table read and no separate scatter launch).
    * ``gather`` — the plain fallback: on top of the per-page pool reads,
      it MATERIALIZES the full ``max_blocks*page = seq_len``-row
      contiguous view for k and v (one write + one read of the whole view,
      per layer, every step) and reads the tables once per gather (k + v).
      This is the traffic blowup the kernel exists to remove — the two
      routes' bytes differ by design, not by drift."""
    L, d, h = n_layers, dim, hidden_dim
    m = max(8, slots)  # one fused step: all slots are rows of one matmul

    def mm_act(k, n):
        return m * k * 2 + m * n * 4

    acts = (mm_act(d, d) * 2 + mm_act(d, kv_dim) * 2
            + mm_act(d, h) * 2 + mm_act(h, d)) * L + mm_act(d, vocab_size)
    rows = float(live_rows)
    view_rows = 0.0
    if paged:
        # page-granular pruning horizon: live rows round up to whole pages
        rows = -(-int(rows) // page_size) * page_size
        if paged_impl == "gather":
            # full contiguous view, written then read, k and v, per layer
            view_rows = 2.0 * seq_len
    kv_stream = int(2 * slots * n_kv_heads * (rows + view_rows) * head_size
                    * cache_bytes_per_el) * L
    kv_write = 2 * slots * kv_dim * cache_bytes_per_el * L
    if not paged:
        table_read = 0
    elif paged_impl == "gather":
        table_read = 4 * slots * (seq_len // page_size) * 2 * L  # k + v gathers
    else:
        table_read = 4 * slots * (seq_len // page_size) * L  # one fused launch
    return int(weight_bytes + acts + kv_stream + kv_write + table_read
               + slots * d * 2)


@dataclass(frozen=True)
class ChunkCostModel:
    """Frozen per-engine pricing inputs for :func:`decode_step_bytes`
    (built once at scheduler construction by
    ``BatchEngine.chunk_cost_model()``; ``weight_bytes`` is the engine's
    real resident parameter bytes, so a model is priced as what it
    streams)."""

    n_layers: int
    dim: int
    hidden_dim: int
    kv_dim: int
    head_size: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    weight_bytes: int
    cache_bytes_per_el: int = 2
    paged: bool = False
    page_size: int = 128
    paged_impl: str = "kernel"  # 'kernel' | 'gather' (KernelSelection route)

    def step_bytes(self, slots: int, live_rows: float) -> int:
        return decode_step_bytes(
            n_layers=self.n_layers, dim=self.dim, hidden_dim=self.hidden_dim,
            kv_dim=self.kv_dim, head_size=self.head_size,
            n_kv_heads=self.n_kv_heads, vocab_size=self.vocab_size,
            seq_len=self.seq_len, weight_bytes=self.weight_bytes,
            slots=slots, live_rows=live_rows,
            cache_bytes_per_el=self.cache_bytes_per_el,
            paged=self.paged, page_size=self.page_size,
            paged_impl=self.paged_impl)


# -------------------------------------------------------------- SLO policy


@dataclass(frozen=True)
class SloPolicy:
    """Per-request latency targets (``--slo-ttft-ms`` / ``--slo-itl-ms``);
    None disables that kind. Verdicts are tri-state per kind: True (met),
    False (violated), None (no target, or the mark never happened — an
    errored request with no first token is unknowable, not a TTFT burn)."""

    ttft_ms: float | None = None
    itl_ms: float | None = None

    def enabled(self) -> bool:
        return self.ttft_ms is not None or self.itl_ms is not None

    @staticmethod
    def _judge(measured, target):
        if target is None or measured is None:
            return None, None
        over = float(measured) - float(target)
        return over <= 0.0, (round(over, 3) if over > 0 else None)

    def verdict(self, ttft_ms: float | None, itl_ms: float | None) -> dict:
        """{'ttft_ok', 'itl_ok', 'violated_by_ms': {...}, 'ok'} — `ok` is
        False iff some kind is measurably violated."""
        ttft_ok, ttft_over = self._judge(ttft_ms, self.ttft_ms)
        itl_ok, itl_over = self._judge(itl_ms, self.itl_ms)
        return {
            "ttft_ok": ttft_ok,
            "itl_ok": itl_ok,
            "violated_by_ms": {"ttft": ttft_over, "itl": itl_over},
            "ok": ttft_ok is not False and itl_ok is not False,
        }

    def verdict_from_marks(self, ttft_ms, e2e_ms, decode_tokens) -> dict:
        """Verdict from a flight-recorder record's marks (the `/debug/
        requests/{req_id}` postmortem): ITL is derived the same way
        Request.itl_ms derives it — (e2e - ttft) / (tokens - 1)."""
        itl = None
        if (ttft_ms is not None and e2e_ms is not None
                and decode_tokens is not None and decode_tokens >= 2):
            itl = (float(e2e_ms) - float(ttft_ms)) / (decode_tokens - 1)
        out = self.verdict(ttft_ms, itl)
        out["targets"] = {"ttft_ms": self.ttft_ms, "itl_ms": self.itl_ms}
        if itl is not None:
            out["itl_ms"] = round(itl, 3)
        return out


class PrefillBudgetController:
    """SLO-driven per-chunk prefill token budget: the online
    controller behind ``--prefill-budget auto``. Each hybrid step fuses up
    to ``current`` prompt tokens of an admitting request into the decode
    chunk's device launch; this controller shrinks/grows that budget from
    the windowed ITL headroom against ``SloPolicy.itl_ms``:

    * p95 ITL over the target (headroom < 0) → HALVE the budget (down to
      ``lo``): running streams are already missing their SLO, so admissions
      must slow down, not the decoders.
    * p95 ITL under ``grow_frac`` of the target (ample headroom) → DOUBLE
      the budget (up to ``hi``): decoders are comfortably inside SLO, so
      spend the slack on joiner TTFT.
    * in between → hold.

    With no ITL target (or an empty window) the controller holds ``start``
    — auto then behaves as a fixed budget, which is what a server with no
    SLO configured should do. Budgets move in powers of two so the fused
    hybrid step's prefill-slice shapes stay in the same small compile set
    as chunked admission always had (engine.pow2_chunk). Updates are
    rate-limited to ``interval_s`` so the quantile merge never rides the
    per-chunk hot path. The current budget is published as the
    ``dllama_prefill_budget_tokens`` gauge."""

    def __init__(self, slo: SloPolicy | None, *, lo: int = 16,
                 hi: int = 256, start: int = 64, grow_frac: float = 0.6,
                 interval_s: float = 0.25, now_fn=time.monotonic):
        self.slo = slo or SloPolicy()
        self.lo = max(1, int(lo))
        self.hi = max(self.lo, int(hi))
        self.current = min(max(int(start), self.lo), self.hi)
        self.grow_frac = float(grow_frac)
        self.interval_s = float(interval_s)
        self._now = now_fn
        self._t_last = None
        ins.PREFILL_BUDGET.set(self.current)

    def update(self, itl_window: "WindowQuantiles") -> int:
        """Re-evaluate against the window's p95 ITL (seconds); returns the
        (possibly unchanged) budget. Cheap no-op inside the rate limit."""
        now = self._now()
        if self._t_last is not None and now - self._t_last < self.interval_s:
            return self.current
        self._t_last = now
        target = self.slo.itl_ms
        if target is None:
            return self.current
        p95 = itl_window.quantile(0.95)
        if p95 is None:
            return self.current
        p95_ms = p95 * 1000.0
        if p95_ms > target:
            nxt = max(self.lo, self.current // 2)
        elif p95_ms < target * self.grow_frac:
            nxt = min(self.hi, self.current * 2)
        else:
            nxt = self.current
        if nxt != self.current:
            self.current = nxt
            ins.PREFILL_BUDGET.set(nxt)
        return self.current


# ------------------------------------------------------------- aggregator


class PerfAggregator:
    """The per-scheduler join of the three views: latency windows + SLO
    accounting (request finishes), and roofline pricing (decode chunks).
    Gauges live in the process registry (last scheduler wins, like every
    other serving gauge); ``refresh_gauges()`` runs at scrape time so the
    windowed values are current without putting quantile merges on the
    serving hot path."""

    def __init__(self, slo: SloPolicy | None = None,
                 cost_model: ChunkCostModel | None = None,
                 window_s: float = 60.0, slices: int = 6,
                 peak_gbs: float | None = None, now_fn=time.monotonic):
        self.slo = slo or SloPolicy()
        self.cost_model = cost_model
        # the card's peak (peak_hbm_gbs); None: attainment is not priced
        self.peak_gbs = None if peak_gbs is None else float(peak_gbs)
        mk = lambda: WindowQuantiles(window_s, slices, now_fn=now_fn)
        self.ttft = mk()   # seconds
        self.itl = mk()    # seconds
        self.e2e = mk()    # seconds
        # request-flow window: finished counts + token sums (goodput and
        # throughput share this basis — both rate over FINISHED requests,
        # so goodput/throughput is a like-for-like fraction)
        self.flow = WindowSums(window_s, slices, now_fn=now_fn)
        # decode-chunk window: priced bytes vs measured device seconds
        self.chunks = WindowSums(window_s, slices, now_fn=now_fn)

    # ------------------------------------------------------------ feeding

    def observe_finish(self, *, finish_reason: str, ttft_ms, itl_ms, e2e_ms,
                       tokens: int) -> None:
        """One terminal request: feed the latency windows, judge the SLOs
        (burn counters per violated kind), and account goodput — tokens
        count toward goodput only when the request finished successfully
        (stop/length) AND met every configured SLO."""
        if ttft_ms is not None:
            self.ttft.observe(ttft_ms / 1000.0)
        if itl_ms is not None:
            self.itl.observe(itl_ms / 1000.0)
        if e2e_ms is not None:
            self.e2e.observe(e2e_ms / 1000.0)
        v = self.slo.verdict(ttft_ms, itl_ms)
        if v["ttft_ok"] is False:
            ins.SLO_VIOLATIONS.labels(kind="ttft").inc()
        if v["itl_ok"] is False:
            ins.SLO_VIOLATIONS.labels(kind="itl").inc()
        good = finish_reason in ("stop", "length") and v["ok"]
        self.flow.add(finished=1, ok=1 if v["ok"] else 0,
                      tokens=tokens, good_tokens=tokens if good else 0)

    def observe_chunk(self, *, occupancy: int, live_rows: float, steps: int,
                      tokens: int, device_s: float) -> None:
        """One consumed decode chunk: price its HBM traffic with the cost
        model (``steps`` fused steps at this occupancy and live-KV horizon)
        against its measured exclusive device window. Chunks with no
        measurable window (clock noise) still count their tokens."""
        fields = {"chunks": 1, "chunk_tokens": tokens,
                  "device_s": max(device_s, 0.0)}
        if self.cost_model is not None and occupancy > 0:
            fields["bytes"] = (self.cost_model.step_bytes(occupancy, live_rows)
                               * max(steps, 0))
        self.chunks.add(**fields)

    # ------------------------------------------------------------- reading

    def window_snapshot(self) -> dict:
        """p50/p95/p99 (ms) + counts for ttft/itl/e2e over the window."""
        out = {}
        for name, w in (("ttft", self.ttft), ("itl", self.itl),
                        ("e2e", self.e2e)):
            s = w.snapshot()
            out[name] = {
                "count": s["count"],
                **{p: (None if s[p] is None else round(s[p] * 1000.0, 3))
                   for p in ("p50", "p95", "p99")},
            }
        return out

    def slo_snapshot(self) -> dict:
        f = self.flow.totals()
        finished = f.get("finished", 0.0)
        att = (f.get("ok", 0.0) / finished) if finished else None
        return {
            "targets": {"ttft_ms": self.slo.ttft_ms,
                        "itl_ms": self.slo.itl_ms},
            "enabled": self.slo.enabled(),
            "window_finished": int(finished),
            "attainment": None if att is None else round(att, 4),
            "violations_total": {
                "ttft": ins.SLO_VIOLATIONS.labels(kind="ttft").value(),
                "itl": ins.SLO_VIOLATIONS.labels(kind="itl").value(),
            },
        }

    def roofline_snapshot(self) -> dict:
        c = self.chunks.totals()
        f = self.flow.totals()
        span = self.flow.span_s()
        device_s = c.get("device_s", 0.0)
        by = c.get("bytes", 0.0)
        # unpriced (no cost model) or unmeasured windows answer None, not a
        # false "0.0 attainment"
        achieved = (by / device_s) if (device_s > 0 and by > 0) else None
        att = (achieved / (self.peak_gbs * 1e9)
               if achieved is not None and self.peak_gbs else None)
        thr = f.get("tokens", 0.0) / span
        good = f.get("good_tokens", 0.0) / span
        return {
            "priced": self.cost_model is not None,
            "window_chunks": int(c.get("chunks", 0.0)),
            "chunk_tokens": int(c.get("chunk_tokens", 0.0)),
            "device_s": round(device_s, 6),
            "bytes": int(by),
            "achieved_gbs": (None if achieved is None
                             else round(achieved / 1e9, 3)),
            "peak_gbs": self.peak_gbs,
            "bandwidth_attainment": (None if att is None
                                     else round(att, 6)),
            "throughput_tok_s": round(thr, 3),
            "goodput_tok_s": round(good, 3),
        }

    def refresh_gauges(self) -> None:
        """Push the windowed views into the registry gauges — called at
        scrape time (`/metrics`, `/debug/perf`) rather than per request.
        A drained window sets NaN (the Prometheus "no data" value, rendered
        as the grammar's NaN token) — never the last stale value: an idle
        server must not scrape as still carrying its old p95."""
        nan = float("nan")
        for name, w in (("ttft", self.ttft), ("itl", self.itl),
                        ("e2e", self.e2e)):
            s = w.snapshot()
            for p in ("p50", "p95", "p99"):
                ins.LATENCY_WINDOW.labels(metric=name, quantile=p).set(
                    nan if s[p] is None else s[p])
        slo = self.slo_snapshot()
        att = slo["attainment"]
        ins.SLO_ATTAINMENT.set(nan if att is None else att)
        roof = self.roofline_snapshot()
        bw = roof["bandwidth_attainment"]
        ins.BW_ATTAINMENT.set(nan if bw is None else bw)
        ins.THROUGHPUT.set(roof["throughput_tok_s"])
        ins.GOODPUT.set(roof["goodput_tok_s"])

    def snapshot(self, ledger: TimeLedger | None = None) -> dict:
        """The `/debug/perf` join: windowed quantiles, SLO accounting,
        ledger attribution, roofline/goodput — one JSON document."""
        out = {
            "window": self.window_snapshot(),
            "slo": self.slo_snapshot(),
            "roofline": self.roofline_snapshot(),
        }
        if ledger is not None:
            out["ledger"] = ledger.snapshot()
        return out
