"""What the hybrid prefill budget steers by: the port's own copy of the
JAX package's sliding-window quantiles, SLO targets and the
``--prefill-budget auto`` controller (``dllama_tpu/obs/perf.py``
``WindowQuantiles``, ``SloPolicy``, ``PrefillBudgetController``), without
its gauges. The scheduler feeds an ITL window at each request's finish,
as the JAX package's ``PerfAggregator.observe_finish`` does, and the
controller reads its p95. Host-side only: nothing here touches torch.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass


class WindowQuantiles:
    """Sliding-window quantile estimator: ``window_s`` of history in
    ``slices`` ring buckets, each keeping at most ``cap`` samples (a uniform
    reservoir past that). Quantiles interpolate linearly between ranks
    (``numpy.percentile``'s default), so under the cap they are exact.
    ``now_fn`` is injectable for tests of the window's expiry."""

    def __init__(self, window_s: float = 60.0, slices: int = 6, cap: int = 512,
                 now_fn=time.monotonic):
        if window_s <= 0 or slices <= 0 or cap <= 0:
            raise ValueError("window_s, slices and cap must be positive")
        self.window_s = float(window_s)
        self.slices = int(slices)
        self.cap = int(cap)
        self._slice_s = self.window_s / self.slices
        self._now = now_fn
        self._lock = threading.Lock()
        # ring of (bucket index, samples, seen); bucket = floor(now / slice_s)
        self._ring: list[tuple[int, list[float], int]] = []

    def _bucket(self) -> int:
        return int(self._now() / self._slice_s)

    def _live(self, bucket: int):
        """Slices still inside the window (the caller holds the lock)."""
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
                j = random.randrange(seen + 1)
                if j < self.cap:
                    samples[j] = v
            self._ring[-1] = (bucket, samples, seen + 1)

    def quantile(self, q: float) -> float | None:
        """The windowed quantile, ``q`` in [0, 1]; None on an empty window."""
        with self._lock:
            xs = sorted(x for _, samples, _ in self._live(self._bucket()) for x in samples)
        if not xs:
            return None
        rank = min(max(q, 0.0), 1.0) * (len(xs) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclass(frozen=True)
class SloPolicy:
    """The per-request inter-token latency target in ms (``--slo-itl-ms``);
    None: no target. (The JAX package's TTFT target and its verdicts come
    with the rest of ``obs/``.)"""

    itl_ms: float | None = None


class PrefillBudgetController:
    """The per-chunk prefill token budget behind ``--prefill-budget auto``:
    each hybrid chunk carries up to ``current`` prompt tokens of the
    admitting request, and the windowed p95 ITL against ``slo.itl_ms``
    moves it: over the target, halve it (down to ``lo``); under
    ``grow_frac`` of it, double it (up to ``hi``); between, hold. With no
    ITL target, or an empty window, it holds ``start``. Budgets stay powers
    of two, so a hybrid slice is always one of the captured prefill widths,
    and updates are rate-limited to one a ``interval_s``."""

    def __init__(self, slo: SloPolicy | None, *, lo: int = 16, hi: int = 256,
                 start: int = 64, grow_frac: float = 0.6, interval_s: float = 0.25,
                 now_fn=time.monotonic):
        self.slo = slo or SloPolicy()
        self.lo = max(1, int(lo))
        self.hi = max(self.lo, int(hi))
        self.current = min(max(int(start), self.lo), self.hi)
        self.grow_frac = float(grow_frac)
        self.interval_s = float(interval_s)
        self._now = now_fn
        self._t_last = None

    def update(self, itl_window: WindowQuantiles) -> int:
        """Re-evaluate against the window's p95 ITL (seconds); returns the
        budget, unchanged inside the rate limit."""
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
            self.current = max(self.lo, self.current // 2)
        elif p95_ms < target * self.grow_frac:
            self.current = min(self.hi, self.current * 2)
        return self.current
