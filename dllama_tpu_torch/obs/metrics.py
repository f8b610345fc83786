"""Dependency-free metrics core: a thread-safe registry of counters, gauges
and fixed-bucket histograms (all with optional labels), rendered in the
Prometheus text exposition format (version 0.0.4) for `GET /metrics`.

Why hand-rolled: the container bakes no prometheus_client, and the serving
hot paths need exactly three instrument kinds — a few hundred lines of
stdlib beat an optional dependency every deploy target would have to
vendor. The exposition *grammar* is the real contract (scrapers parse it);
tests/test_metrics.py checks it line by line, including label escaping and
the `_bucket`/`_sum`/`_count` histogram invariants.

Usage::

    from dllama_tpu_torch.obs import metrics
    REQS = metrics.counter("dllama_requests_admitted_total", "Requests admitted")
    SHED = metrics.counter("dllama_requests_shed_total", "Requests shed", ("reason",))
    SHED.labels(reason="queue_full").inc()
    text = metrics.REGISTRY.render()        # what GET /metrics serves

Instruments registered through the module-level helpers live in the global
``REGISTRY``; registration is idempotent (the same name returns the same
family — schedulers/engines are constructed many times per process in
tests). Tests needing isolation build private :class:`Registry` instances.
All mutating paths take the family lock, so request threads, the scheduler
worker, and the scrape handler can hit the same series concurrently.
"""

from __future__ import annotations

import bisect
import math
import re

from dllama_tpu_torch.utils import locks

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default duration buckets (seconds): spans sub-ms CPU-test chunks through
#: minute-long cold starts
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
#: finer buckets for per-chunk / inter-token durations
CHUNK_BUCKETS_S = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(h: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal)."""
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    """Render a sample value: integers without a trailing .0, infinities as
    the +Inf/-Inf tokens the `le` label grammar requires."""
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Family:
    """A named metric with a fixed label-name tuple; `labels()` returns the
    per-label-value child carrying the actual value(s)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError(f"invalid label name {ln!r} for {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        # guards children dict AND child state. LEAF rank (utils/locks):
        # render/observe paths must never acquire anything under it
        self._lock = locks.make_lock("obs.metrics")
        self._children: dict[tuple, object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            extra = set(kv) - set(self.labelnames)
            if extra:
                raise ValueError(f"unknown labels {sorted(extra)} for {self.name}")
            try:
                values = tuple(str(kv[k]) for k in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e.args[0]!r} for {self.name}") from None
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}, got {values!r}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
        return child

    def _label_str(self, values, extra: str = "") -> str:
        parts = [f'{k}="{escape_label_value(v)}"'
                 for k, v in zip(self.labelnames, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self, out: list[str]) -> None:
        out.append(f"# HELP {self.name} {_escape_help(self.help)}")
        out.append(f"# TYPE {self.name} {self.kind}")
        with self._lock:
            for values in sorted(self._children):
                self._render_child(out, values, self._children[values])

    def _render_child(self, out, values, child) -> None:  # pragma: no cover
        raise NotImplementedError


class _ValueChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_ValueChild):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class _GaugeChild(_ValueChild):
    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum")

    def __init__(self, lock, buckets):
        self._lock = lock
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last slot = (last, +Inf]
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.sum += v
            # le is inclusive: bisect_left puts an exact boundary hit in
            # that boundary's own bucket
            self.counts[bisect.bisect_left(self.buckets, v)] += 1

    def observe_n(self, v: float, n: int) -> None:
        """Record the same value n times in one locked update — for hot
        paths that fold a batch of identical observations (e.g. a spec
        chunk's accepted-length counts via bincount) instead of paying a
        Python call per sample."""
        if n <= 0:
            return
        v = float(v)
        with self._lock:
            self.sum += v * n
            self.counts[bisect.bisect_left(self.buckets, v)] += n

    def count(self) -> int:
        with self._lock:
            return sum(self.counts)


class Counter(_Family):
    kind = "counter"

    def _make_child(self):
        return _CounterChild(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        """No-label convenience (family with labelnames=())."""
        self.labels().inc(amount)

    def value(self) -> float:
        return self.labels().value()

    def _render_child(self, out, values, child) -> None:
        # caller holds self._lock (same lock guards child._value)
        out.append(f"{self.name}{self._label_str(values)} "
                   f"{format_value(child._value)}")


class Gauge(_Family):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild(self._lock)

    def set(self, v: float) -> None:
        self.labels().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    def value(self) -> float:
        return self.labels().value()

    _render_child = Counter._render_child


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(), buckets=LATENCY_BUCKETS_S):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets or any(b != b or b == math.inf for b in buckets):
            raise ValueError(f"bad histogram buckets for {name}: {buckets!r}")
        self.buckets = buckets
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def observe_n(self, v: float, n: int) -> None:
        self.labels().observe_n(v, n)

    def _render_child(self, out, values, child) -> None:
        cum = 0
        for b, c in zip(self.buckets, child.counts):
            cum += c
            le = 'le="%s"' % format_value(b)
            out.append(f"{self.name}_bucket{self._label_str(values, le)} {cum}")
        cum += child.counts[-1]
        inf = self._label_str(values, 'le="+Inf"')
        out.append(f"{self.name}_bucket{inf} {cum}")
        out.append(f"{self.name}_sum{self._label_str(values)} "
                   f"{format_value(child.sum)}")
        out.append(f"{self.name}_count{self._label_str(values)} {cum}")


class Registry:
    """Name -> family map with idempotent registration and text rendering."""

    def __init__(self):
        self._lock = locks.make_lock("obs.metrics")
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name, help, labelnames=(), **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                same = (type(fam) is cls and fam.labelnames == tuple(labelnames)
                        and (cls is not Histogram
                             or fam.buckets == tuple(sorted(float(b) for b in
                                                            kw.get("buckets", LATENCY_BUCKETS_S)))))
                if not same:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(fam).__name__}{fam.labelnames} — cannot re-register "
                        f"as {cls.__name__}{tuple(labelnames)}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name, help, labelnames=(),
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def names(self) -> list[str]:
        """Sorted names of every registered family (catalog drift checks —
        scripts/checks.sh compares this against the README table)."""
        with self._lock:
            return sorted(self._families)

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        out: list[str] = []
        for fam in fams:
            fam.render(out)
        return "\n".join(out) + "\n" if out else ""

    def sample(self, name: str, labels: dict | None = None):
        """Introspection for tests/benches: the current value of one series
        (float for counter/gauge, {'count','sum'} for a histogram), or None
        when the series has never been touched."""
        with self._lock:
            fam = self._families.get(name)
        if fam is None:
            return None
        key = tuple(str((labels or {})[k]) for k in fam.labelnames
                    if k in (labels or {}))
        if len(key) != len(fam.labelnames):
            raise ValueError(f"{name} wants labels {fam.labelnames}")
        with fam._lock:
            child = fam._children.get(key)
            if child is None:
                return None
            if isinstance(child, _HistogramChild):
                return {"count": sum(child.counts), "sum": child.sum}
            return child._value

    def reset(self) -> None:
        """Zero every series, keeping registrations (bench warm-up resets)."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            with fam._lock:
                for child in fam._children.values():
                    if isinstance(child, _HistogramChild):
                        child.counts = [0] * len(child.counts)
                        child.sum = 0.0
                    else:
                        child._value = 0.0


#: the process-global registry `GET /metrics` exposes
REGISTRY = Registry()


def counter(name: str, help: str, labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str, labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str, labelnames=(),
              buckets=LATENCY_BUCKETS_S) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def render() -> str:
    return REGISTRY.render()
