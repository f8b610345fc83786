"""Deterministic fault injection for the serving stack: a copy of the JAX
package's ``utils/faults.py`` (the port imports nothing of that package).
Every point fires on the host, at dispatch, never inside a captured
program's body: a body runs once at capture and then replays, so a fault
there would fire once and never again.

The reference server has no failure-path testing at all (a hung request just
stalls its one blocking client, dllama-api.cpp:522-533); our continuous-
batching tier multiplexes every client over ONE worker thread and ONE device,
so "what happens when a decode chunk dies" must be testable on demand.  This
module gives every interesting failure a NAME, and lets tests (or an operator
reproducing an incident) arm it deterministically — no monkeypatching into
jitted internals, no sleeps-and-hope.

Injection points (armed sites call :func:`fire` with their point name):

======================  =====================================================
``engine.decode``       before a decode-chunk dispatch (BatchEngine.
                        decode_dispatch, spec chunks and hybrid_dispatch)
``engine.prefill``      before an admission prefill chunk (BatchEngine.add_step)
``loader.read``         before the .m header read (models/formats.read_header)
``scheduler.queue``     admission-queue overflow: Scheduler.submit sheds the
                        request as if --max-queue were exceeded
``scheduler.loop``      top of the scheduler worker loop (worker-crash drill)
``pool.alloc``          before a paged-KV page allocation (PagePool._alloc_page)
                        — fails an admission per-request, or crashes a decode
                        top-up into the warm-restart path
``engine.restart``      inside the warm-restart sequence, before the engine
                        rebuild (Scheduler._try_restart) — drills a restart
                        that itself dies, which exhausts the budget
``decode.nan``          poisons one slot of the next decode chunk as if its
                        logits went non-finite (``raise`` armed, consumed via
                        :func:`flag`, OR-ed into the chunk's host-side
                        ``bad`` mask): the scheduler's NaN guard fails THAT
                        request with finish_reason="error", not the engine
``pool.spill``          before a radix-evicted page's d2h copy into the host
                        KV tier's slab (BatchEngine._host_spill) — ``raise`` degrades
                        the eviction to the old discard (page lost, stream
                        correct), ``delay`` stretches the release boundary
``pool.restore``        before a host-tier page's device re-allocation + h2d
                        upload at admission (BatchEngine radix restore) —
                        ``raise`` falls back to re-prefilling the suffix,
                        ``delay`` stretches the admission
``router.proxy``        top of the router's proxy path (serve/router._proxy),
                        before any replica pick — ``raise`` sheds the request
                        with a clean 503, ``delay`` holds it (client-timeout
                        and thundering-herd drills)
======================  =====================================================

On a mesh (parallel/multihost: one process a rank, rank 0 driving) the plan
is rank 0's, wherever it came from: ``--faults``, ``$DLLAMA_FAULTS``,
:func:`install`, :func:`clear`. A follower never arms a plan of its own; it
takes rank 0's, counters included (:func:`state`, :func:`apply`), with the
first command after each change (:func:`version`), before the call that
could fire it. The **engine points** (:data:`ENGINE_POINTS`: ``engine.decode``,
``engine.prefill``, ``decode.nan`` and the ``pool.*`` points) fire inside
the engine calls that every rank makes, so they fire on every rank at the
same call, ``after`` and ``times`` count alike, and a ``raise`` is the same
:class:`InjectedFault` on every rank before the call's first exchange. The
**driver points** (every other point: ``loader.read``, ``scheduler.*``,
``engine.restart``, ``router.proxy``) fire on rank 0 alone, which sends
nothing for them. Rank 0's counter of fires (dllama_fault_fires_total) counts
what the JAX package's one controller would: one fire a point a call.

Actions: ``raise`` (throw :class:`InjectedFault`) and ``delay`` (sleep
``ms``, e.g. to trip the stall watchdog).  Options: ``after=N`` skips the
first N hits, ``times=N`` fires at most N times (default: forever).

Configuration is a comma-separated spec string, via the ``DLLAMA_FAULTS``
env var or the ``--faults`` CLI flag::

    DLLAMA_FAULTS="engine.decode:raise:after=2"
    --faults "engine.decode:delay:ms=400:times=1,scheduler.queue:raise"

Tests use the programmatic API (:func:`install` / :func:`clear`); both paths
share the same plan table.  ``fire`` is a dict-lookup no-op when nothing is
armed — production cost is one ``if``.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field

from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import trace
from dllama_tpu_torch.utils import locks

log = logging.getLogger("dllama_tpu_torch.faults")

ENV_VAR = "DLLAMA_FAULTS"

#: every site that calls fire(); configure() rejects unknown names so a typo
#: in a fault spec fails at startup, not by silently never firing
POINTS = frozenset({
    "engine.decode",
    "engine.prefill",
    "loader.read",
    "scheduler.queue",
    "scheduler.loop",
    "pool.alloc",
    "engine.restart",
    "decode.nan",
    "pool.spill",
    "pool.restore",
    "router.proxy",
})

ACTIONS = frozenset({"raise", "delay"})

#: the points inside engine calls: on a mesh every rank fires them alike; the
#: others are the driver's (loader, scheduler, restart, router), rank 0's alone
ENGINE_POINTS = frozenset({"engine.decode", "engine.prefill", "decode.nan", "pool.alloc",
                           "pool.spill", "pool.restore"})


class InjectedFault(RuntimeError):
    """The error thrown by an armed ``raise`` fault (never raised by real
    failures — tests can assert on the type to prove the drill fired)."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


@dataclass
class _Fault:
    point: str
    action: str  # 'raise' | 'delay'
    ms: float = 0.0  # delay duration
    after: int = 0  # skip the first N hits
    times: int | None = None  # fire at most N times (None = forever)
    hits: int = 0  # total fire() visits (fired or not)
    fired: int = 0
    lock: object = field(
        default_factory=lambda: locks.make_lock("faults.point"), repr=False)

    def visit(self) -> str | None:
        """Count one arrival at the point; return the action to apply (or
        None when the window says skip). Thread-safe: concurrent request
        threads hit scheduler.queue simultaneously."""
        with self.lock:
            n = self.hits
            self.hits += 1
            if n < self.after:
                return None
            if self.times is not None and self.fired >= self.times:
                return None
            self.fired += 1
            return self.action


_plan: dict[str, _Fault] = {}
_plan_lock = locks.make_lock("faults.plan")
#: held by every change of the plan; a mesh's rank 0 holds it across each
#: mirrored call (parallel/multihost.Link), so a plan never changes between
#: the message that carries it and the call it governs
edit_lock = locks.make_rlock("faults.edit")
_version = [0]  # bumped by every change of the plan (version())


def parse(spec: str) -> list[_Fault]:
    """Parse a spec string into fault entries (validating names eagerly)."""
    out: list[_Fault] = []
    for clause in filter(None, (c.strip() for c in spec.split(","))):
        parts = clause.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault clause {clause!r}: want point:action[:k=v...]")
        point, action, opts = parts[0], parts[1], parts[2:]
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; known: {sorted(POINTS)}")
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; known: {sorted(ACTIONS)}")
        f = _Fault(point, action)
        for opt in opts:
            k, _, v = opt.partition("=")
            if k == "ms":
                f.ms = float(v)
            elif k == "after":
                f.after = int(v)
            elif k == "times":
                f.times = int(v)
            else:
                raise ValueError(f"unknown fault option {opt!r} in {clause!r}")
        out.append(f)
    return out


def configure(spec: str | None) -> None:
    """Replace the active plan from a spec string ('' / None clears)."""
    faults = parse(spec) if spec else []
    with edit_lock, _plan_lock:
        _plan.clear()
        for f in faults:
            _plan[f.point] = f
        _version[0] += 1
    if faults:
        log.warning("fault injection ARMED: %s",
                    ", ".join(f"{f.point}:{f.action}" for f in faults))


def configure_from_env() -> None:
    """Arm faults from $DLLAMA_FAULTS if set (CLI startup calls this)."""
    spec = os.environ.get(ENV_VAR)
    if spec:
        configure(spec)


def install(point: str, action: str = "raise", *, ms: float = 0.0,
            after: int = 0, times: int | None = None) -> None:
    """Arm one point programmatically (tests). Replaces any prior fault at
    the same point; other points are untouched."""
    if point not in POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: {sorted(POINTS)}")
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}; known: {sorted(ACTIONS)}")
    with edit_lock, _plan_lock:
        _plan[point] = _Fault(point, action, ms=ms, after=after, times=times)
        _version[0] += 1


def clear(point: str | None = None) -> None:
    """Disarm one point, or everything (tests' teardown)."""
    with edit_lock, _plan_lock:
        if point is None:
            _plan.clear()
        else:
            _plan.pop(point, None)
        _version[0] += 1


def version() -> int:
    """A number that changes whenever the plan does (configure, install,
    clear, apply)."""
    return _version[0]


def state() -> tuple:
    """The plan's engine points as a value a mesh sends its followers: one
    (point, action, ms, after, times, hits, fired) a point, its counters as
    they stand. Driver points stay on rank 0."""
    with _plan_lock:
        return tuple((f.point, f.action, f.ms, f.after, f.times, f.hits, f.fired)
                     for f in _plan.values() if f.point in ENGINE_POINTS)


def apply(entries: tuple) -> None:
    """Replace the plan with rank 0's (:func:`state`): a follower's plan."""
    with edit_lock, _plan_lock:
        _plan.clear()
        for point, action, ms, after, times, hits, fired in entries:
            _plan[point] = _Fault(point, action, ms=ms, after=after, times=times, hits=hits,
                                  fired=fired)
        _version[0] += 1


def active(point: str) -> bool:
    return point in _plan


def pending(point: str) -> bool:
    """Whether an armed fault at `point` can still fire (its ``times``
    window is not exhausted). A plan entry outlives its last firing — this
    is how a drill detects that some OTHER thread consumed the activation
    it armed (e.g. a fixture server's idle worker loop) and re-arms."""
    f = _plan.get(point)
    if f is None:
        return False
    with f.lock:
        if f.times is not None and f.fired >= f.times:
            return False
        return True


def flag(point: str) -> bool:
    """The armed-site hook for sites with their OWN failure semantics (e.g.
    ``decode.nan``, where the failure is poisoned data, not an exception):
    returns True when an armed ``raise`` fault at `point` fires — counted at
    /metrics and on the trace timeline exactly like :func:`fire` — instead
    of raising. ``delay`` still sleeps and returns False."""
    f = _plan.get(point)
    if f is None:
        return False
    action = f.visit()
    if action is None:
        return False
    # every activation is a countable incident: drills and live mishaps
    # alike show up at /metrics (dllama_fault_fires_total{point,action})
    # AND on the request-flow trace timeline (/debug/trace)
    ins.FAULT_FIRES.labels(point=point, action=action).inc()
    trace.TRACER.event("fault.fire", cat="fault", track="scheduler",
                       point=point, action=action)
    if action == "delay":
        log.warning("injected delay at %r: %.0f ms", point, f.ms,
                    extra={"fault_point": point})
        time.sleep(f.ms / 1000.0)
        return False
    log.warning("injected fault at %r", point, extra={"fault_point": point})
    return True


def fire(point: str) -> None:
    """The armed-site hook: no-op unless a fault is installed at `point`.
    Raises InjectedFault for 'raise', sleeps for 'delay'."""
    if flag(point):
        raise InjectedFault(point)
