"""Named locks with an optional runtime lock-order sanitizer: a copy of the
JAX package's ``utils/locks.py`` (the port imports nothing of that package),
whose rank table adds three locks of the port's own (``parallel.link``,
``faults.edit``, ``engine.graphs``).

The serving stack holds a web of small locks across five-plus threads
(scheduler worker, watchdog, HTTP handlers, drain thread, profiler timer):
the scheduler's metrics ring, the KV page pool's reentrant allocator lock
(which the radix prefix tree deliberately piggybacks), the observability
registries (metrics families, tracer ring, compile ledger, perf windows),
and the fault-injection plan. None of them may ever deadlock a scrape or a
request thread, so the stack commits to ONE global acquisition order — the
rank table below, lowest rank acquired first, innermost (leaf) locks
ranked highest. The static half of the contract is the port's analyzer
(``python -m dllama_tpu_torch.analysis``: its ``lock-order``/``lock-leaf``
rules build the cross-module lock graph from the AST); this module is the
runtime half, the stack's lockdep:

* every lock is created through :func:`make_lock` / :func:`make_rlock`
  with a name from :data:`LOCK_RANKS` (an unknown name raises at
  construction — the rank table is the single definition site, drift-
  checked against the README table by the analyzer);
* with ``DLLAMA_LOCK_AUDIT=1`` (armed suite-wide by tests/conftest.py and
  scripts/chaos_soak.sh) each factory returns an audited wrapper keeping a
  thread-local stack of held locks: acquiring a lock whose rank is not
  strictly above every held lock raises :class:`LockOrderError` naming
  BOTH sites — the held lock's acquisition point and the violating one —
  at the acquisition that would eventually deadlock, not at the deadlock;
* re-acquiring a held reentrant lock is always legal (the pool audit
  re-enters the pool lock through the radix tree's audit hook);
* with the audit off the factories return plain ``threading.Lock`` /
  ``RLock`` objects — zero wrapper, zero per-acquire overhead.

Leaf discipline: the metrics registry and tracer locks hold the two
highest ranks, so acquiring ANYTHING while holding them is an order
violation by construction — the scrape-path deadlock shape (a /metrics
render re-entering the scheduler or pool) cannot be written without the
sanitizer (and the static ``lock-leaf`` rule) firing.

Stdlib-only and import-leaf: everything in ``dllama_tpu_torch.obs`` imports
this module, so it must import nothing of dllama_tpu_torch.
"""

from __future__ import annotations

import os
import sys
import threading

ENV_VAR = "DLLAMA_LOCK_AUDIT"

#: The global lock-acquisition order: a thread may only acquire a lock
#: whose rank is STRICTLY greater than every lock it already holds
#: (re-entering a held RLock excepted). Lowest rank = outermost. The
#: README "lock rank" table mirrors this exactly (analyzer rule
#: ``doc-ranks``), and the static lock graph's edges must all ascend it
#: (rule ``lock-order``).
LOCK_RANKS = {
    # outermost: the router's replica-registry/affinity lock — routing
    # decisions may consult anything below, nothing re-enters the router
    "serve.router": 3,
    # outermost: the single-engine API tier's request serializer — held
    # across a whole generation, everything below nests under it
    "api.single": 5,
    # the aio front-end's connection-registry/stream-list lock (held for
    # dict/list mutation only — never across a handler or a device call)
    "serve.frontend": 7,
    # the scheduler's completed-request/stall-sample ring
    "scheduler.metrics": 10,
    # rank 0's command channel on a mesh (parallel/multihost.Link.lock,
    # reentrant): held across each whole mirrored call, which the engine
    # then makes under it (the port's own)
    "parallel.link": 12,
    # the fault plan's edit lock (utils/faults.edit_lock, reentrant): every
    # change of the plan, and rank 0 across each mirrored call (the port's)
    "faults.edit": 14,
    # the paged-KV allocator (PagePool._mu, reentrant: the radix tree
    # shares it and audit() re-enters through the tree's audit hook)
    "engine.pool": 20,
    # fault-injection plan table and per-point firing windows
    "faults.plan": 30,
    "faults.point": 32,
    # CUDA-graph captures and replays against a profiler's start and stop
    # (utils/profiling.GRAPH_GATE); a capture records itself in the ledger
    # under it (the port's own)
    "engine.graphs": 36,
    # compile ledger + shape contract (obs/compile.py)
    "obs.ledger": 40,
    "obs.contract": 42,
    # perf windows / time ledger (obs/perf.py) — bill into metrics
    "obs.perf": 44,
    # transfer-accounting mirror (obs/compile.py)
    "obs.transfers": 46,
    # the one-capture torch.profiler guard (utils/profiling.py)
    "utils.profiling": 48,
    # LEAF locks: nothing may be acquired while holding these. The tracer
    # ring first, the metrics registry/family locks innermost of all.
    "obs.tracer": 50,
    "obs.metrics": 60,
}

#: leaf locks (documented contract; with the ranks above, any acquisition
#: under them already violates the strict ordering — this set exists so
#: the static analyzer and error messages can say WHY)
LEAF_LOCKS = frozenset({"obs.tracer", "obs.metrics"})


class LockOrderError(RuntimeError):
    """An out-of-rank lock acquisition — the shape that deadlocks once two
    threads interleave. The message names both hold sites."""


_armed = os.environ.get(ENV_VAR, "") not in ("", "0")


def configure(on: bool) -> None:
    """Arm/disarm the audit for locks created AFTER this call (tests).
    Production arms via the env var before the process imports anything."""
    global _armed
    _armed = bool(on)


def armed() -> bool:
    return _armed


_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def held_names() -> list[str]:
    """Names of audited locks the CALLING thread currently holds,
    outermost first (introspection for tests and error paths)."""
    return [lk.name for lk, _site in _held()]


def _caller_site() -> str:
    """file:line of the acquisition OUTSIDE this module — the site a
    LockOrderError must name (``with lock:`` enters via __enter__, so the
    first frames belong to locks.py itself)."""
    try:
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:  # pragma: no cover - called from module level
            return "<unknown>"
        return f"{f.f_code.co_filename}:{f.f_lineno}"
    except Exception:  # pragma: no cover - exotic interpreters
        return "<unknown>"


def _check_name(name: str) -> None:
    """The one unknown-name validator (factories and AuditedLock share
    it): the rank table is the single definition site."""
    if name not in LOCK_RANKS:
        raise ValueError(
            f"unknown lock name {name!r}; add it to utils/locks.LOCK_RANKS "
            f"(and the README lock-rank table) — known: {sorted(LOCK_RANKS)}")


class AuditedLock:
    """threading.Lock/RLock with rank-order auditing (see module doc).
    Full Lock surface: acquire(blocking, timeout) / release / context
    manager; ``reentrant`` wraps an RLock and allows re-acquisition of the
    SAME object regardless of rank."""

    __slots__ = ("name", "rank", "reentrant", "_lk")

    def __init__(self, name: str, reentrant: bool = False):
        _check_name(name)
        self.name = name
        self.rank = LOCK_RANKS[name]
        self.reentrant = bool(reentrant)
        self._lk = threading.RLock() if reentrant else threading.Lock()

    def _check(self, site: str) -> None:
        held = _held()
        if self.reentrant and any(lk is self for lk, _ in held):
            return  # legal reentry of a held RLock
        for lk, where in held:
            if lk.rank >= self.rank:
                leaf = (" — it is a LEAF lock: nothing may be acquired "
                        "while holding it" if lk.name in LEAF_LOCKS else "")
                raise LockOrderError(
                    f"lock-order violation: acquiring {self.name!r} "
                    f"(rank {self.rank}) at {site} while holding "
                    f"{lk.name!r} (rank {lk.rank}, acquired at {where})"
                    f"{leaf}; the global order is utils/locks.LOCK_RANKS")

    def acquire(self, blocking: bool = True, timeout: float = -1):
        site = _caller_site()
        self._check(site)
        got = self._lk.acquire(blocking, timeout)
        if got:
            _held().append((self, site))
        return got

    def release(self) -> None:
        self._lk.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:  # Lock parity (RLock lacks it pre-3.12)
        probe = getattr(self._lk, "locked", None)
        if probe is not None:
            return probe()
        if self._lk.acquire(blocking=False):  # pragma: no cover - RLock
            self._lk.release()
            return False
        return True  # pragma: no cover

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"<AuditedLock {self.name} rank={self.rank}>"


def make_lock(name: str):
    """A named non-reentrant lock: plain ``threading.Lock()`` when the
    audit is off (zero overhead — the factory IS the fast path), an
    :class:`AuditedLock` when armed. `name` must be in LOCK_RANKS."""
    _check_name(name)
    if not _armed:
        return threading.Lock()
    return AuditedLock(name)


def make_rlock(name: str):
    """A named REENTRANT lock (same contract as :func:`make_lock`;
    re-acquisition by the holding thread is always rank-legal)."""
    _check_name(name)
    if not _armed:
        return threading.RLock()
    return AuditedLock(name, reentrant=True)
