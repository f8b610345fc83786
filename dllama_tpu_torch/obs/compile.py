"""Capture and device-traffic observability: the port's side of the JAX
package's ``obs/compile.py``.

The port's counterpart of a jit compile is a CUDA-graph capture: each
decode chunk and prompt chunk runs as a program of ``engine/graphs.py``,
captured once per key and replayed after. The stack's speed rests on two
invariants this module turns into scrapeable contracts: a BOUNDED set of
captured programs (a capture after warm-up stalls the live request that
asked for it) and near-zero steady-state host/device traffic.

* :class:`CompileLedger`: every capture is recorded by
  ``graphs.Program`` (:meth:`CompileLedger.record_capture`) under a
  function label and a bucket key (:data:`COMPILE_FNS`), with its seconds.
  Feeds ``dllama_jit_compiles_total{fn}`` /
  ``dllama_jit_compile_seconds_total{fn}`` and a ``compile`` span per
  capture.
* :class:`ShapeContract`: the declared universe of expected programs
  (``BatchEngine`` declares its prefill widths, the scheduler its decode
  chunk through ``BatchEngine.declare_serving_buckets``). A capture is
  expected or unexpected against it (``dllama_jit_unexpected_compiles_total
  {fn}`` and a warning naming the key); a function with no declarations
  classifies ``undeclared`` and never warns. ``--warmup auto`` captures
  every declared program before the first request.
* **transfer accounting**: :func:`note_transfer` counts host/device copies
  at the engine-boundary sites (``dllama_transfers_total{direction,site}``,
  ``dllama_transfer_bytes_total``).
* **device-memory gauges**: :func:`refresh_device_gauges` publishes the
  CUDA caching allocator's live block count and bytes at scrape time.

* **the transfer guard** (``--transfer-guard``): :func:`h2d_guard` runs
  the steady-state dispatch window under ``torch.cuda.set_sync_debug_mode``
  ('warn' for ``log``, 'error' for ``strict``). JAX's
  ``jax.transfer_guard_host_to_device`` flags implicit uploads; the torch
  mode flags operations that synchronize the host with the card, blocking
  uploads and reads included. The mode is process-wide: the guard sets it
  on entry and restores the previous mode on exit.

Module import is stdlib only; torch is imported inside the functions that
touch the card.
"""

from __future__ import annotations

import logging
import time
from collections import deque

from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import trace
from dllama_tpu_torch.utils import locks

log = logging.getLogger("dllama_tpu_torch.obs")

#: ledger `fn` labels the program captures bill to, with each bucket key's
#: grammar. The batched tier's labels are the JAX package's; a decode key
#: names n alone, so the greedy and the sampled program of one n are two
#: captures under one key (JAX compiles one scan for both).
COMPILE_FNS = {
    "prefill_chunk": "BatchEngine's prefill program of one pow2 width "
                     "(keys m{c}, c = pow2 <= --max-prefill-chunk; one "
                     "program a width on the page pool, one a (slot, width) "
                     "on the dense layout); also the prefill slice of a "
                     "hybrid chunk",
    "decode": "the batched n-step decode program, greedy or sampled (keys "
              "n{n}, n in 1..chunk: the row limit can clamp n)",
    "decode_pen": "the batched decode program with repetition-penalty "
                  "counts (keys n{n})",
    "single_step": "the single-engine tier's prefill program of one pow2 "
                   "width (keys m{T})",
    "single_decode": "the single-engine n-step decode programs, greedy, "
                     "sampled and penalized (keys n{n})",
    "spec": "the batched spec program of n propose/verify cycles, plain "
            "sampling (keys n{n} = verify cycles a replay; {1, chunk})",
    "spec_pen": "the batched spec program with repetition-penalty counts "
                "(keys n{n})",
    "single_spec": "the single-engine speculative verify program of m "
                   "cycles at draft length k (keys k{k}.m{m})",
}

#: transfer-accounting site labels (bounded cardinality)
TRANSFER_SITES = ("vectors", "prefill", "history", "commit", "decode_tokens",
                  "spec_counts", "nan_guard", "kv_spill", "kv_restore")


def sig_of(*args, max_leaves: int = 12) -> str:
    """Abstract signature of a program's buffers: dtype[shape] per tensor,
    scalars by value, the ledger's record of WHAT shape was captured.
    Never raises (a ledger entry must not take down a dispatch)."""
    parts: list[str] = []
    try:
        for a in args:
            if len(parts) >= max_leaves:
                parts.append("...")
                break
            shape = getattr(a, "shape", None)
            dtype = getattr(a, "dtype", None)
            if shape is not None and dtype is not None:
                parts.append(f"{dtype}[{','.join(str(d) for d in shape)}]")
            elif isinstance(a, (int, float, bool)):
                parts.append(repr(a))
            else:
                parts.append(type(a).__name__)
    except Exception:  # pragma: no cover - defensive
        parts.append("?")
    return ",".join(parts)


class ShapeContract:
    """Declarative registry of the expected programs: ``declare(fn, key)``
    names one bucket the warm-up captures; ``classify`` answers expected /
    unexpected / undeclared (a fn with no declarations at all has no
    contract to violate, so it never classifies unexpected); ``coverage``
    is the `/debug/compile` view."""

    def __init__(self):
        self._lock = locks.make_lock("obs.contract")
        self._buckets: dict[str, set[str]] = {}  # fn -> declared keys

    def declare(self, fn: str, key: str) -> None:
        if fn not in COMPILE_FNS:
            raise ValueError(f"unknown compile fn {fn!r} "
                             f"(catalog: {sorted(COMPILE_FNS)})")
        with self._lock:
            self._buckets.setdefault(fn, set()).add(str(key))

    def classify(self, fn: str, key: str) -> str:
        """'expected' | 'unexpected' | 'undeclared'."""
        with self._lock:
            buckets = self._buckets.get(fn)
            if buckets is None:
                return "undeclared"
            return "expected" if str(key) in buckets else "unexpected"

    def coverage(self, seen: dict[str, set]) -> dict:
        """Per-fn bucket coverage against ``seen`` (fn -> captured keys):
        declared counts, the declared buckets not captured yet, and the
        captured keys outside the declaration. ``full`` is True when every
        declared bucket has been captured (what `--warmup auto` must
        reach). The JAX package's per-key fields, `warm_targets` equal to
        `declared` (every declared bucket is a warm target here)."""
        with self._lock:
            buckets = {fn: set(ks) for fn, ks in self._buckets.items()}
        out: dict = {"fns": {}, "full": True}
        for fn, ks in sorted(buckets.items()):
            got = {str(k) for k in seen.get(fn, set())}
            missing = sorted(k for k in ks if k not in got)
            out["fns"][fn] = {
                "declared": len(ks),
                "warm_targets": len(ks),
                "compiled": len(got & ks),
                "missing_warm": missing,
                "unexpected_seen": sorted(got - ks),
            }
            if missing:
                out["full"] = False
        return out


class CompileLedger:
    """Thread-safe record of every program capture: bounded entry ring,
    per-fn totals, per-fn seen bucket keys, and the installed
    :class:`ShapeContract`. One process-global instance (:data:`LEDGER`),
    same lifecycle as the metrics registry."""

    def __init__(self, max_entries: int = 256):
        self._lock = locks.make_lock("obs.ledger")
        self.max_entries = int(max_entries)
        self.entries: deque = deque(maxlen=self.max_entries)
        # fn -> {"compiles", "seconds", "unexpected"}
        self.totals: dict[str, dict] = {}
        # fn -> set of bucket keys that were captured
        self.seen: dict[str, set] = {}
        self.contract = ShapeContract()
        self.warmup_report: dict | None = None
        self._warmup_depth = 0  # >0: entries flag warmup=True
        self._seq = 0
        self._t0 = time.monotonic()

    def warmup_phase(self):
        """Context manager flagging entries recorded inside it as warm-up
        (the boot capture pass) rather than traffic-stalling captures."""
        ledger = self

        class _Warm:
            def __enter__(self):
                with ledger._lock:
                    ledger._warmup_depth += 1

            def __exit__(self, *exc):
                with ledger._lock:
                    ledger._warmup_depth -= 1
                return False

        return _Warm()

    # ------------------------------------------------------------- record

    def record_capture(self, fn: str, key: str, seconds: float, t0: float,
                       sig: str = "") -> str:
        """One program captured: ``fn``/``key`` name it, ``seconds`` is the
        capture's wall time and ``t0`` its start (time.monotonic). Returns
        the contract's verdict (expected | unexpected | undeclared)."""
        key = str(key)
        verdict = self.contract.classify(fn, key)
        with self._lock:
            self._seq += 1
            warm = self._warmup_depth > 0
            self.entries.append({
                "seq": self._seq,
                "at_ms": round((t0 - self._t0) * 1000.0, 3),
                "fn": fn,
                "key": key,
                "sig": sig,
                "classification": verdict,
                "warmup": warm,
                "capture_s": round(seconds, 6),
            })
            tot = self.totals.setdefault(
                fn, {"compiles": 0, "seconds": 0.0, "unexpected": 0})
            tot["compiles"] += 1
            tot["seconds"] += seconds
            if verdict == "unexpected":
                tot["unexpected"] += 1
            self.seen.setdefault(fn, set()).add(key)
        ins.JIT_COMPILES.labels(fn=fn).inc()
        ins.JIT_COMPILE_SECONDS.labels(fn=fn).inc(seconds)
        if verdict == "unexpected":
            ins.JIT_UNEXPECTED_COMPILES.labels(fn=fn).inc()
            # names the offending program, so a stalled request's cause is
            # one grep away
            log.warning(
                "unexpected CUDA-graph capture outside the shape-bucket "
                "contract: fn=%s key=%s sig=%s (%.3fs) — declare the bucket "
                "or fix the caller's shape", fn, key, sig, seconds,
                extra={"compile_fn": fn, "compile_key": key})
        tr = trace.TRACER
        if tr.enabled:
            tr.span_at("compile", t0, t0 + seconds, cat="compile",
                       track="compile", fn=fn, key=key, warmup=warm,
                       classification=verdict, compile_s=round(seconds, 4))
        return verdict

    # ------------------------------------------------------------- reading

    def total_compiles(self) -> int:
        """Every recorded capture: the number a steady-state decode window
        must not move at all."""
        with self._lock:
            return sum(t["compiles"] for t in self.totals.values())

    def total_unexpected(self) -> int:
        with self._lock:
            return sum(t["unexpected"] for t in self.totals.values())

    def snapshot(self, entries: int = 64) -> dict:
        """The `/debug/compile` ledger body: per-fn totals, the most
        recent entries, per-fn seen bucket keys, and contract coverage."""
        n = max(0, int(entries))
        with self._lock:
            totals = {fn: dict(t) for fn, t in sorted(self.totals.items())}
            recent = list(self.entries)[-n:] if n else []
            seen = {fn: sorted(ks) for fn, ks in sorted(self.seen.items())}
            seen_sets = {fn: set(ks) for fn, ks in self.seen.items()}
        return {
            "totals": totals,
            "compiles": sum(t["compiles"] for t in totals.values()),
            "unexpected": sum(t["unexpected"] for t in totals.values()),
            "seconds": round(sum(t["seconds"] for t in totals.values()), 6),
            "entries": recent,
            "seen": seen,
            "contract": self.contract.coverage(seen_sets),
        }

    def summary(self) -> dict:
        """Compact join for latency_summary() / /health / /debug/perf."""
        with self._lock:
            totals = self.totals
            out = {
                "compiles": sum(t["compiles"] for t in totals.values()),
                "unexpected": sum(t["unexpected"] for t in totals.values()),
                "seconds": round(
                    sum(t["seconds"] for t in totals.values()), 3),
            }
        out["warmup"] = (None if self.warmup_report is None
                         else {k: self.warmup_report.get(k)
                               for k in ("mode", "buckets", "graphs_captured",
                                         "seconds", "full_coverage")})
        return out

    def install_contract(self, contract: ShapeContract) -> None:
        """Adopt an engine's contract (last engine wins, like the serving
        gauges). Installing starts a fresh coverage epoch: the per-fn
        seen-bucket record resets (lifetime totals and entries stay)."""
        with self._lock:
            self.contract = contract
            self.seen = {}

    def reset(self) -> None:
        """Drop entries/totals/seen and the warm-up report, keeping the
        contract (test isolation)."""
        with self._lock:
            self.entries.clear()
            self.totals = {}
            self.seen = {}
            self.warmup_report = None


#: the process-global capture ledger (what /debug/compile serves)
LEDGER = CompileLedger()


# ------------------------------------------------------------- transfers

_transfer_lock = locks.make_lock("obs.transfers")
# (direction, site) -> [count, bytes] — mirror of the counters so the
# /debug payload can enumerate label combos without registry introspection
_transfers: dict[tuple[str, str], list] = {}


def note_transfer(direction: str, site: str, nbytes: int) -> None:
    """Count one host↔device transfer at an engine-boundary site.
    ``direction`` is 'h2d' or 'd2h'; ``site`` one of TRANSFER_SITES."""
    ins.TRANSFERS.labels(direction=direction, site=site).inc()
    ins.TRANSFER_BYTES.labels(direction=direction, site=site).inc(
        max(0, int(nbytes)))
    with _transfer_lock:
        acc = _transfers.setdefault((direction, site), [0, 0])
        acc[0] += 1
        acc[1] += max(0, int(nbytes))


def transfer_snapshot() -> dict:
    """Per-site transfer tallies + h2d/d2h totals (the `/debug/compile`
    transfer view and the steady-state-gate's measurement surface)."""
    with _transfer_lock:
        items = {f"{d}.{s}": {"count": c, "bytes": b}
                 for (d, s), (c, b) in sorted(_transfers.items())}
        h2d = sum(b for (d, _), (_, b) in _transfers.items() if d == "h2d")
        d2h = sum(b for (d, _), (_, b) in _transfers.items() if d == "d2h")
        h2d_n = sum(c for (d, _), (c, _) in _transfers.items() if d == "h2d")
        d2h_n = sum(c for (d, _), (c, _) in _transfers.items() if d == "d2h")
    return {"sites": items,
            "h2d": {"count": h2d_n, "bytes": h2d},
            "d2h": {"count": d2h_n, "bytes": d2h}}


def reset_transfers() -> None:
    """Zero the host-side mirror (tests/benches; the registry counters
    keep their monotone lifetime totals)."""
    with _transfer_lock:
        _transfers.clear()


# --------------------------------------------------------- device memory

TRANSFER_GUARD_MODES = ("off", "log", "strict")


class h2d_guard:
    """Context manager for the steady-state dispatch window (the JAX
    package's ``h2d_guard``, over ``torch.cuda.set_sync_debug_mode``):
    'strict' makes a synchronizing operation inside the window raise,
    'log' warns, 'off' (and any window on a CPU device, where nothing
    synchronizes) does nothing. The mode is process-wide, so the window is
    kept to the replays and their non-blocking output copies; entry saves
    the previous mode and exit restores it (nested windows nest)."""

    def __init__(self, mode: str, device=None):
        if mode not in TRANSFER_GUARD_MODES:
            raise ValueError(f"transfer_guard must be one of {TRANSFER_GUARD_MODES}, "
                             f"got {mode!r}")
        self.on = mode != "off" and device is not None and getattr(device, "type", "") == "cuda"
        self.level = "error" if mode == "strict" else "warn"
        self._prev = None

    def __enter__(self):
        if self.on:
            import torch

            self._prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(self.level)
        return self

    def __exit__(self, *exc) -> None:
        if self.on:
            import torch

            torch.cuda.set_sync_debug_mode(self._prev)


def refresh_device_gauges() -> dict:
    """Publish the CUDA caching allocator's live blocks and bytes
    (``torch.cuda.memory_stats()``: ``active.all.current`` and
    ``allocated_bytes.all.current``), called at scrape time like the
    process self-metrics. Answers {'buffers': None, 'bytes': None} without
    a CUDA device (the gauges keep their last value)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {"buffers": None, "bytes": None}
        st = torch.cuda.memory_stats()
        n = int(st.get("active.all.current", 0))
        total = int(st.get("allocated_bytes.all.current", 0))
    except Exception:  # pragma: no cover - no backend
        return {"buffers": None, "bytes": None}
    ins.DEVICE_LIVE_BUFFERS.set(n)
    ins.DEVICE_LIVE_BYTES.set(total)
    return {"buffers": n, "bytes": total}


_UNSET = object()


def debug_payload(warmup_report=_UNSET, entries: int = 64) -> dict:
    """The GET /debug/compile document: ledger dump + bucket coverage +
    warm-up report + transfer tallies + live device memory. The API tier
    passes its warm-up state explicitly (None for a warm-up-off boot, which
    must not fall back to a report an earlier engine left on the ledger);
    omitting the argument keeps the ledger's own report."""
    out = LEDGER.snapshot(entries=entries)
    out["warmup"] = (LEDGER.warmup_report if warmup_report is _UNSET
                     else warmup_report)
    out["transfers"] = transfer_snapshot()
    out["device_memory"] = refresh_device_gauges()
    return out
