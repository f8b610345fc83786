"""Profiling and memory accounting: the port's side of the JAX package's
``utils/profiling.py``.

* :func:`trace` — a ``torch.profiler`` capture over a with-block (CLI
  ``--trace DIR``), exported as a Chrome trace (``trace.json`` in the
  directory; loads in Perfetto or chrome://tracing). The JAX package
  writes an XProf trace instead.
* :func:`start_profile` — the on-demand, duration-capped capture behind
  ``POST /debug/profile``: the same capture as :func:`trace` (one lock
  guards both, so a CLI ``--trace`` run and an HTTP capture can never
  double-start the profiler), stopped and exported by a thread of its own.
  With a CUDA device the capture records CUDA activity (CUPTI kernel
  events) beside the CPU ops, or refuses to start
  (:class:`ProfileUnavailable`): a CPU-only trace is never handed back as
  a card's.
* :class:`TokenTimer` — host-side per-token latency recorder with the
  reference's report shape (avg/p50/p90 ms/token, tok/s).
* :func:`collective_bytes_per_token` — analytic per-token inter-chip
  payload for a mesh (zero on one device, the port's only layout).
* :func:`memory_report` / :func:`set_memory_gauges` — parameter and KV
  cache bytes resident on the device.

The JAX package's ``measured_collective_bytes`` parses compiled HLO; it
waits for the port's parallel axes.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import trace as reqtrace
from dllama_tpu_torch.utils import locks


class ProfileBusy(RuntimeError):
    """A profiler capture is already running (one profiler capture at a
    time in a process); the API tier maps this to HTTP 409."""


class ProfileUnavailable(RuntimeError):
    """The profiler cannot record the card's activity here (no CUDA
    activity in ``torch.profiler.supported_activities()``); the API tier
    maps this to HTTP 503 rather than answer with a CPU-only trace."""


#: the one-capture profiler lock + state shared by trace() (CLI --trace)
#: and start_profile() (POST /debug/profile)
_prof_lock = locks.make_lock("utils.profiling")
_prof_state = {"active": False, "dir": None, "started_at": 0.0,
               "duration_s": None, "last_trace": None, "last_written_s": None,
               "activities": None}

#: hard cap on an on-demand capture: profiles are heavy (every op and
#: kernel is recorded); a forgotten long capture must not degrade serving
MAX_PROFILE_SECONDS = 60.0

#: CUDA-graph captures and replays (engine/graphs.Program) and a profiler's
#: start and stop exclude each other: stopping a capture while another
#: thread replayed a graph hung both in native code (the profiler in its
#: exit, the replay in ``CUDAGraph.replay``; torch 2.11, CUDA 12.8, an H100,
#: about one stop in ten under 8-stream decode). A replay waits out a stop
#: (seconds) as it waits out the stop's hold on the interpreter anyway.
GRAPH_GATE = locks.make_lock("engine.graphs")

#: how long POST /debug/profile waits for the capture to start
START_TIMEOUT_S = 60.0

#: the Chrome trace file a capture writes into its directory
TRACE_FILE = "trace.json"


def _activities() -> list:
    """CPU always; CUDA whenever a CUDA device is there (and refused when
    the profiler cannot record it)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise ProfileUnavailable(
                "torch.profiler cannot record CUDA activity in this build; "
                "refusing a CPU-only trace of a card")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _claim(log_dir: str, duration_s: float | None) -> tuple[list, str]:
    """Take the one profiler capture -> (activities, trace path); raises
    ProfileBusy / ProfileUnavailable."""
    with _prof_lock:
        if _prof_state["active"]:
            raise ProfileBusy(
                f"a profiler capture is already running "
                f"(dir={_prof_state['dir']!r}, started "
                f"{time.time() - _prof_state['started_at']:.1f}s ago)")
        acts = _activities()
        os.makedirs(log_dir, exist_ok=True)
        _prof_state.update(active=True, dir=log_dir, started_at=time.time(),
                           duration_s=duration_s,
                           activities=[a.name.lower() for a in acts])
    return acts, os.path.join(log_dir, TRACE_FILE)


def _release(path: str | None, written_s: float | None) -> None:
    with _prof_lock:
        _prof_state.update(active=False, duration_s=None,
                           last_trace=path or _prof_state["last_trace"],
                           last_written_s=written_s)


@contextlib.contextmanager
def _capture(log_dir: str, duration_s: float | None = None):
    """One profiler capture on the calling thread (torch.profiler starts
    and stops on one thread), exported to ``log_dir/trace.json`` on exit.
    CUDA activity is recorded device-wide, whichever thread launched it."""
    acts, path = _claim(log_dir, duration_s)
    written = written_s = None
    try:
        prof = torch.profiler.profile(activities=acts)
        with GRAPH_GATE:
            prof.start()
        reqtrace.TRACER.event("profile.start", cat="profile", track="profiler", dir=log_dir)
        try:
            yield path
        finally:
            t0 = time.perf_counter()
            with GRAPH_GATE:
                prof.stop()
            prof.export_chrome_trace(path)
            written, written_s = path, time.perf_counter() - t0
            reqtrace.TRACER.event("profile.stop", cat="profile", track="profiler")
    finally:
        _release(written, written_s)


def profile_status() -> dict:
    """Snapshot of the profiler capture: dir, timing, the last trace
    written and the seconds its stop and write took (`last_written_s`)."""
    with _prof_lock:
        return {k: _prof_state[k] for k in ("active", "dir", "duration_s", "activities",
                                            "last_trace", "last_written_s")}


def start_profile(log_dir: str | None = None, duration_s: float = 2.0) -> dict:
    """Start an on-demand torch.profiler capture for `duration_s` (clamped
    to [0.05, MAX_PROFILE_SECONDS]) on a thread of its own, which stops it
    and writes the Chrome trace. Returns {dir, trace, activities,
    duration_s} once the capture runs; raises :class:`ProfileBusy` when a
    capture (this one or a CLI ``--trace`` run) is already in flight, and
    :class:`ProfileUnavailable` when a card's activity cannot be
    recorded."""
    duration_s = min(max(float(duration_s), 0.05), MAX_PROFILE_SECONDS)
    if not log_dir:
        log_dir = tempfile.mkdtemp(prefix="dllama_profile_")
    log_dir = str(log_dir)
    started = threading.Event()
    box: dict = {}

    def run():
        try:
            with _capture(log_dir, duration_s) as path:
                box["trace"] = path
                started.set()
                time.sleep(duration_s)
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller
            box["error"] = e
            started.set()

    threading.Thread(target=run, name="dllama-profile", daemon=True).start()
    if not started.wait(START_TIMEOUT_S):
        raise ProfileUnavailable(f"the profiler did not start within {START_TIMEOUT_S:.0f} s")
    if "error" in box and "trace" not in box:
        raise box["error"]
    with _prof_lock:
        acts = _prof_state["activities"]
    return {"dir": log_dir, "trace": box["trace"], "activities": acts,
            "duration_s": duration_s}


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler capture over a with-block, exported to
    ``log_dir/trace.json``; a no-op when log_dir is falsy. Shares the
    process's profiler with :func:`start_profile`, so it raises
    :class:`ProfileBusy` instead of corrupting a running capture."""
    if not log_dir:
        yield
        return
    with _capture(str(log_dir)):
        yield


@dataclass
class TokenTimer:
    """Per-token wall-clock recorder (dllama.cpp:82-104 report shape).

    Every stop() also observes the sample into the metrics registry
    (dllama_token_latency_seconds), so the console report and a /metrics
    scrape read the same record."""

    ms: list[float] = field(default_factory=list)
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.ms.append(dt)
        ins.TOKEN_LATENCY_SECONDS.observe(dt / 1000.0)
        return dt

    @contextlib.contextmanager
    def token(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> str:
        if not self.ms:
            return "no tokens timed"
        a = np.asarray(self.ms)
        # throughput over TOTAL time, not 1000/mean (the reciprocal of the
        # mean overweights fast tokens); guard the all-zero clock
        total_s = float(a.sum()) / 1000.0
        tok_s = len(a) / total_s if total_s > 0 else 0.0
        return (
            f"{len(a)} tokens: avg {a.mean():.2f} ms/token "
            f"(p50 {np.percentile(a, 50):.2f}, p90 {np.percentile(a, 90):.2f}, "
            f"max {a.max():.2f}), {tok_s:.1f} tok/s"
        )


def collective_bytes_per_token(cfg, tp: int = 1, sp: int = 1, exchange_bytes: float = 2.0) -> dict:
    """Analytic inter-chip payload per decoded token, per chip (the JAX
    package's arithmetic; zero at tp = sp = 1). Tensor-parallel Llama
    all-gathers the wo and w2 partial sums (dim elements each) a layer and
    the logits (vocab/tp) once a token; sp > 1 adds the query broadcast and
    LSE merge of sequence-parallel attention. Bytes are sent + received per
    chip. The measured counterpart is a rank's count of its collectives'
    result bytes (parallel/collectives.TPExchange, read by
    ``InferenceEngine.measured_collective_report``). The sp term is JAX's
    as it stands: it counts kv heads, where the LSE merge's partials are
    the query heads' (the measured "sp:all-reduce" is a layer's
    n_heads/tp row maxima and n_heads/tp (head_size + 1) numerators and
    denominators, f32); the two are printed side by side, not reconciled."""
    per_chip = 0.0
    if tp > 1:
        per_layer = 2 * 2 * (cfg.dim / tp) * (tp - 1) * exchange_bytes
        per_chip += cfg.n_layers * per_layer
        per_chip += 2 * (cfg.vocab_size / tp) * (tp - 1) * 4.0 / tp  # f32 logits gather
    if sp > 1:
        per_chip += 2 * cfg.n_layers * (cfg.n_kv_heads * (cfg.head_size + 2)) * 4.0 * (sp - 1) / sp
    return {
        "bytes_per_token_per_chip": per_chip,
        "kb_per_token_per_chip": per_chip / 1024.0,
        "tp": tp,
        "sp": sp,
        "exchange_bytes_per_elem": exchange_bytes,
    }


def _tensors(obj):
    """Every tensor reachable from a params tree (dicts, lists, tuples and
    the packed-weight dataclasses, whose fields are tensors)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            yield from _tensors(v)


def params_nbytes(params) -> int:
    """Bytes of the storages the params tree holds, each storage counted
    once (a stacked weight's per-layer views, or fused weights that alias
    their parts, are not counted twice)."""
    seen: dict[int, int] = {}
    for t in _tensors(params):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def cache_nbytes(cache) -> int:
    return cache.k.numel() * cache.k.element_size() + cache.v.numel() * cache.v.element_size()


def set_memory_gauges(params, cache) -> tuple[int, int]:
    """Publish the device-memory accounting as gauges (model_params_bytes /
    kv_cache_bytes), queryable at /metrics and in the /health payload.
    Returns (params_bytes, cache_bytes)."""
    pb, cb = params_nbytes(params), cache_nbytes(cache)
    ins.MODEL_PARAMS_BYTES.set(pb)
    ins.KV_CACHE_BYTES.set(cb)
    return pb, cb


def memory_report(cfg, params, cache) -> str:
    """Device-memory accounting (nn-core.cpp:152-166 role)."""
    pb = params_nbytes(params)
    cb = cache_nbytes(cache)
    shape = tuple(cache.k.shape)
    return (
        f"💿 params {pb / 1e9:.2f} GB, kv-cache {cb / 1e9:.2f} GB "
        f"(cache {shape[1]} x {shape[3]} rows), total {(pb + cb) / 1e9:.2f} GB"
    )
