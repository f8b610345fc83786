"""Decode and prefill chunks as device programs: the port's counterpart of
the JAX package's jitted steps, one program per static shape as JAX's jit
compiles one.

* A **decode program** is the ``lax.scan`` decode chunk
  (``dllama_tpu/engine/engine.py`` ``_decode_n_impl`` and its sampled and
  penalized forms, and the fused scans behind
  ``BatchEngine.decode_dispatch``): an n-step body of one variant (greedy,
  sampled, penalized), keyed (variant, n).
* A **prefill program** is one prompt chunk of a static token width (the
  single engine's ``_step``, ``BatchEngine.add_step``'s slot prefill and the
  prefill half of a hybrid step), keyed ("prefill", width, layout): the
  position (and on the batched tier the slot) is a device input, so one
  program serves every position, and on the paged layout every slot.
* A **spec program** is a run of speculative verify cycles
  (engine/speculative.py): on the batched tier the JAX package's fused
  spec chunk of n cycles (``_spec_step_impl``/``_spec_step_pen_impl``),
  keyed ("spec" | "spec_pen", n); on the single engine m cycles of
  ``make_spec_decode``'s loop body with the loop condition evaluated on
  the device, keyed ("single_spec", k, m, ngram).

Each :class:`Program` runs over static buffers: the body reads tensors that
the engine owns and refills in place (the fed tokens, the positions,
uniforms, the per-slot vectors, the block tables, the counter-based
generator's state) and writes its outputs (tokens and NaN flags, or the
last position's logits) into tensors made for it by the normal allocator,
outside the pool the engine's graphs share, so that no other program's
replay can overwrite an output that has not been copied out yet. A
program's own next replay does overwrite it: the engine copies a prefill
program's logits out (a device clone, in stream order) before it returns.

On a CUDA device with capture on, the first :meth:`Program.run` warms the
body once on the capture stream and puts back the engine state it moved
(``state``), then captures the body with ``torch.cuda.graph``; every run
replays the graph and adds the kernel launches the capture recorded to the
wrappers' counts (:func:`replayed`). :meth:`Program.prepare` captures
without replaying (``BatchEngine.warmup``). A capture or replay error
raises: nothing falls back to launching the body from Python. On the CPU,
or with capture off, run() calls the body.

The warm-up also writes KV rows, at or past each live row's position: the
replay writes the same rows before any forward reads them, so those need
no putting back. It loads the kernel libraries and sizes the decode
matmuls' split-k scratch, which ``ops.q40_matmul.decode_scratch`` keeps per
stream, before the capture records their pointers: a decode step, and a
prefill chunk of at most 16 tokens, run K1 (or K5) on the decode route.

Module globals that the body reads when it runs are fixed in a graph at
capture (:func:`knobs`); :class:`Programs` keys each program on them, so a
changed knob captures another program instead of replaying a stale route.

Every capture is recorded in the capture ledger (``obs/compile.LEDGER``,
the port's counterpart of the JAX package's compile ledger) under its
function label and bucket key (:meth:`Programs.label`), with its seconds.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Sequence

import torch

from dllama_tpu_torch.engine import sampling
from dllama_tpu_torch.obs import compile as compile_obs
from dllama_tpu_torch.ops import (
    flash_attention,
    layers,
    paged_attention,
    q40_matmul,
    q80_matmul,
    rms_norm,
)
from dllama_tpu_torch.utils.profiling import GRAPH_GATE

#: the decode programs' variants (the JAX package's three scans)
VARIANTS = ("greedy", "sampled", "penalized")
#: the batched tier's spec programs' variants (the JAX package's two spec scans)
SPEC_VARIANTS = ("spec", "spec_pen")


def knobs() -> tuple:
    """The module globals a program's body reads when it runs: the Q40
    style and its tiles, K4's split count, the RMSNorm route and the
    nucleus width."""
    return (q40_matmul.STYLE, q40_matmul.BLOCKDOT_TK, q40_matmul.BLOCKDOT_TN,
            q40_matmul.LOOPDOT_SPLITS, layers.RMS_NORM_IMPL, sampling.NUCLEUS_K)


def launch_tables() -> tuple[dict, ...]:
    """The launch counters of every kernel wrapper a program's body can call."""
    return (q40_matmul.LAUNCHES, q80_matmul.LAUNCHES, flash_attention.LAUNCHES,
            paged_attention.LAUNCHES, rms_norm.LAUNCHES)


def launch_delta(before: Sequence[dict], after: Sequence[dict]) -> tuple[dict, ...]:
    """Per counter table, the launches made between two snapshots (the
    keys that moved only)."""
    return tuple({k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
                 for b, a in zip(before, after))


def replayed(counts: dict, delta: dict, times: int = 1) -> dict:
    """The counts after `times` replays of a program whose capture recorded
    `delta` (a pure function: the caller stores the result)."""
    return {k: n + times * delta.get(k, 0) for k, n in counts.items()}


_STREAMS: dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one capture stream of a device, shared by every program: the
    warm-up runs on it, so the split-k scratch it sizes is the one the
    capture records."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _STREAMS.get(index)
    if stream is None:
        stream = _STREAMS[index] = torch.cuda.Stream(device=device)
    return stream


class Program:
    """One decode or prefill body over static buffers (``buffers``: its own
    inputs and outputs by name; ``state``: the engine tensors it moves)."""

    def __init__(self, body: Callable[[], None], buffers: dict, state: Sequence[torch.Tensor],
                 device: torch.device, capture: bool, pool=None,
                 label: tuple[str, str] | None = None):
        self.body = body
        self.label = label  # (ledger fn, bucket key) of its capture
        self.buffers = buffers
        self.state = tuple(state)
        self.device = device
        self.capture = capture
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: tuple[dict, ...] = ()  # recorded at capture, added per replay
        self.capture_s = 0.0

    @property
    def ready(self) -> bool:
        """True once run() replays (always true without capture)."""
        return not self.capture or self.graph is not None

    def prepare(self) -> None:
        """Capture now, without replaying (a no-op without capture or once
        captured). The warm-up writes what the body writes: the caller
        points the inputs at rows nothing reads."""
        if self.capture and self.graph is None:
            self._capture()

    def run(self) -> None:
        if not self.capture:
            self.body()
            return
        self.prepare()
        with GRAPH_GATE:  # never beside a profiler's start or stop
            self.graph.replay()
        for table, delta in zip(launch_tables(), self.launches):
            table.update(replayed(table, delta))

    def _capture(self) -> None:
        # no cyclic garbage collection while capturing: a collection on the
        # capturing thread that frees another engine's graphs destroys them
        # mid-capture, which the driver refuses and which invalidates the
        # capture (torch's graph context no longer collects first)
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with GRAPH_GATE:  # never beside a profiler's start or stop
                self._capture_graph()
        finally:
            if gc_on:
                gc.enable()

    def _capture_graph(self) -> None:
        t_mono, t0 = time.monotonic(), time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        stream = capture_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            saved = [t.clone() for t in self.state]
            self.body()
            for t, old in zip(self.state, saved):
                t.copy_(old)
        main.wait_stream(stream)
        tables = launch_tables()
        before = [dict(t) for t in tables]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.body()
        after = [dict(t) for t in tables]
        for table, counts in zip(tables, before):
            table.update(counts)  # a capture launches nothing
        self.launches = launch_delta(before, after)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        if self.label is not None:
            compile_obs.LEDGER.record_capture(*self.label, self.capture_s, t_mono,
                                              sig=compile_obs.sig_of(*self.buffers.values()))


Maker = Callable[..., tuple[Callable[[], None], dict, Sequence]]


class Programs:
    """An engine's device programs: decode programs keyed (variant, n,
    knobs()) and prefill programs keyed ("prefill", width, layout,
    knobs()). With ``capture`` None, capture is on exactly when the device
    is CUDA; it is an error on another device. ``tier`` ("batch" or
    "single") picks the capture ledger's function labels."""

    def __init__(self, device, capture: bool | None = None, tier: str = "batch"):
        if tier not in ("batch", "single"):
            raise ValueError(f"tier must be batch|single, got {tier!r}")
        self.tier = tier
        self.device = torch.device(device)
        if capture is None:
            capture = self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError(f"CUDA-graph capture needs a CUDA device, not {self.device}")
        self.capture = bool(capture)
        self._pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._progs: dict[tuple, Program] = {}

    def label(self, key: tuple) -> tuple[str, str]:
        """(ledger fn, bucket key) of the program keyed `key` (without the
        knobs), in obs/compile.COMPILE_FNS's grammar: decode and batched
        spec programs n{n}, prefill programs m{width}, the single engine's
        spec programs k{k}.m{m}."""
        single = self.tier == "single"
        if key[0] == "prefill":
            fn = "single_step" if single else "prefill_chunk"
            bucket = f"m{key[1]}"
        elif key[0] == "single_spec":
            fn, bucket = key[0], f"k{key[1]}.m{key[2]}"
        elif key[0] in SPEC_VARIANTS:
            fn, bucket = key[0], f"n{key[1]}"
        else:
            fn = ("single_decode" if single
                  else "decode_pen" if key[0] == "penalized" else "decode")
            bucket = f"n{key[1]}"
        return fn, bucket

    def _get(self, key: tuple, make: Maker, *args) -> Program:
        full = key + (knobs(),)
        prog = self._progs.get(full)
        if prog is None:
            body, buffers, state = make(*args)
            prog = self._progs[full] = Program(body, buffers, state, self.device,
                                               self.capture, self._pool, self.label(key))
        return prog

    def get(self, variant: str, n: int, make: Maker) -> Program:
        """The decode (or batched spec) program of (variant, n) under the
        current knobs; ``make(variant, n)`` builds (body, buffers, state)
        the first time."""
        if variant not in VARIANTS + SPEC_VARIANTS:
            raise ValueError(f"unknown decode variant {variant!r} (one of "
                             f"{VARIANTS + SPEC_VARIANTS})")
        return self._get((variant, int(n)), make, variant, int(n))

    def spec(self, k: int, m: int, ngram: int, make: Maker) -> Program:
        """The single engine's spec program of m cycles at draft length k
        under the current knobs; ``make(k, m, ngram)`` builds (body,
        buffers, state) the first time."""
        return self._get(("single_spec", int(k), int(m), int(ngram)), make, int(k), int(m),
                         int(ngram))

    def prefill(self, width: int, layout, make: Maker) -> Program:
        """The prefill program of `width` tokens on `layout` (a hashable the
        engine names its cache view by) under the current knobs;
        ``make(width, layout)`` builds (body, buffers, state) the first
        time."""
        return self._get(("prefill", int(width), layout), make, int(width), layout)

    def find(self, variant: str, n: int) -> Program | None:
        """The (variant, n) decode program under the current knobs, if built."""
        return self._progs.get((variant, int(n), knobs()))

    def ready(self, variant: str, n: int) -> bool:
        """True when the (variant, n) decode program under the current knobs
        runs without a capture."""
        prog = self.find(variant, n)
        return prog is not None and prog.ready

    def prefill_ready(self, width: int, layout) -> bool:
        """True when the prefill program of (width, layout) under the
        current knobs runs without a capture."""
        prog = self._progs.get(("prefill", int(width), layout, knobs()))
        return prog is not None and prog.ready

    def stats(self) -> dict:
        """Programs built, graphs captured and the seconds the captures took."""
        graphs = [p for p in self._progs.values() if p.graph is not None]
        return {"programs": len(self._progs), "graphs": len(graphs),
                "capture_s": sum(p.capture_s for p in graphs)}
