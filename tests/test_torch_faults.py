"""Supervision in the port: fault injection (``utils/faults.py``), the stall
watchdog, warm restart and its budget, the NaN guard and per-request
deadlines, and the loader's fault point, ported from the JAX suite's
``tests/test_faults.py`` and held against the JAX package where the same
inputs go through both:

* ``faults.parse`` gives the JAX module's entries and errors on the same
  specs;
* a warm-restarted greedy stream's ids equal the JAX scheduler's under the
  same crash on the same tiny model;
* ``warm_restart`` keeps the address of every tensor a captured program
  reads (the CPU-checkable form of the rule that a restart refills in place
  and recaptures nothing), on both layouts, with the spec history, the
  penalty counts and the host tier.

The tiny model is the JAX tests' (dim 64, 2 layers, vocab 96, context 64,
random f32 weights from seed 2), on the port's paged default (page 8) unless
a test says otherwise.
"""

import http.client
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.obs import metrics
from dllama_tpu_torch.serve.scheduler import QueueFull, Scheduler, SchedulerUnhealthy
from dllama_tpu_torch.utils import faults

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
TINY = LlamaConfig(**KW)
PAGE = 8


@pytest.fixture(autouse=True)
def _clean_faults():
    """No fault plan leaks between tests (or into other files)."""
    from dllama_tpu.utils import faults as jax_faults

    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def jparams():
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    return random_params(JaxConfig(**KW), seed=2, dtype=jnp.float32, quantize=False)


@pytest.fixture(scope="module")
def params(jparams):
    import jax

    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def make_engine(params, n_slots=2, layout="paged", **kw):
    lay = dict(kv_layout="paged", page_size=PAGE) if layout == "paged" else {}
    eng = BatchEngine(TINY, params, n_slots=n_slots, cache_dtype=torch.float32,
                      max_prefill_chunk=8, **lay, **kw)
    if eng.pool is not None:
        eng.pool.audit_on_release = True
    return eng


def make_sched(params, n_slots=2, layout="paged", restart_backoff_s=None, engine_kw=None,
               **kw):
    sched = Scheduler(make_engine(params, n_slots, layout, **(engine_kw or {})), **kw)
    if restart_backoff_s is not None:
        sched.restart_backoff_s = restart_backoff_s
    return sched


def drain_tokens(req, timeout=5.0):
    """Consume a request's queue with a hard deadline (req.tokens() would
    block forever: the hang supervision exists to prevent) -> (tokens,
    exception or None)."""
    toks, deadline = [], time.monotonic() + timeout
    while True:
        item = req.out.get(timeout=max(0.01, deadline - time.monotonic()))
        if isinstance(item, BaseException):
            return toks, item
        if isinstance(item, int):
            toks.append(item)
        else:  # the end sentinel
            return toks, None


def _sample(name, labels=None):
    return metrics.REGISTRY.sample(name, labels) or 0.0


# ------------------------------------------------------------- faults unit


def test_fault_spec_parse_and_windows():
    fs = faults.parse("engine.decode:raise:after=2:times=1, scheduler.queue:delay:ms=7")
    assert fs[0].point == "engine.decode" and fs[0].after == 2 and fs[0].times == 1
    assert fs[1].action == "delay" and fs[1].ms == 7.0
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.parse("nope.where:raise")
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.parse("engine.decode:explode")
    with pytest.raises(ValueError, match="unknown fault option"):
        faults.parse("engine.decode:raise:frobnicate=1")
    # after=1, times=1: hit 0 skipped, hit 1 fires, hit 2 on disarmed
    faults.install("engine.prefill", "raise", after=1, times=1)
    faults.fire("engine.prefill")
    with pytest.raises(faults.InjectedFault):
        faults.fire("engine.prefill")
    faults.fire("engine.prefill")
    assert not faults.pending("engine.prefill") and faults.active("engine.prefill")
    # flag(): a raise fault fires as True instead of raising; delay sleeps
    faults.install("decode.nan", "raise", times=1)
    assert faults.flag("decode.nan") and not faults.flag("decode.nan")


SPECS = ["engine.decode:raise:after=2:times=1, scheduler.queue:delay:ms=7",
         "decode.nan:raise", "pool.spill:delay:ms=1.5:times=3,router.proxy:raise:after=4",
         "", "loader.read:raise,engine.restart:raise:times=2",
         "nope.where:raise", "engine.decode:explode", "engine.decode:raise:frobnicate=1",
         "engine.decode"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_parse_equals_jax(spec):
    """The port's parse gives the JAX module's entries (or its error) on the
    same spec, and both know the same points and actions."""
    from dllama_tpu.utils import faults as jax_faults

    def run(mod):
        try:
            return [(f.point, f.action, f.ms, f.after, f.times) for f in mod.parse(spec)]
        except ValueError as e:
            return ("error", str(e))

    assert run(faults) == run(jax_faults)
    assert faults.POINTS == jax_faults.POINTS and faults.ACTIONS == jax_faults.ACTIONS


def test_fault_env_configure(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "scheduler.loop:raise:after=1000000")
    faults.configure_from_env()
    assert faults.active("scheduler.loop")
    faults.configure(None)
    assert not faults.active("scheduler.loop")


def test_fault_fires_are_counted():
    before = _sample("dllama_fault_fires_total", {"point": "pool.alloc", "action": "raise"})
    faults.install("pool.alloc", "raise", times=2)
    for _ in range(3):
        try:
            faults.fire("pool.alloc")
        except faults.InjectedFault:
            pass
    assert _sample("dllama_fault_fires_total",
                   {"point": "pool.alloc", "action": "raise"}) == before + 2


# ------------------------------------------------------- crash supervision


def test_worker_crash_fails_all_inflight_and_health_goes_unhealthy(params):
    """Without a restart budget, a decode crash fails every in-flight and
    queued request within 2 s (no hung client) and /health goes unhealthy;
    a dead worker refuses new work."""
    sched = make_sched(params, n_slots=1)
    try:
        warm = sched.submit([9, 8, 7], 0.0, 0.9, 3, frozenset(), seed=0)
        assert drain_tokens(warm, timeout=60.0)[1] is None
        faults.install("engine.decode", "raise")
        t0 = time.monotonic()
        running = sched.submit([1, 2, 3], 0.0, 0.9, 50, frozenset(), seed=1)
        queued = sched.submit([4, 5], 0.0, 0.9, 50, frozenset(), seed=2)
        _, exc1 = drain_tokens(running, timeout=2.0)
        _, exc2 = drain_tokens(queued, timeout=2.0)
        assert time.monotonic() - t0 < 2.0
        assert isinstance(exc1, faults.InjectedFault) and isinstance(exc2, faults.InjectedFault)
        assert running.finish_reason == queued.finish_reason == "error"
        h = sched.health()
        assert h["live"] is False and h["ready"] is False and h["restarts"] == 0
        assert h["crashed"] and "InjectedFault" in h["crashed"]
        with pytest.raises(SchedulerUnhealthy):
            sched.submit([1], 0.0, 0.9, 4, frozenset())
    finally:
        faults.clear()
        sched.shutdown()


@pytest.mark.parametrize("budget", ["auto", 0])
def test_prefill_fault_fails_only_that_request(params, budget):
    """An admission failure is per request: the joiner errors, the running
    stream keeps decoding, /health stays live. Under hybrid admission the
    fault fires in hybrid_dispatch before any state moves, and the batch
    gets a plain chunk instead."""
    sched = make_sched(params, n_slots=2, prefill_budget=budget)
    try:
        r1 = sched.submit([1, 2, 3], 0.0, 0.9, 30, frozenset(), seed=1)
        it = r1.tokens()
        first = [next(it), next(it)]
        faults.install("engine.prefill", "raise", times=1)
        r2 = sched.submit([7, 8, 9], 0.0, 0.9, 8, frozenset(), seed=2)
        _, exc2 = drain_tokens(r2, timeout=10.0)
        assert isinstance(exc2, faults.InjectedFault) and r2.finish_reason == "error"
        assert len(first) + len(list(it)) == 30 and r1.finish_reason == "length"
        assert sched.health()["live"] is True
        assert sched.engine.pool.audit()["ok"]
    finally:
        faults.clear()
        sched.shutdown()


def test_pool_alloc_fault_fails_one_admission(params):
    """pool.alloc at an admission's page allocation fails that request only."""
    sched = make_sched(params, n_slots=2)
    try:
        faults.install("pool.alloc", "raise", times=1)
        r = sched.submit([1, 2, 3], 0.0, 0.9, 4, frozenset(), seed=1)
        _, exc = drain_tokens(r, timeout=10.0)
        assert isinstance(exc, faults.InjectedFault) and r.finish_reason == "error"
        ok = sched.submit([1, 2, 3], 0.0, 0.9, 4, frozenset(), seed=1)
        toks, exc = drain_tokens(ok, timeout=10.0)
        assert exc is None and len(toks) == 4
        assert sched.health()["live"] is True and sched.engine.pool.audit()["ok"]
    finally:
        faults.clear()
        sched.shutdown()


def test_injected_queue_overflow(params):
    """scheduler.queue forces the shed path (the API's 429), once."""
    sched = make_sched(params, n_slots=2)
    try:
        shed0 = _sample("dllama_requests_shed_total", {"reason": "queue_full"})
        faults.install("scheduler.queue", "raise", times=1)
        with pytest.raises(QueueFull):
            sched.submit([1, 2], 0.0, 0.9, 4, frozenset())
        assert _sample("dllama_requests_shed_total", {"reason": "queue_full"}) == shed0 + 1
        toks, exc = drain_tokens(sched.submit([1, 2], 0.0, 0.9, 4, frozenset()), 30.0)
        assert exc is None and len(toks) == 4
    finally:
        faults.clear()
        sched.shutdown()


# ---------------------------------------------------------------- watchdog


def test_watchdog_flags_stall_and_recovers(params):
    """A decode chunk delayed past the deadline flips health to stalled
    (live false, new work shed); when it lands the flag clears and the
    request completes; both transitions are counted."""
    stalls0 = _sample("dllama_watchdog_stalls_total")
    rec0 = _sample("dllama_watchdog_recoveries_total")
    sched = make_sched(params, n_slots=1, stall_deadline_s=0.15)
    try:
        warm = sched.submit([9, 8], 0.0, 0.9, 2, frozenset())
        assert drain_tokens(warm, timeout=30.0)[1] is None
        deadline = time.monotonic() + 3.0
        while sched.stalled and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not sched.stalled
        faults.install("engine.decode", "delay", ms=700.0, times=1)
        req = sched.submit([1, 2, 3], 0.0, 0.9, 6, frozenset())
        saw = False
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            h = sched.health()
            if h["stalled"]:
                saw = True
                assert h["live"] is False
                with pytest.raises(SchedulerUnhealthy, match="stalled"):
                    sched.submit([5], 0.0, 0.9, 2, frozenset())
                break
            time.sleep(0.01)
        assert saw, "the watchdog never flagged the delayed chunk"
        toks, exc = drain_tokens(req, timeout=5.0)
        assert exc is None and len(toks) == 6
        deadline = time.monotonic() + 2.0
        while sched.health()["stalled"] and time.monotonic() < deadline:
            time.sleep(0.01)
        h = sched.health()
        assert h["stalled"] is False and h["live"] is True and h["stall_count"] >= 1
        assert _sample("dllama_watchdog_stalls_total") >= stalls0 + h["stall_count"]
        assert _sample("dllama_watchdog_recoveries_total") >= rec0 + 1
    finally:
        faults.clear()
        sched.shutdown()


def test_shutdown_join_timeout_is_surfaced(params, caplog):
    """shutdown() with the worker inside a delayed chunk: a warning, and
    /health says join_failed and live false."""
    sched = make_sched(params, n_slots=1)
    sched.join_timeout_s = 0.05
    try:
        faults.install("engine.decode", "delay", ms=600.0, times=1)
        sched.submit([1, 2, 3], 0.0, 0.9, 4, frozenset())
        time.sleep(0.15)
        with caplog.at_level(logging.WARNING, logger="dllama_tpu_torch.serve"):
            sched.shutdown()
        assert sched.join_failed is True
        assert any("failed to join" in r.message for r in caplog.records)
        h = sched.health()
        assert h["live"] is False and h["join_failed"] is True
    finally:
        faults.clear()
        sched._thread.join(timeout=5.0)


# ------------------------------------------------------------ warm restart

CASES = {"greedy": ([1, 2, 3, 4, 5], dict(temperature=0.0, seed=5)),
         "sampled": ([7, 8, 9], dict(temperature=1.0, seed=11)),
         "penalized": ([4, 4, 2], dict(temperature=0.0, seed=3, presence=0.5,
                                        frequency=0.3))}


def _submit(sched, case, max_tokens):
    prompt, kw = CASES[case]
    kw = dict(kw)
    return sched.submit(prompt, kw.pop("temperature"), 0.9, max_tokens, frozenset(), **kw)


def _reference(params, layout, max_tokens=24):
    ref = make_sched(params, n_slots=3, layout=layout)
    try:
        out = {}
        for case in CASES:
            toks, exc = drain_tokens(_submit(ref, case, max_tokens), timeout=60.0)
            assert exc is None
            out[case] = toks
        return out
    finally:
        ref.shutdown()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_warm_restart_resumes_streams_bit_exact(params, layout):
    """With a restart budget, a scheduler.loop crash mid-stream warm-restarts
    the engine in place: the greedy, sampled and penalized streams resume
    bit-equal to uninterrupted runs, a queued request survives untouched,
    /health is live and ready again, and the restart and recovery counters
    move."""
    ref = _reference(params, layout)
    restarts0 = _sample("dllama_engine_restarts_total")
    recov0 = _sample("dllama_requests_recovered_total")
    sched = make_sched(params, n_slots=3, layout=layout, restart_max=2, restart_backoff_s=0.01)
    try:
        reqs = {case: _submit(sched, case, 24) for case in CASES}
        it = reqs["greedy"].tokens()
        head = [next(it) for _ in range(4)]
        queued = sched.submit([4, 5, 6], 0.0, 0.9, 4, frozenset(), seed=3)
        faults.install("scheduler.loop", "raise", times=1)
        got = {"greedy": head + list(it)}
        for case in ("sampled", "penalized"):
            toks, exc = drain_tokens(reqs[case], timeout=30.0)
            assert exc is None
            got[case] = toks
        toks_q, exc_q = drain_tokens(queued, timeout=30.0)
        assert got == ref
        assert exc_q is None and len(toks_q) == 4
        h = sched.health()
        assert h["live"] is True and h["ready"] is True
        assert h["restarts"] == 1 and h["crashed"] is None and h["recovering"] == 0
        assert _sample("dllama_engine_restarts_total") == restarts0 + 1
        assert _sample("dllama_requests_recovered_total") >= recov0 + 1
        if sched.engine.pool is not None:
            assert sched.engine.pool.audit()["ok"]
    finally:
        faults.clear()
        sched.shutdown()


def _crash_until(sched, n, deadline_s=30.0):
    """Arm scheduler.loop and wait until THIS scheduler restarted n times (a
    plan is process-global: re-arm when another worker took the fire)."""
    faults.install("scheduler.loop", "raise", times=1)
    deadline = time.monotonic() + deadline_s
    while sched.health()["restarts"] < n:
        if not faults.pending("scheduler.loop"):
            faults.install("scheduler.loop", "raise", times=1)
        assert time.monotonic() < deadline, f"restart {n} never happened"
        time.sleep(0.01)


def test_second_warm_restart_still_bit_exact(params):
    """Two crashes inside one sampled stream: the resume record is rebuilt
    from the tokens emitted by then (counter = tokens emitted), so the
    stream stays bit-equal across both."""
    ref = make_sched(params, n_slots=1)
    try:
        ref_toks, exc = drain_tokens(ref.submit([7, 8, 9], 1.0, 0.9, 48, frozenset(),
                                                seed=11), timeout=60.0)
        assert exc is None and len(ref_toks) == 48
    finally:
        ref.shutdown()
    sched = make_sched(params, n_slots=1, restart_max=20, restart_backoff_s=0.01)
    try:
        faults.install("engine.decode", "delay", ms=20.0)
        s = sched.submit([7, 8, 9], 1.0, 0.9, 48, frozenset(), seed=11)
        it = s.tokens()
        got = [next(it) for _ in range(4)]
        _crash_until(sched, 1)
        got += [next(it) for _ in range(6)]
        _crash_until(sched, 2)
        rest, exc = drain_tokens(s, timeout=60.0)
        assert exc is None and got + rest == ref_toks
        assert sched.health()["restarts"] >= 2
    finally:
        faults.clear()
        sched.shutdown()


def test_restart_budget_exhausted_goes_permanently_unhealthy(params):
    """restart_max 1 and two crashes in the window: the second fails the
    stream and leaves /health live false for good; submit refuses."""
    sched = make_sched(params, n_slots=1, restart_max=1, restart_backoff_s=0.01)
    try:
        req = sched.submit([1, 2, 3], 0.0, 0.9, 50, frozenset(), seed=1)
        next(req.tokens())
        faults.install("scheduler.loop", "raise", times=2)
        _, exc = drain_tokens(req, timeout=10.0)
        assert isinstance(exc, faults.InjectedFault) and req.finish_reason == "error"
        deadline = time.monotonic() + 5.0
        while sched.crashed is None and time.monotonic() < deadline:
            time.sleep(0.01)
        h = sched.health()
        assert h["live"] is False and h["restarts"] == 1
        with pytest.raises(SchedulerUnhealthy):
            sched.submit([1], 0.0, 0.9, 2, frozenset())
    finally:
        faults.clear()
        sched.shutdown()


def test_engine_restart_fault_kills_restart(params):
    """A restart that itself dies (engine.restart) ends supervision: live
    false, the restart's error recorded."""
    faults.install("scheduler.loop", "raise", times=1)
    faults.install("engine.restart", "raise", times=1)
    sched = make_sched(params, n_slots=1, restart_max=3, restart_backoff_s=0.01)
    try:
        deadline = time.monotonic() + 5.0
        while sched.crashed is None and time.monotonic() < deadline:
            time.sleep(0.01)
        h = sched.health()
        assert h["live"] is False and h["crashed"] and "engine.restart" in h["crashed"]
    finally:
        faults.clear()
        sched.shutdown()


def _program_tensors(eng):
    """name -> data_ptr of every engine tensor a program reads, and of every
    captured-program buffer."""
    out = {k: v.data_ptr() for k, v in eng.device_state().items()}
    for key, prog in eng.programs._progs.items():
        for name, buf in prog.buffers.items():
            out[f"{key}/{name}"] = buf.data_ptr()
    return out


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_warm_restart_keeps_every_program_address(params, layout):
    """warm_restart refills in place: the address of every tensor the
    decode, prefill and spec programs read (the cache, the tables, the slot
    vectors, the generator rows, the penalty counts, the spec history, the
    host tier's slab) is unchanged, and the engine serves bit-equal tokens
    afterwards as a fresh engine does."""
    kw = dict(spec=2)
    if layout == "paged":
        kw.update(radix_cache="on", kv_host_pages=4)
    eng = make_engine(params, n_slots=2, layout=layout, **kw)
    for slot, pen in ((0, 0.0), (1, 0.5)):
        adm = eng.add_begin(slot, [1, 2, 3, 4, 5, 6, 7, 8, 9])
        while not eng.add_step(adm):
            pass
        eng.add_commit(adm, 0.0, 0.9, seed=slot, presence=pen)
    eng.decode(3)
    eng.decode_consume(eng.decode_dispatch(2, spec=True))
    before = _program_tensors(eng)
    host = eng.pool.host if eng.pool is not None else None
    slab = (host.k.data_ptr(), host.v.data_ptr()) if host is not None else None
    eng.warm_restart()
    assert _program_tensors(eng) == before
    if host is not None:
        assert eng.pool.host is host and (host.k.data_ptr(), host.v.data_ptr()) == slab
        assert host.used == 0 and eng.pool.audit()["ok"]
        assert eng.radix is not None and eng.radix.stats()["nodes"] == 0
    assert not eng.active.any() and int(eng.pos.max()) == 0
    assert int(eng.history.max()) == -1

    def stream(e):
        adm = e.add_begin(0, [3, 1, 4, 1, 5])
        while not e.add_step(adm):
            pass
        first = e.add_commit(adm, 0.0, 0.9, seed=0)
        return [first] + e.decode(6)[:, 0].tolist()

    assert stream(eng) == stream(make_engine(params, n_slots=2, layout=layout, **kw))


def test_warm_restart_greedy_equals_jax_scheduler(params, jparams):
    """The same crash (scheduler.loop, once, after the stream's fourth
    token) in the port's scheduler and in the JAX package's: the resumed
    greedy streams carry the same ids (and each equals its uninterrupted
    run)."""
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine
    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler
    from dllama_tpu.utils import faults as jax_faults

    def run(sched, mod):
        try:
            req = sched.submit([1, 2, 3, 4, 5], 0.0, 0.9, 20, frozenset(), seed=5)
            it = req.tokens()
            head = [next(it) for _ in range(4)]
            mod.install("scheduler.loop", "raise", times=1)
            out = head + list(it)
            assert sched.health()["restarts"] == 1
            return out
        finally:
            mod.clear()
            sched.shutdown()

    jeng = JaxEngine(JaxConfig(**KW), jparams, n_slots=2, cache_dtype=jnp.float32,
                     kv_layout="paged", page_size=PAGE)
    jax_ids = run(JaxScheduler(jeng, chunk=4, restart_max=2, restart_backoff_s=0.01),
                  jax_faults)
    port_ids = run(make_sched(params, n_slots=2, restart_max=2, restart_backoff_s=0.01),
                   faults)
    assert port_ids == jax_ids


# ------------------------------------------------- the host tier's points


def test_spill_and_restore_faults_degrade_to_reprefill(params):
    """pool.spill turns an eviction into the plain discard and pool.restore
    a restore into a re-prefill: either way the stream is the same tokens
    and the pool audits clean."""
    def serve(point):
        sched = make_sched(params, n_slots=1, engine_kw=dict(kv_pages=6, kv_host_pages=8))
        try:
            a = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17]
            first = drain_tokens(sched.submit(a, 0.0, 0.9, 4, frozenset()), 30.0)[0]
            if point == "pool.spill":
                faults.install(point, "raise")
            # another long prompt evicts a's pages from the six-page pool
            drain_tokens(sched.submit([40 + i for i in range(30)], 0.0, 0.9, 4,
                                      frozenset()), 30.0)
            if point == "pool.restore":
                faults.install(point, "raise")
            again, exc = drain_tokens(sched.submit(a, 0.0, 0.9, 4, frozenset()), 30.0)
            assert exc is None and sched.engine.pool.audit()["ok"]
            return first, again, sched.engine.pool.host.stats()
        finally:
            faults.clear()
            sched.shutdown()

    first, again, st = serve(None)
    assert first == again and st["spilled"] > 0 and st["restored"] > 0
    first, again, st = serve("pool.spill")
    assert first == again and st["spilled"] == 0 and st["restored"] == 0
    first, again, st = serve("pool.restore")
    assert first == again and st["spilled"] > 0 and st["restored"] == 0


# ---------------------------------------------------------- transfer guard


def test_transfer_guard_modes_on_the_cpu(params):
    """--transfer-guard: an unknown mode raises at construction; on the CPU
    the guard is a no-op (nothing synchronizes), so a strict engine's
    streams equal an unguarded one's."""
    from dllama_tpu_torch.obs import compile as compile_obs

    with pytest.raises(ValueError, match="transfer_guard"):
        make_engine(params, transfer_guard="loud")
    with pytest.raises(ValueError, match="transfer_guard"):
        compile_obs.h2d_guard("loud", torch.device("cpu"))
    guard = compile_obs.h2d_guard("strict", torch.device("cpu"))
    assert guard.on is False and compile_obs.h2d_guard("log", torch.device("cuda")).on

    def stream(mode):
        sched = make_sched(params, n_slots=2, engine_kw=dict(transfer_guard=mode, spec=2))
        try:
            reqs = [sched.submit([5, 6, 7, 5, 6, 7], 0.0, 0.9, 12, frozenset(), seed=1),
                    sched.submit([1, 2], 0.8, 0.9, 12, frozenset(), seed=2)]
            return [list(r.tokens()) for r in reqs]
        finally:
            sched.shutdown()

    assert stream("strict") == stream("off")


# --------------------------------------- NaN guard + per-request deadlines


def test_nan_guard_and_deadlines_one_scheduler(params):
    """decode.nan fails one request ('error') and the engine stays live; a
    running request past timeout_s finishes 'timeout' at a boundary with its
    deadline fields; a request that expires queued is shed before prefill."""
    sched = make_sched(params, n_slots=1)
    try:
        r1 = sched.submit([1, 2, 3], 0.0, 0.9, 30, frozenset(), seed=1)
        it = r1.tokens()
        next(it)
        faults.install("decode.nan", "raise", times=1)
        _, exc1 = drain_tokens(r1, timeout=10.0)
        faults.clear()
        assert isinstance(exc1, RuntimeError) and "non-finite" in str(exc1)
        assert r1.finish_reason == "error" and sched.health()["live"] is True

        fin0 = _sample("dllama_requests_finished_total", {"reason": "timeout"})
        shed0 = _sample("dllama_requests_shed_total", {"reason": "timeout"})
        faults.install("engine.decode", "delay", ms=30.0)
        r2 = sched.submit([1, 2, 3], 0.0, 0.9, 10_000, frozenset(), timeout_s=0.4)
        toks2, exc2 = drain_tokens(r2, timeout=15.0)
        assert exc2 is None and r2.finish_reason == "timeout" and toks2
        t = r2.timings()
        assert t["timeout_s"] == 0.4 and t["deadline_exceeded"] is True
        runner = sched.submit([1, 2, 3], 0.0, 0.9, 40, frozenset())
        queued = sched.submit([4, 5], 0.0, 0.9, 5, frozenset(), timeout_s=0.2)
        toks_q, exc_q = drain_tokens(queued, timeout=15.0)
        assert exc_q is None and toks_q == [] and queued.finish_reason == "timeout"
        assert runner.finish_reason is None, "the queued deadline fires while the slot is busy"
        sched.cancel(runner)
        drain_tokens(runner, timeout=15.0)
        assert _sample("dllama_requests_finished_total", {"reason": "timeout"}) >= fin0 + 2
        assert _sample("dllama_requests_shed_total", {"reason": "timeout"}) == shed0 + 1
    finally:
        faults.clear()
        sched.shutdown()


# --------------------------------------------------------------- over HTTP


@pytest.fixture(scope="module")
def tpath(tmp_path_factory):
    from tests.test_torch_continuous_serve import _tokenizer_path

    return _tokenizer_path(tmp_path_factory)


def _req(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_http_crash_health_503(tpath):
    """A worker crash over HTTP: the in-flight completion gets a 500, not a
    hang; /health and /health/live answer 503 with the crash; new
    completions are shed with 503."""
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server
    from tests.test_golden import FIXTURE_M

    httpd, api = make_server(load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                        device="cpu"), n_slots=2, frontend="threads")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 16,
            "temperature": 0.0}
    try:
        faults.install("engine.decode", "raise", after=1)
        assert _req(port, "POST", "/v1/chat/completions", body)[0] == 500
        faults.clear()
        for path in ("/health", "/health/live"):
            st, data = _req(port, "GET", path)
            h = json.loads(data)
            assert st == 503 and h["live"] is False and "InjectedFault" in h["crashed"]
        assert _req(port, "POST", "/v1/chat/completions", body)[0] == 503
    finally:
        faults.clear()
        api.scheduler.shutdown()
        httpd.shutdown()
        httpd.server_close()


# ------------------------------------------------------------------ loader


def test_loader_truncated_file_is_actionable(tmp_path):
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.models.formats import ModelFileError
    from tests.test_golden import FIXTURE_M

    mpath = str(tmp_path / "cut.m")
    with open(FIXTURE_M, "rb") as f:
        raw = f.read()
    with open(mpath, "wb") as f:
        f.write(raw[:-1024])
    with pytest.raises(ModelFileError) as ei:
        load_model(mpath, device="cpu")
    msg = str(ei.value)
    assert "truncated" in msg and mpath in msg and f"{len(raw):,}" in msg


def test_loader_corrupt_magic_and_short_file(tmp_path):
    from dllama_tpu_torch.models.formats import ModelFileError, read_header

    bad = tmp_path / "bad.m"
    bad.write_bytes(b"\x37\x13\x00\x00" + b"\x00" * 64)
    with pytest.raises(ModelFileError, match="magic"):
        read_header(str(bad))
    short = tmp_path / "short.m"
    short.write_bytes(b"\x01\x02\x03")
    with pytest.raises(ModelFileError, match="8-byte"):
        read_header(str(short))


def test_loader_fault_point():
    from dllama_tpu_torch.models.formats import read_header
    from tests.test_golden import FIXTURE_M

    faults.install("loader.read", "raise", times=1)
    with pytest.raises(faults.InjectedFault):
        read_header(FIXTURE_M)
    cfg, _ = read_header(FIXTURE_M)  # disarmed
    assert cfg.dim == 64 and os.path.getsize(FIXTURE_M) > 0
