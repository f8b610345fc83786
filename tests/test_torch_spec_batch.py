"""Batched speculative decoding in the port (``BatchEngine(spec=K)``, the
spec programs, the scheduler's spec chunks, ``serve --slots N --spec-k K``)
against the JAX package's ``BatchEngine(spec=K)`` and its scheduler, on the
same tiny model (the JAX spec tests' configuration: dim 64, 2 layers, 4/2
heads, context 64, vocab 96; page 8). JAX's paged engine runs its gather
route on this jax (its Pallas paged kernel does not).

* Engine, lockstep: spec cycles and plain chunks interleaved over greedy,
  penalized-greedy and draft-length-limited slots give JAX's emitted rows,
  per-cycle counts, per-chunk ``advance`` and ``spec_stats()``, dense and
  paged; a radix-tree hit's backfilled history drafts as a cold prefill's.
* Scheduler: greedy streams (penalized greedy included) bit-equal to the JAX
  scheduler's with spec on and to the port's own with spec off, over overlap
  on/off x dense/paged x tree on/off; sampled and penalized batch-mates
  unchanged by speculation; per-request ``spec_k`` mixing and clamping; an
  EOS inside an accepted run rewinds; draft writes never land in a shared
  page; a row-limit-frozen slot advances under the overlap alternation; the
  ``dllama_spec_*`` series equal ``spec_stats()``, which equals JAX's; the
  emitted tokens are the requests' records plus the discarded overrun,
  exactly; a preempted spec stream resumes bit-equal to an uninterrupted
  one; the card smoke's lockstep check of spec against plain chunks passes
  and fails under a skewed generator counter; a worker crash mid-stream
  warm-restarts and resumes a greedy spec stream and a sampled batch-mate
  bit-equal, speculation still live after the restart.
* Entry points: ``serve --slots 2 --spec-k 4`` over HTTP on the golden model,
  both front ends: a body's ``spec_k`` reaches the scheduler and clamps,
  ``/debug/perf`` serves the spec stats and ``dllama_spec_*`` advance.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine, PoolAuditError
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.serve.scheduler import Scheduler

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
CFG = LlamaConfig(**KW)
PAGE = 8
#: a draftable prompt: the greedy continuation of a periodic pattern settles
#: into its own loop, so the n-gram proposer gets real acceptance
REP = [5, 6, 7, 5, 6, 7, 5, 6]


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jcfg = JaxConfig(**KW)
    jparams = random_params(jcfg, seed=3, dtype=jnp.float32, quantize=False)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _layout_kw(layout, radix="off"):
    if layout == "dense":
        return dict(kv_layout="dense")
    return dict(kv_layout="paged", page_size=PAGE, radix_cache=radix)


def _port_engine(models, spec=4, layout="dense", radix="off", n_slots=3, **kw):
    eng = BatchEngine(CFG, models[2], n_slots=n_slots, cache_dtype=torch.float32, spec=spec,
                      **_layout_kw(layout, radix), **kw)
    if eng.pool is not None:
        eng.pool.audit_on_release = True
    return eng


def _jax_engine(models, spec=4, layout="dense", radix="off", n_slots=3):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine

    return JaxEngine(models[0], models[1], n_slots=n_slots, cache_dtype=jnp.float32, spec=spec,
                     **_layout_kw(layout, radix))


def _sched(models, overlap=True, spec=4, layout="dense", radix="off", n_slots=3, **kw):
    return Scheduler(_port_engine(models, spec, layout, radix, n_slots), overlap=overlap, **kw)


def _jax_sched(models, overlap=True, spec=4, layout="dense", radix="off", n_slots=3):
    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler

    return JaxScheduler(_jax_engine(models, spec, layout, radix, n_slots), chunk=4,
                        overlap=overlap)


# ------------------------------------------------------------------ engine


def _admit(eng, slot, prompt, temperature=0.0, spec_k=None, **kw):
    adm = eng.add_begin(slot, prompt)
    while not eng.add_step(adm):
        pass
    return eng.add_commit(adm, temperature, 0.9, seed=slot + 1, spec_k=spec_k, **kw)


def _lockstep(eng, script):
    """Run `script` ("spec" n | "plain" n) on `eng`: per chunk its tokens,
    per-slot advance and per-cycle counts (spec)."""
    rec = []
    for kind, n in script:
        chunk = eng.decode_dispatch(n, spec=kind == "spec")
        toks = np.asarray(eng.decode_consume(chunk))
        cycles = None if chunk.adv_cycles is None else np.asarray(chunk.adv_cycles).tolist()
        rec.append((kind, toks.tolist(), np.asarray(chunk.advance).tolist(), cycles,
                    np.asarray(chunk.start_pos).tolist()))
    return rec


SCRIPT = [("spec", 1), ("spec", 3), ("plain", 2), ("spec", 4), ("spec", 1), ("plain", 3),
          ("spec", 4), ("spec", 4)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_chunks_equal_jax_engine(models, layout):
    """Greedy, penalized-greedy (the spec_pen program) and draft-length-2
    slots through spec chunks and plain chunks: every chunk's tokens, per-slot
    advance, per-cycle counts and start positions, and spec_stats(), equal
    the JAX engine's."""
    out = []
    for make in (_jax_engine, _port_engine):
        eng = make(models, layout=layout)
        _admit(eng, 0, REP)
        _admit(eng, 1, [9, 8, 7, 9, 8], presence=0.5, frequency=0.3)
        _admit(eng, 2, [3, 4, 3, 4, 3], spec_k=2)
        out.append((_lockstep(eng, SCRIPT), eng.spec_stats(), eng.spec_k_slot.tolist()))
    assert out[0] == out[1]
    stats = out[1][1]
    assert stats["cycles"] == 17 and stats["accepted"] > 0  # drafts were accepted
    assert out[1][2] == [4, 4, 2]


def test_spec_k_clamps_and_release_zeroes(models):
    eng = _port_engine(models, n_slots=2)
    _admit(eng, 0, REP, spec_k=99)
    _admit(eng, 1, [1, 2, 3], spec_k=0)
    assert eng.spec_k_slot.tolist() == [4, 0]
    # a spec_k 0 greedy slot rides the cycles one token at a time: no drafts
    assert eng.spec_draft_k().tolist() == [4, 0]
    emit, adv = eng.spec_step()
    assert adv[1] == 1 and adv[0] >= 1
    eng.release(0)
    assert eng.spec_k_slot.tolist() == [0, 0]
    with pytest.raises(ValueError, match="spec=0"):
        _port_engine(models, spec=0).decode_dispatch(1, spec=True)


def test_radix_map_backfills_the_history(models):
    """A tree hit maps the prefix's pages and writes its token ids into the
    slot's history: the drafts, and so the cycles, equal a cold prefill's
    of the same prompt, and so do the tokens."""
    prompt = REP * 3 + [9]

    def run(warm):
        eng = _port_engine(models, layout="paged", radix="on", n_slots=2)
        if warm:
            _admit(eng, 0, prompt[:17])
            eng.radix_insert(0, prompt[:16])
            eng.release(0)
            rows, hit = eng.radix_lookup(prompt)
            assert rows == 16
            eng.radix_map(1, hit)
            adm = eng.add_begin(1, prompt[rows:], start_pos=rows)
        else:
            adm = eng.add_begin(1, prompt)
        while not eng.add_step(adm):
            pass
        first = eng.add_commit(adm, 0.0, 0.9, seed=1)
        hist = eng.history[1, : len(prompt) + 1].tolist()
        toks = [first] + eng.decode_consume(eng.decode_dispatch(4, spec=True))[:, 1].tolist()
        return hist, toks, eng.spec_stats()["cycles"], eng.spec_stats()["accepted"]

    cold, warm = run(False), run(True)
    assert cold[0] == prompt + [cold[1][0]]  # the prompt, then the unfed token
    assert warm == cold and cold[3] > 0


def test_warmup_captures_the_spec_programs(models):
    eng = _port_engine(models, layout="paged")
    report = eng.warmup(chunk=4)
    assert report["per_fn"]["spec"] == 2 and report["per_fn"]["spec_pen"] == 2
    assert report["full_coverage"]
    assert (eng.history == -1).all()  # inert: the warm-up wrote no history


# --------------------------------------------------------------- scheduler


def _greedy_workload(sched):
    """Greedy draftable, greedy, penalized greedy: staggered joins."""
    r1 = sched.submit(REP, 0.0, 0.9, 30, frozenset(), seed=1)
    it1 = r1.tokens()
    head = [next(it1), next(it1)]  # r1 decodes before the others join
    r2 = sched.submit([9, 8, 7], 0.0, 0.9, 10, frozenset(), seed=42)
    r3 = sched.submit([4, 5], 0.0, 0.8, 8, frozenset(), seed=7, presence=0.5, frequency=0.3)
    out2, out3 = list(r2.tokens()), list(r3.tokens())
    return [(head + list(it1), r1.finish_reason), (out2, r2.finish_reason),
            (out3, r3.finish_reason)]


def _mixed_workload(sched):
    """The JAX spec test's traffic: greedy draftable, sampled, penalized."""
    r1 = sched.submit(REP, 0.0, 0.9, 14, frozenset(), seed=1)
    it1 = r1.tokens()
    head = [next(it1), next(it1)]
    r2 = sched.submit([9, 8, 7], 1.1, 0.9, 10, frozenset(), seed=42)
    r3 = sched.submit([4, 5], 0.9, 0.8, 8, frozenset(), seed=7, presence=0.5, frequency=0.3)
    out2, out3 = list(r2.tokens()), list(r3.tokens())
    return [(head + list(it1), r1.finish_reason), (out2, r2.finish_reason),
            (out3, r3.finish_reason)]


def _run(sched, workload):
    try:
        got = workload(sched)
        stats = sched.latency_summary()["spec"]
        if sched.engine.pool is not None:
            report = sched.engine.pool.audit(raise_on_fail=False)
            assert report["ok"], report["problems"]
        return got, stats
    finally:
        sched.shutdown()


_REF: dict = {}


def _port_reference(models, workload):
    """The port's spec-off streams (dense, overlap on), once a workload."""
    if workload not in _REF:
        _REF[workload] = _run(_sched(models, spec=0), workload)[0]
    return _REF[workload]


@pytest.mark.parametrize("overlap,layout,radix", [
    (True, "dense", "off"),
    (False, "dense", "off"),
    (True, "paged", "on"),
    (False, "paged", "off"),
])
def test_greedy_streams_equal_jax_and_spec_off(models, overlap, layout, radix):
    got, stats = _run(_sched(models, overlap, 4, layout, radix), _greedy_workload)
    want, _ = _run(_jax_sched(models, overlap, 4, layout, radix), _greedy_workload)
    assert got == want == _port_reference(models, _greedy_workload)
    assert stats["cycles"] > 0 and stats["accepted"] > 0


def test_sampled_and_penalized_batch_mates_unchanged_by_spec(models):
    """Sampled and penalized streams ride the spec cycles one token a cycle
    at the generator counters plain decode draws them at: the same streams
    spec on and off (the port's Philox streams, not JAX's threefry ones)."""
    ref = _port_reference(models, _mixed_workload)
    for layout, radix in (("dense", "off"), ("paged", "on")):
        got, stats = _run(_sched(models, True, 4, layout, radix), _mixed_workload)
        assert got == ref and stats["cycles"] > 0


def test_per_request_spec_k_mixes_and_clamps(models):
    sched = _sched(models, n_slots=2)
    try:
        r1 = sched.submit(REP, 0.0, 0.9, 24, frozenset(), seed=1, spec_k=4)
        r2 = sched.submit(list(REP), 0.0, 0.9, 24, frozenset(), seed=2, spec_k=0)
        assert r1.spec_k == 4 and r2.spec_k == 0
        out1, out2 = list(r1.tokens()), list(r2.tokens())
        # same prompt, both greedy: the same stream whoever speculated; r1
        # carries an acceptance record, r2 none
        assert out1 == out2
        t1, t2 = r1.timings(), r2.timings()
        assert t1["spec"]["cycles"] > 0 and t1["spec"]["tokens"] > t1["spec"]["cycles"]
        assert "spec" not in t2
        r3 = sched.submit([1, 2], 0.0, 0.9, 2, frozenset(), seed=3, spec_k=99)
        r4 = sched.submit([1, 2], 0.0, 0.9, 2, frozenset(), seed=3)
        assert r3.spec_k == 4 and r4.spec_k == 4  # clamped; None is the engine's K
        list(r3.tokens()), list(r4.tokens())
    finally:
        sched.shutdown()
    off = _sched(models, spec=0, n_slots=1)
    try:
        assert off.submit([1, 2], 0.0, 0.9, 2, frozenset(), spec_k=3).spec_k == 0
    finally:
        off.shutdown()


def test_eos_overrun_rewinds_spec_acceptance(models):
    """An EOS inside an accepted run cuts the stream at the EOS, and
    keep_rows and slot_tokens record only the emitted prefix: rows reused by
    a follow-up request replay bit-exact."""
    sched = _sched(models, n_slots=2)
    try:
        ref = list(sched.submit(REP, 0.0, 0.9, 24, frozenset(), seed=0).tokens())
        cut = next(i for i, t in enumerate(ref) if i >= 12 and t not in ref[:i])
        eos = ref[cut]
        req = sched.submit(list(REP), 0.0, 0.9, 40, frozenset([eos]), seed=0)
        got = list(req.tokens())
        assert got == ref[: cut + 1] and req.finish_reason == "stop"
        slot = next(s for s, t in sched.slot_tokens.items() if t[len(REP):] == got[:-1])
        assert int(sched.engine.pos[slot]) == len(REP) + len(got) - 1
        follow = list(REP) + got + [11, 12]
        warm = list(sched.submit(follow, 0.0, 0.9, 6, frozenset(), seed=5).tokens())
        assert sched.latency_summary()["spec"]["accepted"] > 0
    finally:
        sched.shutdown()
    cold = _sched(models, spec=0, n_slots=2)
    try:
        assert list(cold.submit(follow, 0.0, 0.9, 6, frozenset(), seed=5).tokens()) == warm
    finally:
        cold.shutdown()


def test_draft_writes_never_land_in_shared_pages(models):
    """A spec verify writes K+1 rows past the live position: the dispatch's
    copy-on-write splits a shared page covering them first, and the pool
    audit names the hazard while it stands."""
    eng = _port_engine(models, layout="paged", n_slots=2)
    pool = eng.pool
    _admit(eng, 0, list(range(1, 11)))  # pos 10: mid-page
    blk = int(eng.pos[0]) // pool.page_size
    page = int(pool.tables[0, blk])
    with pool._mu:  # the state a missed copy-on-write would leave
        pool.refcount[page] += 1
        pool.tables[1, 0] = page
        pool.n_blocks[1] = 1
        pool._publish()
    with pytest.raises(PoolAuditError, match="shared inside the writable"):
        pool.audit()
    before = eng.read_page(page)
    emit, adv = eng.spec_step()
    assert adv[0] >= 1
    assert int(pool.tables[0, blk]) != page, "shared page was not split"
    assert pool.audit()["ok"]
    assert int(pool.tables[1, 0]) == page
    after = eng.read_page(page)  # the other referent's bytes are untouched
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    with pool._mu:
        pool._decref(page)
        pool.tables[1, 0] = 0
        pool.n_blocks[1] = 0
        pool._publish()
    eng.release(0)
    assert pool.audit()["ok"]


def test_overlap_alternation_advances_row_limit_frozen_slot(models):
    """A slot inside the K+1-row no-verify window near the context edge
    freezes in spec cycles: plain chunks alternate in until it finishes, and
    an aborted mode-switch dispatch does not take its turn."""
    sched = _sched(models, n_slots=2)
    try:
        near = sched.submit(list(range(1, CFG.seq_len - 5)), 0.0, 0.9, 40, frozenset(),
                            seed=2, spec_k=0)
        spec = sched.submit(REP, 0.0, 0.9, 24, frozenset(), seed=1, spec_k=4)
        done = {}

        def drain(name, req):
            done[name] = (list(req.tokens()), req.finish_reason)

        threads = [threading.Thread(target=drain, args=("near", near)),
                   threading.Thread(target=drain, args=("spec", spec))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), f"starved (finished: {sorted(done)})"
        toks, fin = done["near"]
        assert fin == "length" and len(toks) == 7
        assert done["spec"][1] == "length" and len(done["spec"][0]) == 24
    finally:
        sched.shutdown()


def test_spec_telemetry_and_stats_equal_jax(models):
    """One draftable request alone: the dllama_spec_* deltas equal the
    engine's spec_stats(), which equals the JAX scheduler's, and the
    request's own record covers the tokens its cycles gave it."""
    c0 = ins.SPEC_CYCLES.value()
    e0 = ins.SPEC_TOKENS.labels(kind="emitted").value()
    d0 = ins.SPEC_TOKENS.labels(kind="drafted").value()
    a0 = ins.SPEC_TOKENS.labels(kind="accepted").value()
    sched = _sched(models, n_slots=2)
    try:
        req = sched.submit(REP, 0.0, 0.9, 30, frozenset(), seed=1)
        out = list(req.tokens())
        stats = sched.latency_summary()["spec"]
    finally:
        sched.shutdown()
    jsched = _jax_sched(models, n_slots=2)
    try:
        want = list(jsched.submit(REP, 0.0, 0.9, 30, frozenset(), seed=1).tokens())
        jstats = jsched.latency_summary()["spec"]
    finally:
        jsched.shutdown()
    assert out == want and len(out) == 30
    assert stats == jstats and stats["accepted"] > 0
    assert ins.SPEC_CYCLES.value() - c0 == stats["cycles"]
    assert ins.SPEC_TOKENS.labels(kind="emitted").value() - e0 == stats["emitted"]
    assert ins.SPEC_TOKENS.labels(kind="drafted").value() - d0 == stats["drafted"]
    assert ins.SPEC_TOKENS.labels(kind="accepted").value() - a0 == stats["accepted"]
    t = req.timings()["spec"]
    assert t["tokens"] <= stats["emitted"] and t["tokens_per_cycle"] is not None


def test_spec_rows_partition_the_emitted_tokens(models):
    """The spec chunks' emitted tokens are exactly the requests' summed
    timings().spec tokens (a spec_k 0 request's record included, which
    timings() does not show) plus the rows of slots released while their
    chunk was in flight, and the same for (cycle, slot) pairs: short
    requests finishing beside long ones leave such discarded rows."""
    sched = _sched(models, n_slots=4)
    eng = sched.engine
    try:
        reqs = [sched.submit(REP, 0.0, 0.9, 40, frozenset(), seed=1),
                sched.submit([3, 4, 5, 3, 4, 5], 0.0, 0.9, 36, frozenset(), seed=2, spec_k=0),
                sched.submit(REP[1:], 0.0, 0.9, 6, frozenset(), seed=3),
                sched.submit([3, 4, 5, 3], 0.8, 0.9, 9, frozenset(), seed=4)]
        for req in reqs:
            list(req.tokens())
        stats, rows = eng.spec_stats(), eng.spec_rows()
    finally:
        sched.shutdown()
    assert "spec" not in reqs[1].timings() and reqs[1].spec_tokens > 0
    assert rows["discarded_tokens"] > 0 and rows["discarded_cycles"] > 0
    assert stats["emitted"] == sum(r.spec_tokens for r in reqs) + rows["discarded_tokens"]
    assert rows["slot_cycles"] == sum(r.spec_cycles for r in reqs) + rows["discarded_cycles"]
    assert all(r.spec_cycles <= stats["cycles"] for r in reqs)


def test_smoke_spec_lockstep_check(models):
    """chip_smoke.spec_lockstep_check, the card's exact check of the spec
    programs' sampled rows, on the CPU: greedy, sampled and penalized slots
    through spec and plain chunks equal plain decode's streams; a spec
    cycle that moved a sampled slot's generator counter one draw too far
    fails it."""
    import chip_smoke

    admits = [(REP, dict(temperature=0.0)), ([3, 4, 5, 3, 4], dict(temperature=0.8, seed=105)),
              ([3, 4, 5, 3], dict(temperature=0.8, seed=107, presence=0.5, frequency=0.3))]
    eng = _port_engine(models, layout="paged")
    out = chip_smoke.spec_lockstep_check(eng, admits, 20)
    assert out["stats"]["accepted"] > 0 and all(len(v) == 20 for v in out["spec"].values())

    consume = eng.decode_consume

    def skewed(chunk):
        toks = consume(chunk)
        if chunk.spec:
            eng.rng.counter[1:2] += 1  # slot 1 drew at a wrong counter
        return toks

    eng.decode_consume = skewed
    with pytest.raises(SystemExit):
        chip_smoke.spec_lockstep_check(eng, admits, 20)


def _slow_spec(sched, ms):
    """Slow every spec dispatch by `ms`, so an arrival (or a fault) lands
    while a stream runs."""
    eng = sched.engine
    spec_dispatch = eng._spec_dispatch

    def slow(*a, **k):
        time.sleep(ms / 1000.0)
        return spec_dispatch(*a, **k)

    eng._spec_dispatch = slow


@pytest.mark.parametrize("case", ["greedy", "sampled"])
def test_preempted_spec_stream_resumes_bit_equal(models, case):
    """A priority-0 stream riding spec cycles beside a speculating greedy
    batch-mate is preempted by a priority-2 arrival and resumes where it
    stopped: its tokens equal its uninterrupted run's (the resume installs
    the generator counter, which a spec cycle keeps equal to the tokens
    emitted)."""
    lo_kw = dict(temperature=0.0 if case == "greedy" else 0.8, topp=0.9, max_tokens=40,
                 eos_ids=frozenset(), seed=5)
    mate = [3, 4, 5, 3, 4, 5, 3]

    def uninterrupted():
        sched = _sched(models, layout="paged", radix="on", n_slots=1)
        try:
            return list(sched.submit(REP, **lo_kw).tokens())
        finally:
            sched.shutdown()

    sched = _sched(models, layout="paged", radix="on", n_slots=2)
    _slow_spec(sched, 30.0)
    try:
        m = sched.submit(mate, 0.0, 0.9, 40, frozenset(), seed=1)
        lo = sched.submit(REP, **lo_kw, priority=0)
        it = lo.tokens()
        first = next(it)
        hi = sched.submit([9, 8, 7], 0.0, 0.9, 4, frozenset(), seed=6, priority=2)
        out_hi = list(hi.tokens())
        out_lo = [first] + list(it)
        out_m = list(m.tokens())
        assert len(out_hi) == 4 and lo.finish_reason == "length" and len(out_m) == 40
        assert sched.preempt_count >= 1 and sched.resume_count >= 1
        assert sched.engine.pool.audit()["ok"]
        assert lo.timings()["spec"]["cycles"] > 0
    finally:
        sched.shutdown()
    assert out_lo == uninterrupted()


def test_warm_restart_resumes_spec_streams(models):
    """The JAX suite's drill: a worker crash mid-stream warm-restarts and
    resumes a greedy spec stream and a sampled one bit-equal to an
    uninterrupted run, with speculation live after the restart (the resumed
    slot keeps its spec_k; its counter equals the tokens emitted)."""
    from dllama_tpu_torch.utils import faults

    def run(crash):
        sched = _sched(models, layout="paged", radix="on", n_slots=2, restart_max=2)
        sched.restart_backoff_s = 0.01
        # slowed spec chunks: the crash lands mid-stream on a busy host too,
        # and enough of the stream is left after it to speculate again
        _slow_spec(sched, 20.0)
        try:
            r1 = sched.submit(REP, 0.0, 0.9, 32, frozenset(), seed=1)
            r2 = sched.submit([9, 8, 7], 1.0, 0.9, 24, frozenset(), seed=9)
            it1, it2 = r1.tokens(), r2.tokens()
            head1 = [next(it1) for _ in range(3)]
            head2 = [next(it2) for _ in range(2)]
            if crash:
                faults.install("engine.decode", "raise", times=1)
            out1, out2 = head1 + list(it1), head2 + list(it2)
            assert r1.finish_reason == r2.finish_reason == "length"
            if crash:
                assert sched.restart_count >= 1, "the crash never fired"
                assert r1.spec_cycles > 0 and sched.engine.spec_stats()["cycles"] > 0
                assert sched.engine.pool.audit()["ok"]
            return out1, out2
        finally:
            faults.clear()
            sched.shutdown()

    assert run(crash=True) == run(crash=False)


# ------------------------------------------------------------ entry points


@pytest.fixture(scope="module")
def tpath(tmp_path_factory):
    from dllama_tpu.tools.convert_tokenizer import convert_llama3_tokenizer
    from tests.golden_fixture import write_tiktoken_file

    tmp = tmp_path_factory.mktemp("torch_spec_batch")
    write_tiktoken_file(str(tmp / "tokenizer.model"))
    path = str(tmp / "golden.t")
    convert_llama3_tokenizer(str(tmp / "tokenizer.model")).save(path)
    return path


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


@pytest.mark.parametrize("frontend", ["aio", "threads"])
def test_serve_slots_spec_k_over_http(tpath, frontend):
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server
    from tests.test_golden import FIXTURE_M

    loaded = load_model(FIXTURE_M, tpath, cache_dtype=torch.float32, device="cpu")
    httpd, api = make_server(loaded, host="127.0.0.1", port=0, n_slots=2, spec=4,
                             frontend=frontend)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    body = {"messages": [{"role": "user", "content": "abc abc abc abc abc abc"}],
            "temperature": 0, "max_tokens": 24}
    try:
        seen = []
        submit = api.scheduler.submit

        def recorded(*a, **kw):
            req = submit(*a, **kw)
            seen.append(req.spec_k)
            return req

        api.scheduler.submit = recorded
        c0 = ins.SPEC_CYCLES.value()
        results = [_post(port, dict(body, **extra))
                   for extra in ({}, {"spec_k": 2}, {"spec_k": 99}, {"spec_k": 0})]
        assert [st for st, _ in results] == [200] * 4
        assert seen == [4, 2, 4, 0]
        contents = {r["choices"][0]["message"]["content"] for _, r in results}
        assert len(contents) == 1  # greedy: the same text at every draft length
        assert results[0][1]["timings"]["spec"]["cycles"] > 0
        assert "spec" not in results[3][1]["timings"]
        st, perf = _get(port, "/debug/perf")
        spec = json.loads(perf)["spec"]
        assert st == 200 and spec["k"] == 4 and spec["cycles"] == ins.SPEC_CYCLES.value() - c0
        assert _post(port, dict(body, spec_k=-1))[0] == 400
        st, metrics = _get(port, "/metrics")
        assert st == 200 and b"dllama_spec_cycles_total" in metrics
    finally:
        httpd.shutdown()
        httpd.server_close()
        api.scheduler.shutdown()
