"""Priority classes, tenant fair queueing and preempt-to-pages in the port's
scheduler, against the JAX package's where the two can agree.

* A low-priority request preempted by a high-priority arrival resumes
  bit-equal to its uninterrupted run: greedy, sampled (the resume installs
  the slot's Philox counter) and penalized (the occurrence counts are
  rebuilt), on the page pool with the tree on, and greedy on the dense
  layout (the slot keeps its rows).
* With ``preempt="off"`` it never fires; the high-priority request waits.
* The admission policy picks the same order as the JAX scheduler's on one
  script (priority classes, WFQ across weighted tenants, FIFO within a
  tenant, one immediate pick for a tenant back from idle), and in the
  running scheduler a higher class admits strictly first and a flooding
  tenant does not starve another.
* The API parses ``priority`` and ``tenant`` as the JAX API does, and hands
  them to ``Scheduler.submit``.

The decode chunks are slowed by a sleep around the engine's launch (the
port has no fault injection), so an arrival lands while a stream runs.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.serve import api
from dllama_tpu_torch.serve.scheduler import Request, Scheduler

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
CFG = LlamaConfig(**KW)
PAGE = 8


@pytest.fixture(scope="module")
def params():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jparams = random_params(JaxConfig(**KW), seed=3, dtype=jnp.float32, quantize=False)
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def _sched(params, layout="paged", n_slots=1, slow_ms=0.0, **kw):
    eng = BatchEngine(CFG, params, n_slots=n_slots, cache_dtype=torch.float32,
                      kv_layout=layout, page_size=PAGE, max_prefill_chunk=8)
    if eng.pool is not None:
        eng.pool.audit_on_release = True
    if slow_ms:
        launch = eng._decode_launch

        def slow(*a, **k):
            time.sleep(slow_ms / 1000.0)
            return launch(*a, **k)

        eng._decode_launch = slow
    return Scheduler(eng, **kw)


# long enough (10 slowed chunks) that the arrival lands mid-stream on a busy host
LO = dict(temperature=0.0, topp=0.9, max_tokens=40, eos_ids=frozenset(), seed=5)
CASES = {"greedy": dict(), "sampled": dict(temperature=0.8, seed=11),
         "penalized": dict(presence=0.5, frequency=0.3)}


def _uninterrupted(params, case, layout):
    sched = _sched(params, layout)
    try:
        return list(sched.submit([1, 2, 3], **dict(LO, **CASES[case])).tokens())
    finally:
        sched.shutdown()


def _preempted(params, case, layout, preempt="auto"):
    sched = _sched(params, layout, slow_ms=30.0, preempt=preempt)
    try:
        lo = sched.submit([1, 2, 3], **dict(LO, **CASES[case]), priority=0, tenant="batch")
        it = lo.tokens()
        first = next(it)
        hi = sched.submit([9, 8, 7], 0.0, 0.9, 4, frozenset(), seed=6, priority=2,
                          tenant="interactive")
        out_hi = list(hi.tokens())
        out_lo = [first] + list(it)
        assert hi.finish_reason == "length" and lo.finish_reason == "length"
        assert len(out_hi) == 4
        assert sched.engine.pool is None or sched.engine.pool.audit()["ok"]
        return out_lo, sched.preempt_count, sched.resume_count, hi, lo
    finally:
        sched.shutdown()


@pytest.mark.parametrize("case,layout", [("greedy", "paged"), ("sampled", "paged"),
                                         ("penalized", "paged"), ("greedy", "dense")])
def test_preempted_stream_resumes_bit_equal(params, case, layout):
    out, preempts, resumes, hi, lo = _preempted(params, case, layout)
    assert preempts >= 1 and resumes >= 1, "the high-priority arrival never preempted"
    assert out == _uninterrupted(params, case, layout)
    assert hi.first_token_at < lo.finished_at  # hi did not wait for lo to finish


def test_preempt_off_never_fires(params):
    out, preempts, resumes, hi, lo = _preempted(params, "greedy", "paged", preempt="off")
    assert preempts == 0 and resumes == 0
    assert hi.admitted_at >= lo.finished_at  # it waited for the slot
    assert out == _uninterrupted(params, "greedy", "paged")


# ------------------------------------------------------ admission policy


def _policy(cls, weights=None):
    """A scheduler of `cls` with its policy state only (no worker)."""
    s = object.__new__(cls)
    s._backlog, s._tenant_vt, s._vt_now = [], {}, 0.0
    s.tenant_weights = dict(weights or {})
    return s


def _picks(cls, req_cls, script, weights):
    """Run `script` (("submit", tenant, priority, prompt_len, max_tokens) |
    ("pick", n)) through the policy of `cls`; the picked submission indices
    and the final virtual times."""
    s = _policy(cls, weights)
    reqs, order = [], []
    for op in script:
        if op[0] == "submit":
            _, tenant, prio, n, mt = op
            r = req_cls(list(range(n)), 0.0, 0.9, mt, frozenset(), tenant=tenant, priority=prio)
            reqs.append(r)
            s._backlog.append(r)
        else:
            for _ in range(op[1]):
                r = s._select_next()
                s._charge_tenant(r)
                order.append(reqs.index(r))
    return order, s._tenant_vt, s._vt_now


SCRIPT = ([("submit", "A", 1, 3, 2)] * 20 + [("pick", 20)]  # A works while B idles
          + [("submit", "B", 1, 3, 2)] * 5 + [("submit", "A", 1, 3, 2)]
          + [("pick", 3)]
          + [("submit", "free", 1, 3, 2)] * 3 + [("submit", "paid", 1, 3, 2)] * 3
          + [("submit", "free", 0, 5, 4), ("submit", "paid", 2, 4, 4),
             ("submit", "", 1, 9, 1)]
          + [("pick", 12)])


def test_policy_order_equals_jax():
    from dllama_tpu.serve.scheduler import Request as JaxRequest
    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler

    weights = {"paid": 4.0, "free": 1.0}
    got = _picks(Scheduler, Request, SCRIPT, weights)
    assert got == _picks(JaxScheduler, JaxRequest, SCRIPT, weights)
    order = got[0]
    assert order[20] == 20  # B back from idle: one immediate pick
    # the last 12 picks: the high-class request (submission 33) first, the
    # low-class one (32) last
    assert order[23] == 33 and order[-1] == 32


def test_priority_classes_admit_strictly_first(params):
    sched = _sched(params, slow_ms=20.0)
    try:
        list(sched.submit([5, 6], 0.0, 0.9, 2, frozenset(), seed=99).tokens())
        runner = sched.submit([7, 7], 0.0, 0.9, 24, frozenset(), seed=1, priority=2)
        it = runner.tokens()
        next(it)  # the runner holds the slot; the rest wait in the backlog
        low = sched.submit([2, 2], 0.0, 0.9, 2, frozenset(), seed=2, priority=0)
        norm = sched.submit([3, 3], 0.0, 0.9, 2, frozenset(), seed=3, priority=1)
        high = sched.submit([4, 4], 0.0, 0.9, 2, frozenset(), seed=4, priority=2)
        for r in (low, norm, high, runner):
            list(r.tokens())
        order = sorted((low, norm, high), key=lambda r: r.admitted_at)
        assert [r.priority for r in order] == [2, 1, 0]
        assert sched.preempt_count == 0  # nothing out-ranks the runner
    finally:
        sched.shutdown()


def test_wfq_flood_does_not_starve_another_tenant(params):
    sched = _sched(params, slow_ms=20.0)
    try:
        list(sched.submit([5, 6], 0.0, 0.9, 2, frozenset(), seed=99).tokens())
        runner = sched.submit([7, 7, 7], 0.0, 0.9, 24, frozenset(), seed=1, tenant="A")
        it = runner.tokens()
        next(it)
        flood = [sched.submit([2, 2, 2], 0.0, 0.9, 2, frozenset(), seed=s, tenant="A")
                 for s in range(2, 6)]
        b = sched.submit([3, 3, 3], 0.0, 0.9, 2, frozenset(), seed=9, tenant="B")
        for r in flood + [b, runner]:
            list(r.tokens())
        finished = sorted(flood + [b], key=lambda r: r.finished_at)
        # B came last but at most one A request (charged before B arrived)
        # precedes it
        assert finished.index(b) <= 1
    finally:
        sched.shutdown()


# ------------------------------------------------------------------- api


def test_api_parses_priority_and_tenant_as_jax():
    from dllama_tpu.serve import api as japi

    bodies = [{}, {"priority": 0}, {"priority": 2}, {"priority": "high"},
              {"priority": "low"}, {"priority": "normal"}, {"priority": 1.7},
              {"priority": 3}, {"priority": -1}, {"priority": "urgent"}, {"priority": [1]},
              {"tenant": "acme"}, {"tenant": ""}, {"tenant": 7}, {"tenant": "x" * 65},
              {"tenant": ["t"]}]

    def parse(mod, fn, body):
        try:
            return getattr(mod, fn)(body)
        except mod.ApiError as e:
            return ("error", e.status, str(e))

    for body in bodies:
        for fn in ("_parse_priority", "_parse_tenant"):
            assert parse(api, fn, body) == parse(japi, fn, body), (fn, body)


def test_api_hands_priority_and_tenant_to_the_scheduler():
    seen = {}
    fake = SimpleNamespace(
        defaults=dict(temperature=0.8, topp=0.9, seed=None), stops=[],
        tokenizer=SimpleNamespace(eos_ids=[0], encode=lambda text, add_bos=True: [1, 2, 3]),
        scheduler=SimpleNamespace(engine=SimpleNamespace(seq_len=64),
                                  submit=lambda *a, **k: seen.update(k)))
    fake._normalize_legacy_prompt = lambda body: body["prompt"]
    p = api.ApiServer.prepare_request(fake, {"prompt": "hi", "priority": "high",
                                             "tenant": "acme"}, legacy=True)
    api.ApiServer.batched_submit(fake, p)
    assert seen["priority"] == 2 and seen["tenant"] == "acme"
    with pytest.raises(api.ApiError):
        api.ApiServer.prepare_request(fake, {"prompt": "hi", "priority": 5}, legacy=True)
