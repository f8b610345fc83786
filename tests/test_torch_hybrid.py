"""Hybrid chunked prefill in the port's scheduler (``--prefill-budget``):
while a request admits and others decode, each device chunk first prefills
a slice of the admitting prompt through the prefill program of its width,
then runs the decode program (``BatchEngine.hybrid_dispatch``).

* A hybrid chunk fills its budget: the JAX package's first slice, then
  further power-of-two slices of the same prompt, ending where add_steps
  of those sizes end, bit for bit.
* (a) The JAX package's mixed workload (greedy decoders, then a long
  sampled joiner and a penalized one): the token streams under ``auto``
  and a fixed budget are bit-exact against ``prefill_budget=0`` (the
  phase-split path), on the page pool with the overlapped loop on and off,
  and on the dense layout; the joiner really rode hybrid chunks, and the
  pool audits clean.
* (b) Greedy and penalized-greedy streams equal the JAX ``Scheduler``'s with
  hybrid on (radix and preemption off, weights carried across with
  ``convert.params_from_numpy``). Sampled streams are compared port
  against port only: the port's per-slot generator is Philox, JAX's
  threefry.
* (c) The budget controller of ``obs/perf.py`` shrinks, grows, holds and
  rate-limits as the JAX package's does.
* (d) ``prefill_budget=0`` runs no hybrid chunk and reports mode ``off``;
  ``auto`` reports 64 with no ITL target.
* (e) The CLI takes ``--prefill-budget``, ``--admit-budget-ms``,
  ``--admit-ttft-deadline-ms`` and ``--slo-itl-ms``, and refuses a negative
  or non-integer budget with the JAX CLI's message and exit code; the
  single-engine tier ignores a budget with a warning.

The tiny configuration is the JAX test's (tests/test_hybrid.py): dim 64, 2
layers, 4/2 heads, context 64, page 8, prefill chunks of at most 8 tokens
and a 24-token joining prompt.
"""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.obs import perf
from dllama_tpu_torch.serve.scheduler import Scheduler
from tests.test_golden import FIXTURE_M

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
CFG = LlamaConfig(**KW)
PAGE = 8
LONG_PROMPT = [int(x) % 90 + 1 for x in range(7, 31)]  # 24 tokens: three 8-token slices


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jcfg = JaxConfig(**KW)
    jparams = random_params(jcfg, seed=3, dtype=jnp.float32, quantize=False)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _mixed(sched, greedy_only=False):
    """Greedy r1 decoding, then a long joiner (sampled, or greedy with
    `greedy_only`) and a penalized one (penalized greedy with `greedy_only`):
    the join paths are where hybrid differs from phase-split admission."""
    r1 = sched.submit([1, 2, 3, 1, 2, 3], 0.0, 0.9, 30, frozenset(), seed=1)
    it1 = r1.tokens()
    head = [next(it1), next(it1)]  # r1 decodes before the others join
    r2 = sched.submit(LONG_PROMPT, 0.0 if greedy_only else 1.1, 0.9, 8, frozenset(), seed=42)
    r3 = sched.submit([4, 5], 0.0 if greedy_only else 0.9, 0.8, 6, frozenset(), seed=7,
                      presence=0.5, frequency=0.3)
    out2, out3 = list(r2.tokens()), list(r3.tokens())
    return [(head + list(it1), r1.finish_reason), (out2, r2.finish_reason),
            (out3, r3.finish_reason)]


_RUNS: dict = {}


def _run(params, layout, overlap=True, budget="auto", greedy_only=False):
    """The port's streams (memoized) and the scheduler's latency summary."""
    key = (layout, overlap, budget, greedy_only)
    if key not in _RUNS:
        eng = BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32, kv_layout=layout,
                          page_size=PAGE, max_prefill_chunk=8)
        if eng.pool is not None:
            eng.pool.audit_on_release = True
        sched = Scheduler(eng, overlap=overlap, prefill_budget=budget)
        try:
            streams = _mixed(sched, greedy_only)
        finally:
            sched.shutdown()
        if eng.pool is not None:
            assert eng.pool.audit()["ok"]
        _RUNS[key] = streams, sched.latency_summary()
    return _RUNS[key]


# ------------------------------------------------------------------- parity


@pytest.mark.parametrize("layout,overlap,budget", [
    ("paged", True, "auto"), ("paged", False, "auto"), ("paged", True, 4),
    ("dense", True, "auto")])
def test_hybrid_streams_bit_exact_against_phase_split(models, layout, overlap, budget):
    params = models[2]
    legacy, legacy_summary = _run(params, "paged", budget=0)
    streams, summary = _run(params, layout, overlap, budget)
    assert streams == legacy
    # the joiners' prefill really rode hybrid chunks, in slices of the budget
    hyb = summary["hybrid"]
    assert hyb["chunks"] > 0 and hyb["tokens"] > 0
    assert hyb["tokens"] <= len(LONG_PROMPT) + 2
    assert hyb["chunks"] >= -(-hyb["tokens"] // hyb["prefill_budget"])
    assert legacy_summary["hybrid"]["chunks"] == 0
    assert [n for _, n in streams] == ["length", "length", "length"]


def test_greedy_streams_equal_the_jax_scheduler_with_hybrid_on(models):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine
    from dllama_tpu.serve.scheduler import Scheduler as JaxScheduler

    jcfg, jparams, params = models
    jeng = JaxEngine(jcfg, jparams, n_slots=3, cache_dtype=jnp.float32, kv_layout="paged",
                     page_size=PAGE, radix_cache="off", max_prefill_chunk=8)
    jsched = JaxScheduler(jeng, chunk=4, overlap=True, prefill_budget="auto", preempt="off")
    try:
        want = _mixed(jsched, greedy_only=True)
        assert jsched.latency_summary()["hybrid"]["mode"] == "auto"
    finally:
        jsched.shutdown()
    got, summary = _run(params, "paged", greedy_only=True)
    assert got == want
    assert summary["hybrid"]["chunks"] > 0
    assert got[2][0] != _run(params, "paged", budget=0)[0][2][0]  # r3's penalties acted


def test_a_hybrid_chunk_fills_its_budget_with_pow2_slices(models):
    """The first slice is the JAX package's, pow2_chunk(min(budget,
    remaining), max_prefill_chunk); while budget is left, further pow2
    slices of the same prompt follow in the same chunk. The admission ends
    where add_steps of those sizes end: logits and KV rows bit-equal."""
    params = models[2]
    kw = dict(n_slots=2, cache_dtype=torch.float32, kv_layout="paged", page_size=PAGE,
              max_prefill_chunk=16)
    eng, ref = BatchEngine(CFG, params, **kw), BatchEngine(CFG, params, **kw)
    prompt = list(range(3, 24))  # 21 tokens
    for e in (eng, ref):
        e.add(0, [1, 2, 3], temperature=0.0)
    adm = eng.add_begin(1, prompt)
    got = []
    while adm.off < len(prompt):
        chunk = eng.hybrid_dispatch(2, adm, 16)
        eng.decode_consume(chunk)
        got.append(chunk.hybrid_tokens)
    assert got == [16, 5]  # 16 | 4 + 1
    radm = ref.add_begin(1, prompt)
    while not ref.add_step(radm):  # 16, 4, 1
        pass
    ref.decode(2)
    ref.decode(2)
    assert torch.equal(adm.logits, radm.logits)
    assert torch.equal(eng.cache.k, ref.cache.k) and torch.equal(eng.cache.v, ref.cache.v)
    assert eng.add_commit(adm, 0.0) == ref.add_commit(radm, 0.0)
    # the decoder's prompt in 2 + 1, the joiner's in 16, 4, 1, two 2-step chunks
    assert eng.forwards == ref.forwards == 2 + 3 + 2 * 2


# ------------------------------------------------------------- modes, knobs


def test_budget_zero_is_phase_split_and_auto_holds_64(models):
    params = models[2]
    off = _run(params, "paged", budget=0)[1]
    assert off["hybrid"] == {"mode": "off", "prefill_budget": 0, "chunks": 0, "tokens": 0}
    auto = _run(params, "paged")[1]["hybrid"]
    assert (auto["mode"], auto["prefill_budget"]) == ("auto", 64)
    assert _run(params, "paged", budget=4)[1]["hybrid"]["mode"] == "fixed"
    eng = BatchEngine(CFG, params, n_slots=2, cache_dtype=torch.float32)
    sched = Scheduler(eng, prefill_budget="0", admit_ttft_deadline_ms=5.0, slo_itl_ms=40.0)
    try:
        h = sched.health()
        assert h["prefill_budget"] == 0 and sched.admit_ttft_deadline_ms == 5.0
        assert sched.admit_stall_budget_ms == 250.0 and sched.slo.itl_ms == 40.0
    finally:
        sched.shutdown()
    with pytest.raises(ValueError, match="prefill_budget"):
        Scheduler(eng, prefill_budget=-1)


def test_budget_controller_shrinks_and_grows():
    """p95 over the ITL target halves the budget, ample headroom doubles it,
    the band between holds, no target holds, and updates are rate-limited
    (the JAX package's controller test, on the port's copy)."""
    t = [0.0]

    def now():
        return t[0]

    win = perf.WindowQuantiles(window_s=60.0, now_fn=now)
    ctl = perf.PrefillBudgetController(perf.SloPolicy(itl_ms=50.0), lo=16, hi=256, start=64,
                                       interval_s=0.0, now_fn=now)
    for _ in range(20):
        win.observe(0.100)  # 100 ms >> 50 ms target
    t[0] += 1.0
    assert ctl.update(win) == 32
    t[0] += 1.0
    assert ctl.update(win) == 16
    t[0] += 1.0
    assert ctl.update(win) == 16  # floor
    win2 = perf.WindowQuantiles(window_s=60.0, now_fn=now)
    for _ in range(20):
        win2.observe(0.010)  # 10 ms << 0.6 * 50 ms
    t[0] += 1.0
    assert ctl.update(win2) == 32
    t[0] += 1.0
    assert ctl.update(win2) == 64
    win3 = perf.WindowQuantiles(window_s=60.0, now_fn=now)
    for _ in range(20):
        win3.observe(0.040)  # inside the hold band (0.6..1.0 of the target)
    t[0] += 1.0
    assert ctl.update(win3) == 64
    ctl2 = perf.PrefillBudgetController(perf.SloPolicy(itl_ms=50.0), start=64,
                                        interval_s=10.0, now_fn=now)
    assert ctl2.update(win) == 32  # the first evaluation reacts at once
    t[0] += 0.5
    assert ctl2.update(win) == 32  # rate-limited
    t[0] += 10.0
    assert ctl2.update(win) == 16
    ctl3 = perf.PrefillBudgetController(perf.SloPolicy(), start=64, interval_s=0.0,
                                        now_fn=now)
    assert ctl3.update(win) == 64  # no target: auto holds its start


def test_window_quantiles_match_numpy_and_expire():
    t = [0.0]
    win = perf.WindowQuantiles(window_s=6.0, slices=3, now_fn=lambda: t[0])
    xs = np.random.default_rng(2).standard_normal(50)
    for x in xs:
        win.observe(float(x))
    win.observe(float("nan"))  # never enters the window
    for q in (0.0, 0.5, 0.95, 1.0):
        assert win.quantile(q) == pytest.approx(float(np.percentile(xs, 100 * q)), abs=1e-12)
    t[0] += 6.0  # every slice has left the window
    assert win.quantile(0.5) is None


# ---------------------------------------------------------------------- CLI


def test_single_engine_tier_ignores_a_budget_with_a_warning(tmp_path, caplog):
    import logging

    from dllama_tpu.tools.convert_tokenizer import convert_llama3_tokenizer
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve import api
    from tests.golden_fixture import write_tiktoken_file

    write_tiktoken_file(str(tmp_path / "tokenizer.model"))
    tpath = str(tmp_path / "golden.t")
    convert_llama3_tokenizer(str(tmp_path / "tokenizer.model")).save(tpath)
    with caplog.at_level(logging.WARNING, logger="dllama_tpu_torch.serve"):
        httpd, server = api.make_server(load_model(FIXTURE_M, tpath, device="cpu"), n_slots=0,
                                        prefill_budget=32, slo_itl_ms=40.0)
        httpd.server_close()
    assert server.scheduler is None
    assert any("--prefill-budget" in r.getMessage() and "ignored" in r.getMessage()
               for r in caplog.records)


def test_cli_takes_the_hybrid_flags_and_rejects_bad_budgets(monkeypatch, capsys):
    from dllama_tpu_torch.cli.main import main
    from dllama_tpu_torch.serve import api

    seen = {}
    monkeypatch.setattr(api, "run_server", lambda loaded, **kw: seen.update(kw) or 0)
    base = ["serve", "--model", FIXTURE_M, "--tokenizer", FIXTURE_M, "--device", "cpu",
            "--slots", "2"]
    monkeypatch.setattr("dllama_tpu_torch.cli.main._load", lambda args: None)
    assert main(base) == 0
    assert seen["prefill_budget"] == "auto" and seen["admit_stall_budget_ms"] is None
    assert main(base + ["--prefill-budget", "32", "--admit-budget-ms", "100",
                        "--admit-ttft-deadline-ms", "900", "--slo-itl-ms", "40"]) == 0
    assert (seen["prefill_budget"], seen["admit_stall_budget_ms"],
            seen["admit_ttft_deadline_ms"], seen["slo_itl_ms"]) == (32, 100.0, 900.0, 40.0)
    assert main(base + ["--prefill-budget", "0"]) == 0 and seen["prefill_budget"] == 0
    capsys.readouterr()
    assert main(base + ["--prefill-budget", "-1"]) == 1
    assert "--prefill-budget must be >= 0" in capsys.readouterr().err
    assert main(base + ["--prefill-budget", "abc"]) == 1
    assert "--prefill-budget must be 'auto' or an integer, got 'abc'" in capsys.readouterr().err
