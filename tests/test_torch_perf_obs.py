"""The port's SLO and saturation core (`dllama_tpu_torch/obs/perf.py`)
against the JAX package's (`dllama_tpu/obs/perf.py`): `decode_step_bytes`
on a grid (dense, paged kernel and gather), the time ledger and the perf
aggregator under the same injected clock and observations, the budget
controller's decisions, and the card-keyed bandwidth peak (None off the
table, where attainment is None too). The pure-host cases of
tests/test_perf.py also run against the port's module."""

import itertools
import math

import pytest
import torch

import tests.test_perf as jax_perf_tests
from dllama_tpu.obs import instruments as jins
from dllama_tpu.obs import perf as jperf
from dllama_tpu_torch.obs import instruments as tins
from dllama_tpu_torch.obs import perf as tperf
from tests.test_perf import FakeClock

torch.set_num_threads(1)

#: tests/test_perf.py cases that touch only WindowQuantiles/WindowSums,
#: TimeLedger, SloPolicy, the aggregator and the process gauges
PORTABLE_CASES = (
    "test_window_quantiles_slide_out_of_window",
    "test_window_quantiles_reservoir_bounded_and_sane",
    "test_window_quantiles_rejects_nan_and_validates_args",
    "test_window_sums_totals_and_span",
    "test_time_ledger_partitions_wall_time_exactly",
    "test_time_ledger_open_span_poke_and_reentrant_start",
    "test_time_ledger_rejects_unknown_state",
    "test_time_ledger_feeds_the_counter_family",
    "test_slo_policy_tristate_verdicts",
    "test_slo_verdict_from_flight_recorder_marks",
    "test_perf_aggregator_goodput_vs_throughput",
    "test_refresh_gauges_drained_window_sets_nan_not_stale",
    "test_process_gauges_refresh",
)


@pytest.mark.parametrize("case", PORTABLE_CASES)
def test_jax_perf_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(jax_perf_tests, "perf", tperf)
    monkeypatch.setattr(jax_perf_tests, "ins", tins)
    getattr(jax_perf_tests, case)()


def test_window_quantiles_exact_on_every_adversarial_stream(monkeypatch):
    monkeypatch.setattr(jax_perf_tests, "perf", tperf)
    for name in jax_perf_tests.ADVERSARIAL_STREAMS:
        jax_perf_tests.test_window_quantiles_match_exact_sorted_list(name)


# ------------------------------------------------------- decode step bytes

CFGS = {"8b": dict(n_layers=32, dim=4096, hidden_dim=14336, kv_dim=1024, head_size=128,
                   n_kv_heads=8, vocab_size=128256, seq_len=8192,
                   weight_bytes=4_210_000_000),
        "tiny": dict(n_layers=2, dim=64, hidden_dim=128, kv_dim=32, head_size=16,
                     n_kv_heads=2, vocab_size=96, seq_len=64, weight_bytes=1_000_000)}
ROUTES = {"dense": dict(paged=False), "paged_kernel": dict(paged=True, paged_impl="kernel"),
          "paged_gather": dict(paged=True, paged_impl="gather")}


@pytest.mark.parametrize("cfg,route", itertools.product(sorted(CFGS), sorted(ROUTES)))
def test_decode_step_bytes_equals_jax(cfg, route):
    base = CFGS[cfg]
    for slots, frac, el, page in itertools.product((1, 3, 8, 96), (0.0, 0.1, 0.5, 1.0),
                                                   (1, 2, 4), (8, 16, 64)):
        if base["seq_len"] % page:
            continue
        kw = dict(base, slots=slots, live_rows=frac * base["seq_len"] + 0.5,
                  cache_bytes_per_el=el, page_size=page, **ROUTES[route])
        assert tperf.decode_step_bytes(**kw) == jperf.decode_step_bytes(**kw), kw
        spec = {k: v for k, v in kw.items() if k not in ("slots", "live_rows")}
        cm = tperf.ChunkCostModel(**spec)
        assert cm.step_bytes(slots, kw["live_rows"]) == jperf.ChunkCostModel(
            **spec).step_bytes(slots, kw["live_rows"])


def test_engine_cost_model_prices_like_jax():
    """The port's BatchEngine.chunk_cost_model() and the JAX engine's agree
    on the golden model (resident Q40 bytes included) on both layouts."""
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxBatch
    from dllama_tpu.engine.loader import load_model as jax_load
    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.loader import load_model
    from tests.test_golden import FIXTURE_M

    jl = jax_load(FIXTURE_M, mesh=None, cache_dtype=jnp.float32)
    tl = load_model(FIXTURE_M, cache_dtype=torch.float32, device="cpu")
    for layout in ("dense", "paged"):
        kw = dict(n_slots=2, kv_layout=layout, page_size=16)
        jcm = JaxBatch(jl.config, jl.engine.params, cache_dtype=jnp.float32,
                       **kw).chunk_cost_model()
        tcm = BatchEngine(tl.config, tl.engine.params, cache_dtype=torch.float32,
                          **kw).chunk_cost_model()
        assert tcm.__dict__ == jcm.__dict__
        assert tcm.step_bytes(2, 20.0) == jcm.step_bytes(2, 20.0)


# --------------------------------------------------- ledger and aggregator

SCRIPT = [("admission", 0.002), ("prefill", 0.0151), ("commit", 0.0004),
          ("decode_dispatch", 0.003), ("decode_wait", 0.0072), ("emit", 0.0009),
          ("hybrid", 0.004), ("decode_wait", 0.0069), ("emit", 0.0011), ("idle", 0.5),
          ("admission", 0.001)]


def test_time_ledger_snapshots_equal_jax():
    snaps = []
    for perf, ins in ((jperf, jins), (tperf, tins)):
        clk = FakeClock()
        led = perf.TimeLedger(counter=None, now_fn=clk)
        led.start("idle")
        clk.advance(0.25)
        for state, dt in SCRIPT:
            led.transition(state)
            clk.advance(dt)
        led.poke()
        mid = led.snapshot()
        led.close()
        snaps.append((mid, led.snapshot(), led.wall_s(), led.state()))
    assert snaps[0] == snaps[1]
    assert tperf.LEDGER_STATES == jperf.LEDGER_STATES
    final = snaps[1][1]
    assert sum(final["seconds"].values()) == pytest.approx(final["wall_s"], abs=1e-5)


def _aggregate(perf, peak):
    clk = FakeClock()
    cm = perf.ChunkCostModel(**CFGS["tiny"], paged=True, page_size=16)
    kw = {} if peak == "default" else {"peak_gbs": peak}
    agg = perf.PerfAggregator(slo=perf.SloPolicy(ttft_ms=100.0, itl_ms=20.0),
                              cost_model=cm, now_fn=clk, **kw)
    for i in range(40):
        agg.observe_finish(finish_reason=("stop", "length", "cancelled", "error")[i % 4],
                           ttft_ms=30.0 + 7.0 * i, itl_ms=5.0 + (i % 9) * 3.0,
                           e2e_ms=400.0 + 11.0 * i, tokens=10 + i)
        agg.observe_chunk(occupancy=1 + i % 8, live_rows=12.5 + i, steps=4,
                          tokens=4 * (1 + i % 8), device_s=0.003 + 0.0001 * i)
        clk.advance(0.7)
    snap = agg.snapshot()
    snap["slo"].pop("violations_total")  # process-global counters of each package
    return snap


def test_perf_aggregator_snapshots_equal_jax():
    """Same clock, same finishes and chunks: equal windows, SLO accounting
    and roofline; the port divides by the peak it is given (the JAX default
    is its TPU constant, 819 GB/s)."""
    want = _aggregate(jperf, "default")
    got = _aggregate(tperf, jperf.PEAK_HBM_GBS)
    assert got == want
    assert 0 < got["roofline"]["bandwidth_attainment"]


def test_no_peak_means_no_attainment():
    roof = _aggregate(tperf, None)["roofline"]
    assert roof["peak_gbs"] is None and roof["bandwidth_attainment"] is None
    assert roof["achieved_gbs"] > 0 and roof["priced"]
    # the default is no peak: never a TPU's number or a guess
    assert tperf.PerfAggregator().peak_gbs is None
    agg = tperf.PerfAggregator(cost_model=tperf.ChunkCostModel(**CFGS["tiny"]))
    agg.observe_chunk(occupancy=2, live_rows=10.0, steps=4, tokens=8, device_s=0.25)
    agg.refresh_gauges()
    assert math.isnan(tins.BW_ATTAINMENT.value())


def test_peak_table_is_keyed_on_the_card():
    assert tperf.PEAK_HBM_GBS == {"NVIDIA H100 80GB HBM3": 3350.0}
    assert tperf.peak_hbm_gbs("cpu") is None
    if not torch.cuda.is_available():
        assert tperf.peak_hbm_gbs() is None and tperf.peak_hbm_gbs(0) is None


def test_budget_controller_decisions_equal_jax():
    out = []
    for perf in (jperf, tperf):
        clk = FakeClock()
        win = perf.WindowQuantiles(now_fn=clk)
        ctl = perf.PrefillBudgetController(perf.SloPolicy(itl_ms=20.0), hi=256, now_fn=clk)
        seq = []
        for i in range(60):
            win.observe((0.004 if i < 20 else 0.05 if i < 40 else 0.001) * (1 + i % 3))
            clk.advance(0.3 if i % 5 else 13.0)
            seq.append(ctl.update(win))
        out.append(seq)
    assert out[0] == out[1]
    assert len(set(out[1])) > 2  # it moved both ways


def test_slo_verdicts_equal_jax():
    for t, i in itertools.product((None, 50.0), (None, 10.0)):
        jp, tp = jperf.SloPolicy(t, i), tperf.SloPolicy(t, i)
        for marks in ((None, None, None), (40.0, 100.0, 7), (80.0, 900.0, 2),
                      (10.0, 20.0, 1), (60.0, 60.0, 40)):
            assert tp.verdict_from_marks(*marks) == jp.verdict_from_marks(*marks)
            assert tp.verdict(marks[0], marks[1]) == jp.verdict(marks[0], marks[1])


# ------------------------------------------------------- the capture ledger


def test_capture_ledger_classifies_against_the_contract(caplog):
    """A capture is expected when its bucket is declared, unexpected when
    its fn has declarations but not that key (counted, logged), undeclared
    otherwise; the ledger's documents have the JAX package's keys."""
    from dllama_tpu.obs import compile as jcompile
    from dllama_tpu_torch.engine.graphs import Programs
    from dllama_tpu_torch.obs import compile as tcompile

    ledger = tcompile.CompileLedger()
    contract = tcompile.ShapeContract()
    for n in (1, 2, 3, 4):
        contract.declare("decode", f"n{n}")
    contract.declare("prefill_chunk", "m16")
    ledger.install_contract(contract)
    base = tins.JIT_UNEXPECTED_COMPILES.labels(fn="decode").value()
    with ledger.warmup_phase():
        assert ledger.record_capture("decode", "n4", 0.25, 100.0) == "expected"
    with caplog.at_level("WARNING", logger="dllama_tpu_torch.obs"):
        assert ledger.record_capture("decode", "n9", 0.5, 101.0, sig="int64[9,8]") == \
            "unexpected"
    assert "unexpected CUDA-graph capture" in caplog.text and "n9" in caplog.text
    assert ledger.record_capture("single_decode", "n8", 0.1, 102.0) == "undeclared"
    assert tins.JIT_UNEXPECTED_COMPILES.labels(fn="decode").value() == base + 1
    assert ledger.total_compiles() == 3 and ledger.total_unexpected() == 1
    snap = ledger.snapshot()
    assert [e["warmup"] for e in snap["entries"]] == [True, False, False]
    cov = snap["contract"]["fns"]
    assert cov["decode"]["missing_warm"] == ["n1", "n2", "n3"] and not snap["contract"]["full"]
    assert cov["decode"]["unexpected_seen"] == ["n9"]
    jsnap = jcompile.CompileLedger().snapshot()
    assert set(snap) == set(jsnap)
    jc = jcompile.ShapeContract()
    jc.declare("decode", "n1")
    assert set(contract.coverage({})["fns"]["decode"]) == \
        set(jc.coverage({})["fns"]["decode"])
    assert set(ledger.summary()) == set(jcompile.CompileLedger().summary())
    # the programs' labels: the batched tier's are the JAX package's fns
    progs = Programs("cpu")
    assert progs.label(("greedy", 4)) == progs.label(("sampled", 4)) == ("decode", "n4")
    assert progs.label(("penalized", 2)) == ("decode_pen", "n2")
    assert progs.label(("prefill", 64, "paged")) == ("prefill_chunk", "m64")
    single = Programs("cpu", tier="single")
    assert single.label(("prefill", 8, "dense")) == ("single_step", "m8")
    assert single.label(("greedy", 8)) == ("single_decode", "n8")
    assert tcompile.sig_of(torch.zeros(2, 3, dtype=torch.int64), 5) == "torch.int64[2,3],5"


def test_transfer_tallies_match_jax():
    from dllama_tpu.obs import compile as jcompile
    from dllama_tpu_torch.obs import compile as tcompile

    out = []
    for mod in (jcompile, tcompile):
        mod.reset_transfers()
        mod.note_transfer("h2d", "vectors", 64)
        mod.note_transfer("d2h", "decode_tokens", 256)
        mod.note_transfer("d2h", "decode_tokens", 256)
        out.append(mod.transfer_snapshot())
        mod.reset_transfers()
    assert out[0] == out[1]
    assert out[1]["d2h"] == {"count": 2, "bytes": 512}
    assert set(tcompile.TRANSFER_SITES) <= set(jcompile.TRANSFER_SITES)
