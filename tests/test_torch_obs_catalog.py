"""The port's metrics catalog and exposition against the JAX package's.

`dllama_tpu_torch/obs/instruments.py` registers every dllama_* family of
`dllama_tpu/obs/instruments.py` under the same name, type, help text,
label names and buckets, so a dashboard (or the router's federation) reads
a port replica as it reads a JAX replica; `render()` of equal observations
is byte-equal. The registry and exposition cases of tests/test_metrics.py
run here as parametrised cases on both packages, each holding the port's
output equal to the JAX package's."""

import json
import logging
import math
import re

import pytest
import torch

from dllama_tpu.obs import instruments as jins
from dllama_tpu.obs import metrics as jmetrics
from dllama_tpu_torch.obs import instruments as tins
from dllama_tpu_torch.obs import metrics as tmetrics
from tests.test_metrics import check_histogram, parse_exposition

torch.set_num_threads(1)


def _families(reg) -> dict:
    out = {}
    for name in reg.names():
        fam = reg._families[name]
        out[name] = (type(fam).__name__, fam.help, tuple(fam.labelnames),
                     tuple(getattr(fam, "buckets", ()) or ()))
    return out


#: help texts that differ by design (ROADMAP §C): the port's names the
#: invariant where the JAX text cites that project's change history
HELP_DIFFERS = {"dllama_transfers_total": "steady-state decode is the "}


def test_every_jax_family_is_registered_alike():
    jax_fams = _families(jins.metrics.REGISTRY)
    port_fams = _families(tins.metrics.REGISTRY)
    assert set(jax_fams) == set(port_fams)
    for name, spec in jax_fams.items():
        got = port_fams[name]
        if name in HELP_DIFFERS:
            head = spec[1][: spec[1].index(HELP_DIFFERS[name]) + len(HELP_DIFFERS[name])]
            assert got[1].startswith(head) and got[1] != spec[1], name
            assert got[1].endswith("invariant breaking") and spec[1].endswith(
                "invariant breaking"), name
            got, spec = got[:1] + got[2:], spec[:1] + spec[2:]
        assert got == spec, name
    assert len(jax_fams) > 60  # the whole catalog, not a stub of it


def test_catalog_module_names_match():
    names = lambda mod: {k for k, v in vars(mod).items() if isinstance(
        v, (mod.metrics.Counter, mod.metrics.Gauge, mod.metrics.Histogram))}
    assert names(tins) == names(jins)


# ---------------------------------------- the test_metrics registry cases


def _case_counter_gauge(m):
    reg = m.Registry()
    c = reg.counter("t_requests_total", "help", ("reason",))
    c.labels(reason="a").inc()
    c.labels(reason="a").inc(2)
    c.labels(reason="b").inc()
    assert reg.sample("t_requests_total", {"reason": "a"}) == 3
    with pytest.raises(ValueError):
        c.labels(reason="a").inc(-1)  # counters only go up
    g = reg.gauge("t_depth", "help")
    g.set(7)
    g.inc()
    g.dec(3)
    assert reg.sample("t_depth") == 5
    assert reg.counter("t_requests_total", "help", ("reason",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_requests_total", "help", ("reason",))
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("t_requests_total", "help", ("other",))
    return reg.render()


def _case_histogram(m):
    reg = m.Registry()
    h = reg.histogram("t_lat_seconds", "help", ("op",), buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.01, 0.05, 0.5, 5.0):  # 0.01 lands IN the 0.01 bucket
        h.labels(op="x").observe(v)
    h.labels(op="y").observe_n(0.2, 3)
    text = reg.render()
    families, samples = parse_exposition(text)
    assert families["t_lat_seconds"] == "histogram"
    assert samples[("t_lat_seconds_bucket", '{op="x",le="0.01"}')] == 2
    assert samples[("t_lat_seconds_bucket", '{op="x",le="+Inf"}')] == 5
    assert samples[("t_lat_seconds_count", '{op="y"}')] == 3
    check_histogram(samples, "t_lat_seconds")
    return text


def _case_label_escaping(m):
    reg = m.Registry()
    c = reg.counter("t_esc_total", "multi\nline \\ help", ("what",))
    c.labels(what='we"ird\\val\nue').inc()
    text = reg.render()
    assert '# HELP t_esc_total multi\\nline \\\\ help' in text
    assert 't_esc_total{what="we\\"ird\\\\val\\nue"} 1' in text
    parse_exposition(text)
    return text


def _case_special_values(m):
    reg = m.Registry()
    g = reg.gauge("t_values", "help", ("k",))
    for k, v in (("nan", float("nan")), ("pinf", math.inf), ("ninf", -math.inf),
                 ("int", 3.0), ("tiny", 1e-9), ("big", 123456789.125)):
        g.labels(k=k).set(v)
    text = reg.render()
    parse_exposition(text)
    return text


def _case_reset(m):
    reg = m.Registry()
    reg.counter("t_a_total", "a").inc(4)
    reg.histogram("t_b_seconds", "b", buckets=(1.0,)).observe(2.0)
    reg.reset()
    return reg.render()


REGISTRY_CASES = {"counter_gauge": _case_counter_gauge, "histogram": _case_histogram,
                  "label_escaping": _case_label_escaping,
                  "special_values": _case_special_values, "reset": _case_reset}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_case_renders_byte_equal(case):
    fn = REGISTRY_CASES[case]
    assert fn(tmetrics) == fn(jmetrics)


def _observe_catalog(ins) -> None:
    """The same observations on every kind of catalog family."""
    ins.REQUESTS_ADMITTED.inc(3)
    ins.REQUESTS_SHED.labels(reason="queue_full").inc()
    ins.REQUESTS_FINISHED.labels(reason="stop").inc(2)
    ins.HTTP_RESPONSES.labels(endpoint="/metrics", code="200").inc()
    ins.TOKENS_GENERATED.inc(17)
    ins.QUEUE_DEPTH.set(4)
    ins.PREFILL_BUDGET.set(64)
    ins.BW_ATTAINMENT.set(float("nan"))
    ins.SCHEDULER_TIME.labels(state="idle").inc(0.125)
    for v in (0.0004, 0.03, 2.5):
        ins.TTFT_SECONDS.observe(v)
        ins.ITL_SECONDS.observe(v / 10)
    ins.BATCH_OCCUPANCY.observe_n(8, 5)
    ins.BUILD_INFO.labels(version="x", jax="none", backend="cpu", overlap="on",
                          warmup="auto").set(1)


def test_catalog_render_of_equal_observations_is_byte_equal():
    """A fresh registry of each package holding the whole catalog (each
    family re-registered under its own spec, with the JAX help text), the
    same observations on both: the expositions are the same bytes."""
    out = []
    for ins, metrics in ((jins, jmetrics), (tins, tmetrics)):
        reg = metrics.Registry()
        clone = type("Catalog", (), {})()
        for attr, fam in vars(ins).items():
            help_ = getattr(jins, attr).help if hasattr(fam, "help") else None
            if isinstance(fam, metrics.Histogram):
                new = reg.histogram(fam.name, help_, fam.labelnames, buckets=fam.buckets)
            elif isinstance(fam, metrics.Counter):
                new = reg.counter(fam.name, help_, fam.labelnames)
            elif isinstance(fam, metrics.Gauge):
                new = reg.gauge(fam.name, help_, fam.labelnames)
            else:
                continue
            setattr(clone, attr, new)
        _observe_catalog(clone)
        out.append(reg.render())
    assert out[0] == out[1]
    families, samples = parse_exposition(out[1])
    check_histogram(samples, "dllama_ttft_seconds")
    assert families["dllama_scheduler_time_seconds_total"] == "counter"


def test_request_id_minting_matches():
    from dllama_tpu.obs import new_request_id as jnew
    from dllama_tpu_torch.obs import new_request_id as tnew

    a, b = tnew(), tnew()
    assert a.startswith("req_") and b.startswith("req_") and a != b
    for given in ("trace-41.a_b", "bad id\n!", "x" * 200, "a:b", "", None):
        got, want = tnew(given), jnew(given)
        assert (got == given) == (want == given), given
        assert got.startswith("req_") or got == given


@pytest.mark.parametrize("pkg", ["dllama_tpu", "dllama_tpu_torch"])
def test_token_timer_throughput_is_total_time_based(pkg):
    import importlib

    TokenTimer = importlib.import_module(f"{pkg}.utils.profiling").TokenTimer
    ins = importlib.import_module(f"{pkg}.obs.instruments")
    t = TokenTimer()
    t.ms.extend([100.0, 300.0, 200.0])  # 600 ms over 3 tokens -> 5.0 tok/s
    assert "5.0 tok/s" in t.summary() and "3 tokens" in t.summary()
    assert TokenTimer().summary() == "no tokens timed"
    zero = TokenTimer()
    zero.ms.extend([0.0, 0.0])
    assert "0.0 tok/s" in zero.summary()
    before = ins.TOKEN_LATENCY_SECONDS.labels().count()
    rec = TokenTimer()
    rec.start()
    rec.stop()
    assert ins.TOKEN_LATENCY_SECONDS.labels().count() == before + 1


def test_json_and_text_log_formatters_match():
    from dllama_tpu.utils.logs import JsonFormatter as JJ
    from dllama_tpu.utils.logs import TextFormatter as JT
    from dllama_tpu_torch.utils.logs import JsonFormatter, TextFormatter

    rec = logging.LogRecord("dllama_tpu_torch.serve", logging.INFO, __file__, 1,
                            "hello %s", ("world",), None)
    rec.request_id = "req_abc"
    out, want = json.loads(JsonFormatter().format(rec)), json.loads(JJ().format(rec))
    assert out["msg"] == "hello world" and out["request_id"] == "req_abc"
    assert re.match(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}\.\d{3}Z$", out["ts"])
    assert {k: v for k, v in out.items() if k != "ts"} == \
        {k: v for k, v in want.items() if k != "ts"}
    assert TextFormatter("%(message)s").format(rec) == JT("%(message)s").format(rec)
