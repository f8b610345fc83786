"""The port's fleet observability plane: ``obs/perf.ClockOffset`` and
``WindowSums``, ``obs/trace.merge_chrome``, the router's metrics federation
(``federate``, ``_parse_exposition``), its client-seat SLO windows, the
clock-offset poller, the merged mesh trace, trace propagation through a
failover and the cross-hop postmortem.

* The JAX suite's ``tests/test_fleet_obs.py`` drills run unchanged against
  the port: the module's package objects (``ClockOffset``, ``SloPolicy``,
  ``Router``, ``federate``, ``make_router``, ``ins``, ``metrics``,
  ``trace``) are swapped for the port's while a drill runs, and the stub
  mesh it uses is fronted by the port's router.
* On seeded random inputs the port's ``ClockOffset``, ``WindowSums``,
  ``federate`` and ``_parse_exposition`` give the JAX package's outputs.
"""

import random
import threading

import pytest
import torch

import tests.test_fleet_obs as jf
from dllama_tpu_torch.obs import instruments as ins
from dllama_tpu_torch.obs import metrics, trace
from dllama_tpu_torch.obs.perf import ClockOffset, SloPolicy, WindowSums
from dllama_tpu_torch.serve import router as router_mod
from tests.test_router import StubState, make_stub

torch.set_num_threads(1)

#: the JAX drill module's package globals and the port's objects for them
PORT = {"ins": ins, "metrics": metrics, "trace": trace, "ClockOffset": ClockOffset,
        "SloPolicy": SloPolicy, "Router": router_mod.Router, "federate": router_mod.federate,
        "make_router": router_mod.make_router}


@pytest.fixture
def port_globals(monkeypatch):
    for name, obj in PORT.items():
        monkeypatch.setattr(jf, name, obj)


@pytest.fixture
def obs_mesh(port_globals):
    """Two stub replicas with skewed clocks behind the port's router (its
    poller inert at poll_s=30: drills call _poll_one themselves)."""
    a, b = StubState("stub-a"), StubState("stub-b")
    a.clock_skew, b.clock_skew = 2.5, -1.25
    ha, hb = make_stub(a), make_stub(b)
    server, router = router_mod.make_router([f"127.0.0.1:{ha.server_address[1]}",
                                             f"127.0.0.1:{hb.server_address[1]}"],
                                            poll_s=30.0)
    router.start()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield server.server_address[1], router, (a, b), (ha, hb)
    router.stop()
    for h in (server, ha, hb):
        try:
            h.shutdown()
            h.server_close()
        except OSError:
            pass


UNIT_DRILLS = ["test_clock_offset_empty_and_basic", "test_clock_offset_min_rtt_sample_wins",
               "test_clock_offset_window_slides", "test_merge_chrome_relabels_shifts_and_sorts",
               "test_merge_chrome_tolerates_empty_parts",
               "test_merge_chrome_real_tracers_stay_monotone",
               "test_federate_relabels_and_preaggregates",
               "test_federate_drops_garbage_keeps_rest",
               "test_histogram_federation_equals_union_registry"]
MESH_DRILLS = ["test_poller_estimates_skewed_clocks",
               "test_fleet_obs_off_disables_clock_and_tracer",
               "test_merged_trace_shifts_replica_onto_router_clock",
               "test_router_metrics_endpoint_federates",
               "test_federation_staleness_holds_last_scrape",
               "test_router_client_slo_windows_and_attainment",
               "test_router_fleet_endpoint_joins_health_and_clock",
               "test_trace_propagation_and_postmortem_across_failover",
               "test_non_stream_and_shed_outcomes_recorded"]


@pytest.mark.parametrize("drill", UNIT_DRILLS)
def test_unit_drill(port_globals, drill):
    """One of the JAX suite's unit drills, on the port's objects."""
    assert jf.ClockOffset is ClockOffset and jf.federate is router_mod.federate
    getattr(jf, drill)()


@pytest.mark.parametrize("drill", MESH_DRILLS)
def test_mesh_drill(obs_mesh, drill):
    """One of the JAX suite's stub-mesh drills, against the port's router."""
    assert isinstance(obs_mesh[1], router_mod.Router)
    getattr(jf, drill)(obs_mesh)


@pytest.mark.parametrize("seed", range(3))
def test_clock_offset_equals_jax(seed):
    from dllama_tpu.obs.perf import ClockOffset as JaxClockOffset

    rnd = random.Random(seed)
    port, jax_ = ClockOffset(window=5), JaxClockOffset(window=5)
    assert port.estimate() is None and jax_.estimate() is None
    for _ in range(12):
        t = rnd.uniform(0, 100)
        args = (t, t + rnd.uniform(0, 0.05), t + rnd.uniform(-3, 3))
        port.sample(*args)
        jax_.sample(*args)
        assert port.estimate() == jax_.estimate()


@pytest.mark.parametrize("seed", range(3))
def test_window_sums_equal_jax(seed):
    from dllama_tpu.obs.perf import WindowSums as JaxWindowSums

    rnd = random.Random(seed)
    now = [1000.0]
    port, jax_ = (cls(window_s=6.0, slices=3, now_fn=lambda: now[0])
                  for cls in (WindowSums, JaxWindowSums))
    for _ in range(40):
        now[0] += rnd.uniform(0, 1.5)
        fields = {k: rnd.randrange(0, 1024) / 64.0
                  for k in rnd.sample(["tokens", "bytes", "chunks"], 2)}
        port.add(**fields)
        jax_.add(**fields)
        assert port.totals() == jax_.totals() and port.span_s() == jax_.span_s()


def _random_exposition(rnd, seed):
    reg = metrics.Registry()
    c = reg.counter("dllama_things_total", "things", ("kind",))
    g = reg.gauge("dllama_level", "level")
    h = reg.histogram("dllama_wait_seconds", "wait", ("op",), buckets=(0.5, 1.0, 2.0))
    for _ in range(30):
        c.labels(kind=rnd.choice("abc")).inc(rnd.randrange(1, 5))
        h.labels(op=rnd.choice(["x", "y"])).observe(rnd.randrange(0, 512) / 128.0)
    g.set(seed)
    return reg.render()


@pytest.mark.parametrize("seed", range(3))
def test_federate_and_parse_exposition_equal_jax(seed):
    """federate() and _parse_exposition() of the port and of the JAX
    package give the same text and parse on the same expositions (garbage
    lines included)."""
    from dllama_tpu.serve.router import _parse_exposition as jax_parse
    from dllama_tpu.serve.router import federate as jax_federate

    rnd = random.Random(seed)
    parts = [(f"r{i}", _random_exposition(rnd, i) + ("junk line !!\n" if i else ""))
             for i in range(3)]
    own = _random_exposition(rnd, 9)
    assert router_mod.federate(own, parts) == jax_federate(own, parts)
    for _, text in parts:
        assert router_mod._parse_exposition(text) == jax_parse(text)
