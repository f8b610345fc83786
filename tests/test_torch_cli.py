"""The port's CLI flags of the observability and supervision slices: `--frontend` defaults
to aio (as in the JAX package's CLI), `--log-format json` lines of a served
request carry its request_id, `--trace DIR` writes a torch.profiler Chrome
trace and `--report` prints the memory and per-token report, and
`--transfer-guard`, `--restart-max` and the other supervision flags pass
startup, on one device and on a mesh, with the JAX parser's defaults."""

import contextlib
import http.client
import io
import json
import logging
import os
import threading

import pytest
import torch

from tests.test_golden import FIXTURE_M
from tests.test_torch_continuous_serve import _tokenizer_path
from tests.test_torch_isolation import _tokenizer

torch.set_num_threads(1)


def test_frontend_defaults_to_aio_like_the_jax_cli():
    from dllama_tpu.cli.main import build_parser as jax_parser
    from dllama_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args(["serve", "--model", "m"])
    jargs = jax_parser().parse_args(["serve", "--model", "m"])
    assert args.frontend == jargs.frontend == "aio"
    for flag in ("aio_workers", "log_format", "trace", "trace_buffer", "slo_ttft_ms",
                 "slo_itl_ms", "report", "transfer_guard", "faults", "stall_deadline_s",
                 "restart_max", "restart_window_s", "port", "model"):
        assert getattr(args, flag) == getattr(jargs, flag), flag
    # the router mode: --model optional, the JAX parser's defaults
    argv = ["router", "--replica", "127.0.0.1:9990", "--replica", "127.0.0.1:9991"]
    args, jargs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for flag in ("mode", "model", "replica", "affinity", "poll_s", "router_workers",
                 "failover_max", "fleet_obs", "port", "host", "drain_timeout_s"):
        assert getattr(args, flag) == getattr(jargs, flag), flag


def test_transfer_guard_is_refused(capsys):
    """--transfer-guard is ported now: every mode passes the refusal and
    stops only at the missing tokenizer (exit 1); so does a warm restart on
    a mesh; a bad --faults spec stops startup (exit 2)."""
    from dllama_tpu_torch.cli.main import main
    from dllama_tpu_torch.utils import faults

    for mode in ("strict", "log", "off"):
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", "2",
                     "--transfer-guard", mode]) == 1
        assert "not yet ported" not in capsys.readouterr().err
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--mesh", "tp=2",
                 "--slots", "2", "--restart-max", "1"]) == 1
    assert capsys.readouterr().err == "serve mode requires --tokenizer\n"
    try:
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu",
                     "--faults", "nope.where:raise"]) == 2
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu",
                     "--faults", "engine.decode:raise:after=1000"]) == 1
        assert faults.active("engine.decode")
    finally:
        faults.clear()
    # --frontend aio is no longer refused: it stops at the missing tokenizer
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--frontend", "aio"]) == 1
    assert main(["serve", "--device", "cpu"]) == 1  # --model is required outside router


@contextlib.contextmanager
def _root_logging():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        yield
    finally:
        root.handlers[:] = handlers
        root.setLevel(level)


def test_json_log_lines_carry_request_id(tmp_path_factory):
    """The CLI's logging setup for `--log-format json`, then a served
    request with an X-Request-Id: the request's log lines are JSON objects
    carrying that id."""
    from dllama_tpu_torch.cli.main import build_parser
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server
    from dllama_tpu_torch.utils.logs import setup_logging

    args = build_parser().parse_args(["serve", "--model", FIXTURE_M, "--log-format", "json"])
    err = io.StringIO()
    tpath = _tokenizer_path(tmp_path_factory)
    with _root_logging():
        with contextlib.redirect_stderr(err):
            setup_logging(fmt=args.log_format)
        httpd, api = make_server(load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                            device="cpu"), n_slots=2, kv_layout="paged",
                                 page_size=16, frontend=args.frontend)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=60)
            conn.request("POST", "/v1/chat/completions",
                         json.dumps({"messages": [{"role": "user", "content": "hi"}],
                                     "max_tokens": 3, "temperature": 0}),
                         {"Content-Type": "application/json", "X-Request-Id": "cli-json-1"})
            resp = conn.getresponse()
            assert resp.status == 200 and resp.getheader("X-Request-Id") == "cli-json-1"
            resp.read()
            conn.close()
        finally:
            api.scheduler.shutdown()
            httpd.shutdown()
            httpd.server_close()
    lines = [json.loads(ln) for ln in err.getvalue().splitlines() if ln.startswith("{")]
    mine = [ln for ln in lines if ln.get("request_id") == "cli-json-1"]
    assert mine and all(ln["level"] and ln["logger"].startswith("dllama_tpu_torch")
                        for ln in mine)
    assert any("done" in ln["msg"] for ln in mine)


def test_inference_trace_and_report(tmp_path, capsys):
    from dllama_tpu_torch.cli.main import main
    from dllama_tpu_torch.obs import trace

    out = str(tmp_path / "trace")
    prev = trace.TRACER
    try:
        with _root_logging():
            rc = main(["inference", "--model", FIXTURE_M, "--tokenizer", _tokenizer(tmp_path),
                       "--prompt", "hi", "--steps", "4", "--device", "cpu", "--temperature",
                       "0", "--trace", out, "--report", "--trace-buffer", "0"])
        assert not trace.TRACER.enabled  # --trace-buffer 0: the no-op tracer
    finally:
        trace.TRACER = prev
    assert rc == 0
    err = capsys.readouterr().err
    assert "params" in err and "kv-cache" in err and "tok/s" in err
    assert os.path.join(out, "trace.json") in err
    with open(os.path.join(out, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_setup_logging_formats(fmt):
    from dllama_tpu_torch.utils.logs import setup_logging

    err = io.StringIO()
    with _root_logging():
        with contextlib.redirect_stderr(err):
            setup_logging(fmt=fmt)
        logging.getLogger("dllama_tpu_torch.serve").info("hello %s", "x",
                                                          extra={"request_id": "r-1"})
    line = err.getvalue().strip().splitlines()[-1]
    if fmt == "json":
        assert json.loads(line)["request_id"] == "r-1"
    else:
        assert line.endswith("request_id=r-1") and "hello x" in line
