"""Supervision of a mesh's ranks when one dies, on the CPU (each rank a
process over gloo):

* A follower SIGKILLed while a Scheduler with a restart budget serves a
  stream: the exchange in flight fails, the world is broken, the warm
  restart refuses it (the ranks cannot agree), the stream ends in an
  error and supervision stays down (live false); the next call raises.
* The heartbeat watch over ranks on other hosts: two ``--distributed``
  ``serve`` processes on localhost (the watch's timeout shortened to 3 s
  in both), the follower process SIGKILLed: rank 0, which has no local
  child to poll, sees its heartbeat stop and exits non-zero within the
  timeout (the JAX package's fail-stop after its coordination service's
  heartbeat timeout).
"""

import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dllama_tpu_torch.engine.loader import load_model
from dllama_tpu_torch.serve.scheduler import Scheduler
from tests.test_golden import FIXTURE_M
from tests.test_torch_faults import drain_tokens
from tests.test_torch_mesh_cli import ROOT, _env, _free_port
from tests.test_torch_continuous_serve import _tokenizer_path

torch.set_num_threads(1)

#: the heartbeat timeout of the processes test_a_dead_process_on_another_host
#: starts (JAX's default, the module's, is 100 s)
SHORT_TIMEOUT_S = 3.0


def test_a_follower_killed_mid_stream_breaks_the_world():
    m = load_model(FIXTURE_M, mesh="tp=2", device="cpu", cache_dtype=torch.float32)
    world = m.world
    try:
        be = world.make("batch", n_slots=2, cache_dtype=torch.float32)
        sched = Scheduler(be, restart_max=2, restart_backoff_s=0.01)
        try:
            req = sched.submit([801, 799, 777, 46], 0.0, 0.9, 48, frozenset(), seed=1)
            it = req.tokens()
            head = [next(it) for _ in range(4)]
            world.children[0].send_signal(signal.SIGKILL)
            toks, exc = drain_tokens(req, timeout=30.0)
            assert exc is not None and len(head) + len(toks) < 48
            deadline = time.monotonic() + 10
            while sched.crashed is None and time.monotonic() < deadline:
                time.sleep(0.01)
            health = sched.health()
            assert world.link.closed
            assert health["live"] is False and health["crashed"] is not None
            assert health["restarts"] <= 1  # an attempt, refused by the broken world
        finally:
            sched.shutdown()
        with pytest.raises(RuntimeError, match="command channel is closed"):
            m.engine.prefill(np.asarray([[801, 799]]))
    finally:
        world.close()


def _serve(tok: str, port: int, process: int, coordinator: str) -> subprocess.Popen:
    """The CLI's `serve` as process `process` of a two-process world, with
    the heartbeat timeout set to SHORT_TIMEOUT_S in that process."""
    code = ("import sys; from dllama_tpu_torch.parallel import multihost; "
            f"multihost.HEARTBEAT_TIMEOUT_S = {SHORT_TIMEOUT_S}; "
            "from dllama_tpu_torch.cli.main import main; sys.exit(main(sys.argv[1:]))")
    argv = ["serve", "--model", FIXTURE_M, "--tokenizer", tok, "--device", "cpu",
            "--slots", "2", "--port", str(port), "--distributed", "--coordinator",
            coordinator, "--num-processes", "2", "--process-id", str(process)]
    return subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_a_dead_process_on_another_host_ends_rank_0(tmp_path_factory):
    tok = _tokenizer_path(tmp_path_factory)
    coordinator = f"127.0.0.1:{_free_port()}"
    follower = _serve(tok, _free_port(), 1, coordinator)
    driver = _serve(tok, _free_port(), 0, coordinator)
    lines = []
    try:
        deadline = time.monotonic() + 120
        for line in driver.stdout:
            lines.append(line)
            if "/v1/chat/completions" in line or time.monotonic() > deadline:
                break
        assert driver.poll() is None and follower.poll() is None, "".join(lines)
        follower.send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        code = driver.wait(timeout=SHORT_TIMEOUT_S * 3 + 10)
        waited = time.monotonic() - t0
        out = "".join(lines) + driver.stdout.read()
        assert code != 0
        assert "heartbeat has not moved" in out and "the world is broken" in out
        assert waited < SHORT_TIMEOUT_S * 2 + 2, waited
    finally:
        for p in (driver, follower):
            p.kill()
            p.wait()
