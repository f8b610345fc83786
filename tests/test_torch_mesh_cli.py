"""The CLI on a tensor-parallel mesh, on the CPU (each rank a process, gloo):

* ``inference --device cpu --mesh tp=2`` prints the same greedy text as
  ``--no-mesh``, and so do ``--mesh dp=2``, ``sp=2``, ``dp=2,tp=2`` and
  ``sp=2,tp=2``, and two ``--distributed`` processes on localhost;
* ``--mesh tp=2,pp=2`` / ``tp=2,ep=2`` pass the refusal; ``--faults``,
  ``$DLLAMA_FAULTS`` and ``--restart-max`` on the mesh that runs (the
  default ``--mesh auto`` on two cards included) pass startup and stop
  where the same command without a mesh stops; a mesh larger than the
  cards exits 2;
* ``serve --mesh tp=2`` answers a chat completion on both tiers, a
  SIGKILLed rank 0 leaves no live worker after 10 s, and a SIGKILLed
  worker ends the server non-zero within 10 s.
"""

import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.test_golden import FIXTURE_M
from tests.test_torch_continuous_serve import _tokenizer_path
from tests.test_torch_isolation import _tokenizer

ROOT = Path(__file__).resolve().parent.parent


def _env():
    # no CUDA device even where one exists; one CPU thread per process
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT))


def _free_port() -> int:
    """A port a server can bind, drawn below the kernel's ephemeral range
    (32768-60999 by default): a port the kernel hands out (bind to 0) may
    be handed again, before the server binds it, to one of the many gloo
    connections that other test files' worlds open meanwhile."""
    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    for port in rng.sample(range(20000, 32000), 64):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in 20000-32000")


def _inference_argv(tok, *extra):
    return [sys.executable, "-m", "dllama_tpu_torch", "inference", "--model", FIXTURE_M,
            "--tokenizer", tok, "--prompt", "hello there", "--steps", "12", "--device",
            "cpu", "--temperature", "0", *extra]


@pytest.fixture(scope="module")
def no_mesh_text(tmp_path_factory):
    tok = _tokenizer(tmp_path_factory.mktemp("mesh_cli"))
    out = subprocess.run(_inference_argv(tok, "--no-mesh"), cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return tok, out.stdout


def test_inference_tp2_prints_the_no_mesh_text(no_mesh_text):
    tok, want = no_mesh_text
    out = subprocess.run(_inference_argv(tok, "--mesh", "tp=2", "--report"), cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want and want.strip()
    assert "'tp': 2" in out.stderr and "measured in one decode step" in out.stderr


def test_two_distributed_processes_print_the_no_mesh_text(no_mesh_text):
    tok, want = no_mesh_text
    flags = ["--distributed", "--coordinator", f"127.0.0.1:{_free_port()}",
             "--num-processes", "2"]
    procs = [subprocess.Popen(_inference_argv(tok, *flags, "--process-id", str(i)), cwd=ROOT,
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in (1, 0)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[1][1]
    follower, driver = outs
    assert driver[0] == want
    assert follower[0] == ""  # process 1 follows: the text is process 0's alone


@pytest.mark.parametrize("mesh", ["dp=2", "sp=2", "dp=2,tp=2", "sp=2,tp=2"])
def test_inference_dp_and_sp_print_the_no_mesh_text(no_mesh_text, mesh):
    """dp and sp are ported: the greedy text on each mesh is --no-mesh's."""
    tok, want = no_mesh_text
    out = subprocess.run(_inference_argv(tok, "--mesh", mesh, "--report"), cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == want and want.strip()
    for part in mesh.split(","):
        ax, n = part.split("=")
        assert f"'{ax}': {n}" in out.stderr


@pytest.mark.parametrize("axis", ["pp", "ep"])
def test_unported_mesh_axes_exit_2_by_name(axis, capsys):
    """pp and ep are ported: ``--mesh tp=2,pp=2`` (the fixture's 2 layers,
    one a stage) and ``--mesh tp=2,ep=2`` pass the refusal and stop where
    the same command on ``--mesh tp=2`` stops (the missing --prompt)."""
    from dllama_tpu_torch.cli.main import main

    argv = ["inference", "--model", FIXTURE_M, "--device", "cpu", "--mesh"]
    assert main(argv + ["tp=2"]) == 1
    want = capsys.readouterr().err
    assert main(argv + [f"tp=2,{axis}=2"]) == 1
    got = capsys.readouterr().err
    assert got == want == "inference mode requires --prompt\n"


def test_faults_and_restarts_on_a_mesh_exit_2(capsys):
    """Supervision runs on a mesh: ``--faults`` (armed on rank 0, whose
    plan the followers take) and ``--restart-max`` with ``--mesh tp=2``
    pass startup and stop where the same command without a mesh stops (the
    missing tokenizer, exit 1), alone and together."""
    from dllama_tpu_torch.cli.main import main
    from dllama_tpu_torch.utils import faults

    base = ["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", "2"]
    for flags in (["--faults", "engine.decode:raise:after=1000"], ["--restart-max", "1"],
                  ["--restart-max", "1", "--faults", "engine.decode:raise:after=1000"]):
        try:
            assert main(base + flags) == 1
            want = capsys.readouterr().err.splitlines()[-1]
            assert main(base + ["--mesh", "tp=2"] + flags) == 1
            got = capsys.readouterr().err.splitlines()[-1]  # after the ARMED warning
            assert got == want == "serve mode requires --tokenizer"
            assert faults.active("engine.decode") == ("--faults" in flags)
        finally:
            faults.clear()


def test_refusals_follow_the_mesh_that_runs(monkeypatch, capsys):
    """On a machine with two cards the default --mesh auto resolves to tp=2
    for the fixture (2 kv heads): warm restarts and $DLLAMA_FAULTS pass
    startup there and stop at the missing tokenizer, as on one device; a
    mesh of more ranks than cards exits 2 with the device count."""
    import torch

    from dllama_tpu_torch.cli.main import main
    from dllama_tpu_torch.utils import faults

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert main(["serve", "--model", FIXTURE_M, "--slots", "2", "--restart-max", "1"]) == 1
    assert capsys.readouterr().err == "serve mode requires --tokenizer\n"
    monkeypatch.setenv("DLLAMA_FAULTS", "engine.decode:raise:after=1000")
    try:
        assert main(["serve", "--model", FIXTURE_M]) == 1
        assert capsys.readouterr().err.splitlines()[-1] == "serve mode requires --tokenizer"
        assert faults.active("engine.decode")
    finally:
        faults.clear()
    monkeypatch.delenv("DLLAMA_FAULTS")
    assert main(["inference", "--model", FIXTURE_M, "--mesh", "tp=4"]) == 2
    assert "--mesh tp=4: the mesh needs 4 devices, have 2" in capsys.readouterr().err


def _children(pid: int) -> list[int]:
    path = Path(f"/proc/{pid}/task/{pid}/children")
    return [int(x) for x in path.read_text().split()] if path.exists() else []


def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False
    return state not in ("Z", "X")


@pytest.mark.parametrize("slots", [0, 2])
def test_serve_tp2_answers_and_a_killed_driver_leaves_no_worker(slots, tmp_path_factory):
    tok = _tokenizer_path(tmp_path_factory)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dllama_tpu_torch", "serve", "--model", FIXTURE_M,
         "--tokenizer", tok, "--device", "cpu", "--mesh", "tp=2", "--slots", str(slots),
         "--port", str(port), "--temperature", "0"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    workers: list[int] = []
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if "/v1/chat/completions" in line or time.monotonic() > deadline:
                break
        assert proc.poll() is None, "the server exited before it was ready"
        workers = _children(proc.pid)
        assert len(workers) == 1 and _alive(workers[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
                "temperature": 0}
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = json.loads(resp.read())
        assert resp.status == 200, reply
        assert reply["usage"]["completion_tokens"] >= 1
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        end = time.monotonic() + 10
        while _alive(workers[0]) and time.monotonic() < end:
            time.sleep(0.1)
        assert not _alive(workers[0]), "a worker outlived its driver"
    finally:
        proc.kill()
        proc.wait()
        for pid in workers:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)


def test_serve_tp2_a_killed_worker_ends_the_driver(tmp_path_factory):
    """Rank 0 watches its local worker: a worker SIGKILLed while the server
    idles breaks the world, and the server exits non-zero (fail-stop)."""
    tok = _tokenizer_path(tmp_path_factory)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dllama_tpu_torch", "serve", "--model", FIXTURE_M,
         "--tokenizer", tok, "--device", "cpu", "--mesh", "tp=2", "--slots", "2",
         "--port", str(_free_port())],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            if "/v1/chat/completions" in line or time.monotonic() > deadline:
                break
        workers = _children(proc.pid)
        assert proc.poll() is None and len(workers) == 1
        os.kill(workers[0], signal.SIGKILL)
        assert proc.wait(timeout=10) != 0
        assert "the world is broken" in proc.stdout.read()
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("mesh,slots", [("dp=2", 2), ("sp=2", 0)])
def test_serve_dp_and_sp_answer(mesh, slots, tmp_path_factory):
    """`serve --mesh dp=2 --slots 2 --spec 2` (speculation warned off on dp,
    as in the JAX package) and `serve --mesh sp=2` answer a greedy chat
    completion."""
    tok = _tokenizer_path(tmp_path_factory)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dllama_tpu_torch", "serve", "--model", FIXTURE_M,
         "--tokenizer", tok, "--device", "cpu", "--mesh", mesh, "--slots", str(slots),
         "--spec", "2", "--port", str(port), "--temperature", "0"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            lines.append(line)
            if "/v1/chat/completions" in line or time.monotonic() > deadline:
                break
        assert proc.poll() is None, "".join(lines)
        if slots:
            assert any("--spec is unavailable on dp>1 meshes" in ln for ln in lines)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
                "temperature": 0}
        conn.request("POST", "/v1/chat/completions", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        reply = json.loads(resp.read())
        assert resp.status == 200, reply
        assert reply["usage"]["completion_tokens"] >= 1
    finally:
        proc.kill()
        proc.wait()
