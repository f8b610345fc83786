"""The port stands alone: no module of `dllama_tpu_torch`, and nothing in
`chip_smoke.py`, imports JAX or the JAX package; its CLI runs on the CPU
only when asked to, and says so when no CUDA device is there."""

import ast
import os
import pathlib
import subprocess
import sys

import torch

from tests.test_golden import FIXTURE_M

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(p for p in (ROOT / "dllama_tpu_torch").rglob("*.py")
                    if "build" not in p.parts) + [ROOT / "chip_smoke.py"]


def _env():
    # no CUDA device even where one exists; one CPU thread per process
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT))


def test_no_jax_or_jax_package_import_in_the_source():
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "dllama_tpu"), f"{path}: imports {n}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dllama_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(dllama_tpu_torch.__path__, 'dllama_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dllama_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _tokenizer(tmp_path) -> str:
    from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer

    # the golden model's 1057 ids: bytes, inert filler pieces, then bos/eos
    vocab = [bytes([i]) for i in range(256)] + [f"<t{i}>".encode() for i in range(256, 1055)]
    vocab += [b"<s>", b"</s>"]
    path = str(tmp_path / "tok.t")
    Tokenizer(vocab, [0.0] * len(vocab), 1055, [1056]).save(path)
    return path


def _inference(tmp_path, *extra):
    cmd = [sys.executable, "-m", "dllama_tpu_torch", "inference", "--model", FIXTURE_M,
           "--tokenizer", _tokenizer(tmp_path), "--prompt", "hi", "--steps", "4", *extra]
    return subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=120)


def test_cli_without_a_gpu_refuses_to_run_on_the_cpu(tmp_path):
    out = _inference(tmp_path)
    assert out.returncode != 0
    assert "no CUDA device was found" in out.stderr


def test_cli_on_the_cpu_when_asked(tmp_path):
    out = _inference(tmp_path, "--device", "cpu", "--temperature", "0")
    assert out.returncode == 0, out.stderr
    assert "Decode:" in out.stderr


def test_unported_options_are_refused():
    from dllama_tpu_torch.cli.main import main

    for flag in (["--warmup", "auto"], ["--mesh", "tp=2"],
                 ["--frontend", "aio"], ["--slots", "2", "--spec", "4"],
                 ["--slots", "2", "--radix-cache", "on"],
                 ["--slots", "2", "--prefill-budget", "64"],
                 ["--slots", "2", "--preempt", "on"], ["--slots", "2", "--kv-host-pages", "8"],
                 ["--slots", "2", "--tenant-weight", "a=2"], ["--slots", "2", "--warmup", "auto"],
                 ["--slots", "2", "--restart-max", "1"]):
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", *flag]) == 2, flag
    # the batched tier is ported: --slots passes the refusal and stops only
    # at the missing tokenizer (exit 1)
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", "2",
                 "--kv-layout", "paged", "--radix-cache", "auto", "--preempt", "off"]) == 1
    # so is speculation on the single-engine tier (--spec without --slots)
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--spec", "4"]) == 1
