"""The port stands alone: no module of `dllama_tpu_torch`, and nothing in
`chip_smoke.py` or `kernel_proof.py`, imports JAX or the JAX package; its CLI runs on the CPU
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
                    if "build" not in p.parts) + [ROOT / "chip_smoke.py",
                                                  ROOT / "kernel_proof.py"]


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
        "import dllama_tpu_torch, chip_smoke, kernel_proof\n"
        "for m in pkgutil.walk_packages(dllama_tpu_torch.__path__, 'dllama_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dllama_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


#: packages the card's machine does not have: the converters read their
#: formats themselves (safetensors, the sentencepiece protobuf, tiktoken's
#: base64 vocabulary)
CONVERTER_PACKAGES = ("safetensors", "sentencepiece", "tiktoken", "transformers")


def test_no_port_module_imports_the_converter_packages():
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in CONVERTER_PACKAGES, f"{path}: imports {n}"


def test_the_import_walk_reaches_the_tools_and_the_chaos_drill():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dllama_tpu_torch\n"
        "seen = set()\n"
        "for m in pkgutil.walk_packages(dllama_tpu_torch.__path__, 'dllama_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "        seen.add(m.name)\n"
        "want = {'dllama_tpu_torch.tools.' + n for n in ('converter_core', 'convert_hf',\n"
        "        'convert_llama', 'convert_tokenizer', 'launch')}\n"
        "want |= {'dllama_tpu_torch.experiments.chaos', 'dllama_tpu_torch.utils.native'}\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {CONVERTER_PACKAGES!r}]\n"
        "print(sorted(want - seen), bad)\n"
        "sys.exit(1 if want - seen or bad else 0)\n")
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
    import pytest

    from dllama_tpu_torch.cli.main import _parse_tenant_weights, main
    from dllama_tpu_torch.engine.batch import BatchEngine
    from dllama_tpu_torch.engine.loader import load_model

    # every mesh axis runs, and so does a warm restart on a mesh: it passes
    # startup and stops at the missing tokenizer
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--mesh", "tp=2",
                 "--slots", "2", "--restart-max", "1"]) == 1
    # supervision is ported: the transfer guard, warm restarts, the watchdog
    # and fault injection pass the refusal and stop at the missing tokenizer
    for flag in (["--transfer-guard", "strict"], ["--restart-max", "1"],
                 ["--stall-deadline-s", "2", "--restart-window-s", "30"],
                 ["--faults", "engine.decode:raise:after=1000000"]):
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", "2",
                     *flag]) == 1, flag
    from dllama_tpu_torch.utils import faults

    faults.clear()  # the --faults case armed the process-wide plan
    # the batched tier is ported: --slots passes the refusal and stops only
    # at the missing tokenizer (exit 1)
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", "2",
                 "--kv-layout", "paged", "--radix-cache", "auto", "--preempt", "off"]) == 1
    # so are the radix tree, preemption, the host spill tier and tenant
    # weights, and the two combinations the JAX server warns about and drops
    for flag in (["--radix-cache", "on"], ["--preempt", "on"], ["--kv-host-pages", "8"],
                 ["--tenant-weight", "a=2"],
                 ["--radix-cache", "on", "--kv-layout", "dense"],
                 ["--kv-host-pages", "8", "--radix-cache", "off"]):
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", "2",
                     *flag]) == 1, flag
    assert _parse_tenant_weights(["paid=4", "free=1"]) == {"paid": 4.0, "free": 1.0}
    for bad in ("a", "a=0", "=2", "a=nan", "a=inf"):
        with pytest.raises(SystemExit):
            _parse_tenant_weights([bad])
    # the engine raises JAX's two errors on a direct library misuse
    loaded = load_model(FIXTURE_M, device="cpu")
    kw = dict(n_slots=2, cache_dtype=torch.float32, page_size=16)
    with pytest.raises(ValueError, match="requires the paged KV layout"):
        BatchEngine(loaded.config, loaded.engine.params, kv_layout="dense", radix_cache="on",
                    **kw)
    with pytest.raises(ValueError, match="requires the paged KV layout with the radix"):
        BatchEngine(loaded.config, loaded.engine.params, kv_layout="paged", radix_cache="off",
                    kv_host_pages=8, **kw)
    # so is hybrid chunked prefill at any budget
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", "2",
                 "--prefill-budget", "64"]) == 1
    # so is speculation on the single-engine tier (--spec without --slots),
    # and on the batched tier (--spec or --spec-k with --slots)
    assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--spec", "4"]) == 1
    for flag in (["--slots", "2", "--spec", "4"], ["--slots", "2", "--spec-k", "4"]):
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", *flag]) == 1, flag
    # and --warmup, on both tiers (the single-engine tier ignores it)
    for slots in ("0", "2"):
        assert main(["serve", "--model", FIXTURE_M, "--device", "cpu", "--slots", slots,
                     "--warmup", "auto"]) == 1
