"""The port's model-zoo launcher (``dllama_tpu_torch/tools/launch.py``)
against the JAX package's: the same registry, the multi-part download
exercised offline through ``file://`` parts, a clean failure, and a ``run``
command for this package's CLI."""

import dataclasses
import os
import sys

import pytest

from dllama_tpu_torch.tools import launch


def test_registry_equals_jax():
    from dllama_tpu.tools import launch as jax_launch

    assert list(launch.MODELS) == list(jax_launch.MODELS)
    for name, m in launch.MODELS.items():
        assert dataclasses.asdict(m) == dataclasses.asdict(jax_launch.MODELS[name]), name
        assert (m.model_file, m.tokenizer_file) == (jax_launch.MODELS[name].model_file,
                                                    jax_launch.MODELS[name].tokenizer_file)
    assert len(launch.MODELS["llama3_1_405b_instruct_q40"].model_urls) == 56
    assert len(launch.MODELS["llama3_3_70b_instruct_q40"].model_urls) == 11
    assert launch._parts(3) == ["aa", "ab", "ac"] and launch._parts(30) == jax_launch._parts(30)


def test_download_multipart_concatenates(tmp_path, capsys):
    parts = [tmp_path / f"part{i}" for i in range(3)]
    for i, p in enumerate(parts):
        p.write_bytes(bytes([i]) * 10)
    out = str(tmp_path / "joined.bin")
    launch.download_file([f"file://{p}" for p in parts], out)
    assert open(out, "rb").read() == b"\x00" * 10 + b"\x01" * 10 + b"\x02" * 10
    # a second call skips the finished file (resume semantics)
    launch.download_file([f"file://{parts[0]}"], out)
    assert "skipping" in capsys.readouterr().out
    assert os.path.getsize(out) == 30


def test_download_failure_is_clean(tmp_path):
    out = str(tmp_path / "x.bin")
    good = tmp_path / "good"
    good.write_bytes(b"abc")
    # the second part is missing: nothing of the first may stay behind
    with pytest.raises(SystemExit, match="download failed"):
        launch.download_file([f"file://{good}", f"file://{tmp_path}/missing"], out)
    assert not os.path.exists(out) and not os.path.exists(out + ".part")


@pytest.mark.parametrize("mode", ["chat", "inference", "serve"])
def test_run_prints_the_ports_cli(capsys, mode):
    from dllama_tpu.tools import launch as jax_launch

    m = launch.MODELS["llama3_2_1b_instruct_q40"]
    cmd = launch.run_command(m, "m", mode)
    want = jax_launch.run_command(jax_launch.MODELS[m.name], "m", mode)
    assert cmd[:3] == [sys.executable, "-m", "dllama_tpu_torch"]
    assert want[:3] == [sys.executable, "-m", "dllama_tpu"]
    assert cmd[3:] == want[3:]
    assert launch.main(["run", m.name, "--dir", "m", "--mode", mode]) == 0
    out = capsys.readouterr().out
    assert f"-m dllama_tpu_torch {mode}" in out
    assert "m/dllama_model_llama3_2_1b_instruct_q40.m" in out and "--max-seq-len 4096" in out


def test_cli_list(capsys):
    assert launch.main(["list"]) == 0
    out = capsys.readouterr().out
    assert "llama3_1_8b_instruct_q40" in out and "238.0 GB" in out
    assert len(out.strip().splitlines()) == len(launch.MODELS)


def test_cli_download_from_file_parts(tmp_path, monkeypatch, capsys):
    """`download` of a registry entry whose parts are local files: the model
    parts concatenated, the tokenizer fetched, then the run command."""
    parts = []
    for i, chunk in enumerate((b"MODEL-A", b"MODEL-B")):
        p = tmp_path / f"m.{launch._parts(2)[i]}"
        p.write_bytes(chunk)
        parts.append(f"file://{p}")
    (tmp_path / "tok.t").write_bytes(b"TOK")
    entry = launch.ZooModel("local_q40", tuple(parts), f"file://{tmp_path / 'tok.t'}", 0.0)
    monkeypatch.setitem(launch.MODELS, entry.name, entry)
    d = tmp_path / "models"
    assert launch.main(["download", entry.name, "--dir", str(d)]) == 0
    assert (d / entry.model_file).read_bytes() == b"MODEL-AMODEL-B"
    assert (d / entry.tokenizer_file).read_bytes() == b"TOK"
    assert "-m dllama_tpu_torch chat" in capsys.readouterr().out


@pytest.mark.parametrize("module,argv,want", [
    ("dllama_tpu_torch.tools.launch", ["list"], "llama3_1_8b_instruct_q40"),
    ("dllama_tpu_torch.tools.convert_hf", ["--help"], "model_dir"),
    ("dllama_tpu_torch.tools.convert_llama", ["--help"], "model_dir"),
    ("dllama_tpu_torch.tools.convert_tokenizer", ["--help"], "{hf,llama2,llama3}"),
    ("dllama_tpu_torch.experiments.chaos", ["--help"], "--mesh"),
])
def test_python_dash_m_runs_each_tool(module, argv, want):
    import pathlib
    import subprocess

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=root, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(root), CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    assert want in out.stdout
