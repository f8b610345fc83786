"""The port's kernel benchmark (dllama_tpu_torch/experiments/kbench.py):

* the plain versions of its two kernels (K11-B, the f32-FMA Q40 product, and
  K11-D, the bf16-weight product), which the CUDA kernels are held against
  on the card, equal the JAX benchmark's Pallas kernels (_kernel_b,
  _kernel_d through make_call) in interpret mode at the smoke shapes: f32
  results within 1e-5 * max|ref| (the same products, only the order of the
  f32 sums differs). experiments/kbench.py is loaded by path here; the port
  never imports it;
* `python -m dllama_tpu_torch.experiments.kbench suite --smoke --device cpu`
  prints every SUITE row, the tile sweep, the flash rows and KBENCH DONE,
  with no FAILED line.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dllama_tpu_torch.experiments import kbench

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5
SMOKE_SHAPES = [(8, 128, 256), (32, 128, 256), (8, 256, 128)]  # (m, k, n): w1, wq rows


@pytest.fixture(scope="module")
def jax_kbench():
    spec = importlib.util.spec_from_file_location("jax_kbench", ROOT / "experiments" / "kbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.INTERPRET = True
    return mod


def _inputs(m, k, n):
    """The JAX harness's recipe: a quantized Gaussian weight and bf16 x."""
    import jax.numpy as jnp

    from dllama_tpu.ops.quant import QTensor

    rng = np.random.default_rng(m + k + n)
    w = QTensor.quantize((rng.standard_normal((k, n)) * 0.02).astype(np.float32))
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    return w, x


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("m,k,n", SMOKE_SHAPES)
def test_fma_f32_plain_matches_pallas_interpret(jax_kbench, m, k, n):
    import jax.numpy as jnp

    w, x = _inputs(m, k, n)
    scales32 = w.scales.astype(jnp.float32)
    want = jax_kbench.make_call(jax_kbench._kernel_b, m, k, n)(x, w.packed, scales32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got = kbench.fma_f32(xt, torch.from_numpy(np.array(w.packed)),
                         torch.from_numpy(np.array(scales32)))
    _close(got, want)


@pytest.mark.parametrize("m,k,n", SMOKE_SHAPES)
def test_bf16_gemm_plain_matches_pallas_interpret(jax_kbench, m, k, n):
    import jax.numpy as jnp

    w, x = _inputs(m, k, n)
    wb = w.dequantize(jnp.bfloat16)
    want = jax_kbench.make_call(jax_kbench._kernel_d, m, k, n, bf16=True)(x, wb)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.array(wb.astype(jnp.float32))).to(torch.bfloat16)
    _close(kbench.bf16_gemm(xt, wt), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="packed"):
        kbench.fma_f32(x, torch.zeros((16, 8), dtype=torch.uint8), torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        kbench.bf16_gemm(x.to("meta"), torch.zeros((64, 8), dtype=torch.bfloat16, device="meta"))


def test_suite_smoke_on_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.experiments.kbench", "suite",
                          "--smoke", "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert not [ln for ln in lines if "FAILED" in ln], out.stdout
    assert lines[0].startswith("kbench device: cpu")
    rows = [ln for ln in lines if ln.startswith("m=")]
    assert [ln.split(":")[0] for ln in rows] == ["m=8 w1", "m=8 wcls", "m=32 w1"]
    names = {"m=8 w1": "A auto, BD blockdot, MD maskdot, LD loopdot, DQ deq, B fma-f32, "
                       "D bf16-ref, E torch-deq, Q8 q80-fused",
             "m=8 wcls": "A auto, D bf16-ref, E torch-deq",
             "m=32 w1": "DQ deq, D bf16-ref, E torch-deq, Q8 q80-fused"}
    for row in rows:
        label, rest = row.split(": ", 1)
        for name in names[label].split(", "):
            assert f"{name}=" in rest, (label, name, row)
    assert sum(ln.startswith("  tile tk=") for ln in lines) == 2
    assert any(ln.startswith("tile sweep m=8 w1 best-first: tk") for ln in lines)
    assert any(ln.startswith("flash decode S=1024 pos=") for ln in lines)
    assert any(ln.startswith("flash prefill t=64") for ln in lines)
    assert lines[-1] == "KBENCH DONE"
    # without a card the default device is refused, with no result
    out = subprocess.run([sys.executable, "-m", "dllama_tpu_torch.experiments.kbench", "suite",
                          "--smoke"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1 and "no CUDA device" in out.stderr and not out.stdout
