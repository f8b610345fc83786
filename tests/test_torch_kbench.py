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
  with no FAILED line;
* the kernels' arithmetic modelled bit for bit in numpy: K11-B's wgmma
  route writes each f32 weight w = (q - 8) s as w_hi + w_lo, exactly w for
  every code and every f16 scale widened to f32 and within 2^-16 of |w| for
  any f32 scale; an f32 x enters either route as three bf16 terms whose sum
  is x exactly;
* the route rule (the decode body up to 16 rows, the wgmma loop above) and
  the decode geometries (K11-D's gives every SM a block at 78, 114 and 132
  SMs and walks all of k in one split where the column tiles alone fill the
  card; its ring of 2-byte weights leaves two blocks an SM), against the
  constants of csrc/decode.cuh;
* the wrappers refusing what the kernels do not take.
"""

import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from dllama_tpu_torch.experiments import kbench
from dllama_tpu_torch.ops import q40_matmul as tq

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "dllama_tpu_torch" / "ops" / "csrc"
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
    with pytest.raises(ValueError, match="packed"):  # k not a multiple of 32
        kbench.fma_f32(torch.zeros((2, 40)), torch.zeros((20, 8), dtype=torch.uint8),
                       torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="against w"):
        kbench.bf16_gemm(x, torch.zeros((32, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        kbench.bf16_gemm(x.to("meta"), torch.zeros((64, 8), dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        kbench.fma_f32(x.float().to("meta"), torch.zeros((32, 8), dtype=torch.uint8, device="meta"),
                       torch.zeros((2, 8), device="meta"))
    # the decode route takes at most 16 rows, whoever forces it
    geo = kbench.bf16_decode_geometry(64, 8, 132)
    with pytest.raises(ValueError, match="decode route"):
        kbench._launch("kbench_bf16_gemm", torch.zeros((17, 64), dtype=torch.bfloat16),
                       torch.zeros((64, 8), dtype=torch.bfloat16), None,
                       torch.empty((17, 8)), "decode", geo)


# ------------------------------------------------------------ bit models


def _bf16_rn(v: np.ndarray) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), as f32: __float2bfloat16_rn
    on finite values."""
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def _split_weight(codes: np.ndarray, s: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """K11-B's wgmma-route dequant (csrc/prefill.cuh Q40SplitF32): w = (q - 8) s
    in f32, w_hi = bf16(w), w_lo = bf16(w - w_hi) -> (w, w_hi, w_lo)."""
    w = (codes.astype(np.float32) * s).astype(np.float32)
    hi = _bf16_rn(w)
    lo = _bf16_rn((w - hi).astype(np.float32))
    return w, hi, lo


def test_weight_split_is_exact_for_f16_scales_and_close_for_f32():
    """w_hi + w_lo == (q - 8) s for all 16 codes times every finite f16
    scale widened to f32 (the benchmark's scales), and within 2^-16 of |w|
    for random f32 scales; each term is a bf16 value."""
    s16 = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    s = s16[np.isfinite(s16)].astype(np.float32)
    codes = np.arange(16, dtype=np.float32) - 8.0
    w, hi, lo = _split_weight(codes[:, None], s[None, :])
    assert np.array_equal(w.astype(np.float64), codes[:, None].astype(np.float64) * s)
    assert np.array_equal(hi.astype(np.float64) + lo, w.astype(np.float64))
    for term in (hi, lo):
        assert not (term.view(np.uint32) & 0xFFFF).any()
    rng = np.random.default_rng(9)
    s = (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-20, 20, 1 << 16))).astype(np.float32)
    w, hi, lo = _split_weight(codes[:, None], s[None, :])
    err = np.abs(hi.astype(np.float64) + lo - w)
    assert (err <= np.exp2(-16) * np.abs(w)).all()


def _split_x(v: np.ndarray) -> list[np.ndarray]:
    """An f32 value as three bf16 terms (common.cuh split_bf16x3): each the
    bf16 rounding of what the terms before it left, the remainders in f32."""
    terms = []
    for _ in range(3):
        h = _bf16_rn(v)
        terms.append(h)
        v = (v - h).astype(np.float32)
    return terms


@pytest.mark.parametrize("scale_exp", [(-30, 30), (-100, -60), (0, 1)])
def test_x_split_into_three_bf16_terms_is_exact(scale_exp):
    """Every f32 x with |x| >= 2^-110 is the sum of its three bf16 terms
    exactly, so an f32 x times an exact code, or an exact bf16 weight term,
    is three exact products on the tensor cores."""
    rng = np.random.default_rng(sum(scale_exp) + 200)
    x = (rng.standard_normal(1 << 16)
         * np.exp2(rng.integers(*scale_exp, 1 << 16))).astype(np.float32)
    x = x[np.abs(x) >= np.exp2(-110)]
    terms = _split_x(x)
    assert np.array_equal(sum(t.astype(np.float64) for t in terms), x.astype(np.float64))
    for term in terms:
        assert not (term.view(np.uint32) & 0xFFFF).any()


def test_fma_plain_weight_equals_the_split_for_the_benchmark_scales():
    """On kbench's own recipe (f16 scales widened to f32) the plain version's
    weight f * s - 8 * s equals (q - 8) s = w_hi + w_lo exactly, so K11-B's
    two routes compute the plain version's f32 products."""
    rng = np.random.default_rng(4)
    k, n = 64, 48
    packed = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    s = torch.from_numpy((rng.random((k // 32, n)) * 0.02 + 1e-3).astype(np.float16)).float()
    want = kbench.fma_dequantize(packed, s).numpy()
    p = packed.numpy().reshape(k // 32, 16, n)
    codes = np.concatenate([p & 15, p >> 4], axis=1).reshape(k, n).astype(np.float32) - 8
    w, hi, lo = _split_weight(codes, np.repeat(s.numpy(), 32, axis=0))
    assert np.array_equal(w, want)
    assert np.array_equal(hi.astype(np.float64) + lo, want.astype(np.float64))


# ------------------------------------------------------------ routes and geometry


def _constants(text: str) -> dict[str, int]:
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_route_rule_splits_at_sixteen_rows():
    """m <= 16 takes the decode body (route 0 of the C entries), a larger m
    the wgmma loop (route 1): K1's split against K2, at the body's row limit."""
    text = (CSRC / "decode.cuh").read_text()
    assert kbench.DECODE_MAX_M == _constants(text)["kMaxM"] == tq.DECODE_MAX_M == 16
    assert [kbench.route(m) for m in (1, 8, 15, 16, 17, 32, 256)] == \
        ["decode"] * 4 + ["wgmma"] * 3
    assert kbench.ROUTES.index("decode") == 0 and kbench.ROUTES.index("wgmma") == 1
    for src in ("kbench_fma_f32.cu", "kbench_bf16_gemm.cu"):
        body = (CSRC / src).read_text()
        assert "if (route == 0)" in body and '#include "decode.cuh"' in body
        assert '#include "prefill.cuh"' in body and "run<" in body


@pytest.mark.parametrize("k", [256, 264, 4096, 4104, 14336])
def test_bf16_decode_geometry_fills_the_card_in_long_runs(k):
    """K11-D's decode launch at 78, 114 and 132 SMs: its splits cover the
    32-row blocks of k once (a ragged last block included) in at most
    DECODE_MAX_SPLITS splits of at least DECODE_MIN_BLOCKS_PER_SPLIT blocks,
    in a column tile the body builds for 2-byte weights; every n of a
    thousand columns or more gives each SM a block, and where the column
    tiles alone fill the card (w1, wcls) all of k is one split; nothing
    depends on m."""
    nkb = -(-k // 32)
    for n in (1000, 1024, 4096, 8192, 14336, 128256):
        for sms in (78, 114, 132):
            geo = kbench.bf16_decode_geometry(k, n, sms)
            assert (geo.splits - 1) * geo.kb_per_split < nkb <= geo.splits * geo.kb_per_split
            assert geo.kb_per_split >= min(nkb, tq.DECODE_MIN_BLOCKS_PER_SPLIT)
            assert 1 <= geo.splits <= tq.DECODE_MAX_SPLITS
            assert geo.cols in kbench.NARROW_COLS
            if nkb >= tq.DECODE_MAX_SPLITS * tq.DECODE_MIN_BLOCKS_PER_SPLIT:
                assert -(-n // geo.cols) * geo.splits >= sms
            if -(-n // kbench.NARROW_COLS[0]) >= tq.DECODE_BLOCKS_PER_SM * sms:
                assert geo.splits == 1 and geo.cols == kbench.NARROW_COLS[0]


def test_decode_geometries_against_the_body():
    """The 2-byte-weight policy builds 32- and 64-column warps only, and a
    block of four warps with four 32-row slots each (weights, x rows at m =
    16) leaves two blocks an SM within 227 KB; K11-B takes K1's geometry, at
    most 64 columns a warp with an f32 x."""
    text = (CSRC / "decode.cuh").read_text()
    c = _constants(text)
    body = text[text.index("struct Bf16Weights {"):]
    body = body[: body.index("template <int I>")]
    pol = _constants(body)
    assert "kTile128 = false" in body and pol["kColBytes"] == 2
    assert kbench.NARROW_COLS == (c["kMaxCols"] // 2, c["kMinCols"])
    assert tq.DECODE_BLOCKS_PER_SM == 2
    gc, m = kbench.NARROW_COLS[0], c["kMaxM"]
    slot = pol["kRows"] * (gc * pol["kColBytes"] + c["kRowPad"]) + m * c["kXLd"] * 2
    assert 2 * (c["kWarps"] * pol["kStages"] * slot + 1024) <= 232448
    for k, n in ((4096, 14336), (4096, 1024), (14336, 4096), (4128, 1000)):
        assert kbench.fma_decode_geometry(k, n, 132, False) == tq.decode_geometry(k, n, 132)
        geo = kbench.fma_decode_geometry(k, n, 132, True)
        assert geo.cols <= kbench.NARROW_COLS[0] and geo.cols in tq.DECODE_COLS
        assert (geo.splits - 1) * geo.kb_per_split < k // 32 <= geo.splits * geo.kb_per_split


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
