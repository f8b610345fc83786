"""The Q80 matmul's wrapper on CPU tensors (its plain version, what the CUDA
kernels K5/K6 are held against on the card) against the JAX package: the
Pallas kernels in interpret mode (blockdot for m <= 16, deq beyond) and the
XLA dequantize + dot path, for a stacked layer index and a 2-D weight.

Tolerances: f32 inputs within 1e-5 of max|ref| (only the order of the f32
sums differs); bf16 inputs within 5e-3 of max|ref| against the TPU kernels
(their blockdot scales exact-code partials where the plain version rounds
each weight to bf16, and their output is rounded to bf16) and within 1e-5
against the XLA path, whose arithmetic is the plain version's."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.ops.q80_matmul import (
    DECODE_BLOCKS_PER_SPLIT,
    LAUNCHES,
    PREFILL_RUN_STEPS,
    PREFILL_STEP_K,
    PREFILL_TILE_M,
    PREFILL_TILE_M_SMALL,
    PREFILL_TILE_N,
    decode_splits,
    prefill_splits,
    prefill_tile_m,
    q80_matmul,
    q80_matmul_plain,
)
from dllama_tpu_torch.ops.quant import Q8Tensor

torch.set_num_threads(1)

K, N, LAYER = 256, 256, 1
RTOL_F32 = 1e-5
RTOL_KERNEL_BF16 = 5e-3
ROWS = [1, 8, 16, 17, 40]  # both sides of the decode/prefill split at 16


@pytest.fixture(scope="module")
def weights():
    """A stacked L=2 Q80 weight and a 2-D one, in both packages (layer 1 of
    the stack is used). The stack's codes are overwritten with random bytes,
    -128 included, as the CUDA kernels must take any int8."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.ops.quant import Q8Tensor as JaxQ8

    rng = np.random.default_rng(6)
    ws = [JaxQ8.quantize(rng.standard_normal((K, N)).astype(np.float32) * 0.05)
          for _ in range(2)]
    jw = jax.tree.map(lambda *xs: jnp.stack(xs), *ws)
    codes = rng.integers(-128, 128, size=jw.codes.shape, dtype=np.int8)
    codes[1, :3, :5] = -128
    jw = JaxQ8(jnp.asarray(codes), jw.scales)
    j2 = JaxQ8.quantize(rng.standard_normal((K, N)).astype(np.float32) * 0.05)
    to_torch = params_from_numpy
    return ((jw, to_torch(jax.tree.map(np.asarray, jw))),
            (j2, to_torch(jax.tree.map(np.asarray, j2))))


def _x(m, seed=5):
    return np.random.default_rng(seed + m).standard_normal((m, K)).astype(np.float32)


def _close(got: torch.Tensor, want, rtol: float) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _case(weights, stacked: bool):
    (jw, tw), (j2, t2) = weights
    return (jw, tw, LAYER) if stacked else (j2, t2, None)


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "2d"])
@pytest.mark.parametrize("m", ROWS)
def test_f32_matches_pallas_interpret(weights, m, stacked):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.q80_matmul import q80_matmul as pallas_q80

    jw, tw, layer = _case(weights, stacked)
    x = _x(m)
    want = pallas_q80(jnp.asarray(x), jw, None if layer is None else jnp.int32(layer),
                      interpret=True)
    _close(q80_matmul(torch.from_numpy(x), tw, layer), want, RTOL_F32)


@pytest.mark.parametrize("m", ROWS)
def test_bf16_matches_pallas_interpret_and_xla(weights, m):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.q80_matmul import q80_matmul as pallas_q80
    from dllama_tpu.ops.quant import slice_leaf

    jw, tw, layer = _case(weights, True)
    xb = jnp.asarray(_x(m), jnp.bfloat16)
    x = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = q80_matmul(x, tw, layer, out_dtype=torch.float32)
    _close(got, pallas_q80(xb, jw, jnp.int32(layer), interpret=True), RTOL_KERNEL_BF16)
    wd = slice_leaf(jw, layer).dequantize(jnp.bfloat16)
    xla = jnp.dot(xb, wd, preferred_element_type=jnp.float32)
    _close(got, xla, RTOL_F32)
    out = q80_matmul(x, tw, layer)
    assert out.dtype == torch.bfloat16 and torch.equal(out, got.to(torch.bfloat16))


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices(weights):
    (_, tw), _ = weights
    x = torch.from_numpy(_x(3)).reshape(1, 3, K).to(torch.bfloat16)
    before = dict(LAUNCHES)
    got = q80_matmul(x, tw, LAYER)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, N)
    assert torch.equal(got, q80_matmul_plain(x, tw, LAYER))
    assert LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA"):
        q80_matmul(x.to("meta"), tw, LAYER)
    with pytest.raises(ValueError, match="layer index"):
        q80_matmul(x, tw)
    with pytest.raises(ValueError, match="codes"):
        q80_matmul(x[..., :128], tw, LAYER)
    with pytest.raises(ValueError, match="codes"):  # scales that do not match k
        q80_matmul(x, Q8Tensor(tw.codes, tw.scales[:, :4]), LAYER)


def test_matmul_dispatch_routes_q80(weights):
    """ops.matmul sends a Q8Tensor to the Q80 wrapper on the cuda backend
    and to the plain version on torch; both agree on the CPU."""
    from dllama_tpu_torch.ops.matmul import matmul

    (_, tw), _ = weights
    x = torch.from_numpy(_x(2)).to(torch.bfloat16)
    want = q80_matmul_plain(x, tw, LAYER)
    for backend in ("cuda", "torch"):
        assert torch.equal(matmul(x, tw, LAYER, backend=backend), want)


@pytest.mark.parametrize("k", [256, 4096, 4128, 14336])
def test_decode_splits_follow_k_alone(k):
    """Every split is one run of DECODE_BLOCKS_PER_SPLIT 32-row blocks (the
    last one may be short), so no split boundary depends on n."""
    splits, per = decode_splits(k)
    nkb = k // 32
    assert per == DECODE_BLOCKS_PER_SPLIT and (splits - 1) * per < nkb <= splits * per


@pytest.mark.parametrize("m,k,n", [(17, 4096, 1024), (32, 4096, 14336), (256, 4096, 1024),
                                   (256, 4096, 4096), (256, 14336, 4096), (40, 4128, 1000)])
def test_prefill_splits_cut_k_only_at_run_boundaries(m, k, n):
    """The prefill split is one run of PREFILL_RUN_STEPS steps, or all of k
    in one split: either way the kernel adds the same runs in the same
    order, so a column's sum does not depend on n."""
    splits, per = prefill_splits(m, k, n, sms=132)
    steps = -(-k // 64)
    assert (splits - 1) * per < steps <= splits * per
    assert (splits, per) == (1, steps) or per == PREFILL_RUN_STEPS
    tiles = -(-m // prefill_tile_m(m, n, 132)) * -(-n // PREFILL_TILE_N)
    assert (splits > 1) == (2 * tiles < 132 and steps > PREFILL_RUN_STEPS)


def _source_constants(name: str) -> dict[str, int]:
    text = (Path(__file__).resolve().parents[1] / "dllama_tpu_torch" / "ops" / "csrc"
            / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_prefill_tile_constants_match_the_kernel():
    """prefill_splits and prefill_tile_m count the kernel's own tiles, steps
    and runs."""
    c = _source_constants("q80_prefill.cu")
    assert (c["BM"], c["BM_SMALL"], c["BN"], c["BK"], c["kRunSteps"]) == (
        PREFILL_TILE_M, PREFILL_TILE_M_SMALL, PREFILL_TILE_N, PREFILL_STEP_K, PREFILL_RUN_STEPS)
    assert prefill_tile_m(256, 14336, 132) == PREFILL_TILE_M  # 224 tiles fill the card
    assert prefill_tile_m(256, 4096, 132) == PREFILL_TILE_M_SMALL  # 64 would not
    assert prefill_tile_m(PREFILL_TILE_M - 1, 14336, 132) == PREFILL_TILE_M_SMALL


def _finite_f16_scales() -> np.ndarray:
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    s = bits.view(np.float16)
    return s[np.isfinite(s)]


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 with round-to-nearest-even (cvt.rn.bf16x2.f32), as the
    f32 holding the bf16 value."""
    b = x.astype(np.float32).view(np.uint32)
    r = ((b + np.uint32(0x7FFF) + ((b >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def _k6_weights(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """K6's dequantization, step by step: XOR 0x80 and a byte permute give
    the float 2^23 + q + 128; subtracting 2^23 + 128 leaves the exact code;
    one f32 multiply by the f16 scale; one bf16 rounding."""
    u = (codes.view(np.uint8).astype(np.uint32) ^ 0x80) | 0x4B000000
    code = u.view(np.float32) - np.float32(8388736.0)
    return _bf16_rne(code * scales.astype(np.float32))


def test_k6_dequant_equals_the_plain_weight_for_every_code_and_scale():
    """All 256 int8 codes x every finite f16 scale: the kernel's formula
    gives Q8Tensor.dequantize's bf16 weight bit for bit."""
    codes = np.arange(-128, 128, dtype=np.int8)
    scales = _finite_f16_scales()
    assert scales.size == 63488
    # codes [256, n] against the same scale row in each of the 8 blocks
    w = Q8Tensor(torch.from_numpy(np.repeat(codes[:, None], scales.size, axis=1)),
                 torch.from_numpy(np.repeat(scales[None, :], 256 // 32, axis=0)))
    plain = w.dequantize(torch.bfloat16).float().numpy()
    got = _k6_weights(codes[:, None], scales[None, :])
    assert np.array_equal(got.view(np.uint32), plain.view(np.uint32))


def test_q40_split_scale_fma_is_not_exact_for_int8_codes():
    """K2's dequant, bf16(q s_hi + bf16(q s_lo)) with s = s_hi + s_lo in
    bf16, rounds (q - 8) s once because a 4-bit code times s_lo is exact in
    bf16. An int8 code times s_lo can need 10 significant bits, so the trick
    must not be carried over to K6: q = -125 at s = 7.8857e-05 already
    differs from the plain weight."""
    q = np.array([-125.0])
    s = np.array([np.float16(7.8857e-05)], np.float16)
    sf = s.astype(np.float64)
    s_hi = _bf16_rne(sf.astype(np.float32)).astype(np.float64)
    s_lo = _bf16_rne((sf - s_hi).astype(np.float32)).astype(np.float64)
    lo = _bf16_rne((q * s_lo).astype(np.float32)).astype(np.float64)  # exact in f32
    exact = q * s_hi + lo  # the FMA's exact sum (fits f64), rounded once to bf16:
    e = np.floor(np.log2(np.abs(exact)))
    quantum = 2.0 ** (e - 7)
    fma = np.round(exact / quantum) * quantum  # round half to even
    plain = _bf16_rne((q * sf).astype(np.float32))
    assert fma[0] != plain[0]
    assert _k6_weights(q.astype(np.int8), s)[0] == plain[0]
