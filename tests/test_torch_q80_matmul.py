"""The Q80 matmul's wrapper on CPU tensors (its plain version, what the CUDA
kernels K5/K6 are held against on the card) against the JAX package: the
Pallas kernels in interpret mode (blockdot for m <= 16, deq beyond) and the
XLA dequantize + dot path, for a stacked layer index and a 2-D weight.

Tolerances: f32 inputs within 1e-5 of max|ref| (only the order of the f32
sums differs); bf16 inputs within 5e-3 of max|ref| against the TPU kernels
(their blockdot scales exact-code partials where the plain version rounds
each weight to bf16, and their output is rounded to bf16) and within 1e-5
against the XLA path, whose arithmetic is the plain version's."""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.ops.q80_matmul import (
    DECODE_BLOCKS_PER_SPLIT,
    LAUNCHES,
    PREFILL_RUN_STEPS,
    decode_splits,
    prefill_splits,
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
    tiles = -(-m // 64) * -(-n // 128)
    assert (splits > 1) == (2 * tiles < 132 and steps > PREFILL_RUN_STEPS)
