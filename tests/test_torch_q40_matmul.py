"""The Q40 matmul's plain version (what the CUDA kernels are held against on
the card) against the JAX package: the Pallas kernel in interpret mode for a
decode-shaped and a prefill-shaped call, and QTensor.dequantize + dot for
more row counts. f32 throughout; rel. 1e-5 of max|ref| because only the
order of the f32 sums differs."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.ops.q40_matmul import (
    DECODE_COLS,
    DECODE_MAX_M,
    DECODE_MAX_SPLITS,
    LAUNCHES,
    MASKDOT_COLS,
    MASKDOT_MIN_BLOCKS_PER_SPLIT,
    PREFILL_BLOCKS_PER_SM,
    PREFILL_MIN_STEPS_PER_SPLIT,
    PREFILL_STEP_K,
    PREFILL_TILE_M,
    PREFILL_TILE_M_SMALL,
    PREFILL_TILE_N,
    decode_geometry,
    maskdot_splits,
    prefill_splits,
    prefill_tile_m,
    q40_matmul,
    q40_matmul_plain,
)

torch.set_num_threads(1)

K, N, LAYER = 256, 256, 1
RTOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """A stacked L=2 Q40 weight in both packages (layer 1 is used)."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.ops.quant import QTensor

    rng = np.random.default_rng(4)
    ws = [QTensor.quantize(rng.standard_normal((K, N)).astype(np.float32) * 0.05)
          for _ in range(2)]
    jw = jax.tree.map(lambda *xs: jnp.stack(xs), *ws)
    return jw, params_from_numpy(jax.tree.map(np.asarray, jw))


def _x(m, seed=5):
    return np.random.default_rng(seed + m).standard_normal((m, K)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("m", [5, 32])  # 5 pads to 8 -> blockdot; 32 -> deq
def test_plain_matches_pallas_interpret(weights, m):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.q40_matmul import q40_matmul as pallas_q40

    jw, tw = weights
    x = _x(m)
    want = pallas_q40(jnp.asarray(x), jw, jnp.int32(LAYER), interpret=True)
    _close(q40_matmul_plain(torch.from_numpy(x), tw, LAYER), want)


@pytest.mark.parametrize("m", [1, 8, 17])
def test_plain_matches_dequantize_dot(weights, m):
    import jax.numpy as jnp

    from dllama_tpu.ops.quant import slice_leaf

    jw, tw = weights
    x = _x(m)
    wd = slice_leaf(jw, LAYER).dequantize(jnp.float32)
    want = jnp.dot(jnp.asarray(x), wd, preferred_element_type=jnp.float32)
    _close(q40_matmul_plain(torch.from_numpy(x), tw, LAYER), want)


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices(weights):
    _, tw = weights
    x = torch.from_numpy(_x(3)).reshape(1, 3, K).to(torch.bfloat16)
    before = dict(LAUNCHES)
    got = q40_matmul(x, tw, LAYER)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, N)
    assert torch.equal(got, q40_matmul_plain(x, tw, LAYER))
    assert LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA"):
        q40_matmul(x.to("meta"), tw, LAYER)
    with pytest.raises(ValueError, match="layer index"):
        q40_matmul(x, tw)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (14336, 4096), (4096, 128256)])
def test_decode_split_k_covers_k_once(k, n):
    splits, per, cols = decode_geometry(k, n, sms=132)
    nkb = k // 32
    assert (splits - 1) * per < nkb <= splits * per
    # a block per SM at least, in the widest column tile that allows it
    assert cols in DECODE_COLS and -(-n // cols) * splits >= 132
    assert cols == DECODE_COLS[0] or -(-n // (2 * cols)) * min(DECODE_MAX_SPLITS, nkb // 8) < 132
    assert splits <= DECODE_MAX_SPLITS  # the partials the last block reads at once
    assert DECODE_MAX_M == 16


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (14336, 4096), (4096, 128256)])
def test_maskdot_split_k_covers_k_once(k, n):
    """K3 keeps its own rule: 16 blocks an SM, splits of at least 4 blocks."""
    splits, per = maskdot_splits(k, n, sms=132)
    nkb = k // 32
    assert (splits - 1) * per < nkb <= splits * per
    assert splits == nkb // MASKDOT_MIN_BLOCKS_PER_SPLIT or -(-n // MASKDOT_COLS) * splits >= 132


@pytest.mark.parametrize("m,k,n", [(32, 14336, 4096), (256, 4096, 4096), (256, 4096, 14336),
                                   (256, 4096, 1024), (1, 4096, 14336), (33, 4128, 1000),
                                   (1024, 4096, 4096)])
def test_prefill_split_k_covers_k_once(m, k, n):
    splits, per = prefill_splits(m, k, n, sms=132)
    steps = -(-k // PREFILL_STEP_K)
    assert (splits - 1) * per < steps <= splits * per
    assert splits == 1 or per >= PREFILL_MIN_STEPS_PER_SPLIT
    tiles = -(-m // prefill_tile_m(m)) * -(-n // PREFILL_TILE_N)
    # k is split only where the output tiles alone leave most of the card
    # idle, and then into no more blocks than one wave holds
    slots = PREFILL_BLOCKS_PER_SM * 132
    assert splits == 1 or (2 * tiles <= slots and tiles * splits <= slots)


def _source_constants(name: str) -> dict[str, int]:
    text = (Path(__file__).resolve().parents[1] / "dllama_tpu_torch" / "ops" / "csrc"
            / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_prefill_tile_constants_match_the_kernel():
    """prefill_splits cuts k in the kernel's own steps and counts its own
    output tiles and blocks per SM."""
    c = _source_constants("q40_prefill.cu")
    assert (c["BM"], c["BM_SMALL"], c["BN"], c["BK"], c["kMinBlocksPerSm"]) == (
        PREFILL_TILE_M, PREFILL_TILE_M_SMALL, PREFILL_TILE_N, PREFILL_STEP_K,
        PREFILL_BLOCKS_PER_SM)
    assert prefill_tile_m(PREFILL_TILE_M) == PREFILL_TILE_M
    assert prefill_tile_m(PREFILL_TILE_M - 1) == PREFILL_TILE_M_SMALL
