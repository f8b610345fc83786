"""Flash attention's plain version (what the CUDA kernel is held against on
the card) against the JAX package: the Pallas kernel in interpret mode for
one case, and ops.layers.gqa_attention for decode and multi-token chunks
with per-row positions. f32; 1e-5 absolute because both compute the same
softmax in f32 and differ only in the order of the sums."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu_torch.ops.flash_attention import (
    BLOCKS_PER_SM,
    LAUNCHES,
    MIN_TILES_PER_SPLIT,
    TQ,
    TS,
    flash_gqa_attention,
    kv_splits,
)
from dllama_tpu_torch.ops.layers import gqa_attention

torch.set_num_threads(1)

B, HQ, HKV, HD, S = 2, 4, 2, 64, 64  # group 2
TOL = 1e-5


def _inputs(t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, t, HQ, HD)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, HD)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, HD)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_plain_matches_pallas_interpret():
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.flash_attention import flash_gqa_attention as pallas_flash

    q, k, v = _inputs(3, 0)
    pos = np.array([5, 40], np.int32)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                        interpret=True)
    got = gqa_attention(*_t(q, k, v), torch.from_numpy(pos))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("vector_pos", [False, True])
def test_plain_matches_jax_gqa_attention(t, vector_pos):
    import jax.numpy as jnp

    from dllama_tpu.ops.layers import gqa_attention as jax_gqa

    q, k, v = _inputs(t, 1 + t)
    pos = np.array([0, 50], np.int32) if vector_pos else 17
    want = jax_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tpos = torch.from_numpy(pos) if vector_pos else pos
    got = gqa_attention(*_t(q, k, v), tpos)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    q, k, v = _t(*_inputs(2, 9))
    before = dict(LAUNCHES)
    assert torch.equal(flash_gqa_attention(q, k, v, 3), gqa_attention(q, k, v, 3))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="meta"):
        flash_gqa_attention(q.to("meta"), k.to("meta"), v.to("meta"), 3)


@pytest.mark.parametrize("rows,bhkv,live", [(4, 8, 64), (4, 8, 1), (1024, 8, 36), (36, 8, 17),
                                            (256, 8, 2), (512, 8, 61), (64, 8, 1)])
def test_kv_splits_cover_the_live_tiles_once(rows, bhkv, live):
    splits, per = kv_splits(rows, bhkv, live, sms=132)
    assert 1 <= splits <= max(1, live // MIN_TILES_PER_SPLIT)
    assert (splits - 1) * per < live <= splits * per
    # no more blocks than the card holds, unless one split a query tile
    assert splits == 1 or -(-rows // TQ) * bhkv * (splits - 1) < BLOCKS_PER_SM * 132


@pytest.mark.parametrize("live", [1, 2, 16, 17, 64])
def test_kv_splits_of_decode_and_verify_rows_agree(live):
    """A decode step (4 folded rows a KV head) and a spec verify forward (36)
    take one query tile each, so a row's keys are split alike."""
    assert kv_splits(4, 8, live, sms=132) == kv_splits(36, 8, live, sms=132)


def test_tile_constants_match_the_kernel():
    """The tiles the wrapper counts are those of the source and of the
    attention body it includes (attention.cuh, shared with the paged
    kernels)."""
    csrc = Path(__file__).resolve().parents[1] / "dllama_tpu_torch" / "ops" / "csrc"
    text = (csrc / "flash_attention.cu").read_text()
    assert '#include "attention.cuh"' in text
    text += (csrc / "attention.cuh").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert (c["TQ"], c["TS"], c["kMinBlocksPerSm"]) == (TQ, TS, BLOCKS_PER_SM)


def _kernel_p_rounding(q, k, v, pos, group):
    """The tensor-core kernel's arithmetic rebuilt in torch for one KV head
    (q [rows, hd] folded t-major, k/v [S, hd], bf16 values in f32): 64-key
    tiles in order, f32 scores and online softmax, and P entering P.V as a
    bf16 hi + lo pair, both products summed in f32."""
    rows, hd = q.shape
    qpos = pos + torch.arange(rows) // group
    m = torch.full((rows, 1), -1e30)
    l = torch.zeros((rows, 1))
    acc = torch.zeros((rows, hd))
    horizon = int(qpos.max())
    for s0 in range(0, horizon + 1, TS):
        keys = s0 + torch.arange(TS)
        ok = keys[None, :] <= qpos[:, None]
        s = torch.where(ok, (q @ k[s0:s0 + TS].T) / hd ** 0.5, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), torch.tensor(0.0))
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        l = alpha * l + p.sum(dim=1, keepdim=True)
        acc = acc * alpha + hi @ v[s0:s0 + TS] + lo @ v[s0:s0 + TS]
        m = m_new
    return acc / torch.where(l == 0, torch.tensor(1.0), l)


@pytest.mark.parametrize("pos", [0, 2048])
def test_p_as_bf16_hi_lo_holds_the_kernel_tolerance(pos):
    """hd 128, group 4, T = 256: P split into bf16 hi + lo parts stays within
    2e-3 (the smoke's TOL_K7) of the plain version, as the TPU kernel's f32 P
    does."""
    t, group, hd = 256, 4, 128
    rng = np.random.default_rng(pos + 7)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    q = bf(rng.standard_normal((1, t, group, hd)))
    k = bf(rng.standard_normal((1, 1, pos + t, hd)))
    v = bf(rng.standard_normal((1, 1, pos + t, hd)))
    want = gqa_attention(q.float(), k.float(), v.float(), pos)[0].reshape(t * group, hd)
    got = _kernel_p_rounding(q.float()[0].reshape(t * group, hd), k.float()[0, 0],
                             v.float()[0, 0], pos, group)
    assert (got - want).abs().max().item() < 2e-3
