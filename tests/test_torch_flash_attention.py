"""Flash attention's plain version (what the CUDA kernel is held against on
the card) against the JAX package: the Pallas kernel in interpret mode for
one case, and ops.layers.gqa_attention for decode and multi-token chunks
with per-row positions. f32; 1e-5 absolute because both compute the same
softmax in f32 and differ only in the order of the sums."""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.ops.flash_attention import LAUNCHES, flash_gqa_attention, kv_splits
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


@pytest.mark.parametrize("rows,bhkv,live", [(4, 8, 64), (4, 8, 1), (1024, 8, 36)])
def test_kv_splits_cover_the_live_tiles_once(rows, bhkv, live):
    splits, per = kv_splits(rows, bhkv, live, sms=132)
    assert 1 <= splits <= max(1, live // 2)
    assert (splits - 1) * per < live <= splits * per
