"""The port's plain layers against the JAX package's: RMSNorm, the RoPE
table (with and without Llama-3.1 frequency scaling) and RoPE applied with
a scalar or per-row position. f32; the table is built by the same numpy
code, so it must be equal; the others agree to 1e-6."""

import numpy as np
import pytest
import torch

from dllama_tpu.models.config import LlamaConfig as JaxConfig
from dllama_tpu.models.config import RopeType as JaxRope
from dllama_tpu.ops import layers as jl
from dllama_tpu_torch.models.config import LlamaConfig, RopeType
from dllama_tpu_torch.ops import layers as tl

torch.set_num_threads(1)

ROPE31 = dict(rope_theta=500000.0, rope_scaling_factor=8.0, rope_scaling_low_freq_factor=1.0,
              rope_scaling_high_freq_factor=4.0, rope_scaling_orig_max_seq_len=8192)


def _cfgs(llama31: bool):
    kw = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=512, seq_len=64)
    if llama31:
        return (JaxConfig(**kw, rope_type=JaxRope.LLAMA3_1, **ROPE31),
                LlamaConfig(**kw, rope_type=RopeType.LLAMA3_1, **ROPE31))
    return JaxConfig(**kw), LlamaConfig(**kw)


def test_rms_norm():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 128)).astype(np.float32) * 3
    w = rng.standard_normal(128).astype(np.float32)
    want = np.asarray(jl.rms_norm(x, w, 1e-5))
    got = tl.rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("llama31", [False, True])
def test_rope_cache(llama31):
    jcfg, cfg = _cfgs(llama31)
    want = np.asarray(jl.build_rope_cache(jcfg, 64))
    got = tl.build_rope_cache(cfg, 64).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    jcfg, cfg = _cfgs(True)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    table = np.array(jl.build_rope_cache(jcfg, 64))
    rope = table[np.array([[3, 4, 5, 6, 7], [40, 41, 42, 43, 44]])] if per_row else table[9:14]
    want = np.asarray(jl.apply_rope(x, rope))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(rope)).numpy()
    assert np.abs(got - want).max() <= 1e-6
