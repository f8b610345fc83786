"""RMSNorm behind the ``ops.layers.RMS_NORM_IMPL`` switch against the JAX
package's Pallas kernel (``ops/pallas/rms_norm.rms_norm`` in interpret mode).

With the switch at ``"cuda"`` the model's norms go through the CUDA kernel's
wrapper (K10), which runs its plain version for CPU tensors. Shapes (1, 64),
(3, 5, 128) and (17, 256) in f32 (within 1e-6 of max|ref|: only the order of
the f32 sum of squares differs) and bf16 (within one bf16 ulp of each
reference element: a sum order can move a rounding across a tie)."""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.ops import layers
from dllama_tpu_torch.ops import rms_norm as k10

torch.set_num_threads(1)

EPS = 1e-5
SHAPES = [(1, 64), (3, 5, 128), (17, 256)]


@pytest.fixture
def cuda_switch(monkeypatch):
    monkeypatch.setattr(layers, "RMS_NORM_IMPL", "cuda")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_pallas_interpret(cuda_switch, shape, dtype):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.rms_norm import rms_norm as pallas_rms_norm

    x, w = _inputs(shape, len(shape) * 100 + shape[-1])
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    want = np.asarray(pallas_rms_norm(jx, jnp.asarray(w), EPS, interpret=True), np.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    tx = tx if dtype == "f32" else tx.to(torch.bfloat16)
    before = dict(k10.LAUNCHES)
    got = layers.rms_norm(tx, torch.from_numpy(w), EPS)
    assert k10.LAUNCHES == before  # a CPU tensor runs the plain version
    assert got.dtype == tx.dtype and tuple(got.shape) == shape
    got = got.float().numpy()
    if dtype == "f32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


def test_switch_routes_the_model_norms(cuda_switch):
    """With the switch at 'cuda' a non-CPU tensor reaches the kernel's
    wrapper (which refuses a tensor that is not on a CUDA device); at the
    default 'torch' the plain version runs on any device."""
    x = torch.ones(2, 64, device="meta")
    w = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        layers.rms_norm(x, w, EPS)
    layers.RMS_NORM_IMPL = "torch"
    assert layers.rms_norm(x, w, EPS).shape == (2, 64)


def test_forward_is_the_same_with_the_switch_on(monkeypatch):
    """On the CPU the switch changes no bit of the forward."""
    from dllama_tpu_torch.models import formats
    from dllama_tpu_torch.models.llama import KVCache, forward
    from tests.test_golden import FIXTURE_M, GOLDEN_PROMPT

    cfg, hs = formats.read_header(FIXTURE_M)
    params = formats.load_params(FIXTURE_M, cfg, hs)
    rope = layers.build_rope_cache(cfg)
    toks = torch.tensor([GOLDEN_PROMPT])
    runs = []
    for impl in ("torch", "cuda"):
        monkeypatch.setattr(layers, "RMS_NORM_IMPL", impl)
        logits, _ = forward(cfg, params, toks, 0, KVCache.create(cfg, 1, torch.float32), rope)
        runs.append(logits)
    assert torch.equal(runs[0], runs[1])
