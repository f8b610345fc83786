"""The PyTorch port's Q40/Q80 codecs and device layout against the JAX
package's: the numpy codecs and the file-to-device transpose must agree bit
for bit, and dequantization exactly (it multiplies exact small integers by
f16 scales widened to f32, so no rounding can differ)."""

import numpy as np
import pytest
import torch

from dllama_tpu.ops import quant as jq
from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


@pytest.mark.parametrize("codec", ["q40", "q80"])
def test_numpy_codecs_bit_exact(codec):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 256)) * rng.uniform(0.01, 2.0, (3, 1))).astype(np.float32)
    x[0, :32] = 0.0  # an all-zero block (delta 0)
    quant = getattr(tq, f"quantize_{codec}_np")
    codes, scales = quant(x)
    want_codes, want_scales = getattr(jq, f"quantize_{codec}_np")(x)
    assert codes.dtype == want_codes.dtype and np.array_equal(codes, want_codes)
    assert scales.dtype == np.float16 and np.array_equal(scales.view(np.uint16),
                                                         want_scales.view(np.uint16))
    deq = getattr(tq, f"dequantize_{codec}_np")(codes, scales)
    assert np.array_equal(deq, getattr(jq, f"dequantize_{codec}_np")(codes, scales))


def test_from_file_layout_byte_equal():
    rng = np.random.default_rng(1)
    n_out, k_in = 48, 128
    packed = rng.integers(0, 256, (n_out * k_in // 32, 16), dtype=np.uint8)
    scales = rng.uniform(-0.1, 0.1, n_out * k_in // 32).astype(np.float16)
    want = jq.QTensor.from_file_layout(packed, scales, n_out, k_in, device=False)
    got = tq.QTensor.from_file_layout(packed, scales, n_out, k_in)
    assert got.shape == (k_in, n_out)
    assert np.array_equal(got.packed.numpy(), want.packed)
    assert np.array_equal(got.scales.numpy().view(np.uint16), want.scales.view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_exact(dtype):
    """Stacked [L, k/2, n] Q40 weight: torch dequantize == JAX dequantize,
    including the final rounding to bf16."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    ws = [jq.QTensor.quantize(rng.standard_normal((64, 96)).astype(np.float32) * 0.05)
          for _ in range(2)]
    jw = jax.tree.map(lambda *xs: jnp.stack(xs), *ws)
    want = np.asarray(jw.dequantize(getattr(jnp, dtype)))
    tw = params_from_numpy(jax.tree.map(np.asarray, jw))
    got = tw.dequantize(getattr(torch, dtype))
    if dtype == "bfloat16":
        want, got = want.view(np.uint16), got.view(torch.int16).numpy().view(np.uint16)
    else:
        got = got.numpy()
    assert np.array_equal(got, want)


def test_slice_leaf_is_a_view():
    w = tq.QTensor(torch.zeros((2, 16, 8), dtype=torch.uint8),
                   torch.zeros((2, 1, 8), dtype=torch.float16))
    one = tq.slice_leaf(w, 1)
    assert one.shape == (32, 8)
    assert one.packed.data_ptr() == w.packed[1].data_ptr()
