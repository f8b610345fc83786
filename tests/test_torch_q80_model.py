"""A Q80 model end to end against the JAX package: one tiny Q80 `.m` (every
matmul width a multiple of 128, so the JAX Pallas gate admits each weight)
loaded by both packages, the JAX one with ``q80_packed=True`` and its Pallas
Q80 kernels in interpret mode, the port's with Q8Tensor leaves through its
Q80 wrappers (plain versions on the CPU).

* f32 logits of a prefill and 4 greedy decode steps agree within 1e-4 of
  max|logit| (the order of the f32 sums differs).
* 16 greedy ids are identical through the port's InferenceEngine and its
  BatchEngine, dense and paged, unfused and with fused wqkv/w13 weights
  (``fuse_layer_weights`` on Q8Tensor leaves).
"""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.models import formats
from dllama_tpu_torch.models.llama import fuse_layer_weights
from dllama_tpu_torch.ops.quant import Q8Tensor

torch.set_num_threads(1)

KW = dict(dim=256, hidden_dim=384, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=384,
          seq_len=64)
PROMPT = [3, 17, 99, 250, 7, 61, 128, 5, 300]
N_IDS = 16
RTOL = 1e-4


@pytest.fixture(scope="module")
def q80_model(tmp_path_factory):
    """(path, JAX greedy ids, JAX logits of the prefill and 4 decode steps)."""
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.models import formats as jf
    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.ops.quant import FloatType

    jcfg = JaxConfig(**KW, weight_type=FloatType.Q80)
    rng = np.random.default_rng(12)
    tensors = {name: rng.standard_normal(shape).astype(np.float32) * 0.08
               for name, shape, _ in jf.tensor_plan(jcfg)}
    for name in tensors:
        if "rms" in name or name == "final_norm":
            tensors[name] = 1.0 + 0.1 * tensors[name]
    path = str(tmp_path_factory.mktemp("q80") / "tiny_q80.m")
    jf.save_model(path, jcfg, tensors)
    jcfg, jhs = jf.read_header(path)
    jparams = jf.load_params(path, jcfg, jhs, dtype=jnp.float32, q80_packed=True)
    jeng = JaxEngine(jcfg, jparams, cache_dtype=jnp.float32, kernels="pallas")
    logits = [np.asarray(jeng.prefill(np.asarray([PROMPT])))]
    ids = [int(np.argmax(logits[0][0]))]
    for _ in range(4):
        logits.append(np.asarray(jeng.decode_step(np.array([[ids[-1]]]))))
        ids.append(int(np.argmax(logits[-1][0])))
    ids += [int(t) for t in jeng.decode_greedy_n(np.array([[ids[-1]]]), N_IDS - 5)[:, 0]]
    return path, ids, logits


def _params(path, fuse=False):
    cfg, hs = formats.read_header(path)
    params = formats.load_params(path, cfg, hs, dtype=torch.float32)
    assert isinstance(params["layers"]["w1"], Q8Tensor) and isinstance(params["wcls"], Q8Tensor)
    if fuse:
        params = dict(params, layers=fuse_layer_weights(params["layers"]))
    return cfg, params


def test_logits_match_jax(q80_model):
    path, _, want = q80_model
    cfg, params = _params(path)
    eng = InferenceEngine(cfg, params, cache_dtype=torch.float32)
    got = [eng.prefill(np.asarray([PROMPT])).numpy()]
    for w in want[:-1]:
        got.append(eng.decode_step(np.array([[int(np.argmax(w[0]))]])).numpy())
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max()


def test_fuse_layer_weights_concatenates_q8_leaves(q80_model):
    cfg, params = _params(q80_model[0])
    fused = fuse_layer_weights(params["layers"])
    assert "wq" not in fused and "w1" not in fused
    wqkv, w13 = fused["wqkv"], fused["w13"]
    assert isinstance(wqkv, Q8Tensor) and isinstance(w13, Q8Tensor)
    assert wqkv.codes.shape == (cfg.n_layers, cfg.dim, cfg.dim + 2 * cfg.kv_dim)
    assert torch.equal(w13.codes[..., cfg.hidden_dim:], params["layers"]["w3"].codes)
    assert torch.equal(wqkv.scales[..., :cfg.dim], params["layers"]["wq"].scales)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_inference_engine_greedy_ids(q80_model, fuse):
    path, want, _ = q80_model
    cfg, params = _params(path)
    eng = InferenceEngine(cfg, params, cache_dtype=torch.float32, fuse_weights=fuse)
    tok = int(torch.argmax(eng.prefill(np.asarray([PROMPT]))[0]))
    ids = [tok] + [int(t) for t in eng.decode_greedy_n(np.array([[tok]]), N_IDS - 1)[:, 0]]
    assert ids == want


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batch_engine_greedy_ids(q80_model, layout, fuse):
    path, want, _ = q80_model
    cfg, params = _params(path, fuse)
    eng = BatchEngine(cfg, params, n_slots=2, cache_dtype=torch.float32, kv_layout=layout,
                      page_size=8)
    first = eng.add(1, PROMPT, temperature=0.0)
    ids = [first] + [int(t) for t in eng.decode(N_IDS - 1)[:, 1]]
    assert ids == want
