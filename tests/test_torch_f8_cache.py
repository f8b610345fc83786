"""The f8 (e4m3) KV cache against the JAX package, on one tiny f32 model
(weights from a seed, carried across with convert.params_from_numpy).

* The same prefill writes the same cache bytes (``view(uint8)``) wherever
  the JAX value is in range: both cast f32 rows to e4m3 with round to
  nearest even. Out of range (|x| > 448) torch saturates to ±448 where JAX
  gives NaN, a difference by design (ROADMAP §C); this model never gets
  there.
* Both read the same e4m3 bytes widened to f32, so the logits agree within
  1e-4 of max|logit| (the order of the f32 sums differs), and 16 greedy ids
  are identical, through the port's InferenceEngine and its BatchEngine on
  the dense layout and (on the CPU) the paged gather.
* The paged kernel keeps the JAX package's bf16/f32 pool rule: with f8,
  ``--kv-layout auto`` resolves to dense, and an explicit paged layout on a
  CUDA device is refused naming ``--kernels torch``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.kernel_select import resolve_kernels
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, _cache_update

torch.set_num_threads(1)

F8 = torch.float8_e4m3fn
KW = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=96,
          seq_len=64)  # head size 64: a size the paged kernel takes
CFG = LlamaConfig(**KW)
PROMPT = [1, 5, 9, 13, 17, 21, 40, 77]
N_IDS = 16
RTOL = 1e-4


@pytest.fixture(scope="module")
def f8_run():
    """(port params, JAX prefill logits, JAX cache k/v bytes after the
    prefill, JAX greedy ids)."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jcfg = JaxConfig(**KW)
    jparams = random_params(jcfg, seed=4, dtype=jnp.float32, quantize=False)
    jeng = JaxEngine(jcfg, jparams, cache_dtype=jnp.float8_e4m3fn)
    logits = np.asarray(jeng.prefill(np.asarray([PROMPT])))
    cache = [np.asarray(c).view(np.uint8).copy() for c in (jeng.cache.k, jeng.cache.v)]
    finite = [np.isfinite(np.asarray(c).astype(np.float32)) for c in (jeng.cache.k, jeng.cache.v)]
    tok = int(np.argmax(logits[0]))
    ids = [tok] + [int(t) for t in jeng.decode_greedy_n(np.array([[tok]]), N_IDS - 1)[:, 0]]
    return params_from_numpy(jax.tree.map(np.asarray, jparams)), logits, cache, finite, ids


def test_prefill_cache_bytes_and_logits_match_jax(f8_run):
    params, want, cache, finite, _ = f8_run
    eng = InferenceEngine(CFG, params, cache_dtype=F8)
    assert eng.cache.k.dtype == F8 and eng.cache.v.dtype == F8
    got = eng.prefill(np.asarray([PROMPT])).numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    for ours, theirs, ok in zip((eng.cache.k, eng.cache.v), cache, finite):
        assert ok.all()  # no value of this model is out of e4m3's range
        ours = ours.view(torch.uint8).numpy()
        np.testing.assert_array_equal(ours[ok], theirs[ok])
        assert ours[:, :, :, len(PROMPT):].max() == 0  # rows past the prompt stay +0.0


@pytest.mark.parametrize("engine", ["single", "batch-dense", "batch-paged"])
def test_greedy_ids_match_jax(f8_run, engine):
    params, _, _, _, want = f8_run
    if engine == "single":
        eng = InferenceEngine(CFG, params, cache_dtype=F8)
        tok = int(torch.argmax(eng.prefill(np.asarray([PROMPT]))[0]))
        ids = [tok] + [int(t) for t in eng.decode_greedy_n(np.array([[tok]]), N_IDS - 1)[:, 0]]
    else:
        layout = engine.split("-")[1]
        eng = BatchEngine(CFG, params, n_slots=2, cache_dtype=F8, kv_layout=layout,
                          page_size=8)
        assert eng.attn_route == ("paged_gather" if layout == "paged" else "torch")
        ids = [eng.add(0, PROMPT, temperature=0.0)]
        ids += [int(t) for t in eng.decode(N_IDS - 1)[:, 0]]
        assert eng.cache.k.dtype == F8
    assert ids == want


def test_cache_write_saturates_and_keeps_frozen_rows():
    """The byte-level write: values past 448 saturate (JAX would store NaN),
    values in range round as a cast does, and rows of inactive slots keep
    their bytes, for scalar and per-row positions."""
    cache = KVCache.create(CFG, 2, F8, seq_len=8).k[0]  # [B, Hkv, S, hd]
    new = torch.full((2, 1, 2, 64), 1.3)
    new[0, 0, 0, 0], new[1, 0, 1, 5] = 500.0, -1e4
    _cache_update(cache, new, 3)
    assert cache[0, 0, 3, 0].float() == 448.0 and cache[1, 0, 4, 5].float() == -448.0
    assert cache[0, 0, 3, 1].float() == torch.tensor(1.3).to(F8).float() == 1.25
    before = cache.view(torch.uint8).clone()
    _cache_update(cache, torch.zeros_like(new), torch.tensor([0, 5]), torch.tensor([False, True]))
    after = cache.view(torch.uint8)
    assert torch.equal(after[0], before[0])  # the inactive slot is untouched
    assert after[1, :, 5:7].max() == 0 and torch.equal(after[1, :, :5], before[1, :, :5])


def test_auto_layout_resolves_dense_and_explicit_paged_is_refused_on_cuda(f8_run):
    from dllama_tpu_torch.serve.api import resolve_kv_layout

    params = f8_run[0]
    for dtype, layout in ((torch.bfloat16, "paged"), (F8, "dense")):
        eng = InferenceEngine(CFG, params, cache_dtype=dtype)
        assert resolve_kv_layout(SimpleNamespace(engine=eng, config=CFG), "auto", 32)[0] == layout
    assert resolve_kernels(CFG, "auto", "cuda", cache_dtype=F8).attn_route == "flash"
    with pytest.raises(NotImplementedError, match="--kernels torch"):
        resolve_kernels(CFG, "auto", "cuda", paged=True, page_size=32, cache_dtype=F8)
    assert resolve_kernels(CFG, "torch", "cuda", paged=True, page_size=32,
                           cache_dtype=F8).attn_route == "paged_gather"


def test_cli_takes_cache_dtype_f8(tmp_path, capsys):
    from dllama_tpu_torch.cli.main import main
    from tests.test_golden import FIXTURE_M
    from tests.test_torch_isolation import _tokenizer

    assert main(["inference", "--model", FIXTURE_M, "--tokenizer", _tokenizer(tmp_path),
                 "--prompt", "hi", "--steps", "4", "--device", "cpu", "--temperature", "0",
                 "--cache-dtype", "f8"]) == 0
    assert "Decode:" in capsys.readouterr().err
