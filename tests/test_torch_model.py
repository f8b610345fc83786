"""The port's Llama forward and InferenceEngine against the JAX package.

* Random Q40 params of the JAX package, carried across by
  params_from_numpy, give the same logits through both forwards (f32
  activations and cache): a prefill and 8 greedy decode steps, within
  1e-4 * max|logit| (the order of f32 sums differs), with identical greedy
  tokens.
* The committed golden `.m` reproduces the pinned temperature-0
  continuation (bf16 embedding, f32 cache), plain and with fused weights.
"""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.engine import GenerationStats, InferenceEngine
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.models import formats
from dllama_tpu_torch.models.config import LlamaConfig
from tests.test_golden import FIXTURE_M, GOLDEN_CONTINUATION, GOLDEN_PROMPT

torch.set_num_threads(1)

DECODE_STEPS = 8
RTOL = 1e-4


def test_forward_matches_jax():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    kw = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=512, seq_len=64)
    jparams = random_params(JaxConfig(**kw), seed=3, dtype=jnp.float32)
    jeng = JaxEngine(JaxConfig(**kw), jparams, cache_dtype=jnp.float32)
    eng = InferenceEngine(LlamaConfig(**kw), params_from_numpy(jax.tree.map(np.asarray, jparams)),
                          cache_dtype=torch.float32)
    prompt = np.random.default_rng(8).integers(0, 512, (1, 11))
    want, got = np.asarray(jeng.prefill(prompt)), eng.prefill(prompt).numpy()
    for _ in range(DECODE_STEPS + 1):
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
        tok = int(np.argmax(want[0]))
        assert int(np.argmax(got[0])) == tok
        want = np.asarray(jeng.decode_step(np.array([[tok]])))
        got = eng.decode_step(np.array([[tok]])).numpy()
    assert eng.pos == jeng.pos


@pytest.mark.parametrize("fuse", [False, True])
def test_golden_continuation(fuse):
    cfg, hs = formats.read_header(FIXTURE_M)
    params = formats.load_params(FIXTURE_M, cfg, hs)
    eng = InferenceEngine(cfg, params, cache_dtype=torch.float32, fuse_weights=fuse)
    tok = int(torch.argmax(eng.prefill(np.asarray([GOLDEN_PROMPT]))[0]))
    ids = [tok] + [int(t) for t in eng.decode_greedy_n(np.array([[tok]]), 15)[:, 0]]
    assert ids == GOLDEN_CONTINUATION


def test_generate_chunks_stop_and_rewind():
    """generate() at temperature 0 yields the greedy continuation across
    decode chunks, and an early stop mid-chunk rewinds the position."""
    cfg, hs = formats.read_header(FIXTURE_M)
    eng = InferenceEngine(cfg, formats.load_params(FIXTURE_M, cfg, hs),
                          cache_dtype=torch.float32)
    stats = GenerationStats()
    out = list(eng.generate(GOLDEN_PROMPT, 16, Sampler(0.0, 0.9, 1), stats=stats, chunk=4))
    assert out == GOLDEN_CONTINUATION
    assert stats.decode_tokens == 15 and eng.pos == len(GOLDEN_PROMPT) + 15
    stop = GOLDEN_CONTINUATION[5]
    eng.reset(0)
    out = list(eng.generate(GOLDEN_PROMPT, 16, Sampler(0.0, 0.9, 1),
                            stop_fn=lambda t: t == stop, chunk=4))
    assert out == GOLDEN_CONTINUATION[:6]
    assert eng.pos == len(GOLDEN_PROMPT) + 5  # rows up to the one that sampled `stop`


def test_penalized_greedy_matches_jax():
    """Presence/frequency penalties at temperature 0: the penalized argmax
    is deterministic, so both packages must emit the same tokens. Negative
    penalties reward repeats, so the text does change."""
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.engine.sampling import Sampler as JaxSampler
    from dllama_tpu.models import formats as jf

    jcfg, jhs = jf.read_header(FIXTURE_M)
    jeng = JaxEngine(jcfg, jf.load_params(FIXTURE_M, jcfg, jhs), cache_dtype=jnp.float32)
    want = list(jeng.generate(GOLDEN_PROMPT, 12, JaxSampler(0.0, 0.9, 1, -2.0, -1.0)))
    cfg, hs = formats.read_header(FIXTURE_M)
    eng = InferenceEngine(cfg, formats.load_params(FIXTURE_M, cfg, hs),
                          cache_dtype=torch.float32)
    got = list(eng.generate(GOLDEN_PROMPT, 12, Sampler(0.0, 0.9, 1, -2.0, -1.0)))
    assert got == want
    assert got != GOLDEN_CONTINUATION[:12]  # the penalties did change the text
