"""Sessions on the port's single engine (``InferenceEngine.save_session`` /
``load_session``), ported from the JAX suite's ``tests/test_engine.py``
session cases and held against the JAX engine on the same tiny model (dim
64, 2 layers, vocab 64, random f32 weights):

* save mid-conversation, restore into a fresh engine, continue: the
  continuation equals the uninterrupted run's and the JAX engine's ids;
* a session refuses an engine of another geometry or other weights;
* an f8 (e4m3) cache round-trips byte for byte;
* ``load_session`` copies INTO the existing cache tensors: their addresses
  (which a captured program holds) do not change, and the decode programs
  made before the load read the restored rows.
"""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.models.config import LlamaConfig

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64,
          seq_len=64)
TINY = LlamaConfig(**KW)


def _jparams(seed, **kw):
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    return random_params(JaxConfig(**dict(KW, **kw)), seed=seed, dtype=jnp.float32,
                         quantize=False)


def make_engine(seed=0, cache_dtype=torch.float32, **kw):
    import jax

    cfg = LlamaConfig(**dict(KW, **kw))
    params = params_from_numpy(jax.tree.map(np.asarray, _jparams(seed, **kw)))
    return InferenceEngine(cfg, params, cache_dtype=cache_dtype)


def test_session_save_load_roundtrip(tmp_path):
    """Save after 5 tokens, load into a fresh engine, decode 5 more: the 10
    tokens equal the uninterrupted run's, and the JAX engine's."""
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.engine.sampling import Sampler as JaxSampler
    from dllama_tpu.models.config import LlamaConfig as JaxConfig

    sampler = Sampler(temperature=0.0, topp=0.9, seed=0)
    full = list(make_engine().generate([1, 2, 3], 10, sampler, chunk=1))
    e1 = make_engine()
    first5 = list(e1.generate([1, 2, 3], 5, sampler, chunk=1))
    path = str(tmp_path / "session.npz")
    e1.save_session(path)
    e2 = make_engine()
    e2.load_session(path)
    assert e2.pos == e1.pos == 3 + 4  # the fifth token is sampled, not yet fed
    toks = e2.decode_greedy_n(np.array([full[4]]), 5)
    assert first5 + [int(t) for t in toks[:, 0]] == full
    jeng = JaxEngine(JaxConfig(**KW), _jparams(0), cache_dtype=jnp.float32)
    jfull = list(jeng.generate([1, 2, 3], 10, JaxSampler(temperature=0.0, topp=0.9, seed=0),
                               chunk=1))
    assert [int(t) for t in jfull] == full


def test_session_fingerprint_mismatch(tmp_path):
    e1 = make_engine()
    path = str(tmp_path / "s.npz")
    e1.save_session(path)
    e2 = make_engine(n_layers=1)
    with pytest.raises(ValueError, match="does not match"):
        e2.load_session(path)


def test_session_fingerprint_rejects_different_weights(tmp_path):
    """Same geometry, other weights: the session is refused (its cache would
    not match the weights); the same weights take it."""
    e1 = make_engine(seed=0)
    e1.prefill(np.array([[1, 2, 3]]))
    path = str(tmp_path / "sess.npz")
    e1.save_session(path)
    with pytest.raises(ValueError, match="does not match"):
        make_engine(seed=1).load_session(path)
    e3 = make_engine(seed=0)
    e3.load_session(path)
    assert e3.pos == e1.pos == 3


def test_session_f8_cache_round_trips_bytes(tmp_path):
    """An e4m3 cache is stored as its bytes and comes back byte for byte."""
    e1 = make_engine(cache_dtype=torch.float8_e4m3fn)
    e1.prefill(np.array([[5, 6, 7, 8, 9]]))
    path = str(tmp_path / "f8.npz")
    e1.save_session(path)
    e2 = make_engine(cache_dtype=torch.float8_e4m3fn)
    e2.load_session(path)
    for a, b in ((e1.cache.k, e2.cache.k), (e1.cache.v, e2.cache.v)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert a.view(torch.uint8).any()
    with np.load(path) as data:
        assert str(data["cache_dtype"]) == "float8_e4m3fn" and data["k"].dtype == np.uint8


def test_load_session_keeps_the_cache_addresses(tmp_path):
    """load_session copies into the cache the programs were made over: the
    cache tensors keep their addresses, and a decode program made BEFORE
    the load (the one a card would replay) continues from the restored
    rows exactly as a fresh engine's does."""
    sampler = Sampler(temperature=0.0, topp=0.9, seed=0)
    e1 = make_engine()
    head = list(e1.generate([4, 5, 6], 4, sampler, chunk=4))
    path = str(tmp_path / "p.npz")
    e1.save_session(path)
    e2 = make_engine()
    list(e2.generate([9, 9, 9, 9, 9, 9], 6, sampler, chunk=4))  # other rows, same programs
    ptrs = (e2.cache.k.data_ptr(), e2.cache.v.data_ptr())
    progs = dict(e2.programs._progs)
    e2.load_session(path)
    assert (e2.cache.k.data_ptr(), e2.cache.v.data_ptr()) == ptrs
    cont = e2.decode_greedy_n(np.array([head[-1]]), 4)[:, 0].tolist()
    assert set(progs) <= set(e2.programs._progs)
    assert all(e2.programs._progs[k] is p for k, p in progs.items())
    ref = make_engine()
    full = list(ref.generate([4, 5, 6], 8, sampler, chunk=4))
    assert head + cont == full
