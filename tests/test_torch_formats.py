"""The PyTorch port's `.m` reader and writer against the JAX package's: the
committed golden fixture loads to byte-equal leaves, and both writers emit
the same file bytes."""

import os

import numpy as np
import pytest
import torch

from dllama_tpu.models import formats as jf
from dllama_tpu_torch.models import formats as tf

torch.set_num_threads(1)

FIXTURE_M = os.path.join(os.path.dirname(__file__), "fixtures", "golden_tiny.m")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16
             else a.numpy())
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float16"):
        return a.view(np.uint16)
    return a


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif hasattr(tree, "scales"):  # QTensor / Q8Tensor
        for field in ("packed", "codes", "scales"):
            if hasattr(tree, field):
                yield prefix + field, getattr(tree, field)
    else:
        yield prefix.rstrip("."), tree


def _assert_same(want_tree, got_tree) -> None:
    want, got = dict(_leaves(want_tree)), dict(_leaves(got_tree))
    assert sorted(got) == sorted(want)
    for name in want:
        w, g = _bits(want[name]), _bits(got[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name


def test_golden_fixture_leaves_byte_equal():
    jcfg, jhs = jf.read_header(FIXTURE_M)
    cfg, hs = tf.read_header(FIXTURE_M)
    assert (cfg.to_header_kv(), hs) == (jcfg.to_header_kv(), jhs)
    _assert_same(jf.load_params(FIXTURE_M, jcfg, jhs), tf.load_params(FIXTURE_M, cfg, hs))


def test_writer_matches_jax_writer(tmp_path):
    from dllama_tpu.models.config import LlamaConfig

    jcfg = LlamaConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=2,
                       vocab_size=40, seq_len=32)
    cfg, _ = tf.read_header(FIXTURE_M)
    cfg = type(cfg)(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    rng = np.random.default_rng(3)
    tensors = {name: rng.standard_normal(shape).astype(np.float32) * 0.1
               for name, shape, _ in jf.tensor_plan(jcfg)}
    jf.save_model(str(tmp_path / "jax.m"), jcfg, tensors)
    tf.save_model(str(tmp_path / "torch.m"), cfg, tensors)
    assert (tmp_path / "torch.m").read_bytes() == (tmp_path / "jax.m").read_bytes()


def test_truncated_file_names_the_tensor(tmp_path):
    data = open(FIXTURE_M, "rb").read()
    bad = tmp_path / "short.m"
    bad.write_bytes(data[: len(data) - 100])
    cfg, hs = tf.read_header(str(bad))
    with pytest.raises(tf.ModelFileError, match="wcls"):
        tf.load_params(str(bad), cfg, hs)



def test_q80_file_loads_like_jax(tmp_path):
    """A Q80 `.m` keeps its weights packed (codes + f16 scales, byte-equal
    to the JAX package's Q8Tensor leaves), and loads packed on another
    device too (the raw records are uploaded, then rearranged there)."""
    from dllama_tpu.models.config import LlamaConfig
    from dllama_tpu.ops.quant import FloatType

    jcfg = LlamaConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=2,
                       vocab_size=40, seq_len=32, weight_type=FloatType.Q80)
    rng = np.random.default_rng(4)
    tensors = {name: rng.standard_normal(shape).astype(np.float32) * 0.1
               for name, shape, _ in jf.tensor_plan(jcfg)}
    path = str(tmp_path / "q80.m")
    jf.save_model(path, jcfg, tensors)
    cfg, hs = tf.read_header(path)
    _assert_same(jf.load_params(path, *jf.read_header(path), q80_packed=True),
                 tf.load_params(path, cfg, hs))
    from dllama_tpu_torch.ops.quant import Q8Tensor

    meta = tf.load_params(path, cfg, hs, device="meta")
    for w in [meta["wcls"], *(meta["layers"][n] for n in ("wq", "wk", "w1", "w2"))]:
        assert isinstance(w, Q8Tensor)
        assert w.codes.device.type == "meta" and w.codes.dtype == torch.int8
        assert w.scales.dtype == torch.float16
        assert w.scales.shape[-2:] == (w.codes.shape[-2] // 32, w.codes.shape[-1])
    assert meta["layers"]["w1"].codes.shape == (1, 64, 96)
