"""``--dequantize`` in the port (``models.formats.load_params(dequantize=True)``,
``engine.loader.load_model(dequantize=True)``) against the JAX package's.

* The tree: every Q40/Q80 matmul weight, wcls and an MoE model's experts
  included, loads as a dense bf16 tensor equal to JAX's
  ``load_params(dequantize=True)`` bit for bit; norms, the router and the
  embedding as without the flag.
* The forward on the dequantized tree runs ``torch.matmul`` on those dense
  weights: on f32 trees it gives JAX's logits within 1e-4 of max|logit|, and
  the packed tree's plain forward (which dequantizes to the activation
  dtype a call) within 1e-6.
* Greedy ids from ``InferenceEngine`` on the dequantized golden model equal
  the JAX engine's on JAX's dequantized tree.
* The CLI takes ``--dequantize`` and ``--moe`` with the JAX parser's
  defaults, and ``inference --dequantize`` and ``inference --moe`` run an MoE
  `.m` on the CPU, as does ``info`` (its MoE line).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.models import formats
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.models.llama import KVCache, forward
from dllama_tpu_torch.ops.layers import build_rope_cache
from dllama_tpu_torch.ops.quant import FloatType, Q8Tensor, QTensor
from tests.test_golden import FIXTURE_M, GOLDEN_PROMPT
from tests.test_torch_isolation import _tokenizer

torch.set_num_threads(1)

DENSE = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
             seq_len=64)
MOE = dict(DENSE, n_experts=4, n_active_experts=2)
MATMULS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "moe_w1", "moe_w2", "moe_w3")


def _write(tmp_path, kw, wt) -> str:
    cfg = LlamaConfig(**kw, weight_type=FloatType[wt])
    rng = np.random.default_rng(21)
    path = str(tmp_path / f"{wt}_{cfg.n_experts}.m")
    formats.save_model(path, cfg, {n: (rng.standard_normal(s) * 0.1).astype(np.float32)
                                   for n, s, _ in formats.tensor_plan(cfg)})
    return path


def _load(path, dtype, dequantize):
    cfg, hs = formats.read_header(path)
    return cfg, formats.load_params(path, cfg, hs, dtype=dtype, dequantize=dequantize)


def _jax_load(path, dtype, dequantize):
    import jax

    from dllama_tpu.models import formats as jf

    cfg, hs = jf.read_header(path)
    params = jf.load_params(path, cfg, hs, dtype=dtype, dequantize=dequantize, q80_packed=True)
    return cfg, params, params_from_numpy(jax.tree.map(np.asarray, params))


def _leaves(tree, path="params"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("wt", ["Q40", "Q80"])
@pytest.mark.parametrize("kw", [DENSE, MOE], ids=["dense", "moe"])
def test_dequantized_tree_equals_jax(tmp_path, wt, kw):
    import jax.numpy as jnp

    path = _write(tmp_path, kw, wt)
    _, ours = _load(path, torch.bfloat16, True)
    _, _, theirs = _jax_load(path, jnp.bfloat16, True)
    ref = dict(_leaves(theirs))
    seen = set()
    for name, leaf in _leaves(ours):
        want = ref[name]
        assert isinstance(leaf, torch.Tensor) and isinstance(want, torch.Tensor), name
        assert leaf.dtype == want.dtype and torch.equal(leaf, want), name
        short = name.split(".")[-1]
        if short in MATMULS or short == "wcls":
            assert leaf.dtype == torch.bfloat16, name
            seen.add(short)
    assert set(ref) == {n for n, _ in _leaves(ours)}
    assert "wcls" in seen and ({"moe_w1", "moe_w2", "moe_w3"} <= seen) == bool(
        kw.get("n_experts"))
    # without the flag the same file keeps every matmul weight packed
    _, packed = _load(path, torch.bfloat16, False)
    kind = QTensor if wt == "Q40" else Q8Tensor
    assert isinstance(packed["wcls"], kind) and isinstance(packed["layers"]["wq"], kind)


@pytest.mark.parametrize("kw", [DENSE, MOE], ids=["dense", "moe"])
def test_dequantized_forward_matches_jax_and_the_packed_tree(tmp_path, kw):
    import jax.numpy as jnp

    from dllama_tpu.models.llama import KVCache as JaxKV
    from dllama_tpu.models.llama import forward as jax_forward
    from dllama_tpu.ops.layers import build_rope_cache as jax_rope

    path = _write(tmp_path, kw, "Q40")
    cfg, dq = _load(path, torch.float32, True)
    _, packed = _load(path, torch.float32, False)
    jcfg, jparams, _ = _jax_load(path, jnp.float32, True)
    toks = np.random.default_rng(22).integers(0, cfg.vocab_size, (1, 7))
    rope = build_rope_cache(cfg)
    got = forward(cfg, dq, torch.from_numpy(toks), 0, KVCache.create(cfg, 1, torch.float32),
                  rope)[0].numpy()
    plain = forward(cfg, packed, torch.from_numpy(toks), 0,
                    KVCache.create(cfg, 1, torch.float32), rope)[0].numpy()
    want = np.asarray(jax_forward(jcfg, jparams, jnp.asarray(toks, jnp.int32), jnp.int32(0),
                                  JaxKV.create(jcfg, 1, jnp.float32), jax_rope(jcfg))[0])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale
    assert np.abs(got - plain).max() <= 1e-6 * scale
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_dequantized_golden_greedy_ids_equal_jax():
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.engine.sampling import Sampler as JaxSampler

    jcfg, jparams, _ = _jax_load(FIXTURE_M, jnp.bfloat16, True)
    want = list(JaxEngine(jcfg, jparams, cache_dtype=jnp.float32).generate(
        GOLDEN_PROMPT, 12, JaxSampler(0.0, 0.9, 1)))
    cfg, params = _load(FIXTURE_M, torch.bfloat16, True)
    eng = InferenceEngine(cfg, params, cache_dtype=torch.float32)
    assert list(eng.generate(GOLDEN_PROMPT, 12, Sampler(0.0, 0.9, 1))) == want


def test_load_model_takes_dequantize_and_moe():
    from dllama_tpu_torch.engine.loader import load_model

    m = load_model(FIXTURE_M, dequantize=True, moe_impl="dispatch", device="cpu")
    assert m.engine.moe_impl == "dispatch"
    assert all(isinstance(m.engine.params["layers"][k], torch.Tensor)
               for k in ("wq", "w1", "w2"))
    assert m.engine.params["wcls"].dtype == torch.bfloat16


def test_cli_flags_match_the_jax_parser():
    from dllama_tpu.cli.main import build_parser as jax_parser
    from dllama_tpu_torch.cli.main import build_parser

    for argv in (["serve", "--model", "m"], ["inference", "--model", "m", "--dequantize",
                                             "--moe", "dense"]):
        ours, theirs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
        assert (ours.dequantize, ours.moe) == (theirs.dequantize, theirs.moe)
    ours = {a.dest: a for a in build_parser()._actions}
    theirs = {a.dest: a for a in jax_parser()._actions}
    assert ours["dequantize"].help == theirs["dequantize"].help
    assert ours["moe"].help == theirs["moe"].help


def _cli(argv):
    from dllama_tpu_torch.cli.main import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_runs_an_moe_model_with_each_flag(tmp_path):
    """`inference` on a tiny MoE `.m` under --moe sort and dense and with
    --dequantize: the same greedy text (f32 cache; the schemes are exact on
    the CPU); `info` prints the MoE line."""
    path = _write(tmp_path, dict(MOE, vocab_size=1057), "Q40")
    tok = _tokenizer(tmp_path)
    base = ["inference", "--model", path, "--tokenizer", tok, "--prompt", "hello moe",
            "--steps", "6", "--temperature", "0", "--device", "cpu", "--cache-dtype", "f32"]
    texts = []
    for extra in (["--moe", "sort"], ["--moe", "dense"], ["--dequantize"]):
        rc, out, err = _cli(base + extra)
        assert rc == 0, err
        texts.append(out)
    assert texts[0] == texts[1]
    assert len(texts[2]) > 0
    rc, out, _ = _cli(["info", "--model", path, "--device", "cpu", "--moe", "sort"])
    assert rc == 0 and "experts=4/2" in out and "moe: 4 experts, 2 active; --moe sort" in out


def test_dense_config_has_no_moe_line(capsys):
    rc, out, _ = _cli(["info", "--model", FIXTURE_M, "--device", "cpu"])
    assert rc == 0 and "moe:" not in out
    cfg, _ = formats.read_header(FIXTURE_M)
    assert dataclasses.replace(cfg, n_experts=8, n_active_experts=2).describe().endswith(
        "experts=8/2")
