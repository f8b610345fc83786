"""The Q40 decode-style ladder of the port (ops/q40_matmul.py) against the
JAX package's q40_matmul:

* resolve_style picks the style JAX's dispatcher calls, for every STYLE and
  row count (the JAX kernels are replaced by recorders, so only the routing
  runs);
* the plain versions of K3 (maskdot) and K4 (loopdot), which the CUDA kernels
  are held against on the card, equal JAX's maskdot/loopdot kernels in
  interpret mode: f32 throughout, within 1e-5 * max|ref| (only the order of
  the f32 sums differs);
* the BLOCKDOT_TK / BLOCKDOT_TN overrides fall back as JAX's do.
"""

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.ops import q40_matmul as tq

torch.set_num_threads(1)

LAYER = 1
RTOL = 1e-5
JAX_CALLS = {"blockdot": "_blockdot_call", "maskdot": "_maskdot_call",
             "loopdot": "_loopdot_call", "deq": "_deq_call"}


def _jax_weights(k, n, seed=4):
    """A stacked L=2 Q40 weight in both packages (layer 1 is used)."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.ops.quant import QTensor

    rng = np.random.default_rng(seed)
    ws = [QTensor.quantize(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
          for _ in range(2)]
    jw = jax.tree.map(lambda *xs: jnp.stack(xs), *ws)
    return jw, params_from_numpy(jax.tree.map(np.asarray, jw))


@pytest.fixture
def jax_route(monkeypatch):
    """Run the JAX dispatcher with each kernel call replaced by a recorder:
    -> fn(style, m, k, n, tk, tn) returning (the call it made, its kwargs)."""
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas import q40_matmul as jq

    seen = []
    for style, name in JAX_CALLS.items():
        def rec(layer, x, packed, scales, *, interpret=False, _style=style, **kw):
            seen.append((_style, kw))
            return jnp.zeros((x.shape[0], packed.shape[-1]), jnp.float32)

        monkeypatch.setattr(jq, name, rec)
    weights = {}

    def route(style, m, k=256, n=256, tk=None, tn=None):
        if (k, n) not in weights:
            weights[k, n] = _jax_weights(k, n)[0]
        monkeypatch.setattr(jq, "STYLE", style)
        monkeypatch.setattr(jq, "BLOCKDOT_TK", tk)
        monkeypatch.setattr(jq, "BLOCKDOT_TN", tn)
        seen.clear()
        jq.q40_matmul(jnp.zeros((m, k), jnp.float32), weights[k, n], 1)
        (call,) = seen
        return call

    return route


@pytest.mark.parametrize("style", tq.STYLES)
def test_resolve_style_matches_jax(jax_route, style):
    for m in (1, 3, 8, 9, 16, 17, 64):
        assert tq.resolve_style(style, m) == jax_route(style, m)[0], (style, m)


def test_unknown_style_is_refused():
    with pytest.raises(ValueError, match="style"):
        tq.resolve_style("blocky", 1)


def test_blockdot_tile_overrides_fall_back_as_in_jax(jax_route):
    k = n = 256
    for tk in (None, 32, 64, 96, 100, 128, 256, 512):
        for tn in (None, 128, 256, 512, 96, 200):
            want = jax_route("blockdot", 8, k, n, tk, tn)[1]
            assert tq.blockdot_tiles(k, n, tk, tn) == (want["tk"], want["tn"]), (tk, tn)
    # the port is compiled for 128/256/512 columns a block: a divisor of n
    # outside that set (which Pallas would tile) falls back too
    assert tq.blockdot_tiles(k, n, None, 64) == (None, None)
    assert tq.blockdot_tiles(4096, 128256, 512, 512) == (512, None)  # 128256 % 512 != 0
    # the overrides set K1's k rows per split and columns per block
    assert tq.decode_geometry(4096, 14336, 132, 512, 128) == (8, 16, 128)


@pytest.mark.parametrize("style", ["maskdot", "loopdot"])
@pytest.mark.parametrize("k,n", [(128, 128), (128, 256), (256, 128), (256, 256)])
def test_plain_matches_pallas_interpret(style, k, n, monkeypatch):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas import q40_matmul as jq

    jw, tw = _jax_weights(k, n, seed=k + n)
    m = 5 if k == n else 16  # 5 pads to 8 rows in JAX
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    monkeypatch.setattr(jq, "STYLE", style)
    want = np.asarray(jq.q40_matmul(jnp.asarray(x), jw, jnp.int32(LAYER), interpret=True))
    plain = tq.STYLE_PLAIN[style]
    got = plain(torch.from_numpy(x), tw, LAYER).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("style", ["maskdot", "loopdot"])
def test_wrapper_runs_the_styles_plain_version_on_cpu(style, monkeypatch):
    _, tw = _jax_weights(128, 128)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3, 128))
                         .astype(np.float32)).to(torch.bfloat16)
    before = dict(tq.LAUNCHES)
    monkeypatch.setattr(tq, "STYLE", style)
    got = tq.q40_matmul(x, tw, LAYER)
    plain = tq.STYLE_PLAIN[style]
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, 128)
    assert torch.equal(got, plain(x, tw, LAYER))
    # a prefill-shaped call under a forced decode style is deq's plain version
    x17 = x.new_ones((17, 128))
    assert torch.equal(tq.q40_matmul(x17, tw, LAYER), tq.q40_matmul_plain(x17, tw, LAYER))
    assert tq.LAUNCHES == before  # the plain versions are no launch


def test_forced_style_restores_the_callers_knobs(monkeypatch):
    from dllama_tpu_torch.experiments import kbench
    from dllama_tpu_torch.ops.quant import QTensor

    monkeypatch.setattr(tq, "STYLE", "loopdot")
    monkeypatch.setattr(tq, "BLOCKDOT_TK", 64)
    monkeypatch.setattr(tq, "BLOCKDOT_TN", 128)
    _, tw = _jax_weights(128, 128)
    x = torch.ones((2, 128), dtype=torch.bfloat16)
    with tq.forced_style("maskdot"):
        assert (tq.STYLE, tq.BLOCKDOT_TK, tq.BLOCKDOT_TN) == ("maskdot", None, None)
        assert torch.equal(tq.q40_matmul(x, tw, LAYER), tq.q40_maskdot_plain(x, tw, LAYER))
    assert (tq.STYLE, tq.BLOCKDOT_TK, tq.BLOCKDOT_TN) == ("loopdot", 64, 128)
    with pytest.raises(RuntimeError), tq.forced_style("deq", 32, 256):
        raise RuntimeError  # restored on the way out of an exception too
    assert (tq.STYLE, tq.BLOCKDOT_TK, tq.BLOCKDOT_TN) == ("loopdot", 64, 128)
    with pytest.raises(ValueError):
        with tq.forced_style("fastest"):
            pass
    # kbench's forced dispatch leaves the caller's style in place
    kbench.dispatch_closure(QTensor(tw.packed[LAYER], tw.scales[LAYER]), "blockdot", 32)(x)
    assert (tq.STYLE, tq.BLOCKDOT_TK, tq.BLOCKDOT_TN) == ("loopdot", 64, 128)
