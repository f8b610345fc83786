"""The port's native host library (``dllama_tpu_torch/utils/native.py``, its
own copy of the C++ in ``utils/csrc/native.cpp``) against its numpy/Python
fallback and against the JAX package's native library, on the cases of
``tests/test_native.py``: Q40/Q80 quantize bytes, BPE ids and the "cannot
tokenize" errors, and ``write_tensor``'s bytes. Everything is bit-equal; no
tolerance applies."""

import io
import pathlib

import numpy as np
import pytest
import torch

from dllama_tpu_torch.models.formats import write_tensor
from dllama_tpu_torch.ops.quant import FloatType, quantize_q40_np, quantize_q80_np
from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer
from dllama_tpu_torch.utils import native

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_native():
    from dllama_tpu.utils import native as jnative

    assert jnative.available()
    return jnative


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1].view(np.uint16), b[1].view(np.uint16))


def test_library_is_built_from_the_ports_source_into_its_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.parent == ROOT / "dllama_tpu_torch" / "build" and path.exists()
    assert native.SOURCE == ROOT / "dllama_tpu_torch" / "utils" / "csrc" / "native.cpp"
    assert native._lib._name == str(path)
    # the JAX package's library is not what the port loads
    assert "native/build" not in native._lib._name


def _blocks(rng, n, kind):
    if kind == "normal":
        x = (rng.standard_normal(n) * rng.uniform(0.01, 10)).astype(np.float32)
        x[:32] = 0.0  # an exact-zero block (delta == 0)
        return x
    # f32 -> f16 rounding edges: tiny deltas (subnormal halves) and large ones
    return np.concatenate([
        rng.standard_normal(32).astype(np.float32) * 1e-7,
        rng.standard_normal(32).astype(np.float32) * 1e4,
        rng.standard_normal(32).astype(np.float32) * 6e-5,
    ])


@pytest.mark.parametrize("n,kind", [(32, "normal"), (4096, "normal"), (32 * 1000 + 32, "normal"),
                                    (96, "subnormal_and_large")])
@pytest.mark.parametrize("fmt", ["q40", "q80"])
def test_quantize_bytes_equal_numpy_and_jax(rng, jax_native, n, kind, fmt):
    x = _blocks(rng, n, kind)
    numpy_fn = quantize_q40_np if fmt == "q40" else quantize_q80_np
    got = getattr(native, f"quantize_{fmt}")(x)
    _equal(got, numpy_fn(x))
    _equal(got, getattr(jax_native, f"quantize_{fmt}")(x))


def test_quantize_keeps_leading_axes(rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    for fn, ref in ((native.quantize_q40, quantize_q40_np), (native.quantize_q80, quantize_q80_np)):
        got, want = fn(x), ref(x)
        assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
        _equal(got, want)


def _vocab():
    vocab = [bytes([i]) for i in range(256)]
    extra = [b"he", b"ll", b"hell", b"hello", b" wo", b" world", b"ld"]
    scores = [-float(i) for i in range(256)] + [5.0, 4.0, 6.0, 9.0, 3.0, 8.0, 2.0]
    vocab += extra
    specials = [b"<s>", b"</s>", b"<|eot|>"]
    bos = len(vocab)
    vocab += specials
    scores += [0.0] * len(specials)
    return vocab, scores, bos


def _mk_tokenizer(cls, native_on: bool):
    vocab, scores, bos = _vocab()
    t = cls(vocab, scores, bos, [bos + 1, bos + 2])
    if not native_on:
        t._native_tried = True  # force the pure-Python path
    return t


@pytest.mark.parametrize(
    "text",
    ["hello world", "hello <s>x</s> bye", "", "héllo ✨", "<|eot|>", "aaa<s>"],
)
@pytest.mark.parametrize("add_bos", [True, False])
@pytest.mark.parametrize("add_special", [True, False])
def test_bpe_ids_equal_fallback_and_jax(text, add_bos, add_special):
    from dllama_tpu.tokenizer.tokenizer import Tokenizer as JaxTokenizer

    t_native = _mk_tokenizer(Tokenizer, True)
    kw = dict(add_bos=add_bos, add_special_tokens=add_special)
    got = t_native.encode(text, **kw)
    assert t_native._native is not None  # really exercised the C++ path
    assert got == _mk_tokenizer(Tokenizer, False).encode(text, **kw)
    assert got == _mk_tokenizer(JaxTokenizer, True).encode(text, **kw)


def test_bpe_ids_equal_on_a_merge_rich_text(rng):
    """A vocabulary of every byte pair and triple of a text, scored at
    random: merges everywhere, ties included."""
    from dllama_tpu.tokenizer.tokenizer import Tokenizer as JaxTokenizer

    text = (ROOT / "README.md").read_bytes()[:3000]
    pieces = sorted({text[i:i + n] for n in (2, 3) for i in range(len(text) - n)})
    vocab = [bytes([i]) for i in range(256)] + pieces + [b"<s>", b"</s>"]
    scores = [0.0] * 256 + rng.integers(-50, 50, len(pieces)).astype(float).tolist() + [0.0, 0.0]
    bos = len(vocab) - 2
    args = (vocab, scores, bos, [bos + 1])
    t_native, t_py = Tokenizer(*args), Tokenizer(*args)
    t_py._native_tried = True
    got = t_native.encode(text)
    assert len(got) < len(text) // 2
    assert got == t_py.encode(text) == JaxTokenizer(*args).encode(text)


@pytest.mark.parametrize("native_on", [True, False])
def test_bpe_error_equals_jax(native_on):
    from dllama_tpu.tokenizer.tokenizer import Tokenizer as JaxTokenizer

    vocab = [b"a", b"b", b"<s>"]  # cannot tokenize arbitrary bytes
    errors = []
    for cls in (Tokenizer, JaxTokenizer):
        t = cls(vocab, [0.0, 0.0, 0.0], 2, [2])
        if not native_on:
            t._native_tried = True
        with pytest.raises(ValueError, match="cannot tokenize") as e:
            t.encode("xyz")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("ft", [FloatType.Q40, FloatType.Q80, FloatType.F16, FloatType.F32])
def test_write_tensor_native_equals_numpy_and_jax(rng, monkeypatch, ft):
    """write_tensor's native bytes equal its numpy path's and the JAX
    writer's, and read back onto the same grid."""
    from dllama_tpu.models.formats import write_tensor as jax_write_tensor
    from dllama_tpu.ops.quant import FloatType as JaxFloatType
    from dllama_tpu_torch.models.formats import decode_dense

    x = rng.standard_normal((64, 96)).astype(np.float32)
    buf_native, buf_jax = io.BytesIO(), io.BytesIO()
    write_tensor(buf_native, x, ft)
    jax_write_tensor(buf_jax, x, JaxFloatType(int(ft)))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)  # the numpy path
    assert not native.available()
    buf_np = io.BytesIO()
    write_tensor(buf_np, x, ft)
    assert buf_native.getvalue() == buf_np.getvalue() == buf_jax.getvalue()
    raw = np.frombuffer(buf_native.getvalue(), np.uint8)
    back = decode_dense(raw, x.shape, ft)
    np.testing.assert_allclose(back, x, atol=np.abs(x).max() / (4 if ft == FloatType.Q40 else 64))


def test_dllama_native_0_gives_the_fallback(monkeypatch):
    monkeypatch.setenv("DLLAMA_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    t = _mk_tokenizer(Tokenizer, True)
    assert t.encode("hello world", add_bos=False) == [259, 32, 119, 111, 114, 262]
    assert t._native is None and t._native_tried


def test_dllama_native_lib_names_the_library(monkeypatch, tmp_path):
    copy = tmp_path / "libcopy.so"
    copy.write_bytes(native.library_path().read_bytes())
    monkeypatch.setenv("DLLAMA_NATIVE_LIB", str(copy))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available() and native._lib._name == str(copy)
    x = np.linspace(-1, 1, 64, dtype=np.float32)
    _equal(native.quantize_q40(x), quantize_q40_np(x))
    # a library that does not load leaves the fallback
    monkeypatch.setenv("DLLAMA_NATIVE_LIB", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
