"""The port's converters (``dllama_tpu_torch/tools/``) against the JAX
package's, case by case as ``tests/test_converters.py`` runs them: the same
synthetic HF safetensors, Meta ``consolidated.*.pth`` shards and tokenizer
inputs go through both packages' converters, and the `.m` and `.t` files
must be byte-equal. Also: the port's own safetensors reader (it does not use
the ``safetensors`` package) against ``safetensors.safe_open``, a BF16
checkpoint, a Mixtral-style MoE checkpoint, the config mapping's errors, and
a converted tiny model whose greedy ids equal the JAX engine's on the JAX
package's conversion of the same checkpoint."""

import base64
import json
import struct

import numpy as np
import pytest
import torch

from dllama_tpu_torch.models import formats
from dllama_tpu_torch.ops.quant import FloatType
from dllama_tpu_torch.tokenizer.tokenizer import Tokenizer
from dllama_tpu_torch.tools import convert_tokenizer
from dllama_tpu_torch.tools.convert_hf import SafetensorsDir, SafetensorsFile, convert_hf
from dllama_tpu_torch.tools.convert_hf import main as convert_hf_main
from dllama_tpu_torch.tools.convert_llama import convert_llama
from dllama_tpu_torch.tools.converter_core import hf_config_to_llama, hf_tensor_for, permute_rope
from tests.test_converters import (
    DIM,
    HEADS,
    HIDDEN,
    KV,
    LAYERS,
    SEQ,
    VOCAB,
    tiny_hf_config,
    tiny_hf_tensors,
    write_hf_checkpoint,
)

torch.set_num_threads(1)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _jax_convert_hf(model_dir, wt, out, max_seq_len=None):
    from dllama_tpu.tools.convert_hf import convert_hf as jax_convert_hf

    jax_convert_hf(model_dir, wt, out, max_seq_len)
    return _bytes(out)


# ------------------------------------------------------------------ hf


@pytest.mark.parametrize("wt", ["f32", "q40"])
@pytest.mark.parametrize("sharded", [False, True])
def test_convert_hf_bytes_equal_jax(tmp_path, rng, sharded, wt):
    tensors = tiny_hf_tensors(rng)
    model_dir = write_hf_checkpoint(tmp_path, tensors, sharded=sharded)
    out = str(tmp_path / "model.m")
    convert_hf(model_dir, wt, out)
    assert _bytes(out) == _jax_convert_hf(model_dir, wt, str(tmp_path / "jax.m"))

    cfg, header_size = formats.read_header(out)
    assert (cfg.dim, cfg.n_layers, cfg.vocab_size) == (DIM, LAYERS, VOCAB)
    if wt == "f32":
        for name, shape, ft, raw in formats.iter_tensors(out, cfg, header_size):
            got = formats.decode_dense(raw, shape, ft)
            want = hf_tensor_for(name, cfg, lambda k: tensors[k])
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_convert_hf_tied_embeddings(tmp_path, rng):
    tensors = tiny_hf_tensors(rng)
    del tensors["lm_head.weight"]  # tied: wcls falls back to embed_tokens
    model_dir = write_hf_checkpoint(tmp_path, tensors)
    out = str(tmp_path / "tied.m")
    convert_hf(model_dir, "f32", out)
    assert _bytes(out) == _jax_convert_hf(model_dir, "f32", str(tmp_path / "jax.m"))
    cfg, header_size = formats.read_header(out)
    for name, shape, ft, raw in formats.iter_tensors(out, cfg, header_size):
        if name == "wcls":
            np.testing.assert_array_equal(
                formats.decode_dense(raw, shape, ft), tensors["model.embed_tokens.weight"])


def test_permute_rope_matches_rotate_half_semantics(rng):
    from dllama_tpu.tools.converter_core import permute_rope as jax_permute_rope

    hd = DIM // HEADS
    eye = np.eye(DIM, dtype=np.float32)
    p = permute_rope(eye, HEADS)
    for h in range(HEADS):
        for i in range(hd // 2):
            np.testing.assert_array_equal(p[h * hd + 2 * i], eye[h * hd + i])
            np.testing.assert_array_equal(p[h * hd + 2 * i + 1], eye[h * hd + hd // 2 + i])
    w = rng.standard_normal((DIM * KV // HEADS, DIM)).astype(np.float32)
    np.testing.assert_array_equal(permute_rope(w, KV), jax_permute_rope(w, KV))


def test_convert_hf_cli_with_max_seq_len(tmp_path, rng, capsys):
    from dllama_tpu.tools.convert_hf import main as jax_main

    model_dir = write_hf_checkpoint(tmp_path, tiny_hf_tensors(rng))
    out, jout = str(tmp_path / "cli.m"), str(tmp_path / "jcli.m")
    assert convert_hf_main([model_dir, "q80", "--output", out, "--max-seq-len", "16"]) == 0
    assert jax_main([model_dir, "q80", "--output", jout, "--max-seq-len", "16"]) == 0
    assert _bytes(out) == _bytes(jout)
    assert "Created" in capsys.readouterr().out


def _mixtral(tmp_path, rng, n_experts=4):
    cfg = dict(tiny_hf_config(), model_type="mixtral", num_local_experts=n_experts,
               num_experts_per_tok=2)
    kv_dim = DIM * KV // HEADS
    t = {"model.embed_tokens.weight": rng.standard_normal((VOCAB, DIM)),
         "model.norm.weight": rng.standard_normal((DIM,)),
         "lm_head.weight": rng.standard_normal((VOCAB, DIM))}
    for li in range(LAYERS):
        p = f"model.layers.{li}."
        t[p + "self_attn.q_proj.weight"] = rng.standard_normal((DIM, DIM))
        t[p + "self_attn.k_proj.weight"] = rng.standard_normal((kv_dim, DIM))
        t[p + "self_attn.v_proj.weight"] = rng.standard_normal((kv_dim, DIM))
        t[p + "self_attn.o_proj.weight"] = rng.standard_normal((DIM, DIM))
        t[p + "block_sparse_moe.gate.weight"] = rng.standard_normal((n_experts, DIM))
        for e in range(n_experts):
            q = f"{p}block_sparse_moe.experts.{e}."
            t[q + "w1.weight"] = rng.standard_normal((HIDDEN, DIM))
            t[q + "w2.weight"] = rng.standard_normal((DIM, HIDDEN))
            t[q + "w3.weight"] = rng.standard_normal((HIDDEN, DIM))
        t[p + "input_layernorm.weight"] = rng.standard_normal((DIM,))
        t[p + "post_attention_layernorm.weight"] = rng.standard_normal((DIM,))
    model_dir = write_hf_checkpoint(tmp_path, {k: v.astype(np.float32) for k, v in t.items()},
                                    sharded=True)
    with open(f"{model_dir}/config.json", "w") as f:
        json.dump(cfg, f)
    return model_dir


def test_convert_hf_mixtral_moe(tmp_path, rng):
    model_dir = _mixtral(tmp_path, rng)
    out = str(tmp_path / "moe.m")
    convert_hf(model_dir, "q40", out)
    assert _bytes(out) == _jax_convert_hf(model_dir, "q40", str(tmp_path / "jax.m"))
    cfg, _ = formats.read_header(out)
    assert (cfg.n_experts, cfg.n_active_experts) == (4, 2)


def _llama31_config():
    return dict(tiny_hf_config(), rope_theta=500000.0, max_position_embeddings=131072,
                rope_scaling={"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                              "original_max_position_embeddings": 8192,
                              "rope_type": "llama3"})


@pytest.mark.parametrize("variant", ["llama2", "llama3.1", "mixtral", "mistral-gelu"])
def test_hf_config_to_llama_equals_jax(variant):
    import dataclasses

    from dllama_tpu.ops.quant import FloatType as JaxFloatType
    from dllama_tpu.tools.converter_core import hf_config_to_llama as jax_map

    hf = {"llama2": tiny_hf_config(), "llama3.1": _llama31_config(),
          "mixtral": dict(tiny_hf_config(), model_type="mixtral", num_local_experts=8,
                          num_experts_per_tok=2),
          "mistral-gelu": dict(tiny_hf_config(), model_type="mistral", hidden_act="gelu",
                               rope_theta=None)}[variant]
    got = hf_config_to_llama(hf, FloatType.Q40)
    want = jax_map(hf, JaxFloatType.Q40)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        assert (a.name, int(a)) == (b.name, int(b)) if hasattr(b, "name") else a == b, field.name


@pytest.mark.parametrize("bad", [{"model_type": "gpt2"}, {"hidden_act": "relu"},
                                 {"rope_scaling": {"type": "linear", "factor": 2.0}}])
def test_hf_config_errors_equal_jax(bad):
    from dllama_tpu.ops.quant import FloatType as JaxFloatType
    from dllama_tpu.tools.converter_core import hf_config_to_llama as jax_map

    hf = dict(tiny_hf_config(), **bad)
    with pytest.raises(ValueError) as got:
        hf_config_to_llama(hf, FloatType.F32)
    with pytest.raises(ValueError) as want:
        jax_map(hf, JaxFloatType.F32)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------ safetensors


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_safetensors_reader_equals_safe_open(tmp_path, rng, dtype):
    from safetensors import safe_open
    from safetensors.torch import save_file

    tdt = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[dtype]
    tensors = {"a.weight": torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal((7,)).astype(np.float32)),
               "c.scalar": torch.tensor(1.5), "empty": torch.zeros((0, 3))}
    tensors = {k: v.to(tdt) for k, v in tensors.items()}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    mine = SafetensorsFile(path)
    assert sorted(mine.keys()) == sorted(tensors)
    with safe_open(path, framework="pt") as f:
        for name in f.keys():
            want = f.get_tensor(name).float().numpy()
            got = mine.get(name)
            assert got.dtype == np.float32 and got.shape == want.shape, name
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=name)
    if dtype != "BF16":  # numpy has no bfloat16: safe_open(framework="np") cannot read it
        with safe_open(path, framework="np") as f:
            for name in f.keys():
                np.testing.assert_array_equal(mine.get(name), f.get_tensor(name).astype(np.float32))


def test_safetensors_dir_single_file_and_index(tmp_path, rng):
    tensors = tiny_hf_tensors(rng)
    for sharded in (False, True):
        d = tmp_path / ("sharded" if sharded else "single")
        d.mkdir()
        src = SafetensorsDir(write_hf_checkpoint(d, tensors, sharded=sharded))
        assert set(src.weight_map) == set(tensors) and "model.norm.weight" in src
        for name in sorted(tensors):
            np.testing.assert_array_equal(src.get(name), tensors[name])
        with pytest.raises(KeyError):
            src.get("missing")
        src.close()


def test_convert_hf_bf16_checkpoint(tmp_path, rng):
    """A BF16 checkpoint converts to the bytes the JAX converter writes from
    the same values stored as F32 (its safetensors numpy path cannot read
    BF16)."""
    from safetensors.torch import save_file

    tensors = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in tiny_hf_tensors(rng).items()}
    bf = tmp_path / "bf16"
    bf.mkdir()
    save_file(tensors, str(bf / "model.safetensors"))
    with open(bf / "config.json", "w") as f:
        json.dump(_llama31_config(), f)
    out = str(tmp_path / "bf16.m")
    convert_hf(str(bf), "q40", out)
    widened = {k: v.float().numpy() for k, v in tensors.items()}
    f32_dir = write_hf_checkpoint(tmp_path, widened)
    with open(f"{f32_dir}/config.json", "w") as f:
        json.dump(_llama31_config(), f)
    assert _bytes(out) == _jax_convert_hf(f32_dir, "q40", str(tmp_path / "jax.m"))


def test_converted_model_reproduces_jax_greedy_ids(tmp_path, rng):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.engine.sampling import Sampler as JaxSampler
    from dllama_tpu.models import formats as jf
    from dllama_tpu_torch.engine.engine import InferenceEngine
    from dllama_tpu_torch.engine.sampling import Sampler

    tensors = {k: (v * 0.3).astype(np.float32) for k, v in tiny_hf_tensors(rng).items()}
    for k in tensors:
        if "norm" in k:
            tensors[k] = np.ones_like(tensors[k])
    model_dir = write_hf_checkpoint(tmp_path, tensors, sharded=True)
    out, jout = str(tmp_path / "port.m"), str(tmp_path / "jax.m")
    convert_hf(model_dir, "f32", out)  # dim 16 is below one Q40 block
    _jax_convert_hf(model_dir, "f32", jout)
    prompt = [1, 7, 22, 5, 40]
    jcfg, jhs = jf.read_header(jout)
    jeng = JaxEngine(jcfg, jf.load_params(jout, jcfg, jhs), cache_dtype=jnp.float32)
    want = list(jeng.generate(prompt, 12, JaxSampler(0.0, 0.9, 1)))
    cfg, hs = formats.read_header(out)
    eng = InferenceEngine(cfg, formats.load_params(out, cfg, hs), cache_dtype=torch.float32)
    got = list(eng.generate(prompt, 12, Sampler(0.0, 0.9, 1)))
    assert got == want and len(set(got)) > 1


# ------------------------------------------------------------------ meta


def _meta_checkpoint(tmp_path, rng):
    kv_dim = DIM * KV // HEADS
    full = {
        "tok_embeddings.weight": rng.standard_normal((VOCAB, DIM)),
        "norm.weight": rng.standard_normal((DIM,)),
        "output.weight": rng.standard_normal((VOCAB, DIM)),
    }
    for li in range(LAYERS):
        p = f"layers.{li}."
        full[p + "attention.wq.weight"] = rng.standard_normal((DIM, DIM))
        full[p + "attention.wk.weight"] = rng.standard_normal((kv_dim, DIM))
        full[p + "attention.wv.weight"] = rng.standard_normal((kv_dim, DIM))
        full[p + "attention.wo.weight"] = rng.standard_normal((DIM, DIM))
        full[p + "feed_forward.w1.weight"] = rng.standard_normal((HIDDEN, DIM))
        full[p + "feed_forward.w2.weight"] = rng.standard_normal((DIM, HIDDEN))
        full[p + "feed_forward.w3.weight"] = rng.standard_normal((HIDDEN, DIM))
        full[p + "attention_norm.weight"] = rng.standard_normal((DIM,))
        full[p + "ffn_norm.weight"] = rng.standard_normal((DIM,))
    full = {k: v.astype(np.float32) for k, v in full.items()}
    # 2 megatron-style shards: wo/w2/embeddings on dim 1, the rest on dim 0
    model_dir = tmp_path / "meta_model"
    model_dir.mkdir()
    axis1 = ("tok_embeddings.weight", "attention.wo.weight", "feed_forward.w2.weight")
    for s in range(2):
        shard = {}
        for k, v in full.items():
            if v.ndim == 1:
                shard[k] = torch.tensor(v)
            else:
                ax = 1 if any(k == a or k.endswith(a) for a in axis1) else 0
                shard[k] = torch.tensor(np.split(v, 2, axis=ax)[s])
        torch.save(shard, str(model_dir / f"consolidated.0{s}.pth"))
    with open(model_dir / "params.json", "w") as f:
        json.dump({"dim": DIM, "n_layers": LAYERS, "n_heads": HEADS, "n_kv_heads": KV,
                   "vocab_size": VOCAB, "max_seq_len": SEQ, "norm_eps": 1e-5,
                   "rope_theta": 500000.0, "use_scaled_rope": True}, f)
    return model_dir, full


@pytest.mark.parametrize("wt", ["f32", "q40"])
def test_convert_llama_meta_shards(tmp_path, rng, wt):
    from dllama_tpu.tools.convert_llama import convert_llama as jax_convert_llama

    model_dir, full = _meta_checkpoint(tmp_path, rng)
    out, jout = str(tmp_path / "meta.m"), str(tmp_path / "jmeta.m")
    convert_llama(str(model_dir), wt, out)
    jax_convert_llama(str(model_dir), wt, jout)
    assert _bytes(out) == _bytes(jout)
    cfg, header_size = formats.read_header(out)
    assert cfg.hidden_dim == HIDDEN  # derived from w1 shard rows * n_shards
    assert cfg.rope_scaling_factor == 8.0  # use_scaled_rope: Llama 3.1's defaults
    if wt == "q40":
        return
    name_map = {
        "embedding": "tok_embeddings.weight", "final_norm": "norm.weight", "wcls": "output.weight",
        "wq": "attention.wq.weight", "wk": "attention.wk.weight", "wv": "attention.wv.weight",
        "wo": "attention.wo.weight", "w1": "feed_forward.w1.weight",
        "w2": "feed_forward.w2.weight", "w3": "feed_forward.w3.weight",
        "rms_att": "attention_norm.weight", "rms_ffn": "ffn_norm.weight",
    }
    for name, shape, ft, raw in formats.iter_tensors(out, cfg, header_size):
        parts = name.split(".")
        key = (f"layers.{parts[1]}." + name_map[parts[2]]) if len(parts) == 3 else name_map[name]
        np.testing.assert_array_equal(formats.decode_dense(raw, shape, ft), full[key], err_msg=name)


# ------------------------------------------------------------------ tokenizers


def _saved_equal(tmp_path, tok, jtok) -> None:
    """Both tokenizers' `.t` files byte-equal."""
    a, b = str(tmp_path / "port.t"), str(tmp_path / "jax.t")
    tok.save(a)
    jtok.save(b)
    assert _bytes(a) == _bytes(b)


def _hf_tok_dir(tmp_path):
    enc = {b: c for c, b in convert_tokenizer.byte_decoder().items()}
    base = [enc[b] for b in range(256)]
    merges = [f"{enc[ord('h')]} {enc[ord('i')]}"]  # "hi" merge
    vocab = {tok: i for i, tok in enumerate(base)}
    vocab[enc[ord("h")] + enc[ord("i")]] = len(vocab)
    bos, eos = len(vocab), len(vocab) + 1
    tok_json = {
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
        "added_tokens": [{"id": bos, "content": "<s>"}, {"id": eos, "content": "</s>"}],
    }
    d = tmp_path / "hftok"
    d.mkdir()
    with open(d / "tokenizer.json", "w") as f:
        json.dump(tok_json, f)
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "chat_template": "T"}, f)
    return d, vocab, enc, bos, eos


def test_convert_hf_tokenizer(tmp_path):
    from dllama_tpu.tools import convert_tokenizer as jct

    d, vocab, enc, bos, eos = _hf_tok_dir(tmp_path)
    tok = convert_tokenizer.convert_hf_tokenizer(str(d))
    assert tok.bos_id == bos and tok.eos_ids == [eos]
    hi = vocab[enc[ord("h")] + enc[ord("i")]]
    assert tok.vocab[hi] == b"hi" and tok.encode("hi", add_bos=False) == [hi]
    _saved_equal(tmp_path, tok, jct.convert_hf_tokenizer(str(d)))
    tok2 = Tokenizer.load(str(tmp_path / "port.t"))
    assert tok2.vocab == tok.vocab and tok2.chat_template == "T"


def test_convert_hf_tokenizer_list_eos(tmp_path):
    from dllama_tpu.tools import convert_tokenizer as jct

    enc = {b: c for c, b in convert_tokenizer.byte_decoder().items()}
    vocab = {enc[b]: b for b in range(256)}
    bos, e0, e1 = 256, 257, 258
    tok_json = {
        "model": {"type": "BPE", "vocab": vocab, "merges": []},
        "added_tokens": [{"id": bos, "content": "<bot>"}, {"id": e0, "content": "<eot0>"},
                         {"id": e1, "content": "<eot1>"}],
    }
    d = tmp_path / "hftok31"
    d.mkdir()
    with open(d / "tokenizer.json", "w") as f:
        json.dump(tok_json, f)
    with open(d / "config.json", "w") as f:
        json.dump({"bos_token_id": bos, "eos_token_id": [e0, e1]}, f)
    tok = convert_tokenizer.convert_hf_tokenizer(str(d))
    assert tok.bos_id == bos and tok.eos_ids == [e0, e1]
    _saved_equal(tmp_path, tok, jct.convert_hf_tokenizer(str(d)))
    assert Tokenizer.load(str(tmp_path / "port.t")).eos_ids == [e0, e1]


def _sp_model(tmp_path):
    # a hand-encoded sentencepiece ModelProto: repeated field 1, each message
    # {1: piece bytes, 2: float score, 3: varint type}
    def sp_piece(piece: bytes, score: float, ptype: int = 1) -> bytes:
        body = bytes([0x0A, len(piece)]) + piece
        body += b"\x15" + struct.pack("<f", score)
        body += bytes([0x18, ptype])
        return bytes([0x0A, len(body)]) + body

    pieces = [(b"<unk>", 0.0, 2), (b"<s>", 0.0, 3), (b"</s>", 0.0, 3),
              ("▁hello".encode(), -1.5, 1), (b"x", -2.25, 1),
              (b"<0x0A>", -3.0, 6), (b"<0x68>", -3.5, 6)]
    blob = b"".join(sp_piece(p, s, t) for p, s, t in pieces)
    blob += bytes([0x12, 3]) + b"abc"  # a trailing unknown field (trainer_spec)
    d = tmp_path / "sptok"
    d.mkdir()
    with open(d / "tokenizer.model", "wb") as f:
        f.write(blob)
    return d


def test_parse_sentencepiece_model(tmp_path):
    from dllama_tpu.tools import convert_tokenizer as jct

    d = _sp_model(tmp_path)
    parsed = convert_tokenizer.parse_sentencepiece_model(str(d / "tokenizer.model"))
    assert parsed == jct.parse_sentencepiece_model(str(d / "tokenizer.model"))
    assert [p for p, _, _ in parsed] == ["<unk>", "<s>", "</s>", "▁hello", "x", "<0x0A>",
                                         "<0x68>"]
    tok = convert_tokenizer.convert_llama2_tokenizer(str(d))
    assert tok.vocab[3] == b" hello" and tok.bos_id == 1
    assert tok.vocab[5] == b"\n" and tok.vocab[6] == b"h"
    assert tok.encode("h\n", add_bos=False) == [6, 5]
    assert tok.regular_vocab_size == len(tok.vocab) - 3
    _saved_equal(tmp_path, tok, jct.convert_llama2_tokenizer(str(d)))


def test_convert_llama3_tokenizer(tmp_path):
    from dllama_tpu.tools import convert_tokenizer as jct

    lines = [f"{base64.b64encode(bytes([i])).decode()} {i}" for i in range(64)]
    path = tmp_path / "tokenizer.model"
    path.write_text("\n".join(lines) + "\n")
    tok = convert_tokenizer.convert_llama3_tokenizer(str(path))
    assert len(tok.vocab) == 64 + 256
    assert tok.bos_id == 64 and tok.vocab[64] == b"<|begin_of_text|>"
    assert tok.eos_ids == [65, 64 + 9] and tok.vocab[73] == b"<|eot_id|>"
    assert tok.regular_vocab_size == 64
    _saved_equal(tmp_path, tok, jct.convert_llama3_tokenizer(str(path)))


def test_convert_tokenizer_cli(tmp_path, monkeypatch):
    from dllama_tpu.tools import convert_tokenizer as jct

    lines = [f"{base64.b64encode(bytes([i])).decode()} {i}" for i in range(16)]
    model = tmp_path / "tokenizer.model"
    model.write_text("\n".join(lines) + "\n")
    monkeypatch.chdir(tmp_path)
    assert convert_tokenizer.main(["llama3", str(model), "--name", "test"]) == 0
    assert jct.main(["llama3", str(model), "--output", "jax.t"]) == 0
    assert _bytes(tmp_path / "dllama_tokenizer_test.t") == _bytes(tmp_path / "jax.t")
    assert len(Tokenizer.load(str(tmp_path / "dllama_tokenizer_test.t")).vocab) == 16 + 256


def test_convert_hf_tokenizer_metaspace_style(tmp_path):
    from dllama_tpu.tools import convert_tokenizer as jct

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "<0x0A>": 3, "h": 4, "i": 5,
             "▁": 6, "hi": 7, "▁hi": 8}
    tok_json = {
        "model": {"type": "BPE", "vocab": vocab, "merges": ["h i", "▁ hi"]},
        "pre_tokenizer": {"type": "Metaspace"},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace"}, {"type": "ByteFallback"}]},
        "added_tokens": [{"id": 0, "content": "<unk>"}, {"id": 1, "content": "<s>"},
                         {"id": 2, "content": "</s>"}],
    }
    d = tmp_path / "mstok"
    d.mkdir()
    with open(d / "tokenizer.json", "w") as f:
        json.dump(tok_json, f)
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>"}, f)
    tok = convert_tokenizer.convert_hf_tokenizer(str(d))
    assert tok.bos_id == 1 and tok.eos_ids == [2]
    assert tok.vocab[6] == b" " and tok.vocab[8] == b" hi" and tok.vocab[3] == b"\n"
    assert tok.regular_vocab_size == len(tok.vocab) - 3
    assert tok.encode(" hi", add_bos=False) == [8]
    assert tok.encode("hi\n", add_bos=False) == [7, 3]
    _saved_equal(tmp_path, tok, jct.convert_hf_tokenizer(str(d)))


# ------------------------------------------------------------------ helpers


def test_quant_helpers_equal_jax(rng):
    from dllama_tpu.ops import quant as jq
    from dllama_tpu_torch.ops import quant

    for name in ("q40", "Q80", "f16", "f32", "bf16"):
        assert int(quant.parse_float_type(name)) == int(jq.parse_float_type(name))
    with pytest.raises(ValueError, match="unsupported float type"):
        quant.parse_float_type("q41")
    x = rng.standard_normal((6, 64)).astype(np.float32)
    packed, scales = quant.quantize_q40_np(x)
    assert quant.q40_to_bytes(packed, scales) == jq.q40_to_bytes(packed, scales)
    back = quant.q40_from_bytes(quant.q40_to_bytes(packed, scales), x.size)
    want = jq.q40_from_bytes(jq.q40_to_bytes(packed, scales), x.size)
    for a, b in zip(back, want):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    codes, scales = quant.quantize_q80_np(x)
    assert quant.q80_to_bytes(codes, scales) == jq.q80_to_bytes(codes, scales)
    for a, b in zip(quant.q80_from_bytes(quant.q80_to_bytes(codes, scales), x.size),
                    jq.q80_from_bytes(jq.q80_to_bytes(codes, scales), x.size)):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    w = rng.standard_normal((64, 48)).astype(np.float32)
    got, ref = quant.QTensor.quantize(w), jq.QTensor.quantize(w)
    assert got.packed.device.type == "cpu" and got.shape == (64, 48)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(got.scales.numpy().view(np.uint16),
                                  np.asarray(ref.scales).view(np.uint16))


def test_smoke_tokenizer_converts_like_jax(tmp_path):
    """chip_smoke's HF tokenizer (BPE pieces learned from the repository's
    text, the Llama-3 specials) through both packages' `hf` converters:
    equal `.t` bytes, and the text merges to the same ids in both."""
    import chip_smoke
    from dllama_tpu.tokenizer.tokenizer import Tokenizer as JaxTokenizer
    from dllama_tpu.tools import convert_tokenizer as jct

    text = chip_smoke.repo_text()[:40_000]
    merged = chip_smoke.learn_bpe(text, 600)
    assert len(merged) == 600 and len({a + b for a, b in merged}) == 600
    chip_smoke.write_hf_tokenizer(str(tmp_path), merged, 1280)
    tok = convert_tokenizer.convert_hf_tokenizer(str(tmp_path))
    _saved_equal(tmp_path, tok, jct.convert_hf_tokenizer(str(tmp_path)))
    assert (len(tok.vocab), tok.bos_id, tok.eos_ids) == (1280, 1024, [1025, 1033])
    assert tok.vocab[256:262] == [a + b for a, b in merged[:6]]
    sample = text[:3000].decode("utf-8", "ignore")
    ids = tok.encode(sample)
    assert len(ids) < 0.6 * len(sample.encode())  # the pieces merge
    assert ids == JaxTokenizer.load(str(tmp_path / "jax.t")).encode(sample)


def test_smoke_checkpoint_converts_to_its_codes(tmp_path):
    """chip_smoke's BF16 checkpoint recipe: every 32-wide input block of a
    projection holds a code -8, so convert_hf's Q40 blocks take the block's
    own scale and codes (the dequantized weight is the BF16 one to its
    rounding), as write_model's network is."""
    import chip_smoke

    hf = dict(chip_smoke.llama31_8b_hf_config(2), hidden_size=64, intermediate_size=128,
              num_attention_heads=2, num_key_value_heads=1, vocab_size=300)
    chip_smoke.write_hf_checkpoint(str(tmp_path), hf, torch.device("cpu"))
    names = {p.name for p in tmp_path.iterdir()}
    assert {"model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors",
            "model.safetensors.index.json", "config.json"} <= names
    out = str(tmp_path / "m.m")
    convert_hf(str(tmp_path), "q40", out)
    cfg, hs = formats.read_header(out)
    assert (cfg.dim, cfg.n_layers, cfg.rope_scaling_factor) == (64, 2, 8.0)
    src = SafetensorsDir(str(tmp_path))
    for name, shape, ft, raw in formats.iter_tensors(out, cfg, hs):
        want = hf_tensor_for(name, cfg, src.get)
        got = formats.decode_dense(raw, shape, ft)
        if ft == FloatType.Q40:
            rec = np.asarray(raw).reshape(-1, 18)
            low = np.minimum(rec[:, 2:] & 15, rec[:, 2:] >> 4).min(axis=1)
            assert (low == 0).all(), name  # a code -8 in every block
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
