"""Prompt-lookup speculative decoding in the port (engine/speculative.py,
InferenceEngine.decode_spec_greedy_n / generate(spec=K), --spec) against the
JAX package, on the committed golden `.m` with an f32 cache. The invariant
is exactness: speculation emits the plain greedy continuation, in fewer
forwards where the text repeats.

* propose_ngram equals JAX's bit for bit (draft and found) on random and
  repetitive histories with unknown (-1) regions;
* decode_spec_greedy_n gives the JAX engine's ids and {emitted, cycles},
  and the ids of plain greedy decoding;
* the seq_len boundary, position accounting, the delta history of a chat
  turn, generate(spec=4), the CLI and the single-engine server with --spec
  and per-request spec_k; --spec with --slots is refused.
"""

import contextlib
import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.sampling import Sampler
from dllama_tpu_torch.engine.speculative import propose_ngram
from dllama_tpu_torch.models import formats
from tests.test_golden import FIXTURE_M, GOLDEN_CONTINUATION, GOLDEN_PROMPT

torch.set_num_threads(1)

REPETITIVE = ([3, 7, 11, 19] * 8)[:30]
RANDOM = [int(t) for t in np.random.default_rng(0).integers(1, 1057, 30)]


@pytest.fixture(scope="module")
def model():
    cfg, hs = formats.read_header(FIXTURE_M)
    return cfg, formats.load_params(FIXTURE_M, cfg, hs)


def _engine(model):
    return InferenceEngine(*model, cache_dtype=torch.float32)


def _prefill(eng, prompt) -> int:
    return int(torch.argmax(eng.prefill(np.asarray([prompt]))[0]))


def _greedy(model, prompt, n):
    eng = _engine(model)
    first = _prefill(eng, prompt)
    return first, [int(t) for t in eng.decode_greedy_n(np.array([[first]]), n)[:, 0]]


def _spec(model, prompt, n, k=6):
    eng = _engine(model)
    first = _prefill(eng, prompt)
    return first, [int(t) for t in eng.decode_spec_greedy_n(prompt, first, n, k=k)], eng


def test_propose_ngram_bit_exact_with_jax():
    import jax.numpy as jnp

    from dllama_tpu.engine.speculative import propose_ngram as jax_propose

    rng = np.random.default_rng(3)
    cases = []
    for _ in range(12):  # random histories, some with a -1 (unknown) prefix
        h = rng.integers(0, 6, 40)
        h[: rng.integers(0, 12)] = -1
        cases.append((h, int(rng.integers(1, 40)), int(rng.integers(1, 6)), int(rng.integers(1, 4))))
    rep = np.array(([-1] * 5) + [4, 9, 2] * 9 + [-1] * 8)
    cases += [(rep, 25, 4, 2), (rep, 32, 6, 3), (rep, 6, 3, 2), (rep, 1, 2, 1),
              (np.arange(16), 12, 4, 2), (np.array([9, 4, 7, 1, 2, 4, 7, 3, 5, 4, 7, 0, 0, 0, 0, 0]),
                                          11, 3, 2)]
    for h, length, k, ngram in cases:
        want, wfound = jax_propose(jnp.asarray(h, jnp.int32), jnp.int32(length), k, ngram)
        got, found = propose_ngram(torch.as_tensor(h, dtype=torch.int64), length, k, ngram)
        assert got.tolist() == np.asarray(want).tolist(), (h, length, k, ngram)
        assert bool(found) == bool(wfound)
    draft, found = propose_ngram(torch.as_tensor(cases[-1][0]), 11, 3, 2)
    assert bool(found) and draft.tolist() == [3, 5, 4]  # the LATEST match wins


def test_spec_matches_jax_engine_and_plain_greedy(model):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.models import formats as jf

    jcfg, jhs = jf.read_header(FIXTURE_M)
    jeng = JaxEngine(jcfg, jf.load_params(FIXTURE_M, jcfg, jhs), cache_dtype=jnp.float32)
    saved = []
    for prompt in (REPETITIVE, RANDOM, [5, 9] * 4):
        jeng.reset(0)
        jfirst = int(np.argmax(np.asarray(jeng.prefill(np.asarray([prompt], np.int32)))[0]))
        want = [int(t) for t in jeng.decode_spec_greedy_n(list(prompt), jfirst, 24, k=6)]
        first, got, eng = _spec(model, prompt, 24)
        assert first == jfirst and got == want
        assert eng._spec_stats == jeng._spec_stats, (prompt, eng._spec_stats, jeng._spec_stats)
        assert eng.pos == jeng.pos == len(prompt) + 24
        assert _greedy(model, prompt, 24) == (first, got)
        cyc, emitted = eng._spec_stats["cycles"], eng._spec_stats["emitted"]
        assert 1 <= cyc <= emitted <= 7 * cyc  # every cycle emits 1..k+1 tokens
        saved.append(emitted - cyc)
    assert max(saved) > 0  # drafts were accepted: fewer forwards than tokens


def test_spec_position_accounting_allows_continuation(model):
    prompt = ([2, 4, 8] * 6)[:16]
    _, ref = _greedy(model, prompt, 30)
    _, got, eng = _spec(model, prompt, 18, k=4)
    assert got == ref[:18] and eng.pos == len(prompt) + 18
    more = eng.decode_greedy_n(np.array([[got[-1]]]), 12)
    assert [int(t) for t in more[:, 0]] == ref[18:30]


def test_spec_respects_seq_len_boundary(model):
    """Near the end of the context the decoder stops early (a (k+1)-row
    window no longer fits) and returns what it could emit."""
    prompt = [1, 2, 3] * 10
    eng = _engine(model)
    first = _prefill(eng, prompt)
    room = eng.seq_len - eng.pos
    toks = eng.decode_spec_greedy_n(prompt, first, room - 2, k=8)
    assert eng.pos <= eng.seq_len and len(toks) <= room - 2
    assert eng.pos == len(prompt) + len(toks)
    _, ref = _greedy(model, prompt, len(toks))
    assert [int(t) for t in toks] == ref


def test_spec_delta_history_multi_turn(model):
    """A chat turn prefills only its delta and hands spec only the delta
    (earlier positions unknown): the same stream as plain greedy."""

    def turn(eng, toks, n, spec):
        first = _prefill(eng, toks)
        if spec:
            return [first] + [int(t) for t in eng.decode_spec_greedy_n(toks, first, n, k=4)]
        return [first] + [int(t) for t in eng.decode_greedy_n(np.array([[first]]), n)[:, 0]]

    eng_s, eng_r = _engine(model), _engine(model)
    for toks in ([3, 7, 11] * 4, [5, 9, 5, 9]):
        assert turn(eng_s, toks, 8, True) == turn(eng_r, toks, 8, False)
    assert eng_s.pos == eng_r.pos
    with pytest.raises(ValueError, match="history length"):
        eng_s.decode_spec_greedy_n(list(range(eng_s.pos + 1)), 1, 2)


def test_generate_spec_equals_golden_continuation(model):
    eng = _engine(model)
    assert list(eng.generate(GOLDEN_PROMPT, 16, Sampler(0.0, 0.9, 1), chunk=8,
                             spec=4)) == GOLDEN_CONTINUATION
    assert eng._spec_stats is not None and eng.pos == len(GOLDEN_PROMPT) + 15
    # the chunked loop over a repetitive prompt, stop and rewind included
    eng.reset(0)
    want = list(eng.generate(REPETITIVE, 33, Sampler(0.0, 0.9, 1), chunk=8))
    eng.reset(0)
    assert list(eng.generate(REPETITIVE, 33, Sampler(0.0, 0.9, 1), chunk=8, spec=6)) == want
    eng.reset(0)
    stop = want[10]
    got = list(eng.generate(REPETITIVE, 33, Sampler(0.0, 0.9, 1), stop_fn=lambda t: t == stop,
                            chunk=8, spec=6))
    assert got == want[: want.index(stop) + 1]
    assert eng.pos == len(REPETITIVE) + want.index(stop)


def test_cli_inference_spec_equals_spec_0(tmp_path):
    from dllama_tpu_torch.cli.main import main
    from tests.test_torch_isolation import _tokenizer

    tpath = _tokenizer(tmp_path)

    def run(spec):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["inference", "--model", FIXTURE_M, "--tokenizer", tpath, "--prompt",
                       "abcabcabcabc", "--steps", "24", "--device", "cpu", "--temperature",
                       "0", "--spec", str(spec)])
        assert rc == 0, err.getvalue()
        return out.getvalue()

    assert run(4) == run(0)
    assert main(["serve", "--model", FIXTURE_M, "--tokenizer", tpath, "--device", "cpu",
                 "--slots", "2", "--spec", "4"]) == 2


def test_serve_spec_and_per_request_spec_k(tmp_path):
    from dllama_tpu.tools.convert_tokenizer import convert_llama3_tokenizer
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve.api import make_server
    from tests.golden_fixture import write_tiktoken_file

    write_tiktoken_file(str(tmp_path / "tokenizer.model"))
    tpath = str(tmp_path / "golden.t")
    convert_llama3_tokenizer(str(tmp_path / "tokenizer.model")).save(tpath)
    messages = [{"role": "user", "content": "abc abc abc abc"}]

    def serve(spec, bodies):
        loaded = load_model(FIXTURE_M, tpath, cache_dtype=torch.float32, device="cpu")
        eng = loaded.engine
        ks = []
        inner = eng.decode_spec_greedy_n

        def recorded(history, token, n, k=8, ngram=2):
            ks.append(k)
            return inner(history, token, n, k=k, ngram=ngram)

        eng.decode_spec_greedy_n = recorded
        httpd, _ = make_server(loaded, host="127.0.0.1", port=0, spec=spec)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        out = []
        try:
            for extra in bodies:
                ks.clear()
                conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1],
                                                  timeout=120)
                conn.request("POST", "/v1/chat/completions", json.dumps(
                    {"messages": messages, "temperature": 0, "max_tokens": 12, **extra}))
                resp = conn.getresponse()
                data = resp.read()
                conn.close()
                out.append((resp.status, json.loads(data), sorted(set(ks))))
        finally:
            httpd.shutdown()
            httpd.server_close()
        return out

    (st, plain, ks), = serve(0, [{}])
    assert st == 200 and ks == []
    want = plain["choices"][0]["message"]["content"]
    results = serve(4, [{}, {"spec_k": 0}, {"spec_k": 99}, {"spec_k": 2}, {"spec_k": -1}])
    for (st, body, ks), want_ks in zip(results[:4], ([4], [], [4], [2])):
        assert st == 200 and body["choices"][0]["message"]["content"] == want
        assert ks == want_ks  # spec_k 0 opts out; above --spec it clamps to it
    assert results[4][0] == 400
