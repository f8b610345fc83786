"""The decode chunk as one device program (engine/graphs.py) on the CPU, where
each program runs its body eagerly: the same body a CUDA graph captures on
the card.

* Greedy ids of the single-engine programs are bit-equal to the JAX
  package's decode scan (``_decode_n_impl``) at n = 1, 3 and 8, and across
  a ``generate`` that stops mid-chunk and then continues (the position
  buffer reloads from the rewound position); penalized greedy likewise.
* BatchEngine greedy ids through the static-buffer ``decode_dispatch`` are
  bit-equal to JAX's BatchEngine, dense and paged at page 8: a page
  boundary crossed mid-chunk, a slot frozen at its row limit, two chunks
  dispatched before the first is consumed.
* A seeded sampled stream repeats, and is the n-step loop fed the chunk's
  uniforms drawn in one call; the per-row sampling the programs use keeps
  the scalar path's top-p set, token for token.
* K7's tiles per split do not depend on the position path.
* The replay launch accounting is a pure function; programs are keyed on
  the knobs a graph fixes at capture.
* ``warmup`` leaves the engine untouched and the first request's ids as
  they are without it; the CLI takes ``--warmup auto`` and the single-engine
  tier warns and ignores it.
* Prefill programs, one a power-of-two width with the position (and on the
  batched tier the slot) as device inputs: for every width up to
  ``max_prefill_chunk``, on the single engine and on both batched layouts,
  their logits and cache rows are bit-equal to a forward at a host
  position through a per-slot view (the path before the programs), and
  within 1e-4 of max|logit| of the JAX package's ``_step`` and
  ``BatchEngine.add_step``; the single engine still reproduces
  ``GOLDEN_CONTINUATION`` with its prompt cut into widths 1, 2 and 4.
"""

import http.client
import json
import logging
import threading

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.engine import graphs
from dllama_tpu_torch.engine.batch import BatchEngine
from dllama_tpu_torch.engine.engine import InferenceEngine
from dllama_tpu_torch.engine.sampling import Sampler, sample_logits
from dllama_tpu_torch.models import formats
from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops import q40_matmul
from dllama_tpu_torch.ops.flash_attention import TS, call_splits, kv_splits
from tests.test_golden import FIXTURE_M, GOLDEN_CONTINUATION, GOLDEN_PROMPT

torch.set_num_threads(1)

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
          seq_len=64)
CFG = LlamaConfig(**KW)


def _port_engine(**kw) -> InferenceEngine:
    cfg, hs = formats.read_header(FIXTURE_M)
    return InferenceEngine(cfg, formats.load_params(FIXTURE_M, cfg, hs),
                           cache_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def jax_engine():
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine
    from dllama_tpu.models import formats as jf

    jcfg, jhs = jf.read_header(FIXTURE_M)
    return JaxEngine(jcfg, jf.load_params(FIXTURE_M, jcfg, jhs), cache_dtype=jnp.float32)


@pytest.fixture(scope="module")
def batch_models():
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.config import LlamaConfig as JaxConfig
    from dllama_tpu.models.llama import random_params

    jcfg = JaxConfig(**KW)
    jparams = random_params(jcfg, seed=9, dtype=jnp.float32, quantize=False)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


# ------------------------------------------------------------ single engine


def test_greedy_programs_match_the_jax_decode_scan(jax_engine):
    eng = _port_engine()
    jax_engine.reset(0)
    want_first = int(np.argmax(np.asarray(jax_engine.prefill(np.asarray([GOLDEN_PROMPT])))[0]))
    tok = int(torch.argmax(eng.prefill(np.asarray([GOLDEN_PROMPT]))[0]))
    assert tok == want_first == GOLDEN_CONTINUATION[0]
    for n in (1, 3, 8):
        want = np.asarray(jax_engine.decode_greedy_n(np.array([[tok]]), n))
        got = eng.decode_greedy_n(np.array([[tok]]), n)
        np.testing.assert_array_equal(got, want)
        assert eng.pos == jax_engine.pos
        tok = int(got[-1, 0])
    assert eng.forwards == 1 + 1 + 3 + 8  # the prefill chunk, then one a decode step


def test_generate_stops_mid_chunk_and_continues_like_jax(jax_engine):
    from dllama_tpu.engine.sampling import Sampler as JaxSampler

    eng = _port_engine()
    stop = GOLDEN_CONTINUATION[5]
    jax_engine.reset(0)
    want = list(jax_engine.generate(GOLDEN_PROMPT, 16, JaxSampler(0.0, 0.9, 1),
                                    stop_fn=lambda t: t == stop, chunk=4))
    got = list(eng.generate(GOLDEN_PROMPT, 16, Sampler(0.0, 0.9, 1),
                            stop_fn=lambda t: t == stop, chunk=4))
    assert got == want == GOLDEN_CONTINUATION[:6]
    assert eng.pos == jax_engine.pos == len(GOLDEN_PROMPT) + 5
    # the program left its position buffer 3 rows further: it reloads
    want = np.asarray(jax_engine.decode_greedy_n(np.array([[stop]]), 8))
    np.testing.assert_array_equal(eng.decode_greedy_n(np.array([[stop]]), 8), want)
    np.testing.assert_array_equal(want[:, 0], GOLDEN_CONTINUATION[6:14])


def test_penalized_greedy_programs_match_jax(jax_engine):
    from dllama_tpu.engine.sampling import Sampler as JaxSampler

    jax_engine.reset(0)
    want = list(jax_engine.generate(GOLDEN_PROMPT, 14, JaxSampler(0.0, 0.9, 1, -1.5, -0.5),
                                    chunk=3))
    got = list(_port_engine().generate(GOLDEN_PROMPT, 14, Sampler(0.0, 0.9, 1, -1.5, -0.5),
                                       chunk=3))
    assert got == want
    assert got != GOLDEN_CONTINUATION[:14]  # the penalties did change the text


def test_seeded_sampled_stream_repeats_and_draws_a_chunk_at_once():
    eng = _port_engine()
    runs = []
    for _ in range(2):
        eng.reset(0)
        runs.append(list(eng.generate(GOLDEN_PROMPT, 12, Sampler(0.9, 0.8, 5), chunk=4)))
    assert runs[0] == runs[1]
    eng.reset(0)
    assert list(eng.generate(GOLDEN_PROMPT, 12, Sampler(0.9, 0.8, 6), chunk=4)) != runs[0]
    # the stream is the n-step loop fed uniforms [n, B, 2] drawn in one call
    ref = _port_engine()
    sampler = Sampler(0.9, 0.8, 5)
    tok = int(sampler(ref.prefill(np.asarray([GOLDEN_PROMPT])))[0])
    want = [tok]
    for n in (4, 4, 3):
        u = torch.rand((n, 1, 2), generator=sampler.generator("cpu"))
        for i in range(n):
            logits = ref.decode_step([[want[-1]]])
            want.append(int(sample_logits(logits, 0.9, 0.8, uniforms=u[i])[0]))
    assert runs[0] == want


def test_per_row_sampling_keeps_the_scalar_top_p_set():
    """The programs pass temperature and top-p as [B] vectors (a graph
    cannot bake a request's floats): every uniform picks the same token as
    the scalar arguments, so the kept set is unchanged."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((6, 300)).astype(np.float32) * 2)
    for temp, topp in ((0.8, 0.9), (1.3, 0.5), (0.7, 1.0), (1.0, 0.0)):
        for u0 in np.linspace(0.0, 0.999, 41):
            u = torch.tensor([[u0, 1.0 - u0]] * 6, dtype=torch.float32)
            want = sample_logits(logits, temp, topp, uniforms=u)
            got = sample_logits(logits, torch.full((6,), temp), torch.full((6,), topp),
                                uniforms=u)
            assert torch.equal(got, want), (temp, topp, u0)


def test_capture_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        _port_engine(capture=True)
    assert not _port_engine().programs.capture


# -------------------------------------------------------------- batch engine


def _batch_script(engine):
    """A slot whose decode crosses the page boundary at row 8 mid-chunk and
    one that freezes at its row limit (the context's 64 rows) in the second
    chunk, which is dispatched before the first is consumed; then a
    penalized greedy slot joins and a lockstep chunk runs."""
    out = [engine.add(0, [1, 2, 3, 4, 5], temperature=0.0),
           engine.add(1, list(range(3, 62)), temperature=0.0)]
    first = engine.decode_dispatch(4)
    second = engine.decode_dispatch(4)
    out.append(engine.decode_consume(first).tolist())
    out.append(engine.decode_consume(second).tolist())
    out.append([int(a) for a in second.advance])
    out.append(engine.add(2, [9, 8, 7, 6, 5], temperature=0.0, presence=0.5, frequency=0.3))
    out.append(engine.decode(4).tolist())
    out.append([int(p) for p in engine.pos])
    return out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batch_programs_match_jax(batch_models, layout):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine

    jcfg, jparams, params = batch_models
    want = _batch_script(JaxEngine(jcfg, jparams, n_slots=3, cache_dtype=jnp.float32,
                                   kv_layout=layout, page_size=8, radix_cache="off"))
    eng = BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32, kv_layout=layout,
                      page_size=8)
    if eng.pool is not None:
        eng.pool.audit_on_release = True
    got = _batch_script(eng)
    assert got == want
    assert got[4] == [4, 1, 0]  # slot 1 froze at row 64 after one row of chunk 2
    assert got[-1] == [17, 64, 9]
    assert eng.forwards == 3 * 4 + 9  # three 4-step chunks and the prompts' nine chunks
    if eng.pool is not None:
        eng.pool.audit()


# --------------------------------------------------------- prefill programs

WIDTHS = (1, 2, 4, 8, 16)
START = 3  # each chunk runs at cache position 3, over rows nothing wrote


def _tokens(width: int) -> np.ndarray:
    return np.random.default_rng(width).integers(0, KW["vocab_size"], (1, width))


def test_single_engine_prefill_programs_match_the_host_position_and_jax(batch_models):
    import jax.numpy as jnp

    from dllama_tpu.engine.engine import InferenceEngine as JaxEngine

    jcfg, jparams, params = batch_models
    jeng = JaxEngine(jcfg, jparams, cache_dtype=jnp.float32, max_prefill_chunk=16)
    eng = InferenceEngine(CFG, params, cache_dtype=torch.float32, max_prefill_chunk=16)
    ref = InferenceEngine(CFG, params, cache_dtype=torch.float32, max_prefill_chunk=16)
    for width in WIDTHS:
        toks = _tokens(width)
        eng.reset(START)
        got = eng.step(toks)
        want = ref._forward(torch.from_numpy(toks), START)  # a host int position
        assert torch.equal(got, want), width
        assert torch.equal(eng.cache.k, ref.cache.k) and torch.equal(eng.cache.v, ref.cache.v)
        assert eng.pos == START + width and eng._dev_pos == eng.pos
        assert int(eng._dec_pos[0]) == eng.pos  # the program advanced the device position
        jeng.reset(START)
        jax_logits = np.asarray(jeng.step(toks))
        np.testing.assert_allclose(got.numpy(), jax_logits,
                                   atol=1e-4 * float(np.abs(jax_logits).max()))
    assert eng.programs.stats()["programs"] == len(WIDTHS)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batched_prefill_programs_match_the_host_position_and_jax(batch_models, layout):
    import jax.numpy as jnp

    from dllama_tpu.engine.batch import BatchEngine as JaxEngine
    from dllama_tpu_torch.models.llama import KVCache, PagedKVCache

    jcfg, jparams, params = batch_models
    kw = dict(n_slots=len(WIDTHS), kv_layout=layout, page_size=8, max_prefill_chunk=16)
    jeng = JaxEngine(jcfg, jparams, cache_dtype=jnp.float32, radix_cache="off", **kw)
    eng = BatchEngine(CFG, params, cache_dtype=torch.float32, **kw)
    ref = BatchEngine(CFG, params, cache_dtype=torch.float32, **kw)
    for slot, width in enumerate(WIDTHS):  # a slot each: fresh rows below START
        toks = _tokens(width)
        adm = eng.add_begin(slot, toks[0], start_pos=START)
        assert eng.add_step(adm) and adm.off == width
        assert int(eng.pos[slot]) == START + width
        # the host-position path: a per-slot view of the cache
        ref.add_begin(slot, toks[0], start_pos=START)
        ref._sync_vectors()
        sub = (PagedKVCache(ref.cache.k, ref.cache.v, ref.cache.tables[slot : slot + 1])
               if layout == "paged" else
               KVCache(ref.cache.k[:, slot : slot + 1], ref.cache.v[:, slot : slot + 1]))
        want = ref._logits(torch.from_numpy(toks), START, sub)
        assert torch.equal(adm.logits, want), width
        assert torch.equal(eng.cache.k, ref.cache.k) and torch.equal(eng.cache.v, ref.cache.v)
        jadm = jeng.add_begin(slot, toks[0], start_pos=START)
        assert jeng.add_step(jadm)
        jax_logits = np.asarray(jadm.logits)
        np.testing.assert_allclose(adm.logits.numpy(), jax_logits,
                                   atol=1e-4 * float(np.abs(jax_logits).max()))
    # one program a width on the page pool; one a (slot, width) on dense
    assert eng.programs.stats()["programs"] == len(WIDTHS)
    assert eng.forwards == len(WIDTHS)


@pytest.mark.parametrize("max_chunk", [1, 2, 4])
def test_single_engine_reproduces_the_golden_continuation_in_program_widths(max_chunk):
    eng = _port_engine(max_prefill_chunk=max_chunk)
    got = list(eng.generate(GOLDEN_PROMPT, len(GOLDEN_CONTINUATION), Sampler(0.0, 0.9, 1),
                            chunk=4))
    assert got == GOLDEN_CONTINUATION
    widths = {k[1] for k in eng.programs._progs if k[0] == "prefill"}
    assert widths == {max_chunk}  # the 4-token prompt in chunks of max_chunk


# ------------------------------------------------------------------- warmup


def _engine_state(eng: BatchEngine) -> dict:
    k, v = eng.cache.k, eng.cache.v
    if eng.pool is not None:  # the trash page takes the inert prefill's rows
        k, v = k[:, :-1], v[:, :-1]
    return {"pos": eng._pos_dev.clone(), "last": eng._last_dev.clone(),
            "seed": eng.rng.seed.clone(), "counter": eng.rng.counter.clone(),
            "k": k.clone(), "v": v.clone(), "host_pos": eng.pos.copy(),
            "active": eng.active.copy(), "forwards": eng.forwards}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_warmup_leaves_the_engine_untouched(batch_models, layout):
    _, _, params = batch_models

    def engine():
        return BatchEngine(CFG, params, n_slots=3, cache_dtype=torch.float32,
                           kv_layout=layout, page_size=8, max_prefill_chunk=16)

    warm, cold = engine(), engine()
    before = _engine_state(warm)
    report = warm.warmup(chunk=4)
    after = _engine_state(warm)
    for key, val in before.items():
        same = torch.equal(val, after[key]) if isinstance(val, torch.Tensor) else (
            np.array_equal(val, after[key]))
        assert same, key
    assert report["full_coverage"] and report["graphs_captured"] == 0  # no capture on the CPU
    # the prefill widths 1..16, one program set for the page pool, one a
    # slot on the dense layout (a graph fixes the slot's cache view)
    widths = 5 if layout == "paged" else 5 * 3
    assert report["per_fn"] == {"decode": 4, "decode_sampled": 4, "decode_pen": 4,
                                "prefill_chunk": widths}
    assert report["buckets"] == 12 + widths and report["cached"] == 0
    if warm.pool is not None:
        assert warm.pool.audit()["free"] == warm.pool.n_pages

    def first_request(eng):
        ids = [eng.add(1, [5, 6, 7, 8, 9, 10], temperature=0.0)]
        for _ in range(3):
            ids += eng.decode(4)[:, 1].tolist()
        return ids

    assert first_request(warm) == first_request(cold)
    with pytest.raises(RuntimeError, match="active"):
        warm.warmup()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float8_e4m3fn])
def test_one_copy_dense_write_equals_the_per_row_scatter(dtype):
    """A decode program's positions are a device tensor: the dense caches
    take each layer's new rows in one index_copy_ (llama._dense_write_index),
    bit-equal to the per-row scatter."""
    from dllama_tpu_torch.models.llama import _cache_update, _dense_write_index, _zeros

    rng = np.random.default_rng(5)
    b, h, s, hd, t = 3, 2, 40, 8, 2
    pos = torch.tensor([0, 17, 38], dtype=torch.int32)
    new = torch.from_numpy(rng.standard_normal((b, t, h, hd)).astype(np.float32)).transpose(1, 2)
    caches = [_zeros((b, h, s, hd), dtype, "cpu") for _ in range(2)]
    for c in caches:
        c.view(torch.uint8).copy_(torch.from_numpy(
            rng.integers(0, 120, c.view(torch.uint8).shape, dtype=np.uint8)))
    caches[1].view(torch.uint8).copy_(caches[0].view(torch.uint8))
    _cache_update(caches[0], new, pos)
    _cache_update(caches[1], new, pos, index=_dense_write_index(pos, b, h, s, t))
    assert torch.equal(caches[0].view(torch.uint8), caches[1].view(torch.uint8))


# ------------------------------------------------------------- the K7 split


@pytest.mark.parametrize("s", [64, 1000, 4096, 4224, 4288, 8192, 32768])
@pytest.mark.parametrize("bhkv,sms", [(8, 132), (64, 132), (8, 78), (256, 114)])
def test_k7_tiles_per_split_follow_the_cache_not_the_position_path(s, bhkv, sms):
    """A decode row (4 folded rows a KV head, device pos) and a spec verify
    row (36 rows, host pos) at any position take the same splits and tiles
    per split, so each sums a row's keys in the same groups: tiles [z per,
    (z + 1) per) of the row's live ones, merged in split order."""
    want = call_splits(4, bhkv, s, sms)
    assert call_splits(36, bhkv, s, sms) == want == kv_splits(4, bhkv, -(-s // TS), sms)
    splits, per = want
    for pos in range(0, s, max(1, s // 257)):
        n_tiles = pos // TS + 1  # the row's live tiles, from pos in the kernel
        live = min(splits, -(-n_tiles // per))
        groups = [(z * per, min((z + 1) * per, n_tiles)) for z in range(live)]
        assert groups[0][0] == 0 and groups[-1][1] == n_tiles
        assert all(a < b for a, b in groups)
    assert (splits - 1) * per < -(-s // TS) <= splits * per


# ------------------------------------------------------- programs and counts


def test_replay_launch_accounting_is_pure():
    before = ({"q40_decode": 3, "q40_prefill": 7}, {"flash_attention": 0, "f8": 2})
    after = ({"q40_decode": 228, "q40_prefill": 7}, {"flash_attention": 32, "f8": 2})
    delta = graphs.launch_delta(before, after)
    assert delta == ({"q40_decode": 225}, {"flash_attention": 32})
    counts = {"q40_decode": 10, "q40_prefill": 1}
    assert graphs.replayed(counts, delta[0]) == {"q40_decode": 235, "q40_prefill": 1}
    assert graphs.replayed(counts, delta[0], times=4) == {"q40_decode": 910, "q40_prefill": 1}
    assert counts == {"q40_decode": 10, "q40_prefill": 1}  # inputs untouched
    assert before[0] == {"q40_decode": 3, "q40_prefill": 7}
    assert graphs.launch_delta(after, after) == ({}, {})
    # every wrapper a decode body reaches is counted
    keys = {k for table in graphs.launch_tables() for k in table}
    assert {"q40_decode", "q80_decode", "flash_attention", "flash_attention_f8",
            "paged_attention", "rms_norm"} <= keys


def test_programs_are_keyed_on_the_knobs_a_graph_fixes():
    progs = graphs.Programs("cpu")
    made = []

    def make(variant, n):
        made.append((variant, n))
        return (lambda: made.append("ran")), {}, ()

    a = progs.get("greedy", 2, make)
    assert progs.get("greedy", 2, make) is a and progs.ready("greedy", 2)
    with q40_matmul.forced_style("loopdot"):
        assert progs.get("greedy", 2, make) is not a
        assert progs.ready("greedy", 2)
    a.run()
    assert made == [("greedy", 2), ("greedy", 2), "ran"]
    assert progs.stats() == {"programs": 2, "graphs": 0, "capture_s": 0}
    with pytest.raises(ValueError, match="variant"):
        progs.get("beam", 2, make)


# ---------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def tpath(tmp_path_factory):
    from dllama_tpu.tools.convert_tokenizer import convert_llama3_tokenizer
    from tests.golden_fixture import write_tiktoken_file

    tmp = tmp_path_factory.mktemp("torch_graphs")
    write_tiktoken_file(str(tmp / "tokenizer.model"))
    path = str(tmp / "golden.t")
    convert_llama3_tokenizer(str(tmp / "tokenizer.model")).save(path)
    return path


def _content(port: int) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(
        {"messages": [{"role": "user", "content": "tell me a story"}], "temperature": 0,
         "max_tokens": 12}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    return body["choices"][0]["message"]["content"]


def test_serve_warmup_auto_on_both_tiers(tpath, caplog, monkeypatch):
    from dllama_tpu_torch.cli.main import main
    from dllama_tpu_torch.engine.loader import load_model
    from dllama_tpu_torch.serve import api

    contents, reports = [], []
    for warmup in ("auto", "off"):
        httpd, server = api.make_server(load_model(FIXTURE_M, tpath, cache_dtype=torch.float32,
                                                   device="cpu"),
                                        n_slots=2, kv_layout="paged", page_size=16,
                                        warmup=warmup)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            reports.append(server.scheduler.warmup_report)
            contents.append(_content(httpd.server_address[1]))
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.scheduler.shutdown()
    assert contents[0] == contents[1]
    assert reports[0]["full_coverage"] and reports[0]["per_fn"]["decode"] == 4
    assert reports[1] is None
    with caplog.at_level(logging.WARNING, logger="dllama_tpu_torch.serve"):
        httpd, _ = api.make_server(load_model(FIXTURE_M, tpath, device="cpu"), n_slots=0,
                                   warmup="auto")
        httpd.server_close()
    assert any("--warmup needs --slots > 0" in r.getMessage() for r in caplog.records)
    # the CLI hands the flag to the server it runs
    seen = {}
    monkeypatch.setattr(api, "run_server", lambda loaded, **kw: seen.update(kw) or 0)
    assert main(["serve", "--model", FIXTURE_M, "--tokenizer", tpath, "--device", "cpu",
                 "--slots", "2", "--warmup", "auto"]) == 0
    assert seen["warmup"] == "auto" and seen["n_slots"] == 2
