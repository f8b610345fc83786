"""The decode body of K1, K5, K3 and K4 (dllama_tpu_torch/ops/csrc/decode.cuh)
on the CPU, where no kernel runs:

* its plain versions, the kernels' own arithmetic (exact-code partials per
  32-row block, scaled and summed in f32: q40_maskdot_plain for K1,
  q80_blockdot_plain for K5), against the JAX package's blockdot kernels in
  interpret mode: f32 throughout, within 1e-5 * max|ref| (only the order of
  the f32 sums differs);
* the unpack modelled bit for bit in numpy — every byte through the Q40
  nibble trick, every int8 code through the Q80 magic-number conversion and
  the byte_perm that packs two bf16 — equal to QTensor's / Q8Tensor's exact
  codes;
* one warp's tensor-core fragments, assembled from those bit operations with
  the kernel's thread, byte and column arithmetic, equal to the block's
  plain partial dot x_b . codes_b;
* each walk of a split's blocks of k over the warps, modelled with
  the kernel's index arithmetic: every block once, and K4's runs in
  ascending k;
* the launch geometry of the wrappers (K1, K5, and K3/K4 under STYLE) at
  every Llama-3.1-8B shape and every row count 1-16, read from the wrappers
  themselves on meta tensors;
* the constants the wrappers share with decode.cuh and its launchers.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu_torch.convert import params_from_numpy
from dllama_tpu_torch.ops import q40_matmul as tq
from dllama_tpu_torch.ops import q80_matmul as t8
from dllama_tpu_torch.ops.quant import Q8Tensor, QTensor

torch.set_num_threads(1)

LAYER = 1
RTOL = 1e-5
SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "dllama_tpu_torch" / "ops" / "csrc"
#: Llama-3.1-8B's matmul shapes (k, n), the fused wqkv/w13 ones included
SHAPES_8B = {"wq": (4096, 4096), "wk": (4096, 1024), "w1": (4096, 14336), "w2": (14336, 4096),
             "wcls": (4096, 128256), "wqkv": (4096, 6144), "w13": (4096, 28672)}


def _x(m, k, seed=5):
    return np.random.default_rng(seed + m).standard_normal((m, k)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()


def _stack(ws):
    import jax
    import jax.numpy as jnp

    jw = jax.tree.map(lambda *xs: jnp.stack(xs), *ws)
    return jw, params_from_numpy(jax.tree.map(np.asarray, jw))


@pytest.mark.parametrize("m", [1, 5, 12, 16])
def test_q40_exact_code_plain_matches_pallas_blockdot(m, monkeypatch):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas import q40_matmul as jq
    from dllama_tpu.ops.quant import QTensor as JaxQ

    rng = np.random.default_rng(11)
    jw, tw = _stack([JaxQ.quantize(rng.standard_normal((256, 128)).astype(np.float32) * 0.05)
                     for _ in range(2)])
    x = _x(m, 256)
    monkeypatch.setattr(jq, "STYLE", "blockdot")
    want = jq.q40_matmul(jnp.asarray(x), jw, jnp.int32(LAYER), interpret=True)
    _close(tq.q40_maskdot_plain(torch.from_numpy(x), tw, LAYER), want)


@pytest.mark.parametrize("m", [1, 5, 12, 16])
def test_q80_exact_code_plain_matches_pallas_blockdot(m):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.q80_matmul import q80_matmul as pallas_q80
    from dllama_tpu.ops.quant import Q8Tensor as JaxQ8

    rng = np.random.default_rng(12)
    ws = [JaxQ8.quantize(rng.standard_normal((256, 128)).astype(np.float32) * 0.05)
          for _ in range(2)]
    codes = rng.integers(-128, 128, size=(2, 256, 128), dtype=np.int8)
    codes[1, :2, :3] = -128
    jw, tw = _stack(ws)
    jw = JaxQ8(jnp.asarray(codes), jw.scales)
    tw = Q8Tensor(torch.from_numpy(codes), tw.scales)
    x = _x(m, 256)
    want = pallas_q80(jnp.asarray(x), jw, jnp.int32(LAYER), interpret=True)  # blockdot: m <= 16
    _close(t8.q80_blockdot_plain(torch.from_numpy(x), tw, LAYER), want)


# ---------------------------------------------------- the kernel's bit operations


def _byte_perm(x: int, y: int, sel: int) -> int:
    """PTX prmt (__byte_perm) without its sign mode: result byte i is byte
    (sel >> 4i) & 7 of the eight bytes of (x, y)."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(sel >> 4 * i) & 7] << 8 * i for i in range(4))


def _bf16_rne(v: float) -> float:
    """f32 -> bf16 with round-to-nearest-even, as the f32 holding it."""
    b = int(np.float32(v).view(np.uint32))
    return float(np.uint32(((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16).view(np.float32))


def _bf16_halves(v: int) -> tuple[float, float]:
    lo = np.uint32((v & 0xFFFF) << 16).view(np.float32)
    hi = np.uint32(v & 0xFFFF0000).view(np.float32)
    return float(lo), float(hi)


def _q40_pair(v: int) -> tuple[float, float]:
    """q40_pair: (v & 0x000F000F) | 0x43004300, then a bf16x2 subtraction of
    136 (f32 difference rounded to bf16)."""
    lo, hi = _bf16_halves((v & 0x000F000F) | 0x43004300)
    return tuple(_bf16_rne(np.float32(v) - np.float32(136.0)) for v in (lo, hi))


def _q80_code(w: int, c: int) -> float:
    """q80_code: byte c of w (a code XOR 0x80) into the mantissa of 2^23 by a
    byte_perm against 0x4B000000, minus 2^23 + 128 in f32."""
    f = np.uint32(_byte_perm(w, 0x4B000000, 0x7440 | c)).view(np.float32)
    return float(np.float32(f) - np.float32(8388736.0))


def _q80_pair(lo: int, hi: int, c: int) -> tuple[float, float]:
    """q80_pair: byte_perm 0x7632 keeps the upper half of each f32 code, its
    bf16 (truncated; the codes are exact, so rounding would agree)."""
    lo_b, hi_b = (int(np.float32(_q80_code(v, c)).view(np.uint32)) for v in (lo, hi))
    pair = _bf16_halves(_byte_perm(lo_b, hi_b, 0x7632))
    assert pair == (_bf16_rne(_q80_code(lo, c)), _bf16_rne(_q80_code(hi, c)))
    return pair


def test_q40_unpack_equals_the_exact_codes_for_every_byte():
    """Every packed byte, in every byte of a word, through the byte_perm that
    pairs two packed rows and the nibble trick: low and high nibble give
    QTensor's codes q - 8 (dims r and r + 16 of the block)."""
    byte = np.arange(256, dtype=np.uint8)
    w = QTensor(torch.from_numpy(np.repeat(byte[None, :], 16, axis=0)),
                torch.ones((1, 256), dtype=torch.float16))
    want = w.dequantize(torch.float32).numpy()  # [32, 256]: dim 0 low, dim 16 high nibble
    for b in range(256):
        o = 255 - b  # the other row's byte in the same column
        for c in range(4):
            word0 = (b << 8 * c) | (0xA5A5A5A5 & ~(0xFF << 8 * c))
            word1 = (o << 8 * c) | (0x5A5A5A5A & ~(0xFF << 8 * c))
            p = _byte_perm(word0, word1, 0x7632 if c >> 1 else 0x5410)
            shift = 8 * (c & 1)
            assert _q40_pair(p >> shift) == (want[0, b], want[0, o]), (b, c)
            assert _q40_pair(p >> (shift + 4)) == (want[16, b], want[16, o]), (b, c)


def test_q80_unpack_equals_the_exact_codes_for_every_code():
    """Every int8 code, -128 included, in every byte of a word: XOR 0x80,
    the magic-number f32 and the bf16 rounding give Q8Tensor's code."""
    codes = np.arange(-128, 128, dtype=np.int8)
    want = Q8Tensor(torch.from_numpy(np.repeat(codes[None, :], 32, axis=0)),
                    torch.ones((1, 256), dtype=torch.float16)).dequantize(torch.float32).numpy()[0]
    raw = codes.view(np.uint8).astype(np.int64)
    for c in range(4):
        for i in range(256):
            lo = (int(raw[i]) << 8 * c) ^ 0x80808080
            hi = (int(raw[255 - i]) << 8 * c) ^ 0x80808080
            assert _q80_pair(lo, hi, c) == (want[i], want[255 - i]), (i, c)


def _warp_partial(fmt: str, stored: np.ndarray, x_block: np.ndarray, n_tiles: int) -> np.ndarray:
    """One warp's partial dot of a 32-row block as decode.cuh forms it:
    per lane (g, t) the words of its rows at byte 2 I g, the fragments of
    each n16 tile by the format's bit operations, the two k16 products on
    the PTX m16n8k16 fragment layout, and the sums written where the kernel
    writes them. `stored` is the block as it lies in memory ([16, 16 I]
    packed bytes, or [32, 16 I] int8 codes), x_block [M, 32]."""
    m_rows = x_block.shape[0]
    mt_count = -(-m_rows // 8)
    out = np.zeros((8 * mt_count, 16 * n_tiles))
    xb = np.zeros((8 * mt_count, 32))
    xb[:m_rows] = x_block
    a_tiles = np.zeros((n_tiles, 2, 16, 16))  # tile, step, A row, k
    raw = stored.view(np.uint8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        off = 2 * n_tiles * g

        def word(r, q, off=off):
            return int.from_bytes(raw[r, off + 4 * q : off + 4 * q + 4].tobytes(), "little")

        for i in range(n_tiles):
            q = i >> 1
            if fmt == "q40":
                sel = 0x7632 if i & 1 else 0x5410
                p01 = _byte_perm(word(2 * t, q), word(2 * t + 1, q), sel)
                p23 = _byte_perm(word(2 * t + 8, q), word(2 * t + 9, q), sel)
                regs = [[_q40_pair(p01), _q40_pair(p01 >> 8), _q40_pair(p23), _q40_pair(p23 >> 8)],
                        [_q40_pair(p01 >> 4), _q40_pair(p01 >> 12), _q40_pair(p23 >> 4),
                         _q40_pair(p23 >> 12)]]
            else:
                c = 2 * (i & 1)
                regs = []
                for s in range(2):
                    w = [word(16 * s + 2 * t + d, q) ^ 0x80808080 for d in (0, 1, 8, 9)]
                    regs.append([_q80_pair(w[0], w[1], c), _q80_pair(w[0], w[1], c + 1),
                                 _q80_pair(w[2], w[3], c), _q80_pair(w[2], w[3], c + 1)])
            for s in range(2):
                for reg, (row, kk) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                                 (g + 8, 2 * t + 8))):
                    a_tiles[i, s, row, kk], a_tiles[i, s, row, kk + 1] = regs[s][reg]
    for i in range(n_tiles):
        for mt in range(mt_count):
            # B[k][j] = x row 8 mt + j, dim 16 s + k; C = A0 B0 + A1 B1 [16 x 8]
            cmat = sum(a_tiles[i, s] @ xb[8 * mt : 8 * mt + 8, 16 * s : 16 * s + 16].T
                       for s in range(2))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                c2, r = 2 * n_tiles * g + 2 * i, mt * 8 + 2 * t
                out[r, c2], out[r + 1, c2] = cmat[g, 2 * t], cmat[g, 2 * t + 1]
                out[r, c2 + 1], out[r + 1, c2 + 1] = cmat[g + 8, 2 * t], cmat[g + 8, 2 * t + 1]
    return out[:m_rows]


@pytest.mark.parametrize("n_tiles", [2, 4, 8])
@pytest.mark.parametrize("fmt,m", [("q40", 3), ("q40", 12), ("q80", 1), ("q80", 16)])
def test_warp_fragments_form_the_blocks_partial_dot(fmt, m, n_tiles):
    rng = np.random.default_rng(n_tiles + m)
    cols = 16 * n_tiles
    x_block = rng.integers(-40, 40, size=(m, 32)).astype(np.float64)  # exact sums
    if fmt == "q40":
        stored = rng.integers(0, 256, size=(16, cols), dtype=np.uint8)
        codes = np.concatenate([(stored & 15).astype(np.int64) - 8,
                                (stored >> 4).astype(np.int64) - 8])  # [32, cols]
    else:
        stored = rng.integers(-128, 128, size=(32, cols), dtype=np.int8)
        stored[0, 0] = -128
        codes = stored.astype(np.int64)
    got = _warp_partial(fmt, stored, x_block, n_tiles)
    assert np.array_equal(got, x_block @ codes)


def _walk(runs: bool, kb_per_split: int, splits: int, nkb: int, wk_count: int) -> list:
    """The blocks of k each warp of each split sums, in the order a column's
    sum meets them, with decode_kernel's index arithmetic (kb0, kb1, the
    step KS): [[blocks of split s, warp wk] for wk] for s]."""
    out = []
    for y in range(splits):
        split0 = y * kb_per_split
        end = min(nkb, split0 + kb_per_split)
        run = -(-kb_per_split // wk_count) if runs else 1
        step = 1 if runs else wk_count
        warps = []
        for wk in range(wk_count):
            kb0 = split0 + wk * run
            kb1 = min(end, kb0 + run) if runs else end
            warps.append(list(range(kb0, kb1, step)))
        out.append(warps)
    return out


@pytest.mark.parametrize("k", [256, 1024, 4096, 4128, 14336])
def test_walks_cover_k_once_and_loopdot_runs_ascend(k):
    """Blockdot (K1/K3) deals a split's blocks to its warps in turn, Loopdot
    (K4) in runs: both walk every 32-row block once, and K4's runs, read in
    the order the kernel adds them (warps of a split, then splits), are
    k ascending."""
    nkb = k // 32
    for runs, geo in ((False, tq.decode_geometry(k, 1024, SMS)),
                      (True, tq.loopdot_geometry(k, 1024, SMS))):
        walk = _walk(runs, geo.kb_per_split, geo.splits, nkb, 4)
        flat = [b for split in walk for warp in split for b in warp]
        assert sorted(flat) == list(range(nkb))
        assert not runs or flat == list(range(nkb))


# ------------------------------------------------------------------ geometry


def _launches(module, fmt, k, n, rows, monkeypatch, style="auto"):
    """The geometry each wrapper hands decode_launch for an m-row call, for
    m in `rows` (under q40_matmul.STYLE `style`), read by running the
    wrapper on meta tensors."""
    seen = []
    monkeypatch.setattr(tq, "STYLE", style)
    monkeypatch.setattr(module, "LAUNCHES", dict(module.LAUNCHES))
    monkeypatch.setattr(module, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(module, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(module, "decode_launch",
                        lambda name, x2, w, s, out, geo: seen.append((name, x2.shape[0], geo)))
    meta = torch.device("meta")
    if fmt == "q40":
        w = QTensor(torch.empty((k // 2, n), dtype=torch.uint8, device=meta),
                    torch.empty((k // 32, n), dtype=torch.float16, device=meta))
        call = tq.q40_matmul
    else:
        w = Q8Tensor(torch.empty((k, n), dtype=torch.int8, device=meta),
                     torch.empty((k // 32, n), dtype=torch.float16, device=meta))
        call = t8.q80_matmul
    for m in rows:
        call(torch.empty((m, k), dtype=torch.bfloat16, device=meta), w)
    return seen


#: the decode body's launches: (format, STYLE) -> the library the wrapper launches
DECODE_LIBS = {("q40", "auto"): "q40_decode", ("q80", "auto"): "q80_decode",
               ("q40", "maskdot"): "q40_maskdot", ("q40", "loopdot"): "q40_loopdot"}


@pytest.mark.parametrize("fmt,style", list(DECODE_LIBS))
@pytest.mark.parametrize("name", list(SHAPES_8B))
def test_decode_geometry_at_every_8b_shape_and_row_count(fmt, style, name, monkeypatch):
    """For m = 1..16 the wrapper launches the decode body with one geometry:
    its splits cover the 32-row blocks of k once, its grid gives each of the
    132 SMs a block, no split walks fewer than DECODE_MIN_BLOCKS_PER_SPLIT
    blocks unless k has fewer, the column tile is one the body is built for,
    and a launch has at most 8 splits (the partials the last block of a
    column tile reads at once); no thread-block cluster is used. K3 takes
    K1's geometry, K4 loopdot_geometry's."""
    k, n = SHAPES_8B[name]
    module = tq if fmt == "q40" else t8
    seen = _launches(module, fmt, k, n, range(1, 17), monkeypatch, style)
    lib = DECODE_LIBS[fmt, style]
    assert [(nm, m) for nm, m, _ in seen] == [(lib, m) for m in range(1, 17)]
    geos = {geo for _, _, geo in seen}
    assert len(geos) == 1  # nothing depends on m
    (geo,) = geos
    nkb = k // 32
    assert (geo.splits - 1) * geo.kb_per_split < nkb <= geo.splits * geo.kb_per_split
    assert geo.kb_per_split >= min(nkb, tq.DECODE_MIN_BLOCKS_PER_SPLIT)
    assert -(-n // geo.cols) * geo.splits >= SMS
    assert geo.cols in tq.DECODE_COLS
    assert geo.splits <= tq.DECODE_MAX_SPLITS <= 8
    if lib == "q40_maskdot":
        assert geo == tq.decode_geometry(k, n, SMS)
    if lib == "q40_loopdot":
        assert geo == tq.loopdot_geometry(k, n, SMS)
    # long runs of k where n alone fills the card: one split at the lm-head
    assert name != "wcls" or geo.splits == 1 or lib in ("q80_decode", "q40_loopdot")


@pytest.mark.parametrize("k", [256, 4096, 4128, 14336])
def test_q80_split_boundaries_follow_k_alone(k):
    geos = {t8.decode_geometry(k, n, SMS)[:2] for n in (128, 1000, 1024, 4096, 6144, 14336,
                                                       28672, 128256)}
    assert len(geos) == 1


# ---------------------------------------------------------- shared constants


def _constants(text: str) -> dict[str, int]:
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _policy(text: str, name: str) -> dict[str, int]:
    body = text[text.index(f"struct {name} {{"):]
    return _constants(body[: body.index("};")])


def test_decode_constants_match_the_body():
    """The wrappers' column tiles, row limit and split limits are the body's:
    16 I columns a warp for I = 2, 4, 8; 128-column warps side by side for
    the BLOCKDOT_TN tiles; each launcher builds exactly those tiles; a split
    walks at least two ring slots of one block a warp; and no launch has
    more splits than the last block reads at once. Each of the four sources
    instantiates the body over its format and walk, and the walks' flags are
    the ones the walk model above assumes."""
    text = (CSRC / "decode.cuh").read_text()
    c = _constants(text)
    assert tq.DECODE_COLS == (c["kMaxCols"], c["kMaxCols"] // 2, c["kMinCols"]) == (128, 64, 32)
    assert tq.DECODE_TILES_N == (c["kMaxCols"], 2 * c["kMaxCols"], c["kWarps"] * c["kMaxCols"])
    assert tq.DECODE_MAX_M == c["kMaxM"]
    assert tq.DECODE_MIN_BLOCKS_PER_SPLIT == 2 * c["kWarps"]
    assert tq.DECODE_MAX_SPLITS == c["kMaxSplits"] and t8.DECODE_SPLITS <= c["kMaxSplits"]
    assert (_policy(text, "Q40Codes")["kRows"], _policy(text, "Q80Codes")["kRows"]) == (16, 32)
    cases = {int(v) for v in re.findall(r"case (\d+):", text)}
    assert cases == set(tq.DECODE_COLS) | set(tq.DECODE_TILES_N)
    assert "kWideTiles = true" in text[text.index("struct Q40Codes"):text.index("struct Q80Codes")]
    assert "kWideTiles = false" in text[text.index("struct Q80Codes"):]
    assert t8.DECODE_SPLITS <= c["kMaxSplits"] and tq.LOOPDOT_SPLITS <= c["kMaxSplits"]
    for src, inst in (("q40_decode.cu", "Q40Codes, Blockdot"), ("q80_decode.cu", "Q80Codes, Blockdot"),
                      ("q40_maskdot.cu", "Q40Codes, Blockdot"), ("q40_loopdot.cu", "Q40Codes, Loopdot")):
        body = (CSRC / src).read_text()
        assert '#include "decode.cuh"' in body and f"decode<{inst}>(" in body, src
    runs = dict(re.findall(r"struct (\w+) \{\s*static constexpr bool kRuns = (\w+);", text))
    assert runs == {"Blockdot": "false", "Loopdot": "true"}
