"""The paged attention wrappers' plain versions (what the CUDA kernel is held
against on the card) against the JAX package on the same numpy inputs:
paged write addressing and the block-table view (integers equal), K9's
wrapper against the JAX gather reference (`_paged_cache_update` followed by
`paged_gqa_attention`, as tests/test_paged_kernel.py does) with the pools
bit-equal, and K8's wrapper against the Pallas block-table flash kernel in
interpret mode. Outputs within 2e-5 absolute and relative: both compute the
same f32 softmax, in another order of sums."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dllama_tpu_torch.ops import flash_attention, paged_attention
from dllama_tpu_torch.ops.flash_attention import paged_flash_gqa_attention, paged_supported
from dllama_tpu_torch.ops.layers import paged_view, paged_write_targets
from dllama_tpu_torch.ops.paged_attention import (
    FUSED_SCATTER_MAX_T,
    kv_splits,
    paged_decode_attention,
    paged_decode_supported,
)

torch.set_num_threads(1)

HD = 64
TOL = 2e-5


def _setup(seed, page, nb, b, t, hq, hkv):
    rng = np.random.default_rng(seed)
    npool = b * nb + 1  # +1 trash page, as PagedKVCache.create
    q = rng.standard_normal((b, t, hq, HD)).astype(np.float32)
    kp = rng.standard_normal((npool, hkv, page, HD)).astype(np.float32)
    vp = rng.standard_normal((npool, hkv, page, HD)).astype(np.float32)
    # shuffled tables: physical page order must not matter
    tables = rng.permutation(npool - 1)[: b * nb].reshape(b, nb).astype(np.int32)
    nk = rng.standard_normal((b, hkv, t, HD)).astype(np.float32)
    nv = rng.standard_normal((b, hkv, t, HD)).astype(np.float32)
    return q, kp, vp, tables, nk, nv


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _jax_reference(q, kp, vp, tables, pos, nk=None, nv=None, active=None):
    """The scatter and gather attention as one jitted function (one compile
    per shape instead of one per primitive)."""
    import jax
    import jax.numpy as jnp

    from dllama_tpu.models.llama import _paged_cache_update
    from dllama_tpu.ops.layers import paged_gqa_attention

    def ref(q, kp, vp, tables, pos, nk, nv, act):
        if nk is not None:
            kp = _paged_cache_update(kp, nk, tables, pos, act)
            vp = _paged_cache_update(vp, nv, tables, pos, act)
        return paged_gqa_attention(q, kp, vp, tables, pos), kp, vp

    args = [None if a is None else jnp.asarray(a)
            for a in (q, kp, vp, tables, pos, nk, nv, active)]
    return [np.asarray(x) for x in jax.jit(ref)(*args)]


@pytest.mark.parametrize("t,active", [(1, None), (5, [True, False, False]),
                                      (3, [False, True, True])])
def test_write_targets_and_view_match_jax(t, active):
    import jax.numpy as jnp

    from dllama_tpu.ops.layers import paged_view as jax_view
    from dllama_tpu.ops.layers import paged_write_targets as jax_targets

    q, kp, _, tables, _, _ = _setup(3, 8, 4, 3, t, 4, 2)
    pos = np.array([0, 13, 29], np.int32)  # 29 + t - 1 runs past the table: clipped
    act = None if active is None else np.array(active)
    want = jax_targets(jnp.asarray(tables), jnp.asarray(pos), t, 8, kp.shape[0],
                       None if act is None else jnp.asarray(act))
    got = paged_write_targets(*_t(tables, pos), t, 8, kp.shape[0], *_t(act))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(paged_view(*_t(kp, tables)).numpy(),
                                  np.asarray(jax_view(jnp.asarray(kp), jnp.asarray(tables))))


@pytest.mark.parametrize("page,nb,t,group,pos,active", [
    (8, 8, 1, 1, [19, 1], None),                       # decode step, small page
    (16, 4, 5, 4, [35, 0], [True, False]),             # chunk across a page boundary
    (24, 3, 1, 4, [23, 47], [False, True]),            # last row of a page, trash row
    (64, 2, 32, 1, [63, 20], None),                    # wider than the fused cap
    (8, 8, 32, 4, [0, 3], None),                       # pre-scatter path, group 4
    (16, 4, 5, 1, [7, 7, 30], [False, True, False]),   # two trash rows collide
])
def test_k9_plain_matches_jax_gather(page, nb, t, group, pos, active):
    b = len(pos)
    q, kp, vp, tables, nk, nv = _setup(page + t, page, nb, b, t, 2 * group, 2)
    pos = np.array(pos, np.int32)
    act = None if active is None else np.array(active)
    want, kref, vref = _jax_reference(q, kp, vp, tables, pos, nk, nv, act)
    tq, tk, tv, ttab, tpos, tnk, tnv, tact = _t(q, kp, vp, tables, pos, nk, nv, act)
    out, k2, v2 = paged_decode_attention(tq, tk, tv, ttab, tpos, tnk, tnv, tact)
    assert k2 is tk and v2 is tv  # updated in place
    np.testing.assert_array_equal(tk.numpy(), kref)
    np.testing.assert_array_equal(tv.numpy(), vref)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)
    if active is not None:  # an inactive slot's own pages kept their contents
        for s in np.flatnonzero(~act):
            for pg in tables[s]:
                np.testing.assert_array_equal(tk.numpy()[pg], kp[pg])


@pytest.mark.parametrize("page,nb,pos", [(8, 8, [19, 1]), (24, 3, [51, 17]),
                                         (64, 2, [63, 127])])
def test_k9_read_only_matches_jax_gather(page, nb, pos):
    q, kp, vp, tables, _, _ = _setup(page, page, nb, 2, 1, 8, 2)
    pos = np.array(pos, np.int32)
    want, _, _ = _jax_reference(q, kp, vp, tables, pos)
    got = paged_decode_attention(*_t(q, kp, vp, tables, pos))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t,pos", [(1, [70, 5]), (3, [0, 100])])
def test_k8_plain_matches_pallas_interpret(t, pos):
    import jax.numpy as jnp

    from dllama_tpu.ops.pallas.flash_attention import paged_flash_gqa_attention as pallas

    q, kp, vp, tables, _, _ = _setup(11 + t, 64, 2, 2, t, 8, 2)
    pos = np.array(pos, np.int32)
    want = pallas(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
                  jnp.asarray(pos), interpret=True)
    got = paged_flash_gqa_attention(*_t(q, kp, vp, tables, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    q, kp, vp, tables, nk, nv = _t(*_setup(5, 16, 2, 2, 1, 4, 2))
    before = {**paged_attention.LAUNCHES, **flash_attention.LAUNCHES}
    paged_decode_attention(q, kp, vp, tables, 3, nk, nv)
    paged_flash_gqa_attention(q, kp, vp, tables, 3)
    assert {**paged_attention.LAUNCHES, **flash_attention.LAUNCHES} == before
    meta = [x.to("meta") for x in (q, kp, vp, tables)]
    with pytest.raises(ValueError, match="meta"):
        paged_decode_attention(*meta, 3)
    with pytest.raises(ValueError, match="multiple of 64"):
        paged_flash_gqa_attention(*meta, 3)


def test_capability_rules():
    assert paged_decode_supported((32, 128), 8)
    assert paged_decode_supported((32, 128), 24)
    assert paged_decode_supported((32, 64), 128, torch.float32)
    assert not paged_decode_supported((32, 128), 12)  # not a whole 8-row sub-tile
    assert not paged_decode_supported((32, 96), 128)  # head size not built
    assert not paged_decode_supported((32, 128), 128, torch.float16)
    assert paged_supported((32, 128), 128) and not paged_supported((32, 128), 24)
    assert FUSED_SCATTER_MAX_T == 16


@pytest.mark.parametrize("rows,bhkv,max_tiles", [(4, 64, 64), (4, 8, 1), (1024, 8, 64)])
def test_kv_splits_fill_the_card_within_the_table(rows, bhkv, max_tiles):
    """Splits of whole tiles that cover the table's tiles once; a decode
    step at full tables puts at least one block on every SM; a verify
    forward's rows (one query tile too) split alike."""
    splits, per = kv_splits(rows, bhkv, max_tiles, sms=132)
    assert 1 <= splits <= max_tiles
    assert (splits - 1) * per < max_tiles <= splits * per
    if max_tiles > 1 and rows <= 64:
        assert bhkv * splits >= 132  # at least one block per SM where the table allows
        assert kv_splits(36, bhkv, max_tiles, sms=132) == (splits, per)
    if max_tiles >= paged_attention.MIN_TILES_PER_SPLIT:
        assert per >= paged_attention.MIN_TILES_PER_SPLIT


def test_tile_constants_match_the_kernel():
    """The wrapper's tiles and blocks per SM are those of the attention body
    the paged source includes (attention.cuh, shared with flash attention),
    and the paged source has no tile of its own."""
    csrc = Path(__file__).resolve().parents[1] / "dllama_tpu_torch" / "ops" / "csrc"
    own = (csrc / "paged_attention.cu").read_text()
    assert '#include "attention.cuh"' in own
    assert not re.findall(r"constexpr int (\w+) = (\d+);", own)
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                          (csrc / "attention.cuh").read_text())}
    assert (c["TQ"], c["TS"], c["kMinBlocksPerSm"]) == (
        paged_attention.TQ, paged_attention.TS, paged_attention.BLOCKS_PER_SM)


class _Table:
    """A slot's table row that fails the test when an entry past `live`
    (the pages the slot's rows reach) is read, as the kernel must never do."""

    def __init__(self, row, live):
        self.row, self.live = row, live

    def __getitem__(self, i):
        assert i < self.live, f"table entry {i} read past the slot's {self.live} live pages"
        return int(self.row[i])


def _k9_sweep_model(q, kp, vp, tables, pos, live_pages, sms=132):
    """The kernel's sweep rebuilt in torch (f32): per (slot, KV head, 64-row
    query tile), 64-row KV tiles gathered row by row through the table up to
    the tile's horizon, split z taking tiles [z per, (z + 1) per) of the
    split rule, an online softmax per split, and the live splits merged in
    split order as attn_combine merges them."""
    b, t, hq, hd = q.shape
    hkv, page = kp.shape[1], kp.shape[2]
    nb = tables.shape[1]
    group, rows, S = hq // hkv, t * (hq // hkv), nb * page
    TQ, TS = paged_attention.TQ, paged_attention.TS
    splits, per = kv_splits(rows, b * hkv, -(-S // TS), sms)
    out = torch.zeros((b, t, hq, hd))
    for bi in range(b):
        tab = _Table(tables[bi], live_pages[bi])
        for kv in range(hkv):
            qf = q[bi, :, kv * group:(kv + 1) * group].reshape(rows, hd)  # t-major fold
            for r0 in range(0, rows, TQ):
                qt = qf[r0:r0 + TQ]
                qpos = pos[bi] + torch.arange(r0, r0 + qt.shape[0]) // group
                horizon = min(int(qpos[-1]), S - 1)
                n_tiles = horizon // TS + 1
                parts = []
                for z in range(splits):
                    if z * per >= n_tiles:
                        break  # the block exits; the combine skips it
                    m = torch.full((qt.shape[0], 1), -1e30)
                    l = torch.zeros((qt.shape[0], 1))
                    acc = torch.zeros((qt.shape[0], hd))
                    for tile in range(z * per, min(n_tiles, (z + 1) * per)):
                        keys = torch.arange(tile * TS, (tile + 1) * TS)
                        kt, vt = torch.zeros((TS, hd)), torch.zeros((TS, hd))
                        for r, s in enumerate(keys.tolist()):
                            if s <= horizon:
                                pg = tab[s // page]
                                kt[r], vt[r] = kp[pg, kv, s % page], vp[pg, kv, s % page]
                        ok = (keys[None, :] <= qpos[:, None]) & (keys[None, :] < S)
                        sc = torch.where(ok, qt @ kt.T / hd ** 0.5, torch.tensor(-1e30))
                        m_new = torch.maximum(m, sc.max(dim=1, keepdim=True).values)
                        p = torch.where(ok, torch.exp(sc - m_new), torch.tensor(0.0))
                        alpha = torch.exp(m - m_new)
                        l = alpha * l + p.sum(dim=1, keepdim=True)
                        acc = acc * alpha + p @ vt
                        m = m_new
                    parts.append((m, l, acc))
                if splits == 1:
                    m, l, acc = parts[0]
                    o = acc * (1 / torch.where(l == 0, torch.tensor(1.0), l))
                else:
                    mmax = torch.stack([p[0] for p in parts]).amax(dim=0)
                    num = torch.zeros_like(parts[0][2])
                    den = torch.zeros_like(parts[0][1])
                    for m, l, acc in parts:
                        w = torch.exp(m - mmax)
                        num, den = num + w * acc, den + w * l
                    o = num / torch.where(den == 0, torch.tensor(1.0), den)
                for i, R in enumerate(range(r0, r0 + qt.shape[0])):
                    out[bi, R // group, kv * group + R % group] = o[i]
    return out


@pytest.mark.parametrize("page,nb,t,pos,active", [
    (8, 48, 1, [0, 150, 383], [True, False, True]),   # a tile spans 8 pages
    (24, 16, 1, [23, 200, 330], None),                # pages across tile edges
    (128, 3, 1, [5, 127, 370], [False, True, True]),  # a page holds two tiles
    (8, 48, 20, [290, 40], [True, True]),              # a chunk: 2 query tiles, causal
    (24, 16, 17, [0, 333], [True, False]),
    (128, 3, 20, [200, 64], None),
])
def test_k9_sweep_model_matches_the_plain_gather(page, nb, t, pos, active):
    """The kernel's sweep (tiles gathered through ragged tables, the split
    rule, the combine order) against paged_gqa_attention after the plain
    scatter, inactive rows to the trash page; the model reads no table
    entry past a slot's live pages, which hold a bad page id."""
    b, hq, hkv = len(pos), 8, 2
    q, kp, vp, tables, nk, nv = _setup(page + t + nb, page, nb, b, t, hq, hkv)
    pos_np = np.array(pos, np.int32)
    live = [(min(p + t - 1, nb * page - 1)) // page + 1 for p in pos]
    ragged = tables.copy()
    for bi, n in enumerate(live):
        ragged[bi, n:] = 10 ** 6  # unallocated: any id; the model must not read it
    tq, tk, tv, tnk, tnv = _t(q, kp, vp, nk, nv)
    act = None if active is None else torch.tensor(active)
    alloc = torch.from_numpy(np.where(ragged == 10 ** 6, 0, ragged))  # the engine's zeros
    want, _, _ = paged_decode_attention(tq, tk, tv, alloc, torch.from_numpy(pos_np), tnk, tnv,
                                        act)
    got = _k9_sweep_model(tq, tk, tv, torch.from_numpy(ragged), pos, live)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
