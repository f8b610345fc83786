"""The port's ring / sequence-parallel attention (``parallel/ring_attention``)
against the JAX package's, on the CPU.

The port's primitives run in a 2-rank and a 4-rank gloo world (each rank a
process running this file as a script, module-scoped: one world of each
size serves every case); JAX's run under ``shard_map`` on the test
process's virtual CPU devices, on an sp mesh of the same size. The grids
are JAX's own (tests/test_ring_attention.py): ``ring_attention`` causal
and not at (sp, hq, hkv) of (4, 8, 2) and (2, 4, 2); ``sp_cache_attention``
at (t, pos) of (1, 17), (4, 8), (8, 0), plus (1, 3), where the shards of
ranks 1.. lie wholly past the query; ``ring_cache_attention`` at (8, 0),
(8, 8), (16, 16). The bound is JAX's, atol 2e-5 and rtol 1e-4. Each
rank's byte counters are held against the shapes exchanged.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
ATOL, RTOL = 2e-5, 1e-4  # JAX's own bound (tests/test_ring_attention.py)
B, D = 2, 16  # batch and head size of every case
CACHE = dict(hq=8, hkv=4, s=32)  # the cache cases' heads and rows

RING = [(4, 8, 2, True), (4, 8, 2, False), (2, 4, 2, True), (2, 4, 2, False)]
SP_CACHE = [(1, 17), (4, 8), (8, 0), (1, 3)]
RING_CACHE = [(8, 0), (8, 8), (16, 16)]


def _cases(sp: int) -> dict:
    """name -> inputs of every case a world of `sp` ranks runs (the full
    tensors; each rank takes its shard)."""
    rng = np.random.default_rng(100 + sp)
    out = {}
    for s, hq, hkv, causal in RING:
        if s != sp:
            continue
        t = 64 if causal else 32
        out[f"ring_{hq}_{hkv}_{int(causal)}"] = dict(
            q=rng.standard_normal((B, t, hq, D)).astype(np.float32),
            k=rng.standard_normal((B, hkv, t, D)).astype(np.float32),
            v=rng.standard_normal((B, hkv, t, D)).astype(np.float32),
            causal=np.array(causal))
    for kind, grid in (("lse", SP_CACHE), ("ringc", RING_CACHE)):
        for t, pos in grid:
            out[f"{kind}_{t}_{pos}"] = dict(
                q=rng.standard_normal((B, t, CACHE["hq"], D)).astype(np.float32),
                k=rng.standard_normal((B, CACHE["hkv"], CACHE["s"], D)).astype(np.float32),
                v=rng.standard_normal((B, CACHE["hkv"], CACHE["s"], D)).astype(np.float32),
                pos=np.array(pos))
    return out


# ---------------------------------------------------------------- a rank


def _rank_main(rank: int, world: int, rdv: str, inputs: str, out: str) -> None:
    """One rank of the world: every case on its shard; its outputs, its
    byte counters, and the (1, 3) case's partials of its own shard."""
    import torch
    import torch.distributed as dist

    from dllama_tpu_torch.parallel import collectives, mesh as pmesh, multihost
    from dllama_tpu_torch.parallel import ring_attention as ra

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world)
    config = pmesh.MeshConfig(sp=world)
    groups = multihost.make_groups(config, rank)
    ex = collectives.TPExchange(pmesh.Mesh(config, rank, None, "gloo", False, groups))
    axis = ex.sp
    res = {}
    with np.load(inputs) as data:
        names = sorted({k.split("/")[0] for k in data.files})
        for name in names:
            c = {k.split("/")[1]: data[k] for k in data.files if k.startswith(name + "/")}
            q, k, v = (torch.from_numpy(c[x]) for x in ("q", "k", "v"))
            ex.open_forward()
            if name.startswith("ring_"):
                tl, sl = q.shape[1] // world, k.shape[2] // world
                got = ra.ring_attention(q[:, rank * tl : (rank + 1) * tl],
                                        k[:, :, rank * sl : (rank + 1) * sl],
                                        v[:, :, rank * sl : (rank + 1) * sl], axis,
                                        causal=bool(c["causal"]))
            else:
                pos = torch.tensor(int(c["pos"]))
                sl = k.shape[2] // world
                kl, vl = k[:, :, rank * sl : (rank + 1) * sl], v[:, :, rank * sl : (rank + 1) * sl]
                if name.startswith("lse_"):
                    got = ra.sp_cache_attention(q, kl, vl, pos, axis)
                else:
                    tl = q.shape[1] // world
                    got = ra.ring_cache_attention(q[:, rank * tl : (rank + 1) * tl], kl, vl,
                                                  pos, axis)
                if name == "lse_1_3":
                    hkv, g = kl.shape[1], q.shape[2] // kl.shape[1]
                    slot = rank * sl + torch.arange(sl)[None, None, :]
                    mask = (slot <= int(pos))[:, None, None]
                    o, m, l = ra._partial_attn(q.reshape(B, 1, hkv, g, D), kl, vl, mask,
                                               1.0 / D ** 0.5)
                    res[name + "/part_o"] = o.numpy()
                    res[name + "/part_l"] = l.numpy()
            ex.close_forward(0, 0)
            res[name + "/out"] = got.numpy()
            for op, n in ex.forward_bytes[(0, 0)].items():
                res[f"{name}/bytes/{op}"] = np.array(n)
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


# ----------------------------------------------------------------- worlds


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """sp -> (inputs, [each rank's results]) of a 2-rank and a 4-rank world,
    both started at once."""
    tmp = tmp_path_factory.mktemp("ring")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    procs, inputs = [], {}
    for sp in (2, 4):
        inputs[sp] = _cases(sp)
        path = tmp / f"in{sp}.npz"
        np.savez(path, **{f"{n}/{k}": a for n, c in inputs[sp].items() for k, a in c.items()})
        for r in range(sp):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(sp), str(tmp / f"rdv{sp}"), str(path),
                 str(tmp / f"out{sp}_{r}.npz")], cwd=ROOT, env=env, stderr=subprocess.PIPE,
                text=True))
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)
    out = {}
    for sp in (2, 4):
        ranks = []
        for r in range(sp):
            with np.load(tmp / f"out{sp}_{r}.npz") as data:
                ranks.append({k: data[k] for k in data.files})
        out[sp] = (inputs[sp], ranks)
    return out


def _jax_mesh(sp):
    from dllama_tpu.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(sp=sp))


def _jax(fn, sp, in_specs, out_spec, *args):
    import jax

    from dllama_tpu.parallel import shard_map as _shard_map

    return np.asarray(jax.jit(_shard_map(fn, mesh=_jax_mesh(sp), in_specs=in_specs,
                                         out_specs=out_spec))(*args))


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("sp,hq,hkv,causal", RING)
def test_ring_attention_matches_jax(worlds, sp, hq, hkv, causal):
    from jax.sharding import PartitionSpec as P

    from dllama_tpu.parallel.ring_attention import ring_attention

    inputs, ranks = worlds[sp]
    name = f"ring_{hq}_{hkv}_{int(causal)}"
    c = inputs[name]
    want = _jax(lambda q, k, v: ring_attention(q, k, v, axis_name="sp", causal=causal), sp,
                (P(None, "sp", None, None), P(None, None, "sp", None),
                 P(None, None, "sp", None)), P(None, "sp", None, None), c["q"], c["k"], c["v"])
    got = np.concatenate([r[name + "/out"] for r in ranks], axis=1)  # queries by rank
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("t,pos", SP_CACHE)
def test_sp_cache_attention_matches_jax(worlds, sp, t, pos):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dllama_tpu.parallel.ring_attention import sp_cache_attention

    inputs, ranks = worlds[sp]
    name = f"lse_{t}_{pos}"
    c = inputs[name]
    want = _jax(lambda q, k, v, p: sp_cache_attention(q, k, v, p, axis_name="sp"), sp,
                (P(None, None, None, None), P(None, None, "sp", None),
                 P(None, None, "sp", None), P()), P(None, None, None, None),
                c["q"], c["k"], c["v"], jnp.int32(pos))
    for r in ranks:  # the merged output is every rank's
        np.testing.assert_allclose(r[name + "/out"], want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(ranks[0][name + "/out"], ranks[-1][name + "/out"])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("t,pos", RING_CACHE)
def test_ring_cache_attention_matches_jax(worlds, sp, t, pos):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dllama_tpu.parallel.ring_attention import ring_cache_attention

    inputs, ranks = worlds[sp]
    name = f"ringc_{t}_{pos}"
    c = inputs[name]
    want = _jax(lambda q, k, v, p: ring_cache_attention(q, k, v, p, axis_name="sp"), sp,
                (P(None, "sp", None, None), P(None, None, "sp", None),
                 P(None, None, "sp", None), P()), P(None, "sp", None, None),
                c["q"], c["k"], c["v"], jnp.int32(pos))
    got = np.concatenate([r[name + "/out"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_a_shard_past_the_query_contributes_exactly_zero(worlds, sp):
    """Decode at pos 3: every rank but 0 holds rows wholly past the query.
    Their partials are exactly zero (the finite NEG and the second where),
    and the merged output is finite."""
    _, ranks = worlds[sp]
    for r in ranks[1:]:
        assert not r["lse_1_3/part_o"].any() and not r["lse_1_3/part_l"].any()
    assert np.isfinite(ranks[0]["lse_1_3/out"]).all()
    assert ranks[0]["lse_1_3/part_l"].min() > 0  # rank 0's rows 0..3 are live


@pytest.mark.parametrize("sp", [2, 4])
def test_byte_counts_match_the_shapes(worlds, sp):
    """Each rank counts its collectives' result bytes (f32): the LSE merge
    all-reduces the row maxima [B, Hkv, G, T] and the numerators with the
    denominators [B, Hkv, G, T, d+1]; the ring permutes its K and V blocks
    [B, Hkv, S/sp, d] sp-1 times."""
    _, ranks = worlds[sp]
    hq, hkv, s = CACHE["hq"], CACHE["hkv"], CACHE["s"]
    g = hq // hkv
    want = {}
    for t, pos in SP_CACHE:
        want[f"lse_{t}_{pos}"] = {"sp:all-reduce": 4 * (B * hkv * g * t * (1 + D + 1))}
    for t, pos in RING_CACHE:
        want[f"ringc_{t}_{pos}"] = {"sp:collective-permute":
                                    4 * (sp - 1) * 2 * B * hkv * (s // sp) * D}
    for s_, hq_, hkv_, causal in RING:
        if s_ == sp:
            t = 64 if causal else 32
            want[f"ring_{hq_}_{hkv_}_{int(causal)}"] = {
                "sp:collective-permute": 4 * (sp - 1) * 2 * B * hkv_ * (t // sp) * D}
    for r in ranks:
        got = {}
        for key, n in r.items():
            if "/bytes/" in key:
                name, _, op = key.split("/", 2)
                got.setdefault(name, {})[op] = int(n)
        assert got == want


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
