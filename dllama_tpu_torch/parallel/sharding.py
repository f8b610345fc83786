"""Sharding rules: the reference's TP decomposition, and the dp, sp, pp and
ep axes, per rank.

Maps one-to-one onto the reference's slicers (nn-core.cpp:170-238), as the
JAX package's ``parallel/sharding.py`` does with PartitionSpecs:

  sliceRowMatmul  (q/k/v/w1/w3/wcls, output-dim shard) -> 'tp' on out
  sliceColMatmul  (wo/w2, input-dim shard + merge-add) -> 'tp' on in
  sliceKvCache / sliceMultiHeadAtt (head shard)        -> kv heads / tp

A spec is a tuple of axis names or None a dim (the PartitionSpec's
entries). Where JAX hands the spec to GSPMD, here each rank slices its own
block of every leaf: rank r of tp takes the r-th of tp equal blocks of each
'tp' dim, as a contiguous tensor (the kernels refuse a strided weight).
The wo and w2 partial sums are all-reduced by the layer
(``models/llama.py``), the vocab-sharded logits all-gathered.

On pp every layer leaf's leading axis is 'pp' (stage s holds the layers
[s L/pp, (s+1) L/pp), parallel/pipeline), the embedding, final norm and
wcls keep their tp specs and are replicated over pp, as JAX's
``pp_param_specs`` places them. On ep an MoE model's expert stacks
[L, E, in, out] split their expert axis (rank e the experts
[e E/ep, (e+1) E/ep)); everything else, the router included, is
replicated over ep.

Weights are replicated over dp and sp. The KV cache [L, B, Hkv, S, d] is
JAX's ``P(pp?, dp?, "tp", "sp", None)`` (cache_spec): a stage holds its
layers, a dp replica its block of the batch
(:meth:`LlamaShardings.batch_block`: replica d the slots
[d B/dp, (d+1) B/dp) when dp divides B, every slot otherwise), an sp rank
its block of the rows (:meth:`LlamaShardings.seq_block`);
:meth:`LlamaShardings.cache_block` is a rank's whole block, which a
session's save gathers and its load scatters. :meth:`LlamaShardings.leaf_block`
is where a rank's parameter leaf lies in the unsharded tree (a session's
fingerprint hashes the unsharded tree on every rank).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dllama_tpu_torch.models.config import LlamaConfig
from dllama_tpu_torch.ops.quant import Q8Tensor, QTensor

# specs for stacked per-layer weights: leading L axis, then (in, out)
_ROW_SHARD = (None, None, "tp")  # output-dim sharded (reference "row" slice)
_COL_SHARD = (None, "tp", None)  # input-dim sharded (reference "col" slice)

LAYER_SPECS = {
    "wq": _ROW_SHARD,
    "wk": _ROW_SHARD,
    "wv": _ROW_SHARD,
    "w1": _ROW_SHARD,
    "w3": _ROW_SHARD,
    "wo": _COL_SHARD,
    "w2": _COL_SHARD,
    "rms_att": (None, None),
    "rms_ffn": (None, None),
    # MoE: leaves are [L, E, in, out]; per-expert in/out dims keep the tp
    # pattern, the expert axis is 'ep'; the gate is replicated
    "moe_gate": (None, None, None),
    "moe_w1": (None, "ep", None, "tp"),
    "moe_w3": (None, "ep", None, "tp"),
    "moe_w2": (None, "ep", "tp", None),
}


@dataclasses.dataclass
class LocalLlamaConfig(LlamaConfig):
    """The config as one rank sees it: its heads, kv heads and FFN width
    (``hidden_dim``; the full width where the FFN is replicated), with
    ``dim`` the model's residual width. ``head_size`` and ``kv_dim``
    follow the rank's heads. On pp ``n_layers`` is the stage's layer count
    (:meth:`LlamaShardings.layer_range` its global indices). On ep the rank
    holds ``n_experts // ep`` experts from ``expert_offset``;
    ``n_experts`` and ``n_active_experts`` stay the model's, as the
    router's top-k runs over every expert. ``seq_len`` stays the model's
    on sp (positions and RoPE rows are global); the rows and slots a
    rank's cache holds are :meth:`LlamaShardings.seq_block` and
    ``batch_block``."""

    tp: int = 1
    ep: int = 1
    expert_offset: int = 0

    @property
    def head_size(self) -> int:
        return self.dim // (self.n_heads * self.tp)

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_size


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape)


class LlamaShardings:
    """Placement rules bound to one rank's :class:`parallel.mesh.Mesh`."""

    def __init__(self, mesh, cfg: LlamaConfig):
        self.mesh = mesh
        self.cfg = cfg
        self.check(mesh.config, cfg)
        # the unsharded tree's digest (engine/engine.params_digest), set when
        # a world builds its engines (parallel/multihost._join)
        self.params_digest: str | None = None

    @staticmethod
    def check(config, cfg: LlamaConfig) -> None:
        """Raise for a mesh this package cannot run `cfg` on (before any
        rank is spawned), with the JAX package's messages: a kv-head count
        tp does not divide, a context sp does not divide, a layer count pp
        does not divide, pp with sp."""
        if cfg.n_kv_heads % config.tp != 0:
            # the reference's hard requirement nNodes <= nKvHeads (app.cpp:201-203);
            # ours is divisibility of the kv-head axis.
            raise ValueError(f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={config.tp}")
        if cfg.seq_len % max(config.sp, 1) != 0:
            raise ValueError(f"seq_len={cfg.seq_len} not divisible by sp={config.sp}")
        if config.pp > 1:
            if cfg.n_layers % config.pp != 0:
                raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={config.pp}")
            if config.sp > 1:
                raise ValueError("pp x sp composition is not supported; use pp with tp/dp")

    @property
    def tp(self) -> int:
        return self.mesh.shape["tp"]

    @property
    def sp(self) -> int:
        return self.mesh.shape["sp"]

    @property
    def dp(self) -> int:
        return self.mesh.shape["dp"]

    @property
    def pp(self) -> int:
        return self.mesh.shape["pp"]

    @property
    def ep(self) -> int:
        return self.mesh.shape["ep"]

    def _batch_axis(self, batch: int) -> str | None:
        """The batch shards over dp only when divisible (a single sequence
        stays replicated over dp), as in the JAX package."""
        return "dp" if batch % self.dp == 0 else None

    def batch_block(self, batch: int) -> tuple[int, int]:
        """[lo, hi) of the batch rows (slots) this rank holds: replica d of
        dp the d-th of dp contiguous blocks, as ``P("dp")`` places them; the
        whole batch where it is replicated over dp."""
        if self.dp == 1 or self._batch_axis(batch) is None:
            return 0, batch
        n = batch // self.dp
        d = self.mesh.coords["dp"]
        return d * n, (d + 1) * n

    def seq_block(self, seq_len: int) -> tuple[int, int]:
        """(offset, rows) of the cache's sequence rows this rank holds: rank
        r of sp the rows [r S/sp, (r+1) S/sp)."""
        if seq_len % self.sp:
            raise ValueError(f"seq_len={seq_len} not divisible by sp={self.sp}")
        rows = seq_len // self.sp
        return self.mesh.coords["sp"] * rows, rows

    def cache_block(self, batch: int, seq_len: int, rank: int | None = None
                    ) -> tuple[slice, ...]:
        """Rank `rank`'s block (default: this rank's) of the unsharded KV
        cache [L, batch, Hkv, seq_len, d] of an engine of `batch` rows: its
        stage's layers (pp), its slots (dp, where dp divides the batch), its
        kv heads (tp) and its sequence rows (sp). A rank's own cache is this
        block, with an sp rank's trash row after its rows."""
        sh = self if rank is None else LlamaShardings(
            dataclasses.replace(self.mesh, rank=rank), self.cfg)
        layers = sh.layer_range()
        lo, hi = sh.batch_block(batch)
        hk = self.cfg.n_kv_heads // self.tp
        h0 = sh.mesh.coords["tp"] * hk
        off, rows = sh.seq_block(seq_len)
        return (slice(layers.start, layers.stop), slice(lo, hi), slice(h0, h0 + hk),
                slice(off, off + rows), slice(None))

    # ---------------------------------------------------------------- specs

    def _sanitize(self, spec: tuple, *shapes) -> tuple:
        """Replicate any spec axis that does not evenly divide the leaf's dim
        (for every given shape): an oddly-sized tensor (e.g. a
        non-power-of-two vocab on wcls) loads replicated rather than
        failing — the reference refuses such configs (nNodes must divide
        every slice, nn-core.cpp:170-238)."""
        n = max(len(s) for s in shapes)
        axes = list(spec) + [None] * (n - len(spec))
        out = []
        for i, ax in enumerate(axes):
            if ax is not None and any(
                len(s) > i and s[i] % self.mesh.shape[ax] != 0 for s in shapes
            ):
                ax = None
            out.append(ax)
        return tuple(out)

    def _expand(self, spec: tuple, leaf):
        """Spec for one leaf (a QTensor's packed bytes and scales share one
        spec — both are [in?, out] shaped; so do a Q8Tensor's codes and
        scales). Lazy Q40 leaves follow the same rule."""
        from dllama_tpu_torch.models.formats import LazyQ40, LazyQ40Stack

        if isinstance(leaf, (QTensor, Q8Tensor, LazyQ40, LazyQ40Stack)):
            tp = self.tp
            if isinstance(leaf, QTensor):
                kdim = leaf.scales.shape[-2]
                shapes = (_shape(leaf.packed), _shape(leaf.scales))
            elif isinstance(leaf, Q8Tensor):
                kdim = leaf.scales.shape[-2]
                shapes = (_shape(leaf.codes), _shape(leaf.scales))
            else:
                kdim = leaf.scales_shape[-2]
                shapes = (leaf.packed_shape, leaf.scales_shape)
            if len(spec) >= 2 and spec[-2] == "tp" and kdim % tp != 0:
                # 'tp' on the contraction dim splits the 32-elem quant-block
                # axis: it must hold tp whole blocks (col-shard, moe_w2)
                raise ValueError(
                    f"Q40 col-shard needs in_dim % (32*tp) == 0; "
                    f"got {kdim * 32} with tp={tp}")
            spec = self._sanitize(spec, *shapes)
            return QTensor(spec, spec)
        if hasattr(leaf, "shape"):
            spec = self._sanitize(spec, _shape(leaf))
        return spec

    def layer_range(self) -> range:
        """The global indices of the layers this rank's stage holds."""
        n = self.cfg.n_layers // self.pp
        return range(self.mesh.coords["pp"] * n, (self.mesh.coords["pp"] + 1) * n)

    def _spec(self, name: str) -> tuple:
        """The spec of a named leaf before _sanitize."""
        if name == "embedding":
            return (None, None)  # replicated; vocab shard lives on wcls
        if name == "final_norm":
            return (None,)
        if name == "wcls":
            return (None, "tp")
        spec = LAYER_SPECS[name.split(".")[-1]]
        if self.pp > 1:
            # stage-split: the stacked layer axis shards over 'pp'
            spec = ("pp", *spec[1:])
        return spec

    def param_spec(self, name: str, leaf):
        """Spec for a named param leaf ('embedding', 'wcls', 'layers.<short>').
        A layer leaf's leading axis is on 'pp'; the shard-direct load's
        one-layer leaves (models/formats.load_params ``layer_range``) keep it
        whole, as _sanitize replicates an axis pp does not divide."""
        return self._expand(self._spec(name), leaf)

    def _splits(self, name: str, ax: str) -> bool:
        """Whether axis `ax` of leaf `name`'s spec splits the stacked leaf
        (what _sanitize decides from the full shapes, told from the model:
        pp and the heads always divide (check), the FFN and the vocab where
        tp divides them, the experts where ep does)."""
        if ax == "ep":
            return self.splits_experts
        if ax == "tp" and name == "wcls":
            return self.logits_sharded
        if ax == "tp" and name.split(".")[-1] in ("w1", "w2", "w3", "moe_w1", "moe_w2",
                                                   "moe_w3"):
            return self.ffn_sharded
        return True

    def leaf_block(self, name: str, shape) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(the unsharded tree's shape, this rank's offset in it) of a leaf
        of this rank's tree of `shape` (a QTensor's packed bytes and scales
        alike)."""
        full, start = list(shape), [0] * len(shape)
        coords, sizes = self.mesh.coords, self.mesh.shape
        for i, ax in enumerate(self._spec(name)[: len(shape)]):
            if ax is not None and sizes[ax] > 1 and self._splits(name, ax):
                start[i] = coords[ax] * full[i]
                full[i] *= sizes[ax]
        return tuple(full), tuple(start)

    def param_spec_tree(self, params) -> dict:
        """A tree of specs congruent with the params tree."""
        return {
            "embedding": self.param_spec("embedding", params["embedding"]),
            "final_norm": self.param_spec("final_norm", params["final_norm"]),
            "wcls": self.param_spec("wcls", params["wcls"]),
            "layers": {name: self.param_spec(f"layers.{name}", leaf)
                       for name, leaf in params["layers"].items()},
        }

    # ------------------------------------------------------------- slicing

    def _bounds(self, spec: tuple, shape: tuple) -> tuple[slice, ...]:
        """This rank's block of a leaf of `shape` under `spec`."""
        coords = self.mesh.coords
        out = []
        for i, n in enumerate(shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None or self.mesh.shape[ax] == 1:
                out.append(slice(None))
            else:
                size = n // self.mesh.shape[ax]
                out.append(slice(coords[ax] * size, (coords[ax] + 1) * size))
        return tuple(out)

    def _slice(self, x, spec: tuple, device, dtype=None) -> torch.Tensor:
        """x's block on this rank as a contiguous tensor of its own on
        `device` (never a view that keeps the full leaf alive)."""
        block = x[self._bounds(spec, _shape(x))]
        if isinstance(block, np.ndarray):
            return torch.from_numpy(np.array(block)).to(device=device, dtype=dtype)
        out = block.to(device=device, dtype=dtype or block.dtype).contiguous()
        return out.clone() if out.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr() else out

    @property
    def splits_weights(self) -> bool:
        """Whether a rank holds less than the whole tree: tp splits the
        matmuls, pp the layers, ep an MoE model's experts (dp and sp
        replicate every weight)."""
        return self.tp > 1 or self.pp > 1 or self.splits_experts

    @property
    def splits_experts(self) -> bool:
        """ep splits an MoE model's expert stacks where it divides them;
        otherwise _sanitize replicates them and every rank runs them all."""
        return self.ep > 1 and self.cfg.n_experts > 0 and self.cfg.n_experts % self.ep == 0

    def is_full(self, params: dict) -> bool:
        """True when `params` is the model's full tree, False when it is
        already one rank's (a shard-direct load's): wq's layer count and
        output dim, and an MoE model's expert count, tell."""
        layers = params["layers"]
        wq = tuple(layers["wq"].shape)
        full = wq[0] == self.cfg.n_layers and wq[-1] == self.cfg.dim
        if "moe_w1" in layers:
            full = full and tuple(layers["moe_w1"].shape)[1] == self.cfg.n_experts
        return full

    def put(self, name: str, leaf, device, dtype=None):
        """This rank's shard of one full param leaf (a dense tensor or
        numpy array, a QTensor or Q8Tensor, or a lazy Q40 leaf) on `device`.
        A lazy Q40 leaf decodes only its shard's byte ranges off the
        memmap (``models/formats.LazyQ40``); ``dtype`` casts a dense leaf."""
        from dllama_tpu_torch.models.formats import LazyQ40, LazyQ40Stack

        spec = self.param_spec(name, leaf)
        if isinstance(leaf, (LazyQ40, LazyQ40Stack)):
            rec = leaf.records(*self._bounds(spec.packed, leaf.packed_shape))
            return QTensor.from_records(torch.from_numpy(rec).to(device))
        if isinstance(leaf, QTensor):
            return QTensor(self._slice(leaf.packed, spec.packed, device),
                           self._slice(leaf.scales, spec.packed, device))
        if isinstance(leaf, Q8Tensor):
            return Q8Tensor(self._slice(leaf.codes, spec.packed, device),
                            self._slice(leaf.scales, spec.packed, device))
        return self._slice(leaf, spec, device, dtype)

    def put_params(self, params: dict, device) -> dict:
        """This rank's tree on `device`: a full tree sliced leaf by leaf, an
        already local one moved as it is. Where no axis splits a weight
        (:attr:`splits_weights`) every leaf is whole on every rank, so a
        tree of tensors moves as it is (no copy on its own device)."""
        full = self.is_full(params)

        def one(name, leaf):
            mine = isinstance(leaf, (torch.Tensor, QTensor, Q8Tensor)) and \
                (not self.splits_weights or not full)
            if not mine:
                return self.put(name, leaf, device)
            if isinstance(leaf, QTensor):
                return QTensor(leaf.packed.to(device), leaf.scales.to(device))
            if isinstance(leaf, Q8Tensor):
                return Q8Tensor(leaf.codes.to(device), leaf.scales.to(device))
            return leaf.to(device)

        return {
            "embedding": one("embedding", params["embedding"]),
            "final_norm": one("final_norm", params["final_norm"]),
            "wcls": one("wcls", params["wcls"]),
            "layers": {k: one(f"layers.{k}", v) for k, v in params["layers"].items()},
        }

    # -------------------------------------------------------- local views

    @property
    def ffn_sharded(self) -> bool:
        """The FFN (w1/w3 out, w2 in; an MoE's per expert) splits over tp
        where tp divides the hidden width; otherwise _sanitize replicates
        it, and its output needs no reduce."""
        return self.tp > 1 and self.cfg.hidden_dim % self.tp == 0

    @property
    def logits_sharded(self) -> bool:
        """wcls splits its vocab over tp where tp divides it; otherwise it is
        replicated and the logits need no gather."""
        return self.tp > 1 and self.cfg.vocab_size % self.tp == 0

    def local_config(self) -> LocalLlamaConfig:
        """The config one rank's forward runs: heads and kv heads / tp, the
        FFN width this rank holds, its stage's layers (pp) and its experts
        (ep, where ep divides them; otherwise _sanitize replicates the
        stacks)."""
        cfg, tp, pp = self.cfg, self.tp, self.pp
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        if isinstance(cfg, LocalLlamaConfig):
            raise ValueError("the shardings take the model's config, not a rank's")
        coords = self.mesh.coords
        ep = self.ep if self.splits_experts else 1
        fields.update(n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
                      hidden_dim=cfg.hidden_dim // tp if self.ffn_sharded else cfg.hidden_dim,
                      n_layers=cfg.n_layers // pp, tp=tp, ep=ep,
                      expert_offset=coords["ep"] * (cfg.n_experts // ep) if ep > 1 else 0)
        return LocalLlamaConfig(**fields)
