"""The device mesh: the JAX package's five named axes, all of which this
package runs: ``dp`` (replicas over the batch), ``pp`` (GPipe stages over
the layers, parallel/pipeline), ``sp`` (the KV cache's sequence axis, ring
attention), ``tp`` (the reference's one axis: the node count every matmul
and the KV heads are split over, SURVEY.md §2.4) and ``ep`` (an MoE
model's experts split over ranks).

:class:`MeshConfig`, :meth:`MeshConfig.parse` and :func:`auto_mesh_config`
return what the JAX package's return (``dllama_tpu/parallel/mesh.py``).
:class:`Mesh` is one rank's view of a world: its size, its rank, its
coordinate on each axis and the process group of each axis. Under
PyTorch each rank is a process of its own (``parallel/multihost.py``),
where JAX drives every device from one controller.
"""

from __future__ import annotations

import dataclasses

import numpy as np

AXES = ("dp", "pp", "sp", "tp", "ep")


class NotPorted(ValueError):
    """An option this package does not run on a mesh yet (faults, warm
    restarts, sessions)."""


class MeshTooLarge(ValueError):
    """A mesh of more ranks than the cards the processes see."""


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> tuple[int, ...]:
        return (self.dp, self.pp, self.sp, self.tp, self.ep)

    @classmethod
    def parse(cls, spec: str) -> "MeshConfig":
        """Parse 'tp=4,dp=2' style CLI strings."""
        kwargs = {}
        for part in spec.split(","):
            if not part:
                continue
            k, _, v = part.partition("=")
            if k not in AXES:
                raise ValueError(f"unknown mesh axis {k!r}; valid: {AXES}")
            kwargs[k] = int(v)
        return cls(**kwargs)


def auto_mesh_config(n_devices: int, n_kv_heads: int, want_sp: bool = False) -> MeshConfig:
    """Pick a (dp, sp, tp) factoring for n devices.

    tp is capped at n_kv_heads (the reference's nNodes <= nKvHeads rule,
    app.cpp:201-203 — each shard needs >= 1 KV head); the remainder goes to
    sp (if requested) then dp.
    """
    tp = 1
    for d in range(min(n_devices, n_kv_heads), 0, -1):
        if n_devices % d == 0 and n_kv_heads % d == 0:
            tp = d
            break
    rest = n_devices // tp
    sp = 1
    if want_sp and rest % 2 == 0:
        sp = 2
        rest //= 2
    return MeshConfig(dp=rest, sp=sp, tp=tp)


def axis_ranks(config: MeshConfig, axis: str) -> list[list[int]]:
    """The global ranks of every group of `axis`, each in the order of its
    coordinate on the axis, the groups in row-major order of the other
    coordinates: the JAX package's device grid (row-major over AXES, tp
    innermost) cut along one axis. Every rank makes every group in this
    order (parallel/multihost)."""
    sizes = config.axis_sizes()
    i = AXES.index(axis)
    ranks = np.moveaxis(np.arange(config.n_devices).reshape(sizes), i, -1)
    return [[int(r) for r in row] for row in ranks.reshape(-1, sizes[i])]


@dataclasses.dataclass
class Mesh:
    """One rank's view of the world: ``config`` (the axis sizes), this
    process's global ``rank``, the process group of each axis
    (``groups``: None on an axis of one; ``group`` is the tp one) and the
    backend they run over. Ranks are laid out as the JAX package's device
    grid, row-major over AXES with tp innermost (:attr:`coords`)."""

    config: MeshConfig
    rank: int = 0
    group: object = None
    backend: str = "gloo"
    staged: bool = False  # gloo over CUDA tensors: exchanges through pinned host memory
    groups: dict = dataclasses.field(default_factory=dict)  # axis -> its process group

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.config.axis_sizes()))

    @property
    def size(self) -> int:
        return self.config.n_devices

    @property
    def tp(self) -> int:
        return self.config.tp

    def axis_group(self, axis: str):
        """(process group, this rank's index on `axis`, the group's global
        ranks in index order); the tp group is ``group``."""
        ranks = next(r for r in axis_ranks(self.config, axis) if self.rank in r)
        group = self.group if axis == "tp" else self.groups.get(axis)
        return group, ranks.index(self.rank), ranks

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (row-major over AXES)."""
        out, r = {}, self.rank
        for ax, n in reversed(list(zip(AXES, self.config.axis_sizes()))):
            out[ax] = r % n
            r //= n
        return {ax: out[ax] for ax in AXES}
