"""The device mesh: the JAX package's five named axes, of which this
package runs ``tp`` (the reference's one axis: the node count every matmul
and the KV heads are split over, SURVEY.md §2.4).

:class:`MeshConfig`, :meth:`MeshConfig.parse` and :func:`auto_mesh_config`
return what the JAX package's return (``dllama_tpu/parallel/mesh.py``).
:class:`Mesh` is one rank's view of a world: its size, its rank, its
coordinate on each axis and the ``tp`` process group. Under PyTorch each
rank is a process of its own (``parallel/multihost.py``), where JAX drives
every device from one controller.
"""

from __future__ import annotations

import dataclasses

AXES = ("dp", "pp", "sp", "tp", "ep")
#: the axes this package runs; a larger size on any other is NotPorted
PORTED_AXES = ("tp",)


class NotPorted(ValueError):
    """A mesh axis (or an option on a mesh) this package does not run yet."""


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

    def check_ported(self) -> None:
        """Raise NotPorted naming the first axis larger than 1 that this
        package does not run."""
        for ax in AXES:
            if ax not in PORTED_AXES and getattr(self, ax) > 1:
                raise NotPorted(f"the mesh axis {ax} ({ax}={getattr(self, ax)})")


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


@dataclasses.dataclass
class Mesh:
    """One rank's view of the world: ``config`` (the axis sizes), this
    process's global ``rank``, the ``tp`` process group (None for a mesh of
    one, or the default group) and the backend it runs over. Ranks are laid
    out as the JAX package's device grid, tp innermost: with only tp ported
    the tp coordinate is the rank."""

    config: MeshConfig
    rank: int = 0
    group: object = None
    backend: str = "gloo"
    staged: bool = False  # gloo over CUDA tensors: exchanges through pinned host memory

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.config.axis_sizes()))

    @property
    def size(self) -> int:
        return self.config.n_devices

    @property
    def tp(self) -> int:
        return self.config.tp

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis (row-major over AXES)."""
        out, r = {}, self.rank
        for ax, n in reversed(list(zip(AXES, self.config.axis_sizes()))):
            out[ax] = r % n
            r //= n
        return {ax: out[ax] for ax in AXES}
