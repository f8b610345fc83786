"""Parallelism tier on ``torch.distributed``: the mesh, the sharding rules,
the collectives of every axis, the GPipe stage schedule (``pipeline``),
ring attention and the process model (one process a rank, rank 0 driving;
``multihost``).

This package runs all five of the JAX package's axes (dp, pp, sp, tp, ep);
faults, warm restarts and sessions on a mesh are refused by name
(:class:`mesh.NotPorted`).
"""
