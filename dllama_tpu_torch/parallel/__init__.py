"""Parallelism tier on ``torch.distributed``: the mesh, the sharding rules,
the collectives of the tensor-parallel exchange and the process model
(one process a rank, rank 0 driving; ``multihost``).

Of the JAX package's five axes this package runs ``tp``; a mesh with
``dp``, ``sp``, ``pp`` or ``ep`` larger than 1 is refused by name
(:class:`mesh.NotPorted`).
"""
