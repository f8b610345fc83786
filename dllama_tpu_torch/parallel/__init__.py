"""Parallelism tier on ``torch.distributed``: the mesh, the sharding rules,
the collectives of every axis, the GPipe stage schedule (``pipeline``),
ring attention and the process model (one process a rank, rank 0 driving;
``multihost``).

This package runs all five of the JAX package's axes (dp, pp, sp, tp, ep),
and supervision on every mesh: fault injection (rank 0's plan, sent to the
followers), warm restarts, sessions (gathered to and read by rank 0) and a
heartbeat watch over every rank (``multihost``).
"""
