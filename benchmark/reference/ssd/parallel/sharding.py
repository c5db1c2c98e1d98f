"""``shard_bounds`` of the port's ``parallel/sharding.py``."""
import numpy as np


def shard_bounds(n, rank, world_size):
    """The rank's contiguous share ``[start, stop)`` of ``n`` items, the
    JAX package's ``np.round(np.linspace(0, n, world_size + 1))``
    split."""
    split = np.round(np.linspace(0, n, world_size + 1)).astype(int)
    return int(split[rank]), int(split[rank + 1])


