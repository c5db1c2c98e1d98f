"""Data parallelism over ``torch.distributed`` (port of
``ssdnerf_tpu/parallel``)."""
from .sharding import (DEFAULT_TIMEOUT, Group, default_backend,
                       init_distributed, replicate, shard_bounds,
                       shard_scenes, shard_train_draws,
                       sharded_volume_render, shutdown)

__all__ = ['DEFAULT_TIMEOUT', 'Group', 'default_backend', 'init_distributed',
           'replicate', 'shard_bounds', 'shard_scenes', 'shard_train_draws',
           'sharded_volume_render', 'shutdown']
