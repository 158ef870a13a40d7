"""Data parallelism over processes, one per card (the JAX package's
``parallel/``: its device mesh becomes a ``torch.distributed`` world), and
height sharding over a ``(data, space)`` grid of them
(``TRAINER.SPATIAL_SHARDS``, :mod:`.halo`)."""

from .distributed import (local_device, maybe_initialize_distributed,  # noqa: F401
                          process_shard, shutdown)
from .group import (Grid, all_reduce_, all_reduce_flat_, barrier,  # noqa: F401
                    batch_rows, broadcast_, global_rows, grid, rank, scene_grid,
                    space_shards, world_size)
