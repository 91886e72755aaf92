"""Several processes, one card each, over ``torch.distributed``.

Training (``distributed.py``: the launch; ``mesh.py``: the batch split and
the collectives; ``fsdp.py``: sharded optimiser state) and inference
(``inference.py``: batch-, tile- and spatial-parallel restoration;
``tp.py``: the tensor-parallel UNet, ControlNet and CLIP tower), the
counterparts of the JAX package's ``parallel/`` modules of the same names.
"""

from .distributed import (
    is_main_process,
    maybe_initialize_distributed,
    process_seed,
    shutdown_distributed,
    sync_processes,
)
from .fsdp import fsdp_dim
from .inference import (
    batch_parallel,
    gather,
    make_tile_sharded_fn,
    shard_for_batch_parallel,
    spatial_parallel,
    spatial_shard,
    tile_parallel_model_fn,
)
from .mesh import DataParallel, broadcast_, data_size
from .tp import tp_dim, tp_plan, tp_shard_

__all__ = ["maybe_initialize_distributed", "shutdown_distributed", "is_main_process",
           "process_seed", "sync_processes", "fsdp_dim", "DataParallel", "broadcast_",
           "data_size", "shard_for_batch_parallel", "batch_parallel", "make_tile_sharded_fn",
           "tile_parallel_model_fn", "spatial_shard", "spatial_parallel", "gather", "tp_dim",
           "tp_plan", "tp_shard_"]
