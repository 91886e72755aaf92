"""Several processes, one card each, over ``torch.distributed``.

Training (``distributed.py``: the launch; ``mesh.py``: the data x tensor
grid, the batch split and the gradient reduction; ``fsdp.py``: sharded
optimiser state) and inference (``inference.py``: batch-, tile- and
spatial-parallel restoration), both on ``tp.py`` (the tensor-parallel
UNet, ControlNet, CLIP tower and SwinIR) and, under autograd, on
``collectives.py`` (the collectives with their backward, which GSPMD
inserts and differentiates for the JAX package). The counterparts of the
JAX package's ``parallel/`` modules of the same names; ``collectives.py``
has none.
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
    spatial_parallel_request,
    spatial_shard,
    tile_parallel_model_fn,
)
from .mesh import DataParallel, ProcessGrid, broadcast_, data_size, make_mesh
from .tp import tp_dim, tp_local, tp_plan, tp_shard_, tp_whole

__all__ = ["maybe_initialize_distributed", "shutdown_distributed", "is_main_process",
           "process_seed", "sync_processes", "fsdp_dim", "DataParallel", "ProcessGrid",
           "make_mesh", "broadcast_", "data_size", "shard_for_batch_parallel", "batch_parallel",
           "make_tile_sharded_fn", "tile_parallel_model_fn", "spatial_shard",
           "spatial_parallel", "spatial_parallel_request", "gather", "tp_dim", "tp_plan", "tp_shard_", "tp_local",
           "tp_whole"]
