"""Training on several processes, one card each, over ``torch.distributed``
(``distributed.py``: the launch; ``mesh.py``: the batch split and the
collectives; ``fsdp.py``: sharded optimiser state). The JAX package's
``parallel/inference.py`` and ``tp.py`` are not ported."""

from .distributed import (
    is_main_process,
    maybe_initialize_distributed,
    process_seed,
    shutdown_distributed,
    sync_processes,
)
from .fsdp import fsdp_dim
from .mesh import DataParallel, broadcast_, data_size

__all__ = ["maybe_initialize_distributed", "shutdown_distributed", "is_main_process",
           "process_seed", "sync_processes", "fsdp_dim", "DataParallel", "broadcast_",
           "data_size"]
