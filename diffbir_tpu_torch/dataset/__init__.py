"""The training data pipeline: file lists, datasets, the batch degradation
and the prefetching iterator. Importing the package registers its config
names (``hard_disk_backend``, ``petrel_backend``, ``realesrgan_dataset``,
``codeformer_dataset``, ``realesrgan_batch_transform``,
``identity_batch_transform``) with ``config.register``, as the JAX
package's does."""

from . import file_backend  # noqa: F401
from .batch_transform import IdentityBatchTransform, RealESRGANBatchTransform
from .codeformer import CodeformerDataset
from .realesrgan import RealESRGANDataset

__all__ = [
    "CodeformerDataset",
    "RealESRGANDataset",
    "RealESRGANBatchTransform",
    "IdentityBatchTransform",
]
