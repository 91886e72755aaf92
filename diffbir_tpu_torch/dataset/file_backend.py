"""File backends: byte access for the dataset sources.

Counterpart of ``diffbir_tpu/dataset/file_backend.py``: ``hard_disk_backend``
reads local files (None when one cannot be read, so the dataset resamples);
``petrel_backend`` (S3-like cluster storage) needs the ``petrel_client``
package, which is not beside the port: building it raises ImportError
naming that package.
"""

from __future__ import annotations

from typing import Optional

from ..config import register


class FileBackend:
    def get(self, filepath: str) -> Optional[bytes]:
        raise NotImplementedError


@register("hard_disk_backend")
class HardDiskBackend(FileBackend):
    def get(self, filepath: str) -> Optional[bytes]:
        try:
            with open(filepath, "rb") as f:
                return f.read()
        except OSError:
            return None


@register("petrel_backend")
class PetrelBackend(FileBackend):
    """S3-like cluster storage through the petrel_client SDK."""

    def __init__(self, enable_mc: bool = True):
        try:
            from petrel_client.client import Client  # type: ignore
        except ImportError as e:
            raise ImportError("petrel_backend needs the petrel_client package, which is not "
                              "installed; use hard_disk_backend") from e
        self._client = Client(enable_mc=enable_mc)

    def get(self, filepath: str) -> Optional[bytes]:
        try:
            data = self._client.Get(filepath)
        except Exception:  # the SDK's transient errors: resample, as JAX does
            return None
        return bytes(data) if data is not None else None
