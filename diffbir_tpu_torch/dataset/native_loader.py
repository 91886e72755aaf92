"""ctypes binding for the native C++ data loader (``native/dataloader/``).

Counterpart of ``diffbir_tpu/dataset/native_loader.py``, on the same shared
library: a C++ thread pool decodes the images (OpenCV), crops and augments
them and queues fixed-shape uint8 RGB batches, so the Python side only
copies a batch out. The library is built at first use by ``make -C
native`` (g++ against OpenCV 4; a no-op when it is current) and must
report ``dl_api_version() >= 2``.

``native_available()`` is False when the library is missing and cannot be
built; ``native_status()`` says why. The datasets' ``as_iterator(...,
native=True)`` and the trainers' ``train.native_loader`` read through
``NativeImageLoader``; the trainers fall back to the Python path, with
JAX's message, where it is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libdiffbir_loader.so")

CROP_CENTER = 0       # scale-to-fit + center crop (center_crop_arr)
CROP_RANDOM = 1       # random crop at native scale
CROP_RANDOM_ZOOM = 2  # random zoom + random crop (random_crop_arr, frac 0.7-1)
_CROP_MODES = {"center": CROP_CENTER, "random": CROP_RANDOM,
               "random_zoom": CROP_RANDOM_ZOOM}
AUG_HFLIP = 1
AUG_ROT90 = 2
API_VERSION = 2

# the library, loaded once a process (None until then), and why it is not
_lib: Optional[ctypes.CDLL] = None
_status = "not loaded yet"


def _build() -> Optional[str]:
    """``make -C native`` (mtime-based: a no-op when the library is
    current); returns why the library is missing afterwards, or None."""
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return None if os.path.exists(_LIB_PATH) else f"no {_NATIVE_DIR}/Makefile"
    try:
        run = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None if os.path.exists(_LIB_PATH) else f"make -C native: {e}"
    if os.path.exists(_LIB_PATH):
        return None
    lines = (run.stderr + run.stdout).strip().splitlines()
    first = next((ln for ln in lines if "error" in ln.lower()), lines[-1] if lines else "")
    return f"make -C native exited {run.returncode}: {first.strip()}"


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _status
    if _lib is not None:
        return _lib
    why = _build()
    if why is not None:
        _status = why
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        _status = f"cannot load {_LIB_PATH}: {e}"
        return None
    try:
        version = lib.dl_api_version()
    except AttributeError:
        version = 0  # a stale pre-v2 library that make failed to refresh
    if version < API_VERSION:
        _status = f"{_LIB_PATH} has API version {version} < {API_VERSION}"
        return None
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
    ]
    lib.dl_next.restype = ctypes.c_int
    lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
    lib.dl_next_idx.restype = ctypes.c_int
    lib.dl_next_idx.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_long),
    ]
    lib.dl_n_files.restype = ctypes.c_long
    lib.dl_n_files.argtypes = [ctypes.c_void_p]
    lib.dl_batches_per_epoch.restype = ctypes.c_long
    lib.dl_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.dl_destroy.restype = None
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    _lib, _status = lib, f"on ({_LIB_PATH})"
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def native_status() -> str:
    """Whether the library loaded, and why not where it did not."""
    _load_lib()
    return _status


class NativeImageLoader:
    """Threaded C++ decode -> crop -> augment loader yielding uint8 RGB
    batches [batch, size, size, 3] forever (epochs roll over with a fresh
    seeded shuffle). Each sample's draws are keyed on (seed, epoch, file
    index), so the stream does not depend on thread timing. A file that
    does not decode gives zeros."""

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        out_size: int,
        crop: str = "random",
        hflip: bool = True,
        rot90: bool = False,
        num_threads: int = 4,
        queue_depth: int = 4,
        seed: int = 231,
        shuffle: bool = True,
    ):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable ({_status}): build it with "
                               "`make -C native`")
        if not paths:
            raise ValueError("empty file list")
        if crop not in _CROP_MODES:
            raise ValueError(f"crop {crop!r}: one of {sorted(_CROP_MODES)}")
        self._lib = lib
        self.batch_size = batch_size
        self.out_size = out_size
        arr = (ctypes.c_char_p * len(paths))(*[os.fspath(p).encode() for p in paths])
        augment = (AUG_HFLIP if hflip else 0) | (AUG_ROT90 if rot90 else 0)
        self._h = lib.dl_create(arr, len(paths), batch_size, out_size, _CROP_MODES[crop],
                                augment, num_threads, queue_depth, seed, int(shuffle))
        if not self._h:
            raise RuntimeError("dl_create failed")
        self._buf = np.empty((batch_size, out_size, out_size, 3), np.uint8)

    @property
    def n_files(self) -> int:
        return int(self._lib.dl_n_files(self._h))

    @property
    def batches_per_epoch(self) -> int:
        return int(self._lib.dl_batches_per_epoch(self._h))

    def _out(self):
        return self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))

    def next(self) -> np.ndarray:
        if self._lib.dl_next(self._h, self._out()) != 0:
            raise StopIteration
        return self._buf.copy()

    def next_with_idx(self) -> Tuple[np.ndarray, np.ndarray]:
        """(batch [B, S, S, 3] uint8, file indices [B] int64)."""
        idx = np.empty((self.batch_size,), np.int64)
        rc = self._lib.dl_next_idx(self._h, self._out(),
                                   idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
        if rc != 0:
            raise StopIteration
        return self._buf.copy(), idx

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
