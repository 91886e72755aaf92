"""Build a ``csrc/`` CUDA file into a shared library at first use and call it.

Each kernel source has a plain C entry point. It is compiled with ``nvcc`` for
Hopper (``sm_90a``) into ``build/torch_kernels/`` at the repository root (a
directory ``.gitignore`` lists), named by a hash of the source and flags, and
loaded with ``ctypes``. The name's hash covers the source, every shared
header in ``csrc/`` (``*.cuh``, which a source may include) and the flags, so
an edited header rebuilds every source. There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the toolkit's
    default install location; None when there is none."""
    candidates = []
    home = os.environ.get("CUDA_HOME")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def build_key(source: Path) -> str:
    """Hash of the source, of every ``csrc/*.cuh`` header (in name order) and
    of the flags: the library's name."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` unless a library of the same source, headers and
    flags is already built. Returns (library path, compiler log; "" when
    cached)."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {source.name}: nvcc not found (set CUDA_HOME or put "
            "nvcc on the PATH)"
        )
    out = BUILD_DIR / f"{source.stem}-{build_key(source)}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


# the launches recorded into a CUDA graph that this thread captures
# (``capture_tally``), which the device has not run
_capture = threading.local()


class CudaKernel:
    """One C entry point of one ``csrc/`` file, built and loaded at first use.

    ``launches`` counts the launches the device runs, so a run can show
    which kernels its path went through: each successful launch through
    :meth:`launch` but those recorded into a CUDA graph that is being
    captured (which go to the capture's ``capture_tally``), and a graph's
    recorded launches again at each of its replays (``count``).
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None

    def load(self):
        if self._fn is None:
            path, self.build_log = build(self.source)
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        """Enqueue one launch on the stream passed in ``args``; raise on any
        CUDA error the launch reports."""
        rc = self.load()(*args)
        if rc != 0:
            msg = self._lib.cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        if torch.cuda.is_current_stream_capturing():
            tally = getattr(_capture, "tally", None)
            if tally is not None:
                tally[self] = tally.get(self, 0) + 1
        else:
            self.launches += 1


@contextlib.contextmanager
def capture_tally():
    """A dict that collects {kernel: launches} of the launches this thread
    records into a CUDA graph within the block (they are not counted in
    ``launches``)."""
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = None


def count(made: dict) -> None:
    """Add ``made`` ({kernel: launches}, a graph's recorded launches) to the
    counters: the graph has run once more."""
    for k, n in made.items():
        k.launches += n


def load_all(kernels: Sequence[CudaKernel]) -> None:
    """Build the distinct sources of ``kernels`` at once (one ``nvcc`` each,
    all started together), then load every entry point."""
    import concurrent.futures

    sources = sorted({k.source for k in kernels})
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = dict(zip(sources, pool.map(lambda s: build(s)[1], sources)))
    for kernel in kernels:
        kernel.load()
        kernel.build_log = kernel.build_log or logs[kernel.source]
