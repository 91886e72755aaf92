"""Real-ESRGAN HQ dataset: images plus per-sample degradation kernels.

Counterpart of ``diffbir_tpu/dataset/realesrgan.py``: the HQ image loaded,
cropped and hflip/rot-augmented; kernel1 and kernel2 from the sinc-or-mixed
sampler padded to 21; the final sinc kernel or a pulse; the prompt (long or
short caption with ``p_long_prompt``, dropped with ``p_empty_prompt``). The
degradation itself is the batch transform's. The draws are JAX's, in JAX's
order: the shuffle from ``default_rng(seed)``, the degradation and prompt
draws from ``default_rng(seed + 1)``, and Python's ``random`` reseeded with
``seed + 2``; so one seed gives the same kernels, crops and prompts as the
JAX dataset.

Images are PNG, read without an image library (``load_image``; any other
format raises ValueError naming it). File lists are text (``.parquet``
lists raise ValueError naming the reader they need). ``as_iterator(...,
native=True)`` reads through the C++ loader (``native_loader.py``), which
decodes any format OpenCV does.
"""

from __future__ import annotations

import math
import os
import random
import struct
import time
import zlib
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

from .. import config as cfglib
from ..config import register
from ..utils.image_io import decode_png, to_rgb
from .degradation import circular_lowpass_kernel, random_mixed_kernels
from .file_backend import HardDiskBackend
from .utils import (
    augment,
    center_crop_arr,
    load_file_list,
    load_parquet_file_list,
    random_crop_arr,
)

_PNG = b"\x89PNG\r\n\x1a\n"


def load_image(backend, path: str, max_retry: int = 5) -> Optional[np.ndarray]:
    """The image at ``path`` as uint8 RGB HWC through ``backend``, or None to
    resample: a local file that is missing, bytes the backend cannot get in
    ``max_retry`` tries (0.5 s apart), or a truncated PNG. Bytes that are not
    a PNG, or a PNG variant the reader does not decode, raise ValueError
    naming the file."""
    data = None
    while data is None:
        if max_retry == 0:
            return None
        # a missing local file resamples at once (the retries are for
        # transient errors); cluster paths never exist locally
        if isinstance(backend, HardDiskBackend) and not os.path.exists(path):
            return None
        data = backend.get(path)
        max_retry -= 1
        if data is None:
            time.sleep(0.5)
    if not data.startswith(_PNG):
        decode_png(data, path)  # raises, naming the format
    try:
        return to_rgb(decode_png(data, path))
    except (zlib.error, struct.error):  # truncated: resample, as JAX does
        return None


def load_cropped(backend, path: str, crop_type: str, out_size: int) -> Optional[np.ndarray]:
    """``load_image``, then the crop: "none" keeps only out_size squares
    (else None, to resample), "center" and "random" crop any other size
    (the random crop from 0.7 of the short side)."""
    img = load_image(backend, path)
    if img is None:
        return None
    if crop_type == "none":
        return img if img.shape[:2] == (out_size, out_size) else None
    if img.shape[:2] == (out_size, out_size):
        return img
    if crop_type == "center":
        return center_crop_arr(img, out_size)
    return random_crop_arr(img, out_size, min_crop_frac=0.7)


@register("realesrgan_dataset")
class RealESRGANDataset:
    def __init__(
        self,
        file_metas: Optional[Sequence[Mapping[str, str]]] = None,
        file_list: Optional[str] = None,
        file_backend_cfg: Mapping[str, Any] = None,
        out_size: int = 512,
        crop_type: str = "none",
        use_hflip: bool = True,
        use_rot: bool = False,
        blur_kernel_size: int = 21,
        kernel_list: Sequence[str] = ("iso", "aniso", "generalized_iso",
                                      "generalized_aniso", "plateau_iso", "plateau_aniso"),
        kernel_prob: Sequence[float] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03),
        blur_sigma: Sequence[float] = (0.2, 3.0),
        betag_range: Sequence[float] = (0.5, 4.0),
        betap_range: Sequence[float] = (1, 2),
        sinc_prob: float = 0.1,
        blur_kernel_size2: int = 21,
        kernel_list2: Sequence[str] = ("iso", "aniso", "generalized_iso",
                                       "generalized_aniso", "plateau_iso", "plateau_aniso"),
        kernel_prob2: Sequence[float] = (0.45, 0.25, 0.12, 0.03, 0.12, 0.03),
        blur_sigma2: Sequence[float] = (0.2, 1.5),
        betag_range2: Sequence[float] = (0.5, 4.0),
        betap_range2: Sequence[float] = (1, 2),
        sinc_prob2: float = 0.1,
        final_sinc_prob: float = 0.8,
        p_empty_prompt: float = 0.2,
        p_long_prompt: float = 0.2,
    ):
        if file_metas is not None:
            self.image_files = []
            for m in file_metas:
                path = m["file_list"]
                if path.endswith(".parquet"):
                    self.image_files += load_parquet_file_list(path)
                else:
                    self.image_files += load_file_list(path)
        else:
            self.image_files = load_file_list(file_list)
        self.file_backend = cfglib.instantiate(
            file_backend_cfg or {"target": "hard_disk_backend"}
        )
        self.out_size = out_size
        if crop_type not in ("none", "center", "random"):
            raise ValueError(f"crop_type {crop_type!r}: none, center or random")
        self.crop_type = crop_type
        self.use_hflip, self.use_rot = use_hflip, use_rot
        self.kernel_range = list(range(7, 22, 2))
        self.cfg = dict(
            kernel_list=kernel_list, kernel_prob=kernel_prob, blur_sigma=blur_sigma,
            betag_range=betag_range, betap_range=betap_range, sinc_prob=sinc_prob,
            kernel_list2=kernel_list2, kernel_prob2=kernel_prob2, blur_sigma2=blur_sigma2,
            betag_range2=betag_range2, betap_range2=betap_range2, sinc_prob2=sinc_prob2,
            final_sinc_prob=final_sinc_prob,
        )
        self.p_empty_prompt = p_empty_prompt
        self.p_long_prompt = p_long_prompt
        pulse = np.zeros((21, 21), np.float32)
        pulse[10, 10] = 1.0
        self.pulse = pulse
        self._rng = np.random.default_rng()  # reseeded by as_iterator(seed)

    def __len__(self) -> int:
        return len(self.image_files)

    def _load_hq(self, path: str) -> Optional[np.ndarray]:
        return load_cropped(self.file_backend, path, self.crop_type, self.out_size)

    def _sample_kernel(self, which: int) -> np.ndarray:
        c = self.cfg
        rng = self._rng
        ksize = random.choice(self.kernel_range)
        sinc_p = c["sinc_prob"] if which == 1 else c["sinc_prob2"]
        if rng.uniform() < sinc_p:
            omega = rng.uniform(np.pi / 3 if ksize < 13 else np.pi / 5, np.pi)
            kernel = circular_lowpass_kernel(omega, ksize)
        else:
            kernel = random_mixed_kernels(
                rng,
                c["kernel_list"] if which == 1 else c["kernel_list2"],
                c["kernel_prob"] if which == 1 else c["kernel_prob2"],
                ksize,
                tuple(c["blur_sigma"] if which == 1 else c["blur_sigma2"]),
                tuple(c["blur_sigma"] if which == 1 else c["blur_sigma2"]),
                (-math.pi, math.pi),
                tuple(c["betag_range"] if which == 1 else c["betag_range2"]),
                tuple(c["betap_range"] if which == 1 else c["betap_range2"]),
            )
        pad = (21 - ksize) // 2
        return np.pad(kernel, ((pad, pad), (pad, pad))).astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img = None
        while img is None:
            meta = self.image_files[index]
            img = self._load_hq(meta["image_path"])
            if img is None:
                index = random.randint(0, len(self) - 1)
        prompt = self._prompt_for(meta)
        hq = (img / 255.0).astype(np.float32)
        hq = augment(hq, self.use_hflip, self.use_rot)
        return {
            "hq": hq,  # [0,1] HWC rgb
            "kernel1": self._sample_kernel(1),
            "kernel2": self._sample_kernel(2),
            "sinc_kernel": self._sample_sinc(),
            "txt": prompt,
        }

    def as_iterator(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                    native: bool = False, num_threads: int = 4):
        """Batches of ``batch_size`` forever (drop-last epochs, reshuffled
        each epoch when ``shuffle``), the draws seeded from ``seed``.
        ``native=True`` moves decode, crop and hflip/rot into the C++ worker
        pool (``native_iterator``); the kernels stay in numpy."""
        if native:
            yield from self.native_iterator(batch_size, seed, num_threads, shuffle)
            return
        if len(self) < batch_size:
            # the drop-last epoch loop below would otherwise spin forever
            # yielding nothing
            raise ValueError(
                f"dataset has {len(self)} items < batch_size={batch_size}"
            )
        order_rng = np.random.default_rng(seed)
        # reproducibility: degradation/prompt sampling shares the seed too
        self._rng = np.random.default_rng(seed + 1)
        random.seed(seed + 2)
        while True:
            idx = np.arange(len(self))
            if shuffle:
                order_rng.shuffle(idx)
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                items = [self[int(j)] for j in idx[i: i + batch_size]]
                yield {
                    "hq": np.stack([it["hq"] for it in items]),
                    "kernel1": np.stack([it["kernel1"] for it in items]),
                    "kernel2": np.stack([it["kernel2"] for it in items]),
                    "sinc_kernel": np.stack([it["sinc_kernel"] for it in items]),
                    "txt": [it["txt"] for it in items],
                }

    def native_iterator(self, batch_size: int, seed: int = 0, num_threads: int = 4,
                        shuffle: bool = True):
        """JAX's ``_as_native_iterator``: local files only, center or random
        (zoom) crop; the loader's order and crops, then the kernels and
        prompts drawn per image. Unlike JAX's, the draws are reseeded from
        ``seed`` as the Python path's are, so a native stream repeats."""
        from .native_loader import NativeImageLoader

        if self.crop_type == "none":
            raise ValueError("native loader needs center/random crop_type")
        loader = NativeImageLoader(
            [m["image_path"] for m in self.image_files], batch_size, self.out_size,
            crop="center" if self.crop_type == "center" else "random_zoom",
            hflip=self.use_hflip, rot90=self.use_rot,
            num_threads=num_threads, seed=seed, shuffle=shuffle)
        self._rng = np.random.default_rng(seed + 1)
        random.seed(seed + 2)
        try:
            while True:
                imgs, idx = loader.next_with_idx()
                yield {
                    "hq": imgs.astype(np.float32) / 255.0,
                    "kernel1": np.stack([self._sample_kernel(1) for _ in idx]),
                    "kernel2": np.stack([self._sample_kernel(2) for _ in idx]),
                    "sinc_kernel": np.stack([self._sample_sinc() for _ in idx]),
                    "txt": [self._prompt_for(self.image_files[int(j)]) for j in idx],
                }
        finally:
            loader.close()

    def _prompt_for(self, meta) -> str:
        if "short_prompt" in meta:
            prompt = (
                meta["long_prompt"]
                if self._rng.uniform() < self.p_long_prompt
                else meta["short_prompt"]
            )
        else:
            prompt = meta.get("prompt", "")
        return "" if self._rng.uniform() < self.p_empty_prompt else prompt

    def _sample_sinc(self) -> np.ndarray:
        if self._rng.uniform() < self.cfg["final_sinc_prob"]:
            ksize = random.choice(self.kernel_range)
            omega = self._rng.uniform(np.pi / 3, np.pi)
            return circular_lowpass_kernel(omega, ksize, pad_to=21).astype(np.float32)
        return self.pulse
