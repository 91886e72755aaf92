"""CodeFormer-style face degradation dataset (stage-1 training).

Counterpart of ``diffbir_tpu/dataset/codeformer.py``: blur (the mixed
iso/aniso kernels) -> a random downsample in ``downsample_range`` -> Gaussian
noise -> the JPEG round trip -> resize back; the prompt dropped with
``p_empty_prompt``; (gt in [-1, 1], lq in [0, 1], prompt) as fp32 HWC. The
draws are JAX's, in JAX's order (``default_rng(seed)`` for the shuffle,
``default_rng(seed + 1)`` for the degradation, Python's ``random`` at ``seed
+ 2``). OpenCV's calls are ``utils.warp``'s torch counterparts:
``cv2.filter2D`` (correlation, border reflect-101) and ``cv2.resize``
INTER_LINEAR on fp32; the JPEG round trip is ``dataset/jpeg.py``'s. Images
are PNG (``realesrgan.load_cropped``).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import config as cfglib
from ..config import register
from ..utils.warp import filter2d, resize
from .degradation import add_gaussian_noise_np, jpeg_compress_np, random_mixed_kernels
from .realesrgan import load_cropped
from .utils import load_file_list


@register("codeformer_dataset")
class CodeformerDataset:
    def __init__(
        self,
        file_list: str,
        file_backend_cfg: Mapping[str, Any],
        out_size: int,
        crop_type: str,
        blur_kernel_size: int,
        kernel_list: Sequence[str],
        kernel_prob: Sequence[float],
        blur_sigma: Sequence[float],
        downsample_range: Sequence[float],
        noise_range: Optional[Sequence[float]],
        jpeg_range: Optional[Sequence[int]],
        p_empty_prompt: float = 0.5,
    ):
        self.image_files = load_file_list(file_list)
        self.file_backend = cfglib.instantiate(file_backend_cfg)
        self.out_size = out_size
        if crop_type not in ("none", "center", "random"):
            raise ValueError(f"crop_type {crop_type!r}: none, center or random")
        self.crop_type = crop_type
        self.blur_kernel_size = blur_kernel_size
        self.kernel_list = kernel_list
        self.kernel_prob = kernel_prob
        self.blur_sigma = blur_sigma
        self.downsample_range = downsample_range
        self.noise_range = noise_range
        self.jpeg_range = jpeg_range
        self.p_empty_prompt = p_empty_prompt
        self._rng = np.random.default_rng()

    def __len__(self) -> int:
        return len(self.image_files)

    def _load_gt(self, path: str) -> Optional[np.ndarray]:
        return load_cropped(self.file_backend, path, self.crop_type, self.out_size)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img_gt = None
        while img_gt is None:
            meta = self.image_files[index]
            img_gt = self._load_gt(meta["image_path"])
            if img_gt is None:
                index = random.randint(0, len(self) - 1)
        prompt = meta.get("prompt", "")
        if self._rng.uniform() < self.p_empty_prompt:
            prompt = ""
        return {**self._degrade(img_gt), "prompt": prompt}

    def as_iterator(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """Batches of ``batch_size`` forever (drop-last epochs), the draws
        seeded from ``seed`` as ``RealESRGANDataset.as_iterator``'s."""
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
                    "gt": np.stack([it["gt"] for it in items]),
                    "lq": np.stack([it["lq"] for it in items]),
                    "prompt": [it["prompt"] for it in items],
                }

    def _degrade(self, img_gt: np.ndarray) -> Dict[str, np.ndarray]:
        """Two-stage synthetic degradation on one decoded uint8 RGB image."""
        gt = (img_gt / 255.0).astype(np.float32)
        h, w, _ = gt.shape
        rng = self._rng
        kernel = random_mixed_kernels(
            rng, self.kernel_list, self.kernel_prob, self.blur_kernel_size,
            tuple(self.blur_sigma), tuple(self.blur_sigma), (-math.pi, math.pi),
        )
        lq = filter2d(torch.from_numpy(gt)[None], torch.from_numpy(kernel)[None])[0]
        scale = rng.uniform(*self.downsample_range)
        lq = resize(lq, (int(w // scale), int(h // scale)), "linear").numpy()
        if self.noise_range is not None:
            sigma = rng.uniform(*self.noise_range)
            lq = add_gaussian_noise_np(rng, lq, sigma)
        if self.jpeg_range is not None:
            q = rng.integers(self.jpeg_range[0], self.jpeg_range[1])
            lq = jpeg_compress_np(lq, int(q))
        lq = resize(torch.from_numpy(lq), (w, h), "linear").numpy()
        return {
            "gt": (gt * 2 - 1).astype(np.float32),
            "lq": np.clip(lq, 0, 1).astype(np.float32),
        }
