"""Dataset utilities: file lists, crops, augmentation.

Counterpart of ``diffbir_tpu/dataset/utils.py`` without an image library:
images are uint8 HWC arrays, and the crops' resizes are Pillow's
(``utils.common.pil_resize``, bit for bit): BOX halving while the short side
is at least twice the target, then BICUBIC to the target's scale (Python's
``round`` of each side, as JAX's). The crop offsets and flips draw from
Python's global ``random`` in JAX's order.

``load_parquet_file_list`` needs ``pandas`` (or ``pyarrow``), which is not
installed beside the port: it raises ValueError naming the reader.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch

from ..utils.common import pil_resize


def load_file_list(path: str) -> List[Dict[str, str]]:
    """One image path per line, optionally 'path<TAB>prompt'."""
    files = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if "\t" in line:
                p, prompt = line.split("\t", 1)
            else:
                p, prompt = line, ""
            files.append({"image_path": p, "prompt": prompt})
    return files


def load_parquet_file_list(path: str, short_prompt_key="short_prompt",
                           long_prompt_key="long_prompt") -> List[Dict[str, str]]:
    """Parquet file lists with short and long captions: not read here."""
    raise ValueError(f"{path}: a .parquet file list needs the pandas (or pyarrow) reader, "
                     "which is not installed beside the port; write the list as text (one "
                     "'path<TAB>prompt' a line)")


def _resize(img: np.ndarray, w: int, h: int, resample: str) -> np.ndarray:
    return pil_resize(torch.from_numpy(np.ascontiguousarray(img)), (h, w), resample).numpy()


def _halve_then_scale(img: np.ndarray, target: int) -> np.ndarray:
    while min(img.shape[0], img.shape[1]) >= 2 * target:
        img = _resize(img, img.shape[1] // 2, img.shape[0] // 2, "box")
    scale = target / min(img.shape[0], img.shape[1])
    return _resize(img, round(img.shape[1] * scale), round(img.shape[0] * scale), "bicubic")


def center_crop_arr(img: np.ndarray, image_size: int) -> np.ndarray:
    """Guided-diffusion centre crop of a uint8 HWC image."""
    arr = _halve_then_scale(img, image_size)
    cy = (arr.shape[0] - image_size) // 2
    cx = (arr.shape[1] - image_size) // 2
    return arr[cy: cy + image_size, cx: cx + image_size]


def random_crop_arr(img: np.ndarray, image_size: int, min_crop_frac: float = 0.8,
                    max_crop_frac: float = 1.0) -> np.ndarray:
    """Guided-diffusion random crop of a uint8 HWC image."""
    min_smaller = int(np.ceil(image_size / max_crop_frac))
    max_smaller = int(np.ceil(image_size / min_crop_frac))
    smaller = random.randrange(min_smaller, max_smaller + 1)
    arr = _halve_then_scale(img, smaller)
    cy = random.randrange(arr.shape[0] - image_size + 1)
    cx = random.randrange(arr.shape[1] - image_size + 1)
    return arr[cy: cy + image_size, cx: cx + image_size]


def augment(imgs, hflip: bool = True, rotation: bool = True, return_status: bool = False):
    """hflip, vflip and transpose (rot90) augmentation, each with p 0.5."""
    single = not isinstance(imgs, list)
    if single:
        imgs = [imgs]
    do_hflip = hflip and random.random() < 0.5
    do_vflip = rotation and random.random() < 0.5
    do_rot90 = rotation and random.random() < 0.5

    def _aug(img):
        if do_hflip:
            img = img[:, ::-1, :].copy()
        if do_vflip:
            img = img[::-1, :, :].copy()
        if do_rot90:
            img = img.transpose(1, 0, 2).copy()
        return img

    imgs = [_aug(i) for i in imgs]
    if single:
        imgs = imgs[0]
    if return_status:
        return imgs, (do_hflip, do_vflip, do_rot90)
    return imgs
