"""Spatial tiling: sliding windows with Gaussian-blended overlap.

Counterpart of ``diffbir_tpu/tiling.py`` (the reference's ``make_tiled_fn``,
``gaussian_weights`` and ``sliding_windows``): a function on NHWC images is
run tile by tile, each result weighted by a per-pixel Gaussian mask
(mixture-of-diffusers blending), summed into an fp32 canvas and divided by
the summed weights; the output may be scaled up or down from the input and
have another channel count. Tiles are stacked on the batch axis in chunks of
``tiles_per_batch`` (tile-major, then batch, the JAX order), and a function
that declares a ``tile_coords`` keyword receives each chunk's top-left
corners, so that it can slice auxiliary inputs (the diffusion hint) in step.

The normaliser depends on geometry only: it is built on the host once per
input size and device and moved there once. The JAX package's ``lax.scan``
branch above ``SCAN_THRESHOLD`` tiles only bounds the size of an XLA
program; in eager PyTorch one loop covers both, and its last chunk runs
short instead of padded (the same sum: JAX gives padded slots weight 0).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def sliding_windows(h: int, w: int, size: int, stride: int) -> List[Tuple[int, int]]:
    """Top-left corners of ``size`` windows at ``stride`` covering (h, w),
    the last row and column flush with the far edges."""
    his = list(range(0, h - size + 1, stride))
    if (h - size) % stride != 0:
        his.append(h - size)
    wis = list(range(0, w - size + 1, stride))
    if (w - size) % stride != 0:
        wis.append(w - size)
    return [(hi, wi) for hi in his for wi in wis]


def gaussian_weights(tile_w: int, tile_h: int) -> np.ndarray:
    """Per-pixel Gaussian blending weights [tile_h, tile_w] (variance 0.01 of
    the tile size; the column centre at (w - 1) / 2, the row centre at
    h / 2, as the reference has them)."""
    var = 0.01
    mid_w = (tile_w - 1) / 2
    x = np.arange(tile_w)
    xp = np.exp(-((x - mid_w) ** 2) / (tile_w * tile_w) / (2 * var)) / np.sqrt(2 * np.pi * var)
    mid_h = tile_h / 2
    y = np.arange(tile_h)
    yp = np.exp(-((y - mid_h) ** 2) / (tile_h * tile_h) / (2 * var)) / np.sqrt(2 * np.pi * var)
    return np.outer(yp, xp)


def make_tiled_fn(
    fn: Callable[..., torch.Tensor],
    size: int,
    stride: int,
    scale_type: str = "up",
    scale: int = 1,
    channel: Optional[int] = None,
    tiles_per_batch: int = 1,
) -> Callable[..., torch.Tensor]:
    """``fn(x, *args, **kwargs)`` (NHWC -> NHWC) as a blended tiled function
    of an [B, H, W, C] input, returning fp32 [B, sH, sW, channel or C] with
    s the ``scale`` "up" (times) or "down" (floor division). ``fn`` gets
    [k B, size, size, C] tile stacks (k tiles of the chunk) and extra
    arguments as they are, and ``tile_coords`` (the chunk's corners, in
    input pixels) when its signature names it."""
    if scale_type not in ("up", "down"):
        raise ValueError(f"unknown scale type {scale_type!r}")
    per = max(1, int(tiles_per_batch))

    def sfn(n: int) -> int:
        return n * scale if scale_type == "up" else n // scale

    osize = sfn(size)
    wmask = gaussian_weights(osize, osize)
    accepts_coords = "tile_coords" in inspect.signature(fn).parameters
    # (h, w, device) -> (coords, mask [1, o, o, 1], 1 / summed weights [1, sH, sW, 1])
    geometry: Dict[tuple, tuple] = {}

    def blend_geometry(h: int, w: int, device: torch.device):
        key = (h, w, str(device))
        if key not in geometry:
            coords = sliding_windows(h, w, size, stride)
            count = np.zeros((sfn(h), sfn(w), 1), np.float32)
            for hi, wi in coords:
                count[sfn(hi): sfn(hi) + osize, sfn(wi): sfn(wi) + osize, 0] += wmask
            geometry[key] = (
                coords,
                torch.as_tensor(wmask[None, :, :, None], dtype=torch.float32, device=device),
                torch.as_tensor(1.0 / count, device=device)[None],
            )
        return geometry[key]

    def tiled(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        b, h, w, c = x.shape
        coords, mask, inv_count = blend_geometry(h, w, x.device)
        out = torch.zeros((b, sfn(h), sfn(w), channel or c), dtype=torch.float32,
                          device=x.device)
        for i in range(0, len(coords), per):
            chunk = coords[i: i + per]
            tiles = torch.cat([x[:, hi: hi + size, wi: wi + size, :] for hi, wi in chunk], dim=0)
            if accepts_coords:
                res = fn(tiles, *args, tile_coords=tuple(chunk), **kwargs)
            else:
                res = fn(tiles, *args, **kwargs)
            res = res.float() * mask
            for j, (hi, wi) in enumerate(chunk):
                out[:, sfn(hi): sfn(hi) + osize, sfn(wi): sfn(wi) + osize, :] += \
                    res[j * b: (j + 1) * b]
        return out * inv_count

    return tiled
