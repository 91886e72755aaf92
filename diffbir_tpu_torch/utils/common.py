"""Image-space utilities: wavelet colour fix, resize and pad. NHWC in and out.

Counterpart of ``diffbir_tpu/utils/common.py``. ``bicubic_resize`` reproduces
``jax.image.resize(method="cubic")``: the Keys kernel with a = -0.5,
half-pixel centres, the kernel widened by the scale when downsampling
(antialiasing), weights renormalised to sum 1 at the border. Its separable
weight matrices are built on the host and applied as two products. (This is
not ``F.interpolate(mode="bicubic")``, which uses a = -0.75 and no
antialiasing.)
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_WAVELET_KERNEL = np.array(
    [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125], [0.0625, 0.125, 0.0625]],
    np.float32,
)


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Depthwise 3x3 blur dilated by ``radius`` with replicate padding."""
    c = image.shape[-1]
    kernel = torch.as_tensor(_WAVELET_KERNEL, dtype=image.dtype, device=image.device)
    kernel = kernel[None, None].repeat(c, 1, 1, 1)  # [C, 1, 3, 3]
    x = F.pad(image.permute(0, 3, 1, 2), (radius,) * 4, mode="replicate")
    return F.conv2d(x, kernel, dilation=radius, groups=c).permute(0, 2, 3, 1)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    high = torch.zeros_like(image)
    low = image
    for i in range(levels):
        blurred = wavelet_blur(low, 2**i)
        high = high + (low - blurred)
        low = blurred
    return high, low


def wavelet_reconstruction(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """content's high frequencies + style's low frequencies (colour fix)."""
    content_high, _ = wavelet_decomposition(content)
    _, style_low = wavelet_decomposition(style)
    return content_high + style_low


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def cubic_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] fp32 resampling weights, as jax.image.scale builds
    them for an antialiased cubic resize."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def bicubic_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased Keys-cubic resize of an NHWC batch (height, then width)."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    wh = torch.as_tensor(cubic_weight_matrix(h, oh), dtype=x.dtype, device=x.device)
    ww = torch.as_tensor(cubic_weight_matrix(w, ow), dtype=x.dtype, device=x.device)
    x = torch.einsum("oh,bhwc->bowc", wh, x)
    return torch.einsum("pw,bowc->bopc", ww, x)


def resize_short_edge_to(x: torch.Tensor, size: int) -> torch.Tensor:
    _, h, w, _ = x.shape
    if h == w:
        out = (size, size)
    elif h < w:
        out = (size, int(w * (size / h)))
    else:
        out = (int(h * (size / w)), size)
    return bicubic_resize(x, out)


def pad_to_multiples_of(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the bottom and right of an NHWC batch to multiples."""
    _, h, w, _ = x.shape
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, 0, pw, 0, ph))


class StageClock:
    """Seconds per stage of a request, each stage ended by a device sync; a
    no-op when no dict is given."""

    def __init__(self, out: Optional[Dict[str, float]], device: torch.device):
        self.out, self.device = out, device
        self.t = time.perf_counter()

    def lap(self, stage: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[stage] = self.out.get(stage, 0.0) + now - self.t
        self.t = now
