"""Image-space utilities: wavelet colour fix, resize and pad. NHWC in and out.

Counterpart of ``diffbir_tpu/utils/common.py``. ``bicubic_resize`` reproduces
``jax.image.resize(method="cubic")``: the Keys kernel with a = -0.5,
half-pixel centres, the kernel widened by the scale when downsampling
(antialiasing), weights renormalised to sum 1 at the border. Its separable
weight matrices are built on the host and applied as two products. (This is
not ``F.interpolate(mode="bicubic")``, which uses a = -0.75 and no
antialiasing.) ``pil_bicubic_resize`` is Pillow's bicubic resize of a uint8
image, bit for bit (the blind-SR loop's pre-upscale, the captioner's
preprocessing); ``pil_resize`` takes Pillow's bilinear (triangle) and box
filters too (RAM++'s preprocessing, the training crops). ``ssim``, ``psnr`` and ``rgb2ycbcr_y`` are the JAX
package's image metrics (the turbo drift readings use them).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import spans

_WAVELET_KERNEL = ((0.0625, 0.125, 0.0625), (0.125, 0.25, 0.125), (0.0625, 0.125, 0.0625))


def host_to_device(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype, device=device)`` for a request's
    data without waiting for the device: on a CUDA device the host array is
    staged in pinned memory and copied without blocking (a pageable copy
    syncs the stream, which stalls the host until the device has caught
    up), ordered after the stream's earlier work; the pinned block is held
    until the copy ends. Constants take ``device_constant``."""
    t = torch.as_tensor(a, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=32)
def device_constant(make: Callable[..., np.ndarray], *args, device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``make(*args)``, a constant of the host, as a tensor on ``device``:
    built and copied at its first use and then kept, so that later calls
    neither copy nor wait. Shared: read it, never write to it."""
    return torch.as_tensor(make(*args), dtype=dtype).to(device)


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    """Depthwise 3x3 blur dilated by ``radius`` with replicate padding."""
    c = image.shape[-1]
    kernel = device_constant(np.asarray, _WAVELET_KERNEL, device=image.device,
                             dtype=image.dtype)
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
    wh = device_constant(cubic_weight_matrix, h, oh, device=x.device, dtype=x.dtype)
    ww = device_constant(cubic_weight_matrix, w, ow, device=x.device, dtype=x.dtype)
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


_PRECISION_BITS = 22  # Pillow's 8-bit resampler: 32 - 8 - 2


def _pil_bicubic(x: float) -> float:
    x = abs(x)
    if x < 1.0:
        return (1.5 * x - 2.5) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return 0.0


def _pil_triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _pil_box(x: float) -> float:
    return 1.0 if -0.5 < x <= 0.5 else 0.0


# Pillow's filters by name: (the filter, its support at scale 1)
PIL_FILTERS = {"bicubic": (_pil_bicubic, 2.0), "bilinear": (_pil_triangle, 1.0),
               "box": (_pil_box, 0.5)}


@functools.lru_cache(maxsize=32)
def pil_coeffs(in_size: int, out_size: int, resample: str = "bicubic") -> np.ndarray:
    """[out_size, in_size] int64 fixed-point weights of Pillow's resampler
    along one axis with the filter ``resample`` ("bicubic", "bilinear": the
    triangle, "box"), widened by the downscale factor (``precompute_coeffs``
    and ``normalize_coeffs_8bpc`` of Pillow's Resample.c)."""
    fn, base = PIL_FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ss = 1.0 / filterscale
    coeffs = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [fn((x - center + 0.5) * ss) for x in range(xmin, xmax)]
        total = sum(w)
        for i, wi in enumerate(w):
            k = wi / total if total != 0.0 else wi
            k *= 1 << _PRECISION_BITS
            coeffs[xx, xmin + i] = int(k - 0.5) if k < 0 else int(k + 0.5)
    return coeffs


def pil_resample(img: torch.Tensor, coeffs: np.ndarray, axis: int) -> torch.Tensor:
    """One Pillow pass over ``axis`` of an [H, W, C] uint8-valued tensor:
    integer sums (exact in float64) plus half, shifted down 22 bits, clipped
    to [0, 255]."""
    k = torch.as_tensor(coeffs, dtype=torch.float64, device=img.device)
    x = img.double()
    s = torch.einsum("oh,hwc->owc", k, x) if axis == 0 else torch.einsum("ow,hwc->hoc", k, x)
    s = torch.floor((s + (1 << (_PRECISION_BITS - 1))) / (1 << _PRECISION_BITS))
    return s.clamp(0, 255)


def pil_resize(img: torch.Tensor, out_hw: Tuple[int, int], resample: str = "bicubic"
               ) -> torch.Tensor:
    """Pillow's ``Image.resize(..., BICUBIC | BILINEAR | BOX)`` of an [H, W, C]
    uint8-valued tensor, bit for bit: the horizontal pass, then the vertical
    one (each only where that side changes); a uint8 tensor."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if ow != w:
        img = pil_resample(img, pil_coeffs(w, ow, resample), axis=1)
    if oh != h:
        img = pil_resample(img, pil_coeffs(h, oh, resample), axis=0)
    return img.to(torch.uint8)


def pil_bicubic_resize(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``pil_resize`` with Pillow's bicubic filter."""
    return pil_resize(img, out_hw, "bicubic")


def rgb2ycbcr_y(x: torch.Tensor) -> torch.Tensor:
    """BT.601 Y of an RGB image in [0, 1], NHWC -> NHW."""
    w = x.new_tensor([65.481, 128.553, 24.966]) / 255.0
    return (x * w).sum(dim=-1) + 16.0 / 255.0


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM per batch item of two [0, 1] NHWC batches (Wang et al.: an
    11x11 Gaussian window of sigma 1.5, K1 = 0.01, K2 = 0.03, valid
    padding, averaged over space and channels), in fp32; the variances
    clamped at 0 and the covariance to their Cauchy-Schwarz bound, as in
    JAX (float error otherwise reads marginally above 1)."""
    a, b = a.float(), b.float()
    r = torch.arange(11, dtype=torch.float32, device=a.device) - 5.0
    g = torch.exp(-(r ** 2) / (2.0 * 1.5 ** 2))
    g = g / g.sum()
    c = a.shape[-1]

    def blur(x):  # separable depthwise Gaussian, valid padding
        x = x.permute(0, 3, 1, 2)
        x = F.conv2d(x, g.reshape(1, 1, 11, 1).repeat(c, 1, 1, 1), groups=c)
        return F.conv2d(x, g.reshape(1, 1, 1, 11).repeat(c, 1, 1, 1), groups=c)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = blur(a), blur(b)
    var_a = (blur(a * a) - mu_a ** 2).clamp(min=0.0)
    var_b = (blur(b * b) - mu_b ** 2).clamp(min=0.0)
    bound = torch.sqrt(var_a * var_b)
    cov = torch.minimum(torch.maximum(blur(a * b) - mu_a * mu_b, -bound), bound)
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean(dim=(1, 2, 3))


def psnr(a: torch.Tensor, b: torch.Tensor, crop_border: int = 0,
         test_y: bool = False) -> torch.Tensor:
    """PSNR per batch item of two [0, 1] NHWC batches, in dB (the mean
    squared error in float64), optionally on the BT.601 Y channel and
    without a ``crop_border`` margin."""
    if crop_border:
        a = a[:, crop_border:-crop_border, crop_border:-crop_border]
        b = b[:, crop_border:-crop_border, crop_border:-crop_border]
    if test_y:
        a, b = rgb2ycbcr_y(a)[..., None], rgb2ycbcr_y(b)[..., None]
    mse = ((a.double() - b.double()) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(1.0 / (mse + 1e-12))


class StageClock:
    """The stages of one call as spans (``utils.spans``): each ``lap(stage)``
    ends a ``<prefix>.<stage>`` span, begun at the clock's start or at the
    lap before, with the device's time between two CUDA events on a CUDA
    device; nothing waits for the device. With a dict ``out``, ``finish()``,
    called once the call's result is on the host (a copy that waited for the
    device), adds each stage's seconds to it: the device's on a CUDA device
    (its last event waited for, where the caller's copy has not), else the
    host's. Without ``out`` and with the recorder off, a no-op."""

    def __init__(self, out: Optional[Dict[str, float]], device: torch.device,
                 prefix: str = "pipeline"):
        self.out, self.device, self.prefix = out, device, prefix
        self.laps = []
        self.cur = self._open()

    def _open(self):
        if self.out is None and not spans.enabled():
            return None
        return spans.open_span(None, self.device, push=False)

    def lap(self, stage: str) -> None:
        if self.cur is None:
            return
        self.laps.append((stage, spans.close_span(self.cur, f"{self.prefix}.{stage}")))
        self.cur = self._open()

    def finish(self) -> None:
        """Drop the span the last lap began; fill ``out``."""
        if self.cur is not None:
            spans.cancel(self.cur)
            self.cur = None
        if self.out is not None:
            for stage, sp in self.laps:
                self.out[stage] = self.out.get(stage, 0.0) + sp.seconds()[0]
        self.laps = []
