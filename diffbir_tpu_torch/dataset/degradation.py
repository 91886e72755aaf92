"""Degradation synthesis (BasicSR / Real-ESRGAN lineage), on the host.

Counterpart of ``diffbir_tpu/dataset/degradation.py``'s host half: the
kernel makers (bivariate Gaussian, generalised Gaussian and plateau
kernels, the Real-ESRGAN mixture, the circular sinc low-pass) are its numpy
code, so one generator state gives the same kernels bit for bit; the
Gaussian noise draws from the caller's numpy generator as JAX's does; the
JPEG round trip (``jpeg_compress_np``) is ``dataset/jpeg.py``'s
codec-free one in place of cv2's, equal to it bit for bit.

Its device-side batch functions (``add_gaussian_noise_batch``,
``add_poisson_noise_batch``, ``filter2d_batch``, ``usm_sharp_batch``) are
torch ops here, on whatever device their batch is, each drawing from an
explicit ``torch.Generator``. No path calls them, in JAX as in the port.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.warp import filter2d
from .jpeg import jpeg_round_trip


# --------------------------------------------------------------------------- #
# kernel synthesis
# --------------------------------------------------------------------------- #
def _mesh_grid(kernel_size: int):
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.hstack(
        [xx.reshape(kernel_size * kernel_size, 1), yy.reshape(kernel_size * kernel_size, 1)]
    ).reshape(kernel_size, kernel_size, 2)
    return xy, xx, yy


def _sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    d = np.array([[sig_x**2, 0], [0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def bivariate_gaussian(
    kernel_size: int, sig_x: float, sig_y: float = None, theta: float = 0.0,
    isotropic: bool = True,
) -> np.ndarray:
    xy, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x**2, 0], [0, sig_x**2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    kernel = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", xy, inv, xy))
    return kernel / kernel.sum()


def bivariate_generalized_gaussian(
    kernel_size: int, sig_x: float, sig_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    xy, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x**2, 0], [0, sig_x**2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    quad = np.einsum("hwi,ij,hwj->hw", xy, inv, xy)
    kernel = np.exp(-0.5 * np.power(quad, beta))
    return kernel / kernel.sum()


def bivariate_plateau(
    kernel_size: int, sig_x: float, sig_y: float, theta: float, beta: float,
    isotropic: bool = True,
) -> np.ndarray:
    xy, _, _ = _mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x**2, 0], [0, sig_x**2]])
    else:
        sigma = _sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    quad = np.einsum("hwi,ij,hwj->hw", xy, inv, xy)
    kernel = 1.0 / (np.power(quad, beta) + 1)
    return kernel / kernel.sum()


def _rand(rng: np.random.Generator, lo: float, hi: float) -> float:
    return float(rng.uniform(lo, hi))


def random_mixed_kernels(
    rng: np.random.Generator,
    kernel_list: Sequence[str],
    kernel_prob: Sequence[float],
    kernel_size: int = 21,
    sigma_x_range: Tuple[float, float] = (0.6, 5),
    sigma_y_range: Tuple[float, float] = (0.6, 5),
    rotation_range: Tuple[float, float] = (-np.pi, np.pi),
    betag_range: Tuple[float, float] = (0.5, 8),
    betap_range: Tuple[float, float] = (0.5, 8),
) -> np.ndarray:
    """Sample one kernel from the Real-ESRGAN kernel mixture (:325-388)."""
    kind = rng.choice(kernel_list, p=kernel_prob)
    sx = _rand(rng, *sigma_x_range)
    sy = _rand(rng, *sigma_y_range)
    th = _rand(rng, *rotation_range)
    if kind == "iso":
        return bivariate_gaussian(kernel_size, sx, isotropic=True)
    if kind == "aniso":
        return bivariate_gaussian(kernel_size, sx, sy, th, isotropic=False)
    if kind == "generalized_iso":
        bg = _rand(rng, *betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, sx, 0, bg, True)
    if kind == "generalized_aniso":
        bg = _rand(rng, *betag_range)
        return bivariate_generalized_gaussian(kernel_size, sx, sy, th, bg, False)
    if kind == "plateau_iso":
        bp = _rand(rng, *betap_range)
        return bivariate_plateau(kernel_size, sx, sx, 0, bp, True)
    if kind == "plateau_aniso":
        bp = _rand(rng, *betap_range)
        return bivariate_plateau(kernel_size, sx, sy, th, bp, False)
    raise ValueError(kind)


def circular_lowpass_kernel(cutoff: float, kernel_size: int, pad_to: int = 0) -> np.ndarray:
    """2D sinc filter (:390-418). kernel_size must be odd."""
    from scipy import special

    assert kernel_size % 2 == 1
    r = kernel_size // 2
    yy, xx = np.mgrid[-r: r + 1, -r: r + 1].astype(np.float64)
    dist = np.sqrt(xx**2 + yy**2)
    with np.errstate(divide="ignore", invalid="ignore"):
        kernel = cutoff * special.j1(cutoff * dist) / (2 * np.pi * dist)
    kernel[r, r] = cutoff**2 / (4 * np.pi)
    kernel = kernel / kernel.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


# --------------------------------------------------------------------------- #
# per-sample degradations (CodeformerDataset style)
# --------------------------------------------------------------------------- #
def add_gaussian_noise_np(
    rng: np.random.Generator, img: np.ndarray, sigma: float, gray: bool = False
) -> np.ndarray:
    """img float [0,1] HWC; sigma in [0,255] scale."""
    if gray:
        noise = rng.standard_normal(img.shape[:2])[..., None] * sigma / 255.0
    else:
        noise = rng.standard_normal(img.shape) * sigma / 255.0
    return np.clip(img + noise, 0, 1).astype(np.float32)


def jpeg_compress_np(img: np.ndarray, quality: int) -> np.ndarray:
    """The JPEG round trip of a float [0, 1] RGB HWC image at ``quality``:
    rounded to uint8 (half to even, as numpy's round), coded and decoded by
    ``jpeg.jpeg_round_trip``, back to float [0, 1]. JAX's runs cv2 on the
    channel-flipped image, whose BGR input order makes its YCbCr the same."""
    u8 = torch.from_numpy(np.clip(np.round(np.asarray(img, np.float32) * 255.0), 0, 255)
                          .astype(np.uint8))
    return jpeg_round_trip(u8, int(quality)).numpy().astype(np.float32) / 255.0


# --------------------------------------------------------------------------- #
# batched noise and filters, NHWC in [0, 1] on any device
# --------------------------------------------------------------------------- #
def _per_image(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, 1, 1, 1)


def add_gaussian_noise_batch(img: torch.Tensor, sigma: torch.Tensor, gray_mask: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             draws: Optional[Mapping[str, torch.Tensor]] = None
                             ) -> torch.Tensor:
    """img [B, H, W, C] in [0, 1]; sigma [B] in [0, 1] units; gray_mask [B]
    bool (one [B, H, W, 1] draw for the channels). The standard normals are
    ``draws`` ({"rgb": [B, H, W, C], "gray": [B, H, W, 1]}) when given, else
    drawn from ``generator`` in that order."""
    b, h, w, c = img.shape
    if draws is None:
        draws = {"rgb": torch.randn(img.shape, generator=generator, device=img.device),
                 "gray": torch.randn((b, h, w, 1), generator=generator, device=img.device)}
    sig = _per_image(sigma.to(img.device, img.dtype))
    noise = torch.where(_per_image(gray_mask.to(img.device)), draws["gray"].to(img) * sig,
                        draws["rgb"].to(img) * sig)
    return torch.clamp(img + noise, 0.0, 1.0)


def add_poisson_noise_batch(img: torch.Tensor, scale: torch.Tensor, gray_mask: torch.Tensor,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Poisson shot noise per image at ``scale`` [B]: the counts drawn at
    2^ceil(log2(levels)) times the image rounded to 255 levels, where levels
    is the image's count of distinct levels (at least 2); gray_mask [B]
    bool: one draw on the channel mean for all channels."""
    b = img.shape[0]
    gray = img.mean(-1, keepdim=True)
    is_gray = _per_image(gray_mask.to(img.device))
    src = torch.where(is_gray, gray, img)
    levels = torch.round(src * 255.0)
    present = torch.zeros((b, 256), device=img.device)
    present.scatter_(1, levels.reshape(b, -1).long().clamp(0, 255), 1.0)
    vals = _per_image(2.0 ** torch.ceil(torch.log2(present.sum(1).clamp(min=2.0))))
    rounded = levels / 255.0
    noise_rgb = torch.poisson(rounded * vals, generator=generator) / vals - rounded
    rounded_g = torch.round(gray * 255.0) / 255.0
    noise_g = torch.poisson(rounded_g * vals, generator=generator) / vals - rounded_g
    noise = torch.where(is_gray, noise_g.expand_as(img), noise_rgb)
    return torch.clamp(img + noise * _per_image(scale.to(img.device, img.dtype)), 0.0, 1.0)


def filter2d_batch(img: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Each image of ``img`` [B, H, W, C] correlated with its own kernel of
    ``kernels`` [B, k, k], border reflect (``utils.warp.filter2d``)."""
    return filter2d(img, kernels)


def usm_kernel(radius: int = 50, device=None) -> torch.Tensor:
    """The unsharp mask's 2-D Gaussian of ``radius`` taps (made odd) with
    cv2.getGaussianKernel's default sigma, fp32 on ``device``."""
    if radius % 2 == 0:
        radius += 1
    sigma = 0.3 * ((radius - 1) * 0.5 - 1) + 0.8
    ax = torch.arange(radius, device=device, dtype=torch.float32) - radius // 2
    g = torch.exp(-(ax ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def usm_sharp_batch(img: torch.Tensor, weight: float = 0.5, radius: int = 50,
                    threshold: float = 10.0) -> torch.Tensor:
    """Unsharp masking of [B, H, W, C] in [0, 1] with ``usm_kernel``."""
    kernel = usm_kernel(radius, img.device)
    kernels = kernel.expand(img.shape[0], *kernel.shape)
    residual = img - filter2d_batch(img, kernels)
    mask = (residual.abs() * 255.0 > threshold).to(img.dtype)
    soft_mask = filter2d_batch(mask, kernels)
    sharp = torch.clamp(img + weight * residual, 0.0, 1.0)
    return soft_mask * sharp + (1 - soft_mask) * img
