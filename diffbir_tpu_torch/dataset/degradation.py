"""Degradation synthesis (BasicSR / Real-ESRGAN lineage), on the host.

Counterpart of ``diffbir_tpu/dataset/degradation.py``'s host half: the
kernel makers (bivariate Gaussian, generalised Gaussian and plateau
kernels, the Real-ESRGAN mixture, the circular sinc low-pass) are its numpy
code, so one generator state gives the same kernels bit for bit; the
Gaussian noise draws from the caller's numpy generator as JAX's does; the
JPEG round trip (``jpeg_compress_np``) is ``dataset/jpeg.py``'s
codec-free one in place of cv2's, equal to it bit for bit.

The JAX module's device-side batch functions (``add_gaussian_noise_batch``,
``add_poisson_noise_batch``, ``filter2d_batch``, ``usm_sharp_batch``) are
not ported: no path of the JAX package calls them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

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
