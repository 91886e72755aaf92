"""Differentiable JPEG round trip in torch, for batches on the card.

Counterpart of ``diffbir_tpu/ops/diffjpeg.py``: RGB to YCbCr, 2x2
average-pool chroma subsampling, the 8x8 DCT and inverse DCT as two 8x8
products per block, quantisation by the standard tables scaled by the
quality factor, rounding either hard or by the differentiable
``round(x) + (x - round(x))^3``, nearest chroma upsampling, back to RGB in
[0, 1]. NHWC, H and W multiples of 16. No path of the port calls it yet, as
none of the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

# standard JPEG base quantization tables (ITU T.81 Annex K)
Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.float32,
)
C_TABLE = np.full((8, 8), 99, np.float32)
C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]
)

# the JPEG DCT-II basis
_alpha = np.array([1.0 / np.sqrt(2)] + [1.0] * 7)
DCT = np.zeros((8, 8), np.float32)
for _k in range(8):
    for _n in range(8):
        DCT[_k, _n] = 0.25 * _alpha[_k] * np.cos((2 * _n + 1) * _k * np.pi / 16)

RGB_TO_YCBCR = np.array([[0.299, 0.587, 0.114],
                         [-0.168736, -0.331264, 0.5],
                         [0.5, -0.418688, -0.081312]], np.float32)
YCBCR_TO_RGB = np.array([[1.0, 0.0, 1.402],
                         [1.0, -0.344136, -0.714136],
                         [1.0, 1.772, 0.0]], np.float32)


def quality_to_factor(quality):
    """JPEG quality in (0, 100] -> the quantisation tables' scale, for a
    float (in float64) or elementwise for a tensor."""
    q = quality if torch.is_tensor(quality) else torch.tensor(quality, dtype=torch.float64)
    # a tensor divided by q: torch computes ``5000.0 / q`` as 5000 x (1 / q)
    factor = torch.where(q < 50, torch.full_like(q, 5000.0) / q / 100.0,
                         (200.0 - q * 2) / 100.0)
    return factor if torch.is_tensor(quality) else float(factor)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H/8 * W/8, 8, 8]."""
    b, h, w = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _unblocks(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    return x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h, w)


def _diff_round(x: torch.Tensor) -> torch.Tensor:
    r = torch.round(x)
    return r + (x - r) ** 3


def quantised_coefficients(x: torch.Tensor, quality: torch.Tensor) -> list:
    """The 8x8 DCT coefficients of ``x`` [B, H, W, 3]'s Y, Cb and Cr (chroma
    2x2 average-pooled) in quantisation steps at ``quality`` [B]: for each
    channel ``(coef / q [B, blocks, 8, 8], q, (h, w))``, ``q`` the base table
    (``Y_TABLE``, ``C_TABLE``) scaled by the quality factor and ``(h, w)`` the
    channel's size."""
    b, h, w, _ = x.shape
    factor = quality_to_factor(quality.to(device=x.device, dtype=x.dtype))[:, None, None, None]
    ycc = (x * 255.0) @ _const(RGB_TO_YCBCR, x).T + _const(np.array([0.0, 128.0, 128.0],
                                                                    np.float32), x)
    d = _const(DCT, x)
    out = []
    for c, table in ((0, Y_TABLE), (1, C_TABLE), (2, C_TABLE)):
        ch = ycc[..., c]
        if c:
            ch = ch.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        q = _const(table, x)[None, None] * factor
        coef = torch.einsum("ki,...ij,lj->...kl", d, _blocks(ch) - 128.0, d)
        out.append((coef / q, q, tuple(ch.shape[1:])))
    return out


def diff_jpeg(x: torch.Tensor, quality: torch.Tensor, differentiable: bool = True
              ) -> torch.Tensor:
    """The JPEG round trip of ``x`` [B, H, W, 3] in [0, 1] (H, W multiples of
    16) at ``quality`` [B] in (0, 100]: the cubic soft rounding when
    ``differentiable``, else the hard round (the degradation synthesis'
    ``DiffJPEG(differentiable=False)``)."""
    d = _const(DCT, x)
    rnd = _diff_round if differentiable else torch.round
    y_rec, cb, cr = (
        _unblocks(torch.einsum("ik,...kl,jl->...ij", d, rnd(steps) * q, d) + 128.0, hh, ww)
        for steps, q, (hh, ww) in quantised_coefficients(x, quality))
    cb_up = cb.repeat_interleave(2, 1).repeat_interleave(2, 2)
    cr_up = cr.repeat_interleave(2, 1).repeat_interleave(2, 2)
    ycc = torch.stack([y_rec, cb_up, cr_up], dim=-1)
    rgb = (ycc + _const(np.array([0.0, -128.0, -128.0], np.float32), x)) \
        @ _const(YCBCR_TO_RGB, x).T
    return torch.clamp(rgb / 255.0, 0.0, 1.0)
