"""Tensor counterparts of the OpenCV calls the face helper makes.

``diffbir_tpu/utils/face.py`` aligns and pastes faces with OpenCV on the
host. These functions compute the same results with torch on the device of
their input (no OpenCV beside the port), each held against ``cv2`` in
``tests/test_torch_face.py``. Images are HWC (or HW) tensors, uint8 or fp32;
affine matrices are [2, 3] fp64 tensors, mapping source to destination
pixels as OpenCV's do.

- ``similarity_lmeds``: ``cv2.estimateAffinePartial2D(method=cv2.LMEDS)``.
  OpenCV draws a few random 2-point subsets; here every pair is tried (5
  landmarks: 10 pairs, deterministic), the model with the least median
  squared error kept, the inliers taken by OpenCV's threshold from that
  median, and the similarity refitted on them in closed form (OpenCV
  refines with Levenberg-Marquardt, which reaches the same least-squares
  optimum of this linear model).
- ``invert_affine``: ``cv2.invertAffineTransform``, in fp64.
- ``warp_affine``: ``cv2.warpAffine`` with bilinear interpolation (its
  INTER_AREA flag, 3, acts as bilinear there too) and constant, reflect or
  reflect-101 borders. The OpenCV of this repository's tests computes it in
  fp32: the inverse map cast to fp32, the source x as one fused multiply-add
  on a per-row fp32 offset, the two horizontal lerps and the vertical one as
  fused multiply-adds, uint8 rounded half to even (fp32 input: bit-equal;
  uint8: within one level where an fp32 sum falls on .5).
- ``resize_linear``: ``cv2.resize(INTER_LINEAR)``. uint8 takes OpenCV's
  fixed-point path bit for bit: fp32 positions, 11-bit weights, exact
  horizontal sums, and the vertical pass's truncating 16-bit products
  (``(((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2) >> 2``); the
  edge columns clamp their weights, the edge rows only their indices.
  fp32 takes the same positions with fp32 weights.
- ``resize_lanczos4``: ``cv2.resize(INTER_LANCZOS4)`` on uint8, bit for bit:
  8 taps, OpenCV's fp32 coefficients rounded to 11 bits, exact integer sums,
  edges replicated. Equal sizes copy, as OpenCV does.
- ``erode``: ``cv2.erode`` with a ones kernel: a min filter anchored at
  k // 2, the border +inf (the image edge does not erode).
- ``gaussian_blur``: ``cv2.GaussianBlur`` of a batch on fp32, separable,
  border reflect-101; sigma <= 0 takes 0.3 * ((k - 1) / 2 - 1) + 0.8, and
  for k <= 9 OpenCV's fixed small kernels (this OpenCV has one for 9 as
  well).

The training degradations (``dataset/``) take three more on fp32:
``resize`` (``cv2.resize`` with INTER_AREA, INTER_LINEAR or INTER_CUBIC and
OpenCV's choices between them) and ``filter2d`` (``cv2.filter2D`` of a batch,
one kernel an image).
"""

from __future__ import annotations

import itertools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Size = Tuple[int, int]  # (width, height), OpenCV's order


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c with one rounding (through fp64)."""
    return (a.double() * b.double() + c.double()).float()


# --------------------------------------------------------------------------- #
# affine estimation
# --------------------------------------------------------------------------- #
def _two_point_models(src: torch.Tensor, dst: torch.Tensor, pairs) -> torch.Tensor:
    """The similarity through each pair of points (OpenCV's
    ``AffinePartial2DEstimatorCallback::runKernel``): [P, 2, 3] fp64."""
    i, j = pairs[:, 0], pairs[:, 1]
    x1, y1, x2, y2 = src[i, 0], src[i, 1], src[j, 0], src[j, 1]
    X1, Y1, X2, Y2 = dst[i, 0], dst[i, 1], dst[j, 0], dst[j, 1]
    d = 1.0 / ((x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2))
    s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1) - (X1 * y2 - X2 * y1) * (y1 - y2)
              - (X1 * x2 - X2 * x1) * (x1 - x2))
    s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1) - (Y1 * x2 - Y2 * x1) * (x1 - x2)
              - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return torch.stack([torch.stack([s0, -s1, s2], -1), torch.stack([s1, s0, s3], -1)], -2)


def _sq_errors(models: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared transfer errors [P, N] in fp32 (OpenCV's ``computeError``)."""
    h = models.float()
    s, t = src.float(), dst.float()
    a = h[:, 0, 0, None] * s[:, 0] + h[:, 0, 1, None] * s[:, 1] + h[:, 0, 2, None] - t[:, 0]
    b = h[:, 1, 0, None] * s[:, 0] + h[:, 1, 1, None] * s[:, 1] + h[:, 1, 2, None] - t[:, 1]
    return a * a + b * b


def similarity_lstsq(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The 4-DOF similarity (scale, rotation, translation) of least squared
    error from ``src`` to ``dst`` ([N, 2]): [2, 3] fp64."""
    s, d = src.double(), dst.double()
    ms, md = s.mean(0), d.mean(0)
    sc, dc = s - ms, d - md
    n = (sc * sc).sum()
    a = (sc[:, 0] * dc[:, 0] + sc[:, 1] * dc[:, 1]).sum() / n
    b = (sc[:, 0] * dc[:, 1] - sc[:, 1] * dc[:, 0]).sum() / n
    tx = md[0] - (a * ms[0] - b * ms[1])
    ty = md[1] - (b * ms[0] + a * ms[1])
    return torch.stack([torch.stack([a, -b, tx]), torch.stack([b, a, ty])])


def similarity_lmeds(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``cv2.estimateAffinePartial2D(src, dst, method=cv2.LMEDS)[0]`` for a
    few points (every pair tried; see the module's notes): [2, 3] fp64 on
    ``src``'s device."""
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    n = src.shape[0]
    if n < 2:
        raise ValueError(f"similarity_lmeds needs 2 points or more, got {n}")
    if n == 2:
        return similarity_lstsq(src, dst)
    pairs = torch.tensor(list(itertools.combinations(range(n), 2)), device=src.device)
    models = _two_point_models(src.double(), dst.double(), pairs)
    medians = _sq_errors(models, src, dst).sort(dim=1).values[:, n // 2]
    best = int(torch.argmin(medians))
    sigma = max(2.5 * 1.4826 * (1 + 5.0 / (n - 2)) * math.sqrt(
        float(medians[best])), 0.001)
    inliers = _sq_errors(models[best:best + 1], src, dst)[0] <= np.float32(sigma * sigma)
    return similarity_lstsq(src[inliers], dst[inliers])


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """``cv2.invertAffineTransform`` in fp64."""
    m = torch.as_tensor(m, dtype=torch.float64)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = torch.where(det != 0, 1.0 / det, torch.zeros_like(det))
    a11, a22, a12, a21 = m[1, 1] * det, m[0, 0] * det, -m[0, 1] * det, -m[1, 0] * det
    b1 = -a11 * m[0, 2] - a12 * m[1, 2]
    b2 = -a21 * m[0, 2] - a22 * m[1, 2]
    return torch.stack([torch.stack([a11, a12, b1]), torch.stack([a21, a22, b2])])


# --------------------------------------------------------------------------- #
# warping
# --------------------------------------------------------------------------- #
BORDERS = ("constant", "reflect", "reflect101")


def _border_index(i: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """OpenCV's ``borderInterpolate`` for reflect ("fedcba|abcdef") and
    reflect-101 ("gfedcb|abcdef"), any distance from the image."""
    if n == 1:
        return torch.zeros_like(i)
    if mode == "reflect":
        period = 2 * n
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - 1 - j, j)
    period = 2 * n - 2
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


def warp_affine(img: torch.Tensor, m: torch.Tensor, dsize: Size, border: str = "constant",
                border_value=0.0) -> torch.Tensor:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_LINEAR, borderMode=,
    borderValue=)`` on an HWC or HW tensor, uint8 or fp32 (see the module's
    notes); ``border_value`` a number or one per channel."""
    if border not in BORDERS:
        raise ValueError(f"border {border!r}: one of {BORDERS}")
    squeeze = img.dim() == 2
    x = (img[..., None] if squeeze else img).float()
    h, w, c = x.shape
    dev = x.device
    mi = invert_affine(m).to(dev).float()
    wo, ho = dsize
    xs = torch.arange(wo, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(ho, dtype=torch.float32, device=dev)[:, None]
    sx = _fma(mi[0, 0].expand(ho, wo), xs.expand(ho, wo), (mi[0, 1] * ys + mi[0, 2]).expand(ho, wo))
    sy = _fma(mi[1, 0].expand(ho, wo), xs.expand(ho, wo), (mi[1, 1] * ys + mi[1, 2]).expand(ho, wo))
    x0, y0 = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    bv = torch.as_tensor(border_value, dtype=torch.float32, device=dev).expand(c)

    def pixel(yi, xi):
        if border == "constant":
            inside = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
            v = x[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
            return torch.where(inside, v, bv)
        return x[_border_index(yi, h, border), _border_index(xi, w, border)]

    p00, p01 = pixel(y0, x0), pixel(y0, x0 + 1)
    p10, p11 = pixel(y0 + 1, x0), pixel(y0 + 1, x0 + 1)
    top = _fma(ax.expand_as(p00), p01 - p00, p00)
    bottom = _fma(ax.expand_as(p10), p11 - p10, p10)
    out = _fma(ay.expand_as(top), bottom - top, top)
    if img.dtype == torch.uint8:
        out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out


# --------------------------------------------------------------------------- #
# resizing
# --------------------------------------------------------------------------- #
def _out_size(hw: Tuple[int, int], dsize: Optional[Size], fx, fy) -> Tuple[Size, float, float]:
    """(dsize, inverse scale x, inverse scale y) as ``cv2.resize`` sets them."""
    h, w = hw
    if dsize is not None and dsize[0] > 0 and dsize[1] > 0:
        return (int(dsize[0]), int(dsize[1])), dsize[0] / w, dsize[1] / h
    if not fx or not fy:
        raise ValueError("resize: give dsize, or fx and fy")
    return (int(np.rint(w * fx)), int(np.rint(h * fy))), float(fx), float(fy)


def _linear_taps(src: int, dst: int, inv_scale: float, clamp: bool):
    """Source indices (2 per output) and fp32 weights (1 - f, f) of OpenCV's
    bilinear resize along one axis; ``clamp``: the columns' rule (weights
    (1, 0) past either edge), else the rows' (indices clamped only)."""
    f = ((np.arange(dst) + 0.5) * (1.0 / inv_scale) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0
        s[low], s[high] = 0, src - 1
    idx = np.stack([np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1)], 1)
    return idx, np.stack([np.float32(1) - f, f], 1).astype(np.float32)


def resize_linear(img: torch.Tensor, dsize: Optional[Size] = None, fx: float = None,
                  fy: float = None) -> torch.Tensor:
    """``cv2.resize(img, dsize, fx=, fy=, interpolation=INTER_LINEAR)`` on an
    HWC or HW uint8 or fp32 tensor (see the module's notes). An exact 2x
    downscale, where OpenCV switches to INTER_AREA, raises ValueError."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    h, w = x.shape[:2]
    (wo, ho), isx, isy = _out_size((h, w), dsize, fx, fy)
    if (wo, ho) == (w, h):
        return img.clone()
    if isx == 0.5 and isy == 0.5:
        raise ValueError("resize_linear: an exact 2x downscale (OpenCV's INTER_AREA case)")
    dev = x.device
    xi, xa = _linear_taps(w, wo, isx, True)
    yi, ya = _linear_taps(h, ho, isy, False)
    xi, yi = torch.from_numpy(xi).to(dev), torch.from_numpy(yi).to(dev)
    if x.dtype == torch.uint8:
        a = torch.from_numpy(np.rint(xa * np.float32(2048)).astype(np.int64)).to(dev)
        b = torch.from_numpy(np.rint(ya * np.float32(2048)).astype(np.int64)).to(dev)
        s = x.long()
        rows = s[:, xi[:, 0]] * a[:, 0, None] + s[:, xi[:, 1]] * a[:, 1, None]
        r0, r1 = rows[yi[:, 0]] >> 4, rows[yi[:, 1]] >> 4
        out = (((r0 * b[:, 0, None, None]) >> 16) + ((r1 * b[:, 1, None, None]) >> 16) + 2) >> 2
        out = out.clamp(0, 255).to(torch.uint8)
    else:
        a, b = torch.from_numpy(xa).to(dev), torch.from_numpy(ya).to(dev)
        s = x.float()
        rows = s[:, xi[:, 0]] * a[:, 0, None] + s[:, xi[:, 1]] * a[:, 1, None]
        out = rows[yi[:, 0]] * b[:, 0, None, None] + rows[yi[:, 1]] * b[:, 1, None, None]
    return out[..., 0] if squeeze else out


def _area_fast(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    h, w, c = x.shape
    blocks = x.reshape(h // sy, sy, w // sx, sx, c)
    return blocks.sum(dim=(1, 3)) * np.float32(1.0 / (sx * sy))


def _area_weights(src: int, dst: int, scale: float) -> np.ndarray:
    """[dst, src] fp32 weights of OpenCV's ``computeResizeAreaTab``: each
    output averages the source cells it covers, partial cells by their
    covered fraction."""
    m = np.zeros((dst, src), np.float32)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def _area_up_weights(src: int, dst: int, inv_scale: float, clamp: bool) -> np.ndarray:
    """[dst, src] fp32 weights of INTER_AREA where OpenCV does not shrink
    both sides: bilinear taps at floor(d * scale) with the fraction
    ``(d + 1) - (s + 1) / scale`` (its ``area_mode``), the bilinear edge
    rules."""
    scale = 1.0 / inv_scale
    m = np.zeros((dst, src), np.float32)
    for d in range(dst):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv_scale)
        f = np.float32(0) if f <= 0 else np.float32(f - np.floor(f))
        if clamp and s >= src - 1:
            s, f = src - 1, np.float32(0)
        m[d, min(max(s, 0), src - 1)] += np.float32(1) - f
        m[d, min(max(s + 1, 0), src - 1)] += f
    return m


def _cubic_weights(src: int, dst: int, inv_scale: float) -> np.ndarray:
    """[dst, src] fp32 weights of OpenCV's bicubic resize (a = -0.75, fp32
    ``interpolateCubic``), taps past either edge on the edge sample."""
    a = np.float32(-0.75)
    x = ((np.arange(dst) + 0.5) * (1.0 / inv_scale) - 0.5).astype(np.float32)
    s = np.floor(x).astype(np.int64)
    x = (x - s.astype(np.float32)).astype(np.float32)
    one = np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    m = np.zeros((dst, src), np.float32)
    for k, c in enumerate((c0, c1, c2, c3)):
        np.add.at(m, (np.arange(dst), np.clip(s - 1 + k, 0, src - 1)), c.astype(np.float32))
    return m


def _separable(x: torch.Tensor, wy: np.ndarray, wx: np.ndarray) -> torch.Tensor:
    """Rows by ``wx`` [wo, w], then columns by ``wy`` [ho, h], in fp32."""
    dev = x.device
    rows = torch.einsum("pw,hwc->hpc", torch.from_numpy(wx).to(dev), x)
    return torch.einsum("oh,hpc->opc", torch.from_numpy(wy).to(dev), rows)


def resize(img: torch.Tensor, dsize: Size, interpolation: str) -> torch.Tensor:
    """``cv2.resize(img, dsize, interpolation=INTER_AREA | INTER_LINEAR |
    INTER_CUBIC)`` of an HWC fp32 tensor ("area", "linear", "cubic"), with
    OpenCV's choices: equal sizes copy; bilinear at an exact 2x shrink of
    both sides is the area average; area shrinking both sides averages
    cells (whole blocks at integer factors), else it takes bilinear taps
    at its own positions; cubic's edges replicate. Sums in fp32, in another
    order than OpenCV's (``tests/test_torch_dataset.py`` holds each against
    cv2)."""
    x = img.float()
    h, w = x.shape[:2]
    wo, ho = int(dsize[0]), int(dsize[1])
    if (wo, ho) == (w, h):
        return x.clone()
    isx, isy = wo / w, ho / h
    sx, sy = 1.0 / isx, 1.0 / isy
    if interpolation == "linear":
        if sx == 2.0 and sy == 2.0:
            return _area_fast(x, 2, 2)
        return resize_linear(x, (wo, ho))
    if interpolation == "cubic":
        return _separable(x, _cubic_weights(h, ho, isy), _cubic_weights(w, wo, isx))
    if interpolation != "area":
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if sx >= 1 and sy >= 1:
        ix, iy = round(sx), round(sy)
        if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
            return _area_fast(x, iy, ix)
        return _separable(x, _area_weights(h, ho, sy), _area_weights(w, wo, sx))
    return _separable(x, _area_up_weights(h, ho, isy, False),
                      _area_up_weights(w, wo, isx, True))


def filter2d(imgs: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """``cv2.filter2D(img, -1, kernel)`` of each fp32 [H, W, C] image of
    ``imgs`` [B, H, W, C] with its own odd-sized kernel of ``kernels`` [B,
    k, k]: correlation about the centre, border reflect-101, in fp32 (OpenCV
    takes a DFT for large kernels: sums in another order)."""
    b, h, w, c = imgs.shape
    k = kernels.shape[-1]
    x = imgs.float().permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.pad(x, (k // 2,) * 4, mode="reflect")
    weight = kernels.float().to(imgs.device).repeat_interleave(c, 0)[:, None]
    return _conv2d(x, weight, b * c).reshape(b, c, h, w).permute(0, 2, 3, 1)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1),
               (-_S45, _S45))


def _lanczos4_taps(src: int, dst: int, inv_scale: float):
    """Source indices [dst, 8] (edges replicated) and 11-bit integer weights
    of OpenCV's ``interpolateLanczos4`` along one axis."""
    f = ((np.arange(dst) + 0.5) * (1.0 / inv_scale) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    y0 = -(f.astype(np.float64) + 3) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.zeros((dst, 8), np.float32)
    total = np.zeros(dst, np.float32)
    for i in range(8):
        yy = ((f + np.float32(3)).astype(np.float32) - np.float32(i)).astype(np.float32)
        y = -yy.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            v = ((_LANCZOS_CS[i][0] * s0 + _LANCZOS_CS[i][1] * c0) / (y * y)).astype(np.float32)
        coeffs[:, i] = np.where(np.abs(yy) >= np.float32(1e-6), v, np.float32(1e30))
        total = (total + coeffs[:, i]).astype(np.float32)
    coeffs = (coeffs * (np.float32(1) / total)[:, None]).astype(np.float32)
    weights = np.clip(np.rint((coeffs * np.float32(2048)).astype(np.float32)), -32768, 32767)
    idx = np.clip(s[:, None] + np.arange(-3, 5)[None, :], 0, src - 1)
    return idx, weights.astype(np.int64)


def resize_lanczos4(img: torch.Tensor, dsize: Size) -> torch.Tensor:
    """``cv2.resize(img, dsize, interpolation=INTER_LANCZOS4)`` on an HWC
    uint8 tensor, bit for bit."""
    if img.dtype != torch.uint8:
        raise ValueError(f"resize_lanczos4 takes uint8, not {img.dtype}")
    h, w = img.shape[:2]
    wo, ho = int(dsize[0]), int(dsize[1])
    if (wo, ho) == (w, h):
        return img.clone()
    dev = img.device
    xi, a = (torch.from_numpy(t).to(dev) for t in _lanczos4_taps(w, wo, wo / w))
    yi, b = (torch.from_numpy(t).to(dev) for t in _lanczos4_taps(h, ho, ho / h))
    s = img.long()
    rows = sum(s[:, xi[:, k]] * a[:, k, None] for k in range(8))
    out = sum(rows[yi[:, k]] * b[:, k, None, None] for k in range(8))
    return ((out + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)


# --------------------------------------------------------------------------- #
# morphology and blur
# --------------------------------------------------------------------------- #
def erode(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """``cv2.erode(img, np.ones((k, k), np.uint8))`` on an fp32 HW tensor."""
    lo = ksize // 2
    x = F.pad(img.float()[None, None], (lo, ksize - 1 - lo, lo, ksize - 1 - lo),
              value=float("inf"))
    return -F.max_pool2d(-x, ksize, stride=1)[0, 0]


# OpenCV's fixed kernels for odd sizes up to 9 when sigma <= 0
_SMALL_GAUSSIAN = {
    1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [v / 256 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4)],
}


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` as fp32."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[ksize], np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x).astype(np.float32).astype(np.float64)
    return (t * (1.0 / t.sum())).astype(np.float32)


def _conv2d(x: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """``F.conv2d`` summing in fp32 as OpenCV does: on the card with cuDNN's
    TF32 off for the call (a process's default rounds its operands to 10
    mantissa bits)."""
    if not x.is_cuda:
        return F.conv2d(x, weight, groups=groups)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(x, weight, groups=groups)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def gaussian_blur(imgs: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` of each fp32 [H, W,
    C] image of ``imgs`` [B, H, W, C]: rows, then columns, each a grouped
    convolution, border reflect-101."""
    b, h, w, c = imgs.shape
    k = torch.from_numpy(gaussian_kernel(ksize, sigma)).to(imgs.device)
    r = ksize // 2
    x = imgs.float().permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = x.index_select(3, _border_index(torch.arange(-r, w + r, device=x.device), w,
                                        "reflect101"))
    x = _conv2d(x, k.view(1, 1, 1, ksize).expand(b * c, 1, 1, ksize), b * c)
    x = x.index_select(2, _border_index(torch.arange(-r, h + r, device=x.device), h,
                                        "reflect101"))
    x = _conv2d(x, k.view(1, 1, ksize, 1).expand(b * c, 1, ksize, 1), b * c)
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)
