"""The JPEG round trip of the training degradations, without a codec.

``cv2.imencode(".jpg", q)`` followed by ``cv2.imdecode`` (OpenCV's
libjpeg-turbo, baseline, 4:2:0) loses information only in its lossy steps;
the entropy coding between them is lossless. So the round trip is computed
here as those steps alone, in libjpeg-turbo's integer arithmetic:

- RGB -> YCbCr with ``jccolor.c``'s 16-bit fixed-point tables;
- chroma 2x2 box downsampling with the alternating 1, 2 rounding bias
  (``h2v2_downsample``), after the right edge of the full-resolution planes
  is replicated to whole 16-pixel chroma blocks and the bottom to an even
  row; the downsampled rows replicated to whole blocks below;
- luma replicated to whole 8x8 blocks;
- the islow forward DCT (``jfdctint.c``: 13-bit constants, 2 pass bits)
  on level-shifted blocks, quantised by the IJG tables scaled by quality
  (``jpeg_quality_scaling``, baseline-clamped to [1, 255]) with
  libjpeg-turbo's reciprocal division (``compute_reciprocal``: round half
  away from zero);
- dequantisation and the islow inverse DCT (``jidctint.c``), clamped to
  [0, 255];
- "fancy" triangle upsampling of the chroma planes (``h2v2_fancy_upsample``,
  edge rows and columns replicated) and YCbCr -> RGB with ``jdcolor.c``'s
  tables.

Everything is exact integer math on int64 tensors, on the device of the
input. ``tests/test_torch_dataset.py`` holds it against cv2 over qualities
30-95.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)
CHROMA_QT = np.full((8, 8), 99, np.int64)
CHROMA_QT[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]

CONST_BITS, PASS1_BITS = 13, 2
# FIX(x) = round(x * 2^13) of jfdctint.c / jidctint.c
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``'s table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(x: torch.Tensor, dim: int, first: bool) -> torch.Tensor:
    d = x.unbind(dim)
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, PASS1_BITS), _descale(tmp10 - tmp11, PASS1_BITS)
        n = CONST_BITS + PASS1_BITS
    z1 = (tmp12 + tmp13) * F0541
    out[2] = _descale(z1 + tmp13 * F0765, n)
    out[6] = _descale(z1 - tmp12 * F1847, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0298, tmp5 * F2053, tmp6 * F3072, tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return torch.stack(out, dim)


def _idct_pass(x: torch.Tensor, dim: int, first: bool) -> torch.Tensor:
    d = x.unbind(dim)
    z1 = (d[2] + d[6]) * F0541
    tmp2, tmp3 = z1 - d[6] * F1847, z1 + d[2] * F0765
    tmp0, tmp1 = (d[0] + d[4]) << CONST_BITS, (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * F0298, tmp1 * F2053, tmp2 * F3072, tmp3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    out = (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
           tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)
    return torch.stack([_descale(o, n) for o in out], dim)


def _reciprocals(divisors: np.ndarray):
    """libjpeg-turbo's ``compute_reciprocal`` for 16-bit DCT elements:
    (reciprocal, correction, total shift) per divisor."""
    recip, corr, shift = (np.zeros(divisors.shape, np.int64) for _ in range(3))
    for i, d in np.ndenumerate(divisors):
        d = int(d)
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip, corr, shift


def _quantize(coef: torch.Tensor, qt: np.ndarray) -> torch.Tensor:
    """Round ``coef / (8 qt)`` half away from zero, by reciprocals."""
    recip, corr, shift = (torch.as_tensor(t, device=coef.device) for t in _reciprocals(qt * 8))
    mag = ((coef.abs() + corr) * recip) >> shift
    return torch.where(coef < 0, -mag, mag)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)


def _unblocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return blocks.reshape(h // 8, w // 8, 8, 8).permute(0, 2, 1, 3).reshape(h, w)


def _replicate(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The plane's last row and column repeated out to h x w."""
    ph, pw = h - plane.shape[0], w - plane.shape[1]
    if ph == 0 and pw == 0:
        return plane
    return F.pad(plane[None, None].double(), (0, pw, 0, ph), mode="replicate")[0, 0].long()


def _code_plane(plane: torch.Tensor, qt: np.ndarray) -> torch.Tensor:
    """A block-aligned sample plane through FDCT, quantisation,
    dequantisation and IDCT; samples clamped to [0, 255]."""
    h, w = plane.shape
    coef = _fdct_pass(_fdct_pass(_blocks(plane) - 128, 2, True), 1, False)
    deq = _quantize(coef, qt) * torch.as_tensor(qt, device=plane.device)
    out = _idct_pass(_idct_pass(deq, 1, True), 2, False) + 128
    return _unblocks(out.clamp(0, 255), h, w)


def _downsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = 1 + torch.arange(s.shape[1], device=plane.device) % 2
    return (s + bias) >> 2


def _upsample_h2v2(plane: torch.Tensor) -> torch.Tensor:
    """``h2v2_fancy_upsample``: 9/16, 3/16, 3/16, 1/16 of the nearest
    samples, rounding alternately up and down, edges replicated."""
    near = plane * 3
    above = near + torch.cat([plane[:1], plane[:-1]])
    below = near + torch.cat([plane[1:], plane[-1:]])
    rows = torch.stack([above, below], 1).reshape(-1, plane.shape[1])  # colsums
    left = torch.cat([rows[:, :1], rows[:, :-1]], 1)
    right = torch.cat([rows[:, 1:], rows[:, -1:]], 1)
    even, odd = (rows * 3 + left + 8) >> 4, (rows * 3 + right + 7) >> 4
    return torch.stack([even, odd], 2).reshape(rows.shape[0], -1)


def jpeg_round_trip(rgb: torch.Tensor, quality: int) -> torch.Tensor:
    """uint8 [H, W, 3] RGB -> its JPEG round trip at ``quality``, uint8 RGB."""
    h, w, _ = rgb.shape
    x = rgb.long()
    r, g, b = x.unbind(-1)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    half = (128 << 16) + 32767
    cb = (-11059 * r - 21709 * g + 32768 * b + half) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + half) >> 16

    def up8(n):
        return -(-n // 8) * 8

    y = _code_plane(_replicate(y, up8(h), up8(w)), quant_table(LUMA_QT, quality))[:h, :w]
    ch, cw = -(-h // 2), -(-w // 2)  # the downsampled sizes
    chroma = []
    for c in (cb, cr):
        small = _downsample_h2v2(_replicate(c, 2 * ch, 16 * -(-w // 16)))
        coded = _code_plane(_replicate(small, up8(ch), small.shape[1]),
                            quant_table(CHROMA_QT, quality))
        chroma.append(_upsample_h2v2(coded[:ch, :cw])[:h, :w])
    cb, cr = (c - 128 for c in chroma)
    red = y + ((91881 * cr + 32768) >> 16)
    green = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    blue = y + ((116130 * cb + 32768) >> 16)
    return torch.stack([red, green, blue], -1).clamp(0, 255).to(torch.uint8)
