"""PNG reading and writing with ``zlib`` alone (no image library).

The formats the CLI reads and writes: 8-bit, non-interlaced PNGs, grey (colour
type 0), RGB (2) or RGBA (6). ``read_png`` undoes the five scanline filters
(so it reads what an encoder with adaptive filtering wrote) and checks each
chunk's CRC; ``write_png`` writes RGB with the "None" filter. Any other
format, bit depth or PNG feature raises ValueError naming the file.
``decode_png`` and ``encode_png`` do the same on bytes (the HTTP front
ends' bodies).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter(data: bytes, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    stride = w * bpp
    if len(data) != h * (stride + 1):
        raise ValueError(f"{path}: image data is {len(data)} bytes, expected {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, f = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = f
        elif ftype == 1:  # Sub: a running sum per channel
            cur = np.cumsum(f.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (f + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            fl, up, cur_l = f.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    ul = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
                cur_l[i] = (fl[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int32)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """The image as uint8 [H, W, C]: C = 1 (grey), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


# the leading bytes of the formats a client may send instead of a PNG
_OTHER_FORMATS = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
                  (b"RIFF", "WebP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def decode_png(buf: bytes, path: str = "the image") -> np.ndarray:
    """``read_png`` of PNG bytes (``path`` names them in errors); another
    format raises ValueError naming it."""
    if not buf.startswith(_SIGNATURE):
        fmt = next((name for magic, name in _OTHER_FORMATS if buf.startswith(magic)),
                   "an unknown format")
        raise ValueError(f"{path}: {fmt}, not a PNG (only PNG is read without an image "
                         "library)")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(buf):
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: bad CRC in the {ctype.decode(errors='replace')} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif ctype[0] & 0x20 == 0:  # an unknown critical chunk (PLTE: palette)
            raise ValueError(f"{path}: unsupported PNG chunk {ctype.decode(errors='replace')}")
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}); 8-bit non-interlaced grey, RGB or RGBA only")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype], path)


def read_rgb(path: str) -> np.ndarray:
    """uint8 [H, W, 3]: grey replicated, alpha dropped (PIL's
    ``convert("RGB")``)."""
    return to_rgb(read_png(path))


def to_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as uint8 [H, W, 3] (``read_rgb``'s conversion)."""
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


def encode_png(img: np.ndarray, path: str = "the image") -> bytes:
    """uint8 [H, W, 3] as the bytes of an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"{path}: a PNG is written from uint8 [H, W, 3], got {img.shape} "
                         f"{img.dtype}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W, 3] as an 8-bit RGB PNG."""
    data = encode_png(img, path)
    with open(path, "wb") as f:
        f.write(data)
