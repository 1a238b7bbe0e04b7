"""Image decoding and resampling for the file readers, without an image
library (the card's machine has no cv2, PIL or torchvision).

``read_png`` and ``read_jpeg`` decode with ``csrc/image.cpp`` (built with
the host ``c++`` at first use by ``ops/_build.image_lib``; the ctypes call
releases the GIL, so a prefetch thread decodes while the loop runs):

- PNG: the chunks are parsed and CRC-checked here, the IDAT stream is
  inflated by ``zlib`` and the C++ undoes the row filters. Colour reads
  8-bit grey, grey+alpha, RGB and RGBA as ``cv2.imread(IMREAD_COLOR)``
  followed by ``COLOR_BGR2RGB`` gives them (alpha dropped, grey
  replicated); depth reads 8- or 16-bit grey as ``IMREAD_UNCHANGED`` gives
  it. Interlaced, palette and 16-bit colour files raise.
- JPEG: baseline Huffman decoding as libjpeg-turbo does it with its
  default settings (islow IDCT, fancy upsampling, its fixed-point YCbCr
  tables), so the RGB equals cv2's. Progressive, arithmetic-coded and
  12-bit files and an EXIF orientation other than 1 raise.

The resamplers are the three ``cv2.resize`` interpolations and the
``cv2.initUndistortRectifyMap`` + ``cv2.remap`` undistortion that the JAX
reader applies (``mipsfusion_tpu/datasets/dataset.py``), in numpy on
float32; ``tests/test_torch_image.py`` holds each to cv2.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

from ..ops import _build

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# samples a pixel for each PNG colour type (palette: not read)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def decode_png(data: bytes, color: bool = True, name: str = "<png>"
               ) -> np.ndarray:
    """A PNG's pixels: with ``color`` uint8 RGB [H, W, 3], else the grey
    samples [H, W] (uint8 or uint16) as stored."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{name}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{name}: CRC error in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not read")
    if ctype == 3:
        raise ValueError(f"{name}: palette PNG is not read")
    if ctype not in _PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f"{name}: PNG colour type {ctype} at {depth} "
                         "bits is not read (8-bit grey, grey+alpha, RGB, "
                         "RGBA; 16-bit grey)")
    if depth == 16 and ctype != 0:
        raise ValueError(f"{name}: 16-bit colour PNG is not read (16-bit "
                         "grey only)")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    out = np.empty((h, w * bpp), np.uint8)
    rc = _build.image_lib().png_unfilter(raw, len(raw), h, w * bpp, bpp,
                                         out.ctypes.data)
    if rc:
        raise ValueError(f"{name}: " + ("unknown PNG filter type" if rc == 1
                                        else "PNG image data too short"))
    if depth == 16:
        px = out.view(">u2").astype(np.uint16).reshape(h, w)
    else:
        px = out.reshape(h, w, ch)
    if not color:
        if ctype != 0:
            raise ValueError(f"{name}: depth PNG must be grey, not colour "
                             f"type {ctype}")
        return px if depth == 16 else px[..., 0]
    if depth == 16:
        raise ValueError(f"{name}: 16-bit grey PNG read as colour")
    if ch <= 2:                                   # grey (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_jpeg(data: bytes, name: str = "<jpeg>") -> np.ndarray:
    """A baseline JPEG's pixels as uint8 RGB [H, W, 3]."""
    lib = _build.image_lib()
    err = ctypes.create_string_buffer(256)
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                     ctypes.byref(nc), err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), w.value, h.value, out.ctypes.data,
                       err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def read_png(path: str, color: bool = True) -> np.ndarray:
    return decode_png(_read_bytes(path), color, path)


def read_jpeg(path: str) -> np.ndarray:
    return decode_jpeg(_read_bytes(path), path)


def read_color(path: str) -> np.ndarray:
    """A colour frame (PNG or JPEG, told by its first bytes, as cv2 tells
    them) as uint8 RGB [H, W, 3]."""
    data = _read_bytes(path)
    if data[:8] == _PNG_SIG:
        return decode_png(data, True, path)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: neither PNG nor JPEG")


def read_depth(path: str) -> np.ndarray:
    """A depth frame: a grey PNG's samples [H, W] as stored."""
    return read_png(path, color=False)


# ---------------------------------------------------------------------------
# resampling (float32 images [H, W] or [H, W, C])
# ---------------------------------------------------------------------------

def _linear_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """cv2's INTER_LINEAR taps along one axis: half-pixel centres, the
    source coordinate and its fraction in float64, the weight then rounded
    to float32, the edges clamped (a clamped tap has weight (1, 0))."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    f[(i0 < 0) | (i0 >= src - 1)] = 0.0
    i0 = np.clip(i0, 0, src - 1)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, f


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H))`` (INTER_LINEAR) on float32: a horizontal
    pass, then a vertical one, each ``a * (1 - f) + b * f`` in float32."""
    W, H = size
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    x0, x1, fx = _linear_taps(W, w)
    y0, y1, fy = _linear_taps(H, h)
    one = np.float32(1.0)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    rows = img[:, x0] * (one - fx)[ex] + img[:, x1] * fx[ex]
    ay = (one - fy).reshape((-1,) + (1,) * (img.ndim - 1))
    by = fy.reshape((-1,) + (1,) * (img.ndim - 1))
    return (rows[y0] * ay + rows[y1] * by).astype(np.float32)


def _area_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's INTER_AREA weights along one axis for a downsample: output d
    covers the source interval [d s, (d + 1) s), s = src / dst, each
    sample weighted by its overlap with it. Returns the taps' indices and
    weights, [dst, k] each (weight 0 past an interval's end); a row sums
    to 1."""
    s = src / dst
    k = int(np.ceil(s)) + 1
    lo = np.arange(dst) * s
    hi = np.minimum(lo + s, src)
    idx = np.floor(lo).astype(np.int64)[:, None] + np.arange(k)
    w = np.clip(np.minimum(hi[:, None], idx + 1)
                - np.maximum(lo[:, None], idx), 0.0, None)
    w /= w.sum(axis=1, keepdims=True)
    return np.minimum(idx, src - 1), w


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=INTER_AREA)`` for a
    downsample: each output pixel the mean of its source area, summed in
    float64 and rounded to float32 (cv2 sums in float32, in its own
    order)."""
    W, H = size
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    if H > h or W > w:
        raise ValueError("resize_area: only downsampling")
    out = img.astype(np.float64)
    for axis, (dst, src) in enumerate(((H, h), (W, w))):
        idx, wt = _area_taps(dst, src)
        shape = (-1,) + (1,) * (img.ndim - 1 - axis)
        out = sum(np.take(out, idx[:, j], axis=axis) * wt[:, j].reshape(shape)
                  for j in range(idx.shape[1]))
    return out.astype(np.float32)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=INTER_NEAREST)``: output
    pixel d takes source floor(d * src / dst) (the block's first sample,
    not its centre)."""
    W, H = size
    h, w = img.shape[:2]

    def idx(dst, src):
        return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src)))
                          .astype(np.int64), src - 1)
    return img[idx(H, h)][:, idx(W, w)]


# ---------------------------------------------------------------------------
# undistortion
# ---------------------------------------------------------------------------

def undistort_maps(K: np.ndarray, dist, size: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.initUndistortRectifyMap(K, dist, None, K, (w, h), CV_32FC1)``:
    for each output pixel the source pixel (x, y) [h, w] float32, through
    the radial (k1, k2, k3) and tangential (p1, p2) model in float64."""
    w, h = size
    d = np.zeros(5)
    d[:len(dist)] = np.asarray(dist, np.float64)[:5]
    k1, k2, p1, p2, k3 = d
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (x - cx) / fx
    y = (y - cy) / fy
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2.0 * x2)) + cx
    v = fy * (y * kr + p1 * (r2 + 2.0 * y2) + p2 * _2xy) + cy
    return u.astype(np.float32), v.astype(np.float32)


def remap_linear(img: np.ndarray, mx: np.ndarray, my: np.ndarray
                 ) -> np.ndarray:
    """``cv2.remap(img, mx, my, INTER_LINEAR)`` with its zero border: the
    source taps around (x, y), each outside the image reading 0."""
    h, w = img.shape[:2]
    x0 = np.floor(mx).astype(np.int64)
    y0 = np.floor(my).astype(np.int64)
    fx = (mx - x0).astype(np.float32)
    fy = (my - y0).astype(np.float32)
    one = np.float32(1.0)
    ex = (...,) + (None,) * (img.ndim - 2)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(ok[ex], v, np.float32(0.0))
    out = (tap(y0, x0) * ((one - fy) * (one - fx))[ex]
           + tap(y0, x0 + 1) * ((one - fy) * fx)[ex]
           + tap(y0 + 1, x0) * (fy * (one - fx))[ex]
           + tap(y0 + 1, x0 + 1) * (fy * fx)[ex])
    return out.astype(np.float32)


def remap_nearest(img: np.ndarray, mx: np.ndarray, my: np.ndarray
                  ) -> np.ndarray:
    """``cv2.remap(img, mx, my, INTER_NEAREST)`` with its zero border: the
    source pixel at the rounded (x, y)."""
    h, w = img.shape[:2]
    xi = np.rint(mx).astype(np.int64)
    yi = np.rint(my).astype(np.int64)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
    return np.where(ok, v, np.zeros((), img.dtype))
