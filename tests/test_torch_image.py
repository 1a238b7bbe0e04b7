"""The port's image decoders and resamplers (``mipsfusion_tpu_torch/
datasets/image.py`` over ``csrc/image.cpp``) against cv2, which the JAX
readers call: PNG and baseline JPEG bit for bit, the resizes within 1e-6
on values in [0, 1], the undistortion maps within 1e-4 pixel and the
remaps within 1e-6 (bilinear) and bit for bit (nearest); the committed
fixtures' digests; and the files outside the decoders' subset raise."""

import hashlib
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from mipsfusion_tpu_torch.datasets import image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _texture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 90 * np.sin(x / (3.0 + k) + seed)
                     * np.cos(y / (4.0 + k) - k) for k in range(3)], -1)
    base[(x // 8 + y // 8) % 5 == 0] = 250
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

_FILTERS = {"none": (cv2.IMWRITE_PNG_FILTER_NONE, 0),
            "sub": (cv2.IMWRITE_PNG_FILTER_SUB, 1),
            "up": (cv2.IMWRITE_PNG_FILTER_UP, 2),
            "avg": (cv2.IMWRITE_PNG_FILTER_AVG, 3),
            "paeth": (cv2.IMWRITE_PNG_FILTER_PAETH, 4)}


def _filter_bytes(path):
    data = open(path, "rb").read()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    row = w * ch * depth // 8 + 1
    return {raw[r * row] for r in range(h)}


@pytest.mark.parametrize("filt", list(_FILTERS))
@pytest.mark.parametrize("kind", ["rgb", "rgba", "grey", "depth16"])
def test_png_matches_cv2(tmp_path, kind, filt):
    """cv2 writes with one filter type forced (the file holds it); the
    port reads what cv2.imread reads, bit for bit."""
    flag, ftype = _FILTERS[filt]
    for h, w in ((17, 23), (40, 33), (1, 5)):
        img = _texture(h, w, 3)
        a = {"rgb": cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
             "rgba": np.dstack([img, img[..., :1]]),
             "grey": img[..., 1],
             "depth16": img[..., 0].astype(np.uint16) * 257 + img[..., 2],
             }[kind]
        path = str(tmp_path / f"{kind}.png")
        cv2.imwrite(path, a, [cv2.IMWRITE_PNG_FILTER, flag])
        if h > 1:
            assert ftype in _filter_bytes(path)
        if kind == "depth16":
            out = image.read_depth(path)
            ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            assert out.dtype == np.uint16
        else:
            out, ref = image.read_png(path), _cv2_rgb(path)
            assert out.dtype == np.uint8 and out.shape == (h, w, 3)
        assert np.array_equal(out, ref)
    if kind == "grey":      # 8-bit grey as depth: the samples as stored
        assert np.array_equal(image.read_depth(path),
                              cv2.imread(path, cv2.IMREAD_UNCHANGED))


def _png(w, h, depth, ctype, raw_rows, interlace=0, bad_crc=False,
         filt=0):
    """A hand-made PNG (cv2 writes no interlaced or palette files)."""
    def chunk(kind, body):
        crc = zlib.crc32(kind + body) ^ (1 if bad_crc and kind == b"IDAT"
                                         else 0)
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    body = b"".join(bytes([filt]) + r for r in raw_rows)
    extra = chunk(b"PLTE", bytes(range(6))) if ctype == 3 else b""
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case,match", [
    ("interlaced", "interlaced"), ("palette", "palette"),
    ("rgb16", "16-bit colour"), ("crc", "CRC"), ("filter", "filter type"),
    ("depth_rgb", "must be grey"), ("grey16_color", "16-bit grey PNG read"),
    ("grey4", "not read"), ("jpeg_as_png", "not a PNG")])
def test_png_outside_the_subset_raises(case, match):
    row = bytes(6)
    data = {
        "interlaced": lambda: _png(2, 2, 8, 2, [row, row], interlace=1),
        "palette": lambda: _png(2, 2, 8, 3, [b"\x00\x01"] * 2),
        "rgb16": lambda: _png(1, 2, 16, 2, [row, row]),
        "crc": lambda: _png(2, 2, 8, 2, [row, row], bad_crc=True),
        "filter": lambda: _png(2, 2, 8, 2, [row, row], filt=7),
        "depth_rgb": lambda: _png(2, 2, 8, 2, [row, row]),
        "grey16_color": lambda: _png(2, 2, 16, 0, [bytes(4)] * 2),
        "grey4": lambda: _png(4, 2, 4, 0, [bytes(2)] * 2),
        "jpeg_as_png": lambda: b"\xff\xd8\xff\xe0",
    }[case]()
    with pytest.raises(ValueError, match=match):
        image.decode_png(data, color=case != "depth_rgb")


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize("sampling", list(_SAMPLING))
@pytest.mark.parametrize("quality", [50, 90, 98])
def test_jpeg_matches_cv2(tmp_path, quality, sampling):
    """Bit for bit what cv2.imread (libjpeg-turbo: islow IDCT, fancy
    upsampling, its YCbCr tables) gives: sizes that are and are not whole
    MCUs, 1 and 2 pixels wide, restart intervals, optimised Huffman
    tables."""
    path = str(tmp_path / "a.jpg")
    for k, (h, w) in enumerate(((16, 16), (17, 23), (61, 97), (48, 64),
                                (3, 5), (1, 1), (40, 2), (2, 40))):
        for rst in (0, 1, 3):
            img = _texture(h, w, k)
            cv2.imwrite(path, img, [
                cv2.IMWRITE_JPEG_QUALITY, quality,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling],
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                cv2.IMWRITE_JPEG_OPTIMIZE, int(rst == 3)])
            out = image.read_jpeg(path)
            assert out.shape == (h, w, 3)
            assert np.array_equal(out, _cv2_rgb(path)), (h, w, rst)


def test_jpeg_greyscale_and_sniffing(tmp_path):
    """A one-component JPEG reads as grey replicated, as cv2's
    IMREAD_COLOR gives it; read_color tells JPEG and PNG by their first
    bytes, whatever the file is called."""
    for h, w in ((21, 33), (8, 8), (37, 29)):
        g = _texture(h, w, 5)[..., 0]
        p = str(tmp_path / "g.jpg")
        cv2.imwrite(p, g, [cv2.IMWRITE_JPEG_QUALITY, 90,
                           cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
        assert np.array_equal(image.read_jpeg(p), _cv2_rgb(p))
    img = _texture(9, 11)
    cv2.imwrite(str(tmp_path / "x.png"), img)
    os.rename(tmp_path / "x.png", tmp_path / "x.jpg")
    assert np.array_equal(image.read_color(str(tmp_path / "x.jpg")),
                          _cv2_rgb(str(tmp_path / "x.jpg")))
    (tmp_path / "t.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        image.read_color(str(tmp_path / "t.jpg"))


def _exif_orientation(orient):
    tiff = (b"MM\x00*" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orient, 0)
            + struct.pack(">I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("case,match", [
    ("progressive", "progressive"), ("s411", "sampling"),
    ("exif6", "orientation 6"), ("arithmetic", "arithmetic"),
    ("bits12", "12-bit"), ("truncated", "truncated|EOI|corrupt"),
    ("not_jpeg", "no SOI")])
def test_jpeg_outside_the_subset_raises(tmp_path, case, match):
    img = _texture(24, 32)
    p = str(tmp_path / "a.jpg")
    params = {"progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              "s411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]}.get(case, [])
    cv2.imwrite(p, img, params)
    data = open(p, "rb").read()
    sof = data.index(b"\xff\xc0") if b"\xff\xc0" in data else None
    if case == "exif6":
        data = data[:2] + _exif_orientation(6) + data[2:]
        open(p, "wb").write(data)
        assert cv2.imread(p).shape[:2] == (32, 24)   # cv2 rotates it
    elif case == "arithmetic":
        data = data[:sof + 1] + b"\xc9" + data[sof + 2:]
    elif case == "bits12":
        data = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    elif case == "truncated":
        data = data[:len(data) // 2]
    elif case == "not_jpeg":
        data = b"\x89PNG" + data
    with pytest.raises(ValueError, match=match):
        image.decode_jpeg(data)
    if case == "exif6":      # orientation 1 reads
        open(p, "wb").write(data.replace(_exif_orientation(6),
                                         _exif_orientation(1)))
        assert np.array_equal(image.read_jpeg(p), _cv2_rgb(p))


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_fixtures_digests(kind):
    """tests/data/{jpeg,png}/digests.json (tools/make_image_fixtures.py):
    cv2's decode and the port's give the recorded SHA-256 (the port's
    check on the card's host reads the same JSON)."""
    d = os.path.join(ROOT, "tests", "data", kind)
    with open(os.path.join(d, "digests.json")) as f:
        rec = json.load(f)
    assert len(rec) >= 5
    for name, r in rec.items():
        path = os.path.join(d, name)
        if name.startswith("depth16"):
            ref, out = cv2.imread(path, cv2.IMREAD_UNCHANGED), \
                image.read_depth(path)
        else:
            ref, out = _cv2_rgb(path), image.read_color(path)
        assert list(out.shape) == r["shape"]
        assert _digest(ref) == r["sha256"] == _digest(out), name


# ---------------------------------------------------------------------------
# resampling and undistortion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((968, 1296), (480, 640)),
                                     ((33, 47), (16, 20)),
                                     ((40, 64), (20, 32)),
                                     ((20, 30), (7, 11))])
@pytest.mark.parametrize("channels", [3, None])
def test_resizes_match_cv2(src, dst, channels):
    """INTER_LINEAR (ScanNet's colour to the depth size) and INTER_AREA
    within 1e-6 (cv2 sums in float32 in its own order); INTER_NEAREST
    bit for bit (floor(d * src / dst), the block's first sample)."""
    rng = np.random.default_rng(0)
    a = rng.random(src + ((channels,) if channels else ())).astype(
        np.float32)
    size = (dst[1], dst[0])
    lin = image.resize_linear(a, size)
    assert lin.dtype == np.float32
    assert np.abs(lin - cv2.resize(a, size)).max() <= 1e-6
    area = image.resize_area(a, size)
    assert np.abs(area - cv2.resize(
        a, size, interpolation=cv2.INTER_AREA)).max() <= 1e-6
    assert np.array_equal(image.resize_nearest(a, size), cv2.resize(
        a, size, interpolation=cv2.INTER_NEAREST))
    assert np.array_equal(image.resize_linear(a, src[::-1]), a)


@pytest.mark.parametrize("dist", [[-0.3, 0.0, 0.0, 0.0, 0.0],
                                  [0.1, -0.05, 0.001, -0.002, 0.01],
                                  [0.0, 0.0, 0.0, 0.0, 0.0]])
@pytest.mark.parametrize("hw", [(32, 32), (480, 640)])
def test_undistortion_matches_cv2(dist, hw):
    """initUndistortRectifyMap's maps within 1e-4 pixel (float32 rounding
    of a float64 computation, one ulp at 640 px); on cv2's maps the
    bilinear remap within 1e-6 (this cv2 interpolates at the maps' float
    coordinates, with no 1/32-pixel table) and the nearest remap bit for
    bit; through the port's own maps the whole correction within 1e-4
    (colour) and bit for bit (depth)."""
    h, w = hw
    K = np.array([[0.9 * w, 0, w / 2 - 0.5], [0, 0.9 * w, h / 2 - 0.5],
                  [0, 0, 1.0]])
    m1, m2 = cv2.initUndistortRectifyMap(K, np.array(dist), None, K, (w, h),
                                         cv2.CV_32FC1)
    u, v = image.undistort_maps(K, dist, (w, h))
    assert u.dtype == np.float32 and u.shape == (h, w)
    assert np.abs(u - m1).max() <= 1e-4 and np.abs(v - m2).max() <= 1e-4
    rng = np.random.default_rng(1)
    a = rng.random((h, w, 3)).astype(np.float32)
    d = (rng.random((h, w)) * 5).astype(np.float32)
    ref_a = cv2.remap(a, m1, m2, cv2.INTER_LINEAR)
    ref_d = cv2.remap(d, m1, m2, cv2.INTER_NEAREST)
    assert np.abs(image.remap_linear(a, m1, m2) - ref_a).max() <= 1e-6
    assert np.array_equal(image.remap_nearest(d, m1, m2), ref_d)
    assert np.abs(image.remap_linear(a, u, v) - ref_a).max() <= 1e-4
    assert np.array_equal(image.remap_nearest(d, u, v), ref_d)
