"""Write the small image fixtures the decoder tests and ``chip_smoke.py``
phase 15 read: JPEGs (``tests/data/jpeg``) and PNGs (``tests/data/png``)
written by cv2, each beside the SHA-256 of cv2's decoded pixels in
``digests.json`` (RGB uint8 for colour, the stored samples for 16-bit
grey).

    python3 tools/make_image_fixtures.py

Needs cv2 (the CPU host's); the machine with the card has none and only
reads the files. The content is a seeded texture, so a rerun writes the
same files with the same cv2.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 [h, w, 3]: smooth bands, edges and noise (every DCT band and
    every PNG filter gets work)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([127 + 90 * np.sin(x / (3.0 + k) + seed)
                     * np.cos(y / (4.0 + k) - k) for k in range(3)], -1)
    base[(x // 8 + y // 8) % 5 == 0] = 250
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(
        np.uint8)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> int:
    import cv2
    jdir = os.path.join(ROOT, "tests", "data", "jpeg")
    pdir = os.path.join(ROOT, "tests", "data", "png")
    os.makedirs(jdir, exist_ok=True)
    os.makedirs(pdir, exist_ok=True)
    S = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
         "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
         "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
    jpegs = {  # name: (h, w, quality, sampling, restart interval, grey)
        "s444_q90.jpg": (40, 48, 90, "444", 0, False),
        "s422_q50_odd.jpg": (29, 37, 50, "422", 0, False),
        "s420_q98_rst.jpg": (48, 64, 98, "420", 2, False),
        "s420_q75_odd.jpg": (45, 61, 75, "420", 0, False),
        "grey_q90_odd.jpg": (21, 33, 90, "444", 1, True),
    }
    out = {}
    for i, (name, (h, w, q, s, rst, grey)) in enumerate(jpegs.items()):
        img = texture(h, w, i)
        img = img[..., 0] if grey else img
        path = os.path.join(jdir, name)
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, q,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, S[s],
                                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
        rgb = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        out[name] = {"shape": list(rgb.shape), "sha256": digest(rgb)}
    with open(os.path.join(jdir, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    F = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
         "sub": cv2.IMWRITE_PNG_FILTER_SUB, "up": cv2.IMWRITE_PNG_FILTER_UP,
         "avg": cv2.IMWRITE_PNG_FILTER_AVG,
         "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}
    out = {}
    for i, (fname, flag) in enumerate(F.items()):
        img = texture(23, 31, 10 + i)
        for kind, a in (("rgb", img), ("rgba", np.dstack(
                [img, img[..., :1]])), ("grey", img[..., 1]),
                ("depth16", img[..., 0].astype(np.uint16) * 257
                 + img[..., 2])):
            name = f"{kind}_{fname}.png"
            path = os.path.join(pdir, name)
            bgr = a if a.ndim == 2 else cv2.cvtColor(
                a, cv2.COLOR_RGB2BGR if a.shape[2] == 3
                else cv2.COLOR_RGBA2BGRA)
            cv2.imwrite(path, bgr, [cv2.IMWRITE_PNG_FILTER, flag])
            if kind == "depth16":
                px = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            else:
                px = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            out[name] = {"shape": list(px.shape), "dtype": str(px.dtype),
                         "sha256": digest(px)}
    with open(os.path.join(pdir, "digests.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
