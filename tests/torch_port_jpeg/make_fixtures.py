"""Write the JPEG fixtures of the port's tests with cv2 (libjpeg-turbo).

    python tests/torch_port_jpeg/make_fixtures.py

The card's machine has no cv2 and no JPEG encoder but the port's own, so
the files that hold the port's decoder to cv2 there are made here once and
checked in; `tests/test_torch_port_jpeg.py` holds each against cv2 on the
CPU, and `chip_smoke.py` holds the C++ decoder to the numpy one on them.
Each image is smooth structure plus noise from a seeded numpy generator,
a few kB as JPEG.
"""

from __future__ import annotations

import struct
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent


def scene(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(x / 6.0 + c) * np.cos(y / 9.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 18, (h, w, 3)), 0, 255).astype(
        np.uint8)


def exif_orientation(jpeg: bytes, orientation: int) -> bytes:
    """`jpeg` with an APP1 EXIF block holding one Orientation tag."""
    tiff = (b"MM\x00\x2a" + struct.pack(">IH", 8, 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(">I", 0))
    app1 = b"\xff\xe1" + struct.pack(">H", 8 + len(tiff)) + b"Exif\x00\x00"
    return jpeg[:2] + app1 + tiff + jpeg[2:]


S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
FIXTURES = {  # name -> (height, width, gray, cv2 parameters)
    "gray": (37, 53, True, []),
    "s444": (45, 67, False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "s422": (45, 67, False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "s420": (45, 67, False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "s440": (45, 67, False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
    "progressive": (48, 64, False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "progressive_gray": (33, 41, True, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "restart": (40, 72, False, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "optimized": (40, 56, False, [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
    "odd_sides": (13, 3, False, []),
    "quality10": (48, 48, False, [cv2.IMWRITE_JPEG_QUALITY, 10]),
    "quality100": (32, 40, False, [cv2.IMWRITE_JPEG_QUALITY, 100]),
}


def main():
    for i, (name, (h, w, gray, params)) in enumerate(sorted(
            FIXTURES.items())):
        img = scene(h, w, i)
        ok, buf = cv2.imencode(".jpg", img[..., 1] if gray else img, params)
        assert ok
        (HERE / f"{name}.jpg").write_bytes(buf.tobytes())
    ok, buf = cv2.imencode(".jpg", scene(30, 50, 99))
    (HERE / "exif_orientation6.jpg").write_bytes(
        exif_orientation(buf.tobytes(), 6))


if __name__ == "__main__":
    main()
