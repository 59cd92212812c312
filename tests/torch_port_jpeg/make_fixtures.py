"""Write the JPEG fixtures of the port's tests with this machine's encoders.

    python tests/torch_port_jpeg/make_fixtures.py

The card's machine has no cv2 and no JPEG encoder but the port's own, so
the files that hold the port's decoder to cv2 there are made here once and
checked in; `tests/test_torch_port_jpeg.py` and `test_torch_port_jpeg_kinds.py`
hold each against cv2 on the CPU, and `chip_smoke.py` holds the C++ decoder
to the numpy one on them. Each image is smooth structure plus noise from a
seeded numpy generator, a few kB as JPEG, 64 px a side or less.

  cv2 (libjpeg-turbo)   baseline, progressive, restart, optimised files, and
                        the progressive files cut short or stripped of their
                        last scans (`cut_*`, `keep*_*`);
  the system libjpeg    arithmetic-coded (SOF9, SOF10), CMYK and YCCK files,
                        through a small C program built here with the host
                        compiler (`ENCODER`);
  GDCM's IJG builds     lossless (SOF3, predictors 1-7, point transform) and
                        12-bit files, through the same program.

The libraries and headers are those of Debian's libjpeg62-turbo-dev and
libgdcm-dev packages (LIB, GDCM below).
"""

from __future__ import annotations

import os
import struct
import subprocess
import tempfile
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
LIB = Path("/usr/lib/x86_64-linux-gnu")
GDCM = Path("/usr/include/gdcm-3.0/gdcmjpeg")


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

# progressive files cut short (name -> (h, w, cv2 parameters, fraction of
# the bytes kept)) or stripped of their scans after the first n (keep<n>_*,
# an EOI after them): libjpeg smooths their unfinished blocks
P = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, 90]
CUT = {
    "cut_quarter": (64, 64, P, 0.25),
    "cut_half": (64, 64, P, 0.5),
    "cut_s422": (37, 29, P + [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], 0.4),
    "cut_gray": (41, 50, P, 0.3),
}
KEEP = {
    "keep1_dc_only": (40, 56, P, 1),
    "keep2_s420": (40, 56, P, 2),
    "keep5_s420": (61, 45, P, 5),
}

# what the C encoder writes: name -> (encoder, height, width, samples in,
# input colour space, JPEG colour space, options); colour spaces are
# libjpeg's J_COLOR_SPACE (1 gray, 2 RGB, 3 YCbCr, 4 CMYK, 5 YCCK)
ENCODED = {
    "arith_seq": ("8", 48, 64, 3, 2, 3, dict(arith=1)),
    "arith_prog": ("8", 40, 56, 3, 2, 3, dict(arith=1, progressive=1)),
    "arith_gray_restart": ("8", 33, 41, 1, 1, 1, dict(arith=1, restart=1)),
    "arith_prog_restart": ("8", 40, 40, 3, 2, 3,
                           dict(arith=1, progressive=1, restart=2)),
    "arith_s444_q95": ("8", 24, 40, 3, 2, 3,
                       dict(arith=1, samp=0x11, quality=95)),
    "cmyk": ("8", 24, 16, 4, 4, 4, {}),
    "ycck": ("8", 24, 16, 4, 4, 5, {}),
    "ycck_progressive": ("8", 40, 32, 4, 4, 5, dict(progressive=1)),
    "lossless_gray_p1": ("g8", 24, 16, 1, 1, 1, dict(predictor=1)),
    "lossless_gray_p4_pt2": ("g8", 30, 20, 1, 1, 1,
                             dict(predictor=4, transform=2)),
    "lossless_gray_p7": ("g8", 24, 16, 1, 1, 1, dict(predictor=7)),
    "lossless_rgb_p5": ("g8", 20, 24, 3, 2, 2, dict(predictor=5)),
    "lossless_rgb_p6": ("g8", 20, 24, 3, 2, 2, dict(predictor=6)),
    "lossless_gray_p2_restart": ("g8", 24, 16, 1, 1, 1,
                                 dict(predictor=2, restart=32)),
    "lossless_gray_p3": ("g8", 24, 16, 1, 1, 1, dict(predictor=3)),
    "lossless12_gray": ("g12", 24, 16, 1, 1, 1, dict(predictor=1)),
    "bits12": ("g12", 24, 16, 3, 2, 3, {}),
}

ENCODER = r"""
/* enc raw out w h nc in_cs jpeg_cs quality arith progressive predictor
       transform restart samp0: the samples of raw (1 byte each, or 2 bytes
   little-endian where BITS_IN_JSAMPLE > 8) as a JPEG */
#include <stdio.h>
#include <stdlib.h>
#include "jpeglib.h"
int main(int argc, char** argv) {
  if (argc != 15) return 2;
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  size_t n = (size_t)w * h * nc;
  JSAMPLE* px = malloc(n * sizeof(JSAMPLE));
  FILE* f = fopen(argv[1], "rb");
  for (size_t i = 0; i < n; ++i) {
    unsigned char b[2] = {0, 0};
    if (fread(b, sizeof(JSAMPLE) == 1 ? 1 : 2, 1, f) != 1) return 3;
    px[i] = (JSAMPLE)(b[0] | b[1] << 8);
  }
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* o = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, o);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = atoi(argv[6]);
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, atoi(argv[7]));
  jpeg_set_quality(&c, atoi(argv[8]), TRUE);
  c.arith_code = atoi(argv[9]);
  if (atoi(argv[10])) jpeg_simple_progression(&c);
#ifdef LOSSLESS
  if (atoi(argv[11])) jpeg_simple_lossless(&c, atoi(argv[11]), atoi(argv[12]));
#endif
  c.restart_interval = atoi(argv[13]);
  int samp = atoi(argv[14]);
  if (samp) {
    c.comp_info[0].h_samp_factor = samp >> 4;
    c.comp_info[0].v_samp_factor = samp & 15;
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(o);
  return 0;
}
"""


def encoders(tmp: Path) -> dict:
    """The encoder built against the system libjpeg ("8") and GDCM's IJG
    builds of 8 and 12 bits ("g8", "g12")."""
    src = tmp / "enc.c"
    src.write_text(ENCODER)
    out = {}
    subprocess.run(["cc", "-O1", "-o", str(tmp / "enc8"), str(src),
                    "-ljpeg"], check=True)
    out["8"] = tmp / "enc8"
    for b in (8, 12):
        exe = tmp / f"encg{b}"
        subprocess.run(
            ["cc", "-O1", "-w", "-DLOSSLESS", f"-DBITS_IN_JSAMPLE={b}",
             f"-I{GDCM / str(b)}", f"-I{GDCM}", "-include",
             str(GDCM / str(b) / f"mangle_jpeg{b}bits.h"), "-o", str(exe),
             str(src), str(LIB / f"libgdcmjpeg{b}.so")], check=True)
        out[f"g{b}"] = exe
    return out


def samples(h: int, w: int, c: int, seed: int, top: int) -> np.ndarray:
    """(h, w, c) smooth structure plus noise in 0..top."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([0.5 + 0.35 * np.sin(x / 6.0 + k) * np.cos(y / 9.0 - k)
                     for k in range(c)], -1)
    return np.clip((base + rng.normal(0, 0.07, (h, w, c))) * top, 0,
                   top).astype(np.int64)


def encode(exe: Path, tmp: Path, arr: np.ndarray, in_cs: int, jpeg_cs: int,
           quality=75, arith=0, progressive=0, predictor=0, transform=0,
           restart=0, samp=0) -> bytes:
    h, w, c = arr.shape
    raw = tmp / "in.raw"
    raw.write_bytes(arr.astype(np.uint8 if exe.name in ("enc8", "encg8")
                               else "<u2").tobytes())
    subprocess.run([str(exe), str(raw), str(tmp / "out.jpg"), str(w),
                    str(h), str(c), str(in_cs), str(jpeg_cs), str(quality),
                    str(arith), str(progressive), str(predictor),
                    str(transform), str(restart), str(samp)], check=True)
    return (tmp / "out.jpg").read_bytes()


def scan_starts(data: bytes) -> list[int]:
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


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
    for i, (name, (h, w, params, frac)) in enumerate(sorted(CUT.items())):
        img = scene(h, w, 200 + i)
        data = cv2.imencode(".jpg", img[..., 1] if "gray" in name else img,
                            params)[1].tobytes()
        (HERE / f"{name}.jpg").write_bytes(data[:int(len(data) * frac)])
    for i, (name, (h, w, params, keep)) in enumerate(sorted(KEEP.items())):
        data = cv2.imencode(".jpg", scene(h, w, 300 + i), params)[1].tobytes()
        (HERE / f"{name}.jpg").write_bytes(
            data[:scan_starts(data)[keep]] + b"\xff\xd9")
    with tempfile.TemporaryDirectory() as t:
        tmp = Path(t)
        exes = encoders(tmp)
        for i, (name, (lib, h, w, c, ics, jcs, opts)) in enumerate(sorted(
                ENCODED.items())):
            top = 4095 if lib == "g12" else 255
            data = encode(exes[lib], tmp, samples(h, w, c, 400 + i, top),
                          ics, jcs, **opts)
            (HERE / f"{name}.jpg").write_bytes(data)
    # lossless at 6 bits: the 8-bit file's frame header says 6 (cv2 reads
    # it, each sample its 16-bit sum's low byte); CMYK without its Adobe
    # marker (plain CMYK to libjpeg); arithmetic conditioning other than
    # the defaults in the DAC segment (the data then decodes otherwise)
    data = (HERE / "lossless_gray_p1.jpg").read_bytes()
    i = data.index(b"\xff\xc3")
    (HERE / "lossless6_gray.jpg").write_bytes(data[:i + 4] + b"\x06"
                                              + data[i + 5:])
    data = (HERE / "cmyk.jpg").read_bytes()
    i = data.index(b"\xff\xee")
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    (HERE / "cmyk_no_adobe.jpg").write_bytes(data[:i] + data[i + 2 + n:])
    data = (HERE / "arith_seq.jpg").read_bytes()
    i = data.index(b"\xff\xcc")
    dac = b"\xff\xcc\x00\x08\x00\x52\x10\x02\x11\x0e"
    n = struct.unpack(">H", data[i + 2:i + 4])[0]
    (HERE / "arith_dac.jpg").write_bytes(data[:i] + dac + data[i + 2 + n:])


if __name__ == "__main__":
    os.chdir(HERE)
    main()
