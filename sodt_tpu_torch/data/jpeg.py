"""JPEG decode and encode in numpy and the stdlib: the plain version of the
port's JPEG decoder (`csrc/jpeg.cpp`), and the encoder of the box crops.

The card's machine has neither cv2 nor PIL, so the port carries its own
JPEG code, as it does for PNG (`png.py`). The JAX package reads a JPEG
through `cv2.imread(IMREAD_UNCHANGED)` (`sodt_tpu/data/vedai.py`), which
is libjpeg-turbo's default decompression; this module computes the same
pixels, step for step:

  read_jpeg(path)   markers (SOI; APPn and COM skipped, JFIF and Adobe
                    noted; DQT with 8- and 16-bit tables; SOF0-3, SOF9-11;
                    DHT; DAC; DRI; SOS; EOI), Huffman decode of baseline,
                    extended-sequential and progressive scans (DC first and
                    refine, AC first and refine with EOB runs), libjpeg's
                    QM decoder for arithmetic-coded ones (`jdarith.c`, DAC
                    conditioning), restart intervals, libjpeg-turbo's SIMD
                    ISLOW IDCT (`idct_islow`), fancy upsampling
                    (`jdsample.c`: h2v1, h2v2, h1v2; other integral
                    factors replicate), the integer YCbCr -> RGB
                    (`jdcolor.c`). Gray -> (H, W, 1); colour -> (H, W, 3)
                    RGB, as `_read_image` returns them through cv2. Three
                    components are YCbCr unless an Adobe APP14 marker with
                    transform 0 (and no JFIF marker) or the component ids
                    R, G, B say RGB. IMREAD_UNCHANGED applies no EXIF
                    orientation, and neither does this. Entropy data that
                    ends early is filled as libjpeg fills it: zero bits for
                    the MCU that runs out, and the MCUs after it left as
                    they are (zero blocks in a sequential file); a marker
                    segment cut short reads on through the FF D9 bytes
                    libjpeg's source manager feeds. A progressive image
                    whose scans leave some of AC coefficients 1-9 unsent or
                    unrefined (cut short, or so written) is smoothed block
                    by block from its neighbours' DCs, as libjpeg-turbo's
                    `decompress_smooth_data` smooths it: 3.1's (cv2 5.0)
                    by default, 2.1's (OpenCV 4.6, the JAX tile loader's)
                    where `opencv46`; the two pick some neighbour rows and
                    columns apart.

                    kind              cv2 5.0       PIL 12        OpenCV 4.6
                    arithmetic        (SOF9, SOF10) as Huffman    as cv2
                    CMYK, YCCK        (H, W, 3)     CMYK (H, W,   as cv2
                      (4 components)  OpenCV's        4), 255 -
                                      CMYK2BGR      libjpeg's
                    lossless (SOF3),  (H, W, c)     reads it      none
                      2-8 bits        uint8, low    (8 bits; 2-7:
                                      byte          none)
                    lossless 9-16     none          none          none
                    lossless in YCbCr none          none          none
                    12-bit            none          none          none
                    SOF11, hierarch.  none          none          none
                    cut progressive   smoothed      raises        smoothed
                                      (3.1)                       (2.1)

                    `_read_image`, the tile loader and the scan follow the
                    readers their JAX paths use: cv2 for the pixels,
                    OpenCV 4.6 for the tiles, PIL's open for the scan
                    (`verify_jpeg`); the box tool follows PIL's
                    `convert("RGB")` (`tools.py`; CMYK as PIL's inverted
                    samples). Where the reader gives no image, the port
                    raises ValueError naming the kind. A lossless image is
                    read as libjpeg-turbo reads it: each sample the
                    prediction (predictors 1-7) plus the difference modulo
                    2^16, shifted by the point transform into 8 bits;
                    subsampled components raise (not mirrored).
  decode_segment(tables, data, ycc)
                    a TIFF strip's or tile's JPEG stream after its
                    JPEGTables, the colour space set by the TIFF's
                    photometric (`tiff.py`; csrc/jpeg.h's C++ entry).
  jpeg_size(path)   (width, height) as PIL's `Image.open(f).size`: the
                    frame header, through PIL's own marker walk.
  verify_jpeg(path) raises where PIL's `Image.open` plus `verify()` plus the
                    JAX scan's 10 px assert mark the file corrupt (PIL reads
                    the markers up to SOS; it decodes nothing).
  write_jpeg(path, arr)
                    the file PIL's `Image.fromarray(arr).save(path)` writes:
                    baseline, quality 75 (libjpeg's scaling of the Annex K
                    tables), 4:2:0 for RGB, the standard Huffman tables, no
                    optimisation, a JFIF 1.01 header. It follows `jccolor.c`
                    (RGB -> YCbCr), `jcsample.c` (h2v2 with its alternating
                    bias), `jfdctint.c` (ISLOW FDCT) and libjpeg-turbo's
                    reciprocal quantisation, with libjpeg's edge padding and
                    dummy blocks.

The entropy decoding (Huffman, QM, lossless prediction) runs in Python;
the smoothing, IDCT, upsampling and colour conversion are whole-image numpy
operations in int64.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np

SOI = b"\xff\xd8"
MIN_SIDE = 10        # the JAX scan's "image size <10 pixels" assert


def _zigzag() -> list[int]:
    order = []
    for s in range(15):
        rows = range(max(0, s - 7), min(s, 7) + 1)
        for r in (reversed(rows) if s % 2 == 0 else rows):
            order.append(r * 8 + s - r)
    return order


# zigzag index -> natural (row-major) index; libjpeg's 16 extra entries
# catch a run that overshoots the block (corrupt data lands on 63)
NATURAL = _zigzag() + [63] * 16

# Annex K tables (natural order) and the standard Huffman tables
# (`jstdhuff.c`): (counts of codes of length 1..16, symbols)
QT_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
           14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
           18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113,
           92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100,
           103, 99]
QT_CHROMA = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
             24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
QT_CHROMA += [99] * 32
_AC_SYMS = [
    (0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa),
    (0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa)]
STD_HUFFMAN = {  # (class, table) -> (counts, symbols); class 0 DC, 1 AC
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), _AC_SYMS[0]),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_SYMS[1]),
}

# the frames read: baseline, extended sequential, progressive, lossless, and
# the three with arithmetic coding
_SOF_READ = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB)
# what each SOF marker that libjpeg (and so cv2) does not read names
_SOF_UNSUPPORTED = {
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xCD: "hierarchical arithmetic-coded (SOF13)",
    0xCE: "hierarchical arithmetic-coded (SOF14)",
    0xCF: "hierarchical arithmetic-coded (SOF15)"}

# the fixed-point constants of jidctint.c / jfdctint.c (CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
F0_298, F0_390, F0_541, F0_765 = 2446, 3196, 4433, 6270
F0_899, F1_175, F1_501, F1_847 = 7373, 9633, 12299, 15137
F1_961, F2_053, F2_562, F3_072 = 16069, 16819, 20995, 25172


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


# ------------------------------------------------------------- Huffman


def _huffman_lut(counts, symbols, is_dc: bool, dc_top: int = 15
                 ) -> list[int]:
    """A 65536-entry table over the next 16 bits: (code length << 8) |
    symbol. A prefix that no code of at most 16 bits matches decodes as
    libjpeg decodes it: symbol 0 after 17 bits. A DC table's symbols are
    sizes up to `dc_top` (16 in a lossless image)."""
    if sum(counts) > 256 or sum(counts) > len(symbols):
        raise ValueError("broken JPEG file (bad Huffman table)")
    if is_dc and any(s > dc_top for s in symbols[:sum(counts)]):
        raise ValueError("broken JPEG file (bad Huffman table)")
    lut = [17 << 8] * 65536
    last = max((i + 1 for i, n in enumerate(counts) if n), default=0)
    code = k = 0
    for length in range(1, last + 1):
        if code + counts[length - 1] >= 1 << length:   # checked before the
            raise ValueError("broken JPEG file (bad Huffman table)")  # fill
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            lut[lo:hi] = [(length << 8) | symbols[k]] * (hi - lo)
            code += 1
            k += 1
        code <<= 1
    return lut


_MASK = [(1 << s) - 1 for s in range(33)]
_HALF = [1 << (s - 1) if s else 0 for s in range(33)]
_MARKER_RE = re.compile(rb"\xff+([^\x00\xff])")
_STUFF_RE = re.compile(rb"\xff+\x00")


class _Segment:
    """One restart interval's entropy-coded bytes, unstuffed, as 32-bit
    big-endian windows at every byte (`w[p >> 3]` holds bit p and the 24
    bits after it), followed by zero bits: libjpeg feeds zero bits once the
    data runs out."""

    def __init__(self, data: bytes, pad_bytes: int):
        self.bits = 8 * len(data)
        b = np.frombuffer(data + bytes(pad_bytes + 4), np.uint8).astype(
            np.uint32)
        n = len(data) + pad_bytes
        self.w = ((b[:n] << 24) | (b[1:n + 1] << 16) | (b[2:n + 2] << 8)
                  | b[3:n + 3]).tolist()


def _split_scan(data: bytes, pos: int):
    """The entropy-coded data of a scan starting at `pos`: a list of
    (segment bytes, the RST number that ends it or None) and the offset of
    the marker that ends the scan (libjpeg's reading: FF..FF 00 is one FF
    byte; FF..FF then any other byte is a marker)."""
    segs, start = [], pos
    while True:
        m = _MARKER_RE.search(data, start)
        if m is None:  # cannot happen: the data ends with a (fake) EOI
            raise ValueError("truncated JPEG file")
        code = m.group(1)[0]
        chunk = _STUFF_RE.sub(b"\xff", data[pos:m.start()])
        if 0xD0 <= code <= 0xD7:
            segs.append((chunk, code - 0xD0))
            pos = start = m.end()
            continue
        segs.append((chunk, None))
        return segs, m.start(1) - 1


# ------------------------------------------------------------ the parse

_EOI_FILL = b"\xff\xd9" * 32769


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None       # latched at the component's first scan
        self.coef = None     # flat list, natural order, 64 per block
        self.coef_bits = [-1] * 64
        self.prev_bits = [0] * 64   # coef_bits before the latest scan


class _Decoder:
    """Markers, scans and coefficients of one file (libjpeg's jdmarker,
    jdhuff and jdphuff in Python)."""

    def __init__(self, data: bytes, name: str):
        self.name = name
        self.n_real = len(data)
        # libjpeg's source managers insert an EOI where the file ends
        self.data = data + b"\xff\xd9"
        self.qt: dict[int, list[int]] = {}
        self.huff: dict[tuple[int, int], tuple | list[int]] = {}
        self.restart = 0
        self.jfif = False
        self.adobe = None
        self.frame = None
        self.progressive = False
        self.n_scans = 0
        self.last_good = 0           # libjpeg's last_good_iMCU_row
        self.opencv46 = False        # refuse what OpenCV 4.6 refuses
        self.lossless = self.arithmetic = False
        self.precision = 8
        # arithmetic conditioning (DAC): DC L and U, AC Kx, per table
        self.dc_l, self.dc_u, self.ac_k = [0] * 16, [1] * 16, [5] * 16
        self.dc_stats = [bytearray(64) for _ in range(16)]
        self.ac_stats = [bytearray(256) for _ in range(16)]
        self.frame_limit = None      # (width, least rows, most rows)

    def fail(self, why: str):
        raise ValueError(f"{self.name}: {why}")

    def _length(self, pos):
        """The marker segment at pos and the offset after it. Past the
        file's end libjpeg's source manager feeds FF D9 again and again, so
        a segment cut short is read on through those bytes, and the marker
        after it is an EOI (the one at n_real)."""
        d = self.data[pos:self.n_real]
        if len(d) < 65537:
            d += _EOI_FILL[:65537 - len(d)]
        n = struct.unpack(">H", d[:2])[0]
        if n < 2:
            self.fail("broken JPEG file (marker length)")
        return d[2:n], min(pos + n, self.n_real)

    def run(self):
        d = self.data
        if d[:2] != SOI:
            self.fail("not a JPEG file (no SOI)")
        pos = 2
        while True:
            # next marker: skip garbage, then FF fill bytes
            while pos < len(d) and d[pos] != 0xFF:
                pos += 1
            while pos < len(d) and d[pos] == 0xFF:
                pos += 1
            if pos >= len(d):
                self.fail("truncated JPEG file")
            m = d[pos]
            pos += 1
            if m == 0xD9:
                break
            if m in _SOF_READ:
                body, pos = self._length(pos)
                self._sof(m, body)
            elif m in _SOF_UNSUPPORTED:
                self.fail(f"{_SOF_UNSUPPORTED[m]} JPEG: libjpeg, and so cv2, "
                          "reads none")
            elif m == 0xCC:
                body, pos = self._length(pos)
                self._dac(body)
            elif m == 0xC4:
                body, pos = self._length(pos)
                self._dht(body)
            elif m == 0xDB:
                body, pos = self._length(pos)
                self._dqt(body)
            elif m == 0xDD:
                body, pos = self._length(pos)
                if len(body) != 2:
                    self.fail("broken JPEG file (DRI)")
                self.restart = struct.unpack(">H", body)[0]
            elif m == 0xDA:
                body, pos = self._length(pos)
                pos = self._sos(body, pos)
                self.n_scans += 1
            elif m == 0xE0:
                body, pos = self._length(pos)
                if len(body) >= 14 and body[:5] == b"JFIF\x00":
                    self.jfif = True
            elif m == 0xEE:
                body, pos = self._length(pos)
                if len(body) >= 12 and body[:5] == b"Adobe":
                    self.adobe = body[11]
            elif 0xE1 <= m <= 0xEF or m in (0xFE, 0xDC):
                pos = self._length(pos)[1]
            elif 0xD0 <= m <= 0xD7 or m == 0x01:
                pass
            elif m == 0xD8:
                self.fail("broken JPEG file (SOI inside the image)")
            else:
                self.fail(f"broken JPEG file (unknown marker 0x{m:02X})")
        if self.frame is None or not self.n_scans:
            self.fail("broken JPEG file (no image)")

    def _sof(self, m, body):
        if self.frame is not None:
            self.fail("broken JPEG file (two frames)")
        if len(body) < 6:
            self.fail("broken JPEG file (SOF)")
        prec, h, w, nc = struct.unpack(">BHHB", body[:6])
        self.lossless = m in (0xC3, 0xCB)
        if m == 0xCB:
            self.fail("arithmetic-coded lossless (SOF11) JPEG: cv2 reads none")
        if self.lossless and not 2 <= prec <= 16:
            self.fail("broken JPEG file (lossless precision)")
        if self.lossless and prec > 8:
            self.fail(f"{prec}-bit lossless JPEG: cv2 reads none")
        if not self.lossless and prec != 8:
            self.fail(f"{prec}-bit JPEG: cv2 reads none (libjpeg's 8-bit "
                      "interface refuses it)")
        if self.lossless and self.opencv46:
            self.fail("lossless (SOF3) JPEG: OpenCV 4.6 (libjpeg-turbo 2.1) "
                      "reads none")
        self.precision = prec
        if h == 0 or w == 0:
            self.fail(f"unsupported image size {w} x {h}")
        if self.frame_limit:        # a TIFF chunk's frame, before allocating
            cols, rows, top = self.frame_limit
            if w != cols or not rows <= h <= top:
                self.fail(f"broken TIFF file (a JPEG strip or tile of {w} x "
                          f"{h} for {cols} x {rows})")
        if len(body) != 6 + 3 * nc or nc == 0:
            self.fail("broken JPEG file (SOF)")
        if nc not in (1, 3, 4):
            self.fail(f"JPEG of {nc} components is not supported")
        comps = []
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                self.fail("broken JPEG file (SOF sampling)")
            comps.append(_Component(cid, hs, vs, tq))
        hmax = max(c.h for c in comps)
        vmax = max(c.v for c in comps)
        mcux = -(-w // (8 * hmax))
        mcuy = -(-h // (8 * vmax))
        for c in comps:
            c.dw = -(-w * c.h // hmax)          # downsampled width
            c.dh = -(-h * c.v // vmax)
            c.bw = -(-c.dw // 8)                # blocks holding data
            c.bh = -(-c.dh // 8)
            c.pw = mcux * c.h                   # blocks, padded to MCUs
            c.ph = mcuy * c.v
            c.coef = [0] * (c.pw * c.ph * 64)
        if self.lossless and any(c.h != hmax or c.v != vmax for c in comps):
            self.fail("lossless JPEG with subsampled components is not "
                      "supported")
        self.progressive = m in (0xC2, 0xCA)
        self.arithmetic = m in (0xC9, 0xCA)
        self.frame = dict(w=w, h=h, comps=comps, hmax=hmax, vmax=vmax,
                          mcux=mcux, mcuy=mcuy)

    def _dqt(self, body):
        i = 0
        while i < len(body):
            pq, tq = body[i] >> 4, body[i] & 15
            n = 64 * (2 if pq else 1)
            if tq > 3 or pq > 1 or i + 1 + n > len(body):
                self.fail("broken JPEG file (DQT)")
            vals = (struct.unpack(">64H", body[i + 1:i + 1 + n]) if pq
                    else body[i + 1:i + 1 + n])
            tab = [0] * 64
            for k in range(64):
                tab[NATURAL[k]] = vals[k]
            self.qt[tq] = tab
            i += 1 + n

    def _dac(self, body):
        if len(body) % 2:
            self.fail("broken JPEG file (DAC)")
        for i in range(0, len(body), 2):
            t, v = body[i], body[i + 1]
            if t >= 32:
                self.fail("broken JPEG file (DAC table)")
            if t >= 16:
                self.ac_k[t - 16] = v
            else:
                self.dc_l[t], self.dc_u[t] = v & 15, v >> 4
                if self.dc_l[t] > self.dc_u[t]:
                    self.fail("broken JPEG file (DAC value)")

    def _dht(self, body):
        i = 0
        while i < len(body):
            if i + 17 > len(body):
                self.fail("broken JPEG file (DHT)")
            tc, th = body[i] >> 4, body[i] & 15
            counts = body[i + 1:i + 17]
            n = sum(counts)
            if tc > 1 or th > 3 or n > 256 or i + 17 + n > len(body):
                self.fail("broken JPEG file (DHT)")
            # checked and built where a scan first takes it, as in libjpeg
            self.huff[(tc, th)] = (counts, body[i + 17:i + 17 + n])
            i += 17 + n

    def _sos(self, body, pos):
        f = self.frame
        if f is None:
            self.fail("broken JPEG file (SOS before SOF)")
        ns = body[0] if body else 0
        if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
            self.fail("broken JPEG file (SOS)")
        by_id = {c.id: c for c in f["comps"]}
        scomps = []
        for i in range(ns):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            if cid not in by_id:
                self.fail("broken JPEG file (SOS component)")
            scomps.append((by_id[cid], t >> 4, t & 15))
        if ns > 1 and sum(c.h * c.v for c, _, _ in scomps) > 10:
            self.fail("broken JPEG file (more than 10 blocks in an MCU)")
        ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
        ah, al = ahl >> 4, ahl & 15
        if self.lossless:            # Ss the predictor, Al the point transform
            if not 1 <= ss <= 7 or se or ah or al >= self.precision:
                self.fail("broken JPEG file (SOS lossless parameters)")
            segs, end = _split_scan(self.data, pos)
            self._lossless_scan(scomps, ss, al, segs)
            return end
        if self.progressive:
            bad = (ss > se or se > 63 or ah > 13 or al > 13
                   or (ss == 0 and se != 0) or (ss > 0 and ns != 1))
        else:
            bad = ss != 0 or se != 63 or ah != 0 or al != 0
        if bad:
            self.fail("broken JPEG file (SOS progression parameters)")
        for c, _, _ in scomps:
            if c.qt is None:  # libjpeg latches the table at the first scan
                if c.tq not in self.qt:
                    self.fail("broken JPEG file (quantization table missing)")
                c.qt = list(self.qt[c.tq])
        segs, end = _split_scan(self.data, pos)
        self._scan(scomps, ss, se, ah, al, segs)
        return end

    # -------------------------------------------------- entropy decoding

    def _table(self, tc, th):
        if (tc, th) not in self.huff:
            self.fail("broken JPEG file (Huffman table missing)")
        t = self.huff[(tc, th)]
        if isinstance(t, tuple):
            try:
                t = self.huff[(tc, th)] = _huffman_lut(
                    *t, tc == 0, 16 if self.lossless else 15)
            except ValueError as e:
                self.fail(str(e))
        return t

    def _lossless_scan(self, scomps, psv, pt, segs):
        """A lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): each
        sample's difference, Huffman coded as a DC difference (size 16 is
        32768), added to its prediction modulo 2^16: the first row of the
        scan and of each restart interval predicts from the left (its first
        sample from 2^(P - Pt - 1)), every other row's first sample from
        above, its others by predictor `psv`. Past the data's end libjpeg
        reads zero bits and goes on decoding."""
        f = self.frame
        w, h = f["w"], f["h"]
        if self.restart % w:
            self.fail("broken JPEG file (a lossless restart interval that "
                      "is not whole rows)")
        tabs = [self._table(0, td) for _, td, _ in scomps]
        ns = len(scomps)
        diffs = [[0] * (w * h) for _ in range(ns)]
        interval = self.restart or w * h
        for it in range(-(-w * h // interval)):
            if it > 0 and it - 1 < len(segs) and segs[it - 1][1] is not None:
                if segs[it - 1][1] != (it - 1) & 7:
                    self.fail("broken JPEG file (restart markers out of "
                              "order)")
            data = segs[it][0] if it < len(segs) else b""
            lo, hi = it * interval, min((it + 1) * interval, w * h)
            seg = _Segment(data, (hi - lo) * ns * 4 + 16)
            wv, p = seg.w, 0
            for m in range(lo, hi):
                for ci in range(ns):
                    e = tabs[ci][(wv[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    s = e & 255
                    if s == 16:
                        v = 32768
                    elif s:
                        v = _extend((wv[p >> 3] >> (32 - (p & 7) - s))
                                    & _MASK[s], s)
                        p += s
                    else:
                        v = 0
                    diffs[ci][m] = v
        rows = interval // w
        init = 1 << (self.precision - pt - 1)
        for ci, (c, _, _) in enumerate(scomps):
            out = np.empty((h, w), np.int64)
            d = diffs[ci]
            prev = None
            for y in range(h):
                row = d[y * w:(y + 1) * w]
                o = [0] * w
                if y % rows == 0:                    # first row
                    ra = (row[0] + init) & 0xFFFF
                    o[0] = ra
                    for x in range(1, w):
                        ra = (row[x] + ra) & 0xFFFF
                        o[x] = ra
                else:
                    rb = prev[0]
                    ra = (row[0] + rb) & 0xFFFF
                    o[0] = ra
                    for x in range(1, w):
                        rc, rb = rb, prev[x]
                        pr = (ra if psv == 1 else rb if psv == 2 else
                              rc if psv == 3 else ra + rb - rc if psv == 4
                              else ra + ((rb - rc) >> 1) if psv == 5 else
                              rb + ((ra - rc) >> 1) if psv == 6 else
                              (ra + rb) >> 1)
                        ra = (row[x] + pr) & 0xFFFF
                        o[x] = ra
                out[y] = o
                prev = o
            # the point transform undone, into an 8-bit sample
            c.samples = ((out << pt) & 0xFF).astype(np.uint8)

    def _arith_scan(self, scomps, ss, se, al, segs, mcus, kind):
        """An arithmetic-coded scan (jdarith.c): the statistics of the
        scan's tables cleared at its start and at each restart, with the DC
        predictions and contexts; MCUs after a bad code in an interval
        decode nothing."""
        dc_bins = kind in ("seq", "dc_first")
        ac_bins = kind in ("seq", "ac_first", "ac_refine")
        interval = self.restart or len(mcus)
        ns = len(scomps)
        for it in range(-(-len(mcus) // interval)):
            if it > 0 and it - 1 < len(segs) and segs[it - 1][1] is not None:
                if segs[it - 1][1] != (it - 1) & 7:
                    self.fail("broken JPEG file (restart markers out of "
                              "order)")
            for _, td, ta in scomps:
                if dc_bins:
                    self.dc_stats[td][:] = bytes(64)
                if ac_bins:
                    self.ac_stats[ta][:] = bytes(256)
            last, ctx = [0] * ns, [0] * ns
            dec = _Arith(segs[it][0] if it < len(segs) else b"")
            for blocks in mcus[it * interval:(it + 1) * interval]:
                if dec.ct == -1 and kind != "dc_refine":
                    continue
                for ci, off in blocks:
                    c, td, ta = scomps[ci]
                    coef = c.coef
                    if kind == "dc_refine":
                        if dec(_FIXED, 0):
                            coef[off] |= 1 << al
                        continue
                    if kind in ("seq", "dc_first"):
                        v = _arith_dc(dec, self.dc_stats[td], ctx, ci,
                                      self.dc_l[td], self.dc_u[td])
                        if v is None:
                            dec.ct = -1
                            break
                        last[ci] = (last[ci] + v) & 0xFFFF
                        coef[off] = _s16(last[ci] << al)
                        if kind == "dc_first":
                            continue
                    st = self.ac_stats[ta]
                    if kind == "ac_refine":
                        if not _arith_ac_refine(dec, st, coef, off, ss, se,
                                                al):
                            dec.ct = -1
                            break
                        continue
                    k = max(ss, 1)
                    top = se if kind == "ac_first" else 63
                    while k <= top:
                        if dec(st, 3 * (k - 1)):
                            break                           # EOB
                        while not dec(st, 3 * (k - 1) + 1):
                            k += 1
                            if k > top:
                                break
                        if k > top:
                            v = None
                        else:
                            v = _arith_ac(dec, st, k, self.ac_k[ta])
                        if v is None:
                            dec.ct = -1
                            break
                        coef[off + NATURAL[k]] = _s16(v << al)
                        k += 1
                    if dec.ct == -1:
                        break

    def _scan(self, scomps, ss, se, ah, al, segs):
        f = self.frame
        # MCU -> its blocks, each (component index in scan, offset)
        if len(scomps) == 1:
            c = scomps[0][0]
            mcus = [[(0, (by * c.pw + bx) * 64)] for by in range(c.bh)
                    for bx in range(c.bw)]
        else:
            mcus = []
            for my in range(f["mcuy"]):
                for mx in range(f["mcux"]):
                    blocks = []
                    for ci, (c, _, _) in enumerate(scomps):
                        for yy in range(c.v):
                            for xx in range(c.h):
                                b = (my * c.v + yy) * c.pw + mx * c.h + xx
                                blocks.append((ci, b * 64))
                    mcus.append(blocks)
        # libjpeg's start_pass: the bits of coefficients 0 (or 1) to 9 as
        # they stood before this scan, then the scan's own
        for c, _, _ in scomps:
            for k in range(min(ss, 1), max(se, 9) + 1):
                c.prev_bits[k] = c.coef_bits[k] if self.n_scans else 0
            for k in range(ss, se + 1):
                c.coef_bits[k] = al
        # each MCU's iMCU row: libjpeg notes the row at its first MCU while
        # the data has not yet run out (last_good_iMCU_row)
        if len(scomps) == 1:
            c = scomps[0][0]
            rows = [i // c.bw // c.v for i in range(len(mcus))]
        else:
            rows = [i // f["mcux"] for i in range(len(mcus))]
        kind = ("seq" if not self.progressive else
                ("dc_first" if ah == 0 else "dc_refine") if ss == 0 else
                ("ac_first" if ah == 0 else "ac_refine"))
        if self.arithmetic:
            self._arith_scan(scomps, ss, se, al, segs, mcus, kind)
            self.last_good = rows[-1]   # arithmetic data never runs short
            return
        dc = [self._table(0, td) if kind in ("seq", "dc_first") else None
              for _, td, _ in scomps]
        ac = [self._table(1, ta) if kind in ("seq", "ac_first", "ac_refine")
              else None for _, _, ta in scomps]
        per_blocks = max(len(b) for b in mcus)
        interval = self.restart or len(mcus)
        n_int = -(-len(mcus) // interval)
        state = {"eobrun": 0}
        insufficient = False
        for it in range(n_int):
            if (not insufficient and it * interval < len(mcus)
                    and (it == 0 or rows[it * interval]
                         != rows[it * interval - 1])):
                self.last_good = rows[it * interval]
            # libjpeg's process_restart: the expected RSTn is consumed and
            # the out-of-data flag reset; at any other marker the flag
            # stays as it is and the interval has no data
            if it > 0 and it - 1 < len(segs) and segs[it - 1][1] is not None:
                if segs[it - 1][1] != (it - 1) & 7:
                    self.fail("broken JPEG file (restart markers out of "
                              "order)")
                insufficient = False
            data = segs[it][0] if it < len(segs) else b""
            group = mcus[it * interval:(it + 1) * interval]
            seg = _Segment(data, per_blocks * 64 * 34 // 8 + 16)
            last_dc = [0] * len(scomps)
            state["eobrun"] = 0
            p = 0
            for j, blocks in enumerate(group):
                m = it * interval + j
                if (j and not insufficient and rows[m] != rows[m - 1]):
                    self.last_good = rows[m]
                if insufficient:
                    continue  # libjpeg leaves the MCU as it is
                for ci, off in blocks:
                    coef = scomps[ci][0].coef
                    if kind == "seq":
                        p, last_dc[ci] = _block_seq(
                            seg.w, p, dc[ci], ac[ci], coef, off, last_dc[ci])
                    elif kind == "dc_first":
                        p, last_dc[ci] = _block_dc_first(
                            seg.w, p, dc[ci], coef, off, last_dc[ci], al)
                    elif kind == "dc_refine":
                        if (seg.w[p >> 3] >> (31 - (p & 7))) & 1:
                            coef[off] |= 1 << al
                        p += 1
                    elif kind == "ac_first":
                        p = _block_ac_first(seg.w, p, ac[ci], coef, off,
                                            ss, se, al, state)
                    else:
                        p = _block_ac_refine(seg.w, p, ac[ci], coef, off,
                                             ss, se, al, state)
                if p > seg.bits:
                    insufficient = True


def _extend(v, s):
    return v - _MASK[s] if v < _HALF[s] else v


def _block_seq(w, p, dc, ac, coef, off, pred):
    e = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
    p += e >> 8
    s = e & 255
    if s:
        v = (w[p >> 3] >> (32 - (p & 7) - s)) & _MASK[s]
        p += s
        pred += v - _MASK[s] if v < _HALF[s] else v
    coef[off] = pred
    k = 1
    while k < 64:
        e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += e >> 8
        s = e & 15
        r = (e >> 4) & 15
        if s:
            k += r
            v = (w[p >> 3] >> (32 - (p & 7) - s)) & _MASK[s]
            p += s
            coef[off + NATURAL[k]] = v - _MASK[s] if v < _HALF[s] else v
            k += 1
        elif r == 15:
            k += 16
        else:
            break
    return p, pred


def _block_dc_first(w, p, dc, coef, off, pred, al):
    e = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
    p += e >> 8
    s = e & 255
    if s:
        v = (w[p >> 3] >> (32 - (p & 7) - s)) & _MASK[s]
        p += s
        pred += _extend(v, s)
    coef[off] = pred << al
    return p, pred


def _block_ac_first(w, p, ac, coef, off, ss, se, al, state):
    if state["eobrun"] > 0:
        state["eobrun"] -= 1
        return p
    k = ss
    while k <= se:
        e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        p += e >> 8
        s = e & 15
        r = (e >> 4) & 15
        if s:
            k += r
            v = (w[p >> 3] >> (32 - (p & 7) - s)) & _MASK[s]
            p += s
            coef[off + NATURAL[k]] = _extend(v, s) << al
        elif r == 15:
            k += 15
        else:
            run = 1 << r
            if r:
                run += (w[p >> 3] >> (32 - (p & 7) - r)) & _MASK[r]
                p += r
            state["eobrun"] = run - 1
            break
        k += 1
    return p


def _bit(w, p):
    return (w[p >> 3] >> (31 - (p & 7))) & 1


def _block_ac_refine(w, p, ac, coef, off, ss, se, al, state):
    p1 = 1 << al
    m1 = -1 << al
    k = ss
    if state["eobrun"] == 0:
        while k <= se:
            e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            p += e >> 8
            s = e & 15
            r = (e >> 4) & 15
            if s:
                s = p1 if _bit(w, p) else m1
                p += 1
            elif r != 15:
                run = 1 << r
                if r:
                    run += (w[p >> 3] >> (32 - (p & 7) - r)) & _MASK[r]
                    p += r
                state["eobrun"] = run
                break
            while True:
                i = off + NATURAL[k]
                c = coef[i]
                if c != 0:
                    if _bit(w, p) and not (c & p1):
                        coef[i] = c + p1 if c >= 0 else c + m1
                    p += 1
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > se:
                    break
            if s:
                coef[off + NATURAL[k]] = s
            k += 1
    if state["eobrun"] > 0:
        while k <= se:
            i = off + NATURAL[k]
            c = coef[i]
            if c != 0:
                if _bit(w, p) and not (c & p1):
                    coef[i] = c + p1 if c >= 0 else c + m1
                p += 1
            k += 1
        state["eobrun"] -= 1
    return p


# ------------------------------------------------- arithmetic decoding

# T.81 Table D.2 in libjpeg's packing (jaricom.c): Qe << 16 | Next_Index_MPS
# << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 bin
_ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171)


class _Arith:
    """libjpeg's QM decoder (jdarith.c) over one restart interval's
    unstuffed bytes: zero bytes once they run out, as libjpeg feeds zeros
    after a marker. `ct` -1 is libjpeg's error state (a bad code): the rest
    of the interval decodes nothing."""

    def __init__(self, data: bytes):
        self.d, self.i, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def __call__(self, st, k: int) -> int:
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                data = self.d[self.i] if self.i < len(self.d) else 0
                self.i += 1
                self.c = (self.c << 8) | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[k]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = self.a - qe
        self.a = temp
        temp <<= self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                self.a = qe
                st[k] = (sv & 0x80) ^ nm
            else:
                self.a = qe
                st[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif self.a < 0x8000:
            if self.a < qe:
                st[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[k] = (sv & 0x80) ^ nm
        return sv >> 7


_FIXED = bytearray([113])        # libjpeg's fixed_bin: never adapts


def _arith_dc(dec, stats, ctx, ci, L, U):
    """Figure F.19 for one block: the DC difference, updating the
    component's conditioning context; None on a bad code."""
    st = stats
    i = ctx[ci]
    if not dec(st, i):
        ctx[ci] = 0
        return 0
    sign = dec(st, i + 1)
    i += 2 + sign
    m = dec(st, i)
    if m:
        i = 20
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                return None
            i += 1
    if m < (1 << L) >> 1:
        ctx[ci] = 0
    elif m > (1 << U) >> 1:
        ctx[ci] = 12 + sign * 4
    else:
        ctx[ci] = 4 + sign * 4
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac(dec, st, k, kmax):
    """Figures F.21-F.24 for one AC coefficient at k whose bins start at
    3 (k - 1) + 2 (after the EOB and zero-run tests): its value, or None on
    a bad code."""
    sign = dec(_FIXED, 0)
    i = 3 * (k - 1) + 2
    m = dec(st, i)
    if m and dec(st, i):
        m <<= 1
        i = 189 if k <= kmax else 217
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                return None
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _s16(v: int) -> int:
    """v as a JCOEF (16 bits)."""
    return ((v + 32768) & 0xFFFF) - 32768


def _arith_ac_refine(dec, st, coef, off, ss, se, al) -> bool:
    """decode_mcu_AC_refine on one block; False on a bad code."""
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coef[off + NATURAL[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and dec(st, i):
            break                                           # EOB
        while True:
            j = off + NATURAL[k]
            if coef[j]:
                if dec(st, i + 2):
                    coef[j] = _s16(coef[j] + (m1 if coef[j] < 0 else p1))
                break
            if dec(st, i + 1):
                coef[j] = m1 if dec(_FIXED, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                return False
        k += 1
    return True


# ------------------------------------------------------ block smoothing

# libjpeg-turbo's block smoothing of a progressive image whose scans left
# some of AC coefficients 1-9 unsent or unrefined (jdcoefct.c, 2.1 and
# later): the natural positions of zigzag coefficients 1-9 (Q01, Q10, Q20,
# Q11, Q02, Q03, Q12, Q21, Q30), and each estimate's weights over the 5 x 5
# block neighbourhood's DC values (rows above to below, columns left to
# right). With AC data present (some of coefficients 1-9 known in part)
# the first five take the K.8-like weights; with none, all nine and the DC
# take the Gaussian-like ones ("change_dc").
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)


def _w(*rows):
    return np.array(rows, np.int64)


_Z = (0, 0, 0, 0, 0)
_SMOOTH_AC = (
    _w(_Z, _Z, (-7, 50, 0, -50, 7), _Z, _Z),
    _w(_Z, (0, 0, 50, 0, 0), _Z, (0, 0, -50, 0, 0), _Z) + _w(
        (0, 0, -7, 0, 0), _Z, _Z, _Z, (0, 0, 7, 0, 0)),
    _w((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0),
       (0, 0, 13, 0, 0), (0, 0, -1, 0, 0)),
    _w((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), _Z, (1, -10, 0, 10, -1),
       (0, 1, 0, -1, 0)),
    _w(_Z, _Z, (-1, 13, -24, 13, -1), _Z, _Z))
_SMOOTH_DC_ONLY = (
    _w((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3),
       (-3, 13, 0, -13, 3), (-1, -1, 0, 1, 1)),
    _w((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), _Z, (1, -13, -38, -13, 1),
       (1, 3, 3, 3, 1)),
    _w((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0), (0, 2, 7, 2, 0),
       (0, 0, 1, 0, 0)),
    _w((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), _Z, (0, -9, 0, 9, 0),
       (1, 0, 0, 0, -1)),
    _w(_Z, (0, 2, -5, 2, 0), (1, 7, -14, 7, 1), (0, 2, -5, 2, 0), _Z),
    _w(_Z, (0, 1, 0, -1, 0), (0, 2, 0, -2, 0), (0, 1, 0, -1, 0), _Z),
    _w(_Z, (0, 1, -3, 1, 0), _Z, (0, -1, 3, -1, 0), _Z),
    _w(_Z, (0, 1, 0, -1, 0), (0, -3, 0, 3, 0), (0, 1, 0, -1, 0), _Z),
    _w(_Z, (0, 1, 2, 1, 0), _Z, (0, -1, -2, -1, 0), _Z))
_SMOOTH_DC = _w((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6),
                (-8, 42, 152, 42, -8), (-6, 6, 42, 6, -6),
                (-2, -6, -8, -6, -2))


def _smoothing_ok(dec) -> bool:
    """libjpeg's smoothing_ok: a progressive image whose components all
    have their tables latched (the DC and Q01-Q30 entries nonzero) and
    some DC data, and some of whose coefficients 1-9 are not yet exact."""
    comps = dec.frame["comps"]
    if not dec.progressive:
        return False
    for c in comps:
        if c.qt is None or any(c.qt[p] == 0 for p in (0, *_SMOOTH_POS)):
            return False
        if c.coef_bits[0] < 0:
            return False
    return any(c.coef_bits[k] != 0 for c in comps for k in range(1, 10))


def _neighbour_rows(c, total: int, turbo21: bool) -> np.ndarray:
    """(bh, 5): the block rows two above to two below each block row of
    the component, as decompress_smooth_data picks them. libjpeg-turbo 3
    counts by the block row's place in the image, taking for the last iMCU
    row only the rows holding data; 2.1 (OpenCV 4.6's) asks the block row's
    place in its iMCU row or the iMCU row's place in the image, so that
    with two block rows an iMCU row a neighbour two rows off is replaced by
    the nearer one."""
    out = np.empty((c.bh, 5), np.int64)
    last = total - 1
    for r in range(c.bh):
        i, b = divmod(r, c.v)
        rows = c.v if i < last else (c.bh % c.v or c.v)
        if turbo21:
            up1, up2 = b > 0 or i > 0, b > 1 or i > 1
            dn1, dn2 = b < rows - 1 or i < last, b < rows - 2 or i + 1 < last
        else:
            ibr, ibrs = i * rows + b, rows * total
            up1, up2 = ibr > 0, ibr > 1
            dn1, dn2 = ibr < ibrs - 1, ibr < ibrs - 2
        prev = r - 1 if up1 else r
        nxt = r + 1 if dn1 else r
        out[r] = (r - 2 if up2 else prev, prev, r, nxt, r + 2 if dn2 else nxt)
    return out


def _div_pred(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """An estimate's value from its weighted sum: rounded, limited below
    the coefficient's next bit when some of it is known (al > 0)."""
    a = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        a = np.minimum(a, (1 << al) - 1)
    return np.where(num < 0, -a, a)


def _smooth(dec, c, coef: np.ndarray, turbo21: bool) -> np.ndarray:
    """decompress_smooth_data on one component: coef (ph, pw, 64) natural
    order -> the blocks the IDCT gets. Rows past the iMCU row where the
    last scan's data ran out take the coefficient bits from before that
    scan."""
    f = dec.frame
    total = f["mcuy"]
    q = [int(v) for v in c.qt]
    dc = coef[:, :, 0]
    rows = _neighbour_rows(c, total, turbo21)
    cols = np.clip(np.arange(c.bw)[:, None] + np.arange(-2, 3), 0, c.bw - 1)
    if turbo21 and c.bw == 2:       # 2.1 loads the column two right late
        cols = np.array([[0, 0, 0, 1, 0], [0, 0, 1, 0, 0]])
    # (bh, bw, 5, 5): the neighbourhood's DCs
    hood = dc[rows[:, None, :, None], cols[None, :, None, :]]
    out = coef.copy()
    blk = out[:c.bh, :c.bw]
    first = dec.n_scans > 1
    for good in (True, False):
        sel = np.arange(c.bh) // c.v
        sel = sel <= dec.last_good if good else sel > dec.last_good
        if not sel.any():
            continue
        if good:
            bits = c.coef_bits[:10]
        else:
            bits = [c.coef_bits[0]] + [b if first else -1
                                      for b in c.prev_bits[1:10]]
        change_dc = all(b == -1 for b in bits[1:10])
        h = hood[sel]
        kernels = _SMOOTH_DC_ONLY if change_dc else _SMOOTH_AC
        part = blk[sel]
        for k, (pos, wts) in enumerate(zip(_SMOOTH_POS, kernels)):
            al = bits[k + 1]
            if al == 0:
                continue
            num = q[0] * (h * wts).sum(axis=(-2, -1))
            est = _div_pred(num, q[pos], al)
            part[..., pos] = np.where(part[..., pos] == 0, est,
                                      part[..., pos])
        if change_dc:
            num = q[0] * (h * _SMOOTH_DC).sum(axis=(-2, -1))
            part[..., 0] = _div_pred(num, q[0], 0)
        blk[sel] = part
    return out


# ------------------------------------------------ IDCT, upsample, colour


def _w16(x):
    """x wrapped to 16 bits, as SIMD word arithmetic leaves it."""
    return ((x + 32768) & 0xFFFF) - 32768


def _w32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _idct_1d(d, shift):
    """One pass of libjpeg-turbo's SIMD ISLOW IDCT (jidctint-avx2.asm) over
    axis 1 of d (n, 8, m), int64 holding 16-bit words: jidctint.c's
    arithmetic with the sums in0 +- in4, in7 + in3 and in5 + in1 taken in
    16 bits, the products and the rest in 32, each output descaled and
    saturated to 16 bits."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[:, i] for i in range(8))
    z1 = (d2 + d6) * F0_541
    tmp2 = z1 - d6 * F1_847
    tmp3 = z1 + d2 * F0_765
    tmp0 = _w16(d0 + d4) << CONST_BITS
    tmp1 = _w16(d0 - d4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d7, d5, d3, d1
    z3, z4 = _w16(t0 + t2), _w16(t1 + t3)
    z5 = (z3 + z4) * F1_175
    t0 = t0 * F0_298
    t1 = t1 * F2_053
    t2 = t2 * F3_072
    t3 = t3 * F1_501
    z1 = (d7 + d1) * -F0_899
    z2 = (d5 + d3) * -F2_562
    z3 = z3 * -F1_961 + z5
    z4 = z4 * -F0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([np.clip(_w32(o + half) >> shift, -32768, 32767)
                     for o in out], axis=1)


def idct_islow(coef: np.ndarray, qt) -> np.ndarray:
    """(n, 64) coefficients in natural order and a quantization table ->
    (n, 8, 8) uint8 samples, as libjpeg-turbo's SIMD ISLOW IDCT gives them
    (what cv2 runs on x86): the coefficients times the table in 16 bits; a
    block whose rows 1-7 are all zero takes the DC-only path (each column
    its dequantised row-0 value << 2, in 16 bits); the output saturated to
    [-128, 127] and offset by 128."""
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    q = np.asarray(qt, np.int64).astype(np.int16).astype(np.int64)
    x = _w16(c * q.reshape(8, 8))                       # [n, row, col]
    ws = _idct_1d(x, CONST_BITS - PASS1_BITS)           # columns
    flat = ~c[:, 1:].any(axis=(1, 2))
    ws[flat] = _w16(x[flat, :1] << PASS1_BITS)
    out = _idct_1d(ws.transpose(0, 2, 1), CONST_BITS + PASS1_BITS + 3)
    return (np.clip(out.transpose(0, 2, 1), -128, 127) + 128).astype(
        np.uint8)


def _plane(c, smooth=None, opencv46=False) -> np.ndarray:
    """A component's samples, (dh, dw) uint8; `smooth` (the decoder) where
    libjpeg smooths the blocks first, as libjpeg-turbo 2.1 does where
    `opencv46`, else as 3.1 does."""
    coef = np.asarray(c.coef, np.int64).astype(np.int16)
    if c.qt is None:  # never in a scan: libjpeg's all-zero multipliers
        return np.full((c.dh, c.dw), 128, np.uint8)
    if smooth is not None:
        coef = _smooth(smooth, c, coef.astype(np.int64).reshape(
            c.ph, c.pw, 64), opencv46).astype(np.int16)
    blocks = idct_islow(coef.reshape(-1, 64), c.qt)
    img = blocks.reshape(c.ph, c.pw, 8, 8).transpose(0, 2, 1, 3).reshape(
        c.ph * 8, c.pw * 8)
    return img[:c.dh, :c.dw]


def _upsample(x: np.ndarray, hf: int, vf: int, w: int, h: int) -> np.ndarray:
    """jdsample.c: the component's (dh, dw) samples to (h, w)."""
    x = x.astype(np.int64)
    dh, dw = x.shape
    if hf == 1 and vf == 1:
        out = x
    elif hf == 2 and vf == 1 and dw > 2:                 # h2v1_fancy
        out = np.empty((dh, 2 * dw), np.int64)
        t = 3 * x
        out[:, 0] = x[:, 0]
        out[:, 2::2] = (t[:, 1:] + x[:, :-1] + 1) >> 2
        out[:, 1:-1:2] = (t[:, :-1] + x[:, 1:] + 2) >> 2
        out[:, -1] = x[:, -1]
    elif hf == 1 and vf == 2:                            # h1v2_fancy
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * dh, dw), np.int64)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
    elif hf == 2 and vf == 2 and dw > 2:                 # h2v2_fancy
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * dh, 2 * dw), np.int64)
        for v, other in ((0, up), (1, down)):
            cs = 3 * x + other                          # column sums
            row = np.empty((dh, 2 * dw), np.int64)
            row[:, 0] = (cs[:, 0] * 4 + 8) >> 4
            row[:, 1:-1:2] = (cs[:, :-1] * 3 + cs[:, 1:] + 7) >> 4
            row[:, 2::2] = (cs[:, 1:] * 3 + cs[:, :-1] + 8) >> 4
            row[:, -1] = (cs[:, -1] * 4 + 7) >> 4
            out[v::2] = row
    else:                                                # replication
        out = np.repeat(np.repeat(x, vf, axis=0), hf, axis=1)
    return out[:h, :w]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (SCALEBITS 16 tables)."""
    cb = cb - 128
    cr = cr - 128
    r = y + ((_fix16(1.40200) * cr + 32768) >> 16)
    g = y + ((-_fix16(0.34414) * cb + 32768 - _fix16(0.71414) * cr) >> 16)
    b = y + ((_fix16(1.77200) * cb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _cmyk_bgr(cmyk: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on libjpeg's CMYK samples, as RGB:
    each of C, M, Y becomes k - ((255 - v) k >> 8)."""
    x = cmyk.astype(np.int64)
    k = x[..., 3:]
    return (k - (((255 - x[..., :3]) * k) >> 8)).astype(np.uint8)


def _decode(data: bytes, name: str, ycc: bool | None = None,
            frame_limit=None, opencv46: bool = False, raw_cmyk=False):
    """The pixels and the frame of a JPEG stream. Three components are
    YCbCr converted to RGB, or RGB as stored where the markers say so
    (module doc); `ycc` True or False says it instead. Four are CMYK, or
    YCCK where an Adobe marker's transform is not 0 (Y Cb Cr to R G B, each
    inverted, K as stored), then OpenCV's CMYK to RGB, or the CMYK samples
    themselves where `raw_cmyk`. `frame_limit` (width, least rows, most
    rows) refuses another frame size before its coefficients are
    allocated."""
    dec = _Decoder(bytes(data), name)
    dec.frame_limit = frame_limit
    dec.opencv46 = opencv46
    dec.run()
    f = dec.frame
    w, h, comps = f["w"], f["h"], f["comps"]
    planes = []
    smooth = dec if _smoothing_ok(dec) else None
    for c in comps:
        hf, vf = f["hmax"] // c.h, f["vmax"] // c.v
        if f["hmax"] % c.h or f["vmax"] % c.v:
            dec.fail("JPEG with fractional sampling ratios is not supported")
        if dec.lossless:
            planes.append(getattr(c, "samples", np.zeros((h, w), np.uint8)))
        else:
            planes.append(_upsample(_plane(c, smooth, opencv46), hf, vf, w,
                                    h))
    if len(comps) == 1:
        return planes[0].astype(np.uint8)[..., None], f
    ids = [c.id for c in comps]
    if ycc is None:
        ycc = not ((not dec.jfif and dec.adobe == 0)
                   or (not dec.jfif and dec.adobe is None
                       and ids == [82, 71, 66]))
    if len(comps) == 4:
        ycc = dec.adobe is not None and dec.adobe != 0
    if dec.lossless and ycc:
        dec.fail(f"lossless JPEG in {'YCCK' if len(comps) == 4 else 'YCbCr'}"
                 ": cv2 reads none (libjpeg converts no colour in lossless "
                 "mode)")
    if len(comps) == 4:
        if ycc:                                             # YCCK
            planes[:3] = list(np.moveaxis(255 - _ycc_to_rgb(*planes[:3])
                                          .astype(np.int64), -1, 0))
        cmyk = np.stack(planes, -1).astype(np.uint8)
        return (cmyk if raw_cmyk else _cmyk_bgr(cmyk)), f
    if not ycc:
        return np.stack(planes, -1).astype(np.uint8), f
    return _ycc_to_rgb(*planes), f


def decode_jpeg(data: bytes, name: str = "<bytes>",
                opencv46: bool = False) -> np.ndarray:
    """The bytes of a JPEG file -> (H, W, 1) gray or (H, W, 3) RGB uint8,
    as cv2 5.0 reads them, or as the JAX tile loader's OpenCV 4.6 reads them
    where `opencv46` (module doc)."""
    return _decode(data, name, opencv46=opencv46)[0]


def decode_segment(tables: bytes | None, data: bytes, ycc: bool,
                   frame_limit, name: str = "<bytes>"):
    """A TIFF strip's or tile's JPEG stream (compression 7): the tables of
    JPEGTables (a tables-only stream, or None) read first, then the
    chunk's own stream, as libtiff feeds libjpeg; three components are
    YCbCr converted to RGB with `ycc`, else RGB as stored (libtiff sets
    the colour space by the TIFF's photometric); a frame other than
    `frame_limit` (width, least rows, most rows) raises before it is
    decoded. Returns the pixels and each component's sampling factors
    (h, v)."""
    if tables:
        if tables[:2] != SOI or data[:2] != SOI:
            raise ValueError(f"{name}: broken JPEG strip or tile (no SOI)")
        end = len(tables) - 2 if tables[-2:] == b"\xff\xd9" else len(tables)
        data = tables[:end] + data[2:]
    px, f = _decode(data, name, ycc, frame_limit)
    return px, [(c.h, c.v) for c in f["comps"]]


def read_jpeg(path: str | Path) -> np.ndarray:
    """What the JAX package's `_read_image` returns for a JPEG file through
    cv2: (H, W, 1) gray or (H, W, 3) RGB uint8."""
    return decode_jpeg(Path(path).read_bytes(), str(path))


# ------------------------------------------------- PIL's header walk


def _pil_open(data: bytes) -> tuple[int, int]:
    """(width, height) where PIL's JPEG plugin opens the file; raises
    where it does not (its marker walk up to SOS, and the checks of
    `Image.open` after it)."""
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError("not a JPEG file")
    pos, s = 3, b"\xff"
    size, layers = None, 0

    def read(n):
        nonlocal pos
        out = data[pos:pos + n]
        pos += len(out)
        return out

    def segment():
        head = read(2)
        if len(head) < 2:
            raise ValueError("truncated JPEG header")
        n = struct.unpack(">H", head)[0] - 2
        if n <= 0:
            return b""
        body = read(n)
        if len(body) < n:
            raise ValueError("Truncated File Read")
        return body

    while True:
        if not s:
            raise ValueError("no SOS marker")
        if s[0] != 0xFF:
            s = read(1)
            continue
        s = s + read(1)
        if len(s) < 2:
            raise ValueError("truncated JPEG header")
        m = (s[0] << 8) | s[1]
        if 0xFFC0 <= m <= 0xFFFE:
            if m in (0xFFC8, 0xFFD8, 0xFFD9) or 0xFFD0 <= m <= 0xFFD7 or \
                    0xFFF0 <= m <= 0xFFFD:
                pass                                   # no handler
            elif m in (0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6,
                       0xFFC7, 0xFFC9, 0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE,
                       0xFFCF, 0xFFDE):
                body = segment()
                if len(body) < 5:
                    raise ValueError("broken SOF")
                size = (struct.unpack(">H", body[3:5])[0],
                        struct.unpack(">H", body[1:3])[0])
                if body[0] != 8:
                    raise ValueError(f"cannot handle {body[0]}-bit layers")
                if len(body) < 6:
                    raise ValueError("broken SOF")
                layers = body[5]
                if layers not in (1, 3, 4):
                    raise ValueError(f"cannot handle {layers}-layer images")
                if (len(body) - 6) % 3:
                    raise ValueError("broken SOF")
            elif m == 0xFFDB:
                body = segment()
                while body:
                    n = 1 + (64 if body[0] // 16 == 0 else 128)
                    if len(body) < n:
                        raise ValueError("bad quantization table marker")
                    body = body[n:]
            else:                                       # Skip, APP, COM
                body = segment()
                if m == 0xFFE0 and body.startswith(b"JFIF") and len(body) < 7:
                    raise ValueError("broken JFIF marker")
                if m == 0xFFEE and body.startswith(b"Adobe") and len(body) < 7:
                    raise ValueError("broken Adobe marker")
            if m == 0xFFDA:
                break
            s = read(1)
        elif m == 0xFFFF:
            s = b"\xff"
        elif m == 0xFF00:
            s = read(1)
        else:
            raise ValueError("no marker found")
    if size is None or not layers or size[0] <= 0 or size[1] <= 0:
        raise ValueError("PIL identifies no JPEG image (no frame or size 0)")
    if size[0] * size[1] > 2 * 89478485:
        raise ValueError("decompression bomb")
    return size


def jpeg_size(path: str | Path) -> tuple[int, int]:
    """(width, height) as PIL's `Image.open(f).size` reads it."""
    try:
        return _pil_open(Path(path).read_bytes())
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def verify_jpeg(path: str | Path) -> None:
    """Raise ValueError where the JAX scan marks the file corrupt: PIL's
    `Image.open` fails, or a side is under MIN_SIDE."""
    w, h = jpeg_size(path)
    if w < MIN_SIDE or h < MIN_SIDE:
        raise ValueError("image size <10 pixels")


# ------------------------------------------------------------- encode


QUALITY = 75          # PIL's and libjpeg's default


def quality_table(base, quality: int) -> list[int]:
    """jcparam.c: the Annex K table scaled for `quality`, baseline-limited."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [min(max((b * scale + 50) // 100, 1), 255) for b in base]


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert (SCALEBITS 16; Cb / Cr round with
    0.5 - epsilon)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    off = (128 << 16) + half - 1
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
         + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + off) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + off) >> 16
    return y, cb, cr


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c on (n, 8, 8) centred samples -> (n, 8, 8) int64, scaled
    up by 8 as libjpeg leaves them."""
    def one(d, shift_odd, rows):
        d = [d[:, i] for i in range(8)]
        tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
        tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
        tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
        tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        out = [None] * 8
        if rows:
            out[0] = (tmp10 + tmp11) << PASS1_BITS
            out[4] = (tmp10 - tmp11) << PASS1_BITS
        else:
            h = 1 << (PASS1_BITS - 1)
            out[0] = (tmp10 + tmp11 + h) >> PASS1_BITS
            out[4] = (tmp10 - tmp11 + h) >> PASS1_BITS
        hs = 1 << (shift_odd - 1)
        z1 = (tmp12 + tmp13) * F0_541
        out[2] = (z1 + tmp13 * F0_765 + hs) >> shift_odd
        out[6] = (z1 - tmp12 * F1_847 + hs) >> shift_odd
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * F1_175
        tmp4, tmp5 = tmp4 * F0_298, tmp5 * F2_053
        tmp6, tmp7 = tmp6 * F3_072, tmp7 * F1_501
        z1, z2 = z1 * -F0_899, z2 * -F2_562
        z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
        out[7] = (tmp4 + z1 + z3 + hs) >> shift_odd
        out[5] = (tmp5 + z2 + z4 + hs) >> shift_odd
        out[3] = (tmp6 + z2 + z3 + hs) >> shift_odd
        out[1] = (tmp7 + z1 + z4 + hs) >> shift_odd
        return np.stack(out, axis=1)

    x = blocks.astype(np.int64)
    # pass 1 over each row (axis 2), results stored as 16-bit DCTELEMs
    x = one(x.transpose(0, 2, 1), CONST_BITS - PASS1_BITS, True)
    x = x.transpose(0, 2, 1).astype(np.int16).astype(np.int64)
    x = one(x, CONST_BITS + PASS1_BITS, False)
    return x.astype(np.int16).astype(np.int64)


def _reciprocal(divisor: int):
    """libjpeg-turbo's compute_reciprocal (16-bit DCTELEM): (recip, corr,
    shift) with q = ((|x| + corr) * recip) >> shift."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def _quantize(x: np.ndarray, qt) -> np.ndarray:
    """(n, 64) FDCT output, natural order -> quantized coefficients."""
    rec = np.array([_reciprocal(q << 3) for q in qt], np.int64)
    a = np.abs(x)
    q = ((a + rec[:, 1]) * rec[:, 0]) >> rec[:, 2]
    return np.where(x < 0, -q, q)


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """libjpeg's expand_bottom_edge / expand_right_edge: replicate the last
    row and column out to (rows, cols)."""
    return np.pad(plane, ((0, rows - plane.shape[0]),
                          (0, cols - plane.shape[1])), mode="edge")


def _code_arrays(counts, symbols):
    """A canonical Huffman table's (code, length) of each symbol 0-255."""
    c = np.zeros(256, np.int64)
    n = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            c[symbols[k]], n[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return c, n


def _entropy_encode(blocks: np.ndarray, comp: np.ndarray, tabs) -> bytes:
    """Baseline Huffman coding of (n, 64) quantized blocks (natural
    order) in file order; comp[i] is block i's component, tabs[c] its
    (dc codes, dc lengths, ac codes, ac lengths). Returns the stuffed
    entropy-coded bytes, padded with 1-bits (jchuff.c)."""
    zz = blocks[:, NATURAL[:64]]
    n = len(zz)
    # DC differences per component, in block order
    dc = zz[:, 0]
    prev = np.zeros(n, np.int64)
    for c in np.unique(comp):
        idx = np.nonzero(comp == c)[0]
        prev[idx[1:]] = dc[idx[:-1]]
    diff = dc - prev

    def size_bits(v):
        a = np.abs(v)
        s = np.zeros_like(a)
        for b in range(16):
            s += a >= (1 << b)
        return s, np.where(v < 0, v - 1, v) & ((1 << s) - 1)

    # the fields, each (block, order within block, value, length)
    fb, fo, fv, fl = [], [], [], []
    dcs, dcbits = size_bits(diff)
    dcode = np.empty(n, np.int64)
    dlen = np.empty(n, np.int64)
    for c in np.unique(comp):
        m = comp == c
        dcode[m] = tabs[c][0][dcs[m]]
        dlen[m] = tabs[c][1][dcs[m]]
    blk = np.arange(n)
    fb += [blk]
    fo += [np.zeros(n, np.int64)]
    fv += [(dcode << dcs) | dcbits]
    fl += [dlen + dcs]
    # AC: runs of zeros before each nonzero coefficient, ZRLs, EOB
    ac = zz[:, 1:]
    bi, ki = np.nonzero(ac)
    vals = ac[bi, ki]
    k = ki + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prevk = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prevk - 1
    nzrl = run // 16
    run = run % 16
    s, bits = size_bits(vals)
    cc = comp[bi]
    acode = np.empty(len(bi), np.int64)
    alen = np.empty(len(bi), np.int64)
    zcode = np.empty(len(bi), np.int64)
    zlen = np.empty(len(bi), np.int64)
    for c in np.unique(comp):
        m = cc == c
        sym = (run[m] << 4) | s[m]
        acode[m] = tabs[c][2][sym]
        alen[m] = tabs[c][3][sym]
        zcode[m] = tabs[c][2][0xF0]
        zlen[m] = tabs[c][3][0xF0]
    # ZRL fields (each nonzero may need up to 3), ordered before it
    for j in range(3):
        m = nzrl > j
        fb += [bi[m]]
        fo += [2 * k[m] - 1]
        fv += [zcode[m]]
        fl += [zlen[m]]
    fb += [bi]
    fo += [2 * k]
    fv += [(acode << s) | bits]
    fl += [alen + s]
    # EOB where the last nonzero is before position 63
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)
    eob = last < 63
    ecode = np.array([tabs[c][2][0] for c in comp], np.int64)
    elen = np.array([tabs[c][3][0] for c in comp], np.int64)
    fb += [blk[eob]]
    fo += [np.full(int(eob.sum()), 200, np.int64)]
    fv += [ecode[eob]]
    fl += [elen[eob]]
    fb, fo = np.concatenate(fb), np.concatenate(fo)
    fv, fl = np.concatenate(fv), np.concatenate(fl)
    order = np.lexsort((fo, fb))
    fv, fl = fv[order], fl[order]
    # the fields' bits, then 1-bits to a whole byte
    total = int(fl.sum())
    starts = np.cumsum(fl) - fl
    owner = np.repeat(np.arange(len(fl)), fl)
    pos = np.arange(total) - starts[owner]
    bitv = (fv[owner] >> (fl[owner] - 1 - pos)) & 1
    pad = (-total) % 8
    bitv = np.concatenate([bitv, np.ones(pad, np.int64)]).astype(np.uint8)
    raw = np.packbits(bitv)
    # byte stuffing: a 0x00 after every 0xFF
    ff = np.nonzero(raw == 0xFF)[0]
    return np.insert(raw, ff + 1, 0).tobytes()


def _marker(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(payload) + 2) + payload


def encode_jpeg(arr: np.ndarray) -> bytes:
    """uint8 (H, W) / (H, W, 1) gray or (H, W, 3) RGB -> the JPEG bytes
    PIL writes for it at its defaults (module note)."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_jpeg takes uint8, not {arr.dtype}")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        planes, samp = [arr.astype(np.int64)], [(1, 1)]
    elif arr.ndim == 3 and arr.shape[2] == 3:
        planes, samp = list(_rgb_to_ycc(arr)), [(2, 2), (1, 1), (1, 1)]
    else:
        raise ValueError(f"write_jpeg takes gray or RGB, not {arr.shape}")
    h, w = arr.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"image size {w} x {h} does not fit a JPEG")
    qts = [quality_table(QT_LUMA, QUALITY), quality_table(QT_CHROMA, QUALITY)]
    hmax = max(s[0] for s in samp)
    vmax = max(s[1] for s in samp)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    # the colour buffer is padded down to whole row groups (vmax rows)
    rows = -(-h // vmax) * vmax
    comp_blocks = []
    for ci, (plane, (hs, vs)) in enumerate(zip(planes, samp)):
        bw = -(-(-(-w * hs // hmax)) // 8)
        bh = -(-(-(-h * vs // vmax)) // 8)
        if hs == hmax and vs == vmax:
            x = _pad(plane, rows, bw * 8)
        else:  # h2v2 with the alternating bias 1, 2, 1, 2, ...
            x = _pad(plane, rows, bw * 16)
            bias = np.tile([1, 2], bw * 4)
            x = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2]
                 + x[1::2, 1::2] + bias) >> 2
        x = _pad(x, mcuy * vs * 8, x.shape[1])[:, :bw * 8]
        blk = x.reshape(mcuy * vs, 8, bw, 8).transpose(0, 2, 1, 3)
        co = _fdct_islow((blk - 128).reshape(-1, 8, 8)).reshape(-1, 64)
        q = _quantize(co, qts[min(ci, 1)]).reshape(mcuy * vs, bw, 64)
        # dummy blocks at the right: zero AC, the left neighbour's DC
        full = np.zeros((mcuy * vs, mcux * hs, 64), np.int64)
        full[:, :bw] = q
        for bx in range(bw, mcux * hs):
            full[:, bx, 0] = full[:, bx - 1, 0]
        comp_blocks.append((full, bh, hs, vs))
    # file order: per MCU, each component's vs x hs blocks; a block row
    # under the component's last is a dummy row (zero AC, and the DC of the
    # block before it in the MCU)
    order, comp = [], []
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (full, bh, hs, vs) in enumerate(comp_blocks):
                for yy in range(vs):
                    for xx in range(hs):
                        if my * vs + yy < bh:
                            b = full[my * vs + yy, mx * hs + xx]
                        else:
                            b = np.zeros(64, np.int64)
                            b[0] = order[-1][0]
                        order.append(b)
                        comp.append(ci)
    blocks = np.stack(order)
    comp = np.array(comp, np.int64)
    tabs = []
    for ci in range(len(planes)):
        t = min(ci, 1)
        tabs.append(_code_arrays(*STD_HUFFMAN[(0, t)])
                    + _code_arrays(*STD_HUFFMAN[(1, t)]))
    scan = _entropy_encode(blocks, comp, tabs)
    out = [SOI, _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(min(len(planes), 2)):
        out.append(_marker(0xDB, bytes([t]) + bytes(
            qts[t][NATURAL[k]] for k in range(64))))
    sof = struct.pack(">BHHB", 8, h, w, len(planes))
    for ci, (hs, vs) in enumerate(samp):
        sof += bytes([ci + 1, (hs << 4) | vs, min(ci, 1)])
    out.append(_marker(0xC0, sof))
    for t in range(min(len(planes), 2)):
        for tc in (0, 1):
            counts, syms = STD_HUFFMAN[(tc, t)]
            out.append(_marker(0xC4, bytes([(tc << 4) | t]) + bytes(counts)
                               + bytes(syms)))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        t = min(ci, 1)
        sos += bytes([ci + 1, (t << 4) | t])
    out.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    out.append(scan)
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path: str | Path, arr: np.ndarray) -> None:
    """Write `arr` as PIL's `Image.fromarray(arr).save(path)` writes it."""
    Path(path).write_bytes(encode_jpeg(arr))
