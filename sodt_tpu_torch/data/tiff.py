"""TIFF decode and encode in numpy and the stdlib (`zlib`): the plain version
of the port's TIFF decoder (`csrc/tiff.cpp`), and the reader of the box
crops' tool.

The card's machine has neither cv2 nor PIL, so the port carries its own
TIFF code, as it does for PNG, JPEG and BMP. `read_tiff` returns what the
JAX package's `_read_image` returns (`sodt_tpu/data/vedai.py`: cv2's
IMREAD_UNCHANGED then `[..., ::-1]`, or `np.asarray(PIL.Image.open(f))`
where cv2 is absent), taking for each kind the branch `png.py` names: 8-bit
gray, RGB and RGBA as cv2 5.0 gives them, palette, 1-, 2-, 4- and 16-bit
images as PIL gives them. The kinds aerial imagery adds (JPEG, YCbCr, CMYK,
signed, float and 32-bit samples) take cv2's branch: cv2 reads every one of
them, where PIL opens only some and differs on several (int16 widened to
int32, uint32 and int8 reinterpreted, CMYK as inverted ink, no float or
integer colour, big-endian floats under predictor 3 misread), and JAX's
`_read_image` takes cv2 wherever it imports. CMYK with an extra sample,
which cv2 does not read, takes PIL's.

  kind                              read_tiff                       branch
  8-bit gray (MinIsBlack)           (H, W, 1) uint8                 cv2
  8-bit gray (MinIsWhite)           (H, W, 1) 255 - v               cv2
  8-bit gray + extra sample         (H, W, 1) the gray sample       cv2
  8-bit RGB                         (H, W, 3) uint8                 cv2
  8-bit RGB + extra sample          (H, W, 4) A R G B; R G B        cv2
                                      premultiplied (c a + 127)
                                      // 255 where ExtraSamples
                                      is 2 (unassociated alpha)
  JPEG (7): gray, RGB (photometric  (H, W, 1) / (H, W, 3) uint8:    cv2
    2), YCbCr (6) of 1 x 1, 2 x 1,    each strip's or tile's stream
    2 x 2 data units                  after JPEGTables, through
                                      `jpeg.decode_segment`; YCbCr
                                      to RGB (libjpeg's fancy
                                      upsampling, which libtiff leaves
                                      on), RGB as stored
  YCbCr (6), not JPEG: 1 x 1,       (H, W, 3) uint8 RGB: each data  cv2
    2 x 1, 2 x 2 data units           unit's Cb Cr on its pixels,
                                      libtiff's TIFFYCbCrToRGB (16-bit
                                      fixed point from the float32
                                      YCbCrCoefficients and Reference-
                                      BlackWhite, defaults .299 .587
                                      .114 and 0 255 128 255 128 255)
  CMYK (5), 8-bit, InkSet 1         (H, W, 4) 255, R, G, B; R =     cv2
                                      (255 - K)(255 - C) // 255
  CMYK + extra sample               (H, W, 3) C M Y as stored       PIL
  signed 8-, 16-, 32-bit, unsigned  (H, W, 1) / (H, W, 3) int8,     cv2
    32-bit, float 32- and 64-bit:     int16, int32, uint32, float32,
    gray, RGB, RGB + extra sample     float64 as stored; (H, W, 4)
                                      A R G B, nothing premultiplied
  1-bit gray                        (H, W, 1) bool (1: white;       PIL
                                      MinIsWhite: 0 is white)
  2-, 4-bit gray                    (H, W, 1) uint8 v * 85, v * 17  PIL
                                      (MinIsWhite: inverted)
  16-bit gray                       (H, W, 1) uint16 as stored      PIL
                                      (MinIsWhite too)
  16-bit RGB, RGB + extra sample    (H, W, 3) uint8 each sample's   PIL
                                      high byte (associated alpha:
                                      divided out, min(255,
                                      c * 255 // a), 0 where a is 0)
  1-, 2-, 4-, 8-bit palette         (H, W, 1) uint8 palette         PIL
                                      indices

  read_tiff_rgb(path)  (H, W, 3) uint8 RGB as PIL's `convert("RGB")`:
                       palette colours (the colour map's samples // 256),
                       16-bit gray clipped at 255, other 16-bit samples
                       their high byte, associated alpha divided out, any
                       alpha dropped; float gray ("F") truncated and
                       clipped to 0-255, NaN 0; "I" gray (int16, int32,
                       uint32 read as int32) clipped; int8 as its bytes
                       ("L"); CMYK nk - c nk / 255 (PIL's rounding); JPEG
                       and YCbCr as `read_tiff`. Raises where PIL opens no
                       such file, and for uncompressed YCbCr, which PIL
                       reads as RGBX bytes and runs out of. A big-endian
                       float under predictor 3, which PIL misreads, follows
                       the true samples.
  tiff_size(path)      (width, height) as PIL's `Image.size`: swapped where
                       the Orientation tag is 5-8.
  verify_tiff(path)    raises where PIL's `Image.open` (its `verify` reads
                       no pixels) plus the JAX scan's 10 px assert fail (a
                       float or integer RGB TIFF, which PIL does not open, is
                       corrupt to the scan).
  write_tiff(path, arr, compression, predictor, tile)
                       uint8 or uint16 gray or RGB, float32 gray, as a
                       little-endian TIFF: no compression, deflate,
                       PackBits or JPEG (uint8; RGB as YCbCr 4:2:0, the
                       port's PIL-equal encoder, JPEGTables); one strip or
                       tiles; predictor 2 or 3 (the files `chip_smoke.py`
                       and the folder tests write).

Read: byte order II and MM, classic TIFF and BigTIFF, the first IFD only
(as cv2 and PIL read a multi-page file); strips and tiles; planar
configuration 1 and 2 (1 only for the kinds aerial imagery adds);
compression 1 (none), 5 (LZW), 7 (JPEG), 8 and 32946 (deflate), 32773
(PackBits), 34892 (DNG 1.4's lossy JPEG, which libtiff has no decoder for:
each strip faults at its first byte, so the RGBA reader's kinds read zeros
on the cv2 branch and the others raise, as cv2 reads and fails); predictor 1, 2 (at 8, 16, 32 and 64 bits, on the unsigned
word) and 3 (floating point: each row's bytes summed at the pixel's
stride, then read as planes, most significant byte first, whatever the
byte order); FillOrder 1 and 2 (2 reverses each byte's bits before the
codec, as libtiff does; its JPEG codec ignores it); photometric 0, 1, 2, 3,
5 and 6. The RATIONAL tags are read as libtiff reads them, float(double(n)
/ d).

The Orientation tag: cv2 turns the image by it (2-4 flip it, in both
OpenCVs), and so does PIL 12 on load for 2-4. OpenCV 4.6 also turns it by
5-8 (transposes), where cv2 5.0 returns no image; the cv2 branch here takes
4.6's turn. PIL reads a 5-8 file with its sides swapped before it turns it,
so the PIL branch raises NotImplementedError for those, and so do the kinds
aerial imagery adds for any turn.

A damaged file: a strip or tile past the end of the file raises
ValueError, as cv2 returns no image and PIL fails. Where a strip's
compressed data stops short or breaks (a cut LZW or PackBits run, a bad
LZW code, a bad deflate stream), libtiff's RGBA reader, through which both
OpenCVs read the unsigned kinds of 8 bits and fewer but JPEG, keeps the
strip as its decoder left it: the bytes that came before the fault, zeros
after, the predictor not undone (a cut PackBits literal run is dropped
whole; deflate is zlib's reading, which stops at the strip's last byte and
reads no Adler-32 after it). `read_tiff` does the same on its cv2 branch
for those kinds and raises ValueError elsewhere, as PIL and OpenCV's
encoded-strip read fail; `read_tiff_rgb` raises, as PIL's `convert` fails.
A JPEG strip decodes as the JPEG decoder decodes a file (a cut stream
filled as libjpeg fills it) and raises where it raises; a frame narrower
than the strip or tile, shorter than its rows, or sampled unlike
YCbCrSubsampling (1 x 1 unless YCbCr) raises, as libtiff refuses it. An
uncompressed strip is read from its offset for as many bytes as its rows
take, as PIL reads it and as libtiff reads a file of one strip whose byte
count is bogus. The Predictor tag counts with LZW and deflate only, as
libtiff registers it with those codecs alone. A 16-bit palette, and 16-bit
float samples, raise ValueError: neither cv2 nor PIL reads one. So does an
image of more than 2^30 pixels, which OpenCV refuses, before any is
allocated, and one of more than 2 x 89478485 wherever the port reads as PIL
does, as PIL's open refuses it.

A DNG is read as this reads a TIFF (its IFD0, as cv2 and PIL read it); a
raw IFD0 (photometric CFA 32803, LinearRaw 34892) raises ValueError, as
cv2 and PIL read no image from it.

Out of scope, raising NotImplementedError naming the kind (ROADMAP Queue 1
item 18): CCITT (2, 3, 4), old-style JPEG (6) and other compressions,
old-style LZW, CIELab and the other photometrics, YCbCr subsampled other
than 1 x 1, 2 x 1, 2 x 2, JPEG-compressed CMYK, InkSet 2, a palette with
extra samples, 16-bit gray or signed / float / 32-bit gray with an extra
sample, more than one extra sample, planar configuration 2 or an
Orientation turn for the kinds aerial imagery adds, uncompressed tiles
under FillOrder 2 (libtiff fails on the small ones).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .jpeg import decode_segment

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
MIN_SIDE = 10        # the JAX scan's "image size <10 pixels" assert
MAX_PIXELS = 1 << 30             # OpenCV's CV_IO_MAX_IMAGE_PIXELS
PIL_MAX_PIXELS = 2 * 89478485    # PIL's decompression bomb, at open
# tag type -> bytes a value takes
TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
             11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_INT_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I",
            16: "Q", 17: "q", 18: "Q"}
# the compressions read (none, LZW, JPEG, deflate twice, PackBits) -> the
# most bytes each makes of one byte of its data (LZW: a 9-bit code for a
# string of up to 4096 bytes; JPEG: a 16 x 16 MCU of 768 bytes in 4 bits)
RATIO = {1: 1, 5: 4096, 7: 1536, 8: 1032, 32946: 1032, 32773: 128,
         34892: 1536}
# DNG 1.4's lossy JPEG, which libtiff knows no decoder for: each strip
# faults at its first byte (cv2's RGBA-reader kinds read zeros)
NO_DECODER = {34892: "compression 34892 (DNG's lossy JPEG): libtiff has no "
                     "decoder for it"}
_COMPRESSION_NAMES = {2: "CCITT RLE (2)", 3: "CCITT Group 3 (3)",
                      4: "CCITT Group 4 (4)", 6: "old-style JPEG (6)",
                      34712: "JPEG 2000 (34712)",
                      34925: "LZMA (34925)", 50000: "Zstandard (50000)",
                      50001: "WebP (50001)"}
# the compressions PIL knows the name of (an unknown one fails its open)
PIL_COMPRESSIONS = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946,
                    34676, 34677, 34925, 50000, 50001}
_PHOTOMETRIC_NAMES = {4: "transparency mask (4)", 5: "CMYK (5)",
                      6: "YCbCr (6)", 8: "CIELab (8)", 9: "ICCLab (9)",
                      10: "ITULab (10)", 32844: "LogL (32844)",
                      32845: "LogLuv (32845)", 32803: "CFA (32803)",
                      34892: "LinearRaw (34892)"}


def _pil_keys() -> dict:
    """PIL's OPEN_INFO keys (byte order, photometric, sample format, fill
    order, bits per sample, extra samples) -> PIL's mode: the kinds PIL's
    `Image.open` takes."""
    t = {}
    for bo in "<>":
        for fill in (1, 2):
            for bits in (1, 2, 4, 8):
                for photo in (0, 1):
                    t[bo, photo, (1,), fill, (bits,), ()] = (
                        "1" if bits == 1 else "L")
                t[bo, 3, (1,), fill, (bits,), ()] = "P"
            t[bo, 2, (1,), fill, (8,) * 3, ()] = "RGB"
        t[bo, 1, (2,), 1, (8,), ()] = "L"
        t[bo, 1, (1,), 1, (8, 8), (2,)] = "LA"
        for extra, mode in (((), "RGBA"), ((0,), "RGB"), ((1,), "RGBA"),
                            ((2,), "RGBA"), ((999,), "RGBA")):
            t[bo, 2, (1,), 1, (8,) * 4, extra] = mode
        for extra, mode in (((0,), "RGB"), ((1,), "RGBA"), ((2,), "RGBA")):
            for more in (1, 2):
                t[bo, 2, (1,), 1, (8,) * (4 + more), extra + (0,) * more] = (
                    mode)
        t[bo, 2, (1,), 1, (16,) * 3, ()] = "RGB"
        for extra, mode in (((), "RGBA"), ((0,), "RGB"), ((1,), "RGBA"),
                            ((2,), "RGBA")):
            t[bo, 2, (1,), 1, (16,) * 4, extra] = mode
        t[bo, 3, (1,), 1, (8, 8), (0,)] = "P"
        t[bo, 3, (1,), 1, (8, 8), (2,)] = "PA"
        for n, extra in ((4, ()), (5, (0,)), (6, (0, 0))):
            t[bo, 5, (1,), 1, (8,) * n, extra] = "CMYK"
        t[bo, 5, (1,), 1, (16,) * 4, ()] = "CMYK"
        t[bo, 6, (1,), 1, (8,), ()] = "L"
        t[bo, 6, (1,), 1, (8,) * 3, ()] = "RGB"
        t[bo, 8, (1,), 1, (8,) * 3, ()] = "LAB"
        t[bo, 1, (2,), 1, (16,), ()] = "I"
        t[bo, 1, (2,), 1, (32,), ()] = "I"
        for photo in (0, 1):
            t[bo, photo, (3,), 1, (32,), ()] = "F"
    t["<", 1, (1,), 1, (12,), ()] = "I;16"
    t["<", 0, (1,), 1, (16,), ()] = "I;16"
    t["<", 1, (1,), 1, (16,), ()] = "I;16"
    t[">", 1, (1,), 1, (16,), ()] = "I;16B"
    t["<", 1, (1,), 2, (16,), ()] = "I;16"
    t["<", 1, (1,), 1, (32,), ()] = "I"
    return t


PIL_KEYS = _pil_keys()


class _Ifd:
    """The first IFD: byte order, BigTIFF or not, {tag: tuple of ints},
    {tag: tuple of float32 values} of its RATIONAL tags, and the bytes of
    JPEGTables (347)."""

    def __init__(self, bo: str, big: bool, tags: dict, rationals: dict,
                 tables: bytes | None):
        self.bo, self.big, self.tags = bo, big, tags
        self.rationals, self.tables = rationals, tables

    def get(self, tag: int, default=None):
        v = self.tags.get(tag)
        return default if v is None else v


def _walk_ifd(data: bytes, name: str, pil: bool) -> _Ifd:
    """Read the first IFD. With `pil`, as PIL's `ImageFileDirectory_v2`
    reads it: BigTIFF told by the third byte being 43 (which misses a
    big-endian BigTIFF), a read that runs out ending the walk with the tags
    read so far, a tag of a type PIL does not know skipped. Without, as
    libtiff reads it: any short read raises. RATIONAL values are kept as
    libtiff reads them, float(double(n) / d) (0 where d is 0)."""
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{name}: not a TIFF file (signature)")
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43 if pil else data[:4] in SIGNATURES[2:]
    if big and not pil and (len(data) < 8 or struct.unpack(
            bo + "HH", data[4:8]) != (8, 0)):
        raise ValueError(f"{name}: broken BigTIFF header")
    head = 16 if big else 8
    if len(data) < head:
        raise ValueError(f"{name}: truncated TIFF file (header)")
    first = struct.unpack_from(bo + ("Q" if big else "I"), data,
                               8 if big else 4)[0]
    if not first:
        raise ValueError(f"{name}: broken TIFF file (no IFD)")
    ent, count_bytes, inline = (20, 8, 8) if big else (12, 2, 4)
    tags, rationals, tables = {}, {}, None
    pos = first
    try:
        if pos + count_bytes > len(data):
            raise EOFError("IFD past the end of the file")
        n = struct.unpack_from(bo + ("Q" if big else "H"), data, pos)[0]
        pos += count_bytes
        for _ in range(n):
            if pos + ent > len(data):
                raise EOFError("IFD cut short")
            tag, typ = struct.unpack_from(bo + "HH", data, pos)
            count = struct.unpack_from(bo + ("Q" if big else "I"), data,
                                       pos + 4)[0]
            field = pos + (12 if big else 8)
            pos += ent
            if typ not in TYPE_SIZE:
                continue
            size = count * TYPE_SIZE[typ]
            at = field
            if size > inline:
                at = struct.unpack_from(bo + ("Q" if big else "I"), data,
                                        field)[0]
                if at + size > len(data):
                    raise EOFError(f"tag {tag}'s data past the end of the "
                                   "file")
            if tag == 347 and typ in (1, 7):
                tables = bytes(data[at:at + size])
            if not size:
                continue
            if typ == 5:
                v = struct.unpack_from(f"{bo}{2 * count}I", data, at)
                rationals[tag] = tuple(
                    float(np.float32(a / b)) if b else 0.0
                    for a, b in zip(v[::2], v[1::2]))
            if typ not in _INT_FMT:
                continue
            tags[tag] = struct.unpack_from(f"{bo}{count}{_INT_FMT[typ]}",
                                           data, at)
    except EOFError as e:
        if not pil:
            raise ValueError(f"{name}: broken TIFF file ({e})") from None
    return _Ifd(bo, big, tags, rationals, tables)


def _one(ifd: _Ifd, tag: int, default=None):
    v = ifd.get(tag)
    return default if v is None else v[0]


# (SampleFormat, bits) -> the samples' dtype
DTYPES = {(1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
          (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
          (3, 32): np.float32, (3, 64): np.float64}
YCBCR_SUBSAMPLING = ((1, 1), (2, 1), (2, 2))
LUMA = (0.299, 0.587, 0.114)                  # YCbCrCoefficients' default
REF_BW = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)  # libtiff's for YCbCr


def _info(data: bytes, name: str) -> SimpleNamespace:
    """The image the first IFD describes; raises ValueError where no reader
    takes it, NotImplementedError for a kind out of the port's scope."""
    ifd = _walk_ifd(data, name, pil=False)
    w, h = _one(ifd, 256), _one(ifd, 257)
    if not w or not h or w < 0 or h < 0:
        raise ValueError(f"{name}: broken TIFF file (no image size)")
    if w > 1 << 16 or h > 1 << 16:
        raise ValueError(f"{name}: unsupported image size {w} x {h}")
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: image too large ({w} x {h} pixels; "
                         "OpenCV reads at most 2^30)")
    comp = _one(ifd, 259, 1)
    photo = _one(ifd, 262)
    spp = _one(ifd, 277, 1)
    bps = ifd.get(258, (1,))
    sfs = ifd.get(339, (1,))
    # libtiff knows the Predictor tag only with the codecs that take it
    pred = _one(ifd, 317, 1) if comp in (5, 8, 32946) else 1
    fill = _one(ifd, 266, 1)
    extra = ifd.get(338, ())
    planar = _one(ifd, 284, 1)
    orient = _one(ifd, 274, 1)

    def out_of_scope(what):
        return NotImplementedError(
            f"{name}: a TIFF image with {what}; the port reads uncompressed, "
            "LZW, deflate, PackBits and JPEG gray, RGB, palette, CMYK and "
            "YCbCr images of unsigned, signed and float samples")

    if comp not in RATIO:
        raise out_of_scope(_COMPRESSION_NAMES.get(
            comp, f"compression {comp}"))
    if photo is None:
        raise ValueError(f"{name}: broken TIFF file (no photometric "
                         "interpretation)")
    if photo in (32803, 34892):
        raise ValueError(
            f"{name}: a raw DNG image (photometric "
            f"{_PHOTOMETRIC_NAMES[photo]}): cv2 and PIL read none from it")
    if photo not in (0, 1, 2, 3, 5, 6):
        raise out_of_scope(
            f"photometric {_PHOTOMETRIC_NAMES.get(photo, photo)}")
    if len(set(bps)) != 1:
        raise out_of_scope(f"mixed bits per sample {bps}")
    bits = bps[0]
    if len(set(sfs)) != 1:
        raise out_of_scope(f"mixed sample formats {sfs}")
    sf = sfs[0]
    if sf not in (1, 2, 3):
        raise out_of_scope(f"SampleFormat {sf}")
    if sf == 3 and bits == 16:
        raise ValueError(f"{name}: unreadable TIFF (16-bit floating-point "
                         "samples, which neither cv2 nor PIL reads)")
    if (sf, bits) not in DTYPES and not (sf == 1 and bits in (1, 2, 4)):
        raise out_of_scope(f"{bits}-bit samples (SampleFormat {sf})")
    if pred not in (1, 2, 3):
        raise out_of_scope(f"predictor {pred}")
    if pred == 3 and sf != 3:
        raise ValueError(f"{name}: broken TIFF file (the floating-point "
                         f"predictor with SampleFormat {sf})")
    if fill not in (1, 2):
        raise ValueError(f"{name}: broken TIFF file (FillOrder {fill})")
    numeric = sf != 1 or bits >= 32
    colours = {2: 3, 5: 4, 6: 3}.get(photo, 1)
    if spp - colours not in (0, 1):
        raise out_of_scope(f"{spp} samples per pixel (photometric {photo})")
    more = spp > colours
    if more and photo == 3:
        raise out_of_scope("a palette and an extra sample")
    if more and bits == 16 and photo < 2:
        raise out_of_scope("16-bit gray and an extra sample")
    if more and bits < 8:
        raise out_of_scope(f"{bits}-bit samples and an extra sample")
    if photo == 2 and bits < 8:
        raise out_of_scope(f"{bits}-bit RGB")
    if photo == 3 and bits > 8:
        raise ValueError(f"{name}: unreadable TIFF (a {bits}-bit palette, "
                         "which neither libtiff nor PIL reads)")
    if pred == 2 and bits < 8:
        raise ValueError(f"{name}: broken TIFF file (predictor 2 with "
                         f"{bits}-bit samples)")
    if numeric and photo not in (1, 2):
        raise out_of_scope(f"{bits}-bit samples of SampleFormat {sf} under "
                           f"photometric {photo}")
    if numeric and more and photo == 1:
        raise out_of_scope(f"{bits}-bit gray (SampleFormat {sf}) and an "
                           "extra sample")
    if photo in (5, 6) and (bits != 8 or sf != 1):
        raise out_of_scope(f"{bits}-bit samples under photometric "
                           f"{_PHOTOMETRIC_NAMES[photo]}")
    if photo == 5 and _one(ifd, 332, 1) != 1:
        raise out_of_scope(f"InkSet {_one(ifd, 332)} (CMYK is InkSet 1)")
    sub = ifd.get(530, ())
    sub = tuple(sub[:2]) if len(sub) >= 2 else (2, 2)
    if photo == 6:
        if more:
            raise out_of_scope("YCbCr and an extra sample")
        if sub not in YCBCR_SUBSAMPLING:
            raise out_of_scope(f"YCbCr subsampling {sub[0]} x {sub[1]}")
        if pred != 1 and sub != (1, 1):
            raise out_of_scope(f"predictor {pred} with subsampled YCbCr")
    if comp == 7:
        if photo not in (1, 2, 6) or bits != 8 or sf != 1 or more:
            raise out_of_scope(f"JPEG compression under photometric {photo} "
                               f"({spp} x {bits} bits)")
        pred, fill = 1, 1           # libtiff's JPEG codec reverses no bits
    new_kind = numeric or photo in (5, 6) or comp == 7
    if new_kind and orient != 1:
        raise out_of_scope(f"orientation {orient} with photometric {photo} "
                           f"and {bits}-bit samples of SampleFormat {sf}")
    if planar == 2 and spp > 1 and new_kind:
        raise out_of_scope(f"planar configuration 2 under photometric "
                           f"{photo} with {bits}-bit samples")
    cmap = None
    if photo == 3:
        cmap = ifd.get(320)
        if cmap is None or len(cmap) < 3 << bits:
            raise ValueError(f"{name}: broken TIFF file (no colour map)")
        cmap = np.asarray(cmap[:3 << bits], np.int64).reshape(3, -1).T
    tiled = 322 in ifd.tags or 324 in ifd.tags
    if tiled:
        tw, th = _one(ifd, 322), _one(ifd, 323)
        offsets, counts = ifd.get(324), ifd.get(325)
        if not tw or not th or offsets is None:
            raise ValueError(f"{name}: broken TIFF file (tiles)")
    else:
        tw, th = w, min(_one(ifd, 278, h) or h, h)
        offsets, counts = ifd.get(273), ifd.get(279)
        if offsets is None:
            raise ValueError(f"{name}: broken TIFF file (no strips)")
    if tiled and fill == 2 and comp == 1:
        # libtiff's reading of them fails on small tiles (an RGBA tile of
        # fewer than 1024 pixels) and not on large ones
        raise out_of_scope("uncompressed tiles under FillOrder 2")
    planes = spp if planar == 2 and spp > 1 else 1
    across, down = -(-w // tw), -(-h // th)
    if len(offsets) < across * down * planes or (
            counts is not None and len(counts) < len(offsets)):
        raise ValueError(f"{name}: broken TIFF file ({len(offsets)} of "
                         f"{across * down * planes} strips or tiles)")
    if counts is None and comp != 1:
        raise ValueError(f"{name}: broken TIFF file (no byte counts)")
    units = sub if photo == 6 and comp != 7 else None
    t = SimpleNamespace(
        w=w, h=h, comp=comp, photo=photo, spp=spp, bits=bits, sf=sf,
        pred=pred, fill=fill, extra=tuple(extra), planes=planes, tiled=tiled,
        tw=tw, th=th, across=across, down=down, offsets=offsets,
        counts=counts, cmap=cmap, orient=orient, bo=ifd.bo, big=ifd.big,
        units=units, sub=sub, tables=ifd.tables,
        luma=ifd.rationals.get(529, LUMA)[:3],
        ref_bw=ifd.rationals.get(532, REF_BW)[:6])
    if photo == 6 and (len(t.luma) < 3 or len(t.ref_bw) < 6):
        raise ValueError(f"{name}: broken TIFF file (YCbCr coefficients)")
    # no codec makes more than RATIO[comp] bytes of a byte of its data: a
    # file that claims more pixels than that is refused before they are
    # allocated
    rows = down * th if tiled else h
    if comp == 7:
        need = rows * across * tw * spp
    elif units:
        hs, vs = units
        need = -(-rows // vs) * across * -(-tw // hs) * (hs * vs + 2)
    else:
        need = rows * across * planes * -(-tw * (spp // planes) * bits // 8)
    if need > RATIO[comp] * len(data):
        raise ValueError(f"{name}: broken TIFF file ({w} x {h} pixels, more "
                         f"than its {len(data)} bytes can hold)")
    return t


# ------------------------------------------------------------- codecs

# Each codec returns (the `need` bytes, None), or stops at the first fault
# and returns (the bytes that came before it, zeros after, its cause), as
# libtiff's decoders leave a strip.

def _pad(out: bytes, need: int) -> bytes:
    return bytes(out[:need]) + bytes(max(0, need - len(out)))


def _lzw(src: bytes, need: int, name: str) -> tuple[bytes, str | None]:
    """TIFF LZW (MSB-first codes of 9-12 bits, the width one code early,
    as libtiff's LZWDecode)."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        raise NotImplementedError(f"{name}: a TIFF image with old-style LZW "
                                  "codes (LSB-first)")
    base = [bytes([i]) for i in range(256)] + [b"", b""]
    table = list(base)
    out = bytearray()
    nbits, buf, nb, pos, n = 9, 0, 0, 0, len(src)
    prev = None
    while len(out) < need:
        while nb < nbits and pos < n:
            buf = (buf << 8) | src[pos]
            pos += 1
            nb += 8
        if nb < nbits:
            break                       # the data ends: taken as EOI
        nb -= nbits
        code = buf >> nb
        buf &= (1 << nb) - 1
        if code == 256:
            table, nbits, prev = list(base), 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                return _pad(out, need), (f"broken LZW data (code {code} "
                                         "after a clear code)")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
                new = table[prev] + entry[:1]
            elif code == len(table):
                new = entry = table[prev] + table[prev][:1]
            else:
                return _pad(out, need), (f"broken LZW data (code {code} "
                                         "not yet in the table)")
            if len(table) < 4096:
                table.append(new)
        out += entry
        prev = code
        if len(table) + 1 >= 1 << nbits and nbits < 12:
            nbits += 1
    if len(out) < need:
        return _pad(out, need), (f"truncated TIFF file (LZW data ends after "
                                 f"{len(out)} of {need} bytes)")
    return bytes(out[:need]), None


def _packbits(src: bytes, need: int, name: str) -> tuple[bytes, str | None]:
    """libtiff's PackBitsDecode: a literal run the data cuts short is
    dropped."""
    out = bytearray()
    i, n = 0, len(src)
    while len(out) < need and i < n:
        c = src[i]
        i += 1
        if c < 128:
            take = min(c + 1, need - len(out))
            if n - i < take:
                break
            out += src[i:i + take]
            i += c + 1
        elif c > 128 and i < n:
            out += src[i:i + 1] * min(257 - c, need - len(out))
            i += 1
    if len(out) < need:
        return _pad(out, need), (f"truncated TIFF file (PackBits data ends "
                                 f"after {len(out)} of {need} bytes)")
    return bytes(out), None


def _inflate(src: bytes, need: int, name: str) -> tuple[bytes, str | None]:
    """libtiff's ZIPDecode: zlib's inflate into `need` bytes, which stops
    there (the rest of the stream, its Adler-32 too, unread) but reads the
    symbols and block headers up to the next byte it would write."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(src, need)
    except zlib.error as e:
        # zlib returns nothing of a call that fails: the bytes before the
        # fault come from the plain inflate below
        return _pad(_inflate_to_fault(src, need), need), (
            f"broken deflate data ({e})")
    if len(out) < need:
        return _pad(out, need), (f"broken deflate data (the stream ends "
                                 f"after {len(out)} of {need} bytes)")
    return out, None


class _Fault(Exception):
    """The plain inflate stops: a fault, the data's end or `need` bytes."""


# RFC 1951's length and distance symbols: (base, extra bits)
_LENS = [(3 + i, 0) for i in range(8)] + [
    (b, e) for e in range(1, 6) for b in
    range(3 + (4 << e), 3 + (8 << e), 1 << e)] + [(258, 0)]
_DISTS = [(1, 0), (2, 0), (3, 0), (4, 0)] + [
    (1 + (2 << e) + k * (1 << e), e) for e in range(1, 14) for k in (0, 1)]


def _inflate_to_fault(src: bytes, need: int) -> bytes:
    """The bytes zlib writes of the stream before the fault it raises at (at
    most `need`): RFC 1951 read symbol by symbol, with zlib's checks."""
    out = bytearray()
    state = {"pos": 0, "buf": 0, "nb": 0}

    def bits(k):
        while state["nb"] < k:
            if state["pos"] >= len(src):
                raise _Fault
            state["buf"] |= src[state["pos"]] << state["nb"]
            state["pos"] += 1
            state["nb"] += 8
        v = state["buf"] & ((1 << k) - 1)
        state["buf"] >>= k
        state["nb"] -= k
        return v

    def code(lens, lone_ok):
        """Canonical code {(length, code): symbol}; zlib refuses an
        over-subscribed set and an incomplete one unless it is one 1-bit
        code."""
        count = [0] * 16
        for n in lens:
            count[n] += 1
        count[0], left, top = 0, 1, 0
        for n in range(1, 16):
            left = (left << 1) - count[n]
            if left < 0:
                raise _Fault
            top = n if count[n] else top
        if left > 0 and not (lone_ok and top <= 1):
            raise _Fault
        nxt, c = {}, 0
        for n in range(1, 16):
            nxt[n] = c
            c = (c + count[n]) << 1
        table = {}
        for sym, n in enumerate(lens):
            if n:
                table[n, nxt[n]] = sym
                nxt[n] += 1
        return table

    def decode(table):
        c = 0
        for n in range(1, 16):
            c = (c << 1) | bits(1)
            if (n, c) in table:
                return table[n, c]
        raise _Fault

    def put(b):
        if len(out) >= need:
            raise _Fault
        out.append(b)

    fixed = (code([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, False),
             code([5] * 32, False))
    try:
        cmf, flg = bits(8), bits(8)
        if cmf & 15 != 8 or cmf >> 4 > 7 or (cmf * 256 + flg) % 31 or \
                flg & 32:
            return bytes(out)
        last = False
        while not last:
            last, kind = bits(1), bits(2)
            if kind == 0:
                state["buf"] >>= state["nb"] & 7
                state["nb"] -= state["nb"] & 7
                n, inv = bits(16), bits(16)
                if n ^ 0xFFFF != inv:
                    return bytes(out)
                for _ in range(n):
                    put(bits(8))
                continue
            if kind == 3:
                return bytes(out)
            if kind == 1:
                lit, dist = fixed
            else:
                nlit, ndist, ncode = bits(5) + 257, bits(5) + 1, bits(4) + 4
                if nlit > 286 or ndist > 30:
                    return bytes(out)
                cl = [0] * 19
                for i in range(ncode):
                    cl[(16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13,
                        2, 14, 1, 15)[i]] = bits(3)
                ctab = code(cl, False)
                lens = []
                while len(lens) < nlit + ndist:
                    sym = decode(ctab)
                    if sym < 16:
                        lens.append(sym)
                        continue
                    if sym == 16 and not lens:
                        return bytes(out)
                    val = lens[-1] if sym == 16 else 0
                    rep = (3 + bits(2) if sym == 16 else 3 + bits(3)
                           if sym == 17 else 11 + bits(7))
                    if len(lens) + rep > nlit + ndist:
                        return bytes(out)
                    lens += [val] * rep
                if not lens[256]:
                    return bytes(out)
                lit, dist = code(lens[:nlit], True), code(lens[nlit:], True)
            while True:
                sym = decode(lit)
                if sym < 256:
                    put(sym)
                    continue
                if sym == 256:
                    break
                if sym - 257 >= 29:
                    return bytes(out)
                base, extra = _LENS[sym - 257]
                length = base + bits(extra)
                d = decode(dist)
                if d >= 30:
                    return bytes(out)
                back = _DISTS[d][0] + bits(_DISTS[d][1])
                if len(out) >= need or back > len(out):
                    return bytes(out)
                for _ in range(length):
                    put(out[-back])
    except _Fault:
        pass
    return bytes(out)


# ------------------------------------------------------------- samples

_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _chunk(data: bytes, t: SimpleNamespace, i: int, need: int,
           name: str) -> tuple[bytes, str | None]:
    """Strip or tile i, decompressed to `need` bytes, and the cause of its
    codec's fault or None (the codecs above); a strip past the end of the
    file raises. FillOrder 2 reverses the bits of each byte of the data
    first, as libtiff does before it decodes."""
    off = t.offsets[i]
    cnt = t.counts[i] if t.counts is not None else need
    if t.comp == 1:
        # libtiff takes a single strip's byte count for bogus and reads
        # the strip's rows from its offset; any other strip must fit
        one_strip = not t.tiled and len(t.offsets) == 1
        if (off + cnt > len(data) and not one_strip) or off + need > len(
                data):
            raise ValueError(f"{name}: truncated TIFF file (strip or tile "
                             f"{i} past the end of the file)")
        src = data[off:off + need]
        return (src.translate(_REVERSED) if t.fill == 2 else src), None
    if off + cnt > len(data):
        raise ValueError(f"{name}: truncated TIFF file (strip or tile {i} "
                         "past the end of the file)")
    if t.comp in NO_DECODER:
        return bytes(need), NO_DECODER[t.comp]
    src = data[off:off + cnt]
    if t.fill == 2:
        src = src.translate(_REVERSED)
    if t.comp == 5:
        return _lzw(src, need, name)
    if t.comp == 32773:
        return _packbits(src, need, name)
    return _inflate(src, need, name)


def _dtype(t: SimpleNamespace):
    return DTYPES.get((t.sf, t.bits), np.uint8)


def _unpack(raw: bytes, rows: int, cols: int, k: int, t: SimpleNamespace,
            predict: bool = True):
    """A decompressed chunk of `rows` x `cols` pixels of k samples ->
    (rows, cols, k) of the samples' dtype (uint8 for 1-8 bits), the
    predictor undone with `predict`: 2 sums each sample with the one k to
    its left (wrapping, on the unsigned word); 3 sums each byte of the
    row with the one k to its left, then reads the row's bytes as planes,
    most significant byte first."""
    dt = _dtype(t)
    if t.bits >= 8 and t.pred == 3 and predict:
        b = t.bits // 8
        v = np.frombuffer(raw, np.uint8).reshape(rows, cols * b, k)
        v = np.cumsum(v, axis=1, dtype=np.uint8)
        v = v.reshape(rows, b, cols * k).transpose(0, 2, 1)
        return np.ascontiguousarray(v).view(f">{np.dtype(dt).str[1:]}"
                                            ).reshape(rows, cols, k).astype(dt)
    if t.bits >= 8:
        a = np.frombuffer(raw, np.dtype(dt).newbyteorder(t.bo)).astype(
            dt).reshape(rows, cols, k)
    else:
        stride = -(-cols * k * t.bits // 8)
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(
            rows, stride), axis=1)[:, :cols * k * t.bits]
        weights = (1 << np.arange(t.bits - 1, -1, -1)).astype(np.uint8)
        a = (bits.reshape(rows, cols * k, t.bits) * weights).sum(
            -1, dtype=np.uint8).reshape(rows, cols, k)
    if t.pred == 2 and predict:
        u = a.view(f"u{a.dtype.itemsize}")
        a = np.cumsum(u, axis=1, dtype=u.dtype).view(a.dtype)
    return a


def _units(raw: bytes, rows: int, cols: int, t: SimpleNamespace):
    """A chunk of YCbCr data units -> (rows, cols) Y, Cb, Cr planes, each
    unit's Cb and Cr on all of its hs x vs pixels."""
    hs, vs = t.units
    ur, uc = -(-rows // vs), -(-cols // hs)
    u = np.frombuffer(raw, np.uint8).reshape(ur, uc, hs * vs + 2)
    y = u[..., :hs * vs].reshape(ur, uc, vs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(ur * vs, uc * hs)
    rep = lambda c: np.repeat(np.repeat(c, vs, 0), hs, 1)
    return np.stack([y, rep(u[..., -2]), rep(u[..., -1])], -1)[:rows, :cols]


def _jpeg(data: bytes, t: SimpleNamespace, i: int, rows: int, cols: int,
          name: str) -> np.ndarray:
    """Strip or tile i of a JPEG-compressed TIFF: its stream after the
    JPEGTables (`jpeg.decode_segment`), YCbCr converted to RGB where the
    photometric is YCbCr and left as stored where it is RGB, as libtiff
    sets libjpeg's colour spaces. The frame must be the chunk's width and
    at least its rows (libtiff warns of fewer and then fails), at most
    its nominal rows (libtiff refuses more, except in a last strip, where
    the port refuses more than RowsPerStrip before allocating), its first
    component sampled as YCbCrSubsampling says (1 x 1 unless YCbCr) and
    the others 1 x 1, as libtiff requires."""
    off = t.offsets[i]
    cnt = t.counts[i]
    if off + cnt > len(data):
        raise ValueError(f"{name}: truncated TIFF file (strip or tile {i} "
                         "past the end of the file)")
    px, samp = decode_segment(t.tables, data[off:off + cnt], t.photo == 6,
                              (cols, rows, t.th), name)
    if len(samp) != t.spp:
        raise ValueError(f"{name}: broken TIFF file (a JPEG strip or tile "
                         f"of {len(samp)} components for {t.spp} samples)")
    want = [t.sub if t.photo == 6 else (1, 1)] + [(1, 1)] * (t.spp - 1)
    if samp != want:
        raise ValueError(f"{name}: broken TIFF file (JPEG sampling factors "
                         f"{samp}, where libtiff takes {want})")
    return px[:rows]


def _samples(data: bytes, t: SimpleNamespace, name: str,
             fill: bool = False) -> np.ndarray:
    """Every strip or tile placed: (h, w, spp) samples (uint8 at 1-8 bits,
    the dtype of SampleFormat and bits else); YCbCr data units as (h, w,
    3) Y, Cb, Cr; JPEG chunks decoded (gray, RGB or YCbCr -> RGB). A
    codec's fault raises ValueError, or with `fill` leaves the strip as
    libtiff's RGBA reader does: the bytes that came before it, zeros after,
    the predictor not undone."""
    out = np.zeros((t.h, t.w, t.spp), _dtype(t))
    k = t.spp // t.planes
    i = 0
    for p in range(t.planes):
        for ty in range(t.down):
            for tx in range(t.across):
                y0, x0 = ty * t.th, tx * t.tw
                rows = t.th if t.tiled else min(t.th, t.h - y0)
                if t.comp == 7:
                    a = _jpeg(data, t, i, rows, t.tw, name)
                else:
                    if t.units:
                        hs, vs = t.units
                        need = (-(-rows // vs) * -(-t.tw // hs)
                                * (hs * vs + 2))
                    else:
                        need = rows * -(-t.tw * k * t.bits // 8)
                    raw, fault = _chunk(data, t, i, need, name)
                    if fault and not fill:
                        raise ValueError(f"{name}: {fault}")
                    a = (_units(raw, rows, t.tw, t) if t.units else
                         _unpack(raw, rows, t.tw, k, t, predict=not fault))
                y1, x1 = min(y0 + rows, t.h), min(x0 + t.tw, t.w)
                out[y0:y1, x0:x1, p * k:(p + 1) * k] = a[:y1 - y0, :x1 - x0]
                i += 1
    return out


def _orient(img: np.ndarray, o: int) -> np.ndarray:
    """Turn (h, w, c) by the Orientation tag, as OpenCV does."""
    turned = {2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1],
              5: img.transpose(1, 0, 2),
              6: img[::-1].transpose(1, 0, 2),
              7: img[::-1, ::-1].transpose(1, 0, 2),
              8: img[:, ::-1].transpose(1, 0, 2)}.get(o, img)
    return np.ascontiguousarray(turned)


def _rgba_reader(t: SimpleNamespace) -> bool:
    """OpenCV reads these through libtiff's RGBA reader, which fills a
    broken strip; the others through TIFFReadEncodedStrip, which fails."""
    return t.sf == 1 and t.bits <= 8 and t.comp != 7


def _load(path, fill=None) -> tuple[SimpleNamespace, np.ndarray]:
    """The image's description and samples; `fill` (a function of the
    description) says whether a codec's fault fills the strip."""
    data = Path(path).read_bytes()
    t = _info(data, str(path))
    return t, _samples(data, t, str(path), bool(fill and fill(t)))


def _cv2_branch(t: SimpleNamespace) -> bool:
    """The kinds `read_tiff` reads as cv2 5.0 does (module doc)."""
    return ((t.bits == 8 and t.photo != 3
             and not (t.photo == 5 and t.spp == 5))
            or t.sf != 1 or t.bits >= 32)


def _pil_bomb(w: int, h: int, name: str) -> None:
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: decompression bomb ({w} x {h} pixels; "
                         f"PIL opens at most {PIL_MAX_PIXELS})")


def _pil_mode(t: SimpleNamespace, name: str) -> str:
    """PIL's mode for the image, or ValueError where PIL does not open it
    (and so the JAX package, without cv2, reads nothing)."""
    key = (t.bo, t.photo, (t.sf,), t.fill, (t.bits,) * t.spp, t.extra)
    if t.big and t.bo == ">":
        raise ValueError(f"{name}: PIL opens no big-endian BigTIFF")
    _pil_bomb(t.w, t.h, name)
    if key not in PIL_KEYS:
        raise ValueError(f"{name}: PIL reads no such TIFF (photometric "
                         f"{t.photo}, {t.spp} x {t.bits} bits, SampleFormat "
                         f"{t.sf}, FillOrder {t.fill})")
    if t.orient in (5, 6, 7, 8):
        raise NotImplementedError(
            f"{name}: a TIFF image with orientation {t.orient} read through "
            "PIL, which reads its samples with the sides swapped")
    return PIL_KEYS[key]


def _gray(s: np.ndarray, t: SimpleNamespace) -> np.ndarray:
    """1-8 bit gray samples -> 8-bit levels (MinIsWhite inverted)."""
    top = (1 << t.bits) - 1
    v = s if t.photo == 1 else top - s
    return (v * (255 // top)).astype(np.uint8)


def _premultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libtiff's unassociated alpha in TIFFReadRGBA*: (c a + 127) // 255."""
    return ((rgb.astype(np.int32) * a + 127) // 255).astype(np.uint8)


def _unpremultiply(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """PIL's RGBa unpackers: min(255, c * 255 // a), 0 where a is 0."""
    a = a.astype(np.int32)
    v = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
    return np.where(a == 255, rgb, np.where(a == 0, 0, v)).astype(np.uint8)


def _cmyk_rgb(s: np.ndarray) -> np.ndarray:
    """libtiff's RGBA reader on 8-bit CMYK: (255 - K)(255 - C) // 255 for
    R, and so for G and B."""
    s = s.astype(np.int32)
    k = 255 - s[..., 3:4]
    return (k * (255 - s[..., :3]) // 255).astype(np.uint8)


def _cmyk_pil(s: np.ndarray) -> np.ndarray:
    """PIL's `convert("RGB")` of CMYK: nk - c nk / 255 (its MULDIV255
    rounding), nk = 255 - K."""
    s = s.astype(np.int32)
    nk = 255 - s[..., 3:4]
    t = s[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _code2v(c, rb: float, rw: float, cr: int) -> np.ndarray:
    """libtiff's Code2V: (c - (int) RB) * (float) CR / (float) (RW - RB),
    clamped to +-4096 and truncated, in float32."""
    f32 = np.float32
    den = f32(rw) - f32(rb)
    den = den if den != 0 else f32(1)
    v = (np.asarray(c - np.trunc(f32(rb)), f32) * f32(cr)) / den
    return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)


def _ycbcr_rgb(ycc: np.ndarray, luma, ref_bw) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGB (tables of 16-bit fixed point from the
    float32 coefficients and ReferenceBlackWhite) on (..., 3) Y Cb Cr
    bytes."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    fix = lambda x: int(float(x) * 65536.0 + 0.5)
    f1 = f32(2) - f32(2) * lr
    f3 = f32(2) - f32(2) * lb
    d1, d3 = fix(np.clip(f1, 0, 2)), fix(np.clip(f3, 0, 2))
    d2, d4 = -fix(np.clip(lr * f1 / lg, 0, 2)), -fix(np.clip(lb * f3 / lg,
                                                             0, 2))
    x = np.arange(256) - 128
    rb = [f32(v) for v in ref_bw]
    cr = _code2v(x, rb[4] - f32(128), rb[5] - f32(128), 127)
    cb = _code2v(x, rb[2] - f32(128), rb[3] - f32(128), 127)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y_tab = _code2v(x + 128, rb[0], rb[1], 255)
    yy = y_tab[ycc[..., 0]]
    cbv, crv = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([yy + cr_r[crv], yy + ((cb_g[cbv] + cr_g[crv]) >> 16),
                    yy + cb_b[cbv]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _colour(s: np.ndarray, t: SimpleNamespace) -> np.ndarray:
    """YCbCr data units or CMYK samples as the RGBA reader leaves them
    (JPEG chunks come out of the decoder in RGB already)."""
    if t.units:
        return _ycbcr_rgb(s, t.luma, t.ref_bw)
    return s


def read_tiff(path: str | Path) -> np.ndarray:
    """Decode a TIFF to the layout of the JAX package's `_read_image`
    (module doc)."""
    t, s = _load(path, fill=lambda t: _cv2_branch(t) and _rgba_reader(t))
    name = str(path)
    if _cv2_branch(t):
        if t.photo == 5:                          # A = 255, R G B
            img = np.concatenate([np.full_like(s[..., :1], 255),
                                  _cmyk_rgb(s)], -1)
        elif t.photo == 6:
            img = _colour(s, t)
        elif t.photo < 2:
            img = s[..., :1] if t.sf != 1 or t.bits >= 32 else _gray(
                s[..., :1], t)
        elif t.spp == 3:
            img = s
        else:
            rgb = s[..., :3]
            if t.extra == (2,) and t.bits == 8 and t.sf == 1:
                rgb = _premultiply(rgb, s[..., 3:])
            img = np.concatenate([s[..., 3:], rgb], -1)
        return _orient(img, t.orient)
    _pil_mode(t, name)                                     # PIL's branch
    if t.photo == 3 or t.bits == 16 and t.photo < 2:
        img = s
    elif t.photo < 2:
        img = _gray(s, t)
        if t.bits == 1:
            img = img != 0
    elif t.photo == 5:                            # CMYK: the ink as stored
        img = s[..., :3]
    else:
        img = (s >> 8).astype(np.uint8)
        if t.extra == (1,):
            img = np.concatenate([_unpremultiply(img[..., :3],
                                                 img[..., 3:]),
                                  img[..., 3:]], -1)
        img = img[..., :3]
    return _orient(img, t.orient)


def read_tiff_rgb(path: str | Path) -> np.ndarray:
    """Decode a TIFF to (H, W, 3) uint8 RGB as PIL's `convert("RGB")`
    does (module doc)."""
    t, s = _load(path)
    mode = _pil_mode(t, str(path))
    if t.photo == 3:
        img = (t.cmap // 256).astype(np.uint8)[s[..., 0]]
    elif mode == "F":
        v = s[..., :1]
        with np.errstate(invalid="ignore"):
            g = np.where(np.isnan(v), 0, np.clip(np.trunc(v), 0, 255))
        img = np.repeat(g.astype(np.uint8), 3, -1)
    elif mode == "I" or t.sf == 2:
        # PIL reads 32-bit unsigned as int32 and signed 8-bit as its bytes
        v = s[..., :1].astype({4: np.int32, 1: np.uint8}.get(
            s.dtype.itemsize, s.dtype))
        img = np.repeat(np.clip(v, 0, 255).astype(np.uint8), 3, -1)
    elif t.photo < 2:
        g = (np.minimum(s[..., :1], 255).astype(np.uint8) if t.bits == 16
             else _gray(s[..., :1], t))
        img = np.repeat(g, 3, -1)
    elif t.photo == 5:
        img = _cmyk_pil(s)
    elif t.photo == 6:
        if t.comp == 1:
            raise ValueError(f"{path}: PIL reads uncompressed YCbCr as RGBX "
                             "bytes and runs out of them")
        img = _colour(s, t)
    else:
        img = s if t.bits == 8 else (s >> 8).astype(np.uint8)
        if t.extra == (1,):
            img = _unpremultiply(img[..., :3], img[..., 3:])
        img = img[..., :3]
    return _orient(img, t.orient)


def _pil_open(data: bytes, name: str) -> tuple[int, int]:
    """PIL's `TiffImageFile._open` and `_setup` on the bytes: raises where
    they raise, returns PIL's (width, height)."""
    ifd = _walk_ifd(data, name, pil=True)
    tags = ifd.tags
    if 0xBC01 in tags:
        raise ValueError(f"{name}: a Windows Media Photo file")
    comp = _one(ifd, 259, 1)
    if comp not in PIL_COMPRESSIONS:
        raise ValueError(f"{name}: unknown TIFF compression {comp}")
    w, h = _one(ifd, 256), _one(ifd, 257)
    if w is None or h is None:
        raise ValueError(f"{name}: missing dimensions")
    photo = 6 if comp == 6 else _one(ifd, 262, 0)
    sf = ifd.get(339, (1,))
    if len(sf) > 1 and max(sf) == min(sf) == 1:
        sf = (1,)
    bps = ifd.get(258, (1,))
    extra = ifd.get(338, ())
    spp = _one(ifd, 277, 3 if comp == 6 and photo in (2, 6) else 1)
    if spp > 6:
        raise ValueError(f"{name}: invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: unknown data organization")
    key = (ifd.bo, photo, tuple(sf), _one(ifd, 266, 1), tuple(bps),
           tuple(extra))
    if key not in PIL_KEYS:
        raise ValueError(f"{name}: unknown pixel mode {key}")
    if comp == 1:
        if 273 not in tags and 324 not in tags:
            raise ValueError(f"{name}: unknown data organization")
        if 273 not in tags and (322 not in tags or 323 not in tags):
            raise ValueError(f"{name}: invalid tile dimensions")
    _pil_bomb(w, h, name)
    if _one(ifd, 274) in (5, 6, 7, 8):
        w, h = h, w
    return int(w), int(h)


def tiff_size(path: str | Path) -> tuple[int, int]:
    """(width, height) as PIL's `Image.open(f).size` (module doc)."""
    return _pil_open(Path(path).read_bytes(), str(path))


def verify_tiff(path: str | Path) -> None:
    """Raise ValueError where the JAX scan (PIL's `Image.open` and
    `verify`, which reads no pixels, and the 10 px assert) marks the file
    corrupt."""
    w, h = tiff_size(path)
    if w < MIN_SIDE or h < MIN_SIDE:
        raise ValueError("image size <10 pixels")


# ------------------------------------------------------------- writer

def _packbits_encode(row: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:                                          # a run
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        j = i + 1                                          # literals
        while j < n and j - i < 128 and not (
                j + 1 < n and row[j] == row[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def _jpeg_chunks(blocks) -> tuple[bytes, list]:
    """The port's JPEG (`jpeg.encode_jpeg`: PIL's defaults, RGB as YCbCr
    4:2:0) of each block as an abbreviated stream, and the quantization and
    Huffman tables they share as a tables-only stream (JPEGTables)."""
    from .jpeg import encode_jpeg
    tables, chunks = None, []
    for blk in blocks:
        s, pos, keep, tab = encode_jpeg(blk), 2, [], []
        while s[pos + 1] != 0xDA:
            n = struct.unpack(">H", s[pos + 2:pos + 4])[0]
            (tab if s[pos + 1] in (0xDB, 0xC4) else keep if s[pos + 1]
             != 0xE0 else []).append(s[pos:pos + 2 + n])
            pos += 2 + n
        t = b"\xff\xd8" + b"".join(tab) + b"\xff\xd9"
        if tables not in (None, t):
            raise AssertionError("the blocks' JPEG tables differ")
        tables = t
        chunks.append(b"\xff\xd8" + b"".join(keep) + s[pos:])
    return tables, chunks


def write_tiff(path: str | Path, arr: np.ndarray, compression="none",
               predictor=1, tile=None) -> None:
    """Write `arr` ((H, W) gray or (H, W, 3) RGB, uint8 or uint16; (H, W)
    float32) as a little-endian TIFF with one IFD: one strip, or tiles of
    `tile` (height, width), multiples of 16. `compression` is "none",
    "deflate", "packbits" or "jpeg" (uint8: RGB as YCbCr 4:2:0 with
    YCbCrSubsampling 2 x 2, the tables in JPEGTables; tiles padded with
    their edge pixels); `predictor` 2 (integer) and 3 (float) take
    deflate."""
    s = np.asarray(arr)
    if s.ndim == 2:
        s = s[..., None]
    h, w, spp = s.shape
    if (s.dtype not in (np.uint8, np.uint16, np.float32) or spp not in (1, 3)
            or (s.dtype == np.float32 and spp != 1)):
        raise ValueError(f"write_tiff takes uint8 or uint16 gray or RGB and "
                         f"float32 gray, not {s.dtype} {s.shape}")
    bits = 8 * s.dtype.itemsize
    comp = {"none": 1, "deflate": 8, "packbits": 32773,
            "jpeg": 7}[compression]
    if predictor in (2, 3) and comp != 8:
        raise ValueError("predictors 2 and 3 take deflate (readers ignore "
                         "them without LZW or deflate)")
    if predictor == 3 and s.dtype != np.float32 or (
            predictor == 2 and s.dtype == np.float32):
        raise ValueError("predictor 3 takes float32 samples, 2 integers")
    if comp == 7 and s.dtype != np.uint8:
        raise ValueError("JPEG takes uint8 samples")

    def encode(block: np.ndarray) -> bytes:
        if predictor == 2:                  # differences wrap, unsigned
            d = block.copy()
            d[:, 1:] = block[:, 1:] - block[:, :-1]
            block = d
        if predictor == 3:                  # byte planes, then differences
            r, c, _ = block.shape
            v = block.astype(">f4").view(np.uint8).reshape(r, c, 4)
            v = v.transpose(0, 2, 1).reshape(r, 4 * c).astype(np.int64)
            v[:, 1:] = v[:, 1:] - v[:, :-1]
            raw = (v & 255).astype(np.uint8).tobytes()
        else:
            raw = block.astype(block.dtype.newbyteorder("<")).tobytes()
        if comp == 8:
            return zlib.compress(raw)
        if comp == 32773:
            rs = len(raw) // len(block)
            return b"".join(_packbits_encode(raw[i:i + rs])
                            for i in range(0, len(raw), rs))
        return raw

    th, tw = tile or (h, w)
    blocks = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            part = s[y:y + th, x:x + tw]
            blocks.append(np.pad(part, ((0, th - part.shape[0]),
                                        (0, tw - part.shape[1]), (0, 0)),
                                 mode="edge" if comp == 7 else "constant"))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [comp]), 262: (3, [1 if spp == 1 else 2]),
            277: (3, [spp]), 284: (3, [1])}
    if comp == 7:
        tables, chunks = _jpeg_chunks(
            [b[..., 0] if spp == 1 else b for b in blocks])
        tags[347] = (7, tables)
        if spp == 3:
            tags[262], tags[530] = (3, [6]), (3, [2, 2])
    else:
        chunks = [encode(b) for b in blocks]
    if s.dtype == np.float32:
        tags[339] = (3, [3])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags[322], tags[323] = (4, [tw]), (4, [th])
    else:
        tags[278] = (4, [h])
    body = bytearray(8)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\0" * (len(c) % 2)
    tags[324 if tile else 273] = (4, offsets)
    tags[325 if tile else 279] = (4, [len(c) for c in chunks])
    ifd_at = len(body)
    spill_at = ifd_at + 2 + len(tags) * 12 + 4
    entries, spill = b"", bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        payload = (bytes(vals) if typ == 7 else struct.pack(
            f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals))
        if len(payload) <= 4:
            value = payload + b"\0" * (4 - len(payload))
        else:
            value = struct.pack("<I", spill_at + len(spill))
            spill += payload + b"\0" * (len(payload) % 2)
        entries += struct.pack("<HHI", tag, typ, len(vals)) + value
    body += struct.pack("<H", len(tags)) + entries + b"\0" * 4 + spill
    body[:8] = b"II" + struct.pack("<HI", 42, ifd_at)
    Path(path).write_bytes(bytes(body))
