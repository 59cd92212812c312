"""BMP decode and encode in numpy: the plain version of the port's BMP
decoder (`csrc/bmp.cpp`), and the reader of the box crops' tool.

The card's machine has neither cv2 nor PIL, so the port carries its own
BMP code, as it does for PNG (`png.py`) and JPEG (`jpeg.py`). The JAX
package reads an image through `cv2.imread(IMREAD_UNCHANGED)` and then
`[..., ::-1]`, or through `np.asarray(PIL.Image.open(f))` where cv2 is
absent (`sodt_tpu/data/vedai.py` `_read_image`). `read_bmp` takes one of
the two for each kind, by the rule `png.py` states for PNG: 8-bit gray,
RGB and RGBA as cv2 gives them, palette, 1-, 4- and 16-bit images as PIL
gives them, and cv2's for a kind the rule does not settle.

  kind (header)                   read_bmp                   branch
  1-, 4-, 8-bit palette, RLE4,    (H, W, 1) uint8 palette    PIL
    RLE8 (CORE, INFO, V4, V5)       indices; 1 bit with a
                                    black / white palette:
                                    (H, W, 1) bool (mode "1")
  16-bit 5-5-5 (BI_RGB), 5-6-5    (H, W, 3) RGB, each         PIL
    or 5-5-5 (BITFIELDS)            sample v * 255 // 31
                                    (green of 5-6-5: // 63)
  24-bit (INFO, V4, V5)           (H, W, 3) RGB              cv2
  24-bit (CORE, 12 bytes)         (H, W, 1) gray: cv2 reads  cv2
                                    a CORE file as gray,
                                    (1868 B + 9617 G + 4899 R
                                    + 8192) >> 14
  32-bit BI_RGB                   (H, W, 3) RGB, the fourth  cv2
                                    byte dropped
  32-bit BITFIELDS, INFO or V2    (H, W, 4) the four bytes   cv2
    header (40 or 52 bytes), or     of each pixel reversed:
    a zero R, G or B mask           cv2 ignores the masks
  32-bit BITFIELDS, V3-V5 header  (H, W, 4) A R G B, each    cv2
                                    field f of the masks
                                    widened f * 255 // max;
                                    A 255 where its mask is 0

  read_bmp_rgb(path)  (H, W, 3) uint8 RGB as PIL's `convert("RGB")` gives
                      it: palette colours (black past the palette), 16-bit
                      samples widened as above, 32-bit bytes placed by the
                      masks PIL knows, alpha dropped.
  bmp_size(path)      (width, height) as PIL's `Image.size`.
  verify_bmp(path)    raises where PIL's `Image.open` plus the JAX scan's
                      10 px assert fail (PIL's `verify` reads no pixels).
  write_bmp(path, arr)
                      (H, W, 3) RGB as 24 bits, (H, W) gray as 8 bits with
                      a gray palette, bottom-up, a 40-byte header: the
                      files cv2 writes.

Rows run bottom-up, or top-down where the height is negative. RLE8 and
RLE4 are undone as OpenCV undoes them (`grfmt_bmp.cpp`): end-of-line,
end-of-bitmap and delta escapes move on through pixels a run never sets,
which keep palette index 0; a run or a literal that overshoots its row,
and a stream that ends before the bitmap does, raise, as cv2 returns no
image for them. A bitmap of more than 2^30 pixels raises before any is
allocated, as OpenCV refuses it, and one of more than 2 x 89478485 raises
wherever the port reads as PIL does (PIL's branch of `read_bmp`,
`read_bmp_rgb`, `bmp_size`), as PIL's open refuses it.

Departures, each where the libraries' own readers are at fault:
  * PIL reads a delta escape as four bytes and drops the last pixel of an
    odd RLE4 literal; PIL refuses an RLE bitmap that ends early (cv2 keeps
    index 0 there). The port follows OpenCV's reading, in indices.
  * PIL reads a 4- or 8-bit file whose palette it takes for gray (16
    entries (i, i, i), or 2 entries black and white) with the sample width
    of mode "L" or "1", so its pixels are garbled; the port returns the
    indices.
  * OpenCV 4.6, which the tile loader follows, cuts a 32-bit BITFIELDS
    field to its low byte where cv2 5.0, which `read_bmp` follows, widens
    it: the two agree on byte-wide masks.
  * OpenCV reads the BITFIELDS masks of a 16-bit file after the header,
    where a V3, V4 or V5 file keeps them inside it, and so fails on it; the
    tile loader (`csrc/bmp.cpp`) reads the masks where PIL and the format
    put them.
"""

from __future__ import annotations

import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SIGNATURE = b"BM"
MAX_PIXELS = 1 << 30             # OpenCV's CV_IO_MAX_IMAGE_PIXELS
PIL_MAX_PIXELS = 2 * 89478485    # PIL's decompression bomb, at open
HEADERS = (12, 40, 52, 56, 64, 108, 124)   # the header sizes PIL opens
MIN_SIDE = 10        # the JAX scan's "image size <10 pixels" assert
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
MASKS_16 = {(0x7C00, 0x3E0, 0x1F): 5, (0xF800, 0x7E0, 0x1F): 6}
# PIL's 32-bit BITFIELDS layouts (r, g, b, a masks) -> its raw mode
PIL_MASKS_32 = {
    (0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
    (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
    (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
    (0x0, 0x0, 0x0, 0x0): "BGRA",
}
_OUT_OF_SCOPE = {4: "embedded JPEG data (compression 4)",
                 5: "embedded PNG data (compression 5)"}


def _u32(b, i):
    return struct.unpack_from("<I", b, i)[0]


def _parse(data: bytes, name: str) -> SimpleNamespace:
    """The header of a BMP file as both readers take it; raises ValueError
    where neither reads it, NotImplementedError for BI_JPEG / BI_PNG."""
    if len(data) < 18 or data[:2] != SIGNATURE:
        raise ValueError(f"{name}: not a BMP file (signature)")
    offset = _u32(data, 10)
    size = _u32(data, 14)
    if size not in HEADERS:
        raise ValueError(f"{name}: broken BMP file (header size {size})")
    if len(data) < 14 + size:
        raise ValueError(f"{name}: truncated BMP file (header)")
    core = size == 12
    if core:
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp, clr_used, top_down = BI_RGB, 0, False
    else:
        w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
        clr_used = _u32(data, 46)
        top_down = h < 0
        h = abs(h)
    if comp in _OUT_OF_SCOPE:
        raise NotImplementedError(
            f"{name}: a BMP image with {_OUT_OF_SCOPE[comp]}; the port reads "
            "BI_RGB, RLE8, RLE4 and BITFIELDS bitmaps")
    ok = {BI_RGB: (1, 4, 8, 16, 24, 32), BI_RLE8: (8,), BI_RLE4: (4,),
          BI_BITFIELDS: (16, 24, 32)}.get(comp, ())
    if (w <= 0 or h <= 0 or w > 1 << 16 or h > 1 << 16 or bpp not in ok
            or (core and bpp not in (1, 4, 8, 24))):
        raise ValueError(f"{name}: broken BMP file ({w} x {h}, {bpp} bits, "
                         f"compression {comp})")
    # checked before a pixel is allocated: an RLE bitmap of any size fits in
    # a few bytes of escapes
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: image too large ({w} x {h} pixels; "
                         "OpenCV reads at most 2^30)")
    pos = 14 + size
    masks = None
    if comp == BI_BITFIELDS:
        # offset 54: after an INFO header, inside any longer one
        if len(data) < 54 + 12:
            raise ValueError(f"{name}: truncated BMP file (bitfields)")
        masks = struct.unpack_from("<III", data, 54)
        alpha = _u32(data, 14 + 52) if size >= 56 else 0
        masks = masks + (alpha,)
        if size == 40:
            pos += 12
    palette = np.zeros((256, 3), np.uint8)          # RGB, black past its end
    n_pal = 0
    if bpp <= 8:
        n_pal = clr_used or 1 << bpp
        if n_pal > 256:
            raise ValueError(f"{name}: broken BMP file ({n_pal} colours)")
        step = 3 if core else 4
        raw = np.frombuffer(data[pos:pos + n_pal * step], np.uint8)
        got = len(raw) // step
        palette[:got] = raw[:got * step].reshape(got, step)[:, 2::-1]
    return SimpleNamespace(w=w, h=h, bpp=bpp, comp=comp, core=core, size=size,
                   top_down=top_down, offset=offset, masks=masks,
                   palette=palette, n_pal=n_pal, clr_used=clr_used)


def _fill(out, x, y, count, w, h, value):
    """OpenCV's FillUniColor in index space: `count` pixels of `value`
    from (x, y) on, wrapping to the next row; returns the new (x, y)."""
    while True:
        end = min(x + count, w)
        count -= end - x
        out[y, x:end] = value
        x = end
        if x >= w:
            x, y = 0, y + 1
            if y >= h:
                break
        if count <= 0:
            break
    return x, y


def _rle(data: bytes, hd: SimpleNamespace, name: str) -> np.ndarray:
    """An RLE8 or RLE4 stream -> (h, w) palette indices, rows in file order,
    as OpenCV's BmpDecoder walks it (module doc)."""
    w, h, rle4 = hd.w, hd.h, hd.comp == BI_RLE4
    out = np.zeros((h, w), np.uint8)
    pos, n = hd.offset, len(data)
    x = y = 0
    line_end_flag = 0

    def take(k):
        nonlocal pos
        if pos + k > n:
            raise ValueError(f"{name}: truncated BMP file (RLE data ends "
                             "before the bitmap)")
        pos += k
        return data[pos - k:pos]

    while True:
        count, code = take(2)
        if count:                                         # a run
            if x + count > w:
                raise ValueError(f"{name}: broken BMP file (an RLE run "
                                 "past the end of its row)")
            if rle4:
                out[y, x:x + count] = np.resize(
                    np.array([code >> 4, code & 15], np.uint8), count)
                x += count
                continue
            prev = y
            x, y = _fill(out, x, y, count, w, h, code)
            line_end_flag = y - prev
            if y >= h:
                break
        elif code > 2:                                    # literal pixels
            if x + code > w:
                raise ValueError(f"{name}: broken BMP file (RLE literal "
                                 "pixels past the end of its row)")
            if rle4:
                src = np.frombuffer(take((((code + 1) >> 1) + 1) & ~1),
                                    np.uint8)
                nib = np.stack([src >> 4, src & 15], 1).reshape(-1)
                out[y, x:x + code] = nib[:code]
            else:
                out[y, x:x + code] = np.frombuffer(
                    take((code + 1) & ~1), np.uint8)[:code]
            x += code
            line_end_flag = 0
        else:                               # end of line / bitmap, delta
            dx, dy = w - x, h - y
            if rle4 or code or not line_end_flag or dx < w:
                if code == 2:
                    dx, dy = take(2)
                move = dx + (dy * w if code else 0)
                if y >= h:
                    break
                x, y = _fill(out, x, y, move, w, h, 0)
                if y >= h:
                    break
            line_end_flag = 0
            if y >= h:
                break
    return out


def _pixels(data: bytes, hd: SimpleNamespace, name: str) -> np.ndarray:
    """The bitmap, rows top-down: (h, w) indices for 1-8 bits, (h, w)
    uint16 for 16, (h, w, 3) B G R for 24, (h, w, 4) bytes for 32."""
    if hd.comp in (BI_RLE8, BI_RLE4):
        px = _rle(data, hd, name)
    else:
        stride = (hd.w * hd.bpp + 31) // 32 * 4
        end = hd.offset + stride * hd.h
        if end > len(data):
            raise ValueError(f"{name}: truncated BMP file (pixel data)")
        rows = np.frombuffer(data, np.uint8, stride * hd.h,
                             hd.offset).reshape(hd.h, stride)
        w = hd.w
        if hd.bpp < 8:
            bits = np.unpackbits(rows, axis=1)[:, :w * hd.bpp]
            bits = bits.reshape(hd.h, w, hd.bpp)
            weights = (1 << np.arange(hd.bpp - 1, -1, -1)).astype(np.uint8)
            px = (bits * weights).sum(-1, dtype=np.uint8)
        elif hd.bpp == 8:
            px = rows[:, :w]
        elif hd.bpp == 16:
            px = rows[:, :2 * w].copy().view("<u2").astype(np.uint16)
        else:
            k = hd.bpp // 8
            px = rows[:, :k * w].reshape(hd.h, w, k)
    return px if hd.top_down else px[::-1]


def _pil_bomb(w: int, h: int, name: str) -> None:
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: decompression bomb ({w} x {h} pixels; "
                         f"PIL opens at most {PIL_MAX_PIXELS})")


def _load(path, as_pil=lambda hd: False
          ) -> tuple[SimpleNamespace, np.ndarray]:
    """The header and the pixels; where `as_pil(header)` (the caller reads
    the kind as PIL does), first raise where PIL's open raises."""
    data = Path(path).read_bytes()
    hd = _parse(data, str(path))
    if hd.bpp == 16:
        if hd.comp == BI_RGB:
            hd.masks = (0x7C00, 0x3E0, 0x1F, 0)
        if hd.masks[:3] not in MASKS_16:
            raise ValueError(f"{path}: unsupported BMP bitfields layout")
    elif hd.bpp == 24 and hd.comp == BI_BITFIELDS:
        hd.masks = hd.masks[:3]
    if as_pil(hd):
        _pil_bomb(hd.w, hd.h, str(path))
    return hd, _pixels(data, hd, str(path))


def _widen16(px: np.ndarray, masks) -> np.ndarray:
    """5-5-5 / 5-6-5 samples -> (h, w, 3) RGB, as PIL's BGR;15 / BGR;16
    unpackers widen them (v * 255 // 31, green of 5-6-5 // 63)."""
    px = px.astype(np.int32)
    if MASKS_16[tuple(masks[:3])] == 5:
        r, g, b = (px >> 10) & 31, (px >> 5) & 31, px & 31
        gmax = 31
    else:
        r, g, b = (px >> 11) & 31, (px >> 5) & 63, px & 31
        gmax = 63
    return np.stack([r * 255 // 31, g * 255 // gmax, b * 255 // 31],
                    -1).astype(np.uint8)


def _pil_bilevel(hd: SimpleNamespace) -> bool:
    """PIL's mode "1": a 1-bit file of two colours, black then white."""
    return (hd.bpp == 1 and hd.n_pal == 2
            and not hd.palette[0].any() and (hd.palette[1] == 255).all())


def read_bmp(path: str | Path) -> np.ndarray:
    """Decode a BMP to the layout of the JAX package's `_read_image`
    (module doc)."""
    hd, px = _load(path, as_pil=lambda hd: hd.bpp <= 16)  # PIL's branch
    if hd.bpp <= 8:
        return (px[..., None] != 0 if _pil_bilevel(hd)
                else np.ascontiguousarray(px[..., None]))
    if hd.bpp == 16:
        return _widen16(px, hd.masks)
    if hd.bpp == 24:
        if hd.comp == BI_BITFIELDS:
            raise ValueError(f"{path}: broken BMP file (24-bit BITFIELDS, "
                             "which cv2 does not read)")
        if hd.core:                  # cv2 reads a CORE file as gray
            b, g, r = (px[..., i].astype(np.int32) for i in range(3))
            return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(
                np.uint8)[..., None]
        return np.ascontiguousarray(px[..., ::-1])
    if hd.comp != BI_BITFIELDS:
        return np.ascontiguousarray(px[..., 2::-1])
    if hd.size < 56 or not all(hd.masks[:3]):
        return np.ascontiguousarray(px[..., ::-1])
    v = px.copy().view("<u4")[..., 0].astype(np.int64)
    argb = (hd.masks[3], *hd.masks[:3])
    return np.stack([_field(v, m, scale=True) if m else np.full_like(v, 255)
                     for m in argb], -1).astype(np.uint8)


def _field(v: np.ndarray, mask: int, scale: bool) -> np.ndarray:
    """The bits of `mask` in the 32-bit pixels v, shifted down; widened to
    8 bits as cv2 5.0 widens them (f * 255 // max) where `scale`, else cut
    to their low byte as OpenCV 4.6 casts them."""
    shift = (mask & -mask).bit_length() - 1
    f = (v & mask) >> shift
    return f * 255 // (mask >> shift) if scale else f & 0xFF


def read_bmp_rgb(path: str | Path) -> np.ndarray:
    """Decode a BMP to (H, W, 3) uint8 RGB as PIL's `convert("RGB")`
    does (module doc)."""
    hd, px = _load(path, as_pil=lambda hd: True)
    if hd.bpp <= 8:
        return hd.palette[px]
    if hd.bpp == 16:
        return _widen16(px, hd.masks)
    if hd.bpp == 24:
        if hd.comp == BI_BITFIELDS and hd.masks != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"{path}: unsupported BMP bitfields layout")
        return np.ascontiguousarray(px[..., ::-1])
    mode = "BGRX"
    if hd.comp == BI_BITFIELDS:
        if hd.masks not in PIL_MASKS_32:
            raise ValueError(f"{path}: unsupported BMP bitfields layout")
        mode = PIL_MASKS_32[hd.masks]
    return np.ascontiguousarray(px[..., [mode.index(c) for c in "RGB"]])


def _pil_open(data: bytes, name: str) -> tuple[int, int]:
    """PIL's `BmpImageFile._open` on the bytes: raises where it raises,
    returns its (width, height)."""
    if len(data) < 18 or data[:2] != SIGNATURE:
        raise ValueError(f"{name}: not a BMP file")
    size = _u32(data, 14)
    if size not in HEADERS:
        raise ValueError(f"{name}: unsupported BMP header type ({size})")
    if len(data) < 14 + size:
        raise ValueError(f"{name}: truncated BMP file (header)")
    if size == 12:
        w, h, _, bpp = struct.unpack_from("<HHHH", data, 18)
        comp, colors = BI_RGB, 0
    else:
        w, h_raw, _, bpp, comp = struct.unpack_from("<iIHHI", data, 18)
        h = 2 ** 32 - h_raw if data[25] == 0xFF else h_raw
        colors = _u32(data, 46)
        if comp == BI_BITFIELDS:
            if len(data) < 54 + 12:
                raise ValueError(f"{name}: truncated BMP file (bitfields)")
            rgb = struct.unpack_from("<III", data, 54)
            rgba = rgb + ((_u32(data, 14 + 52),) if size >= 56 else (0,))
            if not ((bpp == 32 and rgba in PIL_MASKS_32)
                    or (bpp == 24 and rgb == (0xFF0000, 0xFF00, 0xFF))
                    or (bpp == 16 and rgb in MASKS_16)):
                raise ValueError(f"{name}: unsupported BMP bitfields layout")
        elif comp not in (BI_RGB, BI_RLE8, BI_RLE4):
            raise ValueError(f"{name}: unsupported BMP compression ({comp})")
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bpp})")
    colors = colors or 1 << bpp
    if bpp <= 8 and not 0 < colors <= 65536:
        raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: broken BMP file ({w} x {h})")
    _pil_bomb(w, h, name)
    return int(w), int(h)


def bmp_size(path: str | Path) -> tuple[int, int]:
    """(width, height) as PIL's `Image.open(f).size`."""
    with open(path, "rb") as f:
        return _pil_open(f.read(14 + 124 + 12), str(path))


def verify_bmp(path: str | Path) -> None:
    """Raise ValueError where the JAX scan (PIL's `Image.open` and
    `verify`, which reads no pixels, and the 10 px assert) marks the file
    corrupt."""
    w, h = bmp_size(path)
    if w < MIN_SIDE or h < MIN_SIDE:
        raise ValueError("image size <10 pixels")


def write_bmp(path: str | Path, arr: np.ndarray) -> None:
    """Write uint8 (H, W, 3) RGB as a 24-bit BMP, (H, W) or (H, W, 1)
    gray as an 8-bit BMP with a gray palette; bottom-up, 40-byte header."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] not in (1, 3)):
        raise ValueError(f"write_bmp takes uint8 gray or RGB, not "
                         f"{arr.dtype} {arr.shape}")
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    h, w = arr.shape[:2]
    gray = arr.ndim == 2
    bpp = 8 if gray else 24
    px = arr if gray else arr[..., ::-1]
    stride = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp // 8] = px[::-1].reshape(h, -1)
    ramp = np.arange(256, dtype=np.uint8)
    palette = (np.stack([ramp, ramp, ramp, 0 * ramp], 1).tobytes() if gray
               else b"")
    offset = 14 + 40 + len(palette)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, BI_RGB, rows.size,
                       0, 0, 0, 0)
    head = SIGNATURE + struct.pack("<IHHI", offset + rows.size, 0, 0, offset)
    Path(path).write_bytes(head + info + palette + rows.tobytes())
