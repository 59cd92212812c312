"""PNG decode and encode in numpy and the stdlib (`zlib`): the port's own
stand-in for `cv2.imread` / PIL, which the card's machine does not have.

  read_png(path)    signature, chunks and their CRCs, the IDATs joined and
                    inflated, the five row filters undone (each of Adam7's
                    seven passes on its own), the samples unpacked. For an
                    8-bit gray, RGB, gray+alpha or RGBA image it returns
                    what the JAX package's `_read_image` returns through
                    cv2 (`sodt_tpu/data/vedai.py:51-57`: IMREAD_UNCHANGED,
                    then `[..., ::-1]`): gray -> (H, W, 1); RGB -> (H, W, 3)
                    RGB; RGBA -> (H, W, 4) in the order A, R, G, B;
                    gray+alpha -> (H, W, 4) as A, L, L, L (cv2 widens it to
                    BGRA first). Every other image, and any image with a
                    tRNS chunk, returns what `_read_image` returns through
                    PIL where cv2 is absent, as on the card's machine
                    (`np.asarray(Image.open(path))`, then `[..., None]` or
                    `[..., :3]`): 16-bit gray -> (H, W, 1) uint16; 16-bit
                    RGB, RGBA -> (H, W, 3) uint8 of each sample's high
                    byte; 16-bit gray+alpha -> (H, W, 3) L, L, L high
                    bytes; palette (1, 2, 4, 8 bits) -> (H, W, 1) of the
                    palette INDICES, not colours (a JAX quirk); 1-bit gray
                    -> (H, W, 1) bool; 2- and 4-bit gray -> (H, W, 1) uint8
                    scaled to 0-255; tRNS changes nothing (RGB stays 3
                    channels).
  read_png_rgb(path)
                    (H, W, 3) uint8 RGB, as PIL's `convert("RGB")` gives it
                    (palette colours, alpha dropped).
  png_size(path)    (width, height) from IHDR alone, as PIL's `Image.size`.
  verify_png(path)  raises where PIL's `Image.verify` plus the JAX scan's
                    10 px assert fail: signature, IHDR first, every CRC,
                    IEND present, both sides >= 10.
  write_png(path, arr, filters=1)
                    an encoder that sets each row's filter type (0 None,
                    1 Sub, 2 Up, 3 Average, 4 Paeth; one int for every row
                    or one per row). Channels are taken in file order
                    (gray, gray+alpha, R G B, R G B A). cv2 writes every row
                    with Sub, which is the default here too.

Every bit depth and colour type of the PNG standard is read, interlaced
or not; a combination outside it raises ValueError.

Rows with Sub, Up or None are undone with whole-row numpy operations (Sub
as a uint8 cumulative sum along the row, Up as one add to the row above).
Average and Paeth take the pixel to the left, the one above and the one
above-left, so neither a row nor a column is one vector operation. An
image that holds such rows is undone on a wavefront (`_unfilter_scheduled`:
pixel (y, x) needs only pixels made one and two steps before it), each
step one vector operation over every row of a skewed copy.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel, and the bit depths the standard allows
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7: each pass's (row start, column start, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
MIN_SIDE = 10        # the JAX scan's "image size <10 pixels" assert
PIL_MAX_PIXELS = 2 * 89478485    # PIL's decompression bomb, at open


def pil_bomb(w: int, h: int, name) -> None:
    """PIL's open refuses more than twice its 89478485-pixel limit (above
    the limit itself it only warns)."""
    if w * h > PIL_MAX_PIXELS:
        raise ValueError(f"{name}: decompression bomb ({w} x {h} pixels; "
                         f"PIL opens at most {PIL_MAX_PIXELS})")


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, in file order.
    Raises ValueError on a short chunk or a CRC that does not match."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (signature)")
    pos = 8
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG file (chunk header)")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise ValueError(f"truncated PNG file (chunk {kind!r})")
        payload = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:end])[0]
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"broken PNG file (bad CRC in {kind!r})")
        yield kind, payload
        pos = end


def _ihdr(payload: bytes):
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", payload[:13])
    return w, h, depth, ctype, comp, filt, interlace


def png_size(path: str | Path) -> tuple[int, int]:
    """(width, height) from the IHDR chunk, as PIL's `Image.open(f).size`
    (the header only); raises above PIL's decompression bomb limit, as its
    open does."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    pil_bomb(w, h, path)
    return int(w), int(h)


def verify_png(path: str | Path) -> None:
    """Raise ValueError where the JAX scan (`Image.open`, `Image.verify`
    and its 10 px assert) marks the file corrupt: the signature, IHDR
    first, every chunk's CRC, IEND present, PIL's decompression bomb limit,
    both sides at least MIN_SIDE."""
    data = Path(path).read_bytes()
    kinds = []
    for kind, payload in _chunks(data):
        if not kinds and kind != b"IHDR":
            raise ValueError("broken PNG file (IHDR is not first)")
        if kind == b"IHDR":
            w, h = _ihdr(payload)[:2]
        kinds.append(kind)
        if kind == b"IEND":
            break
    if b"IEND" not in kinds:
        raise ValueError("truncated PNG file (no IEND)")
    pil_bomb(w, h, path)
    if w < MIN_SIDE or h < MIN_SIDE:
        raise ValueError("image size <10 pixels")


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays, as selects by 0 / 1 products
    (numpy's `where` on int16 costs several times a product)."""
    u, v = b - c, a - c
    pa, pb, pc = np.abs(u), np.abs(v), np.abs(u + v)
    take_a = (pa <= pb) & (pa <= pc)
    take_b = (pb <= pc) & ~take_a
    return c + take_a * v + take_b * u


def _unfilter_easy(data, ft, out, bpp):
    """Every row, where the filters are None, Sub and Up only: Sub rows as
    one uint8 cumulative sum along x, Up rows one add each, top down."""
    h, stride = data.shape
    sub = np.flatnonzero(ft == 1)
    out[sub] = np.cumsum(data[sub].reshape(len(sub), stride // bpp, bpp),
                         axis=1, dtype=np.uint8).reshape(len(sub), stride)
    none = ft == 0
    out[none] = data[none]
    for y in np.flatnonzero(ft == 2):
        out[y] = data[y] + (out[y - 1] if y else 0)


def _unfilter_scheduled(data, ft, bpp):
    """Every row, any filter, on a wavefront. A row that needs the row
    above (Up, Average, Paeth) starts one step after it, any other row
    (None; Sub, undone beforehand and then copied) at step 0: pixel (y, x)
    is made at step s(y) + x, after its left neighbour (step - 1), the
    pixel above (step - 1) and the one above-left (step - 2). T[step + 2,
    y + 1] holds it, T[:, 0] is a zero row above the image and a row's
    cells outside [s(y), s(y) + w) stay zero, so one step is three slices
    of T over all rows, and a run of n such rows costs n - 1 steps beyond
    the row's width."""
    h, stride = data.shape
    w = stride // bpp
    dep = ft >= 2
    s = np.zeros(h, np.int64)
    for y in range(1, h):
        s[y] = s[y - 1] + 1 if dep[y] else 0
    raw = data.reshape(h, w, bpp).astype(np.int16)
    sub = np.flatnonzero(ft == 1)
    raw[sub] = np.cumsum(data[sub].reshape(len(sub), w, bpp), axis=1,
                         dtype=np.uint8)
    steps = int(s.max()) + w + 2
    rt = np.zeros((steps, h + 1, bpp), np.int16)
    for y in range(h):
        rt[s[y] + 2:s[y] + 2 + w, y + 1] = raw[y]
    kind = np.where(dep, ft, 0)
    masks = {f: np.broadcast_to((kind == f)[:, None], (h, bpp)).astype(
        np.int16) for f in (2, 3, 4) if (kind == f).any()}
    t = np.zeros((steps, h + 1, bpp), np.int16)
    for i in range(2, steps):
        a, b, c = t[i - 1, 1:], t[i - 1, :-1], t[i - 2, :-1]
        pred = rt[i, 1:].copy()
        for f, m in masks.items():
            pred += m * (b if f == 2 else (a + b) >> 1 if f == 3
                         else _paeth(a, b, c))
        live = (i - 2 - s >= 0) & (i - 2 - s < w)
        np.bitwise_and(pred, 0xFF, out=pred)
        np.multiply(pred, live[:, None], out=t[i, 1:])
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = t[s[y] + 2:s[y] + 2 + w, y + 1]
    return out.reshape(h, stride)


def _unfilter(buf: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """h filtered rows of `stride` bytes each (their filter-type bytes in
    front) -> (h, stride) uint8 with every row's filter undone; `bpp` the
    bytes a pixel takes, at least 1."""
    if buf.size < h * (stride + 1):
        raise ValueError("truncated PNG file (image data)")
    buf = buf[:h * (stride + 1)].reshape(h, stride + 1)
    ft, data = buf[:, 0], buf[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"broken PNG file (filter type {ft.max()})")
    if (ft >= 3).any():
        return _unfilter_scheduled(data, ft, bpp)
    out = np.empty((h, stride), np.uint8)
    _unfilter_easy(data, ft, out, bpp)
    return out


def _samples(rows: np.ndarray, w: int, depth: int, spp: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> (h, w, spp) samples: uint8 at depths
    1-8, uint16 at 16 (big-endian in the file)."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, w, spp)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, spp)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _decode(raw: bytes, w: int, h: int, depth: int, spp: int,
            interlace: int) -> np.ndarray:
    """The inflated IDAT stream -> (h, w, spp) samples, plain or Adam7."""
    buf = np.frombuffer(raw, np.uint8)
    bpp = max(depth * spp // 8, 1)
    stride = lambda n: (n * depth * spp + 7) // 8
    if not interlace:
        return _samples(_unfilter(buf, h, stride(w), bpp), w, depth, spp)
    out = np.zeros((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in ADAM7:
        ph, pw = len(range(y0, h, dy)), len(range(x0, w, dx))
        if not ph or not pw:
            continue            # an empty pass holds no rows at all
        n = ph * (stride(pw) + 1)
        rows = _unfilter(buf[pos:pos + n], ph, stride(pw), bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, spp)
        pos += n
    return out


def _as_read_image(img: np.ndarray, depth: int, ctype: int,
                   trns: bool) -> np.ndarray:
    """Samples -> the layout of JAX's `_read_image` (module doc): cv2's
    for 8-bit gray / RGB / gray+alpha / RGBA without tRNS, PIL's for the
    rest."""
    if depth == 8 and ctype != 3 and not trns:
        if ctype == 4:          # cv2 widens L, A to B G R A = L L L A
            return np.ascontiguousarray(img[..., [1, 0, 0, 0]])
        if ctype == 6:          # B G R A reversed: A R G B
            return np.ascontiguousarray(img[..., [3, 0, 1, 2]])
        return img
    if ctype == 3 or (ctype == 0 and depth in (8, 16)):
        return img              # palette indices; gray as stored
    if ctype == 0:              # 1 bit: PIL mode "1"; 2, 4: scaled "L"
        return (img.astype(bool) if depth == 1
                else img * np.uint8(255 // ((1 << depth) - 1)))
    if depth == 16:             # PIL keeps each sample's high byte
        img = (img >> 8).astype(np.uint8)
    if ctype == 4:              # PIL widens L, A to R G B A = L L L A
        img = img[..., [0, 0, 0, 1]]
    return np.ascontiguousarray(img[..., :3])


def _load(path):
    """(samples (H, W, spp), bit depth, colour type, tRNS present, PLTE
    payload) of a PNG file."""
    data = Path(path).read_bytes()
    idat, header, trns, plte = [], None, False, b""
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = _ihdr(payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE":
            plte = payload
        elif kind == b"tRNS":
            trns = True
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: broken PNG file (no IHDR or IDAT)")
    w, h, depth, ctype, _, _, interlace = header
    if depth not in DEPTHS.get(ctype, ()) or interlace > 1:
        raise ValueError(f"{path}: broken PNG file (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    img = _decode(zlib.decompress(b"".join(idat)), w, h, depth,
                  CHANNELS[ctype], interlace)
    return img, depth, ctype, trns, plte


def read_png(path: str | Path) -> np.ndarray:
    """Decode a PNG to the layout of the JAX package's `_read_image` (module
    doc)."""
    img, depth, ctype, trns, _ = _load(path)
    return _as_read_image(img, depth, ctype, trns)


def read_png_rgb(path: str | Path) -> np.ndarray:
    """Decode a PNG to (H, W, 3) uint8 RGB as PIL's `convert("RGB")` does:
    palette indices to their PLTE colours (black past its end), 16-bit
    gray clipped at 255, other 16-bit samples their high byte, 1-, 2- and
    4-bit gray scaled to 0-255, gray repeated, alpha and tRNS dropped."""
    img, depth, ctype, _, plte = _load(path)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        colours = np.frombuffer(plte, np.uint8)[:768]
        pal[:len(colours) // 3] = colours[:len(colours) // 3 * 3].reshape(
            -1, 3)
        return pal[img[..., 0]]
    if ctype == 0 and depth == 16:
        img = np.minimum(img, 255).astype(np.uint8)
    elif ctype == 0 and depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    elif depth == 16:
        img = (img >> 8).astype(np.uint8)
    if ctype in (0, 4):
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, -1))
    return np.ascontiguousarray(img[..., :3])


def write_png(path: str | Path, arr: np.ndarray, filters=1,
              level: int = 6) -> None:
    """Encode uint8 `arr` ((H, W) or (H, W, 1) gray, (H, W, 2) gray+alpha,
    (H, W, 3) RGB, (H, W, 4) RGBA, channels in file order) as a PNG whose
    row y carries filter type `filters` (an int) or `filters[y]`."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, cn = arr.shape
    ctype = {1: 0, 3: 2, 2: 4, 4: 6}[cn]
    ft = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    if ft.max(initial=0) > 4:
        raise ValueError("PNG filter types are 0-4")
    x = arr.reshape(h, w * cn).astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, cn:] = x[:, :-cn]
    upleft = np.zeros_like(x)
    upleft[1:, cn:] = x[:-1, :-cn]
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1,
                     _paeth(left, up, upleft)])
    rows = (x - pred[ft, np.arange(h)]) & 0xFF
    stream = np.concatenate([ft[:, None].astype(np.int16), rows], 1)
    raw = stream.astype(np.uint8).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(raw, level))
                           + chunk(b"IEND", b""))
