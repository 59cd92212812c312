"""Write the BMP and TIFF fixtures of the port's tests.

    python tests/torch_port_bmp_tiff/make_fixtures.py

The card's machine has neither cv2 nor PIL, so the files that hold the
port's C++ decoders to its numpy ones there are made here once and checked
in; `tests/test_torch_port_bmp.py` and `tests/test_torch_port_tiff.py` hold
each against JAX's `_read_image` (cv2 or PIL, by the branch the module doc
names) on the CPU, and `chip_smoke.py` holds the C++ decoders to the numpy
ones on them. The kinds neither cv2 nor PIL writes are written byte by byte
here (the BMP writer and the TIFF writer below, which takes any byte
order, BigTIFF, tiles, planar configuration 2, predictor 2, 1-16 bit
samples, a photometric, colour map, extra samples and orientation); LZW
comes from cv2. The tests write their other files with the same two
writers. Each image is smooth structure plus noise from a
seeded numpy generator, at odd sides, rows not a multiple of 4 bytes.
"""

from __future__ import annotations

import struct
import sys
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

from sodt_tpu_torch.data.tiff import _packbits_encode  # noqa: E402


def scene(h: int, w: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 18, (h, w, c)), 0, 255).astype(
        np.uint8)


# ------------------------------------------------------------------ BMP

def bmp(rows: bytes, w: int, h: int, bpp: int, comp: int = 0,
        header: int = 40, palette=None, masks=None, top_down=False) -> bytes:
    """A BMP file around `rows` (the bitmap as stored). `palette`: (n, 3)
    RGB; `masks`: (r, g, b[, a]), after an INFO header, else in it."""
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r] + ([] if header == 12 else [0]))
                       for r, g, b in np.asarray(palette, np.uint8))
    extra = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n_pal = 0 if palette is None else len(palette)
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bpp, comp, len(rows), 2835, 2835, n_pal, 0)
        m = list(masks or ()) + [0] * (4 - len(masks or ()))
        if header == 40 and masks is not None:
            extra = struct.pack("<III", *m[:3])
        elif header > 40:
            info += struct.pack("<IIII", *m)
            if header >= 108:
                info += struct.pack("<I", 0x73524742) + bytes(48)
            info = (info + bytes(header))[:header]
    offset = 14 + len(info) + len(extra) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(rows), 0, 0, offset)
    return head + info + extra + pal + rows


def pack_rows(px: np.ndarray, bpp: int, top_down=False) -> bytes:
    """(h, w) indices or uint16, (h, w, k) bytes -> rows padded to 4 bytes,
    bottom-up unless `top_down`."""
    out = []
    for r in px:
        if bpp < 8:
            bits = ((r[:, None] >> np.arange(bpp - 1, -1, -1)) & 1)
            b = np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes()
        elif bpp == 16:
            b = r.astype("<u2").tobytes()
        else:
            b = r.astype(np.uint8).tobytes()
        out.append(b + bytes(-len(b) % 4))
    return b"".join(out if top_down else out[::-1])


def rle(px: np.ndarray, rle4: bool, delta_row: int | None = None,
        end_row: int | None = None, literals: bool = True) -> bytes:
    """RLE8 / RLE4 of (h, w) indices, bottom row first: stretches of 3 or
    more pixels a run can hold (equal pixels; RLE4: two alternating
    nibbles) as runs, the rest as literals of 3 to 7 pixels (odd counts
    included; runs alone without `literals`), a tail under 3 pixels as
    runs; each row ends with an end-of-line. At `delta_row` the first 2
    pixels are skipped with a delta escape (left at index 0); the bitmap
    ends at `end_row` with an end-of-bitmap (the rows above keep index
    0)."""
    out = bytearray()
    period = 2 if rle4 else 1
    for y, row in enumerate(px[::-1]):
        if y == end_row:
            break
        x = 0
        if y == delta_row:
            out += bytes([0, 2, 2, 0])
            x = 2
        w = len(row)
        while x < w:
            k = min(x + period, w)
            while k < w and row[k] == row[k - period] and k - x < 255:
                k += 1
            n = k - x
            if n >= 3 or w - x < 3 or not literals:        # a run
                lo = row[x + 1] if x + 1 < w else 0
                out += bytes([n, row[x] << 4 | lo if rle4 else row[x]])
                x += n
                continue
            n = min(w - x, 3 + (x + y) % 5)                 # literals
            lit = [int(v) for v in row[x:x + n]]
            if rle4:
                lit += [0] * (n % 2)
                data = bytes(a << 4 | b for a, b in zip(lit[::2], lit[1::2]))
            else:
                data = bytes(lit)
            out += bytes([0, n]) + data + bytes(len(data) % 2)
            x += n
        out += bytes([0, 0])
    out += bytes([0, 1])
    return bytes(out)


def bmp_fixtures() -> dict:
    rng = np.random.default_rng(5)
    pal = rng.integers(0, 256, (256, 3))
    out = {}
    h, w = 13, 11                                  # odd sides, padded rows
    rgb = scene(h, w, 3, 1)
    idx = (scene(h, w, 1, 2)[..., 0] // 32 * 3).astype(np.int64)
    s16 = rng.integers(0, 1 << 16, (h, w))
    bgra = np.dstack([rgb[..., ::-1], scene(h, w, 1, 3)])
    out["rgb24"] = bmp(pack_rows(rgb[..., ::-1], 24), w, h, 24)
    out["rgb24_topdown"] = bmp(pack_rows(rgb[..., ::-1], 24, True), w, h, 24,
                               top_down=True)
    out["core24"] = bmp(pack_rows(rgb[..., ::-1], 24), w, h, 24, header=12)
    out["core_pal8"] = bmp(pack_rows(idx, 8), w, h, 8, header=12,
                           palette=pal)
    out["gray8"] = bmp(pack_rows(rgb[..., 1], 8), w, h, 8,
                       palette=np.repeat(np.arange(256)[:, None], 3, 1))
    out["pal8_short"] = bmp(pack_rows(idx, 8), w, h, 8, palette=pal[:20])
    out["pal4"] = bmp(pack_rows(idx % 16, 4), w, h, 4, palette=pal[:16])
    out["pal1"] = bmp(pack_rows(idx % 2, 1), w, h, 1, palette=pal[:2])
    out["pal1_bilevel"] = bmp(pack_rows(idx % 2, 1), w, h, 1,
                              palette=[(0, 0, 0), (255, 255, 255)])
    out["rle8"] = bmp(rle(idx, False, delta_row=4, end_row=11), w, h, 8,
                      comp=1, palette=pal)
    out["rle4"] = bmp(rle(idx % 16, True, delta_row=2, end_row=12), w, h, 4,
                      comp=2, palette=pal[:16])
    out["rgb555"] = bmp(pack_rows(s16, 16), w, h, 16)
    out["bitfields565"] = bmp(pack_rows(s16, 16), w, h, 16, comp=3,
                              masks=(0xF800, 0x7E0, 0x1F))
    out["bitfields555"] = bmp(pack_rows(s16, 16), w, h, 16, comp=3,
                              masks=(0x7C00, 0x3E0, 0x1F))
    out["v4_bitfields565"] = bmp(pack_rows(s16, 16), w, h, 16, comp=3,
                                 header=108, masks=(0xF800, 0x7E0, 0x1F))
    out["rgb32"] = bmp(pack_rows(bgra, 32), w, h, 32)
    out["info_bitfields32"] = bmp(pack_rows(bgra, 32), w, h, 32, comp=3,
                                  masks=(0xFF0000, 0xFF00, 0xFF))
    out["v5_alpha"] = bmp(pack_rows(bgra, 32), w, h, 32, comp=3, header=124,
                          masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    out["v5_rgba_order"] = bmp(pack_rows(bgra, 32), w, h, 32, comp=3,
                               header=124,
                               masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    out["v4_no_alpha"] = bmp(pack_rows(bgra, 32), w, h, 32, comp=3,
                             header=108, masks=(0xFF0000, 0xFF00, 0xFF, 0))
    out["v5_10bit"] = bmp(pack_rows(bgra, 32), w, h, 32, comp=3, header=124,
                          masks=(0x3FF00000, 0xFFC00, 0x3FF, 0))
    return out


# ----------------------------------------------------------------- TIFF

def lzw_encode(raw: bytes) -> bytes:
    """TIFF LZW: a clear code first, MSB-first codes of 9-12 bits, each
    width taken where libtiff's decoder takes it (one code early), a clear
    code before the table fills, the end-of-information code last."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    cur = b""
    for b in raw:
        s = cur + bytes([b])
        if s in table:
            cur = s
            continue
        put(table[cur])
        table[s] = nxt
        nxt += 1
        if nxt == 1 << nbits and nbits < 12:
            nbits += 1
        if nxt == 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        cur = bytes([b])
    if cur:
        put(table[cur])
        nxt += 1
        if nxt == 1 << nbits and nbits < 12:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def reverse_bits(data: bytes) -> bytes:
    """Each byte's bits in the other order (FillOrder 2)."""
    lut = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(lut)


def float_predict(block: np.ndarray) -> bytes:
    """libtiff's floating-point predictor (3) on (rows, cols, k) samples:
    each row's bytes split into planes, most significant byte first, then
    differenced byte by byte at a stride of k."""
    r, c, k = block.shape
    b = block.dtype.itemsize
    be = block.astype(block.dtype.newbyteorder(">")).reshape(r, c * k)
    planes = be.view(np.uint8).reshape(r, c * k, b).transpose(0, 2, 1)
    v = planes.reshape(r, b * c * k).astype(np.int64)
    d = v.copy()
    d[:, k:] = v[:, k:] - v[:, :-k]
    return (d & 255).astype(np.uint8).tobytes()


def ycbcr_units(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """(h, w, 3) Y Cb Cr samples as TIFF YCbCr data units of hs x vs: the
    hs * vs Y samples row by row, then the cell's mean Cb and Cr (the
    image padded by its edge samples to whole units)."""
    h, w, _ = ycc.shape
    hh, ww = -(-h // vs) * vs, -(-w // hs) * hs
    pad = np.pad(ycc, ((0, hh - h), (0, ww - w), (0, 0)), mode="edge")
    cells = pad.reshape(hh // vs, vs, ww // hs, hs, 3).transpose(0, 2, 1, 3, 4)
    y = cells[..., 0].reshape(hh // vs, ww // hs, vs * hs)
    cbcr = cells[..., 1:].reshape(hh // vs, ww // hs, vs * hs, 2).mean(2)
    return np.concatenate([y, cbcr.astype(np.uint8)], -1).astype(
        np.uint8).tobytes()


def jpeg_chunks(img: np.ndarray, blocks, subsampling: int, quality=75):
    """PIL's JPEG encoding of each block (an (rows, cols[, 3]) array) as
    abbreviated streams, and the tables they share as one tables-only
    stream (TIFF's JPEGTables)."""
    import io
    from PIL import Image
    tables, chunks = None, []
    for blk in blocks:
        b = io.BytesIO()
        Image.fromarray(blk).save(b, "JPEG", quality=quality,
                                  subsampling=subsampling)
        s, pos, keep, tab = b.getvalue(), 2, [], []
        while s[pos + 1] != 0xDA:
            n = struct.unpack(">H", s[pos + 2:pos + 4])[0]
            seg = s[pos:pos + 2 + n]
            if s[pos + 1] in (0xDB, 0xC4):
                tab.append(seg)
            elif s[pos + 1] != 0xE0:
                keep.append(seg)
            pos += 2 + n
        t = b"\xff\xd8" + b"".join(tab) + b"\xff\xd9"
        assert tables in (None, t)
        tables = t
        chunks.append(b"\xff\xd8" + b"".join(keep) + s[pos:])
    return tables, chunks


TYPES = {1: "B", 3: "H", 4: "I", 16: "Q", 8: "h", 9: "i", 11: "f", 12: "d"}


def write_tiff(path: str | Path, arr: np.ndarray, compression="none",
               tile=None, rows_per_strip=None, predictor=1, byteorder="<",
               bigtiff=False, planar=1, photometric=None, bits=None,
               colormap=None, extra_samples=None, orientation=None,
               sample_format=None, fill_order=1, extra_tags=None,
               chunks=None) -> None:
    """Write `arr` ((H, W) or (H, W, spp) samples in file order, of any
    integer or float dtype) as a TIFF with one IFD, byte by byte.
    `compression` is "none", "lzw", "deflate" or "packbits"; `tile` a
    (height, width) of multiples of 16, else strips of `rows_per_strip`
    rows (all rows by default); `bits` 1, 2 or 4 packs uint8 values of that
    width (default: the dtype's); `colormap` (2**bits, 3) uint16 for
    photometric 3; `sample_format` defaults to the dtype's kind (1 unsigned,
    2 signed, 3 float); predictor 2 differences integers (wrapping), 3 is
    the floating-point predictor; `fill_order` 2 reverses each byte's bits
    after compression. `chunks` (compressed strips or tiles, with
    `compression` a TIFF code) replaces the encoding, as for JPEG;
    `extra_tags` {tag: (type, values)} adds tags: type 5 takes (numerator,
    denominator) pairs, 7 bytes."""
    s = np.asarray(arr)
    if s.ndim == 2:
        s = s[..., None]
    h, w, spp = s.shape
    bits = bits or 8 * s.dtype.itemsize
    if sample_format is None:
        sample_format = {"u": 1, "b": 1, "i": 2, "f": 3}[s.dtype.kind]
    if photometric is None:
        photometric = 1 if spp < 3 else 2
    comp = ({"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}[compression]
            if isinstance(compression, str) else compression)
    if predictor in (2, 3) and (bits < 8 or comp not in (5, 8)):
        raise ValueError("predictors take 8-bit samples or wider, LZW or "
                         "deflated (readers ignore them otherwise)")
    bo = byteorder

    def encode(block: np.ndarray) -> bytes:
        r, c, k = block.shape
        if predictor == 3:
            raw = float_predict(block)
        elif bits >= 8:
            v = block
            if predictor == 2:
                u = block.view(f"u{block.dtype.itemsize}")
                d = u.copy()
                d[:, 1:] = u[:, 1:] - u[:, :-1]
                v = d.view(block.dtype)
            raw = v.astype(v.dtype.newbyteorder(bo)).tobytes()
        else:
            vals = block.reshape(r, c * k).astype(np.uint8)
            packed = np.zeros((r, c * k * bits), np.uint8)
            for q in range(bits):
                packed[:, q::bits] = (vals >> (bits - 1 - q)) & 1
            raw = np.packbits(packed, axis=1).tobytes()
        if comp == 5:
            raw = lzw_encode(raw)
        elif comp == 8:
            raw = zlib.compress(raw)
        elif comp == 32773:
            rs = len(raw) // r
            raw = b"".join(_packbits_encode(raw[i * rs:(i + 1) * rs])
                           for i in range(r))
        return reverse_bits(raw) if fill_order == 2 else raw

    planes = ([s] if planar == 1 or spp == 1
              else [s[..., k:k + 1] for k in range(spp)])
    if chunks is None:
        chunks = []
        for p in planes:
            if tile:
                th, tw = tile
                for y in range(0, h, th):
                    for x in range(0, w, tw):
                        blk = np.zeros((th, tw, p.shape[2]), s.dtype)
                        part = p[y:y + th, x:x + tw]
                        blk[:part.shape[0], :part.shape[1]] = part
                        chunks.append(encode(blk))
            else:
                rps = rows_per_strip or h
                chunks.extend(encode(p[y:y + rps]) for y in range(0, h, rps))
    off_type = 16 if bigtiff else 4
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [comp]), 262: (3, [photometric]), 277: (3, [spp]),
            284: (3, [planar])}
    if sample_format != 1:
        tags[339] = (3, [sample_format] * spp)
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).T.reshape(-1)])
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    if orientation:
        tags[274] = (3, [orientation])
    if tile:
        tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
        off_tag, cnt_tag = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    tags.update(extra_tags or {})
    body = bytearray(b"\0" * (16 if bigtiff else 8))
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\0" * (len(c) % 2)
    tags[off_tag] = (off_type, offsets)
    tags[cnt_tag] = (off_type, [len(c) for c in chunks])
    ifd_at = len(body)
    esz, inline, ofmt = (20, 8, "Q") if bigtiff else (12, 4, "I")
    spill_at = ifd_at + (8 if bigtiff else 2) + len(tags) * esz + inline
    entries, spill = b"", bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ == 7:
            payload, n = bytes(vals), len(vals)
        elif typ == 5:
            payload = b"".join(struct.pack(bo + "II", *v) for v in vals)
            n = len(vals)
        else:
            payload = struct.pack(f"{bo}{len(vals)}{TYPES[typ]}", *vals)
            n = len(vals)
        if len(payload) <= inline:
            value = payload + b"\0" * (inline - len(payload))
        else:
            value = struct.pack(bo + ofmt, spill_at + len(spill))
            spill += payload + b"\0" * (len(payload) % 2)
        entries += struct.pack(bo + "HH" + ofmt, tag, typ, n) + value
    body += (struct.pack(bo + ("Q" if bigtiff else "H"), len(tags)) + entries
             + b"\0" * inline + spill)
    magic = b"II" if bo == "<" else b"MM"
    body[:16 if bigtiff else 8] = (
        magic + struct.pack(bo + "HHHQ", 43, 8, 0, ifd_at) if bigtiff
        else magic + struct.pack(bo + "HI", 42, ifd_at))
    Path(path).write_bytes(bytes(body))


def write_ycbcr(path, ycc: np.ndarray, subsampling=(2, 2), compression="none",
                rows_per_strip=None, extra_tags=None, **kw) -> None:
    """(H, W, 3) Y Cb Cr samples as a photometric-6 TIFF of data units
    (`ycbcr_units`), in strips of `rows_per_strip` rows."""
    hs, vs = subsampling
    h, w, _ = ycc.shape
    rps = rows_per_strip or h
    code = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}[compression]
    chunks = []
    for y in range(0, h, rps):
        raw = ycbcr_units(ycc[y:y + rps], hs, vs)
        chunks.append(lzw_encode(raw) if code == 5 else zlib.compress(raw)
                      if code == 8 else _packbits_encode(raw)
                      if code == 32773 else raw)
    tags = {530: (3, [hs, vs]), **(extra_tags or {})}
    write_tiff(path, ycc, compression=code, rows_per_strip=rps,
               photometric=6, extra_tags=tags, chunks=chunks, **kw)


def write_jpeg_tiff(path, img: np.ndarray, subsampling=2, photometric=None,
                    tile=None, rows_per_strip=None, tables=True,
                    **kw) -> None:
    """A JPEG-compressed TIFF (compression 7) of (H, W) gray or (H, W, 3)
    RGB pixels: PIL's JPEG of each strip or tile (`subsampling` 0, 1, 2:
    4:4:4, 4:2:2, 4:2:0), photometric YCbCr (6) with YCbCrSubsampling for
    colour unless given, the tables in JPEGTables (`tables`) or in every
    chunk."""
    h, w = img.shape[:2]
    if tile:
        th, tw = tile
        pad = np.pad(img, ((0, -h % th), (0, -w % tw)) + ((0, 0),) * (
            img.ndim - 2), mode="edge")
        blocks = [pad[y:y + th, x:x + tw] for y in range(0, h, th)
                  for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        blocks = [img[y:y + rps] for y in range(0, h, rps)]
    tab, chunks = jpeg_chunks(img, blocks, subsampling)
    color = img.ndim == 3
    photometric = photometric or (6 if color else 1)
    tags = dict(kw.pop("extra_tags", {}))
    if photometric == 6:
        tags[530] = (3, [[1, 1], [2, 1], [2, 2]][subsampling])
    if tables:
        tags[347] = (7, tab)
    else:
        chunks = [tab[:-2] + c[2:] for c in chunks]
    write_tiff(path, img, compression=7, tile=tile,
               rows_per_strip=rows_per_strip, photometric=photometric,
               extra_tags=tags, chunks=chunks, **kw)


def tiff_fixtures(tmp: Path) -> dict:
    """name -> bytes of each TIFF fixture."""
    import cv2

    rng = np.random.default_rng(7)
    h, w = 19, 23
    rgb = scene(h, w, 3, 11)
    gray = rgb[..., 1]
    alpha = scene(h, w, 1, 12)
    s16 = rng.integers(0, 1 << 16, (h, w, 4)).astype(np.uint16)
    s16[::2] //= 300                                   # both sides of 255
    cmap = rng.integers(0, 1 << 16, (256, 3))
    idx = (gray // 16).astype(np.uint8)
    cases = {
        "deflate_tiles_pred": (rgb, dict(compression="deflate",
                                         tile=(16, 16), predictor=2)),
        "packbits_mm": (rgb, dict(compression="packbits", byteorder=">",
                                  rows_per_strip=4)),
        "bigtiff": (rgb, dict(bigtiff=True, rows_per_strip=5)),
        "bigtiff_mm": (gray, dict(bigtiff=True, byteorder=">")),
        "planar2": (rgb, dict(planar=2, rows_per_strip=7)),
        "planar2_deflate_rgba": (np.dstack([rgb, alpha]), dict(
            planar=2, compression="deflate", extra_samples=[2])),
        "rgba_unassociated": (np.dstack([rgb, alpha]),
                              dict(extra_samples=[2])),
        "rgba_associated": (np.dstack([rgb, alpha]),
                            dict(extra_samples=[1], compression="packbits")),
        "gray_alpha": (np.dstack([gray, alpha[..., 0]]),
                       dict(extra_samples=[2])),
        "minwhite8": (gray, dict(photometric=0)),
        "bit1": ((gray > 128).astype(np.uint8), dict(bits=1)),
        "bit1_minwhite_tiles": ((gray > 128).astype(np.uint8), dict(
            bits=1, photometric=0, tile=(16, 16), compression="packbits")),
        "gray4": (gray >> 4, dict(bits=4, compression="deflate")),
        "gray2_minwhite": (gray >> 6, dict(bits=2, photometric=0)),
        "palette8": (idx * 16, dict(photometric=3, colormap=cmap)),
        "palette8_cmap8": (idx * 16, dict(photometric=3,
                                          colormap=cmap >> 8)),
        "palette4": (idx, dict(bits=4, photometric=3, colormap=cmap[:16])),
        "palette1": (idx % 2, dict(bits=1, photometric=3,
                                   colormap=cmap[:2])),
        "gray16_mm_pred": (s16[..., 0], dict(byteorder=">", predictor=2,
                                             compression="deflate")),
        "gray16_minwhite": (s16[..., 0], dict(photometric=0)),
        "rgb16_tiles": (s16[..., :3], dict(tile=(16, 32))),
        "rgb16_planar2_deflate": (s16[..., :3], dict(planar=2,
                                                     compression="deflate")),
        "rgba16_associated": (s16, dict(extra_samples=[1])),
        "orientation3": (rgb, dict(orientation=3)),
        "orientation6": (rgb, dict(orientation=6)),
    }
    out = {}
    for name, (arr, kw) in cases.items():
        p = tmp / f"{name}.tif"
        write_tiff(p, arr, **kw)
        out[name] = p.read_bytes()
    # the kinds aerial imagery ships: JPEG (gray, RGB, YCbCr 1 x 1, 2 x 1,
    # 2 x 2; strips, tiles, tables in JPEGTables or in each chunk), YCbCr
    # data units, CMYK, signed, float and 32-bit samples (predictors 2 and
    # 3), FillOrder 2
    f32 = (rng.standard_normal((h, w)) * 60 + 90).astype(np.float32)
    f32[0, :4] = [np.nan, np.inf, -np.inf, 255.5]
    ycc_tags = {529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
                532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                          (240, 1)])}
    jpegs = {
        "jpeg_gray": (gray, dict(subsampling=0, rows_per_strip=16)),
        "jpeg_rgb": (rgb, dict(subsampling=0, photometric=2)),
        "jpeg_ycc11_tiles": (rgb, dict(subsampling=0, tile=(16, 16))),
        "jpeg_ycc21_strips": (rgb, dict(subsampling=1, rows_per_strip=8)),
        "jpeg_ycc22_strips": (rgb, dict(subsampling=2, rows_per_strip=16)),
        "jpeg_ycc22_tiles_mm": (rgb, dict(subsampling=2, tile=(16, 16),
                                          byteorder=">")),
        "jpeg_ycc22_no_tables": (rgb, dict(subsampling=2, tables=False)),
    }
    for name, (arr, kw) in jpegs.items():
        p = tmp / f"{name}.tif"
        write_jpeg_tiff(p, arr, **kw)
        out[name] = p.read_bytes()
    yccs = {
        "ycc11": dict(subsampling=(1, 1)),
        "ycc21_lzw": dict(subsampling=(2, 1), compression="lzw",
                          rows_per_strip=6),
        "ycc22_deflate": dict(subsampling=(2, 2), compression="deflate",
                              rows_per_strip=8),
        "ycc22_packbits_bt709": dict(subsampling=(2, 2),
                                     compression="packbits",
                                     extra_tags=ycc_tags),
    }
    for name, kw in yccs.items():
        p = tmp / f"{name}.tif"
        write_ycbcr(p, scene(h, w, 3, 13), **kw)
        out[name] = p.read_bytes()
    samples = {
        "cmyk_lzw": (scene(h, w, 4, 14), dict(photometric=5,
                                              compression="lzw")),
        "cmyk_extra": (scene(h, w, 5, 14), dict(photometric=5,
                                                extra_samples=[0])),
        "float32": (f32, {}),
        "float32_pred3": (f32, dict(predictor=3, compression="deflate")),
        "float32_pred3_mm_tiles": (f32, dict(predictor=3, compression="lzw",
                                             byteorder=">", tile=(16, 16))),
        "float32_rgb_pred2": (np.dstack([f32, f32 * 2, -f32]),
                              dict(predictor=2, compression="deflate")),
        "float32_rgba": (np.dstack([f32, f32, f32, f32 / 200]),
                         dict(extra_samples=[2])),
        "float64_pred3": (f32.astype(np.float64) * np.pi, dict(
            predictor=3, compression="deflate")),
        "int8_rgb": ((rgb.astype(np.int16) - 128).astype(np.int8), {}),
        "int16_pred2_lzw": ((s16[..., 0].astype(np.int32) - 20000).astype(
            np.int16), dict(predictor=2, compression="lzw")),
        "int16_rgb_mm": ((s16[..., :3].astype(np.int32) - 30000).astype(
            np.int16), dict(byteorder=">", compression="packbits")),
        "int32_pred2": (s16[..., 0].astype(np.int32) * 40000 - 10 ** 9,
                        dict(predictor=2, compression="deflate")),
        "uint32": (s16[..., 1].astype(np.uint32) * 60000, {}),
        "fill2_lzw_rgb": (rgb, dict(compression="lzw", fill_order=2)),
        "fill2_bit1": ((gray > 128).astype(np.uint8), dict(
            bits=1, fill_order=2)),
        "fill2_gray16": (s16[..., 0], dict(fill_order=2,
                                           compression="deflate")),
    }
    for name, (arr, kw) in samples.items():
        p = tmp / f"{name}.tif"
        write_tiff(p, arr, **kw)
        out[name] = p.read_bytes()
    lzw = [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW]
    pred = [cv2.IMWRITE_TIFF_PREDICTOR, cv2.IMWRITE_TIFF_PREDICTOR_HORIZONTAL]
    for name, arr, params in (
            ("lzw_rgb", rgb[..., ::-1], lzw),
            ("lzw_pred_gray_strips", gray, lzw + pred + [
                cv2.IMWRITE_TIFF_ROWSPERSTRIP, 6]),
            ("lzw_pred_rgb16", s16[..., 2::-1], lzw + pred)):
        ok, buf = cv2.imencode(".tif", arr, params)
        assert ok, name
        out[name] = buf.tobytes()
    return out


def main():
    import tempfile

    for p in HERE.glob("*.bmp"):
        p.unlink()
    for p in HERE.glob("*.tif"):
        p.unlink()
    for name, data in bmp_fixtures().items():
        (HERE / f"{name}.bmp").write_bytes(data)
    with tempfile.TemporaryDirectory() as tmp:
        for name, data in tiff_fixtures(Path(tmp)).items():
            (HERE / f"{name}.tif").write_bytes(data)


if __name__ == "__main__":
    main()
