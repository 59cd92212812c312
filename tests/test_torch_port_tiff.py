"""The port's TIFF code against the JAX package's readers on the CPU:

  * `_read_image` (the C++ decoder of `csrc/tiff.cpp`, built here with the
    host compiler) and `data/tiff.py`'s numpy decoder bit-equal to JAX's
    `_read_image` under the branch `tiff.py`'s table names (cv2 for 8-bit
    gray and RGB(A), PIL for palettes, 1-, 2-, 4- and 16-bit samples) on
    every checked-in fixture (`tests/torch_port_bmp_tiff/`) and on files
    cv2, PIL and `write_tiff` write at sides from 1 to about 1000 px: none,
    LZW, deflate and PackBits; predictor 2; strips and tiles; planar
    configuration 2; II and MM; BigTIFF;
  * the Orientation tag as cv2 and PIL take it (and OpenCV 4.6's turn for
    5-8, where cv2 5.0 reads nothing);
  * damaged files: a strip past the end raises (cv2 returns no image); a
    strip whose LZW, PackBits or deflate data is cut or broken reads as
    JAX's `_read_image` reads it, filled as libtiff leaves it on the cv2
    branch, raising where PIL fails; a 16-bit palette raises, as every
    reader fails; the kinds out of scope raise NotImplementedError naming
    themselves;
  * `tiff_size` / `image_size` equal to PIL's `size`, `verify_image`
    raising where JAX's scan marks a file corrupt;
  * `tools boxes` crops of a TIFF folder byte-equal to JAX's, and a VEDAI
    folder written as TIFF (deflate, predictor 2, tiles) giving JAX's eval
    batches and JAX's `val` mAP.
"""

from __future__ import annotations

import importlib.util
import io
import struct
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image

from sodt_tpu_torch.data import native_loader as tnative
from sodt_tpu_torch.data import tiff
from sodt_tpu_torch.data import vedai as tv
from sodt_tpu_torch.kernels import _build
from torch_port_common import (DAMAGED_STRIPS,  # noqa: F401
                               batches_equal_jax, damaged_tiff, folder_as,
                               jax_read_image, one_torch_thread, pil_scan,
                               val_equals_jax)

FIXTURES = Path(__file__).resolve().parent / "torch_port_bmp_tiff"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.tif"))
SIDES = [(1, 1), (2, 3), (10, 11), (17, 5), (37, 53), (123, 157)]
BIG = (997, 731)


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _script()


@pytest.fixture(scope="module")
def lib():
    try:
        _build.cxx_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    assert tnative.available(), tnative.load_error()
    return tnative._lib


def _info(path):
    return tiff._info(Path(path).read_bytes(), str(path))


def _cv2_branch(path) -> bool:
    return tiff._cv2_branch(_info(path))


def _equal(got, want, what):
    want = np.asarray(want)
    if want.dtype.byteorder == ">":          # PIL's I;16B
        want = want.astype(np.uint16)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _all_three(path) -> np.ndarray:
    """The port's three reads, held equal: `_read_image` (C++, picked by
    the signature), `decode_tiff` and the numpy `read_tiff`."""
    got = tv._read_image(str(path))
    _equal(tnative.decode_tiff(path), got, path)
    _equal(tiff.read_tiff(path), got, path)
    return got


def _pil_rgb(path):
    """PIL's `convert("RGB")`, or None where PIL does not open the file."""
    try:
        return np.asarray(Image.open(path).convert("RGB"))
    except Exception:
        return None


def _rgb_as_pil(path):
    want = _pil_rgb(path)
    if want is None:
        with pytest.raises((ValueError, NotImplementedError)):
            tiff.read_tiff_rgb(path)
    else:
        _equal(tiff.read_tiff_rgb(path), want, path)


def _with_orientation(data: bytes, o: int) -> bytes:
    """A classic TIFF's bytes with its Orientation tag's value set to o."""
    bo = "<" if data[:2] == b"II" else ">"
    pos = struct.unpack_from(bo + "I", data, 4)[0]
    n = struct.unpack_from(bo + "H", data, pos)[0]
    for e in range(pos + 2, pos + 2 + 12 * n, 12):
        if struct.unpack_from(bo + "H", data, e)[0] == 274:
            return data[:e + 8] + struct.pack(bo + "H", o) + data[e + 10:]
    raise AssertionError("no Orientation tag")


def _turned(img: np.ndarray, o: int) -> np.ndarray:
    """OpenCV 4.6's turn of an upright image by Orientation 5-8."""
    return {5: img.swapaxes(0, 1), 6: np.rot90(img, -1),
            7: img[::-1, ::-1].swapaxes(0, 1), 8: np.rot90(img, 1)}[o]


# -------------------------------------------------------------- decode

@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_decodes_as_jax(lib, tmp_path, name):
    """Each checked-in file through the port's three reads; the JAX read of
    the branch the table names; PIL's `convert("RGB")` for
    `read_tiff_rgb`. An image oriented 5-8, which cv2 5.0 does not read, is
    held to its upright twin turned as OpenCV 4.6 turns it; a big-endian
    file under the floating-point predictor, which PIL misreads, to PIL's
    read of its little-endian twin."""
    path = FIXTURES / name
    got = _all_three(path)
    t = _info(path)
    if t.orient in (5, 6, 7, 8):
        data = _with_orientation(path.read_bytes(), 1)
        up = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        _equal(got, np.ascontiguousarray(_turned(up[..., ::-1], t.orient)),
               name)
        with pytest.raises(NotImplementedError, match="orientation"):
            tiff.read_tiff_rgb(path)
        return
    _equal(got, jax_read_image(path, cv2_branch=_cv2_branch(path)), name)
    if t.pred == 3 and t.bo == ">":
        # PIL swaps the bytes that libtiff's floating-point predictor
        # already put in the host's order: the port's convert("RGB") is
        # held to PIL's of a little-endian twin of the same samples
        twin = tmp_path / "le.tif"
        FX.write_tiff(twin, got[..., 0], predictor=3, compression="lzw",
                      tile=(16, 16))
        _equal(tiff.read_tiff_rgb(path), _pil_rgb(twin), name)
        assert not np.array_equal(_pil_rgb(path), _pil_rgb(twin))
        return
    _rgb_as_pil(path)


def test_fixtures_are_the_scripts(tmp_path):
    """The checked-in TIFF files are what `make_fixtures.py` builds."""
    made = FX.tiff_fixtures(tmp_path)
    assert sorted(f"{n}.tif" for n in made) == FIXTURE_FILES
    for name, data in made.items():
        assert (FIXTURES / f"{name}.tif").read_bytes() == data, name
        assert len(data) < 8192


def _cv2_writer(c, params, dtype=np.uint8):
    def write(p, h, w, s):
        img = FX.scene(h, w, c, s)
        if dtype == np.uint16:
            img = img.astype(np.uint16) * 257 + np.uint16(s)
        ok, buf = cv2.imencode(".tif", img[..., 0] if c == 1 else img,
                               params)
        assert ok
        p.write_bytes(buf.tobytes())
    return write


def _pil_writer(mode, compression):
    def write(p, h, w, s):
        img = Image.fromarray(FX.scene(h, w, 3, s))
        if mode == "I;16":
            img = Image.fromarray(FX.scene(h, w, 1, s)[..., 0].astype(
                np.uint16) * 251)
        elif mode == "P":
            img = img.convert("P")
        else:
            img = img.convert(mode)
        if compression == "jpeg":
            img.save(p, compression="jpeg", quality=90)
            return
        img.save(p, compression=compression)
    return write


def _own_writer(c, **kw):
    def write(p, h, w, s):
        arr = FX.scene(h, w, c, s)
        if kw.get("bits") == 16:
            arr = arr.astype(np.uint16) * 257 + np.uint16(s)
            kw2 = {k: v for k, v in kw.items() if k != "bits"}
        elif kw.get("bits") in (1, 4):
            arr = arr >> (8 - kw["bits"])
            kw2 = kw
        else:
            kw2 = kw
        if kw.get("photometric") == 3:
            cmap = np.random.default_rng(s).integers(
                0, 1 << 16, (1 << kw.get("bits", 8), 3))
            kw2 = dict(kw2, colormap=cmap)
        FX.write_tiff(p, arr[..., 0] if c == 1 else arr, **kw2)
    return write


LZW = [cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW]
PRED = [cv2.IMWRITE_TIFF_PREDICTOR, cv2.IMWRITE_TIFF_PREDICTOR_HORIZONTAL]
STRIPS = [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 7]
WRITERS = {  # kind -> (write(path, h, w, seed), cv2 branch or not)
    "cv2_lzw_bgr": (_cv2_writer(3, LZW), True),
    "cv2_lzw_pred_gray_strips": (_cv2_writer(1, LZW + PRED + STRIPS), True),
    "cv2_deflate_bgra": (_cv2_writer(4, [
        cv2.IMWRITE_TIFF_COMPRESSION,
        cv2.IMWRITE_TIFF_COMPRESSION_ADOBE_DEFLATE]), True),
    "cv2_packbits_bgr": (_cv2_writer(3, [
        cv2.IMWRITE_TIFF_COMPRESSION,
        cv2.IMWRITE_TIFF_COMPRESSION_PACKBITS]), True),
    "cv2_lzw_pred_rgb16": (_cv2_writer(3, LZW + PRED, np.uint16), False),
    "pil_lzw_palette": (_pil_writer("P", "tiff_lzw"), False),
    "pil_packbits_bilevel": (_pil_writer("1", "packbits"), False),
    "pil_deflate_gray16": (_pil_writer("I;16", "tiff_deflate"), False),
    "pil_raw_rgba": (_pil_writer("RGBA", "raw"), True),
    "pil_lzw_gray_alpha": (_pil_writer("LA", "tiff_lzw"), True),
    "own_tiles_pred_deflate": (_own_writer(3, tile=(16, 32), predictor=2,
                                           compression="deflate"), True),
    "own_planar2_mm": (_own_writer(3, planar=2, byteorder=">",
                                   rows_per_strip=5), True),
    "own_bigtiff_packbits": (_own_writer(1, bigtiff=True,
                                         compression="packbits"), True),
    "own_gray4_tiles": (_own_writer(1, bits=4, tile=(16, 16)), False),
    "own_palette4": (_own_writer(1, bits=4, photometric=3), False),
    "own_rgb16_planar2_deflate": (_own_writer(3, bits=16, planar=2,
                                              compression="deflate"), False),
    "cv2_jpeg_rgb": (_cv2_writer(3, [cv2.IMWRITE_TIFF_COMPRESSION,
                                     cv2.IMWRITE_TIFF_COMPRESSION_JPEG,
                                     cv2.IMWRITE_TIFF_ROWSPERSTRIP, 8]),
                     True),
    "pil_jpeg_ycbcr": (_pil_writer("YCbCr", "jpeg"), True),
    "pil_lzw_cmyk": (_pil_writer("CMYK", "tiff_lzw"), True),
    "own_jpeg_gray_strips": (lambda p, h, w, s: FX.write_jpeg_tiff(
        p, FX.scene(h, w, 1, s)[..., 0], subsampling=0, rows_per_strip=16),
        True),
    "own_jpeg_ycc21_tiles": (lambda p, h, w, s: FX.write_jpeg_tiff(
        p, FX.scene(h, w, 3, s), subsampling=1, tile=(16, 32)), True),
    "own_jpeg_ycc22_strips": (lambda p, h, w, s: FX.write_jpeg_tiff(
        p, FX.scene(h, w, 3, s), subsampling=2, rows_per_strip=32), True),
    "own_ycc22_lzw": (lambda p, h, w, s: FX.write_ycbcr(
        p, FX.scene(h, w, 3, s), (2, 2), compression="lzw",
        rows_per_strip=16), True),
    "own_ycc21_deflate": (lambda p, h, w, s: FX.write_ycbcr(
        p, FX.scene(h, w, 3, s), (2, 1), compression="deflate"), True),
    "own_float32_pred3_tiles": (lambda p, h, w, s: FX.write_tiff(
        p, FX.scene(h, w, 1, s)[..., 0] / np.float32(7), predictor=3,
        compression="deflate", tile=(32, 16)), True),
    "own_int16_pred2_strips": (lambda p, h, w, s: FX.write_tiff(
        p, FX.scene(h, w, 1, s)[..., 0].astype(np.int16) * -97,
        predictor=2, compression="lzw", rows_per_strip=5), True),
    "own_fill2_deflate_rgb": (_own_writer(3, fill_order=2,
                                          compression="deflate"), True),
}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_generated_files_decode_as_jax(lib, tmp_path, kind):
    """C++ at every side up to ~1000 px, numpy as well below it."""
    write, cv2_branch = WRITERS[kind]
    for i, (h, w) in enumerate(SIDES + [BIG]):
        path = tmp_path / f"{kind}_{h}x{w}.tif"
        write(path, h, w, i)
        want = jax_read_image(path, cv2_branch=cv2_branch)
        if (h, w) == BIG:
            _equal(tnative.decode_tiff(path), want, path.name)
        else:
            _equal(_all_three(path), want, path.name)
            _rgb_as_pil(path)


def test_big_image_numpy_decoder(tmp_path):
    path = tmp_path / "big.tif"
    WRITERS["cv2_lzw_bgr"][0](path, *BIG, 3)
    _equal(tiff.read_tiff(path), jax_read_image(path, cv2_branch=True), "big")


def test_planar2_uncompressed_16bit_departs_from_pil(lib, tmp_path):
    """PIL reads each plane of an uncompressed planar-2 16-bit file as 8
    bits; the port reads the planes as the format says, as PIL does for
    the same samples deflated."""
    s16 = FX.scene(9, 13, 3, 2).astype(np.uint16) * 257
    raw, packed = tmp_path / "raw.tif", tmp_path / "deflate.tif"
    FX.write_tiff(raw, s16, planar=2)
    FX.write_tiff(packed, s16, planar=2, compression="deflate")
    want = jax_read_image(packed, cv2_branch=False)
    _equal(_all_three(raw), want, "raw")
    assert not np.array_equal(jax_read_image(raw, cv2_branch=False), want)


# --------------------------------------------------------- orientation

@pytest.mark.parametrize("o", range(1, 9))
@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_orientation_tag_as_cv2_and_pil(lib, tmp_path, kind, o):
    """cv2 (8-bit kinds) and PIL 12 (the PIL branch) turn the image by tags
    2-4; OpenCV 4.6 turns it by 5-8 too, where cv2 5.0 reads nothing: the
    cv2 branch takes 4.6's turn, the PIL branch (PIL reads those with
    their sides swapped) raises."""
    arr = FX.scene(7, 12, 3, o)
    if kind == "gray16":
        arr = arr[..., 0].astype(np.uint16) * 257
    path = tmp_path / f"{kind}_{o}.tif"
    FX.write_tiff(path, arr, orientation=o)
    cv2_branch = kind == "rgb8"
    if o >= 5 and not cv2_branch:
        for read in (tv._read_image, tnative.decode_tiff, tiff.read_tiff):
            with pytest.raises(NotImplementedError, match="orientation"):
                read(str(path))
        return
    got = _all_three(path)
    if o >= 5:
        assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
        _equal(got, np.ascontiguousarray(_turned(arr, o)), path.name)
        assert tiff.tiff_size(path) == Image.open(path).size == (7, 12)
    else:
        _equal(got, jax_read_image(path, cv2_branch=cv2_branch), path.name)
        assert tiff.tiff_size(path) == Image.open(path).size == (12, 7)


# ------------------------------------------------------- damage, scope

def _strip_tags(data: bytes) -> dict:
    """tag -> the position of its IFD entry, in a classic II TIFF."""
    pos = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, pos)[0]
    at = {}
    for e in range(pos + 2, pos + 2 + 12 * n, 12):
        at[struct.unpack_from("<H", data, e)[0]] = e
    return at


def _file(tmp_path, name, arr, **kw) -> bytes:
    path = tmp_path / f"{name}.tif"
    FX.write_tiff(path, arr, **kw)
    return path.read_bytes()


def _set_count(data: bytes, value: int) -> bytes:
    e = _strip_tags(data)[279]
    return data[:e + 8] + struct.pack("<I", value) + data[e + 12:]


def _damaged(tmp_path, kind) -> tuple[bytes, str]:
    """The bytes of a damaged file and what cv2 makes of it: "none" (no
    image), "fills" (libtiff fills the broken strip with what it decoded
    and zeros, each version its own way) or "reads" (libtiff takes a single
    strip's bogus byte count for the rows' size)."""
    rgb = FX.scene(16, 12, 3, 5)
    if kind.startswith("lzw"):
        ok, enc = cv2.imencode(".tif", rgb, LZW)
        data = enc.tobytes()
        tags = _strip_tags(data)
        off = struct.unpack_from("<I", data, tags[273] + 8)[0]
        cnt = struct.unpack_from("<I", data, tags[279] + 8)[0]
        if kind == "lzw_bad_code":      # 24 one bits hold a whole code
            bad = bytearray(data)       # past the table's end
            bad[off + cnt // 3:off + cnt // 3 + 3] = b"\xff\xff\xff"
            return bytes(bad), "fills"
        return _set_count(data, cnt // 2), "fills"          # lzw_short
    comp, what = kind.split("_", 1)
    strips = 4 if what.endswith("strips") else None
    data = _file(tmp_path, kind, rgb, rows_per_strip=strips, compression={
        "raw": "none", "deflate": "deflate", "packbits": "packbits"}[comp])
    if what.startswith("past_end"):
        e = _strip_tags(data)[279]
        n = struct.unpack_from("<I", data, e + 4)[0]
        at = struct.unpack_from("<I", data, e + 8)[0] if n > 1 else e + 8
        last = at + 4 * (n - 1)
        data = data[:last] + struct.pack("<I", len(data)) + data[last + 4:]
        return data, "reads" if comp == "raw" and not strips else "none"
    cnt = struct.unpack_from("<I", data, _strip_tags(data)[279] + 8)[0]
    return _set_count(data, cnt // 2), "fills"                # short


DAMAGE = ["lzw_bad_code", "lzw_short", "deflate_short", "packbits_short",
          "raw_past_end", "raw_past_end_strips", "deflate_past_end",
          "packbits_past_end"]


@pytest.mark.parametrize("kind", DAMAGE)
def test_damaged_file_raises_in_both_decoders(lib, tmp_path, kind):
    """A strip past the end of the file: cv2 reads nothing and the port
    raises, both decoders naming the same cause. Compressed data that stops
    short or holds a bad LZW code: libtiff keeps what came before the
    fault, zeros after, and both decoders give cv2's pixels. A single
    uncompressed strip with a bogus byte count decodes as cv2 decodes
    it."""
    data, cv2_does = _damaged(tmp_path, kind)
    path = tmp_path / f"bad_{kind}.tif"
    path.write_bytes(data)
    read = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert (read is None) == (cv2_does == "none")
    if cv2_does != "none":
        _equal(_all_three(path), read[..., ::-1], kind)
        return
    with pytest.raises(ValueError) as a:
        tnative.decode_tiff(path)
    with pytest.raises(ValueError) as b:
        tiff.read_tiff(path)
    cause = lambda e: str(e.value).split(": ", 1)[1].split(" (")[0]
    assert str(path) in str(a.value) and cause(a) == cause(b)


@pytest.mark.parametrize("name", sorted(DAMAGED_STRIPS))
def test_damaged_strips_read_as_jax(lib, tmp_path, name):
    """A cut or garbled strip or tile (LZW, PackBits, deflate; strips and
    tiles; predictor 2; RGB, gray, palette, 1- and 16-bit): the three
    reads give JAX's `_read_image` under the branch the table names
    (cv2's fill of the strip, PIL's failure), and `read_tiff_rgb` fails
    where PIL's `convert("RGB")` fails."""
    path = damaged_tiff(tmp_path, name)
    try:
        want = jax_read_image(path, cv2_branch=_cv2_branch(path))
    except Exception:
        want = None
    if want is None:
        for read in (tv._read_image, tnative.decode_tiff, tiff.read_tiff):
            with pytest.raises(ValueError, match="(data ends|broken)"):
                read(str(path))
    else:
        _equal(_all_three(path), want, name)
    _rgb_as_pil(path)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_damaged_fixtures_decode_alike_in_both_decoders(lib, tmp_path,
                                                        name):
    """Fixtures with bytes overwritten or cut, from a seed: the C++ decoder
    gives the numpy decoder's pixels, or an error of its type naming the
    same cause."""
    good = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(sum(good[-64:]))
    for k in range(12):
        data = bytearray(good)
        if k % 3 == 2:
            data = data[:int(rng.integers(8, len(data)))]
        else:
            top = min(len(data), 400) if k % 3 == 0 else len(data)
            for i in rng.integers(8, top, int(rng.integers(1, 6))):
                data[i] = int(rng.integers(256))
        path = tmp_path / f"{k}.tif"
        path.write_bytes(bytes(data))
        try:
            want = tiff.read_tiff(path)
        except (ValueError, NotImplementedError) as e:
            with pytest.raises(type(e)) as got:
                tnative.decode_tiff(path)
            cause = lambda m: str(m).split(": ", 1)[-1].split(" (")[0]
            assert cause(got.value) == cause(e), (name, k, got.value, e)
            continue
        _equal(tnative.decode_tiff(path), want, (name, k))


def test_16bit_palette_is_refused_as_every_reader_refuses(lib, tmp_path):
    """Neither libtiff (cv2) nor PIL reads a 16-bit palette: every read of
    the port raises, and the scan marks the file corrupt."""
    path = tmp_path / "pal16.tif"
    rng = np.random.default_rng(16)
    FX.write_tiff(path, rng.integers(0, 1 << 16, (12, 11), np.uint16),
                    photometric=3, colormap=rng.integers(0, 1 << 16,
                                                         (1 << 16, 3)))
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    assert pil_scan(path) is None
    for read in (tv._read_image, tnative.decode_tiff, tiff.read_tiff,
                 tiff.read_tiff_rgb, tv.verify_image, tv.image_size):
        with pytest.raises(ValueError):
            read(str(path))


@pytest.mark.parametrize("side,dtype,what", [
    (14000, np.uint16, "more than its"),           # PIL's branch
    (40000, np.uint8, "image too large")])         # cv2's
def test_sizes_are_bounded_as_pil_and_opencv(lib, tmp_path, side, dtype,
                                             what):
    """A header that claims side x side pixels in one strip of one byte:
    the scan fails as PIL's open fails (above 2 x 89478485), the reads
    before a pixel is allocated, at OpenCV's 2^30 or else at the bytes the
    file holds (a TIFF's strips bound its pixels before PIL's limit
    counts)."""
    path = tmp_path / "big.tif"
    FX.write_tiff(path, np.zeros((1, 1), dtype))
    data = bytearray(path.read_bytes())
    at = _strip_tags(bytes(data))
    for tag in (256, 257, 278):
        struct.pack_into("<I", data, at[tag] + 8, side)
    path.write_bytes(bytes(data))
    assert pil_scan(path) is None
    for read in (tv.verify_image, tv.image_size):
        with pytest.raises(ValueError, match="decompression bomb"):
            read(str(path))
    for read in (tv._read_image, tnative.decode_tiff, tiff.read_tiff):
        with pytest.raises(ValueError, match=what):
            read(str(path))


def _out_of_scope(tmp_path) -> dict:
    """what -> a file of a kind the port does not read (ROADMAP Queue 1)."""
    rgb = FX.scene(16, 16, 3, 1)
    files = {}

    def pil_file(name, img, **kw):
        b = io.BytesIO()
        img.save(b, format="TIFF", **kw)
        files[name] = b.getvalue()

    def own_file(name, arr, **kw):
        p = tmp_path / "own.tif"
        FX.write_tiff(p, arr, **kw)
        files[name] = p.read_bytes()

    pil_file("CCITT Group 4 (4)", Image.fromarray(rgb).convert("1"),
             compression="group4")
    pil_file("JPEG compression under photometric 5",
             Image.fromarray(rgb).convert("CMYK"), compression="jpeg")
    pil_file("photometric CIELab (8)", Image.fromarray(rgb).convert("LAB"))
    pil_file("a palette and an extra sample", Image.fromarray(rgb).convert(
        "PA"))
    own_file("16-bit gray and an extra sample",
             np.zeros((16, 16, 2), np.uint16), extra_samples=[2])
    own_file("old-style JPEG (6)", rgb, compression=6,
             chunks=[b"\xff\xd8\xff\xd9"])
    own_file("YCbCr subsampling 4 x 2", rgb, photometric=6,
             extra_tags={530: (3, [4, 2])})
    own_file("planar configuration 2 under photometric 6", rgb,
             photometric=6, planar=2, extra_tags={530: (3, [1, 1])})
    own_file("orientation 3 with photometric 1 and 32-bit samples",
             rgb[..., 0].astype(np.float32), orientation=3)
    own_file("uncompressed tiles under FillOrder 2", rgb, fill_order=2,
             tile=(16, 16))
    data = bytearray(_file(tmp_path, "old", rgb[..., 0]))
    off = struct.unpack_from("<I", data, _strip_tags(data)[273] + 8)[0]
    data[off:off + 2] = b"\x00\x01"
    e = _strip_tags(bytes(data))[259]
    data[e + 8:e + 10] = struct.pack("<H", 5)
    files["old-style LZW"] = bytes(data)
    return files


def _add_tag(data: bytes, tag: int, value: int) -> bytes:
    """A classic II TIFF with one more SHORT tag (the IFD rewritten at the
    end of the file)."""
    pos = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, pos)[0]
    entries = [data[e:e + 12] for e in range(pos + 2, pos + 2 + 12 * n, 12)]
    entries.append(struct.pack("<HHIHH", tag, 3, 1, value, 0))
    entries.sort(key=lambda b: struct.unpack_from("<H", b)[0])
    ifd = struct.pack("<H", n + 1) + b"".join(entries) + bytes(4)
    body = data + bytes(len(data) % 2)
    return body[:4] + struct.pack("<I", len(body)) + body[8:] + ifd


SCOPE = ["CCITT Group 4 (4)", "JPEG compression under photometric 5",
         "photometric CIELab (8)", "a palette and an extra sample",
         "16-bit gray and an extra sample", "old-style JPEG (6)",
         "YCbCr subsampling 4 x 2",
         "planar configuration 2 under photometric 6",
         "orientation 3 with photometric 1 and 32-bit samples",
         "uncompressed tiles under FillOrder 2", "old-style LZW"]


@pytest.mark.parametrize("what", SCOPE)
def test_out_of_scope_kinds_raise_naming_them(lib, tmp_path, what):
    path = tmp_path / "x_co.tif"
    path.write_bytes(_out_of_scope(tmp_path)[what])
    for read in (tv._read_image, tnative.decode_tiff, tiff.read_tiff):
        with pytest.raises(NotImplementedError, match=what.replace(
                "(", r"\(").replace(")", r"\)")):
            read(str(path))


def test_decoder_is_the_host_library_without_fallback(tmp_path, monkeypatch):
    """Where the host library does not build, `_read_image` raises with
    the compiler's words; it does not fall back to the numpy decoder."""
    path = tmp_path / "a.tif"
    FX.write_tiff(path, FX.scene(8, 8, 3, 0))
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "tiff.cpp").write_text("int broken(\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    with pytest.raises(RuntimeError, match="tiff.cpp:") as e:
        tv._read_image(str(path))
    assert "TIFF decoder" in str(e.value) and "unavailable" in str(e.value)


# ------------------------------------------------------ PIL's header walk

def _header_cases(good: bytes) -> dict:
    pos = struct.unpack_from("<I", good, 4)[0]
    tags = _strip_tags(good)
    return {
        "good": good,
        "cut_header": good[:6],
        "ifd_past_end": good[:4] + struct.pack("<I", len(good) + 10)
        + good[8:],
        "no_ifd": good[:4] + bytes(4) + good[8:],
        "ifd_cut": good[:pos + 40],
        "entry_count_too_big": good[:pos] + struct.pack("<H", 200)
        + good[pos + 2:],
        "no_width": good[:tags[256]] + struct.pack("<H", 999)
        + good[tags[256] + 2:],
        "unknown_compression": good[:tags[259] + 8] + struct.pack(
            "<H", 9999) + good[tags[259] + 10:],
        "bits_tag_past_end": good[:tags[258] + 8] + struct.pack(
            "<I", len(good) - 2) + good[tags[258] + 12:],
        "no_strips": good[:tags[273]] + struct.pack("<H", 998)
        + good[tags[273] + 2:],
        "signature": b"II*\x01" + good[4:],
    }


HEADER_KINDS = ["good", "cut_header", "ifd_past_end", "no_ifd", "ifd_cut",
                "entry_count_too_big", "no_width", "unknown_compression",
                "bits_tag_past_end", "no_strips", "signature", "small",
                "narrow", "bigtiff_mm", "orientation6"]


@pytest.mark.parametrize("kind", HEADER_KINDS)
def test_verify_and_size_follow_jax_scan(tmp_path, kind):
    h, w = {"small": (9, 30), "narrow": (40, 9)}.get(kind, (12, 14))
    rgb = FX.scene(h, w, 3, 1)
    path = tmp_path / f"{kind}.tif"
    if kind == "bigtiff_mm":
        FX.write_tiff(path, rgb, bigtiff=True, byteorder=">")
    elif kind == "orientation6":
        FX.write_tiff(path, rgb, orientation=6)
    else:
        FX.write_tiff(path, rgb)
        cases = _header_cases(path.read_bytes())
        if kind in cases:
            path.write_bytes(cases[kind])
    want = pil_scan(path)
    if want is None:
        with pytest.raises(Exception):
            tv.verify_image(str(path))
    else:
        tv.verify_image(str(path))
        assert tv.image_size(str(path)) == want == tiff.tiff_size(path)


def test_size_equals_pil_across_fixtures():
    for name in FIXTURE_FILES:
        path = FIXTURES / name
        try:
            with Image.open(path) as im:
                want = im.size
        except Exception:                   # a big-endian BigTIFF
            with pytest.raises(ValueError):
                tv.image_size(str(path))
            continue
        assert tv.image_size(str(path)) == want, name


def test_write_tiff_reads_back_everywhere(lib, tmp_path):
    """The port's writer: RGB and gray, 8 and 16 bits, one strip or tiles,
    each compression, predictor 2 with deflate."""
    rgb = FX.scene(21, 13, 3, 6)
    for arr in (rgb, rgb[..., 1], rgb.astype(np.uint16) * 257):
        for comp in ("none", "deflate", "packbits"):
            for kw in ({}, {"tile": (16, 16)}) + (
                    ({"predictor": 2}, {"predictor": 2, "tile": (16, 32)})
                    if comp == "deflate" else ()):
                path = tmp_path / f"{arr.ndim}{arr.dtype}_{comp}_{kw}.tif"
                tiff.write_tiff(path, arr, compression=comp, **kw)
                want = arr if arr.ndim == 3 else arr[..., None]
                if arr.dtype == np.uint16:       # PIL's branch: high bytes
                    want = (arr >> 8).astype(np.uint8)
                _equal(_all_three(path), want, path.name)
                read = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
                _equal(read if read.ndim == 2 else read[..., ::-1], arr,
                       path.name)
                if arr.dtype == np.uint8:
                    _equal(np.asarray(Image.open(path)), arr, path.name)


def test_image_format_knows_bigtiff(tmp_path):
    """BigTIFF's signatures (II+\\0, MM\\0+) are TIFF, as cv2 and PIL
    read them; a `.dng` with a TIFF signature is DNG."""
    for bo in "<>":
        path = tmp_path / f"big{bo == '>'}.tif"
        FX.write_tiff(path, FX.scene(12, 10, 3, 2), bigtiff=True,
                        byteorder=bo)
        assert tv.image_format(str(path)) == "TIFF"
        assert cv2.imread(str(path)) is not None
    dng = tmp_path / "x.dng"
    dng.write_bytes((tmp_path / "bigFalse.tif").read_bytes())
    assert tv.image_format(str(dng)) == "DNG"


# ----------------------------------------------------------------- DNG

DNG_VERSION = {50706: (1, [1, 4, 0, 0])}


def _lossy_dng(path: Path) -> None:
    """The file at `path` with its Compression tag made 34892 (DNG 1.4's
    lossy JPEG, which libtiff has no decoder for)."""
    d = bytearray(path.read_bytes())
    bo = "<" if d[:2] == b"II" else ">"
    ifd = struct.unpack(bo + "I", d[4:8])[0]
    for i in range(struct.unpack(bo + "H", d[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * i
        if struct.unpack(bo + "H", d[e:e + 2])[0] == 259:
            d[e + 8:e + 10] = struct.pack(bo + "H", 34892)
    path.write_bytes(bytes(d))


def _write_dng(kind: str, path: Path) -> None:
    """A DNG's IFD0 of each kind: a plain TIFF named .dng, a DNG's preview
    (DNGVersion, NewSubFileType 1, SubIFDs naming the raw), a JPEG YCbCr
    preview, IFD0s under compression 34892 (libtiff's RGBA reader, through
    which cv2 reads 8-bit RGB, gray and YCbCr, leaves each strip zeros),
    and the raw IFD0s no reader develops (CFA, LinearRaw)."""
    rgb = FX.scene(16, 24, 3, 5)
    if kind.startswith("lossy34892"):
        inner = kind.split("_", 1)[1]
        if inner == "ycc":
            FX.write_jpeg_tiff(path, rgb)
        else:
            FX.write_tiff(path, {"rgb": rgb, "gray": rgb[..., 0],
                                 "gray16": rgb[..., 0].astype(np.uint16)
                                 * 200}[inner], compression="deflate",
                          extra_tags=DNG_VERSION)
        _lossy_dng(path)
    elif kind == "plain":
        FX.write_tiff(path, rgb)
    elif kind == "preview":
        FX.write_tiff(path, rgb, compression="deflate", extra_tags={
            **DNG_VERSION, 254: (4, [1]), 330: (4, [8])})
    elif kind == "jpeg_preview":
        FX.write_jpeg_tiff(path, rgb)
    elif kind == "cfa16":
        FX.write_tiff(path, rgb[..., 0].astype(np.uint16) * 200,
                      photometric=32803, extra_tags={
                          **DNG_VERSION, 33421: (3, [2, 2]),
                          33422: (1, [0, 1, 1, 2])})
    else:
        FX.write_tiff(path, rgb.astype(np.uint16 if kind == "linear16"
                                       else np.uint8),
                      photometric=34892, extra_tags=DNG_VERSION)


def _jax_scan(path):
    try:
        with Image.open(path) as im:
            im.verify()
            w, h = im.size
            assert w > 9 and h > 9
            return w, h
    except Exception:
        return None


@pytest.mark.parametrize("kind", ["plain", "preview", "jpeg_preview",
                                  "lossy34892_ycc", "lossy34892_rgb",
                                  "lossy34892_gray"])
def test_dng_reads_as_its_ifd0_tiff(lib, tmp_path, kind):
    """cv2 and PIL read a DNG as a TIFF, its IFD0 alone: JAX's array, size
    and scan verdict, PIL's `convert("RGB")` for the boxes, and JAX's
    OpenCV 4.6 tile. Under compression 34892 cv2 reads zeros through the
    RGBA reader (YCbCr zeros as their RGB), and PIL opens nothing."""
    from sodt_tpu.data import native_loader as jnative
    from sodt_tpu.data import vedai as jv
    path = tmp_path / f"{kind}_co.dng"
    _write_dng(kind, path)
    assert tv.image_format(str(path)) == "DNG"
    _equal(tv._read_image(str(path)), jv._read_image(str(path)), kind)
    if kind.startswith("lossy34892"):
        assert _jax_scan(path) is None
        with pytest.raises(ValueError):
            tv.verify_image(str(path))
        with pytest.raises(ValueError):
            tiff.read_tiff_rgb(path)
    else:
        assert tv.image_size(str(path)) == _jax_scan(path)
        tv.verify_image(str(path))
        with Image.open(path) as im:
            _equal(tiff.read_tiff_rgb(path), np.asarray(im.convert("RGB")),
                   kind)
    tiles = []
    for mod in (tnative, jnative):
        loader = mod.NativeTileLoader([str(path)], [str(path)], 64)
        try:
            tiles.append(loader.get(np.asarray([0])))
        finally:
            loader.close()
    for got, want in zip(*tiles):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["cfa16", "linear8", "linear16",
                                  "lossy34892_gray16"])
def test_raw_dng_fails_where_cv2_and_pil_fail(lib, tmp_path, kind):
    """A raw IFD0 (CFA, LinearRaw), or 16-bit samples under compression
    34892 (read outside the RGBA reader): cv2 reads no image (JAX raises
    FileNotFoundError), PIL identifies none (the scan marks it corrupt),
    JAX's 4.6 loader fails the job; the port raises naming the kind, its
    scan marks it corrupt, its job fails."""
    from sodt_tpu.data import native_loader as jnative
    from sodt_tpu.data import vedai as jv
    path = tmp_path / f"{kind}_co.dng"
    _write_dng(kind, path)
    with pytest.raises(FileNotFoundError):
        jv._read_image(str(path))
    with pytest.raises(ValueError, match="raw DNG image" if "lossy" not in
                       kind else "compression 34892"):
        tv._read_image(str(path))
    assert _jax_scan(path) is None
    with pytest.raises(ValueError):
        tv.verify_image(str(path))
    for mod in (tnative, jnative):
        loader = mod.NativeTileLoader([str(path)], [str(path)], 64)
        try:
            with pytest.raises(RuntimeError, match="failed to decode"):
                loader.get(np.asarray([0]))
        finally:
            loader.close()


# ------------------------------------------------------------- folders

def test_extract_boxes_crops_equal_jax(lib, tmp_path):
    """`tools boxes` on a TIFF set (LZW, tiles, palette, 16-bit, alpha)
    writes JAX's crops, byte for byte."""
    from sodt_tpu.data import tools as jtools
    from sodt_tpu_torch.data import tools
    root = tmp_path / "set"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, name in enumerate(["lzw_rgb.tif", "deflate_tiles_pred.tif",
                              "palette8.tif", "rgb16_tiles.tif",
                              "rgba_associated.tif", "gray16_mm_pred.tif"]):
        (root / "images" / f"{i}_co.tiff").write_bytes(
            (FIXTURES / name).read_bytes())
        np.savetxt(root / "labels" / f"{i}.txt", [[i % 3, 0.4, 0.5, 0.5, 0.6],
                                                  [1, 0.8, 0.3, 0.3, 0.3]],
                   fmt="%.6f")
    files = lambda d: {p.relative_to(d): p.read_bytes()
                       for p in sorted(Path(d).rglob("*")) if p.is_file()}
    want = files(jtools.extract_boxes(str(root)))
    got = files(tools.extract_boxes(str(root)))
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The PNG VEDAI folder's pairs as TIFF: deflate, predictor 2, tiles of
    64 x 128."""
    return folder_as(tmp_path_factory, "tif", lambda p, img: tiff.write_tiff(
        p, img, compression="deflate", predictor=2, tile=(64, 128)))


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_tiff_folder_batches_equal_jax(lib, folder, rect):
    batches_equal_jax(folder, rect)


def test_tiff_folder_val_matches_jax(lib, folder, tmp_path, one_torch_thread):
    val_equals_jax(folder, tmp_path)


@pytest.fixture(scope="module")
def aerial_folder(tmp_path_factory):
    """The PNG VEDAI folder's pairs as aerial imagery ships them: RGB as
    YCbCr 4:2:0 JPEG in tiles (the port's writer: JPEGTables, PIL's
    encoder), IR as float32 samples under the floating-point predictor
    (the 8-bit values, deflated)."""
    def write(p, img):
        if img.ndim == 3:
            tiff.write_tiff(p, img, compression="jpeg", tile=(256, 256))
        else:
            tiff.write_tiff(p, img.astype(np.float32), compression="deflate",
                            predictor=3)
    return folder_as(tmp_path_factory, "tif", write)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_aerial_folder_items_and_batches_equal_jax(lib, aerial_folder, rect):
    """JAX's VedaiDataset items and eval batches, bit-equal, dtypes
    included: float32 IR items, which JAX's eval step does not scale, and
    the rect batches' uint8 letterbox of them."""
    from sodt_tpu.data.vedai import VedaiDataset as JDS
    from sodt_tpu_torch.data import VedaiDataset as TDS
    lst = str(aerial_folder["val_list"])
    j, t = JDS(lst, img_size=256), TDS(lst, img_size=256)
    for i in range(len(j)):
        for a, b in zip(t[i], j[i]):
            _equal(a, b, i)
        assert t[i][1].dtype == np.float32
    batches_equal_jax(aerial_folder, rect)


def test_aerial_folder_val_matches_jax(lib, aerial_folder, tmp_path,
                                       one_torch_thread):
    val_equals_jax(aerial_folder, tmp_path)


def test_write_tiff_jpeg_and_float_read_back_as_cv2(lib, tmp_path):
    """The port's writer: JPEG (RGB as YCbCr 4:2:0, gray; one strip or
    tiles) reads back through cv2 to the port's decode, float32 under
    predictor 3 to its samples, bit for bit."""
    rgb = FX.scene(45, 61, 3, 8)
    for arr, kw in ((rgb, {}), (rgb, {"tile": (32, 16)}), (rgb[..., 0], {})):
        path = tmp_path / f"{arr.ndim}_{kw}.tif"
        tiff.write_tiff(path, arr, compression="jpeg", **kw)
        got = _all_three(path)
        _equal(got, jax_read_image(path, cv2_branch=True), path.name)
        assert np.abs(got.astype(int) - (arr if arr.ndim == 3 else arr[
            ..., None])).mean() < 20      # quality 75 on a noisy scene
    f = (rgb[..., 0] / np.float32(3)).astype(np.float32)
    path = tmp_path / "f.tif"
    tiff.write_tiff(path, f, compression="deflate", predictor=3)
    _equal(_all_three(path), f[..., None], "float32")
    _equal(jax_read_image(path, cv2_branch=True), f[..., None], "float32")


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_scan_marks_fixtures_as_jax(name):
    """JAX's integrity scan (PIL's open and verify, the 10 px assert) on
    each fixture, new kinds included: PIL opens the float, `I` and CMYK
    kinds it knows and no float or integer colour; `verify_image` raises
    where the scan marks the file corrupt."""
    path = FIXTURES / name
    want = pil_scan(path)
    if want is None:
        with pytest.raises(Exception):
            tv.verify_image(str(path))
    else:
        tv.verify_image(str(path))
        assert tv.image_size(str(path)) == want


@pytest.mark.parametrize("case", ["last_strip_full_height", "strip_too_tall",
                                  "strip_too_narrow"])
def test_jpeg_strip_frame_sizes_as_libtiff(lib, tmp_path, case):
    """libtiff takes a last strip whose JPEG frame keeps the full
    RowsPerStrip (decoded as cv2 decodes it) and refuses a frame taller
    than its strip elsewhere (cv2 reads nothing); a narrower frame it only
    warns of and reads on, which the port does not follow. In both
    refusals the two decoders raise naming the sizes, before the frame is
    decoded."""
    rgb = FX.scene(40, 24, 3, 4)
    rows = 16
    blocks = [rgb[y:y + rows] for y in range(0, 40, rows)]
    if case == "last_strip_full_height":
        blocks[-1] = np.pad(blocks[-1], ((0, rows - len(blocks[-1])), (0, 0),
                                         (0, 0)), mode="edge")
    elif case == "strip_too_tall":
        blocks[0] = rgb[:rows + 8]
    else:
        blocks[1] = blocks[1][:, :16]
    tables, chunks = FX.jpeg_chunks(rgb, blocks, 2)
    path = tmp_path / f"{case}.tif"
    FX.write_tiff(path, rgb, compression=7, rows_per_strip=rows,
                  photometric=6, chunks=chunks,
                  extra_tags={530: (3, [2, 2]), 347: (7, tables)})
    read = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if case == "last_strip_full_height":
        _equal(_all_three(path), read[..., ::-1], case)
        return
    assert (read is None) == (case == "strip_too_tall")
    for decode in (tnative.decode_tiff, tiff.read_tiff):
        with pytest.raises(ValueError, match="a JPEG strip or tile of"):
            decode(path)
