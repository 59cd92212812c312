"""The port's BMP code against the JAX package's readers on the CPU:

  * `_read_image` (the C++ decoder of `csrc/bmp.cpp`, built here with the
    host compiler) and `data/bmp.py`'s numpy decoder bit-equal to JAX's
    `_read_image` under the branch `bmp.py`'s table names (cv2 for 24 and
    32 bits, PIL for palettes and 16 bits) on every checked-in fixture
    (`tests/torch_port_bmp_tiff/`, made by its `make_fixtures.py`) and on
    files written by cv2, PIL and the fixtures' script at sides from 1 to
    about 1000 px, rows not a multiple of 4 bytes;
  * RLE8 / RLE4 as OpenCV walks them (deltas, early ends), and as PIL where
    PIL reads them soundly; the stated departures from PIL;
  * damaged files raise where cv2 returns no image, both decoders alike;
    BI_JPEG / BI_PNG raise NotImplementedError naming themselves;
  * `bmp_size` / `image_size` equal to PIL's `size`, `verify_image`
    raising where JAX's scan marks a file corrupt;
  * `tools boxes` crops of a BMP folder byte-equal to JAX's, and a VEDAI
    folder written as BMP giving JAX's eval batches and JAX's `val` mAP.
"""

from __future__ import annotations

import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image

from sodt_tpu_torch.data import bmp
from sodt_tpu_torch.data import native_loader as tnative
from sodt_tpu_torch.data import vedai as tv
from sodt_tpu_torch.kernels import _build
from torch_port_common import (batches_equal_jax, folder_as,  # noqa: F401
                               jax_read_image, one_torch_thread, pil_scan,
                               val_equals_jax)

FIXTURES = Path(__file__).resolve().parent / "torch_port_bmp_tiff"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.bmp"))
SIDES = [(1, 1), (2, 3), (10, 11), (17, 5), (37, 53), (123, 157)]
BIG = (997, 731)
# RLE fixtures: PIL reads a delta as four bytes and drops the last pixel of
# an odd RLE4 literal (module doc), so they are held to cv2's colours
RLE = {"rle8.bmp", "rle4.bmp"}


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


def _branch(path) -> bool:
    """Whether `bmp.py`'s table reads the file through cv2 (else PIL)."""
    hd = bmp._parse(Path(path).read_bytes(), str(path))
    return hd.bpp > 16


def _equal(got, want, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _all_three(path) -> np.ndarray:
    """The port's three reads of a file, held equal: `_read_image` (C++,
    picked by the signature), `decode_bmp` and the numpy `read_bmp`."""
    got = tv._read_image(str(path))
    _equal(tnative.decode_bmp(path), got, path)
    _equal(bmp.read_bmp(path), got, path)
    return got


def _cv2_rgb(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img[..., ::-1] if img.ndim == 3 else np.repeat(img[..., None], 3,
                                                          -1)


# -------------------------------------------------------------- decode

@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_decodes_as_jax(lib, name):
    """Each checked-in file through the port's three reads; the JAX read of
    the branch the table names; PIL's `convert("RGB")` for `read_bmp_rgb`."""
    path = FIXTURES / name
    got = _all_three(path)
    if name in RLE:              # indices, shown through the palette
        hd, _ = bmp._load(path)
        _equal(hd.palette[got[..., 0]], _cv2_rgb(path), name)
        _equal(bmp.read_bmp_rgb(path), _cv2_rgb(path), name)
        return
    _equal(got, jax_read_image(path, cv2_branch=_branch(path)), name)
    _rgb_as_pil(path)


def _rgb_as_pil(path):
    """`read_bmp_rgb` is PIL's `convert("RGB")`, or raises where PIL does
    not open the file (masks it has no mode for)."""
    try:
        want = np.asarray(Image.open(path).convert("RGB"))
    except OSError:
        with pytest.raises(ValueError, match="bitfields layout"):
            bmp.read_bmp_rgb(path)
        return
    _equal(bmp.read_bmp_rgb(path), want, path)


def test_fixtures_are_the_scripts():
    """The checked-in BMP files are what `make_fixtures.py` builds."""
    made = FX.bmp_fixtures()
    assert sorted(f"{n}.bmp" for n in made) == FIXTURE_FILES
    for name, data in made.items():
        assert (FIXTURES / f"{name}.bmp").read_bytes() == data, name
        assert len(data) < 8192


def _writers() -> dict:
    """kind -> (write(path, h, w, seed), cv2 branch or not)."""
    def scene(h, w, c, seed):
        return FX.scene(h, w, c, seed)

    def pil(mode):
        def write(p, h, w, s):
            img = Image.fromarray(scene(h, w, 3, s))
            img = (img.convert("P") if mode == "P" else img.convert(mode))
            img.save(p)
        return write

    def hand(bpp, comp=0, header=40, masks=None, rle4=None):
        def write(p, h, w, s):
            rng = np.random.default_rng(s)
            pal = rng.integers(0, 256, (1 << min(bpp, 8), 3))
            idx = scene(h, w, 1, s)[..., 0] >> (8 - min(bpp, 8))
            if bpp == 16:
                px = rng.integers(0, 1 << 16, (h, w))
                rows = FX.pack_rows(px, 16)
            elif comp in (1, 2):
                rows = FX.rle(idx, comp == 2, literals=comp == 1)
            else:
                rows = FX.pack_rows(idx, bpp)
            p.write_bytes(FX.bmp(rows, w, h, bpp, comp=comp, header=header,
                                 palette=pal if bpp <= 8 else None,
                                 masks=masks))
        return write

    return {
        "rgb24_cv2": (lambda p, h, w, s: cv2.imwrite(
            str(p), scene(h, w, 3, s)), True),
        "gray8_cv2": (lambda p, h, w, s: cv2.imwrite(
            str(p), scene(h, w, 1, s)[..., 0]), False),
        "bgra32_cv2": (lambda p, h, w, s: cv2.imwrite(
            str(p), scene(h, w, 4, s)), True),
        "rgbx32_pil": (pil("RGBA"), True),
        "palette8_pil": (pil("P"), False),
        "bilevel_pil": (pil("1"), False),
        "palette4": (hand(4), False),
        "palette1": (hand(1), False),
        "rgb555": (hand(16), False),
        "bitfields565": (hand(16, 3, masks=(0xF800, 0x7E0, 0x1F)), False),
        "rle8": (hand(8, 1), False),
        "rle4_runs": (hand(4, 2), False),
    }


WRITERS = _writers()


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_generated_files_decode_as_jax(lib, tmp_path, kind):
    """C++ at every side up to ~1000 px, numpy as well below it."""
    write, cv2_branch = WRITERS[kind]
    for i, (h, w) in enumerate(SIDES + [BIG]):
        path = tmp_path / f"{kind}_{h}x{w}.bmp"
        write(path, h, w, i)
        want = jax_read_image(path, cv2_branch=cv2_branch)
        if (h, w) == BIG:
            _equal(tnative.decode_bmp(path), want, path.name)
        else:
            _equal(_all_three(path), want, path.name)
            _rgb_as_pil(path)


def test_big_image_numpy_decoder(tmp_path):
    path = tmp_path / "big.bmp"
    WRITERS["rle8"][0](path, *BIG, 3)
    _equal(bmp.read_bmp(path), jax_read_image(path, cv2_branch=False), "big")


# ------------------------------------------------------- RLE, departures

def _rle_file(path, stream: bytes, bpp: int, palette) -> Path:
    path.write_bytes(FX.bmp(stream, 7, 5, bpp, comp=1 if bpp == 8 else 2,
                            palette=palette))
    return path


PALETTE = [(200, 10, 30), (1, 2, 3)] + [(i, 255 - i, 7 * i % 256)
                                        for i in range(2, 256)]
STREAMS = {  # name -> (bits, stream); rows bottom-up, 7 x 5
    "eol_after_full_row": (8, bytes([7, 20, 0, 0, 7, 21, 0, 0, 0, 3, 30, 31,
                                     32, 0, 4, 33, 0, 0, 7, 34, 0, 0, 7, 35,
                                     0, 1])),
    "early_end": (8, bytes([7, 20, 0, 0, 7, 21, 0, 0, 0, 1])),
    "rows_without_eol": (8, bytes([7, 20, 7, 21, 7, 22, 0, 0, 0, 1])),
    "delta": (8, bytes([1, 11, 0, 2, 2, 1, 2, 12, 0, 0, 0, 1])),
    "rle4_odd_literal_delta": (4, bytes([
        7, 0x12, 0, 0, 0, 4, 0x34, 0x56, 3, 0x78, 0, 0, 0, 3, 0x9A, 0xB0,
        4, 0xCD, 0, 0, 7, 0xEF, 0, 0, 0, 2, 1, 0, 2, 0x11, 0, 1])),
    "rle4_even": (4, bytes([7, 0x12, 0, 0, 0, 6, 0x34, 0x56, 0x78, 0, 1,
                            0x9A, 0, 0, 7, 0xCD, 0, 0, 7, 0xEF, 0, 0, 7,
                            0x31, 0, 1])),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_rle_escapes_as_opencv(lib, tmp_path, name):
    """Runs, literals, end-of-line after a full row, rows without one,
    deltas and an early end-of-bitmap: the indices, through the palette,
    are cv2's colours (pixels no run sets keep index 0, as cv2 fills them
    with palette[0]); where PIL reads the stream (no delta, no odd RLE4
    literal, no early end) they are PIL's indices too."""
    bits, stream = STREAMS[name]
    path = _rle_file(tmp_path / f"{name}.bmp", stream, bits,
                     PALETTE[:1 << bits])
    got = _all_three(path)
    pal = np.asarray(PALETTE[:1 << bits] + [(0, 0, 0)] * 256, np.uint8)
    _equal(pal[got[..., 0]], _cv2_rgb(path), name)
    if name in ("eol_after_full_row", "rle4_even"):
        _equal(got, jax_read_image(path, cv2_branch=False), name)
    else:                                   # PIL misreads or refuses these
        try:
            pil = jax_read_image(path, cv2_branch=False)
        except Exception:
            return
        assert not np.array_equal(pil, got), name


def test_pil_gray_palette_departure(lib, tmp_path):
    """A 4-bit file of 16 gray entries (i, i, i): PIL takes it for mode "L"
    and reads 4-bit samples 8 bits wide; the port returns the indices,
    which here are cv2's gray levels."""
    idx = FX.scene(6, 9, 1, 4)[..., 0] >> 4
    path = tmp_path / "gray16.bmp"
    path.write_bytes(FX.bmp(FX.pack_rows(idx, 4), 9, 6, 4,
                            palette=[(i, i, i) for i in range(16)]))
    got = _all_three(path)
    _equal(got[..., 0], cv2.imread(str(path), cv2.IMREAD_UNCHANGED), "gray")
    assert not np.array_equal(got, jax_read_image(path, cv2_branch=False))


# ------------------------------------------------------- damage, scope

def _damage_cases() -> dict:
    """kind -> the bytes of a damaged file, each of which cv2 returns no
    image for."""
    good = FX.bmp(FX.pack_rows(FX.scene(12, 10, 3, 1), 24), 10, 12, 24)
    idx = FX.scene(5, 7, 1, 2)[..., 0] >> 4
    pal = PALETTE[:16]
    return {
        "truncated_pixels": good[:-7],
        "offset_past_end": good[:10] + struct.pack("<I", len(good) + 4)
        + good[14:],
        "rle_run_past_row": FX.bmp(bytes([9, 13, 0, 1]), 7, 5, 8, comp=1,
                                   palette=PALETTE),
        "rle_literal_past_row": FX.bmp(bytes([0, 8]) + bytes(8) + bytes(
            [0, 1]), 7, 5, 8, comp=1, palette=PALETTE),
        "rle_stream_cut": FX.bmp(FX.rle(idx, True)[:9], 7, 5, 4, comp=2,
                                 palette=pal),
        "rle4_run_past_row": FX.bmp(bytes([8, 0x12, 0, 1]), 7, 5, 4, comp=2,
                                    palette=pal),
        "bitfields_444": FX.bmp(FX.pack_rows(idx, 16), 7, 5, 16, comp=3,
                                masks=(0xF00, 0xF0, 0xF)),
        "bitfields_24": FX.bmp(FX.pack_rows(FX.scene(5, 7, 3, 1), 24), 7, 5,
                               24, comp=3, masks=(0xFF0000, 0xFF00, 0xFF)),
        "bits_2": FX.bmp(FX.pack_rows(idx % 4, 2), 7, 5, 2,
                         palette=pal[:4]),
        "rle8_with_4_bits": FX.bmp(FX.rle(idx, False), 7, 5, 4, comp=1,
                                   palette=pal),
        "header_size_20": good[:14] + struct.pack("<I", 20) + good[18:],
        "cut_header": good[:30],
    }


DAMAGE = _damage_cases()


@pytest.mark.parametrize("kind", sorted(DAMAGE))
def test_damaged_file_raises_where_cv2_reads_nothing(lib, tmp_path, kind):
    path = tmp_path / f"{kind}.bmp"
    path.write_bytes(DAMAGE[kind])
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(ValueError) as a:
        tnative.decode_bmp(path)
    with pytest.raises(ValueError) as b:
        bmp.read_bmp(path)
    assert str(path) in str(a.value) and str(path) in str(b.value)
    tail = lambda e: str(e.value).split(": ", 1)[1]
    assert tail(a) == tail(b)


@pytest.mark.parametrize("side,pil,opencv", [(13000, True, True),
                                             (14000, False, True),
                                             (40000, False, False)])
def test_rle_sizes_are_bounded_as_pil_and_opencv(lib, tmp_path, side, pil,
                                                 opencv):
    """An RLE8 bitmap of any size fits in two bytes (end of bitmap). PIL
    opens one of up to 2 x 89478485 pixels and OpenCV decodes one of up to
    2^30: the scan and the sizes follow PIL, the reads raise where their
    branch's library refuses, each before a pixel is allocated (no decode
    runs here below either bound)."""
    path = tmp_path / "big.bmp"
    path.write_bytes(FX.bmp(bytes([0, 1]), side, side, 8, comp=1,
                            palette=PALETTE))
    assert (pil_scan(path) is not None) == pil
    if pil:
        tv.verify_image(str(path))
        assert tv.image_size(str(path)) == Image.open(path).size
        return
    for read in (tv.verify_image, tv.image_size):
        with pytest.raises(ValueError, match="decompression bomb"):
            read(str(path))
    if not opencv:
        with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE_PIXELS"):
            cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    what = "image too large" if not opencv else "decompression bomb"
    for read in (tv._read_image, tnative.decode_bmp, bmp.read_bmp,
                 bmp.read_bmp_rgb):
        with pytest.raises(ValueError, match=what):
            read(str(path))


@pytest.mark.parametrize("comp,what", [(4, "embedded JPEG data"),
                                       (5, "embedded PNG data")])
def test_out_of_scope_kinds_raise_naming_them(lib, tmp_path, comp, what):
    path = tmp_path / "x_co.bmp"
    path.write_bytes(FX.bmp(b"\xff\xd8" + bytes(30), 4, 4, 24, comp=comp))
    for read in (tv._read_image, tnative.decode_bmp, bmp.read_bmp):
        with pytest.raises(NotImplementedError,
                           match=f"a BMP image with {what}"):
            read(str(path))


def test_decoder_is_the_host_library_without_fallback(tmp_path, monkeypatch):
    """Where the host library does not build, `_read_image` raises with
    the compiler's words; it does not fall back to the numpy decoder."""
    path = tmp_path / "a.bmp"
    cv2.imwrite(str(path), FX.scene(8, 8, 3, 0))
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "bmp.cpp").write_text("int broken(\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    with pytest.raises(RuntimeError, match="bmp.cpp:") as e:
        tv._read_image(str(path))
    assert "BMP decoder" in str(e.value) and "unavailable" in str(e.value)


# ------------------------------------------------------ PIL's header walk

HEADER_CASES = {
    "good": lambda g: g,
    "small": None,
    "narrow": None,
    "cut_header": lambda g: g[:40],
    "cut_pixels": lambda g: g[:-30],              # PIL's open reads none
    "offset_past_end": lambda g: g[:10] + struct.pack("<I", 99999) + g[14:],
    "header_size_20": lambda g: g[:14] + struct.pack("<I", 20) + g[18:],
    "zero_width": lambda g: g[:18] + struct.pack("<i", 0) + g[22:],
    "negative_height": lambda g: g[:22] + struct.pack("<i", -12) + g[26:],
    "bits_7": lambda g: g[:28] + struct.pack("<H", 7) + g[30:],
    "compression_9": lambda g: g[:30] + struct.pack("<I", 9) + g[34:],
    "bitfields_24": lambda g: g[:30] + struct.pack("<I", 3) + g[34:54]
    + struct.pack("<III", 0xFF0000, 0xFF00, 0xFF) + g[54:],
    "bitfields_odd_masks": lambda g: g[:30] + struct.pack("<I", 3) + g[34:54]
    + struct.pack("<III", 0xF00, 0xF0, 0xF) + g[54:],
    "signature": lambda g: b"BA" + g[2:],
}


@pytest.mark.parametrize("kind", sorted(HEADER_CASES))
def test_verify_and_size_follow_jax_scan(tmp_path, kind):
    h, w = {"small": (9, 30), "narrow": (40, 9)}.get(kind, (12, 14))
    good = FX.bmp(FX.pack_rows(FX.scene(h, w, 3, 1), 24), w, h, 24)
    data = HEADER_CASES[kind](good) if HEADER_CASES[kind] else good
    path = tmp_path / f"{kind}.bmp"
    path.write_bytes(data)
    want = pil_scan(path)
    if want is None:
        with pytest.raises(Exception):
            tv.verify_image(str(path))
    else:
        tv.verify_image(str(path))
        assert tv.image_size(str(path)) == want == bmp.bmp_size(path)


def test_size_equals_pil_across_fixtures():
    for name in FIXTURE_FILES:
        try:
            with Image.open(FIXTURES / name) as im:
                want = im.size
        except OSError:                   # masks PIL has no mode for
            with pytest.raises(ValueError):
                tv.image_size(str(FIXTURES / name))
            continue
        assert tv.image_size(str(FIXTURES / name)) == want, name


def test_write_bmp_reads_back_everywhere(lib, tmp_path):
    rgb = FX.scene(21, 13, 3, 6)
    for arr, name in ((rgb, "rgb"), (rgb[..., 0], "gray")):
        path = tmp_path / f"{name}.bmp"
        bmp.write_bmp(path, arr)
        want = arr if arr.ndim == 3 else arr[..., None]
        _equal(_all_three(path), want, name)
        _equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), arr[..., ::-1]
               if arr.ndim == 3 else arr, name)
        _equal(np.asarray(Image.open(path)), arr, name)


# ------------------------------------------------------------- folders

def test_extract_boxes_crops_equal_jax(lib, tmp_path):
    """`tools boxes` on a BMP set (24-bit, palette, 16-bit, RLE) writes
    JAX's crops, byte for byte."""
    from sodt_tpu.data import tools as jtools
    from sodt_tpu_torch.data import tools
    root = tmp_path / "set"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, name in enumerate(["rgb24.bmp", "pal8_short.bmp", "rgb555.bmp",
                              "v5_alpha.bmp", "core24.bmp"]):
        (root / "images" / f"{i}_co.bmp").write_bytes(
            (FIXTURES / name).read_bytes())
        np.savetxt(root / "labels" / f"{i}.txt", [[i % 3, 0.4, 0.5, 0.5, 0.6],
                                                  [1, 0.8, 0.3, 0.3, 0.3]],
                   fmt="%.6f")
    files = lambda d: {p.relative_to(d): p.read_bytes()
                       for p in sorted(Path(d).rglob("*")) if p.is_file()}
    want = files(jtools.extract_boxes(str(root)))
    got = files(tools.extract_boxes(str(root)))
    assert sorted(got) == sorted(want) and len(got) == 10
    for k in want:
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The PNG VEDAI folder's pairs as BMP files: `_co` 24-bit, `_ir`
    8-bit gray (as cv2 writes both)."""
    return folder_as(tmp_path_factory, "bmp", lambda p, img: bmp.write_bmp(
        p, img))


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_bmp_folder_batches_equal_jax(lib, folder, rect):
    batches_equal_jax(folder, rect)


def test_bmp_folder_val_matches_jax(lib, folder, tmp_path, one_torch_thread):
    val_equals_jax(folder, tmp_path)
