"""The port's tile loader (`csrc/tile_loader.cpp`, bound by
`data/native_loader.py`) on the CPU, built here with the host compiler:

  * every PNG variant (8-bit gray, gray+alpha, RGB, RGBA with every row
    filter; Adam7; palette of 1-8 bits with and without tRNS; 1-, 2- and
    4-bit gray; 16-bit gray, gray+alpha, RGB, RGBA) and every resize branch
    (k = 2, k = 3, general area, linear, none) gives tiles bit-equal to JAX's
    OpenCV native loader (`sodt_tpu.data.native_loader`) at 64 and 512 px,
    non-square images padded with 114 as there;
  * square 8-bit RGB / gray pairs equal the port's python tile source, and
    the feeds give the same batches with and without `prefer_native`;
  * the inflate against zlib at levels 0, 1, 6, 9 and its strategies;
  * JPEG files (gray, 4:4:4, 4:2:2, 4:2:0, 4:4:0, progressive, restart
    intervals, optimised tables; `csrc/jpeg.cpp`, chosen by the file's
    signature, decoding as OpenCV 4.6's libjpeg-turbo 2.1) give tiles
    bit-equal to JAX's OpenCV loader at 64 and 512 px, and a folder that mixes PNG and JPEG pairs equals it and the
    port's python tile source;
  * BMP and TIFF files (every checked-in fixture of `tests/
    torch_port_bmp_tiff/`: palettes, RLE, 16-bit and 32-bit BITFIELDS,
    CORE headers; LZW, deflate, PackBits, predictor 2, tiles, planar
    configuration 2, MM, BigTIFF, MinIsWhite, alpha, orientation; `csrc/
    bmp.cpp` and `csrc/tiff.cpp`, chosen by the signature) give tiles
    bit-equal to JAX's OpenCV loader at 64 and 512 px, each resize branch
    and non-square sides included; where OpenCV 4.6 reads nothing or
    misreads (2- and 4-bit gray, 4-bit palettes, 16-bit planar
    configuration 2, the 16-bit masks of a V4 header), the tile equals
    its twin's (the same pixels in a kind OpenCV reads); a folder that
    mixes PNG, JPEG, BMP and TIFF pairs equals JAX's loader and the port's
    python tile source;
  * every faulty file fails its job with the file named; the cache, the
    thread pool and repeated indices leave the bytes as they are;
  * the build: the compiler's words kept where it fails, the library free
    of OpenCV and zlib, the kernel library's hash blind to `.cpp` sources.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from sodt_tpu.data import native_loader as jnative
from sodt_tpu_torch.data import loader as tl
from sodt_tpu_torch.data import native_loader as tnative
from sodt_tpu_torch.data import bmp, png, tiff
from sodt_tpu_torch.data.png import write_png
from sodt_tpu_torch.data.vedai import VedaiDataset
from sodt_tpu_torch.kernels import _build
from test_torch_port_item11 import _chunk, _encode
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)
from torch_port_common import DAMAGED_STRIPS, bmp_tiff_script, damaged_tiff

SIZES = (64, 512)
# a portrait variant image: area over partial cells at 64 px, the linear
# path at 512 (a row of 460 px, not a multiple of 16 bytes), 114 at the right
VH, VW = 100, 90
HYP = dict(hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, degrees=0.0, translate=0.1,
           scale=0.5, shear=0.0, perspective=0.0, flipud=0.0, fliplr=0.5,
           mosaic=1.0, mixup=0.5)


@pytest.fixture(scope="module")
def lib():
    """The port's library, built with the host compiler (skips only where
    there is none); JAX's OpenCV loader is the oracle and must load."""
    try:
        _build.cxx_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    assert tnative.available(), tnative.load_error()
    if not jnative.available():
        pytest.skip("JAX's native/libsodt_loader.so neither loads nor builds")
    return tnative._lib


def _scene(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth structure plus noise, uint8: ties of every rounding occur."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = (np.sin(x[..., None] / 7.0 + np.arange(c)) * 60
            + np.cos(y[..., None] / 5.0) * 50 + 128)
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(
        np.uint8)


def _tiles(mod, rgb_paths, ir_paths, size, idx, cache_gb=8.0):
    loader = mod.NativeTileLoader([str(p) for p in rgb_paths],
                                  [str(p) for p in ir_paths], size,
                                  cache_gb=cache_gb)
    try:
        return loader.get(np.asarray(idx))
    finally:
        loader.close()


def _same_as_jax(path, size):
    got = _tiles(tnative, [path], [path], size, [0])
    want = _tiles(jnative, [path], [path], size, [0])
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, size, size, 3)
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    return got[0][0]


# ------------------------------------------------------------- variants

def _variant_writers() -> dict:
    """name -> a function writing that variant's PNG to a path."""
    h, w = VH, VW
    rng = np.random.default_rng(23)
    s16 = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    s16[::2] //= 200                  # half the rows below 256: both sides
    gray = _scene(h, w, 1, 1)
    pal = {d: _chunk(b"PLTE", rng.integers(0, 256, 3 << d, dtype=np.uint8)
                     .tobytes()) for d in (1, 2, 4, 8)}
    trns = {d: _chunk(b"tRNS", bytes(range(0, 256, 7))[:1 << d])
            for d in (1, 2, 4, 8)}
    every = np.arange(h) % 5          # the rows cycle through all 5 filters
    out = {}
    for c, name in ((1, "gray8"), (2, "gray_alpha8"), (3, "rgb8"),
                    (4, "rgba8")):
        out[name] = lambda p, c=c: write_png(p, _scene(h, w, c, c),
                                             filters=every)
    for ctype, spp, name in ((0, 1, "gray16"), (4, 2, "gray_alpha16"),
                             (2, 3, "rgb16"), (6, 4, "rgba16")):
        out[name] = lambda p, ctype=ctype, spp=spp: p.write_bytes(
            _encode(s16[..., :spp], 16, ctype))
    out["adam7_rgb8"] = lambda p: p.write_bytes(
        _encode(_scene(h, w, 3, 5), 8, 2, adam7=True))
    out["adam7_gray_alpha16"] = lambda p: p.write_bytes(
        _encode(s16[..., :2], 16, 4, adam7=True))
    out["adam7_palette4"] = lambda p: p.write_bytes(
        _encode(gray >> 4, 4, 3, adam7=True, extra=pal[4]))
    for d in (1, 2, 4, 8):
        out[f"palette{d}"] = lambda p, d=d: p.write_bytes(
            _encode(gray >> (8 - d), d, 3, extra=pal[d]))
        out[f"palette{d}_trns"] = lambda p, d=d: p.write_bytes(
            _encode(gray >> (8 - d), d, 3, extra=pal[d] + trns[d]))
    for d in (1, 2, 4):
        out[f"gray{d}"] = lambda p, d=d: p.write_bytes(
            _encode(gray >> (8 - d), d, 0))
    out["rgb8_trns"] = lambda p: p.write_bytes(_encode(
        _scene(h, w, 3, 6), 8, 2, extra=_chunk(b"tRNS", b"\0\1\0\2\0\3")))
    out["gray8_trns"] = lambda p: p.write_bytes(
        _encode(gray, 8, 0, extra=_chunk(b"tRNS", b"\0\7")))
    return out


VARIANTS = _variant_writers()


@pytest.fixture(scope="module")
def variant_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("variants")
    for name, write in VARIANTS.items():
        write(d / f"{name}.png")
    return d


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_tiles_equal_jax_opencv_loader(lib, variant_dir, variant,
                                               size):
    tile = _same_as_jax(variant_dir / f"{variant}.png", size)
    ow = int(VW * size / VH)
    assert (tile[:, ow:] == 114).all() and (tile[:, :ow] != 114).any()


def test_palette_index_past_plte_is_black(lib, tmp_path):
    """A palette image using indices past its PLTE: black there, as in
    OpenCV (libpng's palette is zeroed past its end)."""
    idx = (_scene(VH, VW, 1, 9) >> 4)
    p = tmp_path / "short_plte.png"
    p.write_bytes(_encode(idx, 4, 3, extra=_chunk(b"PLTE", bytes(
        range(30)))))                                  # 10 of 16 entries
    tile = _same_as_jax(p, VH)
    assert (tile[:VH, :VW][idx[..., 0] >= 10] == 0).all()


# ------------------------------------------------------------- resize

# the longest side -> 64 / 512 px: 1024 (k 16 / k 2), 1536 (k 24 / k 3),
# 600 (general area at both), 256 (k 4 / linear), 512 (k 8 / none), 48
# (linear at both)
SIDES = (1024, 1536, 600, 256, 512, 48)


@pytest.fixture(scope="module")
def resize_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("resize")
    for side in SIDES:
        write_png(d / f"rgb{side}.png", _scene(side, side, 3, side))
        write_png(d / f"gray{side}.png", _scene(side, side, 1, side + 1))
    for hw in ((768, 1024), (1024, 768)):
        write_png(d / "rgb{}x{}.png".format(*hw), _scene(*hw, 3, 4))
    return d


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["rgb", "gray"])
@pytest.mark.parametrize("side", SIDES)
def test_resize_branches_equal_jax_opencv_loader(lib, resize_dir, side, kind,
                                                 size):
    tile = _same_as_jax(resize_dir / f"{kind}{side}.png", size)
    assert (tile != 114).any()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("hw", [(768, 1024), (1024, 768)],
                         ids=["landscape", "portrait"])
def test_non_square_is_padded_as_jax_opencv_loader(lib, resize_dir, hw,
                                                   size):
    tile = _same_as_jax(resize_dir / "rgb{}x{}.png".format(*hw), size)
    h, w = (int(s * size / 1024) for s in hw)
    assert (tile[h:] == 114).all() and (tile[:, w:] == 114).all()


# ----------------------------------------------------------------- JPEG

# (channels, cv2.imwrite's JPEG parameters by name, IMWRITE_ left out)
SAMPLING = "JPEG_SAMPLING_FACTOR"
JPEG_VARIANTS = {
    "gray": (1, {}),
    "s444": (3, {SAMPLING: SAMPLING + "_444"}),
    "s422": (3, {SAMPLING: SAMPLING + "_422"}),
    "s420": (3, {SAMPLING: SAMPLING + "_420"}),
    "s440": (3, {SAMPLING: SAMPLING + "_440"}),
    "progressive": (3, {"JPEG_PROGRESSIVE": 1}),
    "restart": (3, {"JPEG_RST_INTERVAL": 3}),
    "optimized": (3, {"JPEG_OPTIMIZE": 1}),
}


def _write_jpeg(path, img, params=None):
    """cv2's JPEG of `img` (BGR or gray), `params` named as in
    JPEG_VARIANTS. cv2 is imported here, so that only the JPEG tests skip
    where it is absent."""
    cv2 = pytest.importorskip("cv2")
    flat = []
    for key, value in (params or {}).items():
        flat += [getattr(cv2, "IMWRITE_" + key),
                 getattr(cv2, "IMWRITE_" + value) if isinstance(value, str)
                 else value]
    assert cv2.imwrite(str(path), img, flat)


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpeg_variants")
    for i, (name, (c, params)) in enumerate(JPEG_VARIANTS.items()):
        img = _scene(VH, VW, c, 40 + i)
        _write_jpeg(d / f"{name}.jpg", img[..., 0] if c == 1 else img,
                    params)
    return d


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("variant", sorted(JPEG_VARIANTS))
def test_jpeg_tiles_equal_jax_opencv_loader(lib, jpeg_dir, variant, size):
    tile = _same_as_jax(jpeg_dir / f"{variant}.jpg", size)
    ow = int(VW * size / VH)
    assert (tile[:, ow:] == 114).all() and (tile[:, :ow] != 114).any()


def _mixed_folder(root: Path) -> str:
    """A fold list of pairs that mix the formats: a JPEG `_co` with a PNG
    `_ir`, a PNG `_co` with a JPEG `_ir` (gray), JPEG both (one named
    .png: the signature decides), at sides that take each resize branch."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    lines = []
    kinds = (("jpg", "png"), ("png", "jpg"), ("jpg", "jpg"), ("jpg", "png"))
    for i, ((co, ir), side) in enumerate(zip(kinds, (1024, 600, 256, 48))):
        stem = root / "images" / f"{i:08d}"
        rgb, gray = _scene(side, side, 3, 300 + i), _scene(side, side, 1, i)
        if co == "jpg":
            _write_jpeg(f"{stem}_co.jpg", rgb[..., ::-1])
        else:
            write_png(f"{stem}_co.png", rgb)
        irp = f"{stem}_ir.{co}"                       # beside its _co
        if ir == "jpg":
            _write_jpeg(irp, gray[..., 0], {"JPEG_PROGRESSIVE": 1})
        else:
            write_png(irp, gray)
        (root / "labels" / f"{i:08d}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
        lines.append(f"{stem}_co.{co}\n")
    lst = root / "fold.txt"
    lst.write_text("".join(lines))
    return str(lst)


@pytest.mark.parametrize("size", SIZES)
def test_mixed_png_jpeg_folder_equals_jax_and_python_source(lib, tmp_path,
                                                            size):
    ds = VedaiDataset(_mixed_folder(tmp_path), size)
    assert len(ds) == 4
    idx = np.array([3, 0, 2, 1, 0])
    py = tl.PyTileSource(ds, "test").wait(idx)
    src = tl._make_tile_source(ds, size, cache=False)
    assert src.name == "native"
    got = src.wait(src.submit(idx))
    want = _tiles(jnative, ds.img_files, ds.ir_files, size, idx)
    for g, p, w in zip(got, py, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("kind,what", [
    ("lossless", "lossless (SOF3) JPEG: OpenCV 4.6"),
    ("bits12", "12-bit JPEG"), ("hierarchical", "hierarchical (SOF5)"),
    ("no_frame", "no image"), ("overfull_huffman", "bad Huffman table")])
def test_faulty_jpeg_fails_the_job_and_names_it(lib, tmp_path, kind, what):
    """Files OpenCV 4.6 reads none of (a lossless frame, which its
    libjpeg-turbo 2.1 does not know, 12 bits, a hierarchical frame) and
    broken ones fail the job, naming the file and the kind. (Cut
    progressive, arithmetic-coded and CMYK files, which 4.6 reads, are
    `test_torch_port_jpeg_kinds.py`'s.)"""
    good = tmp_path / "good_co.jpg"
    _write_jpeg(good, _scene(48, 40, 3, 0), {"JPEG_PROGRESSIVE": 1})
    data = bytearray(good.read_bytes())
    sof = data.index(b"\xff\xc2")
    if kind == "lossless":
        data = bytearray((Path(__file__).resolve().parent / "torch_port_jpeg"
                          / "lossless_gray_p1.jpg").read_bytes())
    elif kind == "bits12":
        data[sof + 4] = 12
    elif kind == "hierarchical":
        data[sof + 1] = 0xC5
    elif kind == "overfull_huffman":        # three 1-bit DC codes
        sos = data.index(b"\xff\xda")
        data[sos:sos] = (b"\xff\xc4\x00\x16\x00\x03" + bytes(15)
                         + b"\x00\x01\x02")
    else:
        data = data[:sof] + b"\xff\xd9"
    bad = tmp_path / f"bad_{kind}_ir.jpg"
    bad.write_bytes(bytes(data))
    loader = tnative.NativeTileLoader([str(good)] * 2, [str(good), str(bad)],
                                      64)
    try:
        with pytest.raises(RuntimeError) as e:
            loader.get(np.array([0, 1]))
        msg = str(e.value)
        assert f"failed to decode {bad}" in msg and what in msg, msg
        rgb, ir = loader.get(np.array([0]))
        np.testing.assert_array_equal(rgb, ir)
    finally:
        loader.close()


# ------------------------------------------------------------ BMP, TIFF

BT_FIXTURES = Path(__file__).resolve().parent / "torch_port_bmp_tiff"
BT_FILES = sorted(p.name for p in BT_FIXTURES.iterdir()
                  if p.suffix in (".bmp", ".tif"))
# where OpenCV 4.6 reads nothing or misreads, a twin of the same pixels in
# a kind it reads: name -> write(path of the fixture, path of the twin)
BT_TWINS = {
    "gray4.tif": lambda src, dst: tiff.write_tiff(
        dst, tiff.read_tiff_rgb(src)[..., 0]),
    "gray2_minwhite.tif": lambda src, dst: tiff.write_tiff(
        dst, tiff.read_tiff_rgb(src)[..., 0]),
    "palette4.tif": lambda src, dst: tiff.write_tiff(
        dst, tiff.read_tiff_rgb(src)),
    "rgb16_planar2_deflate.tif": lambda src, dst: tiff.write_tiff(
        dst, tiff._load(src)[1]),
    "v4_bitfields565.bmp": lambda src, dst: dst.write_bytes(
        (BT_FIXTURES / "bitfields565.bmp").read_bytes()),
}


# where OpenCV 4.6 aborts its process (cvtColor of a 1- or 4-channel signed
# or float64 image) or reads nothing (32-bit unsigned samples, CMYK and an
# extra sample): the port fails the job, naming the kind
BT_46_ABORTS = {"int16_pred2_lzw.tif", "int32_pred2.tif", "float64_pred3.tif"}
BT_46_READS_NOTHING = {"uint32.tif", "cmyk_extra.tif"}

_ABORT_PROBE = """
import sys, numpy as np
from sodt_tpu.data import native_loader as jnative
loader = jnative.NativeTileLoader([sys.argv[1]], [sys.argv[1]], 64)
loader.get(np.asarray([0]))
"""


def _jax_loader_aborts(path: Path) -> bool:
    """JAX's OpenCV 4.6 loader on `path` in a process of its own: whether
    the process died of SIGABRT."""
    proc = subprocess.run(["python", "-c", _ABORT_PROBE, str(path)],
                          capture_output=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    return proc.returncode in (-6, 134)


@pytest.mark.parametrize("name", sorted(BT_46_ABORTS | BT_46_READS_NOTHING))
def test_kinds_opencv_46_cannot_tile_fail_the_job(lib, name):
    path = BT_FIXTURES / name
    if name in BT_46_ABORTS:
        assert _jax_loader_aborts(path)
        what = "aborts its process"
    else:
        with pytest.raises(RuntimeError, match="failed to decode"):
            _tiles(jnative, [path], [path], 64, [0])
        what = "OpenCV 4.6 reads no such TIFF"
    with pytest.raises(RuntimeError, match=what):
        _tiles(tnative, [path], [path], 64, [0])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", [n for n in BT_FILES if n not in
                                  BT_46_ABORTS | BT_46_READS_NOTHING])
def test_bmp_tiff_tiles_equal_jax_opencv_loader(lib, tmp_path, name, size):
    path = BT_FIXTURES / name
    if name not in BT_TWINS:
        _same_as_jax(path, size)
        return
    if "planar2" not in name:           # OpenCV 4.6 reads nothing there
        with pytest.raises(RuntimeError):
            _tiles(jnative, [path], [path], size, [0])
    twin = tmp_path / f"twin{path.suffix}"
    BT_TWINS[name](path, twin)
    got = _tiles(tnative, [path], [path], size, [0])
    want = _tiles(jnative, [twin], [twin], size, [0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _write_bt(path: Path, img: np.ndarray) -> None:
    """`img` (RGB or gray) as a BMP (24-bit / 8-bit) or a TIFF (LZW by cv2
    for RGB, deflate with predictor 2 in tiles by the port's writer for
    gray)."""
    if path.suffix == ".bmp":
        bmp.write_bmp(path, img)
    elif img.ndim == 3:
        cv2 = pytest.importorskip("cv2")
        assert cv2.imwrite(str(path), img[..., ::-1], [
            cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_COMPRESSION_LZW])
    else:
        tiff.write_tiff(path, img, compression="deflate", predictor=2,
                        tile=(64, 128))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("hw", [(1024, 768), (768, 1024), (600, 600),
                                (48, 40)])
@pytest.mark.parametrize("ext", [".bmp", ".tif"])
def test_bmp_tiff_resize_paths_equal_jax_opencv_loader(lib, tmp_path, ext,
                                                       hw, size):
    """Shrinking (area, integer and general) and enlarging, non-square
    sides padded with 114, colour and gray."""
    for c in (3, 1):
        path = tmp_path / f"x{c}{ext}"
        img = _scene(*hw, c, sum(hw) + c)
        _write_bt(path, img if c == 3 else img[..., 0])
        tile = _same_as_jax(path, size)
        h, w = (int(s * size / max(hw)) for s in hw)
        assert (tile[h:] == 114).all() and (tile[:, w:] == 114).all()


@pytest.mark.parametrize("name", sorted(DAMAGED_STRIPS))
def test_damaged_tiff_tiles_equal_jax_opencv_loader(lib, tmp_path, name):
    """A cut or garbled LZW or PackBits strip or tile: the tiles of JAX's
    OpenCV loader, whose libtiff keeps what came before the fault and
    zeros. Deflate: the tiles of cv2 5.0's image, zlib's reading (OpenCV
    4.6's libtiff inflates with libdeflate, which leaves bytes of its own
    about the fault). A 16-bit strip fails the job, as in JAX."""
    path = damaged_tiff(tmp_path, name)
    if "16" in name:
        for mod in (tnative, jnative):
            with pytest.raises(RuntimeError, match="failed to decode"):
                _tiles(mod, [path], [path], 64, [0])
        return
    if not name.startswith("deflate"):
        _same_as_jax(path, 64)
        return
    cv2 = pytest.importorskip("cv2")
    read = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    twin = tmp_path / "twin.png"
    write_png(twin, read[..., ::-1] if read.ndim == 3 else read)
    for g, w in zip(_tiles(tnative, [path], [path], 64, [0]),
                    _tiles(jnative, [twin], [twin], 64, [0])):
        np.testing.assert_array_equal(g, w, err_msg=name)


def _mixed_four(root: Path) -> str:
    """A fold list of pairs in PNG, JPEG, BMP and TIFF, mixed within pairs
    (a TIFF named .png: the signature decides), at sides that take each
    resize branch."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    kinds = (("tif", "bmp"), ("bmp", "png"), ("png", "tif"), ("jpg", "tif"),
             ("bmp", "jpg"), ("tif", "tif"))
    lines = []
    for i, ((co, ir), side) in enumerate(zip(kinds, (1024, 600, 256, 48,
                                                     512, 100))):
        stem = root / "images" / f"{i:08d}"
        rgb, gray = _scene(side, side, 3, 400 + i), _scene(side, side, 1, i)
        for kind, img, p in ((co, rgb, Path(f"{stem}_co.{co}")),
                             (ir, gray[..., 0], Path(f"{stem}_ir.{co}"))):
            if kind == "png":
                write_png(p, img)
            elif kind == "jpg":
                _write_jpeg(p, img[..., ::-1] if img.ndim == 3 else img)
            else:
                tmp = p.with_suffix("." + kind)
                _write_bt(tmp, img)
                tmp.replace(p)
        (root / "labels" / f"{i:08d}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
        lines.append(f"{stem}_co.{co}\n")
    lst = root / "fold.txt"
    lst.write_text("".join(lines))
    return str(lst)


@pytest.mark.parametrize("size", SIZES)
def test_mixed_four_format_folder_equals_jax_and_python_source(
        lib, tmp_path, size):
    ds = VedaiDataset(_mixed_four(tmp_path), size)
    assert len(ds) == 6
    idx = np.array([5, 3, 0, 2, 1, 4, 0])
    py = tl.PyTileSource(ds, "test").wait(idx)
    src = tl._make_tile_source(ds, size, cache=False)
    assert src.name == "native"
    got = src.wait(src.submit(idx))
    want = _tiles(jnative, ds.img_files, ds.ir_files, size, idx)
    for g, p, w in zip(got, py, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def _bad_bmp_tiff(kind: str, tmp_path: Path) -> Path:
    good = tmp_path / "good.tif"
    bmp_tiff_script().write_tiff(good, _scene(40, 48, 3, 1),
                                 rows_per_strip=8)
    data = good.read_bytes()
    if kind == "rle_run_past_row":
        path = tmp_path / "bad_ir.bmp"
        path.write_bytes(b"BM" + struct.pack("<IHHI", 0, 0, 0, 54 + 1024)
                         + struct.pack("<IiiHHIIiiII", 40, 7, 5, 1, 8, 1, 0,
                                       0, 0, 0, 0) + bytes(1024)
                         + bytes([9, 13, 0, 1]))
        return path
    if kind == "rle_too_large":         # 2^30 < 40000^2 pixels, 2 bytes
        path = tmp_path / "bad_ir.bmp"
        path.write_bytes(b"BM" + struct.pack("<IHHI", 0, 0, 0, 54)
                         + struct.pack("<IiiHHIIiiII", 40, 40000, 40000, 1,
                                       8, 1, 0, 0, 0, 0, 0) + bytes([0, 1]))
        return path
    path = tmp_path / "bad_ir.tif"
    if kind == "strip_past_end":        # the last strip's byte count
        ifd = struct.unpack_from("<I", data, 4)[0]
        for e in range(ifd + 2, ifd + 2 + 12 * data[ifd], 12):
            if struct.unpack_from("<H", data, e)[0] == 279:
                at = struct.unpack_from("<I", data, e + 8)[0] + 4 * 4
        path.write_bytes(data[:at] + struct.pack("<I", len(data))
                         + data[at + 4:])
        return path
    if kind == "palette_16bit":
        bmp_tiff_script().write_tiff(
            path, np.arange(12 * 11, dtype=np.uint16).reshape(12, 11) * 300,
            photometric=3, colormap=np.zeros((1 << 16, 3), np.uint16))
        return path
    if kind == "old_style_jpeg":
        bmp_tiff_script().write_tiff(path, _scene(16, 16, 3, 2),
                                     compression=6,
                                     chunks=[b"\xff\xd8\xff\xd9"])
        return path
    raise KeyError(kind)


@pytest.mark.parametrize("kind,what", [
    ("rle_run_past_row", "an RLE run past the end of its row"),
    ("rle_too_large", "image too large (40000 x 40000 pixels"),
    ("strip_past_end", "strip or tile 4 past the end of the file"),
    ("palette_16bit", "a 16-bit palette, which neither libtiff nor PIL"),
    ("old_style_jpeg",
     "not implemented: a TIFF image with old-style JPEG (6)")])
def test_faulty_bmp_tiff_fails_the_job_and_names_it(lib, tmp_path, kind,
                                                    what):
    good = tmp_path / "good_co.bmp"
    bmp.write_bmp(good, _scene(48, 40, 3, 0))
    bad = _bad_bmp_tiff(kind, tmp_path)
    loader = tnative.NativeTileLoader([str(good)] * 2, [str(good), str(bad)],
                                      64)
    try:
        with pytest.raises(RuntimeError) as e:
            loader.get(np.array([0, 1]))
        msg = str(e.value)
        assert f"failed to decode {bad}" in msg and what in msg, msg
        rgb, ir = loader.get(np.array([0]))
        np.testing.assert_array_equal(rgb, ir)
    finally:
        loader.close()


# ------------------------------------------------- python source, feeds

def _folder(root: Path, sides, n_per_side: int = 2) -> str:
    """A fold list of square 8-bit RGB `_co` / gray `_ir` pairs with one
    label each; returns the list's path."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    lines = []
    for i, side in enumerate(s for s in sides for _ in range(n_per_side)):
        stem = f"{i:08d}"
        write_png(root / "images" / f"{stem}_co.png",
                  _scene(side, side, 3, 100 + i), filters=np.arange(side) % 5)
        write_png(root / "images" / f"{stem}_ir.png",
                  _scene(side, side, 1, 200 + i))
        (root / "labels" / f"{stem}.txt").write_text(
            f"{i % 3} 0.5 0.5 0.2 0.25\n")
        lines.append(f"{root / 'images' / stem}_co.png\n")
    lst = root / "fold.txt"
    lst.write_text("".join(lines))
    return str(lst)


@pytest.mark.parametrize("size", SIZES)
def test_square_pairs_equal_python_tile_source(lib, tmp_path, size):
    ds = VedaiDataset(_folder(tmp_path, (1024, 600, 256, 48), 1), size)
    idx = np.array([3, 0, 2, 1, 0])
    py = tl.PyTileSource(ds, "test").wait(idx)
    src = tl._make_tile_source(ds, size, cache=False)
    assert src.name == "native" and "tile_loader.cpp" in src.why
    for got, want in zip(src.wait(src.submit(idx)), py):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def feed_ds(tmp_path_factory):
    return VedaiDataset(_folder(tmp_path_factory.mktemp("feed"), (96, 80),
                                3), 64)


def _take(it, k):
    return [next(it) for _ in range(k)]


@pytest.mark.usefixtures("one_torch_thread")
def test_stream_feed_same_with_and_without_native(lib, feed_ds, monkeypatch,
                                                  capsys):
    """Streaming, two epochs: the native source's batches equal the python
    source's at one seed."""
    monkeypatch.setattr(tl, "DEVICE_BANK_MAX_GB", 0.0)
    runs = {}
    for native in (True, False):
        runs[native] = _take(tl.make_train_batches(
            feed_ds, 2, 64, HYP, seed=4, device="cpu", epochs=2,
            prefer_native=native), 6)
    out = capsys.readouterr().out
    assert "tile source: native (libsodt_tiles.so" in out
    assert "tile source: python (prefer_native=False)" in out
    for a, b in zip(runs[True], runs[False]):
        for k in ("img", "ir", "targets", "tmask"):
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


@pytest.mark.usefixtures("one_torch_thread")
def test_bank_feed_same_with_and_without_native(lib, feed_ds):
    feeds = {native: tl.make_bank_feed(feed_ds, 2, 64, HYP, seed=6,
                                       device="cpu", prefer_native=native)
             for native in (True, False)}
    assert feeds[True].source.name == "native"
    assert feeds[False].source.name == "python"
    for a, b in zip(feeds[True].banks, feeds[False].banks):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    a, b = feeds[True].augment_step(), feeds[False].augment_step()
    torch.testing.assert_close(a["img"], b["img"], rtol=0, atol=0)


# -------------------------------------------------------------- inflate

def _png_of(rgb: np.ndarray, zdata: bytes, parts: int = 3) -> bytes:
    """An 8-bit RGB PNG whose zlib stream is `zdata`, cut into `parts`
    IDAT chunks."""
    h, w, _ = rgb.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    cuts = np.linspace(0, len(zdata), parts + 1).astype(int)
    idats = b"".join(_chunk(b"IDAT", zdata[a:b])
                     for a, b in zip(cuts[:-1], cuts[1:]))
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + idats
            + _chunk(b"IEND", b""))


def _raw_rows(rgb: np.ndarray) -> bytes:
    return b"".join(b"\0" + r.tobytes() for r in rgb)


STREAMS = [(0, zlib.Z_DEFAULT_STRATEGY), (1, zlib.Z_DEFAULT_STRATEGY),
           (6, zlib.Z_DEFAULT_STRATEGY), (9, zlib.Z_DEFAULT_STRATEGY),
           (6, zlib.Z_FIXED), (6, zlib.Z_RLE), (9, zlib.Z_HUFFMAN_ONLY)]


@pytest.mark.parametrize("level,strategy", STREAMS,
                         ids=[f"level{l}-strategy{s}" for l, s in STREAMS])
def test_inflate_is_held_to_zlib(lib, tmp_path, level, strategy):
    """Stored, fixed and dynamic blocks, long and overlapping matches, a
    stream cut across IDATs: the tile at r = 1 is the image itself."""
    h, w = 160, 200                                    # > 64 KiB raw
    rgb = _scene(h, w, 3, level)
    rgb[40:80] = rgb[40:41]                            # long repeats
    comp = zlib.compressobj(level, zlib.DEFLATED, 15, 8, strategy)
    zdata = comp.compress(_raw_rows(rgb)) + comp.flush()
    assert zlib.decompress(zdata) == _raw_rows(rgb)
    p = tmp_path / "z.png"
    p.write_bytes(_png_of(rgb, zdata))
    tile = _tiles(tnative, [p], [p], w, [0])[0][0]
    np.testing.assert_array_equal(tile[:h], rgb)
    assert (tile[h:] == 114).all()


# ------------------------------------------------------------ bad input

def _broken(kind: str, good: bytes) -> bytes:
    """`good` (a PNG with one IDAT) broken one way."""
    chunks = list(png._chunks(good))
    kinds = [k for k, _ in chunks]
    i = kinds.index(b"IDAT")
    z = chunks[i][1]
    if kind == "crc":                                  # one CRC byte flipped
        pos = good.index(b"IDAT") + 4 + len(z)
        return good[:pos] + bytes([good[pos] ^ 0x40]) + good[pos + 1:]
    if kind == "truncated":
        return good[:len(good) // 2]
    if kind == "not_png":          # neither PNG, JPEG, BMP, TIFF nor WebP
        return b"GIF8" + good[4:]
    bad = {"zlib_header": bytes([z[0] ^ 0x0F]) + z[1:],
           "adler": z[:-1] + bytes([z[-1] ^ 1]),
           "zlib_cut": z[:len(z) // 2]}[kind]
    chunks[i] = (b"IDAT", bad)
    return png.SIGNATURE + b"".join(_chunk(k, p) for k, p in chunks)


BAD = {"crc": "bad CRC in chunk IDAT", "truncated": "truncated PNG file",
       "not_png": "not a PNG, JPEG, BMP, TIFF or WebP file",
       "zlib_header": "bad zlib stream (header)",
       "adler": "bad zlib stream (Adler-32)",
       "zlib_cut": "truncated zlib stream", "missing": "cannot open the file"}


@pytest.mark.parametrize("kind", sorted(BAD))
def test_faulty_file_fails_the_job_and_names_it(lib, tmp_path, kind):
    good = tmp_path / "good_co.png"
    write_png(good, _scene(48, 40, 3, 0))
    bad = tmp_path / f"bad_{kind}_ir.png"
    if kind != "missing":
        bad.write_bytes(_broken(kind, good.read_bytes()))
    loader = tnative.NativeTileLoader([str(good)] * 2, [str(good), str(bad)],
                                      64)
    try:
        with pytest.raises(RuntimeError) as e:
            loader.get(np.array([0, 1, 0]))
        msg = str(e.value)
        assert f"failed to decode {bad}" in msg and BAD[kind] in msg, msg
        rgb, ir = loader.get(np.array([0]))       # the loader goes on
        np.testing.assert_array_equal(rgb, ir)
    finally:
        loader.close()


def test_first_failing_tile_in_order_is_reported(lib, tmp_path):
    """Tiles decode on a pool, but the job reports the failure a loop over
    (rgb 0, ir 0, rgb 1, ...) meets first."""
    good = tmp_path / "ok.png"
    write_png(good, _scene(32, 32, 3, 0))
    gone = [str(tmp_path / f"gone{i}.png") for i in range(4)]
    loader = tnative.NativeTileLoader([str(good), gone[0], str(good)],
                                      [gone[1], str(good), gone[2]], 32)
    try:
        for idx, first in (([2, 1, 0], gone[2]), ([1, 0], gone[0]),
                           ([0, 2], gone[1])):
            with pytest.raises(RuntimeError, match=first):
                loader.get(np.array(idx))
    finally:
        loader.close()


# ------------------------------------------------------ cache and threads

def test_cache_pool_and_repeats_leave_the_bytes(lib, resize_dir):
    """No cache, a budget that holds two tiles, the default budget: the
    same bytes, equal to JAX's one-thread loader, over jobs that repeat
    indices and jobs waited in reverse order."""
    paths = [resize_dir / f"rgb{s}.png" for s in (1024, 600, 256, 48)]
    irs = [resize_dir / f"gray{s}.png" for s in (1024, 600, 256, 48)]
    jobs = [[0, 1, 0, 2], [3, 3, 1, 0, 2, 2], [1], [2, 0, 3, 1, 0, 3]]
    want = [_tiles(jnative, paths, irs, 512, j) for j in jobs]
    tile_gb = 512 * 512 * 3 / 2**30
    for gb in (0.0, 2 * tile_gb, 8.0):
        loader = tnative.NativeTileLoader([str(p) for p in paths],
                                          [str(p) for p in irs], 512,
                                          cache_gb=gb)
        try:
            ids = [loader.submit(np.array(j)) for j in jobs]
            got = {i: loader.wait(i) for i in reversed(ids)}
            got[ids[0]] = loader.get(np.array(jobs[0]))    # from the cache
            for i, w in zip(ids, want):
                for g, x in zip(got[i], w):
                    np.testing.assert_array_equal(g, x)
        finally:
            loader.close()


def test_wait_releases_the_interpreter(lib, resize_dir):
    """While `loader_wait` blocks, other Python threads run."""
    p = [str(resize_dir / "rgb1536.png")] * 4
    loader = tnative.NativeTileLoader(p, p, 512, cache_gb=0.0)
    ticks, stop = [0], threading.Event()

    def spin():
        while not stop.is_set():
            ticks[0] += 1
    job = loader.submit(np.arange(4))
    th = threading.Thread(target=spin)
    th.start()
    try:
        time.sleep(0.001)
        before = ticks[0]
        loader.wait(job)
        during = ticks[0] - before
    finally:
        stop.set()
        th.join(timeout=10)
        loader.close()
    assert not th.is_alive() and during > 1000, during


def test_close_with_jobs_in_flight_returns(lib, resize_dir):
    p = [str(resize_dir / "rgb1024.png")] * 2
    loader = tnative.NativeTileLoader(p, p, 512, cache_gb=0.0)
    for _ in range(3):
        loader.submit(np.array([0, 1]))
    th = threading.Thread(target=loader.close)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()


def test_submit_checks_its_indices(lib, resize_dir):
    p = [str(resize_dir / "rgb48.png")]
    loader = tnative.NativeTileLoader(p, p, 64)
    try:
        for bad in ([1], [-1], [[0]]):
            with pytest.raises(IndexError):
                loader.submit(np.array(bad))
    finally:
        loader.close()


# ---------------------------------------------------------------- build

def _fresh_binding(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)


def test_compile_error_is_kept_word_for_word(lib, tmp_path, monkeypatch,
                                             capsys):
    """A source that does not compile: `available()` is False, the
    compiler's message is `load_error()` and the feed's reason."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "tile_loader.cpp").write_text("int broken(\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _fresh_binding(monkeypatch)
    assert not tnative.available()
    err = tnative.load_error()
    assert "failed:" in err and "tile_loader.cpp:" in err and "error" in err
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        tnative.NativeTileLoader([], [], 64)
    ds = VedaiDataset(_folder(tmp_path / "f", (48,), 2), 32)
    src_ = tl._make_tile_source(ds, 32)
    assert src_.name == "python" and err in src_.why


def test_missing_compiler_is_kept(lib, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", Path("/nonexistent/build"))
    _fresh_binding(monkeypatch)
    assert not tnative.available()
    assert "no host C++ compiler" in tnative.load_error()


def test_library_has_no_opencv_and_no_zlib(lib):
    """`ldd` / `nm -D`: libc, libstdc++ (and its libgcc_s), libm only; no
    OpenCV, libpng, zlib or libjpeg symbol."""
    so = _build.build_host()
    if shutil.which("ldd") is None or shutil.which("nm") is None:
        pytest.skip("no ldd / nm on this machine")
    ldd = subprocess.run(["ldd", str(so)], capture_output=True, text=True,
                         check=True).stdout
    libs = {line.split()[0] for line in ldd.splitlines() if line.strip()}
    allowed = ("linux-vdso", "libstdc++", "libm.", "libgcc_s", "libc.",
               "libpthread", "ld-linux", "/lib64/ld-linux")
    assert all(n.startswith(allowed) for n in libs), libs
    nm = subprocess.run(["nm", "-D", "--undefined-only", str(so)],
                        capture_output=True, text=True, check=True).stdout
    for bad in ("cv", "inflate", "png_", "adler32", "crc32", "jpeg_",
                "tj", "WebP", "VP8"):
        assert not [s for s in nm.split() if s.startswith(bad)], bad
    exported = subprocess.run(["nm", "-D", "--defined-only", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
    for name in ("loader_create", "loader_submit", "loader_wait",
                 "loader_last_error", "loader_destroy", "jpeg_file_shape",
                 "jpeg_file_decode", "bmp_file_shape", "bmp_file_decode",
                 "tiff_file_shape", "tiff_file_decode", "webp_file_shape",
                 "webp_file_decode"):
        assert f" T {name}" in exported


def test_kernel_hash_ignores_host_sources(lib, tmp_path, monkeypatch):
    """The CUDA library's hash reads `.cu` / `.cuh` only, so the tile
    loader's source leaves the kernels' build as it is."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    kernels, host = _build._source_hash(), _build._host_hash()
    (copy / "tile_loader.cpp").write_text("// changed\n")
    assert _build._source_hash() == kernels
    assert _build._host_hash() != host
