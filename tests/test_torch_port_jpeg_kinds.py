"""JPEG's remaining kinds and libjpeg's block smoothing in the port, against
the JAX package's three readers on the CPU:

  * every fixture of `tests/torch_port_jpeg/` that its script makes for these
    kinds (progressive files cut short or stripped of their last scans;
    arithmetic-coded sequential and progressive files, with restarts and
    with DAC conditioning; CMYK with and without an Adobe marker, YCCK;
    lossless files of predictors 1-7, a point transform, 6 bits, gray and
    RGB; 12-bit lossy and lossless files) read by `_read_image` (the C++
    decoder) and the numpy decoder bit-equal to JAX's `_read_image`
    through cv2 5.0, or raising with the kind named where cv2 reads none;
    PIL's branch where PIL reads the file (its CMYK samples 255 minus
    libjpeg's); the scan's verdict and size as PIL's; tiles bit-equal to
    JAX's OpenCV 4.6 loader, or the job failing where that loader fails;
  * progressive files cut at points all over their scans and written with
    scans dropped, every one decoded by both decoders as cv2 5.0 decodes it
    (libjpeg-turbo 3.1's smoothing), the C++ and numpy decoders as OpenCV
    4.6 does where asked (2.1's), and the tiles as JAX's 4.6 loader's;
  * `tools boxes` on a CMYK JPEG as PIL's `convert("RGB")`.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image

from sodt_tpu.data import native_loader as jnative
from sodt_tpu.data import vedai as jv
from sodt_tpu_torch.data import jpeg
from sodt_tpu_torch.data import native_loader as tnative
from sodt_tpu_torch.data import tools as ttools
from sodt_tpu_torch.data import vedai as tv
from sodt_tpu_torch.kernels import _build

FIXTURES = Path(__file__).resolve().parent / "torch_port_jpeg"
_spec = importlib.util.spec_from_file_location(
    "jpeg_make_fixtures", FIXTURES / "make_fixtures.py")
SCRIPT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SCRIPT)
DERIVED = ("lossless6_gray", "cmyk_no_adobe", "arith_dac")
KIND_FILES = sorted(f"{n}.jpg" for n in (*SCRIPT.CUT, *SCRIPT.KEEP,
                                         *SCRIPT.ENCODED, *DERIVED))
# where cv2 5.0 reads no image, the words the port's error names the kind by
REFUSED = {"bits12.jpg": "12-bit JPEG",
           "lossless12_gray.jpg": "12-bit lossless JPEG"}
PROGRESSIVE = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]


@pytest.fixture(scope="module")
def lib():
    try:
        _build.cxx_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    assert tnative.available(), tnative.load_error()
    return tnative._lib


def _cv2(path):
    """JAX's `_read_image` through cv2, or None where cv2 reads nothing."""
    try:
        return jv._read_image(str(path))
    except FileNotFoundError:
        return None


def _equal(got, want, what):
    assert got.dtype == want.dtype == np.uint8, what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _tile(mod, path, size=64):
    """One tile of `path` from a tile loader, or the job's error."""
    loader = mod.NativeTileLoader([str(path)], [str(path)], size)
    try:
        return loader.get(np.asarray([0]))[0][0]
    except RuntimeError as e:
        return str(e)
    finally:
        loader.close()


def _pil_scan(path):
    """JAX's scan of one file: PIL's (width, height), or None (corrupt)."""
    try:
        with Image.open(path) as im:
            im.verify()
            w, h = im.size
            assert w > 9 and h > 9
            return w, h
    except Exception:
        return None


def test_fixture_table_is_the_script():
    """Each kind's fixture exists, holds the frame its table says, and is a
    few kB at most."""
    assert sorted(p.name for p in FIXTURES.glob("*.jpg")
                  if p.name in KIND_FILES) == KIND_FILES
    frames = {"arith_seq": 0xC9, "arith_prog": 0xCA, "cmyk": 0xC0,
              "lossless_gray_p1": 0xC3, "lossless12_gray": 0xC3,
              "bits12": 0xC1}
    for name, marker in frames.items():
        data = (FIXTURES / f"{name}.jpg").read_bytes()
        assert bytes([0xFF, marker]) in data, name
    for name in KIND_FILES:
        assert (FIXTURES / name).stat().st_size < 4096, name


@pytest.mark.parametrize("name", KIND_FILES)
def test_kind_reads_as_cv2_pil_and_opencv46(lib, name):
    path = FIXTURES / name
    want = _cv2(path)
    if want is None:
        what = re.escape(REFUSED[name])
        for read in (tv._read_image, jpeg.read_jpeg):
            with pytest.raises(ValueError, match=what) as e:
                read(str(path))
            assert str(path) in str(e.value)
    else:
        assert name not in REFUSED
        _equal(tv._read_image(str(path)), want, name)
        _equal(jpeg.read_jpeg(path), want, name)
        # PIL's branch where it reads the file (not a cut one, nor one of
        # 6 bits): the same array, or for CMYK its "CMYK;I" samples
        try:
            with Image.open(path) as im:
                pil = np.asarray(im)
        except OSError:
            pil = None
        if pil is None:
            assert "cut" in name or "lossless6" in name
        elif pil.ndim == 3 and pil.shape[2] == 4:
            raw = tnative.decode_jpeg(path, raw_cmyk=True)
            _equal(raw, jpeg._decode(path.read_bytes(), name,
                                     raw_cmyk=True)[0], name)
            _equal(pil, 255 - raw, name)
        else:
            _equal(pil[..., None] if pil.ndim == 2 else pil, want, name)
    scan = _pil_scan(path)
    if scan is None:
        with pytest.raises(Exception):
            tv.verify_image(str(path))
    else:
        tv.verify_image(str(path))
        assert tv.image_size(str(path)) == scan
    got, ref = _tile(tnative, path), _tile(jnative, path)
    if isinstance(ref, str):
        assert isinstance(got, str) and f"failed to decode {path}" in got
    else:
        assert not isinstance(got, str), got
        np.testing.assert_array_equal(got, ref, err_msg=name)


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(x / 6.0 + c) * np.cos(y / 9.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 18, (h, w, 3)), 0, 255).astype(
        np.uint8)


# (h, w, extra cv2 parameters, gray): 4:2:0 (two block rows an iMCU row,
# where 2.1 and 3.1 pick neighbour rows apart), 4:2:2 two chroma blocks wide
# (where they pick columns apart), 4:4:4, gray, a restart interval
CUT_VARIANTS = {
    "s420": (64, 64, [], False),
    "s422_narrow": (37, 29, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], False),
    "s444": (45, 67, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], False),
    "gray": (33, 41, [], True),
    "restart": (40, 56, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2], False),
}


@pytest.mark.parametrize("variant", sorted(CUT_VARIANTS))
def test_cut_progressive_jpeg_decodes_as_cv2(lib, tmp_path, variant):
    """A progressive file cut at points all over its scans: both decoders
    give cv2's pixels (libjpeg-turbo's block smoothing of the blocks the
    scans left unfinished), or raise where cv2 reads none (a cut inside a
    Huffman table's counts, a scan header); numpy's OpenCV 4.6 reading
    equals the C++ one's at every cut."""
    h, w, params, gray = CUT_VARIANTS[variant]
    img = _scene(h, w, 7)
    data = cv2.imencode(".jpg", img[..., 1] if gray else img,
                        PROGRESSIVE + params + [cv2.IMWRITE_JPEG_QUALITY,
                                                85])[1].tobytes()
    sos = data.index(b"\xff\xda")
    seen = set()
    for cut in range(sos + 12, len(data), 41):
        path = tmp_path / f"cut{cut}_co.jpg"
        path.write_bytes(data[:cut])
        want = _cv2(path)
        if want is None:
            for read in (tv._read_image, jpeg.read_jpeg):
                with pytest.raises(ValueError, match=str(path)):
                    read(str(path))
            seen.add("raised")
            continue
        _equal(tv._read_image(str(path)), want, cut)
        _equal(jpeg.read_jpeg(path), want, cut)
        _equal(jpeg.decode_jpeg(data[:cut], opencv46=True),
               tnative.decode_jpeg(path, opencv46=True), cut)
        seen.add("decoded")
    assert "decoded" in seen


@pytest.mark.parametrize("variant", ["s420", "s422_narrow"])
def test_cut_progressive_tiles_equal_jax_opencv46(lib, tmp_path, variant):
    """The tiles follow OpenCV 4.6's libjpeg-turbo 2.1, whose smoothing picks
    some neighbours apart from 3.1's: at each cut, JAX's 4.6 loader's
    tile."""
    h, w, params, _ = CUT_VARIANTS[variant]
    data = cv2.imencode(".jpg", _scene(h, w, 8), PROGRESSIVE + params
                        )[1].tobytes()
    starts = [i for i in range(len(data) - 1)
              if data[i:i + 2] == b"\xff\xda"]
    files = [data[:s] + b"\xff\xd9" for s in starts[1:]]
    files += [data[:len(data) * k // 8] for k in range(2, 8)]
    for k, cut in enumerate(files):
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(cut)
        got, ref = _tile(tnative, path, max(h, w)), _tile(jnative, path,
                                                           max(h, w))
        if isinstance(ref, str):
            assert isinstance(got, str)
            continue
        assert not isinstance(got, str), got
        np.testing.assert_array_equal(got, ref, err_msg=str(k))


def test_progressive_without_last_scans_decodes_as_cv2(lib, tmp_path):
    """Whole files, an EOI after their n-th scan, for every n: coefficients
    1-9 unsent or unrefined, smoothed as cv2 smooths them."""
    data = cv2.imencode(".jpg", _scene(40, 48, 9), PROGRESSIVE)[1].tobytes()
    starts = [i for i in range(len(data) - 1)
              if data[i:i + 2] == b"\xff\xda"]
    for n in range(1, len(starts)):
        path = tmp_path / f"keep{n}.jpg"
        path.write_bytes(data[:starts[n]] + b"\xff\xd9")
        want = _cv2(path)
        _equal(tv._read_image(str(path)), want, n)
        _equal(jpeg.read_jpeg(path), want, n)


@pytest.mark.parametrize("marker,what", [
    (0xC5, "hierarchical (SOF5)"), (0xC7, "hierarchical lossless (SOF7)"),
    (0xCD, "hierarchical arithmetic-coded (SOF13)"),
    (0xCB, "arithmetic-coded lossless (SOF11)")])
def test_refused_frames_fail_where_cv2_fails(lib, tmp_path, marker, what):
    data = bytearray((FIXTURES / "lossless_gray_p1.jpg").read_bytes())
    data[data.index(b"\xff\xc3") + 1] = marker
    path = tmp_path / "x.jpg"
    path.write_bytes(bytes(data))
    assert _cv2(path) is None
    for read in (tv._read_image, jpeg.read_jpeg):
        with pytest.raises(ValueError, match=re.escape(what)):
            read(str(path))
    assert f"failed to decode {path}" in _tile(tnative, path)


def test_boxes_of_a_cmyk_jpeg_follow_pil(lib, tmp_path):
    """`tools boxes` reads a CMYK or YCCK JPEG as PIL's `convert("RGB")`
    (its inverted "CMYK;I" samples, then its CMYK to RGB)."""
    root = tmp_path / "set"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for name in ("cmyk", "ycck"):
        img = root / "images" / f"{name}.jpg"
        img.write_bytes((FIXTURES / f"{name}.jpg").read_bytes())
        (root / "labels" / f"{name}.txt").write_text("0 0.5 0.5 1.0 1.0\n")
    out = ttools.extract_boxes(str(root))
    for name in ("cmyk", "ycck"):
        crop = out / "0" / f"set_{name}_0.jpg"
        with Image.open(root / "images" / f"{name}.jpg") as im:
            want = np.asarray(im.convert("RGB"))
        ref = tmp_path / "ref.jpg"
        Image.fromarray(want).save(ref)
        assert crop.read_bytes() == ref.read_bytes(), name
