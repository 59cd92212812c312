"""The port's JPEG code against the JAX package's readers on the CPU:

  * `_read_image` (the C++ decoder of `csrc/jpeg.cpp`, built here with the
    host compiler) and `data/jpeg.py`'s numpy decoder bit-equal to JAX's
    `_read_image` through cv2 (libjpeg-turbo) on every checked-in fixture
    (`tests/torch_port_jpeg/`, made by its `make_fixtures.py`) and on JPEGs
    made here by `cv2.imencode`: gray, 4:4:4, 4:2:2, 4:2:0, 4:4:0,
    progressive, restart intervals, optimised Huffman tables, at qualities
    10, 75 and 100, sides from 1 to about 1000 px;
  * a truncated sequential file decodes as cv2 fills it; a truncated
    progressive one as cv2 fills and smooths it;
  * Adobe RGB and 'R', 'G', 'B' component ids as libjpeg takes them, EXIF
    orientation left alone as IMREAD_UNCHANGED leaves it, rewritten frames
    of each kind decoding as cv2 does, or raising with their names where
    cv2 reads none (the kinds' own fixtures are
    `test_torch_port_jpeg_kinds.py`'s);
  * `jpeg_size` equal to PIL's `size`, `verify_jpeg` rejecting and
    accepting the files JAX's scan does;
  * `write_jpeg` byte-equal to PIL's `Image.save` at its defaults, and its
    tables equal to the ones libjpeg writes.
"""

from __future__ import annotations

import io
import re
import struct
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image

from sodt_tpu.data import vedai as jv
from sodt_tpu_torch.data import jpeg
from sodt_tpu_torch.data import native_loader as tnative
from sodt_tpu_torch.data import vedai as tv
from sodt_tpu_torch.kernels import _build

FIXTURES = Path(__file__).resolve().parent / "torch_port_jpeg"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.jpg"))
S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
VARIANTS = {
    "gray": (True, []),
    "s444": (False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "s422": (False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "s420": (False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "s440": (False, [S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
    "progressive": (False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "progressive_gray": (True, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "progressive_s444": (False, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, S,
                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "restart": (False, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    "restart_progressive": (False, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "optimized": (False, [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
}
# (h, w): odd sides, sides under one MCU and under 3 chroma samples
SIDES = [(1, 1), (2, 3), (10, 11), (17, 5), (37, 53), (123, 157),
         (256, 200)]
BIG = (997, 731)


@pytest.fixture(scope="module")
def lib():
    try:
        _build.cxx_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    assert tnative.available(), tnative.load_error()
    return tnative._lib


def scene(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth structure plus noise, uint8 BGR (cv2's order)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 90 * np.sin(x / 6.0 + c) * np.cos(y / 9.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 18, (h, w, 3)), 0, 255).astype(
        np.uint8)


def encode(h, w, variant, quality, seed=0) -> bytes:
    gray, params = VARIANTS[variant]
    img = scene(h, w, seed)
    ok, buf = cv2.imencode(".jpg", img[..., 1] if gray else img,
                           params + [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def cv2_pixels(path) -> np.ndarray:
    """JAX's `_read_image` through cv2 (IMREAD_UNCHANGED, BGR -> RGB)."""
    return jv._read_image(str(path))


def _equal(got, want, what):
    assert got.dtype == want.dtype == np.uint8, what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


# -------------------------------------------------------------- decode

@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_decodes_as_cv2(lib, name):
    """Both decoders on each checked-in file, and the C++ one through the
    port's `_read_image` (which picks it by the file's signature); where
    cv2 reads none (12 bits), all three raise."""
    path = FIXTURES / name
    try:
        want = cv2_pixels(path)
    except FileNotFoundError:
        for read in (tv._read_image, jpeg.read_jpeg, tnative.decode_jpeg):
            with pytest.raises(ValueError, match="12-bit"):
                read(path if read is not tv._read_image else str(path))
        return
    _equal(tv._read_image(str(path)), want, name)
    _equal(jpeg.read_jpeg(path), want, name)
    _equal(tnative.decode_jpeg(path), want, name)


def test_fixtures_are_the_scripts():
    """The fixtures hold what their script's table says: gray or colour,
    progressive or not, a restart interval, the sides."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = [*mod.FIXTURES, *mod.CUT, *mod.KEEP, *mod.ENCODED,
             "lossless6_gray", "cmyk_no_adobe", "arith_dac",
             "exif_orientation6"]
    assert sorted(f"{n}.jpg" for n in names) == FIXTURE_FILES
    for name, (h, w, gray, params) in mod.FIXTURES.items():
        data = (FIXTURES / f"{name}.jpg").read_bytes()
        assert jpeg.jpeg_size(FIXTURES / f"{name}.jpg") == (w, h)
        keys = params[0::2]
        assert (b"\xff\xc2" in data) == (cv2.IMWRITE_JPEG_PROGRESSIVE in keys)
        assert (b"\xff\xdd" in data) == (cv2.IMWRITE_JPEG_RST_INTERVAL in
                                         keys)
        assert cv2_pixels(FIXTURES / f"{name}.jpg").shape[2] == (
            1 if gray else 3)
        assert len(data) < 8192


@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generated_jpegs_decode_as_cv2(lib, tmp_path, variant, quality):
    """C++ at every side up to ~1000 px, numpy up to 256 px."""
    for i, (h, w) in enumerate(SIDES + [BIG]):
        data = encode(h, w, variant, quality, seed=i)
        path = tmp_path / f"{variant}_{h}x{w}.jpg"
        path.write_bytes(data)
        want = cv2_pixels(path)
        _equal(tnative.decode_jpeg(path), want, path.name)
        if (h, w) != BIG:
            _equal(jpeg.decode_jpeg(data), want, path.name)


def test_big_image_numpy_decoder(tmp_path):
    data = encode(*BIG, "s420", 75, seed=3)
    (tmp_path / "big.jpg").write_bytes(data)
    _equal(jpeg.decode_jpeg(data), cv2_pixels(tmp_path / "big.jpg"), "big")


@pytest.mark.parametrize("variant", ["s420", "gray", "restart", "s422"])
def test_truncated_sequential_file_decodes_as_cv2(lib, tmp_path, variant):
    """libjpeg's fill: zero bits for the MCU whose data runs out, zero
    blocks after it (cv2 warns and returns the image), at cuts all over
    the entropy-coded data."""
    data = encode(61, 83, variant, 75, seed=5)
    sos = data.index(b"\xff\xda")
    cuts = list(range(sos + 20, len(data), 37)) + [len(data) - 2,
                                                    len(data) - 1]
    for cut in cuts:
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        want = cv2_pixels(path)
        _equal(tnative.decode_jpeg(path), want, cut)
        _equal(jpeg.decode_jpeg(data[:cut]), want, cut)


@pytest.mark.parametrize("variant", ["progressive", "progressive_gray",
                                     "restart_progressive"])
def test_truncated_progressive_file_as_cv2_or_raises(lib, tmp_path,
                                                     variant):
    """Cut anywhere in its scans: as cv2, partial coefficients and all, the
    blocks the scans left unfinished smoothed as libjpeg-turbo smooths
    them. Where cv2 returns nothing (a cut inside a Huffman table's counts
    or a scan header), both decoders raise with the file named."""
    data = encode(61, 83, variant, 75)
    sos = data.index(b"\xff\xda")
    seen = set()
    for cut in range(sos + 40, len(data), 23):
        path = tmp_path / f"cut{cut}_co.jpg"
        path.write_bytes(data[:cut])
        try:
            want = cv2_pixels(path)
        except FileNotFoundError:                   # cv2 gives no image
            for read in (tv._read_image, jpeg.read_jpeg):
                with pytest.raises(ValueError, match=str(path)):
                    read(str(path))
            seen.add("raised")
            continue
        _equal(tv._read_image(str(path)), want, cut)
        _equal(jpeg.read_jpeg(path), want, cut)
        seen.add("decoded")
    assert "decoded" in seen


def test_progressive_file_without_its_last_scans_raises(lib, tmp_path):
    """Whole, with an EOI, but its last scans dropped: libjpeg smooths the
    unfinished blocks, and both decoders give cv2's image (the name is the
    test's from before the smoothing was mirrored, when they raised). With
    the last scan alone dropped (the luma's final AC refinement), luma AC
    1-9 is unfinished too."""
    data = encode(40, 48, "progressive", 75)
    starts = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for keep in (len(starts) - 1, 3):
        cut = data[:starts[keep]] + b"\xff\xd9"
        path = tmp_path / f"keep{keep}.jpg"
        path.write_bytes(cut)
        want = cv2_pixels(path)
        assert want.shape == (40, 48, 3)
        for read in (tv._read_image, jpeg.read_jpeg):
            _equal(read(str(path)), want, keep)


def test_header_damage_raises_where_cv2_fails(lib, tmp_path):
    """Cut inside the markers before the first scan: cv2 returns nothing
    (JAX raises FileNotFoundError), the port raises ValueError."""
    data = encode(40, 40, "s420", 75)
    for cut in range(4, data.index(b"\xff\xda") + 10, 11):
        path = tmp_path / f"h{cut}.jpg"
        path.write_bytes(data[:cut])
        with pytest.raises(FileNotFoundError):
            jv._read_image(str(path))
        with pytest.raises(ValueError, match=str(path)):
            tv._read_image(str(path))
        with pytest.raises(ValueError):
            jpeg.decode_jpeg(data[:cut])


def _with_dht(data: bytes, tc_th: int, counts) -> bytes:
    """`data` with one more DHT segment (table class and id `tc_th`, codes
    per length `counts`, symbols 0, 1, ...) just before its first scan."""
    counts = list(counts) + [0] * (16 - len(counts))
    body = bytes([tc_th, *counts]) + bytes(range(sum(counts)))
    i = data.index(b"\xff\xda")
    return (data[:i] + b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
            + data[i:])


@pytest.mark.parametrize("tc_th,counts", [
    (0x00, [3]),                  # three 1-bit DC codes
    (0x10, [2]),                  # a 1-bit code of all ones
    (0x11, [255]),                # far past the 9-bit lookup
    (0x10, [1, 2]),
    (0x10, [1] * 8 + [3]),        # one past the lookup's end
    (0x11, [1] * 15 + [2]),       # all ones at 16 bits
], ids=["dc_3x1", "ac_2x1", "ac_255x1", "ac_1x1_2x2", "ac_9bit_edge",
        "ac_16bit_edge"])
def test_overfull_huffman_table_raises_as_cv2_fails(lib, tmp_path, tc_th,
                                                    counts):
    """A DHT with more codes than their lengths hold: libjpeg refuses it
    (cv2 returns nothing, JAX raises FileNotFoundError); both decoders
    raise naming the file, before they write a code."""
    path = tmp_path / "bad_huffman.jpg"
    path.write_bytes(_with_dht(encode(24, 24, "s420", 75), tc_th, counts))
    with pytest.raises(FileNotFoundError):
        jv._read_image(str(path))
    for read in (tv._read_image, jpeg.read_jpeg):
        with pytest.raises(ValueError, match="bad Huffman table") as e:
            read(str(path))
        assert str(path) in str(e.value)


@pytest.mark.parametrize("selector", [0x40, 0x04, 0xFF])
def test_scan_naming_a_table_past_3_raises_as_cv2_fails(lib, tmp_path,
                                                        selector):
    """A scan that names Huffman table 4-15 (DC in the high nibble, AC in
    the low): libjpeg refuses it, both decoders raise naming the file."""
    data = bytearray(encode(24, 24, "s420", 75))
    sos = data.index(b"\xff\xda")
    data[sos + 6] = selector               # the first component's tables
    path = tmp_path / "bad_selector.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(FileNotFoundError):
        jv._read_image(str(path))
    for read in (tv._read_image, jpeg.read_jpeg):
        with pytest.raises(ValueError, match="Huffman table missing") as e:
            read(str(path))
        assert str(path) in str(e.value)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_damaged_fixtures_decode_alike_in_both_decoders(lib, tmp_path,
                                                        name):
    """Fixtures with bytes overwritten or cut, from a seed: the C++ decoder
    gives the numpy decoder's pixels or its error, word for word."""
    good = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(sum(good[-64:]))
    for k in range(12):
        data = bytearray(good)
        if k % 3 == 2:
            data = data[:int(rng.integers(2, len(data)))]
        else:
            top = min(len(data), 700) if k % 3 == 0 else len(data)
            for i in rng.integers(2, top, int(rng.integers(1, 6))):
                data[i] = int(rng.integers(256))
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(bytes(data))
        try:
            want = jpeg.read_jpeg(path)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tnative.decode_jpeg(path)
            assert str(got.value) == str(e), (name, k)
            continue
        _equal(tnative.decode_jpeg(path), want, (name, k))


def _without_app0(data: bytes) -> bytes:
    assert data[2:4] == b"\xff\xe0"
    n = struct.unpack(">H", data[4:6])[0]
    return data[:2] + data[4 + n:]


def _sof_ids(data: bytes, ids) -> bytes:
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    for k, cid in enumerate(ids):
        old = b[i + 10 + 3 * k]
        b[i + 10 + 3 * k] = cid
        j = data.index(b"\xff\xda")         # the scan names the ids too
        for m in range(3):
            if b[j + 5 + 2 * m] == old:
                b[j + 5 + 2 * m] = cid
                break
    return bytes(b)


@pytest.mark.parametrize("kind", ["adobe_rgb", "adobe_ycc", "rgb_ids",
                                  "no_markers"])
def test_colour_space_markers_as_libjpeg(lib, tmp_path, kind):
    """Three components are RGB (no conversion) under an Adobe marker
    with transform 0, or ids 'R', 'G', 'B' without JFIF or Adobe markers;
    YCbCr otherwise."""
    data = _without_app0(encode(33, 47, "s444", 90))
    adobe = lambda t: (b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
                       + bytes([t]))
    data = {"adobe_rgb": data[:2] + adobe(0) + data[2:],
            "adobe_ycc": data[:2] + adobe(1) + data[2:],
            "rgb_ids": _sof_ids(data, b"RGB"),
            "no_markers": data}[kind]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    want = cv2_pixels(path)
    _equal(tnative.decode_jpeg(path), want, kind)
    _equal(jpeg.decode_jpeg(data), want, kind)


def _replace_segments(data: bytes, marker: int, make) -> bytes:
    """`data` with each marker segment of type `marker` (up to SOS)
    replaced by `make(payload)` (a whole segment, marker included)."""
    out, pos = [data[:2]], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos:pos + 2 + n]
        out.append(make(seg[4:]) if seg[1] == marker else seg)
        pos += 2 + n
    return b"".join(out) + data[pos:]


def _sixteen_bit_dqt(payload: bytes) -> bytes:
    body = b""
    while payload:
        vals = payload[1:65]
        body += bytes([0x10 | payload[0]]) + struct.pack(">64H", *vals)
        payload = payload[65:]
    return b"\xff\xdb" + struct.pack(">H", len(body) + 2) + body


def _non_interleaved(data: bytes) -> bytes:
    """The same coefficients as a sequential file of one scan per
    component (each scan's blocks in raster order, its own DC chain), made
    with the port's encoder: what libjpeg's `jpeg_simple_progression`-less
    multi-scan writers emit."""
    dec = jpeg._Decoder(data, "x")
    dec.run()
    head = data[:data.index(b"\xff\xda")]
    scans = []
    for ci, c in enumerate(dec.frame["comps"]):
        coef = np.asarray(c.coef, np.int64).reshape(c.ph, c.pw, 64)
        blocks = coef[:c.bh, :c.bw].reshape(-1, 64)
        t = 0 if ci == 0 else 1
        tabs = [jpeg._code_arrays(*jpeg.STD_HUFFMAN[(0, t)])
                + jpeg._code_arrays(*jpeg.STD_HUFFMAN[(1, t)])]
        body = jpeg._entropy_encode(blocks, np.zeros(len(blocks), np.int64),
                                    tabs)
        sos = bytes([1, c.id, (t << 4) | t, 0, 63, 0])
        scans.append(jpeg._marker(0xDA, sos) + body)
    return head + b"".join(scans) + b"\xff\xd9"


@pytest.mark.parametrize("kind", ["sof1", "dqt16", "non_interleaved",
                                  "non_interleaved_gray"])
def test_rewritten_files_decode_as_cv2(lib, tmp_path, kind):
    """Files no cv2 writer makes, made from its own: extended-sequential
    (SOF1), 16-bit quantization tables, one scan per component."""
    data = encode(45, 67, "gray" if "gray" in kind else "s420", 75)
    if kind == "sof1":
        i = data.index(b"\xff\xc0")
        data = data[:i + 1] + b"\xc1" + data[i + 2:]
    elif kind == "dqt16":
        data = _replace_segments(data, 0xDB, _sixteen_bit_dqt)
    else:
        data = _non_interleaved(data)
        assert data.count(b"\xff\xda") == (1 if "gray" in kind else 3)
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    want = cv2_pixels(path)
    _equal(tnative.decode_jpeg(path), want, kind)
    _equal(jpeg.decode_jpeg(data), want, kind)


def test_exif_orientation_is_not_applied(lib):
    """IMREAD_UNCHANGED applies no orientation: the 30 x 50 image tagged
    6 (rotate 90) comes out 30 x 50, as cv2 and PIL's size give it."""
    path = FIXTURES / "exif_orientation6.jpg"
    assert Image.open(path).getexif().get(0x0112) == 6
    assert cv2.imread(str(path)).shape[:2] == (50, 30)   # IMREAD_COLOR turns
    got = tv._read_image(str(path))
    assert got.shape == (30, 50, 3) and jpeg.jpeg_size(path) == (50, 30)
    _equal(got, cv2_pixels(path), "exif")


@pytest.mark.parametrize("marker,what", [
    (0xC3, "lossless (SOF3)"), (0xC9, "arithmetic-coded (SOF9)"),
    (0xCA, "arithmetic-coded (SOF10)"), (0xC5, "hierarchical (SOF5)"),
    ("12bit", "12-bit JPEG"), ("cmyk", "CMYK / YCCK"),
    ("bmp", "a BMP image")])
def test_unsupported_kinds_raise_naming_them(lib, tmp_path, marker, what):
    """A baseline file's frame rewritten to each kind: where cv2 reads an
    image (sequential arithmetic coding and CMYK, whose data then decodes
    otherwise), both decoders give its pixels; where it reads none (12
    bits, hierarchical, a lossless or progressive frame over a baseline
    scan header), they raise naming why; a BMP of JPEG data named .jpg is
    out of scope."""
    data = bytearray(encode(24, 24, "s444", 75))
    i = data.index(b"\xff\xc0")
    if marker == "12bit":
        data[i + 4] = 12
    elif marker == "cmyk":                  # a fourth component in SOF
        data[i + 3] += 3
        data[i + 9] = 4
        data[i + 19:i + 19] = b"\x04\x11\x00"
    elif marker != "bmp":
        data[i + 1] = marker
    path = tmp_path / "x_co.jpg"
    if marker == "bmp":        # named .jpg, a BMP of embedded JPEG data
        cv2.imwrite(str(tmp_path / "x.bmp"), np.zeros((9, 9, 3), np.uint8))
        bmp = bytearray((tmp_path / "x.bmp").read_bytes())
        bmp[30:34] = struct.pack("<I", 4)       # BI_JPEG: out of scope
        path.write_bytes(bytes(bmp))
        with pytest.raises(NotImplementedError, match=re.escape(what)):
            tv._read_image(str(path))
        return
    path.write_bytes(bytes(data))
    try:
        want = cv2_pixels(path)
    except FileNotFoundError:
        # 12 bits and a hierarchical frame by their names; a lossless or
        # progressive frame by the scan header a baseline file gives it
        what = (what if marker in ("12bit", 0xC5) else
                "SOS lossless parameters" if marker == 0xC3 else
                "SOS progression parameters")
        with pytest.raises(ValueError, match=re.escape(what)):
            tv._read_image(str(path))
        with pytest.raises(ValueError, match=re.escape(what)):
            jpeg.decode_jpeg(bytes(data))
        return
    _equal(tv._read_image(str(path)), want, what)
    _equal(jpeg.decode_jpeg(bytes(data)), want, what)


def test_decoder_is_the_host_library_without_fallback(tmp_path, monkeypatch):
    """Where the host library does not build, `_read_image` raises with
    the compiler's words; it does not fall back to the numpy decoder."""
    path = tmp_path / "a.jpg"
    path.write_bytes(encode(16, 16, "s420", 75))
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "jpeg.cpp").write_text("int broken(\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    with pytest.raises(RuntimeError, match="jpeg.cpp:") as e:
        tv._read_image(str(path))
    assert "unavailable" in str(e.value) and "error" in str(e.value)


# ---------------------------------------------------- PIL's header walk

def _pil(path):
    """JAX's scan of one file: None where it marks the file corrupt, else
    PIL's (width, height)."""
    try:
        with Image.open(path) as im:
            im.verify()
            w, h = im.size
            assert w > 9 and h > 9
            return w, h
    except Exception:
        return None


def _damaged(good: bytes) -> dict:
    sof = good.index(b"\xff\xc0")
    sos = good.index(b"\xff\xda")
    dqt = good.index(b"\xff\xdb")
    app0 = good[:2] + b"\xff\xe0\x00\x06JFIF" + good[2:]
    return {
        "good": good,
        "truncated_data": good[:len(good) * 2 // 3],   # PIL decodes nothing
        "no_eoi": good[:-2],
        "cut_in_sof": good[:sof + 7],
        "cut_before_sos": good[:sos],
        "cut_in_sos": good[:sos + 5],
        "no_soi": good[2:],
        "leading_junk": b"\x00" + good,
        "junk_after_soi": good[:3] + b"\x00" + good[3:],
        "12bit": good[:sof + 4] + b"\x0c" + good[sof + 5:],
        "two_layers": good[:sof + 9] + b"\x02" + good[sof + 10:],
        "sof_body_short": good[:sof + 2] + b"\x00\x0a" + good[sof + 4:],
        "zero_height": good[:sof + 5] + b"\x00\x00" + good[sof + 7:],
        "bad_dqt": good[:dqt + 2] + b"\x00\x10" + good[dqt + 4:],
        "short_jfif": app0,
        "bad_marker": good[:sof] + b"\xff\x05" + good[sof:],
        "padded_marker": good[:sof] + b"\xff" + good[sof:],
        "small": None,
        "gray_small_side": None,
    }


@pytest.fixture(scope="module")
def damaged(tmp_path_factory):
    d = tmp_path_factory.mktemp("damaged")
    good = encode(40, 52, "s420", 75)
    out = {}
    for kind, data in _damaged(good).items():
        if data is None:
            h, w = (9, 30) if kind == "small" else (40, 9)
            data = encode(h, w, "gray" if "gray" in kind else "s420", 75)
        (d / f"{kind}.jpg").write_bytes(data)
        out[kind] = d / f"{kind}.jpg"
    return out


@pytest.mark.parametrize("kind", sorted(_damaged(b"\xff\xd8\xff\xc0\xff\xda"
                                                 b"\xff\xdb")))
def test_verify_and_size_follow_jax_scan(damaged, kind):
    path = damaged[kind]
    want = _pil(path)
    if want is None:
        with pytest.raises(ValueError):
            jpeg.verify_jpeg(path)
        with pytest.raises(Exception):
            tv.verify_image(str(path))
    else:
        jpeg.verify_jpeg(path)
        tv.verify_image(str(path))
        assert jpeg.jpeg_size(path) == want == tv.image_size(str(path))
        with Image.open(path) as im:
            assert im.size == want


def test_size_equals_pil_across_variants(tmp_path):
    for variant in VARIANTS:
        for h, w in SIDES:
            path = tmp_path / f"{variant}_{h}x{w}.jpg"
            path.write_bytes(encode(h, w, variant, 75))
            with Image.open(path) as im:
                assert jpeg.jpeg_size(path) == im.size == (w, h)


# -------------------------------------------------------------- encode

def _pil_bytes(arr) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, format="JPEG")
    return bio.getvalue()


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (8, 8), (16, 16), (17, 33),
                                 (45, 67), (123, 157), (300, 211)])
def test_write_jpeg_equals_pil(tmp_path, h, w):
    """RGB (4:2:0) and gray, smooth and noisy: the bytes PIL writes."""
    rng = np.random.default_rng(h * 1000 + w)
    for arr in (scene(h, w, 1)[..., ::-1].copy(),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                scene(h, w, 2)[..., 0].copy()):
        jpeg.write_jpeg(tmp_path / "x.jpg", arr)
        assert (tmp_path / "x.jpg").read_bytes() == _pil_bytes(arr)
        assert jpeg.encode_jpeg(arr[..., None] if arr.ndim == 2 else arr) \
            == _pil_bytes(arr)


def test_write_jpeg_takes_only_uint8_gray_or_rgb():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="gray or RGB"):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))


def _segments(data: bytes) -> dict:
    """marker -> list of payloads, up to SOS."""
    out, pos = {}, 2
    while data[pos + 1] != 0xDA:
        m = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.setdefault(m, []).append(data[pos + 4:pos + 2 + n])
        pos += 2 + n
    return out


@pytest.mark.parametrize("quality", [10, 50, 75, 95, 100])
def test_tables_equal_libjpeg(quality):
    """The scaled Annex K tables and the standard Huffman tables, as
    libjpeg (through cv2) writes them."""
    ok, buf = cv2.imencode(".jpg", scene(16, 16, 0),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    seg = _segments(buf.tobytes())
    dqt = b"".join(seg[0xDB])
    want = {}
    while dqt:
        want[dqt[0]] = list(dqt[1:65])
        dqt = dqt[65:]
    for t, base in ((0, jpeg.QT_LUMA), (1, jpeg.QT_CHROMA)):
        table = jpeg.quality_table(base, quality)
        assert [table[jpeg.NATURAL[k]] for k in range(64)] == want[t]
    dht = b"".join(seg[0xC4])
    got = {}
    while dht:
        n = sum(dht[1:17])
        got[(dht[0] >> 4, dht[0] & 15)] = (tuple(dht[1:17]),
                                          tuple(dht[17:17 + n]))
        dht = dht[17 + n:]
    assert got == jpeg.STD_HUFFMAN


def test_encoded_crops_decode_as_pil_everywhere(lib, tmp_path):
    """What the port writes, the port's decoders, cv2 and PIL read alike."""
    arr = scene(70, 90, 8)[..., ::-1].copy()
    path = tmp_path / "crop.jpg"
    jpeg.write_jpeg(path, arr)
    want = np.asarray(Image.open(path).convert("RGB"))
    _equal(cv2_pixels(path), want, "cv2")
    _equal(tv._read_image(str(path)), want, "C++")
    _equal(jpeg.read_jpeg(path), want, "numpy")
