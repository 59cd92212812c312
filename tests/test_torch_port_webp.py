"""The port's WebP code against the JAX package's readers on the CPU:

  * `_read_image` (the C++ decoder of `csrc/webp.cpp`, built here with the
    host compiler), `native_loader.decode_webp` and `data/webp.py`'s numpy
    decoder bit-equal to JAX's `_read_image` through cv2 on every
    checked-in fixture (`tests/torch_port_webp/`, made by its
    `make_fixtures.py`: VP8L with every transform, palettes of 2, 4, 16 and
    256 colours, colour cache and meta codes; VP8 at qualities 1-100 with
    1-4 segments, the simple and normal filters, 1-8 partitions; VP8X with
    ALPH raw and compressed under each filter; ICCP / EXIF chunks; sides
    from 1 px), and `read_webp_rgb` equal to PIL's `convert("RGB")`;
  * the tile loader's tiles of each fixture equal to JAX's OpenCV 4.6
    loader's at 64 and 512 px;
  * seeded damaged copies (cut, bytes inverted): both decoders give cv2's
    pixels or raise where cv2 returns no image, and the port's scan and
    `image_size` follow PIL's open (JAX's scan);
  * an animated file raises NotImplementedError naming "animated WebP"
    (cv2 5.0 reads its first frame, OpenCV 4.6 fails the job);
  * the port's constant tables equal libwebp's (where `libwebp.a` is
    present), the minimal VP8L writer of the tests decodes in cv2 to its
    input, the host library is used without a numpy fallback;
  * `tools boxes` crops of a WebP set byte-equal to JAX's, and a VEDAI
    folder written as WebP giving JAX's eval batches and JAX's `val` mAP.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image

from sodt_tpu.data import native_loader as jnative
from sodt_tpu_torch.data import native_loader as tnative
from sodt_tpu_torch.data import vedai as tv
from sodt_tpu_torch.data import webp
from sodt_tpu_torch.kernels import _build
from test_torch_port_tile_loader import _tiles
from torch_port_common import (batches_equal_jax, folder_as,  # noqa: F401
                               jax_read_image, one_torch_thread, pil_scan,
                               riff, val_equals_jax, vp8l_stream,
                               write_webp_lossless)

FIXTURES = Path(__file__).resolve().parent / "torch_port_webp"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.webp"))
STILL = [n for n in FIXTURE_FILES if not n.startswith("animated")]
SIZES = (64, 512)


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_webp_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lib():
    try:
        _build.cxx_path()
    except RuntimeError as e:
        pytest.skip(str(e))
    assert tnative.available(), tnative.load_error()
    return tnative._lib


def _equal(got, want, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _all_three(path) -> np.ndarray:
    """The port's three reads of a file, held equal: `_read_image` (C++,
    picked by the signature), `decode_webp` and the numpy `read_webp`."""
    got = tv._read_image(str(path))
    _equal(tnative.decode_webp(path), got, path)
    _equal(webp.read_webp(path), got, path)
    return got


def _cv2(path):
    """cv2's read, None where it gives no image (or refuses the header)."""
    try:
        return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    except cv2.error:
        return None


# -------------------------------------------------------------- decode

def test_fixture_set_covers_the_kinds():
    """At least 30 fixtures, and each kind the module doc names."""
    assert len(FIXTURE_FILES) >= 30
    kinds = {"VP8 ": 0, "VP8L": 0, "VP8X": 0}
    alph = set()
    for name in FIXTURE_FILES:
        d = (FIXTURES / name).read_bytes()
        kinds[d[12:16].decode("latin1")] += 1
        if d[12:16] == b"VP8X" and d[30:34] == b"ALPH":
            alph.add(d[38] & 0x0F)              # method | filter << 2
    assert min(kinds.values()) >= 5, kinds
    assert alph >= {m | f << 2 for m in (0, 1) for f in range(4)}, alph


@pytest.mark.parametrize("name", STILL)
def test_fixture_decodes_as_jax(lib, name):
    """Each checked-in still file through the port's three reads against
    JAX's `_read_image` (cv2), and `read_webp_rgb` against PIL's
    `convert("RGB")`."""
    path = FIXTURES / name
    got = _all_three(path)
    _equal(got, jax_read_image(path, cv2_branch=True), name)
    want = np.asarray(Image.open(path).convert("RGB"))
    _equal(webp.read_webp_rgb(path), want, name)
    assert got.shape[2] in (3, 4)
    _equal(got[..., -3:], want, name)              # RGB, or A R G B


def test_animated_raises_naming_it(lib, tmp_path):
    """An animated file: cv2 5.0 reads its first frame and OpenCV 4.6 fails
    the job; every read of the port raises NotImplementedError naming
    "animated WebP" (the scan passes it, as PIL's open does)."""
    path = FIXTURES / "animated_32x24.webp"
    assert _cv2(path).shape == (24, 32, 3)
    for read in (tv._read_image, tnative.decode_webp, webp.read_webp):
        with pytest.raises(NotImplementedError, match="animated WebP"):
            read(str(path))
    tv.verify_image(str(path))
    assert tv.image_size(str(path)) == Image.open(path).size == (32, 24)
    loader = tnative.NativeTileLoader([str(path)], [str(path)], 64)
    try:
        with pytest.raises(RuntimeError, match="animated WebP"):
            loader.get(np.array([0]))
    finally:
        loader.close()
    with pytest.raises(RuntimeError):
        _tiles(jnative, [path], [path], 64, [0])


def test_fixtures_are_the_scripts():
    """The checked-in files are what `make_fixtures.py` writes, where this
    machine's libwebp encoder is the one that wrote them."""
    fx = _script()
    try:
        enc = fx.Encoder()
    except RuntimeError as e:
        pytest.skip(str(e))
    made = fx.fixtures(enc)
    assert enc.version == fx.ENCODER_VERSION, hex(enc.version)
    assert sorted(f"{n}.webp" for n in made) == FIXTURE_FILES
    for name, data in made.items():
        assert (FIXTURES / f"{name}.webp").read_bytes() == data, name
    folder = fx.vedai_q90(enc)
    assert sorted(folder) == sorted(
        p.name for p in (FIXTURES / "vedai_q90").iterdir())
    for name, data in folder.items():
        assert (FIXTURES / "vedai_q90" / name).read_bytes() == data, name
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*.webp"))
    assert total < 3 << 20, total


def test_vedai_q90_pairs_decode_as_jax(lib):
    """The lossy folder of chip_smoke's phase `webp` (four 512 px pairs and
    one 1024 px pair): C++ as cv2 on each, numpy on the 512 px ones."""
    for path in sorted((FIXTURES / "vedai_q90").glob("*.webp")):
        got = tv._read_image(str(path))
        _equal(got, jax_read_image(path, cv2_branch=True), path.name)
        if "00001024" not in path.name:
            _equal(webp.read_webp(path), got, path.name)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", STILL)
def test_fixture_tiles_equal_jax_opencv(lib, name, size):
    """The tile loader (`decode_bgr`: alpha dropped) against JAX's OpenCV
    4.6 loader (imread, BGRA2BGR, resize) at 64 and 512 px."""
    path = FIXTURES / name
    got = _tiles(tnative, [path], [path], size, [0])
    want = _tiles(jnative, [path], [path], size, [0])
    for g, w in zip(got, want):
        _equal(g, w, (name, size))


# ----------------------------------------------------------------- damage

# the fixtures the damage runs over: one of each container and codec
DAMAGE_SOURCES = ("ll_meta_cache_96x131.webp", "ll_pal4_35x23.webp",
                  "ll_rgba_41x29_m6.webp", "q50_33x65.webp",
                  "part8_150x70.webp", "seg4_90x91.webp",
                  "alpha_enc_vp8l_f2_33x29.webp",
                  "alpha_raw_gradient_45x31.webp",
                  "alpha_vp8l_horizontal_45x31.webp",
                  "vp8x_icc_exif_39x27.webp", "vp8x_ll_exif_27x39.webp",
                  "strong_sharp3_77x45.webp")


def _damaged(seed: int):
    """(name, bytes) of seeded damaged copies: cut at a random length, or 1-3
    bytes inverted (past the RIFF header for half of them)."""
    rng = np.random.default_rng(seed)
    for k in range(24):
        src = DAMAGE_SOURCES[(seed + k) % len(DAMAGE_SOURCES)]
        d = bytearray((FIXTURES / src).read_bytes())
        kind = int(rng.integers(0, 3))
        if kind == 0:
            d = d[:int(rng.integers(1, len(d)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                d[int(rng.integers(12 if kind == 1 else 0, len(d)))] ^= 0xFF
        yield f"{seed}_{k}_{src}", bytes(d)


@pytest.mark.parametrize("seed", range(12))
def test_damaged_copies_decode_as_cv2_and_scan_as_pil(lib, tmp_path, seed):
    """Both decoders give cv2's pixels, or both raise where cv2 gives no
    image (the same cause); the scan and `image_size` follow PIL's open."""
    raised = 0
    for name, data in _damaged(seed):
        path = tmp_path / f"{name}"
        path.write_bytes(data)
        want = _cv2(path)
        results = []
        for read in (tnative.decode_webp, webp.read_webp):
            try:
                results.append(read(path))
            except (ValueError, NotImplementedError) as e:
                results.append(str(e).split(": ", 1)[-1])
        if want is None:
            raised += 1
            assert all(isinstance(r, str) for r in results), name
            assert results[0] == results[1], (name, results)
        else:
            for r in results:
                assert not isinstance(r, str), (name, r)
                _equal(r, want[..., ::-1], name)
        scan = pil_scan(path)
        try:
            tv.verify_image(str(path))
            ours = tv.image_size(str(path))
        except Exception:
            ours = None
        assert ours == scan, name
    assert 0 < raised < 24


def test_cut_files_fail_as_cv2_and_pil(lib, tmp_path):
    """A file cut at half its length, at 40 bytes or at 20 bytes: cv2 gives
    no image and PIL does not open it (libwebp's checks of the RIFF size,
    the 32 bytes OpenCV reads first)."""
    for name in ("q75_65x33.webp", "ll_rgb_37x53.webp",
                 "alpha_enc_raw_37x35.webp"):
        d = (FIXTURES / name).read_bytes()
        for n in (len(d) // 2, 40, 20):
            path = tmp_path / f"cut{n}_{name}"
            path.write_bytes(d[:n])
            assert _cv2(path) is None and pil_scan(path) is None
            for read in (tnative.decode_webp, webp.read_webp, tv.verify_image):
                with pytest.raises(ValueError):
                    read(str(path))


def test_file_below_opencv_header_size(lib, tmp_path):
    """A valid 1 x 1 lossless file of fewer than 32 bytes: cv2 reads no
    image (OpenCV's reader wants 32 bytes of header), nor does the port;
    PIL opens it."""
    from torch_port_common import _BitWriter
    bw = _BitWriter()
    for v, n in ((0x2F, 8), (0, 14), (0, 14), (0, 1), (0, 3), (0, 3)):
        bw.put(v, n)                   # header; no transform, cache, meta
    for sym in (1, 1, 0, 1, 0):        # green, red, blue, alpha, distance
        bw.put(0b0001 | sym << 3, 4)   # simple code of one 1-bit symbol
    data = riff([(b"VP8L", bw.bytes())])
    assert len(data) < webp.CV_HEADER
    path = tmp_path / "tiny.webp"
    path.write_bytes(data)
    assert _cv2(path) is None
    assert Image.open(path).size == (1, 1)
    for read in (tnative.decode_webp, webp.read_webp):
        with pytest.raises(ValueError, match="below the 32"):
            read(path)


# ------------------------------------------------------- tables, writers

def _libwebp_tables():
    """libwebp.a's local copies of the decoder's constant tables, or None
    where the archive is absent."""
    import struct
    ar = Path("/usr/lib/x86_64-linux-gnu/libwebp.a")
    if not ar.exists():
        return None
    data = ar.read_bytes()
    members, pos, names = {}, 8, b""
    while pos + 60 <= len(data):
        hdr = data[pos:pos + 60]
        name = hdr[:16].decode().strip()
        size = int(hdr[48:58].decode().strip())
        body = data[pos + 60:pos + 60 + size]
        if name == "//":
            names = body
        elif name.startswith("/") and name[1:].isdigit():
            off = int(name[1:])
            members[names[off:names.index(b"/\n", off)].decode()] = body
        elif name not in ("/", "/SYM64/"):
            members[name.rstrip("/")] = body
        pos += 60 + size + (size & 1)
    out = {}
    for member, elf in members.items():
        if not member.startswith("libwebpdecode"):
            continue
        shoff, = struct.unpack_from("<Q", elf, 0x28)
        shentsize, shnum = struct.unpack_from("<HH", elf, 0x3A)
        secs = [struct.unpack_from("<IIQQQQIIQQ", elf, shoff + i * shentsize)
                for i in range(shnum)]
        for s in secs:
            if s[1] != 2:                              # SHT_SYMTAB
                continue
            strtab = secs[s[6]]
            for k in range(s[5] // 24):
                nm, _, _, shndx, value, size = struct.unpack_from(
                    "<IBBHQQ", elf, s[4] + 24 * k)
                if not size or not 0 < shndx < len(secs):
                    continue
                start = strtab[4] + nm
                sym = elf[start:elf.index(b"\0", start)].decode()
                sec = secs[shndx]
                out[sym] = elf[sec[4] + value:sec[4] + value + size]
    return out


TABLES = {"CoeffsProba0": ("_COEFFS_PROBA0", np.uint8),
          "CoeffsUpdateProba": ("_COEFFS_UPDATE_PROBA", np.uint8),
          "kBModesProba": ("_BMODES_PROBA", np.uint8),
          "kYModesIntra4": ("_YMODES_INTRA4", np.int8),
          "kAcTable": ("_AC_TABLE", np.uint16),
          "kDcTable": ("_DC_TABLE", np.uint8),
          "kZigzag": ("_ZIGZAG", np.uint8),
          "kBands": ("_BANDS", np.uint8),
          "kCodeLengthCodeOrder": ("_CODE_LENGTH_CODE_ORDER", np.uint8),
          "kCodeToPlane": ("_CODE_TO_PLANE", np.uint8)}


def _cpp_table(name: str) -> list:
    """A table as `csrc/webp.cpp` spells it (k + CamelCase of the numpy
    module's name)."""
    import re
    src = (_build.CSRC / "webp.cpp").read_text()
    cname = "k" + "".join(w.capitalize()
                          for w in name.strip("_").lower().split("_"))
    m = re.search(rf"{cname}\[\d+\] = \{{([^}}]*)\}};", src)
    assert m, cname
    return [int(v) for v in m.group(1).replace("\n", " ").split(",")
            if v.strip()]


@pytest.mark.parametrize("symbol", sorted(TABLES))
def test_constant_tables_equal_libwebp(symbol):
    """The port's copies (numpy module and C++ source) equal libwebp's,
    where this machine has libwebp.a."""
    tables = _libwebp_tables()
    if tables is None or symbol not in tables:
        pytest.skip("libwebp.a (with the decoder's local symbols) absent")
    attr, dtype = TABLES[symbol]
    want = np.frombuffer(tables[symbol], dtype).tolist()
    assert list(getattr(webp, attr)) == want
    assert _cpp_table(attr) == want


@pytest.mark.parametrize("hw", [(1, 1), (5, 7), (64, 33)])
def test_minimal_vp8l_writer_decodes_in_cv2(lib, tmp_path, hw):
    """The tests' VP8L writer (chip_smoke's lossless folder): cv2 reads its
    files back to the input, and so do both decoders."""
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), np.uint8)
    path = tmp_path / "m.webp"
    write_webp_lossless(path, img)
    _equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1], img, hw)
    _equal(_all_three(path), img, hw)


def test_decoder_is_the_host_library_without_fallback(tmp_path, monkeypatch):
    """Where the host library does not build, `_read_image` raises with
    the compiler's words; it does not fall back to the numpy decoder."""
    path = tmp_path / "a.webp"
    write_webp_lossless(path, np.zeros((4, 4, 3), np.uint8))
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "webp.cpp").write_text("int broken(\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    with pytest.raises(RuntimeError, match="webp.cpp:") as e:
        tv._read_image(str(path))
    assert "WEBP decoder" in str(e.value) and "unavailable" in str(e.value)


# ------------------------------------------------------------- the scan

@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_scan_and_size_follow_pil(name):
    path = FIXTURES / name
    want = pil_scan(path)
    assert want is not None or min(Image.open(path).size) < 10
    if want is None:
        with pytest.raises(ValueError, match="<10 pixels"):
            tv.verify_image(str(path))
    else:
        tv.verify_image(str(path))
    assert tv.image_size(str(path)) == Image.open(path).size


def test_pil_pixel_limit(tmp_path):
    """A VP8X canvas (and its VP8L frame) of 16383 x 16383: above PIL's
    decompression bomb limit, so JAX's scan marks it corrupt, and so does
    the port's; no pixel is decoded."""
    argb = np.zeros((1, 1, 4), np.uint8)
    stream = bytearray(vp8l_stream(argb, alpha_used=False))
    v = int.from_bytes(stream[1:5], "little")
    v = (v & ~((1 << 28) - 1)) | 16382 | 16382 << 14
    stream[1:5] = v.to_bytes(4, "little")
    path = tmp_path / "bomb.webp"
    path.write_bytes(riff([(b"VP8L", bytes(stream))]))
    assert pil_scan(path) is None
    with pytest.raises(ValueError, match="decompression bomb"):
        tv.verify_image(str(path))
    with pytest.raises(ValueError, match="decompression bomb"):
        tv.image_size(str(path))


# ------------------------------------------------------------- folders

def test_extract_boxes_crops_equal_jax(lib, tmp_path):
    """`tools boxes` on a WebP set (lossy, lossless, alpha) writes JAX's
    crops, byte for byte."""
    from sodt_tpu.data import tools as jtools
    from sodt_tpu_torch.data import tools
    root = tmp_path / "set"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i, name in enumerate(["q90_97x83.webp", "ll_meta_cache_96x131.webp",
                              "alpha_vp8l_gradient_45x31.webp",
                              "ll_rgba_41x29_m6.webp"]):
        (root / "images" / f"{i}_co.webp").write_bytes(
            (FIXTURES / name).read_bytes())
        np.savetxt(root / "labels" / f"{i}.txt", [[i % 3, 0.4, 0.5, 0.5, 0.6],
                                                  [1, 0.8, 0.3, 0.3, 0.3]],
                   fmt="%.6f")
    files = lambda d: {p.relative_to(d): p.read_bytes()
                       for p in sorted(Path(d).rglob("*")) if p.is_file()}
    want = files(jtools.extract_boxes(str(root)))
    got = files(tools.extract_boxes(str(root)))
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        assert got[k] == want[k], k


def _cv2_webp(path, img):
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    assert cv2.imwrite(str(path), rgb[..., ::-1].copy(),
                       [cv2.IMWRITE_WEBP_QUALITY, 90])


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """The PNG VEDAI folder's pairs as lossy WebP files (cv2, quality 90;
    the IR as three equal channels)."""
    return folder_as(tmp_path_factory, "webp", _cv2_webp)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_webp_folder_batches_equal_jax(lib, folder, rect):
    batches_equal_jax(folder, rect)


def test_webp_folder_val_matches_jax(lib, folder, tmp_path, one_torch_thread):
    val_equals_jax(folder, tmp_path)


def _mixed_webp(root: Path) -> str:
    """A fold list of pairs mixing WebP (lossy, lossless) and PNG, at sides
    that take each resize branch (a WebP named .png: the signature
    decides). No alpha: JAX's python dataset keeps A R G of an RGBA image
    where its OpenCV loader drops A, so the two sources differ there."""
    from sodt_tpu_torch.data.png import write_png
    from test_torch_port_tile_loader import _scene
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    kinds = (("webp90", "png"), ("png", "webp101"), ("webp90", "webp90"),
             ("webp101", "webp90"))
    lines = []
    for i, ((co, ir), side) in enumerate(zip(kinds, (1024, 600, 256, 48))):
        stem = root / "images" / f"{i:08d}"
        rgb, gray = _scene(side, side, 3, 500 + i), _scene(side, side, 1, i)
        ext = "png" if co == "png" else "webp"
        for kind, img, p in ((co, rgb, Path(f"{stem}_co.{ext}")),
                             (ir, gray[..., 0], Path(f"{stem}_ir.{ext}"))):
            bgr = img[..., ::-1] if img.ndim == 3 else np.repeat(
                img[..., None], 3, -1)
            if kind == "png":
                write_png(p, img)
            else:
                q = 101 if kind == "webp101" else 90
                ok, buf = cv2.imencode(".webp", bgr.copy(),
                                       [cv2.IMWRITE_WEBP_QUALITY, q])
                p.write_bytes(buf.tobytes())
        (root / "labels" / f"{i:08d}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
        lines.append(f"{stem}_co.{ext}\n")
    lst = root / "fold.txt"
    lst.write_text("".join(lines))
    return str(lst)


@pytest.mark.parametrize("size", SIZES)
def test_mixed_webp_folder_equals_jax_and_python_source(lib, tmp_path, size):
    """The native feed on a folder mixing WebP and PNG: JAX's OpenCV 4.6
    loader's tiles and the port's python tile source's."""
    from sodt_tpu_torch.data import loader as tl
    from sodt_tpu_torch.data.vedai import VedaiDataset
    ds = VedaiDataset(_mixed_webp(tmp_path), size)
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
