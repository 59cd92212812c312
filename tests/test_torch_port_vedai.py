"""sodt_tpu_torch.data.vedai, data.prepare, data.native_loader and the tile
sources of data.loader against the JAX package on the CPU, on a VEDAI
folder in the real on-disk layout (`tests/test_e2e_fixture.py`'s
`_write_fixture`: 1024 px `_co` / `_ir` PNG pairs, raw 14-column
annotations)."""

from __future__ import annotations

import shutil

import numpy as np
import pytest

pytest.importorskip("cv2")

from sodt_tpu.data import native_loader as jnative
from sodt_tpu.data import prepare as jprep
from sodt_tpu.data import vedai as jv
from sodt_tpu_torch.data import loader as tl
from sodt_tpu_torch.data import native_loader as tnative
from sodt_tpu_torch.data import prepare as tprep
from sodt_tpu_torch.data import vedai as tv
from test_e2e_fixture import _write_fixture
from torch_port_common import write_vedai_folder


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_vedai_folder(tmp_path_factory.mktemp("vedai"))


def _fresh_list(folder, tmp_path):
    """A copy of the fold list in its own directory, so that each test
    starts without a label cache."""
    dst = tmp_path / "fold.txt"
    shutil.copy(folder["list"], dst)
    return str(dst)


def test_prepare_writes_jax_label_files(tmp_path):
    """Label files byte-equal to JAX's, fold lists equal, and the CLI."""
    _write_fixture(tmp_path, n=6, raw_size=1024, nc=3)
    with open(tmp_path / "Annotations1024" / "00000001.txt", "a") as f:
        # raw 7 survives as 7, raw 8 is dropped, raw 9 becomes 7
        f.write("10.0 20.0 0.0 7 0 0 5.0 15.0 15.0 5.0 10.0 10.0 30.0 30.0\n"
                "11.0 21.0 0.0 8 0 0 5.0 15.0 15.0 5.0 10.0 10.0 30.0 30.0\n"
                "12.0 22.0 0.0 9 0 0 6.0 16.0 16.0 6.0 10.0 10.0 30.0 30.0\n")
    ann = str(tmp_path / "Annotations1024")
    assert jprep.makelabels(ann, str(tmp_path / "j"), 1024.0) == 6
    tprep.main([ann, str(tmp_path / "t"), "--img-size", "1024", "--fold",
                str(tmp_path / "fold01.txt"), "--fold-out",
                str(tmp_path / "t.txt"), "--image-root",
                str(tmp_path / "images")])
    jprep.changepath(str(tmp_path / "fold01.txt"), str(tmp_path / "j.txt"),
                     str(tmp_path / "images"), suffix="_co.png")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        assert ((tmp_path / "t" / n).read_bytes()
                == (tmp_path / "j" / n).read_bytes()), n
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    first = (tmp_path / "t" / "00000001.txt").read_text().split("\n")
    assert [r.split()[0] for r in first if r][-2:] == ["7", "7"]
    assert tprep.CLASS_REMAP == jprep.CLASS_REMAP


@pytest.mark.parametrize("size", [512, 128])
def test_dataset_matches_jax(folder, tmp_path, size):
    """File lists, labels, `bad` and every item bit-equal to JAX's
    VedaiDataset (1024 -> 512 and -> 128 by INTER_AREA; the 1024 x 768
    pair keeps its aspect)."""
    lst = _fresh_list(folder, tmp_path)
    j = jv.VedaiDataset(lst, img_size=size)
    (tmp_path / "fold.labels.npz").unlink()
    t = tv.VedaiDataset(lst, img_size=size)
    assert (t.img_files, t.ir_files, t.label_files) == (
        j.img_files, j.ir_files, j.label_files)
    assert len(t) == len(folder["stems"])
    for a, b in zip(t.labels, j.labels):
        np.testing.assert_array_equal(a, b)
    for i in range(len(j)):
        for a, b in zip(t[i], j[i]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert t[len(t) - 1][0].shape == (size, size * 3 // 4, 3)


def test_label_cache_is_shared_and_corrupt_items_match(folder, tmp_path,
                                                       monkeypatch, capsys):
    """A truncated RGB file and an IR file with a corrupt CRC are left out by
    both scans (the same `bad`); each package then reads the other's
    `.labels.npz` without scanning again."""
    root = tmp_path / "f"
    shutil.copytree(folder["root"], root)
    lst = root / "fold01_write.txt"
    lst.write_text(lst.read_text().replace(str(folder["root"]), str(root)))
    co = root / "images" / "00000002_co.png"
    co.write_bytes(co.read_bytes()[:5000])
    ir = root / "images" / "00000004_ir.png"
    blob = bytearray(ir.read_bytes())
    blob[60] ^= 0x55
    ir.write_bytes(bytes(blob))

    t = tv.VedaiDataset(str(lst), img_size=128)
    assert "corrupt image" in capsys.readouterr().out
    cache = root / "fold01_write.labels.npz"
    saved = np.load(cache, allow_pickle=True)
    assert saved["bad"].tolist() == [i in (1, 3) for i in range(9)]
    cache.unlink()
    j = jv.VedaiDataset(str(lst), img_size=128)
    assert t.img_files == j.img_files and len(t) == 7
    np.testing.assert_array_equal(np.load(cache, allow_pickle=True)["bad"],
                                  saved["bad"])

    def no_scan(*a, **k):
        raise AssertionError("scanned again")
    # the port reads JAX's cache without scanning ...
    monkeypatch.setattr(tv, "verify_png", no_scan)
    t2 = tv.VedaiDataset(str(lst), img_size=128)
    monkeypatch.undo()
    # ... and JAX the port's
    cache.unlink()
    tv.VedaiDataset(str(lst), img_size=128)
    monkeypatch.setattr(jv.Image, "open", no_scan)
    j2 = jv.VedaiDataset(str(lst), img_size=128)
    assert t2.img_files == j2.img_files == j.img_files
    for a, b in zip(t2.labels, j2.labels):
        np.testing.assert_array_equal(a, b)


def test_read_image_decodes_jpeg_as_jax(tmp_path):
    """A JPEG (named .jpg, or a JPEG named .png) decodes through the host
    library to the pixels of JAX's `_read_image` (cv2), colour and gray."""
    import cv2
    rng = np.random.default_rng(11)
    img = cv2.GaussianBlur(rng.integers(0, 256, (45, 67, 3), np.uint8),
                           (5, 5), 2)
    for name, arr in (("x_co.jpg", img), ("y_ir.jpg", img[..., 0]),
                      ("z_co.png", img)):
        p = str(tmp_path / name)
        ok, buf = cv2.imencode(".jpg", arr)
        (tmp_path / name).write_bytes(buf.tobytes())
        got = tv._read_image(p)
        np.testing.assert_array_equal(got, jv._read_image(p))
        assert got.dtype == np.uint8 and got.shape[2] == (1 if arr.ndim == 2
                                                          else 3)


@pytest.mark.parametrize("ext,fmt", [(".bmp", "BMP"), (".tiff", "TIFF"),
                                     (".webp", "WebP")])
def test_read_image_other_formats_decode_as_jax(tmp_path, ext, fmt):
    """Formats beyond PNG and JPEG: a BMP, a TIFF and a WebP as cv2 writes
    them decode to JAX's pixels (the host library's decoders)."""
    import cv2
    p = str(tmp_path / f"x_co{ext}")
    img = np.random.default_rng(3).integers(0, 256, (12, 14, 3), np.uint8)
    assert cv2.imwrite(p, img)
    assert tv.image_format(p) == fmt
    want = jv._read_image(p)                       # JAX reads it
    assert want.shape == (12, 14, 3)
    np.testing.assert_array_equal(tv._read_image(p), want)


def test_read_image_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tv._read_image(str(tmp_path / "missing_co.png"))
    with pytest.raises(FileNotFoundError):
        tv._read_image(str(tmp_path / "missing_co.jpg"))


def test_native_binding_matches_jax_and_the_python_source(folder, tmp_path,
                                                          monkeypatch):
    """The port's own library (`csrc/tile_loader.cpp`, built here with the
    host compiler at first use; no OpenCV) binds; its tiles at 1024 -> 512
    are bit-equal to JAX's OpenCV binding and to the port's python source;
    a missing file fails the job with its path."""
    if not jnative.available():
        pytest.skip("JAX's native/libsodt_loader.so neither loads nor builds")
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler: the port's tile loader builds "
                    "with one")
    monkeypatch.setattr(tnative, "_lib", None)      # bind it anew
    monkeypatch.setattr(tnative, "_error", None)
    t = tv.VedaiDataset(_fresh_list(folder, tmp_path), img_size=512)
    square = t.img_files[:8]                  # the native tiles are square
    irs = t.ir_files[:8]
    assert tnative.available() and tnative.load_error() is None
    idx = np.array([3, 0, 7, 3])
    a = tnative.NativeTileLoader(square, irs, 512)
    b = jnative.NativeTileLoader(square, irs, 512)
    ga, gb = a.get(idx), b.get(idx)
    py = tl.PyTileSource(t, "test").wait(idx)
    for x, y, z in zip(ga, gb, py):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    src = tl._make_tile_source(t, 512)
    assert src.name == "native"
    a.close()
    b.close()
    bad = tnative.NativeTileLoader([square[0], str(tmp_path / "gone_co.png")],
                                   irs[:2], 64)
    with pytest.raises(RuntimeError, match="gone_co.png"):
        bad.get(np.array([0, 1]))
    bad.close()


def test_tile_source_says_why_it_fell_back(folder, tmp_path, monkeypatch):
    """Where the library does not load, the python source is taken and the
    reason kept (JAX's fallback swallows it)."""
    t = tv.VedaiDataset(_fresh_list(folder, tmp_path), img_size=64)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", "c++ failed:\ntile_loader.cpp:1: "
                        "error: no such file")
    src = tl._make_tile_source(t, 64)
    assert src.name == "python" and "tile_loader.cpp:1: error" in src.why
    from sodt_tpu_torch.data import SyntheticVedai
    assert "no image files" in tl._make_tile_source(
        SyntheticVedai(n=2, img_size=32), 32).why
    rgb, ir = src.wait(src.submit(np.array([1, 0])))
    np.testing.assert_array_equal(rgb[0], t[1][0])
    np.testing.assert_array_equal(ir[1], t[0][1])


# ------------------------------------------- dtypes beyond uint8 (16-bit IR)

def _pair_folder(root, side: tuple[int, int], ir_write) -> str:
    """One pair, `<stem>_co.<ext>` (8-bit RGB) and `<stem>_ir.<ext>` (16-bit
    gray), written by `ir_write(path, array)`, and one label; the fold
    list."""
    from pathlib import Path
    root = Path(root)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    h, w = side
    rng = np.random.default_rng(h * 7 + w)
    y, x = np.mgrid[:h, :w]
    base = 90 * np.sin(x / 23.0) * np.cos(y / 17.0) + 128
    rgb = np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0,
                  255).astype(np.uint8)
    ir16 = np.clip(base * 200 + rng.normal(0, 3000, (h, w)), 0,
                   65535).astype(np.uint16)
    ext = ir_write(None, None)
    ir_write(root / "images" / f"00000001_co.{ext}", rgb)
    ir_write(root / "images" / f"00000001_ir.{ext}", ir16)
    (root / "labels" / "00000001.txt").write_text("1 0.5 0.5 0.2 0.3\n")
    lst = root / "fold.txt"
    lst.write_text(f"{root / 'images' / f'00000001_co.{ext}'}\n")
    return str(lst)


def _ir_png16(path, arr):
    """PNG by cv2 (RGB given, written as BGR); the extension for None."""
    import cv2
    if path is None:
        return "png"
    assert cv2.imwrite(str(path), arr[..., ::-1] if arr.ndim == 3 else arr)


def _ir_tiff16(path, arr):
    """TIFF by the port's writer (deflate, predictor 2)."""
    from sodt_tpu_torch.data.tiff import write_tiff
    if path is None:
        return "tif"
    write_tiff(path, arr, compression="deflate", predictor=2)


RESIZE_16 = [((1024, 1024), 512), ((700, 700), 512), ((300, 300), 512),
             ((1024, 1024), 128), ((1024, 768), 512), ((300, 211), 512)]


@pytest.mark.parametrize("ir_write", [_ir_png16, _ir_tiff16],
                         ids=["png16", "tiff16"])
@pytest.mark.parametrize("side,size", RESIZE_16,
                         ids=[f"{s[0]}x{s[1]}to{n}" for s, n in RESIZE_16])
def test_16bit_ir_items_equal_jax(tmp_path, ir_write, side, size):
    """A 16-bit gray IR beside an 8-bit RGB: the port's item equals JAX's,
    dtype included (uint16 IR, INTER_AREA when shrinking, IPP's linear
    resize when enlarging). Before the resize took every dtype, the port's
    IR came back uint8."""
    lst = _pair_folder(tmp_path, side, ir_write)
    j = jv.VedaiDataset(lst, img_size=size)
    (tmp_path / "fold.labels.npz").unlink()
    t = tv.VedaiDataset(lst, img_size=size)
    assert len(t) == len(j) == 1
    for a, b in zip(t[0], j[0]):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
    assert t[0][1].dtype == np.uint16 and t[0][1].max() > 255


def _dtype_image(dtype, h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth structure plus noise over most of the dtype's range: ties of
    every rounding occur."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.sin(x[..., None] / 9.0 + np.arange(c)) * np.cos(
        y[..., None] / 7.0)
    if np.dtype(dtype).kind == "f":
        return (base * 300 + rng.normal(0, 40, (h, w, c))).astype(dtype)
    info = np.iinfo(dtype)
    span = (float(info.max) - float(info.min)) / 2
    mid = (float(info.max) + float(info.min)) / 2
    v = mid + span * 0.9 * base + rng.normal(0, span / 20, (h, w, c))
    return np.clip(np.rint(v), info.min, info.max).astype(dtype)


RESIZE_DTYPES = [(1024, 512), (1000, 512), (700, 512), (300, 512),
                 (211, 512), (37, 512)]


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32,
                                   np.float64])
@pytest.mark.parametrize("src,size", RESIZE_DTYPES,
                         ids=[f"{s}to{d}" for s, d in RESIZE_DTYPES])
def test_resize_longest_equals_cv2_for_every_dtype(dtype, src, size):
    """`resize_longest` against JAX's `_resize_longest` (cv2 5.0 with its
    IPP) at integer and general shrinking factors and enlarged, square and
    not, 1, 3 and 4 channels. Enlarging float64, and float32 of 3 or 4
    channels, raises NotImplementedError (IPP's rounding there is not
    reproduced)."""
    from sodt_tpu.data.vedai import _resize_longest as jresize
    from sodt_tpu_torch.data.resize import resize_longest
    for c in (1, 3, 4):
        for hw in ((src, src), (src, src * 3 // 4), (src * 2 // 3, src)):
            img = _dtype_image(dtype, *hw, c, src + c + hw[1])
            if src < size and (dtype == np.float64 or (
                    dtype == np.float32 and c > 1)):
                with pytest.raises(NotImplementedError):
                    resize_longest(img, size)
                continue
            got, want = resize_longest(img, size), jresize(img, size)
            assert got.dtype == want.dtype == dtype
            assert got.shape == want.shape, (hw, c)
            np.testing.assert_array_equal(got, want, err_msg=f"{hw} {c}")


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int8, np.float16])
def test_resize_raises_where_cv2_raises(dtype):
    """cv2.resize refuses these dtypes under INTER_AREA and INTER_LINEAR;
    so does the port, unless no resize is needed."""
    import cv2
    from sodt_tpu_torch.data.resize import resize_longest
    img = np.ones((40, 30, 1), dtype)
    for size in (20, 80):
        with pytest.raises(cv2.error):
            cv2.resize(img, (size * 3 // 4, size), interpolation=(
                cv2.INTER_AREA if size < 40 else cv2.INTER_LINEAR))
        with pytest.raises(TypeError, match=np.dtype(dtype).name):
            resize_longest(img, size)
    assert resize_longest(img, 40) is img


def test_resize_nan_reaches_what_cv2_sums(tmp_path):
    """float32 IR with NaN (a nodata value) shrunk and enlarged: NaN reaches
    exactly the outputs cv2 sums it into."""
    from sodt_tpu.data.vedai import _resize_longest as jresize
    from sodt_tpu_torch.data.resize import resize_longest
    rng = np.random.default_rng(5)
    for hw, size in (((300, 200), 512), ((1000, 700), 384),
                     ((1024, 1024), 512)):
        img = (rng.random((*hw, 1)) * 100).astype(np.float32)
        img[rng.random((*hw, 1)) < 0.02] = np.nan
        with np.errstate(invalid="ignore"):
            got, want = resize_longest(img, size), jresize(img, size)
        np.testing.assert_array_equal(got, want)


def test_predictor_letterbox_takes_the_dtype_as_jax(tmp_path):
    """The Predictor's letterbox (and `detect`'s, through it) of uint16,
    int16 and float32 images: the f32 values JAX's `letterbox_image` gives,
    no uint8 cast."""
    import jax.numpy as jnp
    import torch
    from sodt_tpu.ops.letterbox import letterbox_image as jletterbox
    from sodt_tpu_torch.models import infer
    for dtype in (np.uint16, np.int16, np.float32):
        img = _dtype_image(dtype, 61, 47, 3, 3)
        item = infer._to_array(img)
        assert item.dtype == dtype
        got = infer.Predictor.letterbox(
            type("P", (), {"img_size": 64, "model": torch.nn.Linear(1, 1)})(),
            [item])
        want = jletterbox(jnp.asarray(item, jnp.float32), 64) / 255.0
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ir16_folder(tmp_path_factory):
    """The PNG VEDAI folder's pairs with the IR at 16 bits (v * 257 + 3)."""
    import cv2
    from torch_port_common import folder_as

    def write(p, img):
        if img.ndim == 2:
            img = img.astype(np.uint16) * 257 + 3
        assert cv2.imwrite(str(p), img[..., ::-1] if img.ndim == 3 else img)
    return folder_as(tmp_path_factory, "png", write)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_16bit_ir_eval_batches_equal_jax(ir16_folder, rect):
    """The eval batches of a 16-bit IR folder (uint16 IR stacked as it is,
    square; the rect letterbox's uint8 cast) equal JAX's."""
    from torch_port_common import batches_equal_jax
    batches_equal_jax(ir16_folder, rect)
