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
