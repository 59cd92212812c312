"""sodt_tpu_torch.data.png and data.resize against cv2 and PIL on the CPU
(the card's machine has neither; the JAX package decodes and resizes with
cv2 where it imports, as here).

The decoder is held bit-equal to JAX's `_read_image` (cv2's
IMREAD_UNCHANGED, then `[..., ::-1]`) and to PIL on PNGs written by cv2
(every row Sub), by PIL (Sub, Up, Paeth) and by the port's encoder with
every filter type, for gray, RGB, gray+alpha and RGBA. The resize is held
bit-equal to JAX's `_resize_longest` (cv2 INTER_AREA / INTER_LINEAR)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from PIL import Image

from sodt_tpu.data.synthetic import SyntheticVedai as JSynth
from sodt_tpu.data.vedai import _read_image as jread, _resize_longest as jresize
from sodt_tpu_torch.data import png
from sodt_tpu_torch.data.resize import resize_longest

KINDS = ("gray", "rgb", "gray_alpha", "rgba")


def _image(kind: str, h=61, w=77, seed=0) -> np.ndarray:
    """File-order channels: noise over a synthetic scene, so every filter
    predicts something."""
    rgb, ir, _ = JSynth(n=1, img_size=128, seed=seed)[0]
    base = np.concatenate([rgb, ir[..., :1]], -1)[:h, :w]
    noise = np.random.default_rng(seed).integers(0, 40, base.shape)
    img = ((base.astype(int) + noise) % 256).astype(np.uint8)
    return {"gray": img[..., 3:], "rgb": img[..., :3],
            "gray_alpha": img[..., 2:], "rgba": img}[kind]


def _filters_used(path) -> set[int]:
    data = open(path, "rb").read()
    idat, pos, ihdr = b"", 8, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, ctype = ihdr[:4]
    stride = w * png.CHANNELS[ctype] + 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride)
    return set(raw[:, 0].tolist())


def _cv2_order(img: np.ndarray) -> np.ndarray:
    """What cv2 IMREAD_UNCHANGED then [..., ::-1] gives for a file holding
    `img` (file order): gray+alpha widens to B G R A = L L L A first."""
    if img.shape[-1] == 2:
        return img[..., [1, 0, 0, 0]]
    if img.shape[-1] == 4:
        return img[..., [3, 0, 1, 2]]
    return img


def _write(writer: str, kind: str, img: np.ndarray, path) -> None:
    if writer == "port":
        png.write_png(path, img, filters=np.arange(img.shape[0]) % 5)
    elif writer == "pil":
        mode = {"gray": "L", "rgb": "RGB", "gray_alpha": "LA",
                "rgba": "RGBA"}[kind]
        Image.fromarray(img[..., 0] if kind == "gray" else img, mode).save(
            path)
    else:
        cv2.imwrite(str(path), img[..., 0] if kind == "gray"
                    else img[..., [2, 1, 0]] if kind == "rgb"
                    else img[..., [2, 1, 0, 3]])


CASES = [(w, k) for w in ("port", "pil", "cv2") for k in KINDS
         if not (w == "cv2" and k == "gray_alpha")]   # cv2 writes no LA


@pytest.mark.parametrize("writer,kind", CASES,
                         ids=[f"{w}-{k}" for w, k in CASES])
def test_decoder_matches_cv2_and_pil(tmp_path, writer, kind):
    img = _image(kind)
    path = tmp_path / "x.png"
    _write(writer, kind, img, path)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, jread(str(path)))
    np.testing.assert_array_equal(got, _cv2_order(img))
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    assert png.png_size(path) == Image.open(path).size
    used = _filters_used(path)
    if writer == "port":
        assert used == {0, 1, 2, 3, 4}
    elif writer == "cv2":
        assert used == {1}


def test_pil_writes_paeth_and_up_rows(tmp_path):
    """A 1024 px VEDAI-like tile written by PIL: Sub, Up and Paeth rows."""
    rgb, _, _ = JSynth(n=1, img_size=1024, seed=11)[0]
    path = tmp_path / "t.png"
    Image.fromarray(rgb).save(path)
    assert {1, 2, 4} <= _filters_used(path)
    np.testing.assert_array_equal(png.read_png(path), rgb)


def test_channel_quirks_of_the_cv2_path(tmp_path):
    """RGBA (10, 20, 30, 40) reads as (40, 10, 20, 30); gray+alpha (50, 60)
    as (60, 50, 50, 50): JAX's cv2 branch, mirrored."""
    rgba = np.zeros((12, 12, 4), np.uint8) + np.uint8([10, 20, 30, 40])
    la = np.zeros((12, 12, 2), np.uint8) + np.uint8([50, 60])
    for arr, want in ((rgba, [40, 10, 20, 30]), (la, [60, 50, 50, 50])):
        p = tmp_path / f"{arr.shape[-1]}.png"
        Image.fromarray(arr, "RGBA" if arr.shape[-1] == 4 else "LA").save(p)
        assert png.read_png(p)[0, 0].tolist() == want
        assert jread(str(p))[0, 0].tolist() == want


def _pil_verdict(path) -> bool:
    try:
        with Image.open(path) as im:
            im.verify()
            w, h = im.size
            assert w > 9 and h > 9
        return True
    except Exception:
        return False


def _port_verdict(path) -> bool:
    try:
        png.verify_png(path)
        return True
    except Exception:
        return False


def test_verify_flags_what_pil_flags(tmp_path):
    """A sound file passes both; a truncated file, a corrupt CRC, a file
    without IEND and a 9 px side fail both."""
    good = tmp_path / "good.png"
    png.write_png(good, _image("rgb"))
    data = good.read_bytes()
    cases = {"good": data, "truncated": data[:len(data) // 2],
             "no_iend": data[:-12]}
    crc = bytearray(data)
    crc[40] ^= 0xFF                                  # inside IDAT's payload
    cases["bad_crc"] = bytes(crc)
    small = tmp_path / "small.png"
    png.write_png(small, _image("rgb", h=9, w=20))
    cases["small"] = small.read_bytes()
    for name, blob in cases.items():
        p = tmp_path / f"{name}.png"
        p.write_bytes(blob)
        assert _port_verdict(p) == _pil_verdict(p) == (name == "good"), name


def _ihdr_only(path, side: int) -> None:
    """A PNG of a few dozen bytes whose IHDR says side x side (1-bit gray),
    with a short IDAT: PIL's open and verify read no pixels."""
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    path.write_bytes(png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", side, side, 1, 0, 0, 0, 0)) + chunk(
        b"IDAT", zlib.compress(bytes(10))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("side,corrupt", [(14000, True), (9000, False)])
def test_scan_follows_pil_pixel_limit(tmp_path, side, corrupt):
    """PIL's open refuses more than 2 x 89478485 pixels (above 89478485 it
    only warns): JAX's scan marks a 14000 x 14000 IHDR corrupt and passes a
    9000 x 9000 one; so do the port's scan and `image_size`."""
    import warnings
    from sodt_tpu_torch.data import vedai as tv
    from torch_port_common import pil_scan
    path = tmp_path / f"ihdr{side}.png"
    _ihdr_only(path, side)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert (pil_scan(path) is None) == corrupt
    if corrupt:
        for read in (tv.verify_image, tv.image_size):
            with pytest.raises(ValueError, match="decompression bomb"):
                read(str(path))
    else:
        tv.verify_image(str(path))
        assert tv.image_size(str(path)) == (side, side)


def test_out_of_scope_pngs_raise(tmp_path):
    """What the PNG standard does not define raises ValueError in the
    port, as PIL refuses it too: a palette at 16 bits, colour type 5, gray
    at 3 bits. (16-bit and palette images, once
    refused here, are read: tests/test_torch_port_item11.py.)"""
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    for depth, ctype, interlace in ((16, 3, 0), (8, 5, 0), (3, 0, 0)):
        p = tmp_path / f"bad{depth}_{ctype}_{interlace}.png"
        ihdr = struct.pack(">IIBBBBB", 12, 12, depth, ctype, 0, 0, interlace)
        p.write_bytes(png.SIGNATURE + chunk(b"IHDR", ihdr)
                      + chunk(b"IDAT", zlib.compress(bytes(12 * 80)))
                      + chunk(b"IEND", b""))
        with pytest.raises(ValueError, match="broken PNG file"):
            png.read_png(p)
        with pytest.raises(Exception):
            np.asarray(Image.open(p))


# the factors of `_resize_longest`: r = 1, 1/2, 1/4, 1/8 (INTER_AREA on
# whole cells), 0.625 (INTER_AREA over partial cells), 1.25 (INTER_LINEAR)
RESIZE = [(1024, 1024), (1024, 512), (1024, 256), (1024, 128), (1024, 640),
          (512, 640)]


@pytest.mark.parametrize("kind", ["rgb", "gray"])
@pytest.mark.parametrize("src,dst", RESIZE,
                         ids=[f"{s}to{d}" for s, d in RESIZE])
def test_resize_is_cv2_bit_for_bit(kind, src, dst):
    """Bit-equal to cv2 at every factor (a square and a 4:3 image, noise
    over a scene, so ties of each rounding occur)."""
    rgb, ir, _ = JSynth(n=1, img_size=src, seed=3)[0]
    base = rgb if kind == "rgb" else ir[..., :1]
    noise = np.random.default_rng(src + dst).integers(0, 64, base.shape)
    img = ((base.astype(int) + noise) % 256).astype(np.uint8)
    for im in (img, img[: src * 3 // 4]):
        got = resize_longest(im, dst)
        want = jresize(im, dst)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("size", [64, 512])
def test_linear_resize_rounds_the_whole_row_as_cv2(channels, size):
    """Enlarged portrait images, whose rows are not a whole number of 16
    bytes: cv2 rounds the last bytes as its vector steps do, not with its
    scalar formula. Every width from 2 px to the size."""
    rng = np.random.default_rng(channels + size)
    for w in range(2, size, 1 if size == 64 else 37):
        h = min(w + 1 + w // 3, size - 1)
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        got = resize_longest(img, size)
        want = jresize(img, size)
        assert got.shape == want.shape, w
        np.testing.assert_array_equal(got, want, err_msg=f"width {w}")
