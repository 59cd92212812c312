"""The port's reference-weight import, the rest of PNG, live sources and
video in `detect`, the dataset tools and WBF, against the JAX package on
the CPU:

  * `utils.torch_import`: each importer equals `from_jax_variables` of
    JAX's importer's tree, bit for bit (the same names, the same f32
    values): the flagship on a state_dict of the in-repo checkpoint made by
    `tools/export_torch.py`'s `export_flagship_state_dict`; yolo5m and the
    SwinV2 encoder on a state_dict made from JAX's init tree by an inverse
    map written here, which JAX's importer must carry back to that tree;
  * `data.png`: 16-bit, palette (1-8 bits), tRNS and sub-byte gray
    images, written by PIL, cv2 or an encoder of this file, decode as
    JAX's `_read_image` decodes them where cv2 is absent (its PIL branch,
    the card machine's); Adam7 images (this file's encoder) decode as
    their non-interlaced twins and as JAX's `_read_image`;
    `read_png_rgb` equals PIL's `convert("RGB")`;
  * `data.streams` and `detect`'s video and live sources against JAX's
    under one fake cv2 module: names, frames, BGR -> RGB, --max-frames,
    StopIteration after close; JAX's errors without cv2;
  * `data.tools`: autosplit's files and the flattened tree identical to
    JAX's; extract_boxes' JPEG crops byte-equal to the ones JAX writes;
  * `ops.wbf`: equal to JAX's on tests/test_aux.py's cases and a seeded
    random one.
"""

from __future__ import annotations

import importlib.util
import re
import struct
import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from PIL import Image

from sodt_tpu_torch.data import png
from torch_port_common import drawn_variables
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_state_dicts(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def _same_trees(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            _same_trees(a[k], b[k], f"{path}/{k}")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


# ------------------------------------------------------------ torch_import

def test_flagship_import_equals_jax():
    """The trained flagship through tools/export_torch.py's reference
    state_dict: the port's import is `from_jax_variables` of JAX's, and
    loads strictly into the port's model."""
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train.checkpoint import eval_variables, load_checkpoint
    from sodt_tpu.utils.torch_import import import_flagship_model as jimp
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.utils.torch_import import import_flagship_model
    from sodt_tpu_torch.weights import from_jax_variables
    export = _module("export_torch", ROOT / "tools/export_torch.py")
    v = jax.tree.map(np.asarray, eval_variables(
        load_checkpoint(ROOT / "runs/flagship_r5_150ep/best_stripped")))
    jm = jbuild(str(ROOT / "sodt_tpu/configs/model.yaml"), ch_in=4)
    sd = {k: torch.from_numpy(np.ascontiguousarray(x)) for k, x in
          export.export_flagship_state_dict(v, jm.spec).items()}
    tm = tbuild(str(ROOT / "sodt_tpu_torch/configs/model.yaml"), ch_in=4)
    got = import_flagship_model(sd, tm.spec)
    _same_state_dicts(got, from_jax_variables(jimp(sd, jm.spec)))
    tm.load_state_dict(got)


def _leaf_to_reference(leaf: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """A flax leaf -> the reference's leaf name and layout."""
    if leaf == "kernel":
        return "weight", (v.T if v.ndim == 2 else v.transpose(3, 2, 0, 1))
    return {"scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(leaf, leaf), v


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _unified_reference(v: dict, spec) -> dict:
    """Inverse of JAX's `import_unified_model`: l{i} -> model.{i}, m{k} ->
    m.{k}, detect -> model.{Detect's index}."""
    det = [ld.i for ld in spec.head if ld.name == "Detect"][0]
    sd = {}
    for col in ("params", "batch_stats"):
        for path, x in _flat(v[col]):
            mods = [f"model.{det}" if p == "detect"
                    else f"model.{p[1:]}" if re.fullmatch(r"l\d+", p)
                    else f"m.{p[1:]}" if re.fullmatch(r"m\d+", p) else p
                    for p in path[:-1]]
            name, x = _leaf_to_reference(path[-1], x)
            sd[".".join(mods + [name])] = torch.from_numpy(
                np.ascontiguousarray(x))
    return sd


def _swinv2_reference(enc: dict) -> dict:
    """Inverse of JAX's `import_swinv2_encoder`."""
    subs = ((r"^layer(\d+)_blk(\d+)\.", r"layers.\1.blocks.\2."),
            (r"^downsample(\d+)\.", r"layers.\1.downsample."),
            (r"cpb_mlp0", "cpb_mlp.0"), (r"cpb_mlp1", "cpb_mlp.2"),
            (r"mlp_fc(\d)", r"mlp.fc\1"))
    sd = {}
    for path, x in _flat(enc):
        name, x = _leaf_to_reference(path[-1], x)
        key = ".".join(path[:-1] + (name,))
        for pat, rep in subs:
            key = re.sub(pat, rep, key)
        sd[key] = torch.from_numpy(np.ascontiguousarray(x))
    return sd


def test_unified_import_equals_jax():
    """yolo5m (Focus, Conv, C3, SPP, Detect at three levels): the inverse
    map's state_dict goes back to JAX's init tree through JAX's importer;
    the port's import of it is `from_jax_variables` of JAX's."""
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.utils.torch_import import import_unified_model as jimp
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.utils.torch_import import import_unified_model
    from sodt_tpu_torch.weights import from_jax_variables
    jm = jbuild(str(ROOT / "sodt_tpu/configs/yolo5m.yaml"), ch_in=3,
                input_mode="RGB")
    x = np.zeros((1, 64, 64, 3), np.float32)
    v = drawn_variables(jm, x, x, seed=4, train=True)
    sd = _unified_reference(v, jm.spec)
    back = jimp(sd, jm.spec)
    _same_trees(back, v)
    tm = tbuild(str(ROOT / "sodt_tpu_torch/configs/yolo5m.yaml"), ch_in=3,
                input_mode="RGB")
    got = import_unified_model(sd, tm.spec)
    _same_state_dicts(got, from_jax_variables(back))
    tm.load_state_dict(got)
    mix = SimpleNamespace(i=0, name="MixConv2d", args=())
    with pytest.raises(NotImplementedError, match="no importer for module "
                                                  "MixConv2d"):
        import_unified_model(sd, SimpleNamespace(backbone=(mix,), head=()))


def test_swinv2_encoder_import_equals_jax():
    """The SwinV2 encoder (depths 2, 2, 6, 2): the inverse map's
    state_dict goes back to JAX's init tree; the port's import is
    `from_jax_variables` of JAX's and loads strictly into the port's
    encoder."""
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.utils.torch_import import import_swinv2_encoder as jimp
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.utils.torch_import import import_swinv2_encoder
    from sodt_tpu_torch.weights import from_jax_variables
    jm = jbuild(str(ROOT / "sodt_tpu/configs/model_swinv2.yaml"), ch_in=4)
    x = np.zeros((1, 64, 64, 3), np.float32)
    enc = drawn_variables(jm, x, x, seed=5)["params"]["l0"]
    sd = _swinv2_reference(enc)
    back = jimp(sd)
    _same_trees(back, enc)
    got = import_swinv2_encoder(sd)
    _same_state_dicts(got, from_jax_variables({"params": back}))
    tm = tbuild(str(ROOT / "sodt_tpu_torch/configs/model_swinv2.yaml"),
                ch_in=4)
    tm.l0.load_state_dict(got)


# --------------------------------------------------------------------- PNG

def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _rows(samples: np.ndarray, depth: int) -> list[bytes]:
    """(h, w, spp) samples -> each row's bytes at `depth` bits."""
    h, w, spp = samples.shape
    if depth == 16:
        return [samples[y].astype(">u2").tobytes() for y in range(h)]
    if depth == 8:
        return [samples[y].astype(np.uint8).tobytes() for y in range(h)]
    bits = np.unpackbits(samples.astype(np.uint8)[..., :1], axis=-1)
    bits = bits[..., 8 - depth:].reshape(h, w * depth)
    return [np.packbits(bits[y]).tobytes() for y in range(h)]


def _encode(samples: np.ndarray, depth: int, ctype: int, *, adam7=False,
            extra: bytes = b"") -> bytes:
    """A PNG of `samples` (file order), every row filter Paeth (4) where
    `adam7`, else Sub (1), interlaced or not."""
    h, w, _ = samples.shape
    if adam7:
        raw = b""
        for y0, x0, dy, dx in png.ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += b"".join(b"\x00" + r for r in _rows(sub, depth))
    else:
        raw = b"".join(b"\x00" + r for r in _rows(samples, depth))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(adam7))
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _jax_pil(path, monkeypatch):
    """JAX's `_read_image` where cv2 is absent (its PIL branch)."""
    from sodt_tpu.data import vedai
    with monkeypatch.context() as m:
        m.setattr(vedai, "_HAS_CV2", False)
        return vedai._read_image(str(path))


def _variants(tmp_path) -> dict:
    """name -> a PNG file of each variant, its writer in the name."""
    rng = np.random.default_rng(11)
    h, w = 13, 17
    rgb8 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    c16 = rng.integers(0, 65536, (h, w, 4), dtype=np.uint16)
    out = {}

    def put(name, write):
        p = tmp_path / f"{name}.png"
        write(p)
        out[name] = p
    put("pil_gray16", lambda p: Image.fromarray(g16).save(p))
    put("cv2_rgb16", lambda p: cv2.imwrite(str(p), c16[..., :3]))
    put("cv2_rgba16", lambda p: cv2.imwrite(str(p), c16))
    put("own_gray_alpha16", lambda p: p.write_bytes(
        _encode(c16[..., :2], 16, 4)))
    put("pil_palette8", lambda p: Image.fromarray(rgb8).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=200).save(p))
    put("pil_palette4", lambda p: Image.fromarray(rgb8).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=12).save(p, bits=4))
    put("pil_palette_trns", lambda p: Image.fromarray(rgb8).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=64).save(
        p, transparency=3))
    put("pil_rgb_trns", lambda p: Image.fromarray(rgb8).save(
        p, transparency=tuple(int(c) for c in rgb8[0, 0])))
    put("pil_gray_trns", lambda p: Image.fromarray(rgb8[..., 0]).save(
        p, transparency=int(rgb8[0, 0, 0])))
    put("pil_gray1", lambda p: Image.fromarray(rgb8[..., 0] > 127).save(p))
    for d in (2, 4):
        put(f"own_gray{d}", lambda p, d=d: p.write_bytes(_encode(
            rgb8[..., :1] >> (8 - d), d, 0)))
        pal = _chunk(b"PLTE", rng.integers(0, 256, 3 << d,
                                           dtype=np.uint8).tobytes())
        put(f"own_palette{d}", lambda p, d=d, pal=pal: p.write_bytes(
            _encode(rgb8[..., :1] >> (8 - d), d, 3, extra=pal)))
    return out


def test_png_variants_equal_jax_pil_branch(tmp_path, monkeypatch):
    """Each variant decodes as JAX's `_read_image` decodes it through PIL
    (dtype, shape, values), e.g. 16-bit gray as uint16 (H, W, 1) and a
    palette image as its INDEX plane (H, W, 1); `read_png_rgb` equals
    PIL's convert("RGB")."""
    for name, p in _variants(tmp_path).items():
        got, want = png.read_png(p), _jax_pil(p, monkeypatch)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(
            png.read_png_rgb(p), np.asarray(Image.open(p).convert("RGB")),
            err_msg=name)
    assert png.read_png(tmp_path / "pil_gray16.png").dtype == np.uint16
    assert png.read_png(tmp_path / "pil_palette8.png").shape[-1] == 1


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray_alpha8", "rgba8",
                                  "gray16", "rgb16", "palette2", "gray1"])
def test_adam7_equals_plain_and_jax(tmp_path, monkeypatch, kind):
    """An Adam7 file of this file's encoder (image sizes that leave some
    passes empty) decodes as its non-interlaced twin and as JAX's
    `_read_image` (cv2's branch for 8-bit images without a palette, as for
    their plain twins; PIL's for the rest)."""
    depth = int(re.sub(r"\D", "", kind))
    ctype = {"gray": 0, "rgb": 2, "gray_alpha": 4, "rgba": 6,
             "palette": 3}[re.sub(r"\d", "", kind)]
    spp = png.CHANNELS[ctype]
    extra = _chunk(b"PLTE", bytes(range(12))) if ctype == 3 else b""
    for h, w in ((5, 3), (9, 14), (1, 1)):
        rng = np.random.default_rng(h * w)
        samples = rng.integers(0, 1 << depth, (h, w, spp)).astype(
            np.uint16 if depth == 16 else np.uint8)
        a, b = tmp_path / f"{h}x{w}_adam7.png", tmp_path / f"{h}x{w}.png"
        a.write_bytes(_encode(samples, depth, ctype, adam7=True, extra=extra))
        b.write_bytes(_encode(samples, depth, ctype, extra=extra))
        got = png.read_png(a)
        np.testing.assert_array_equal(got, png.read_png(b))
        from sodt_tpu.data.vedai import _read_image
        want = (_read_image(str(a)) if depth == 8 and ctype != 3
                else _jax_pil(a, monkeypatch))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- streams and video

class _FakeCapture:
    """cv2.VideoCapture over a fixed source: BGR frames made from the
    source's name; a file ends after `n` frames, a live source never."""

    def __init__(self, src, n=None):
        self.src, self.i, self.n, self.open = str(src), 0, n, True

    def isOpened(self):
        return self.open

    def read(self):
        if self.n is not None and self.i >= self.n:
            return False, None
        seed = sum(map(ord, self.src)) + (self.i if self.n else 0)
        self.i += 1
        return True, np.random.default_rng(seed).integers(
            0, 256, (6, 8, 3), dtype=np.uint8)

    def release(self):
        self.open = False


def _fake_cv2(n_video=3):
    mod = type(sys)("cv2")
    mod.VideoCapture = lambda src: _FakeCapture(
        src, n_video if str(src).endswith(".mp4") else None)
    return mod


def _jax_detect():
    return _module("jax_detect_cli_item11", ROOT / "detect.py")


def test_streams_and_video_equal_jax_under_a_fake_cv2(tmp_path,
                                                      monkeypatch):
    from sodt_tpu.data.streams import StreamSource as JStream
    from sodt_tpu.data.streams import is_stream_source as jis
    from sodt_tpu_torch import detect
    from sodt_tpu_torch.data.streams import StreamSource, is_stream_source
    jdetect = _jax_detect()
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2())
    (tmp_path / "cams.streams").write_text("0\nrtsp://cam/a\n")
    for s in ("0", "rtsp://x", "RTMP://y", "https://z", "a.streams",
              "img_co.png", "clip.mp4", "12a"):
        assert is_stream_source(s) == jis(s), s
    src = str(tmp_path / "cams.streams")
    with StreamSource(src) as t, JStream(src) as jx:
        assert t.names == jx.names == ["0", "rtsp://cam/a"] and len(t) == 2
        (tn, tf), (jn, jf) = next(t), next(jx)
        assert tn == jn
        for a, b, name in zip(tf, jf, tn):
            np.testing.assert_array_equal(a, b)
            bgr = _FakeCapture(name).read()[1]
            np.testing.assert_array_equal(a, bgr[..., ::-1])
    with pytest.raises(StopIteration):
        next(t)
    got = list(detect.iter_stream_frames(src, 5))
    want = list(jdetect.iter_stream_frames(src, 5))
    assert [g[0] for g in got] == [w[0] for w in want] == [
        "0#0", "rtsp://cam/a#1", "0#2", "rtsp://cam/a#3", "0#4"]
    for (_, a, ia), (_, b, ib) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert ia is ib is None
    (tmp_path / "clip.mp4").write_bytes(b"")
    png.write_png(tmp_path / "a.png", np.full((4, 5, 3), 9, np.uint8))
    got = list(detect.iter_sources(str(tmp_path)))
    want = list(jdetect.iter_sources(str(tmp_path)))
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[0] for g in got][1:] == [f"{tmp_path / 'clip.mp4'}#{i}"
                                       for i in range(3)]
    for (_, a, _), (_, b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_live_sources_without_cv2_raise_as_jax(tmp_path, monkeypatch):
    """Without cv2 (the card's machine): a live source raises JAX's
    RuntimeError, a video JAX's ImportError, in both packages."""
    from sodt_tpu.data.streams import StreamSource as JStream
    from sodt_tpu_torch import detect
    from sodt_tpu_torch.data.streams import StreamSource
    jdetect = _jax_detect()
    monkeypatch.setitem(sys.modules, "cv2", None)
    for make in (StreamSource, JStream):
        with pytest.raises(RuntimeError, match="stream sources need OpenCV"):
            make("0")
    (tmp_path / "clip.mp4").write_bytes(b"")
    for mod in (detect, jdetect):
        with pytest.raises(ImportError):
            list(mod.iter_sources(str(tmp_path / "clip.mp4")))


# ------------------------------------------------------------- data tools

def _labelled_tree(root: Path) -> Path:
    """images/{a,b}_co.png (RGB), images/sub/c.png (palette) with their
    labels, and a file of another kind."""
    rng = np.random.default_rng(3)
    (root / "images/sub").mkdir(parents=True)
    (root / "labels/sub").mkdir(parents=True)
    for stem, h, w in (("a_co", 40, 60), ("b_co", 50, 30)):
        png.write_png(root / f"images/{stem}.png",
                      rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (30, 45, 3), dtype=np.uint8)).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=40).save(
        root / "images/sub/c.png")
    np.savetxt(root / "labels/a.txt", [[0, 0.5, 0.5, 0.3, 0.4],
                                       [2, 0.1, 0.9, 0.2, 0.2]], fmt="%.6f")
    np.savetxt(root / "labels/b.txt", [[1, 0.95, 0.05, 0.5, 0.5]],
               fmt="%.6f")
    np.savetxt(root / "labels/sub/c.txt", [[3, 0.4, 0.6, 0.25, 0.5]],
               fmt="%.6f")
    (root / "images/notes.txt").write_text("not an image\n")
    return root


def test_autosplit_and_flatten_equal_jax(tmp_path):
    from sodt_tpu.data import tools as jtools
    from sodt_tpu_torch.data import tools
    root = _labelled_tree(tmp_path / "set")
    jtools.autosplit(str(root / "images"), (0.5, 0.3, 0.2), seed=7)
    want = {t: (root / "images" / t).read_text() for t in
            ("autosplit_train.txt", "autosplit_val.txt", "autosplit_test.txt")
            if (root / "images" / t).exists()}
    tools.main(["autosplit", str(root / "images"), "--weights",
                "0.5,0.3,0.2", "--seed", "7"])
    got = {t: (root / "images" / t).read_text() for t in want}
    assert got == want and sum(len(v.splitlines()) for v in got.values()) == 3
    flat = lambda d: {p.name: p.read_bytes() for p in Path(d).iterdir()}
    want = flat(jtools.flatten_recursive(str(root / "labels")))
    assert flat(tools.flatten_recursive(str(root / "labels"))) == want
    assert sorted(want) == ["a.txt", "b.txt", "c.txt"]


def test_extract_boxes_crops_equal_jax(tmp_path):
    """The port's crops are JAX's: `.jpg` files under the same class
    directories and names, byte-equal to the ones PIL writes, from PNG and
    JPEG (colour and gray) sources alike; cv2 decodes each to PIL's
    pixels."""
    from sodt_tpu.data import tools as jtools
    from sodt_tpu_torch.data import tools
    root = _labelled_tree(tmp_path / "set")
    rng = np.random.default_rng(5)
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (70, 90, 3), np.uint8),
                              (5, 5), 2)
    cv2.imwrite(str(root / "images/d_co.jpg"), smooth)
    cv2.imwrite(str(root / "images/sub/e.jpg"), smooth[:41, :57, 1],
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    np.savetxt(root / "labels/d.txt", [[0, 0.3, 0.4, 0.5, 0.6],
                                       [1, 0.8, 0.8, 0.3, 0.3]], fmt="%.6f")
    np.savetxt(root / "labels/sub/e.txt", [[2, 0.5, 0.5, 0.9, 0.9]],
               fmt="%.6f")
    files = lambda d: {p.relative_to(d): p.read_bytes()
                       for p in sorted(Path(d).rglob("*")) if p.is_file()}
    want = files(jtools.extract_boxes(str(root)))
    got = files(tools.extract_boxes(str(root)))
    assert sorted(got) == sorted(want) and len(got) == 7
    assert all(k.suffix == ".jpg" for k in got)
    for k in want:
        dec = lambda b: cv2.imdecode(np.frombuffer(b, np.uint8),
                                     cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(dec(got[k]), dec(want[k]))
        assert got[k] == want[k], k


# -------------------------------------------------------------------- WBF

def test_wbf_equals_jax():
    from sodt_tpu.ops import wbf as jwbf
    from sodt_tpu_torch.ops import wbf
    boxes = np.array([[0.1, 0.1, 0.3, 0.3], [0.11, 0.1, 0.31, 0.3],
                      [0.6, 0.6, 0.8, 0.8]])
    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 0.8, (40, 2))
    rand = np.concatenate([xy, xy + rng.uniform(0.05, 0.2, (40, 2))], 1)
    cases = [
        (boxes, np.array([0.9, 0.8, 0.7]), np.zeros(3), {"iou_thr": 0.5}),
        (np.tile(boxes[:1], (2, 1)), np.array([0.9, 0.8]),
         np.array([0.0, 1.0]), {"iou_thr": 0.5}),
        (rand, rng.uniform(0, 1, 40), rng.integers(0, 3, 40).astype(float),
         {"iou_thr": 0.3, "skip_box_thr": 0.2, "conf_type": "max"}),
        (rand, rng.uniform(0, 1, 40), rng.integers(0, 3, 40).astype(float),
         {}),
        (np.zeros((0, 4)), np.zeros(0), np.zeros(0), {})]
    for b, s, lab, kw in cases:
        for x, y in zip(wbf.weighted_boxes_fusion(b, s, lab, **kw),
                        jwbf.weighted_boxes_fusion(b, s, lab, **kw)):
            np.testing.assert_array_equal(x, y)
    dets = np.array([[10, 10, 30, 30, 0.9, 0], [11, 10, 31, 30, 0.8, 0]],
                    float)
    got, want = wbf.weighted_boxes(dets, 512), jwbf.weighted_boxes(dets, 512)
    assert got.shape == (1, 6)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        wbf.weighted_boxes(rand[:0].reshape(0, 6), 512),
        jwbf.weighted_boxes(rand[:0].reshape(0, 6), 512))
