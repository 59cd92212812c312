"""The serving path of the port (`sodt_tpu_torch/models/infer.py`'s
`Predictor` and `Detections`, `sodt_tpu_torch/detect.py`) against the JAX
package's (`sodt_tpu/models/infer.py`, the repo-root `detect.py`), f32 on
the CPU, on the narrow flagship and on the all-CNN tests/tiny.yaml of
`tests/test_aux.py`, with weights carried across by `from_jax_variables`.
Their Detect biases are raised so that random weights clear the serving
threshold (conf 0.25).

Tolerances: the same detections per image, boxes within 1e-3 px of JAX's
in native pixels, scores and classes within 1e-4; the detect CLI's label
files line for line, coordinates within one unit of the written precision
(1e-6) plus 1e-3 px of the native size, conf within 1e-4 (the written
precision).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sodt_tpu.models.infer import Predictor as JPredictor
from sodt_tpu.ops.boxes import scale_coords as jscale_coords
from sodt_tpu.ops.letterbox import letterbox_image as jletterbox
from sodt_tpu.train.evaluate import make_eval_step as jstep
from sodt_tpu_torch import detect
from sodt_tpu_torch.data.png import write_png
from sodt_tpu_torch.models.infer import Detections, Predictor
from sodt_tpu_torch.ops.boxes import scale_coords as tscale_coords
from sodt_tpu_torch.weights import from_jax_variables, save_npz

from torch_port_common import NARROW_CFG, j, narrow_pair, tiny_pair

ROOT = Path(__file__).resolve().parent.parent
BOX_TOL = 1e-3        # px, native
SCORE_TOL = 1e-4
IMG = 64


@pytest.fixture(scope="module")
def served():
    """The narrow pair with the Detect objectness and class biases raised
    (obj +10, cls +3): a few to a few dozen boxes an image clear 0.25."""
    jm, v, tm = narrow_pair(3, IMG)
    bias = v["params"]["detect"]["m0"]["bias"].copy()
    bias[4::13] += 10.0
    for c in range(5, 13):
        bias[c::13] += 3.0
    v["params"]["detect"]["m0"]["bias"] = bias
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, tm


def _images():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (80, 100, 3), dtype=np.uint8),
            rng.integers(0, 256, (120, 90, 3), dtype=np.uint8)]


def _same(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(g[:, 4:], w[:, 4:], rtol=0,
                                   atol=SCORE_TOL)


def test_torch_scale_coords_matches_jax():
    """Native-pixel mapping with and without a letterbox's own ratio_pad
    (a rect batch's, scaleup off), clipping included."""
    rng = np.random.default_rng(2)
    boxes = rng.uniform(-20, 560, (50, 4)).astype(np.float32)
    for img1, img0, rp in (((512, 512), (1024, 768), None),
                           ((256, 320), (97, 131), None),
                           ((288, 224), (256, 192), ((1.0,), (16.0, 16.0))),
                           ((544, 544), (512, 384), ((0.75,), (80.5, 32.0)))):
        want = np.asarray(jscale_coords(img1, j(boxes), img0, ratio_pad=rp))
        got = tscale_coords(img1, torch.from_numpy(boxes), img0,
                            ratio_pad=rp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_torch_predictor_matches_jax(served, tmp_path, capsys):
    """The serving API on an 80 x 100 and a 120 x 90 image (arrays), and
    the same images given as PNG paths: boxes in native pixels."""
    jm, v, tm = served
    imgs = _images()
    names = [f"c{i}" for i in range(8)]
    want = JPredictor(jm, v, img_size=IMG, names=names)(imgs)
    pred = Predictor(tm, img_size=IMG, names=names)
    got = pred(imgs)
    assert isinstance(got, Detections) and len(got) == 2
    assert got.shapes == [(80, 100), (120, 90)]
    _same(got.dets, want.dets)
    paths = []
    for i, im in enumerate(imgs):
        paths.append(tmp_path / f"{i}.png")
        write_png(paths[-1], im)
    _same(pred(paths).dets, want.dets)
    got.print()
    want.print()
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and out[0].startswith("image 0: ")
    saved = got.save(tmp_path / "plots")
    assert [p.name for p in saved] == ["image0.png", "image1.png"]


def test_torch_predictor_on_tiny_yaml_matches_jax(tmp_path):
    """tests/test_aux.py's serving case on tests/tiny.yaml (RGB, 64 px,
    names a, b, c): an 80 x 100 and a 120 x 90 image as arrays, and the
    same images as JPEG paths, which both packages decode (JAX with cv2):
    the same detections, boxes in native pixels."""
    import cv2
    from sodt_tpu.data.vedai import _read_image as jread
    jm, v, tm = tiny_pair(2, detect_bias=6.0)
    imgs = _images()
    names = ["a", "b", "c"]
    want = JPredictor(jm, v, img_size=IMG, names=names)(imgs)
    pred = Predictor(tm, img_size=IMG, names=names)
    got = pred(imgs)
    assert got.shapes == [(80, 100), (120, 90)]
    _same(got.dets, want.dets)
    paths = []
    for i, im in enumerate(imgs):
        paths.append(str(tmp_path / f"{i}.jpg"))
        cv2.imwrite(paths[-1], cv2.GaussianBlur(im, (3, 3), 1)[..., ::-1])
    want = JPredictor(jm, v, img_size=IMG, names=names)(
        [jread(p) for p in paths])
    _same(pred(paths).dets, want.dets)


def test_torch_predictor_is_its_eval_step_after_scale_coords(served):
    """The Predictor's boxes are `make_eval_step` (conf 0.25, iou 0.45,
    one label a box, top_k 512) on its own letterboxed batch, mapped by
    `scale_coords`: bit for bit (the card's check, on the CPU)."""
    _, _, tm = served
    imgs = _images()
    pred = Predictor(tm, img_size=IMG)
    batch = pred.letterbox(imgs)
    dets, valid, _ = pred.step(batch, batch)
    for i, d in enumerate(pred(imgs).dets):
        ref = dets[i][valid[i]].clone()
        ref[:, :4] = tscale_coords((IMG, IMG), ref[:, :4], imgs[i].shape[:2])
        assert torch.equal(torch.from_numpy(d), ref)


def _jax_detect(jm, v, source, conf=0.25, iou=0.45):
    """JAX's detect loop (`detect.py` l.140-160) over the repo-root CLI's
    own `iter_sources`: (name, detections in native pixels) per image."""
    spec = importlib.util.spec_from_file_location("jax_detect_cli",
                                                  ROOT / "detect.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    step = jstep(jm, conf_thres=conf, iou_thres=iou, multi_label=False,
                 top_k=512, approx_topk=True)
    out = []
    for name, rgb, ir in cli.iter_sources(str(source), want_ir=True):
        h0, w0 = rgb.shape[:2]
        img = jletterbox(j(rgb), IMG, scaleup=True) / 255.0
        if ir is not None:
            if ir.shape[-1] == 1:
                ir = np.repeat(ir, 3, -1)
            ir = jletterbox(j(ir), IMG, scaleup=True) / 255.0
        else:
            ir = img
        dets, valid, _ = step(v, img[None], ir[None])
        d = np.asarray(dets[0])[np.asarray(valid[0])]
        if d.shape[0]:
            d[:, :4] = np.asarray(jscale_coords((IMG, IMG), j(d[:, :4]),
                                                (h0, w0)))
        out.append((name, d))
    return out


def test_torch_detect_cli_matches_jax_loop(served, tmp_path, capsys):
    """`python -m sodt_tpu_torch.detect` on a PNG folder written by the
    port's encoder: two `_co` / `_ir` pairs (the IR gray) and a `_co`
    without a partner (its RGB stands in, as in JAX), under RGB+IR with
    --save-txt: one label file per image, the same lines as JAX's loop."""
    jm, v, tm = served
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    for stem, (h, w), ir in (("a", (80, 100), True), ("b", (120, 90), True),
                             ("c", (64, 64), False)):
        write_png(src / f"{stem}_co.png",
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if ir:
            write_png(src / f"{stem}_ir.png",
                      rng.integers(0, 256, (h, w), dtype=np.uint8))
    (src / "notes.txt").write_text("not an image\n")
    npz = tmp_path / "w.npz"
    save_npz(from_jax_variables(v), npz)
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    res = detect.main(["--source", str(src), "--cfg", str(cfg), "--weights",
                       str(npz), "--img-size", str(IMG), "--input_mode",
                       "RGB+IR", "--save-dir", str(tmp_path / "out"),
                       "--save-txt", "--no-bf16", "--device", "cpu"])
    want = _jax_detect(jm, v, src)
    assert [r["source"] for r in res["results"]] == [n for n, _ in want]
    assert [r["n"] for r in res["results"]] == [len(d) for _, d in want]
    assert res["images"] == 3 and res["detections"] == sum(
        len(d) for _, d in want) > 0
    last = capsys.readouterr().out.splitlines()[-1]
    assert last == '{"images": 3, "detections": %d}' % res["detections"]
    labels = tmp_path / "out" / "labels"
    assert sorted(p.name for p in labels.iterdir()) == [
        "a_co.txt", "b_co.txt", "c_co.txt"]
    for name, d in want:
        lines = (labels / f"{Path(name).stem}.txt").read_text().splitlines()
        assert len(lines) == len(d)
        h0, w0 = {"a": (80, 100), "b": (120, 90), "c": (64, 64)}[
            Path(name).stem[0]]
        for line, (x1, y1, x2, y2, conf, cls) in zip(lines, d):
            f = line.split()
            assert int(f[0]) == int(cls)
            want_xywh = [(x1 + x2) / 2 / w0, (y1 + y2) / 2 / h0,
                         (x2 - x1) / w0, (y2 - y1) / h0]
            np.testing.assert_allclose(
                [float(x) for x in f[1:5]], want_xywh, rtol=0,
                atol=1e-6 + BOX_TOL / min(h0, w0))
            assert abs(float(f[5]) - conf) <= 1e-4


def test_torch_detect_cli_on_jpeg_pairs_matches_jax_loop(served, tmp_path):
    """`python -m sodt_tpu_torch.detect` on a JPEG folder (written by cv2,
    as a camera's files are): `x_co.jpg` picks up `x_ir.jpg` (gray,
    progressive) as JAX's `derive_ir_path` pairs them, a `_co.jpg` without
    a partner stands alone; under RGB+IR, the same detections as JAX's
    loop, which decodes with cv2."""
    import cv2
    jm, v, tm = served
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(6)
    for stem, (h, w), ir in (("a", (80, 100), True), ("b", (120, 90), True),
                             ("c", (64, 64), False)):
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                               (3, 3), 1)
        cv2.imwrite(str(src / f"{stem}_co.jpg"), img)
        if ir:
            cv2.imwrite(str(src / f"{stem}_ir.jpg"), img[..., 2],
                        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    npz = tmp_path / "w.npz"
    save_npz(from_jax_variables(v), npz)
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    res = detect.main(["--source", str(src), "--cfg", str(cfg), "--weights",
                       str(npz), "--img-size", str(IMG), "--input_mode",
                       "RGB+IR", "--save-dir", str(tmp_path / "out"),
                       "--no-bf16", "--device", "cpu"])
    want = _jax_detect(jm, v, src)
    assert [r["source"] for r in res["results"]] == [n for n, _ in want]
    assert [Path(n).name for n, _ in want] == ["a_co.jpg", "b_co.jpg",
                                                "c_co.jpg"]
    assert res["detections"] == sum(len(d) for _, d in want) > 0
    got = [tm_dets for tm_dets in _port_dets(tm, src)]
    _same(got, [d for _, d in want])


def _port_dets(tm, src):
    """The port's detections per image of `src` through its own
    `iter_sources` and `Predictor` (what the CLI runs)."""
    pred = Predictor(tm, img_size=IMG)
    return [pred([rgb], [ir] if ir is not None else None).dets[0]
            for _, rgb, ir in detect.iter_sources(str(src), want_ir=True)]


@pytest.mark.parametrize("args,what", [
    (["--save-img"], None),
    (["--max-frames", "10"], "--max-frames"),
    (["--source", "0"], "stream source"),
    (["--source", "rtsp://camera/stream"], "stream source"),
    (["--source", "cams.streams"], "stream source"),
    (["--source", "VIDEO"], "video source"),
], ids=["save_img", "max_frames", "webcam", "rtsp", "streams", "video"])
def test_torch_detect_refuses_unported_sources(tmp_path, monkeypatch, args,
                                               what):
    """Streams, video and --max-frames, once refused here, are ported: on
    a machine without cv2 (the card's; cv2 hidden here) a live source
    raises JAX's RuntimeError and a video JAX's ImportError, after the
    model is built, as in JAX; --max-frames is taken (1000 by default).
    --save-img (`what` None) writes the image with its boxes beside the
    labels. The live sources with cv2 are in test_torch_port_item11.py."""
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    write_png(tmp_path / "a.png", np.zeros((40, 60, 3), np.uint8))
    common = ["--cfg", str(cfg), "--device", "cpu", "--no-bf16",
              "--img-size", "64", "--input_mode", "RGB+IR", "--save-dir",
              str(tmp_path / "out")]
    if what is None:
        detect.main(["--source", str(tmp_path / "a.png")] + common + args)
        assert (tmp_path / "out" / "a.png").stat().st_size > 0
        return
    assert detect.parser().parse_args(["--source", "x"]).max_frames == 1000
    if what == "--max-frames":
        out = detect.main(["--source", str(tmp_path / "a.png")] + common
                          + args)
        assert out["images"] == 1
        return
    (tmp_path / "clip.mp4").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "cv2", None)
    argv = ["--source", str(tmp_path)] + common
    argv += [a.replace("VIDEO", str(tmp_path / "clip.mp4")) for a in args]
    if what == "video source":
        with pytest.raises(ImportError):
            detect.main(argv)
    else:
        with pytest.raises(RuntimeError,
                           match="stream sources need OpenCV"):
            detect.main(argv)
