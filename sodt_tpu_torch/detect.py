"""Inference CLI of the port (`detect.py` of the JAX package), on the card.

    python -m sodt_tpu_torch.detect --source images/ --input_mode RGB+IR \\
        --weights checkpoints/flagship_r5_150ep_ema.npz --save-txt

--source is an image or video file, a folder of them, a webcam index, an
rtsp / rtmp / http(s) URL or a `.streams` list of them. Images are PNG,
JPEG, BMP, TIFF or WebP files, decoded by the port itself (`data.vedai.
_read_image`; an animated WebP raises NotImplementedError naming "animated
WebP"); a video is read frame by frame with cv2
(imported there; frames named `<file>#<i>`), and a live source through
`data.streams.StreamSource` (cv2 too) until --max-frames frames (1000 by
default). Without cv2, as on the card's machine, a video raises
ImportError and a live source RuntimeError, as in JAX.
Under RGB+IR a `*_co.png` picks up the `*_ir.png` beside it (a `*_co.jpg`
its `*_ir.jpg`, by JAX's `derive_ir_path`), and `_ir` files are skipped as
pair partners. Each image goes through
`models.infer.Predictor` (device letterbox, one eval step, boxes back in
native pixels) with the serving rule of the JAX CLI: top_k 512 when
--conf-thres >= 0.1, else the eval protocol's 4096. --save-txt writes
`<save-dir>/labels/<stem>.txt` (class cx cy w h conf, normalized by the
native size); --save-img writes `<save-dir>/<stem>.png`, the image with
its boxes (`utils.plots.plot_images`), where matplotlib is installed, and
otherwise prints one line saying that no image was written and why. --int8 runs inside `kernels.int8_serving()`, as `val --int8`.
Weights: --weights (a .npz state_dict or a checkpoint of the port), else a
torch.Generator seeded with 0. --device (or --platform, JAX's name)
defaults to cuda and raises when no card is visible; --device cpu runs the
plain PyTorch path. Prints one line per image and, last, {"images",
"detections"}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import numpy as np
import torch
import yaml

from . import resolve_device
from .data.streams import StreamSource, is_stream_source
from .data.vedai import _read_image, derive_ir_path
from .kernels import int8_serving
from .models import build_model
from .models.compiler import resolve_config_path
from .models.infer import Predictor
from .train.checkpoint import load_into
from .train.evaluate import write_yolo_txt
from .utils.plots import boxes_as_targets, missing_reason, plot_images
from .weights import init_weights

IMG_EXT = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}
VID_EXT = {".mp4", ".avi", ".mov", ".mkv"}
CH_IN = {"RGB": 3, "IR": 3, "RGB+IR": 4}


def iter_sources(source: str, want_ir: bool = False):
    """Yield (name, rgb uint8 HWC, ir or None) frames from a file, a
    folder or a video (PNG, JPEG, BMP, TIFF and WebP images). Under RGB+IR a
    `*_co.png` / `*_co.jpg` / ... picks up its `*_ir` sibling where it
    exists, and `_ir` files are skipped as pair partners."""
    p = Path(source)
    files = sorted(p.glob("*")) if p.is_dir() else [p]
    for f in files:
        if f.suffix.lower() in IMG_EXT:
            if "_ir" in f.stem and want_ir:
                continue  # read as a pair partner
            ir = None
            if want_ir:
                irp = Path(derive_ir_path(str(f)))
                if irp.exists() and irp != f:
                    ir = _read_image(str(irp))
            yield str(f), _read_image(str(f)), ir
        elif f.suffix.lower() in VID_EXT:
            import cv2
            cap = cv2.VideoCapture(str(f))
            i = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield f"{f}#{i}", frame[..., ::-1].copy(), None  # BGR -> RGB
                i += 1
            cap.release()


def iter_stream_frames(source: str, max_frames: int):
    """Yield (name, rgb, None) from live sources until max_frames."""
    n = 0
    with StreamSource(source) as src:
        for names, frames in src:
            for name, frame in zip(names, frames):
                yield f"{name}#{n}", frame, None
                n += 1
                if n >= max_frames:
                    return


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", required=True,
                    help="image / folder / video path, webcam index, "
                         "rtsp/http URL, or .streams list file")
    ap.add_argument("--max-frames", type=int, default=1000,
                    help="stop live streams after N frames")
    ap.add_argument("--cfg", default="configs/model.yaml")
    ap.add_argument("--weights", default="")
    ap.add_argument("--data", default="configs/data_vedai.yaml")
    ap.add_argument("--img-size", type=int, default=512)
    ap.add_argument("--conf-thres", type=float, default=0.25)
    ap.add_argument("--iou-thres", type=float, default=0.45)
    ap.add_argument("--input_mode", default="RGB",
                    choices=["RGB", "IR", "RGB+IR"])
    ap.add_argument("--save-dir", default="runs/detect/exp")
    ap.add_argument("--save-txt", action="store_true")
    ap.add_argument("--save-img", action="store_true",
                    help="write each image with its boxes to --save-dir "
                         "(needs matplotlib)")
    ap.add_argument("--no-bf16", action="store_false", dest="bf16")
    ap.add_argument("--int8", action="store_true",
                    help="int8 serving (K12), as val --int8")
    ap.add_argument("--device", "--platform", default="cuda")
    return ap


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    if a.save_img and missing_reason():
        print(f"--save-img: no image written: {missing_reason()}")
    with int8_serving() if a.int8 else contextlib.nullcontext():
        return _run(a)


def _run(a) -> dict:
    dev = resolve_device(a.device)
    with open(resolve_config_path(a.data)) as f:
        data_cfg = yaml.safe_load(f)
    nc = int(data_cfg.get("nc", 8))
    names = data_cfg.get("names", [str(i) for i in range(nc)])
    model = build_model(a.cfg, ch_in=CH_IN[a.input_mode], nc=nc,
                        dtype=torch.bfloat16 if a.bf16 else torch.float32,
                        input_mode=a.input_mode)
    if a.weights:
        load_into(model, a.weights)
    else:
        init_weights(model, seed=0)
    # serving settings: the exact sort over 512 candidates holds all that
    # clear a serving threshold; below it (mAP-style sweeps) far more
    # clear, and the eval protocol's 4096 is taken
    predictor = Predictor(model.to(dev).eval(), a.img_size, names,
                          conf_thres=a.conf_thres, iou_thres=a.iou_thres,
                          top_k=512 if a.conf_thres >= 0.1 else 4096)
    labels = Path(a.save_dir) / "labels"
    labels.mkdir(parents=True, exist_ok=True)
    results = []
    frames = (iter_stream_frames(a.source, a.max_frames)
              if is_stream_source(a.source)
              else iter_sources(a.source, want_ir="IR" in a.input_mode))
    for name, rgb, ir in frames:
        d = predictor([rgb], ir=[ir]).dets[0]
        results.append({"source": name, "n": int(d.shape[0])})
        print(f"{name}: {d.shape[0]} detections")
        if a.save_txt:
            write_yolo_txt(labels / f"{Path(name).stem}.txt", d,
                           rgb.shape[:2], ".4f")
        if a.save_img:
            plot_images(rgb[None].astype(np.float32) / 255.0,
                        *boxes_as_targets(d, rgb.shape[:2]),
                        Path(a.save_dir) / f"{Path(name).stem}.png", names)
    out = {"images": len(results),
           "detections": sum(r["n"] for r in results)}
    print(json.dumps(out))
    return dict(out, results=results)


if __name__ == "__main__":
    main()
