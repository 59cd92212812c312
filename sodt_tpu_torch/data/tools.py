"""Dataset maintenance tools (`sodt_tpu/data/tools.py`), on the host:

  * flatten_recursive: copy every file of a directory tree into a flat
    sibling `<path>_flat` directory;
  * extract_boxes: crop each labelled box into `classifier/<class>/`
    (a detection set into a classification set), each box padded by
    1.2x + 3 px and clipped to the image;
  * autosplit: write autosplit_{train,val,test}.txt, each image assigned
    to a split by a weighted draw from `random.Random(seed)`.

    python -m sodt_tpu_torch.data.tools {flatten,boxes,autosplit} <path>

`extract_boxes` reads each image as PIL's `convert("RGB")` gives it, with
the decoder its signature chooses: PNG with `png.read_png_rgb`, JPEG with
the host library's (`native_loader.decode_jpeg`, gray repeated to RGB;
CMYK and YCCK as PIL's "CMYK;I" samples, 255 minus libjpeg's, through its
CMYK to RGB), BMP with `bmp.read_bmp_rgb`, TIFF and DNG (a TIFF, its IFD0
read) with `tiff.read_tiff_rgb` (palette colours, alpha dropped) and WebP
with the host library's (`native_loader.decode_webp`, alpha dropped, after
PIL's open walk `webp.webp_size`; `webp.read_webp_rgb` is its plain
version); an animated WebP raises NotImplementedError naming "animated
WebP".
It writes each crop as JAX does, a `.jpg` under JAX's name, with the
port's encoder (`jpeg.write_jpeg`: PIL's defaults, the bytes PIL writes).
"""

from __future__ import annotations

import glob
import random
import shutil
from pathlib import Path

import numpy as np

from . import native_loader
from .bmp import read_bmp_rgb
from .jpeg import write_jpeg
from .png import read_png_rgb
from .tiff import _cmyk_pil, read_tiff_rgb
from .webp import webp_size
from .vedai import _unsupported, derive_label_path, image_format

IMG_FORMATS = {"bmp", "jpg", "jpeg", "png", "tif", "tiff", "dng", "webp"}


def flatten_recursive(path: str) -> Path:
    """Bring all files of a directory tree to a flat `<path>_flat` dir."""
    new_path = Path(str(path) + "_flat")
    shutil.rmtree(new_path, ignore_errors=True)
    new_path.mkdir(parents=True)
    for file in glob.glob(str(Path(path)) + "/**/*.*", recursive=True):
        shutil.copyfile(file, new_path / Path(file).name)
    return new_path


def extract_boxes(path: str) -> Path:
    """Crop labelled boxes into one directory per class, as JPEGs."""
    path = Path(path)
    out = path / "classifier"
    if out.is_dir():
        shutil.rmtree(out)
    for im_file in sorted(path.rglob("*.*")):
        if im_file.suffix[1:].lower() not in IMG_FORMATS:
            continue
        lb_file = Path(derive_label_path(str(im_file)))
        if not lb_file.exists():
            continue
        fmt = image_format(str(im_file))
        if fmt in ("PNG", "BMP", "TIFF", "DNG"):
            im = {"PNG": read_png_rgb, "BMP": read_bmp_rgb,
                  "TIFF": read_tiff_rgb, "DNG": read_tiff_rgb}[fmt](im_file)
        elif fmt == "WebP":
            webp_size(im_file)                 # PIL's open refuses it first
            im = native_loader.decode_webp(im_file)
            im = im[..., 1:] if im.shape[2] == 4 else im
        elif fmt == "JPEG":
            im = native_loader.decode_jpeg(im_file, raw_cmyk=True)
            if im.shape[2] == 1:
                im = np.repeat(im, 3, axis=2)
            elif im.shape[2] == 4:     # PIL reads JPEG CMYK as "CMYK;I"
                im = _cmyk_pil(255 - im)
        else:
            raise _unsupported(str(im_file), fmt)
        h, w = im.shape[:2]
        lb = np.loadtxt(lb_file, ndmin=2, dtype=np.float32)
        for j, x in enumerate(lb):
            c = int(x[0])
            f = out / f"{c}" / f"{path.stem}_{im_file.stem}_{j}.jpg"
            f.parent.mkdir(parents=True, exist_ok=True)
            b = x[1:5] * [w, h, w, h]
            b[2:] = b[2:] * 1.2 + 3  # pad
            x1 = int(np.clip(b[0] - b[2] / 2, 0, w))
            x2 = int(np.clip(b[0] + b[2] / 2, 0, w))
            y1 = int(np.clip(b[1] - b[3] / 2, 0, h))
            y2 = int(np.clip(b[1] + b[3] / 2, 0, h))
            crop = im[y1:y2, x1:x2]
            if not crop.size:
                raise ValueError(f"box failure in {f}")
            write_jpeg(f, crop)
    return out


def autosplit(path: str, weights=(0.9, 0.1, 0.0), seed: int | None = None):
    """Write autosplit_{train,val,test}.txt assigning each image to a
    split with the given weights."""
    path = Path(path)
    files = sorted(path.rglob("*.*"))
    rng = random.Random(seed)
    txt = ["autosplit_train.txt", "autosplit_val.txt",
           "autosplit_test.txt"]
    for t in txt:
        (path / t).unlink(missing_ok=True)
    for img in files:
        if img.suffix[1:].lower() not in IMG_FORMATS:
            continue
        i = rng.choices([0, 1, 2], weights=weights, k=1)[0]
        with open(path / txt[i], "a") as f:
            f.write(str(img) + "\n")
    return [path / t for t in txt]


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("cmd", choices=["flatten", "boxes", "autosplit"])
    p.add_argument("path")
    p.add_argument("--weights", default="0.9,0.1,0.0")
    p.add_argument("--seed", type=int, default=None)
    a = p.parse_args(argv)
    if a.cmd == "flatten":
        print(flatten_recursive(a.path))
    elif a.cmd == "boxes":
        print(extract_boxes(a.path))
    else:
        w = tuple(float(x) for x in a.weights.split(","))
        print([str(x) for x in autosplit(a.path, w, a.seed)])


if __name__ == "__main__":
    main()
