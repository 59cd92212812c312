"""VEDAI dataset preparation (`sodt_tpu/data/prepare.py`, numpy and the
stdlib; the label files are byte-equal to its).

Converts raw VEDAI annotations to YOLO label format and rewrites fold lists.
Pure stdlib/numpy (the reference uses pandas).

Raw VEDAI annotation format (one txt per image, e.g. Annotations512/
00000001.txt), columns as named in data_transform.py:12:

    x_center y_center orientation class is_contained is_occluded
    corner1_x corner2_x corner3_x corner4_x
    corner1_y corner2_y corner3_y corner4_y

Reference semantics reproduced exactly (data_transform.py:14-28):
  * the class remap is a SEQUENTIAL pandas .replace chain
    (1->0, 11->1, 2->3, 5->2, 4->5, 10->4, 23->6, 9->7) — order matters;
  * rows with a final class > 7 are dropped (so raw 8/31/201 vanish) but
    raw class 7 (motorcycles) is NOT remapped and survives as final class
    7, aliasing vans (raw 9 -> 7): a reference quirk kept for parity;
  * cx/cy come from the annotation's own center columns; w/h from the
    corner extents — all normalized by the image size.

Output row: ``cls cx cy w h`` (space-separated, one object per line).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# VEDAI raw id -> training id, applied as a sequential replace chain
# (data_transform.py:14-21). A dict lookup is equivalent here because no
# replacement target collides with a later source EXCEPT raw 7, which the
# reference never remaps (see module docstring).
CLASS_REMAP = {1: 0, 11: 1, 2: 3, 5: 2, 4: 5, 10: 4, 23: 6, 9: 7, 7: 7}


def update_annotation_row(row: list[float], img_w: float = 512.0,
                          img_h: float = 512.0):
    """One raw annotation row -> (cls, cx, cy, w, h) normalized, or None.

    ``row`` is the 14-column VEDAI record (see module docstring). Rows
    whose remapped class exceeds 7 are dropped (data_transform.py:27).
    """
    cls_raw = int(row[3])
    cls = CLASS_REMAP.get(cls_raw, cls_raw)
    if cls > 7:
        return None
    cx = float(row[0]) / img_w
    cy = float(row[1]) / img_h
    xs = np.asarray(row[6:10], np.float32)
    ys = np.asarray(row[10:14], np.float32)
    w = float(xs.max() - xs.min()) / img_w
    h = float(ys.max() - ys.min()) / img_h
    return cls, cx, cy, w, h


def update_annotations(src_file: str | Path, dst_file: str | Path,
                       img_size: float = 512.0) -> int:
    """One raw per-image annotation txt -> one YOLO label txt
    (data_transform.py:10-28). Returns the number of kept objects."""
    rows = []
    with open(src_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 14:
                continue
            out = update_annotation_row([float(x) for x in parts[:14]],
                                        img_size, img_size)
            if out is None:
                continue
            cls, cx, cy, w, h = out
            rows.append(f"{cls} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}")
    Path(dst_file).write_text("\n".join(rows) + ("\n" if rows else ""))
    return len(rows)


def makelabels(annotation_dir: str, out_dir: str, img_size: float = 512.0):
    """Annotation dir -> labels dir, one txt per image
    (data_transform.py:31-37: Annotations512/ -> labels/)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(annotation_dir)):
        if not name.endswith(".txt"):
            continue
        update_annotations(Path(annotation_dir) / name, out / name, img_size)
        n += 1
    return n


def changepath(fold_file: str, out_file: str, image_root: str,
               suffix: str = "") -> int:
    """Fold id list -> absolute image path list (data_transform.py:39-63).

    The reference writes bare path stems (LoadImagesAndLabels_sr appends
    ``_co.png`` itself, datasets.py:684-685); our VedaiDataset accepts
    either. Pass ``suffix="_co.png"`` for fully-resolved lists.
    """
    with open(fold_file) as f:
        ids = [ln.strip() for ln in f if ln.strip()]
    lines = [str(Path(image_root) / f"{i}{suffix}") for i in ids]
    Path(out_file).write_text("\n".join(lines) + "\n")
    return len(lines)


def main(argv=None):
    """CLI: python -m sodt_tpu_torch.data.prepare Annotations512/ labels/
    [--fold fold01.txt --fold-out fold01_write.txt --image-root imgs/]"""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("annotations", help="raw annotation directory "
                    "(one 14-column txt per image)")
    ap.add_argument("out_dir")
    ap.add_argument("--img-size", type=float, default=512.0)
    ap.add_argument("--fold", default="")
    ap.add_argument("--fold-out", default="")
    ap.add_argument("--image-root", default="")
    ap.add_argument("--suffix", default="_co.png",
                    help="appended to fold stems (empty = reference-style "
                         "bare stems)")
    a = ap.parse_args(argv)
    n = makelabels(a.annotations, a.out_dir, a.img_size)
    print(f"wrote labels for {n} images to {a.out_dir}")
    if a.fold and a.fold_out:
        m = changepath(a.fold, a.fold_out, a.image_root, a.suffix)
        print(f"wrote {m} image paths to {a.fold_out}")


if __name__ == "__main__":
    main()
