"""The serving API (`sodt_tpu/models/infer.py`): `Predictor` and its
`Detections`.

`Predictor` takes numpy images (HWC uint8, RGB; gray is repeated to three
channels), PNG or JPEG paths (decoded by the port's own
`data.vedai._read_image`), or lists of them, with an optional IR image
each; it letterboxes every
image on the model's device, runs one batched eval step with the serving
settings (conf 0.25, iou 0.45, max_det 300, one label a box, top_k 512)
and maps the boxes back to each image's native pixels. JAX's Predictor
asks for an approximate top-k at 512; on the CPU JAX's approximate top-k
is exact, and the port's stable sort is exact everywhere, so the two agree
whenever the candidates clearing the conf gate fit in 512.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.boxes import scale_coords
from ..ops.letterbox import letterbox_image
from ..train.evaluate import cache_rel_bias, make_eval_step


class Detections:
    """Per-image detections in native pixels: `dets` a list of (n, 6)
    xyxy + conf + cls arrays, `shapes` the images' (h, w); `imgs` the
    images (HWC uint8), which `save` draws."""

    def __init__(self, dets: list[np.ndarray], shapes, names, imgs=None):
        self.dets = dets
        self.shapes = shapes
        self.names = names
        self.imgs = imgs
        self.n = len(dets)

    def __len__(self):
        return self.n

    def pandas(self):
        """One DataFrame an image (pandas is imported here, on use)."""
        import pandas as pd
        return [pd.DataFrame(d, columns=["xmin", "ymin", "xmax", "ymax",
                                         "confidence", "class"])
                for d in self.dets]

    def print(self):
        for i, d in enumerate(self.dets):
            counts: dict[str, int] = {}
            for cls in d[:, 5].astype(int):
                name = self.names[cls] if cls < len(self.names) else str(cls)
                counts[name] = counts.get(name, 0) + 1
            desc = ", ".join(f"{v} {k}" for k, v in counts.items()) or "none"
            print(f"image {i}: {desc}")

    def save(self, save_dir="runs/detect/exp") -> list:
        """`<save_dir>/image{i}.png`: each image with its boxes
        (`utils.plots.plot_images`). Returns the paths written: none where
        matplotlib is missing, which it then says on one line."""
        from ..utils.plots import boxes_as_targets, missing_reason, plot_images
        if missing_reason():
            print(f"Detections.save: no image written: {missing_reason()}")
            return []
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        return [plot_images(img[None].astype(np.float32) / 255.0,
                            *boxes_as_targets(d, img.shape[:2]),
                            Path(save_dir) / f"image{i}.png", self.names)
                for i, (d, img) in enumerate(zip(self.dets, self.imgs))]


def _to_array(item) -> np.ndarray:
    if isinstance(item, (str, Path)):
        from ..data.vedai import _read_image
        item = _read_image(str(item))
    img = np.asarray(item)
    if img.ndim == 2:
        img = img[..., None]
    return np.repeat(img, 3, -1) if img.shape[-1] == 1 else img


class Predictor:
    """Input-robust inference over a model that holds its weights on its
    device (the serving settings are the class's; the detect CLI passes
    its own thresholds and top-k)."""

    conf = 0.25
    iou = 0.45
    max_det = 300
    top_k = 512

    def __init__(self, model, img_size: int = 512, names=None, *,
                 conf_thres: float | None = None,
                 iou_thres: float | None = None, top_k: int | None = None):
        self.model = cache_rel_bias(model)
        self.img_size = img_size
        self.names = names or [str(i) for i in range(model.spec.nc)]
        self.step = make_eval_step(
            model, conf_thres=self.conf if conf_thres is None else conf_thres,
            iou_thres=self.iou if iou_thres is None else iou_thres,
            max_det=self.max_det, multi_label=False,
            top_k=self.top_k if top_k is None else top_k)

    def letterbox(self, imgs) -> torch.Tensor:
        """HWC uint8 images -> one (B, S, S, 3) f32 batch in [0, 1] on the
        model's device."""
        dev = next(self.model.parameters()).device
        return torch.stack([
            letterbox_image(torch.as_tensor(im, dtype=torch.float32,
                                            device=dev), self.img_size) / 255.0
            for im in imgs])

    def __call__(self, inputs, ir=None) -> Detections:
        items = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        irs = ir if isinstance(ir, (list, tuple)) else [ir] * len(items)
        imgs = [_to_array(x) for x in items]
        ir_imgs = [_to_array(x) if x is not None else im
                   for x, im in zip(irs, imgs)]
        shapes = [im.shape[:2] for im in imgs]
        dets, valid, _ = self.step(self.letterbox(imgs),
                                   self.letterbox(ir_imgs))
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        out = []
        for i, hw in enumerate(shapes):
            d = dets[i][valid[i]].copy()
            if len(d):
                d[:, :4] = scale_coords((self.img_size, self.img_size),
                                        torch.from_numpy(d[:, :4]),
                                        hw).numpy()
            out.append(d)
        return Detections(out, shapes, self.names, imgs)
