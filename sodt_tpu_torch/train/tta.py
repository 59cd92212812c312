"""Test-time-augmented inference (`sodt_tpu/train/tta.py`).

Three passes: identity, lr-flip at 0.83x, 0.67x. Each pass resizes the
NHWC batch with JAX's own 4-tap bilinear formula (half-pixel centres, edges
clamped, no antialias), pads it to a multiple of `gs` with 0.447, runs the
model and decodes; the boxes are de-scaled (all four columns divided by
the scale) and the flipped pass is de-flipped (x -> w - x). The passes'
predictions are concatenated for one NMS.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.detect import decode_detections

TTA_SCALES = (1.0, 0.83, 0.67)
TTA_FLIPS = (None, 3, None)  # 3 = left-right
PAD_VALUE = 0.447


def scale_img_shape(h: int, w: int, ratio: float, gs: int = 32):
    """(resized h, w, padded h, w). The pad target comes from the
    UNROUNDED product, the resize from its truncation."""
    nh, nw = int(h * ratio), int(w * ratio)
    ph = math.ceil(h * ratio / gs) * gs
    pw = math.ceil(w * ratio / gs) * gs
    return nh, nw, ph, pw


def _source_coords(n_in: int, n_out: int):
    """JAX's f32 source coordinates (i + 0.5) * (n_in / n_out) - 0.5, each
    op rounded to f32 as JAX rounds it (the ratio is taken in Python):
    the floor index, the clamped pair of taps and the fraction."""
    f = np.float32
    s = (np.arange(n_out, dtype=f) + f(0.5)) * f(n_in / n_out) - f(0.5)
    s0 = np.floor(s)
    i0 = s0.astype(np.int64)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1),
            (s - s0).astype(f))


def _bilinear_resize(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(B, H, W, C) f32 -> (B, nh, nw, C) by explicit gathers of the four
    taps (`F.interpolate` forms the source coordinate differently)."""
    _, h, w, _ = img.shape
    dev = img.device
    y0, y1, fy = (torch.from_numpy(a).to(dev, non_blocking=True)
                  for a in _source_coords(h, nh))
    x0, x1, fx = (torch.from_numpy(a).to(dev, non_blocking=True)
                  for a in _source_coords(w, nw))
    fy = fy[None, :, None, None]
    fx = fx[None, None, :, None]
    r0, r1 = img[:, y0], img[:, y1]
    top = r0[:, :, x0] * (1 - fx) + r0[:, :, x1] * fx
    bot = r1[:, :, x0] * (1 - fx) + r1[:, :, x1] * fx
    return top * (1 - fy) + bot * fy


def scale_img(img: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """Resize an NHWC f32 batch by `ratio`, then pad bottom and right to a
    multiple of `gs` with 0.447."""
    if ratio == 1.0:
        return img
    _, h, w, _ = img.shape
    nh, nw, ph, pw = scale_img_shape(h, w, ratio, gs)
    out = _bilinear_resize(img, nh, nw)
    return F.pad(out, (0, 0, 0, pw - nw, 0, ph - nh), value=PAD_VALUE)


def tta_forward(model, img: torch.Tensor, ir: torch.Tensor | None,
                gs: int | None = None) -> torch.Tensor:
    """Augmented inference: the passes' decoded predictions concatenated,
    (B, sum_i N_i, no) f32 in the input's pixel space. `gs` defaults to
    max(32, the largest Detect stride), as in JAX."""
    anchors, strides = model.anchors_per_level, model.strides
    if gs is None:
        gs = max(32, int(max(strides)))
    w = img.shape[2]
    outs = []
    for si, fi in zip(TTA_SCALES, TTA_FLIPS):
        xi = img.flip(2) if fi == 3 else img
        ii = ir.flip(2) if fi == 3 and ir is not None else ir
        xi = scale_img(xi, si, gs)
        ii = scale_img(ii, si, gs) if ii is not None else None
        y = decode_detections(model(xi, ii)["raw"], anchors, strides)
        # a true f32 division: on the card a Python divisor would become a
        # multiply by its reciprocal (torch.full: no copy from the host)
        box = y[..., :4] / torch.full((), si, dtype=y.dtype, device=y.device)
        if fi == 3:
            box = torch.cat([w - box[..., :1], box[..., 1:]], -1)
        outs.append(torch.cat([box, y[..., 4:]], -1))
    return torch.cat(outs, 1)
