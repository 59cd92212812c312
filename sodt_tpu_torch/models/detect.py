"""Anchor-based YOLO Detect head and grid decode (`sodt_tpu/models/detect.py`).

Raw outputs keep the JAX layout (B, ny, nx, na, no), so the flattened
candidate order that NMS sees is the same in both packages.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .swin import Conv


def detect_bias(nc: int, na: int, stride: float) -> torch.Tensor:
    """Per-anchor bias [x,y,w,h,obj,cls...]: obj log(8/(640/stride)^2),
    cls log(0.6/(nc-0.99))."""
    b = torch.zeros(na, nc + 5)
    b[:, 4] += math.log(8 / (640 / stride) ** 2)
    b[:, 5:] += math.log(0.6 / (nc - 0.99))
    return b.reshape(-1)


class Detect(nn.Module):
    """Per-level 1x1 output convs; returns a list of (B, ny, nx, na, no)."""

    def __init__(self, nc: int, anchors, strides, ch):
        super().__init__()
        self.nc, self.anchors, self.strides = nc, anchors, tuple(strides)
        self.na = len(anchors[0]) // 2
        self.no = nc + 5
        for i, c in enumerate(ch):
            conv = Conv(c, self.no * self.na, 1, bias=True)
            with torch.no_grad():
                conv.bias.copy_(detect_bias(nc, self.na, self.strides[i]))
            setattr(self, f"m{i}", conv)

    def forward(self, xs):
        outs = []
        for i, x in enumerate(xs):
            y = getattr(self, f"m{i}")(x)
            b, ny, nx, _ = y.shape
            outs.append(y.reshape(b, ny, nx, self.na, self.no))
        return outs


def decode_detections(outs, anchors, strides) -> torch.Tensor:
    """Raw per-level logits -> (B, total, no) pixel-space predictions, f32:
    xy = (sigmoid*2 - 0.5 + grid) * stride, wh = (sigmoid*2)^2 * anchor."""
    zs = []
    for out, anc, s in zip(outs, anchors, strides):
        b, ny, nx, na, no = out.shape
        y = torch.sigmoid(out.float())
        yv, xv = torch.meshgrid(
            torch.arange(ny, dtype=torch.float32, device=out.device),
            torch.arange(nx, dtype=torch.float32, device=out.device),
            indexing="ij")
        grid = torch.stack([xv, yv], dim=-1)[:, :, None, :]
        anc = torch.as_tensor(anc, dtype=torch.float32).to(
            out.device, non_blocking=True).reshape(1, 1, 1, na, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * s
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        z = torch.cat([xy, wh, y[..., 4:]], dim=-1)
        zs.append(z.reshape(b, ny * nx * na, no))
    return torch.cat(zs, dim=1)
