"""Box geometry used by NMS, eval and the loss (`sodt_tpu/ops/boxes.py`):
the same formulas, so that NMS sees bit-identical IoUs on the CPU."""

from __future__ import annotations

import math

import numpy as np
import torch


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner boxes [x1,y1,x2,y2] -> center boxes [cx,cy,w,h]."""
    x1, y1, x2, y2 = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    return torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) center boxes [cx,cy,w,h] -> corner boxes [x1,y1,x2,y2]."""
    cx, cy, w, h = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    hw, hh = w / 2, h / 2
    return torch.cat([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


def xywhn2xyxy(x: torch.Tensor, w: float = 640, h: float = 640) -> torch.Tensor:
    """Normalized center boxes -> pixel corner boxes (no letterbox pad)."""
    cx, cy, bw, bh = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    return torch.cat([w * (cx - bw / 2), h * (cy - bh / 2),
                      w * (cx + bw / 2), h * (cy + bh / 2)], dim=-1)


def clip_coords(boxes: torch.Tensor, img_hw: tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to image bounds (h, w); extra columns pass through."""
    h, w = img_hw
    return torch.cat([boxes[..., 0:1].clamp(0, w), boxes[..., 1:2].clamp(0, h),
                      boxes[..., 2:3].clamp(0, w), boxes[..., 3:4].clamp(0, h),
                      boxes[..., 4:]], dim=-1)


def scale_coords(img1_hw, coords: torch.Tensor, img0_hw,
                 ratio_pad=None) -> torch.Tensor:
    """Undo the letterbox: xyxy coords in the network's `img1_hw` (h, w)
    back to the native `img0_hw`, then clipped to it. `ratio_pad`
    ((gain,), (padw, padh)) is the letterbox's own, as a rect batch
    carries it; without it the gain and pad are those of a centred
    letterbox from img0 to img1, formed in f32 as JAX forms them."""
    if ratio_pad is None:
        f = np.float32
        gain = f(min(img1_hw[0] / img0_hw[0], img1_hw[1] / img0_hw[1]))
        padw = float((f(img1_hw[1]) - f(img0_hw[1]) * gain) / f(2))
        padh = float((f(img1_hw[0]) - f(img0_hw[0]) * gain) / f(2))
        gain = float(gain)
    else:
        gain = ratio_pad[0][0]
        padw, padh = ratio_pad[1]
    out = torch.cat([(coords[..., 0:1] - padw) / gain,
                     (coords[..., 1:2] - padh) / gain,
                     (coords[..., 2:3] - padw) / gain,
                     (coords[..., 3:4] - padh) / gain,
                     coords[..., 4:]], dim=-1)
    return clip_coords(out, img0_hw)


def box_iou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N, M)."""
    area1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    area2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    lt = torch.maximum(box1[..., :, None, :2], box2[..., None, :, :2])
    rb = torch.minimum(box1[..., :, None, 2:4], box2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[..., :, None] + area2[..., None, :] - inter)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, *, xyxy: bool = True,
             giou: bool = False, diou: bool = False, ciou: bool = False,
             eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU / GIoU / DIoU / CIoU of broadcastable (..., 4) boxes
    -> (...). As in the JAX package: eps goes on the heights only when the
    union is formed, the CIoU aspect term uses atan, and its alpha is held
    out of the gradient."""
    if xyxy:
        b1_x1, b1_y1, b1_x2, b1_y2 = (box1[..., i] for i in range(4))
        b2_x1, b2_y1, b2_x2, b2_y2 = (box2[..., i] for i in range(4))
    else:
        b1_x1 = box1[..., 0] - box1[..., 2] / 2
        b1_x2 = box1[..., 0] + box1[..., 2] / 2
        b1_y1 = box1[..., 1] - box1[..., 3] / 2
        b1_y2 = box1[..., 1] + box1[..., 3] / 2
        b2_x1 = box2[..., 0] - box2[..., 2] / 2
        b2_x2 = box2[..., 0] + box2[..., 2] / 2
        b2_y1 = box2[..., 1] - box2[..., 3] / 2
        b2_y2 = box2[..., 1] + box2[..., 3] / 2

    inter_w = (torch.minimum(b1_x2, b2_x2)
               - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
    inter_h = (torch.minimum(b1_y2, b2_y2)
               - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    inter = inter_w * inter_h

    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (giou or diou or ciou):
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if ciou or diou:
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2
                + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
        if diou:
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2)
                                  - torch.atan(w1 / h1)) ** 2
        alpha = (v / (v - iou + (1 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    c_area = cw * ch + eps
    return iou - (c_area - union) / c_area
