"""YOLO detection loss with fixed-shape target assignment
(`sodt_tpu/train/loss.py`).

Every candidate (target x anchor x offset) slot exists statically and a
boolean mask switches it on, as in the JAX package, so both packages
compute the same sums in the same shapes:

  targets (B, M, 5) [cls, cx, cy, w, h] normalized, tmask (B, M) bool.

Anchor match max(r, 1/r) < anchor_t on the wh ratios; the centre cell plus
its two nearest neighbours (offsets 0.5); grid indices clamped to the map;
CIoU box loss; the objectness target is the scatter-MAX of the detached,
clamped IoU over the slots that land on one (cell, anchor); BCE class loss
with the cp/cn smoothing hooks; optional focal modulation; the per-level
obj balance; the total carries `* batch size`.

In the data-parallel train step (`world` W > 1 ranks, `parallel.mesh`)
each rank holds B / W rows of the global batch, and its loss is its share
of the global one, so that the ranks' losses sum to it: lbox and lcls divide by the
global count of positives, max(sum over ranks, 1) (clamped after the
sum, as JAX's mesh counts them); the objectness mean of each level is
taken over the rank's rows and divided by W (equal shards); the total
carries `* global batch size`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou
from ..parallel.mesh import all_reduce_tensors


def smooth_bce(eps: float = 0.1) -> tuple[float, float]:
    """Positive / negative label-smoothing targets."""
    return 1.0 - 0.5 * eps, 0.5 * eps


def bce_with_logits(logits, targets, pos_weight: float = 1.0):
    """Elementwise BCE-with-logits with positive weighting (no reduction)."""
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    return -(pos_weight * targets * log_p + (1.0 - targets) * log_not_p)


def focal_modulation(logits, targets, loss, gamma: float, alpha: float = 0.25):
    """TF-style focal factor applied to a BCE loss."""
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * (1.0 - p_t) ** gamma


def qfocal_modulation(logits, targets, loss, gamma: float,
                      alpha: float = 0.25):
    """Quality focal factor."""
    p = torch.sigmoid(logits)
    alpha_f = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_f * torch.abs(targets - p) ** gamma


def bce_blur_with_logits(pred, true, alpha: float = 0.05):
    """BCE with a reduced missing-label effect; returns the mean."""
    loss = bce_with_logits(pred, true)
    dx = torch.sigmoid(pred) - true
    alpha_factor = 1 - torch.exp((dx - 1) / (alpha + 1e-4))
    return (loss * alpha_factor).mean()


class LossConfig(NamedTuple):
    nc: int
    anchors: tuple          # per-level ((w,h)*na,) pixel anchors
    strides: tuple          # per-level strides
    hyp_box: float = 0.05
    hyp_obj: float = 1.0
    hyp_cls: float = 0.5
    cls_pw: float = 1.0
    obj_pw: float = 1.0
    anchor_t: float = 4.0
    fl_gamma: float = 0.0
    gr: float = 1.0
    label_smoothing: float = 0.0

    @property
    def nl(self) -> int:
        return len(self.anchors)

    @property
    def na(self) -> int:
        return len(self.anchors[0]) // 2

    @property
    def balance(self) -> tuple:
        return {3: (4.0, 1.0, 0.4)}.get(
            self.nl, (4.0, 1.0, 0.25, 0.06, 0.02))


def build_targets_level(targets: torch.Tensor, tmask: torch.Tensor,
                        anchors_grid: torch.Tensor, ny: int, nx: int,
                        anchor_t: float) -> dict:
    """Assign padded targets to one detection level, fixed shapes.

    targets (B, M, 5) normalized [cls, cx, cy, w, h]; tmask (B, M) bool;
    anchors_grid (na, 2) in grid units. Returns (B, M, na, 5)-shaped
    assignment tensors (the last axis: the centre cell and its four
    neighbour offsets)."""
    b, m, _ = targets.shape
    na = anchors_grid.shape[0]
    dev = targets.device
    gain = torch.tensor([nx, ny, nx, ny], dtype=torch.float32, device=dev)

    txywh = targets[..., 1:5] * gain
    tcls = targets[..., 0]

    r = txywh[..., None, 2:4] / anchors_grid[None, None]
    anchor_ok = torch.maximum(r, 1.0 / r).amax(dim=-1) < anchor_t

    gxy = txywh[..., 0:2]
    gxi = gain[0:2] - gxy
    fx, fy = gxy[..., 0], gxy[..., 1]
    ix, iy = gxi[..., 0], gxi[..., 1]
    g = 0.5
    # the coordinates are non-negative, where torch's % and jnp's agree
    j = (fx % 1.0 < g) & (fx > 1.0)          # take left cell
    k = (fy % 1.0 < g) & (fy > 1.0)          # take top cell
    l = (ix % 1.0 < g) & (ix > 1.0)          # take right cell
    mm = (iy % 1.0 < g) & (iy > 1.0)         # take bottom cell

    off_ok = torch.stack([torch.ones_like(j), j, k, l, mm], dim=-1)
    offsets = torch.tensor([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]],
                           dtype=torch.float32, device=dev) * g

    pos = (tmask[..., None, None] & anchor_ok[..., None]
           & off_ok[:, :, None])                           # (B, M, na, 5)

    gij = torch.floor(gxy[:, :, None, None, :] - offsets[None, None, None])
    gi = gij[..., 0].clamp(0, nx - 1).expand(b, m, na, 5).long()
    gj = gij[..., 1].clamp(0, ny - 1).expand(b, m, na, 5).long()

    txy = gxy[:, :, None, None, :] - torch.stack([gi, gj], dim=-1)
    twh = txywh[:, :, None, None, 2:4].expand(b, m, na, 5, 2)
    tbox = torch.cat([txy, twh], dim=-1)                   # (B, M, na, 5, 4)

    anc = anchors_grid[None, None, :, None, :].expand(b, m, na, 5, 2)
    a_idx = torch.arange(na, device=dev)[None, None, :, None].expand(
        b, m, na, 5)
    cls_b = tcls[:, :, None, None].expand(b, m, na, 5).long()
    return dict(pos=pos, gi=gi, gj=gj, a=a_idx, tbox=tbox, anchors=anc,
                tcls=cls_b)


def compute_loss(preds: Sequence[torch.Tensor], targets: torch.Tensor,
                 tmask: torch.Tensor, cfg: LossConfig, world: int = 1):
    """Total detection loss.

    preds: per-level raw outputs (B, ny, nx, na, 5+nc) from Detect;
    targets / tmask as in `build_targets_level`. Returns (total,
    dict(box=, obj=, cls=)); the total carries the `* batch size` scale.
    `world` > 1: this rank's share of the global loss over that many
    ranks of the default process group (module doc)."""
    bsz = preds[0].shape[0] * world
    nc = cfg.nc
    cp, cn = smooth_bce(cfg.label_smoothing)
    dev = preds[0].device
    lbox = torch.zeros((), dtype=torch.float32, device=dev)
    lobj = torch.zeros((), dtype=torch.float32, device=dev)
    lcls = torch.zeros((), dtype=torch.float32, device=dev)

    for li, p in enumerate(preds):
        b, ny, nx, na, no = p.shape
        anchors_grid = (torch.tensor(cfg.anchors[li], dtype=torch.float32,
                                     device=dev).reshape(na, 2)
                        / cfg.strides[li])
        asn = build_targets_level(targets, tmask, anchors_grid, ny, nx,
                                  cfg.anchor_t)
        pos = asn["pos"]
        if world > 1:
            npos = all_reduce_tensors([pos.sum().float()])[0].clamp(min=1)
        else:
            npos = pos.sum().clamp(min=1)

        # gather predictions at the assigned slots
        pf = p.reshape(b, ny * nx * na, no).float()
        fi = ((asn["gj"] * nx + asn["gi"]) * na + asn["a"]).reshape(b, -1)
        ps = torch.gather(pf, 1, fi[..., None].expand(-1, -1, no))
        ps = ps.reshape(pos.shape + (no,))                 # (B, M, na, 5, no)

        # box loss (CIoU)
        pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * asn["anchors"]
        iou = bbox_iou(torch.cat([pxy, pwh], dim=-1), asn["tbox"],
                       xyxy=False, ciou=True)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        lbox = lbox + torch.where(pos, 1.0 - iou, zero).sum() / npos

        # objectness target map: scatter-max of the IoU into (B, ny*nx*na)
        tobj_val = (1.0 - cfg.gr) + cfg.gr * iou.detach().clamp(min=0.0)
        tobj_val = torch.where(pos, tobj_val, zero).reshape(b, -1)
        tobj = torch.zeros((b, ny * nx * na), dtype=torch.float32, device=dev)
        tobj.scatter_reduce_(1, fi, tobj_val, "amax", include_self=True)

        obj_logits = pf[..., 4]
        obj_loss = bce_with_logits(obj_logits, tobj, cfg.obj_pw)
        if cfg.fl_gamma > 0:
            obj_loss = focal_modulation(obj_logits, tobj, obj_loss,
                                        cfg.fl_gamma)
        obj_mean = obj_loss.mean() if world == 1 else obj_loss.mean() / world
        lobj = lobj + obj_mean * cfg.balance[li]

        # classification loss at the positives
        if nc > 1:
            onehot = F.one_hot(asn["tcls"], nc).float()
            t = cn * (1 - onehot) + onehot * cp
            cls_logits = ps[..., 5:]
            cls_loss = bce_with_logits(cls_logits, t, cfg.cls_pw)
            if cfg.fl_gamma > 0:
                cls_loss = focal_modulation(cls_logits, t, cls_loss,
                                            cfg.fl_gamma)
            lcls = lcls + (torch.where(pos[..., None], cls_loss, zero).sum()
                           / (npos * nc))

    lbox = lbox * cfg.hyp_box
    lobj = lobj * cfg.hyp_obj
    lcls = lcls * cfg.hyp_cls
    total = (lbox + lobj + lcls) * bsz
    return total, {"box": lbox, "obj": lobj, "cls": lcls}
