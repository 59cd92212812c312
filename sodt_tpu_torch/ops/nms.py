"""Fixed-shape batched NMS (`sodt_tpu/ops/nms.py`), on the device.

The same pipeline as the JAX package, written over a batch dimension:

  1. score = obj * cls; multi-label expands every (box, class) pair.
  2. the top-k candidates by score (k static) replace the dynamic conf
     filter; sub-threshold entries are masked to score 0.
  3. boxes are offset by class * MAX_WH so one IoU matrix handles
     per-class NMS.
  4. greedy selection runs max_det fixed steps of argmax + suppress
     against the precomputed (k, k) IoU matrix.
  5. optional merge-NMS (weighted box fusion of the survivors), gated on
     1 < n < 3000 candidates, with the redundancy rule.

Top-k ties break as `jax.lax.top_k` breaks them, lower index first: a
stable descending sort, never `torch.topk`.
"""

from __future__ import annotations

import torch

from .boxes import xywh2xyxy, box_iou

MAX_WH = 4096.0  # class-offset multiplier


@torch.no_grad()
def batched_nms(preds: torch.Tensor, *, conf_thres: float = 0.25,
                iou_thres: float = 0.45, multi_label: bool = False,
                max_det: int = 300,
                top_k: int = 4096, merge: bool = True):
    """(B, N, 5+nc) xywh+obj+cls predictions -> ((B, max_det, 6) dets as
    xyxy+conf+cls, (B, max_det) bool valid). Entries beyond the survivors
    are zero."""
    bsz, n, no = preds.shape
    nc = no - 5
    dev, dt = preds.device, preds.dtype
    boxes = xywh2xyxy(preds[..., :4])
    obj = preds[..., 4]
    cls_conf = preds[..., 5:] * obj[..., None]
    obj_ok = obj > conf_thres

    if multi_label and nc > 1:
        keep = obj_ok[..., None] & (cls_conf > conf_thres)
        scores = torch.where(keep, cls_conf,
                             torch.zeros((), dtype=dt, device=dev))
        scores = scores.reshape(bsz, n * nc)
        cls_ids = torch.arange(nc, dtype=dt, device=dev).repeat(n)
        cls_ids = cls_ids.expand(bsz, n * nc)
        cand_boxes = boxes.repeat_interleave(nc, dim=1)
    else:
        best = cls_conf.argmax(dim=-1)
        best_conf = cls_conf.amax(dim=-1)
        scores = torch.where(obj_ok & (best_conf > conf_thres), best_conf,
                             torch.zeros((), dtype=dt, device=dev))
        cls_ids = best.to(dt)
        cand_boxes = boxes

    n_cand = (scores > 0.0).sum(dim=-1)
    k = min(top_k, scores.shape[1])
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(cand_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls_ids, 1, top_idx)
    cand_valid = top_scores > 0.0

    off = top_boxes + (top_cls * MAX_WH)[..., None]
    iou = box_iou(off, off)                                   # (B, k, k)

    rows = torch.arange(bsz, device=dev)
    ar = torch.arange(k, device=dev)
    alive = cand_valid
    live = torch.where(cand_valid, top_scores, torch.zeros((), dtype=dt, device=dev))
    kept_idx, kept_ok = [], []
    for _ in range(max_det):
        idx = live.argmax(dim=-1)                              # (B,)
        ok = live[rows, idx] > 0.0
        suppress = (iou[rows, idx] > iou_thres) | (ar[None] == idx[:, None])
        alive = alive & torch.where(ok[:, None], ~suppress, alive)
        live = torch.where(alive, live, torch.zeros((), dtype=dt, device=dev))
        kept_idx.append(idx)
        kept_ok.append(ok)
    kept_idx = torch.stack(kept_idx, dim=1)                    # (B, max_det)
    kept_ok = torch.stack(kept_ok, dim=1)

    gather = lambda t: torch.gather(t, 1, kept_idx)
    out_boxes = torch.gather(top_boxes, 1, kept_idx[..., None].expand(-1, -1, 4))
    out_scores = gather(top_scores)
    out_cls = gather(top_cls)

    if merge:
        merge_on = (n_cand > 1) & (n_cand < 3000)              # (B,)
        neigh = (iou[rows[:, None], kept_idx] > iou_thres) & cand_valid[:, None, :]
        w = neigh * top_scores[:, None, :]                     # (B, max_det, k)
        denom = w.sum(dim=-1, keepdim=True)
        merged = torch.matmul(w, top_boxes) / denom.clamp(min=1e-12)
        use = merge_on[:, None] & (denom[..., 0] > 0) & kept_ok
        out_boxes = torch.where(use[..., None], merged, out_boxes)
        redundant_ok = neigh.sum(dim=-1) > 1
        kept_ok = kept_ok & torch.where(merge_on[:, None], redundant_ok,
                                        torch.ones_like(redundant_ok))

    dets = torch.cat([out_boxes, out_scores[..., None], out_cls[..., None]],
                     dim=-1)
    dets = torch.where(kept_ok[..., None], dets,
                       torch.zeros((), dtype=dt, device=dev))
    return dets, kept_ok
