"""Weighted Boxes Fusion (`sodt_tpu/ops/wbf.py`): an alternative
post-processing in numpy on the host, a library function as in JAX (no
CLI calls it). Per class, boxes are clustered by IoU against the running
fused boxes in score order, each cluster's coordinates are the
confidence-weighted mean of its members, and its score the members' mean
(`conf_type` "avg") or max, rescaled by cluster support (single model).
"""

from __future__ import annotations

import numpy as np


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / (a1 + a2 - inter + 1e-12)


def weighted_boxes_fusion(boxes: np.ndarray, scores: np.ndarray,
                          labels: np.ndarray, iou_thr: float = 0.55,
                          skip_box_thr: float = 0.0,
                          conf_type: str = "avg"):
    """Fuse one model's detections (normalized xyxy in [0,1]).

    Returns (fused_boxes, fused_scores, fused_labels) sorted by score.
    """
    keep = scores > skip_box_thr
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    out_boxes, out_scores, out_labels = [], [], []

    for c in np.unique(labels):
        sel = labels == c
        b, s = boxes[sel], scores[sel]
        order = np.argsort(-s)
        b, s = b[order], s[order]

        fused: list[np.ndarray] = []      # running weighted boxes
        clusters: list[list[int]] = []    # member indices
        members_b: list[list[np.ndarray]] = []
        members_s: list[list[float]] = []

        for i in range(len(b)):
            matched = -1
            if fused:
                ious = _iou(b[i], np.asarray(fused))
                j = int(ious.argmax())
                if ious[j] > iou_thr:
                    matched = j
            if matched < 0:
                fused.append(b[i].copy())
                members_b.append([b[i]])
                members_s.append([float(s[i])])
            else:
                members_b[matched].append(b[i])
                members_s[matched].append(float(s[i]))
                ws = np.asarray(members_s[matched])
                bs = np.asarray(members_b[matched])
                fused[matched] = (bs * ws[:, None]).sum(0) / ws.sum()

        for fb, mb, ms in zip(fused, members_b, members_s):
            ms = np.asarray(ms)
            if conf_type == "max":
                sc = ms.max()
            else:
                sc = ms.mean()
            # rescale by cluster support (single model: weights sum to 1)
            sc = sc * min(len(ms), 1) / 1.0
            out_boxes.append(fb)
            out_scores.append(sc)
            out_labels.append(float(c))

    if not out_boxes:
        return (np.zeros((0, 4)), np.zeros(0), np.zeros(0))
    ob = np.asarray(out_boxes)
    osc = np.asarray(out_scores)
    ol = np.asarray(out_labels)
    order = np.argsort(-osc)
    return ob[order], osc[order], ol[order]


def weighted_boxes(dets: np.ndarray, image_size: int, iou_thr: float = 0.55,
                   conf_thr: float = 0.0):
    """(N, 6) pixel xyxy + conf + cls detections, fused, in the same
    layout."""
    if dets.shape[0] == 0:
        return dets
    nb = dets[:, :4] / image_size
    b, s, l = weighted_boxes_fusion(nb, dets[:, 4], dets[:, 5],
                                    iou_thr=iou_thr, skip_box_thr=conf_thr)
    return np.concatenate([b * image_size, s[:, None], l[:, None]], axis=1)
