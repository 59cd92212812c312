"""Detection metrics for the eval protocol: COCO-style mAP and GT matching.

A numpy-only copy of `sodt_tpu/utils/metrics.py` (conf-sorted PR
accumulation, 1000-point curve sampling, 101-point interpolated AP over
the 0.5:0.95 IoU vector, F1-max operating point), kept inside the port so
that `sodt_tpu_torch` imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def compute_ap(recall, precision):
    """101-point COCO-interp AP from one PR curve (metrics.py:81-106)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls):
    """Per-class AP from matched detections.

    tp: (n_det, n_iou) bool/0-1 matrix of TP flags at each IoU threshold.
    Returns (p, r, ap, f1, unique_classes) at the max-F1 operating point,
    matching reference metrics.py:18-78.
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]

    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = sel.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1 = 2 * p * r / (p + r + 1e-16)
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype("int32")


def _box_iou_np(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:4], box2[None, :, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=2)
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-16)


def match_predictions(det: np.ndarray, labels_xyxy: np.ndarray,
                      iouv: np.ndarray) -> np.ndarray:
    """Greedy IoU matching of detections to GT, one GT per detection.

    det: (N,6) xyxy+conf+cls; labels_xyxy: (M,5) cls+xyxy; iouv: (n_iou,)
    Returns correct: (N, n_iou) bool. Semantics follow reference
    test.py:219-237: per-class candidate pairs above iouv[0], sorted by IoU,
    deduplicated on both detection and GT indices.
    """
    correct = np.zeros((det.shape[0], iouv.shape[0]), dtype=bool)
    if labels_xyxy.shape[0] == 0 or det.shape[0] == 0:
        return correct
    tcls = labels_xyxy[:, 0]
    nl = labels_xyxy.shape[0]
    detected: set[int] = set()
    for c in np.unique(tcls):
        ti = np.where(tcls == c)[0]
        pi = np.where(det[:, 5] == c)[0]
        if pi.shape[0] == 0 or ti.shape[0] == 0:
            continue
        ious = _box_iou_np(det[pi, :4], labels_xyxy[ti, 1:5])
        best = ious.argmax(1)
        best_iou = ious[np.arange(len(pi)), best]
        # detections claim targets in row order (NMS output is conf-sorted),
        # one target each, stopping once every GT is matched
        for j in np.where(best_iou > iouv[0])[0]:
            d = int(ti[best[j]])
            if d not in detected:
                detected.add(d)
                correct[pi[j]] = best_iou[j] > iouv
                if len(detected) == nl:
                    break
    return correct
