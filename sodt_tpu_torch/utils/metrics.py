"""Detection metrics for the eval protocol: COCO-style mAP, GT matching,
the confusion matrix, fitness and the per-class CSV.

A numpy-only copy of `sodt_tpu/utils/metrics.py` (conf-sorted PR
accumulation, 1000-point curve sampling, 101-point interpolated AP over
the 0.5:0.95 IoU vector, F1-max operating point, fitness = 0.9 mAP@0.5 +
0.1 mAP), kept inside the port so that `sodt_tpu_torch` imports nothing of
the JAX package.
"""

from __future__ import annotations

import numpy as np


def fitness(x: np.ndarray) -> np.ndarray:
    """Weighted fitness over [P, R, mAP@.5, mAP@.5:.95] rows (metrics.py:12-15)."""
    w = np.array([0.0, 0.0, 0.9, 0.1])
    return (x[:, :4] * w).sum(1)


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


class ConfusionMatrix:
    """IoU-matched confusion matrix (reference metrics.py:109-181)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections: np.ndarray, labels: np.ndarray):
        """detections: (N,6) xyxy+conf+cls; labels: (M,5) cls+xyxy."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        detection_classes = detections[:, 5].astype(int)
        iou = _box_iou_np(labels[:, 1:], detections[:, :4])

        x = np.where(iou > self.iou_thres)
        if x[0].shape[0]:
            matches = np.concatenate(
                (np.stack(x, 1), iou[x[0], x[1]][:, None]), 1)
            if x[0].shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))

        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(np.int16)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and sum(j) == 1:
                self.matrix[gc, detection_classes[m1[j]]] += 1
            else:
                self.matrix[self.nc, gc] += 1
        if n:
            for i, dc in enumerate(detection_classes):
                if not any(m1 == i):
                    self.matrix[dc, self.nc] += 1


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


def write_per_class_csv(metrics: dict, names, path) -> None:
    """The per-class table as CSV (`utils/xlsx.py` writes the same table
    as a workbook): an `all` row, then one row per evaluated class."""
    with open(path, "w") as fh:
        fh.write("class,name,P,R,mAP50,mAP\n")
        fh.write(f"all,all,{metrics.get('mp', 0):.5g},"
                 f"{metrics.get('mr', 0):.5g},"
                 f"{metrics.get('map50', 0):.5g},"
                 f"{metrics.get('map', 0):.5g}\n")
        for c, v in sorted(metrics.get("per_class", {}).items()):
            nm = names[c] if c < len(names) else str(c)
            fh.write(f"{c},{nm},{v['p']:.5g},{v['r']:.5g},"
                     f"{v['ap50']:.5g},{v['ap']:.5g}\n")
