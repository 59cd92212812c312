"""Evaluation: batched inference -> on-device NMS -> mAP
(`sodt_tpu/train/evaluate.py`).

Protocol as in the JAX package: conf 0.001, iou 0.6, multi-label,
merge-NMS with the 1 < n < 3000 gate and redundancy drop, IoU vector
0.5:0.95:10, top_k 4096. The forward, decode and NMS run on the device;
the greedy GT matching and AP accumulation run on host numpy. speed_ms is
inference + NMS wall time per image, synchronized with the device.
Save-json/txt, the confusion matrix, TTA, ensembles and hybrid labels are
not ported yet.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from ..models.detect import decode_detections
from ..models.swin import SwinBlock, WindowAttention
from ..models.swinv2 import WindowAttentionV2
from ..ops.nms import batched_nms
from ..ops.boxes import xywhn2xyxy
from ..utils.metrics import ap_per_class, match_predictions


def cache_rel_bias(model: torch.nn.Module) -> torch.nn.Module:
    """Materialize every WindowAttention's (nh, N, N) rel-pos bias (V2: the
    cpb-MLP bias of its nominal window, in the model's dtype) and, for a
    bf16 model, every SwinBlock's kernel weights once (refresh after any
    weight load or device move)."""
    dt = getattr(model, "dtype", torch.float32)
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.cache_bias()
        elif isinstance(m, WindowAttentionV2):
            m.cache_bias(m.window_size, dt)
        elif isinstance(m, SwinBlock) and dt == torch.bfloat16:
            m.cache_kernel_weights(dt)
    return model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_eval_step(model, *, conf_thres: float = 0.001,
                   iou_thres: float = 0.6, max_det: int = 300,
                   top_k: int = 4096, merge: bool = True):
    """(img, ir) -> (dets (B, max_det, 6), valid (B, max_det)) on the
    model's device. uint8 images are cast and scaled by 1/255 there."""
    anchors = model.anchors_per_level
    strides = model.strides

    @torch.no_grad()
    def step(img: torch.Tensor, ir: torch.Tensor):
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        if ir is not None and ir.dtype == torch.uint8:
            ir = ir.float() / 255.0
        out = model(img, ir)
        pred = decode_detections(out["raw"], anchors, strides)
        return batched_nms(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                           multi_label=True, max_det=max_det,
                           top_k=top_k, merge=merge)

    return step


def evaluate(model, batches, *, nc: int, img_size: int,
             device: str | torch.device = "cuda", conf_thres: float = 0.001,
             iou_thres: float = 0.6, max_det: int = 300, top_k: int = 4096,
             merge: bool = True) -> dict[str, Any]:
    """Run the mAP protocol over `batches` (dicts from
    data.make_eval_batches; a rect batch's `net_shape` scales its ground
    truth). Returns the metrics dict."""
    from .. import resolve_device
    dev = resolve_device(device)
    cache_rel_bias(model)
    step = make_eval_step(model, conf_thres=conf_thres, iou_thres=iou_thres,
                          max_det=max_det, top_k=top_k, merge=merge)
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    seen = 0
    t_infer = 0.0
    for batch in batches:
        img = torch.from_numpy(batch["img"]).to(dev)
        ir = torch.from_numpy(batch["ir"]).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        dets, valid = step(img, ir)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        t_infer += time.perf_counter() - t0

        targets, tmask = batch["targets"], batch["tmask"]
        # rect batches carry their own network shape
        net_h, net_w = batch.get("net_shape", (img_size, img_size))
        for si in range(batch.get("valid", dets.shape[0])):
            seen += 1
            d = dets[si][valid[si]]
            labs = targets[si][tmask[si]]
            tcls = labs[:, 0].tolist()
            if d.shape[0] == 0:
                if len(tcls):
                    stats.append((np.zeros((0, 10), bool), np.zeros(0),
                                  np.zeros(0), tcls))
                continue
            gt = xywhn2xyxy(torch.from_numpy(labs[:, 1:5]), net_w,
                            net_h).numpy()
            labels5 = np.concatenate([labs[:, 0:1], gt], axis=1)
            correct = match_predictions(d, labels5, iouv)
            stats.append((correct, d[:, 4], d[:, 5], tcls))

    out: dict[str, Any] = {"seen": seen,
                           "speed_ms": 1000 * t_infer / max(seen, 1)}
    if stats:
        tp = np.concatenate([np.asarray(s[0]) for s in stats])
        conf = np.concatenate([s[1] for s in stats])
        pcls = np.concatenate([s[2] for s in stats])
        tcls = np.concatenate([np.asarray(s[3]) for s in stats])
        if tp.size and tp.any():
            p, r, ap, f1, cls_idx = ap_per_class(tp, conf, pcls, tcls)
            ap50, ap_mean = ap[:, 0], ap.mean(1)
            out.update(mp=float(p.mean()), mr=float(r.mean()),
                       map50=float(ap50.mean()), map=float(ap_mean.mean()),
                       per_class={int(c): dict(p=float(p[i]), r=float(r[i]),
                                               ap50=float(ap50[i]),
                                               ap=float(ap_mean[i]))
                                  for i, c in enumerate(cls_idx)})
        else:
            out.update(mp=0.0, mr=0.0, map50=0.0, map=0.0, per_class={})
        out["nt"] = np.bincount(tcls.astype(np.int64), minlength=nc).tolist()
    else:
        out.update(mp=0.0, mr=0.0, map50=0.0, map=0.0, per_class={}, nt=[0])
    return out
