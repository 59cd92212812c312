"""Evaluation: batched inference -> on-device NMS -> mAP
(`sodt_tpu/train/evaluate.py`).

Protocol as in the JAX package: conf 0.001, iou 0.6, multi-label,
merge-NMS with the 1 < n < 3000 gate and redundancy drop, IoU vector
0.5:0.95:10, top_k 4096. The forward, decode and NMS run on the device;
the greedy GT matching and AP accumulation run on host numpy. speed_ms is
inference + NMS wall time per image, synchronized with the device.

The protocol's extras are JAX's: test-time augmentation (`train/tta.py`),
NMS ensembles (a list of models whose decoded predictions are concatenated
before one NMS), hybrid labels (the ground truth as unit-confidence
candidates), the COCO-style json and YOLO txt exports in native pixels,
and an optional COCOeval pass where pycocotools is installed. The eval
step also gives the val loss (`make_eval_step(loss_cfg=)`); `evaluate`
does not fill it, as JAX's trainer and CLI never ask for it. `evaluate(
confusion=True)` (`val --plots`) adds the IoU-matched confusion matrix.
The scan eval and the `EvalRunner` of the JAX package answer TPU dispatch
latency and are not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from ..models.detect import decode_detections
from ..models.swin import SwinBlock, WindowAttention
from ..models.swinv2 import WindowAttentionV2
from ..ops.nms import batched_nms
from ..ops.boxes import scale_coords, xywhn2xyxy, xyxy2xywh
from ..utils.metrics import ConfusionMatrix, ap_per_class, match_predictions
from .loss import LossConfig, compute_loss
from .tta import tta_forward


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
                   top_k: int = 4096, merge: bool = True,
                   multi_label: bool = True,
                   loss_cfg: LossConfig | None = None,
                   augment: bool = False, hybrid_labels: bool = False):
    """(img, ir[, targets, tmask]) -> (dets (B, max_det, 6), valid
    (B, max_det), val losses or None) on the model's device. uint8 images
    are cast and scaled by 1/255 there.

    `model` may be a list of models: an NMS ensemble, whose members'
    decoded predictions are concatenated before one NMS. `augment` runs
    each member through `tta_forward`. `hybrid_labels` adds the ground
    truth (targets (B, M, 5) normalized xywh, tmask (B, M)) as candidates
    of confidence 1 at the batch's network size; masked slots get obj 0
    and fall to the conf gate. The val loss (`loss_cfg`) is taken for a
    single model without `augment` only: one member's raw maps would
    misstate an ensemble."""
    models = list(model) if isinstance(model, (list, tuple)) else [model]
    anchors = models[0].anchors_per_level
    strides = models[0].strides

    @torch.no_grad()
    def step(img: torch.Tensor, ir: torch.Tensor, targets=None, tmask=None):
        if img.dtype == torch.uint8:
            img = img.float() / 255.0
        if ir is not None and ir.dtype == torch.uint8:
            ir = ir.float() / 255.0
        preds, out = [], None
        for m in models:
            if augment:
                preds.append(tta_forward(m, img, ir))
            else:
                out = m(img, ir)
                preds.append(decode_detections(out["raw"], anchors, strides))
        pred = preds[0] if len(preds) == 1 else torch.cat(preds, 1)
        if hybrid_labels and targets is not None:
            nc = pred.shape[-1] - 5
            h, w = img.shape[1:3]
            net = torch.tensor([w, h, w, h], dtype=torch.float32,
                               device=pred.device)
            obj = tmask.to(pred.dtype)[..., None]
            # one-hot as jax.nn.one_hot: a class out of range is all zeros
            onehot = (targets[..., :1].long() == torch.arange(
                nc, device=pred.device)).to(pred.dtype)
            gt = torch.cat([(targets[..., 1:5] * net).to(pred.dtype), obj,
                            onehot * obj], -1)
            pred = torch.cat([pred, gt], 1)
        dets, valid = batched_nms(pred, conf_thres=conf_thres,
                                  iou_thres=iou_thres,
                                  multi_label=multi_label, max_det=max_det,
                                  top_k=top_k, merge=merge)
        losses = None
        if (loss_cfg is not None and targets is not None
                and len(models) == 1 and not augment):
            _, losses = compute_loss(out["raw"], targets, tmask, loss_cfg)
        return dets, valid, losses

    return step


def _image_id(batch: dict, si: int, seen: int):
    """The file stem, an int when numeric; else the dataset index."""
    stems = batch.get("stems")
    if stems is not None:
        stem = stems[si]
        return int(stem) if str(stem).isnumeric() else stem
    ids = batch.get("indices")
    return ids[si] if ids is not None else seen - 1


def _export(d: np.ndarray, batch: dict, si: int, net_hw, image_id,
            jdict: list | None, save_txt: str | None,
            save_conf: bool) -> None:
    """One image's detections in its native pixels: COCO records into
    `jdict`, a YOLO txt under `save_txt`. A rect batch carries the
    letterbox's own gain and pad (`ratio_pads`, scaleup off): they are
    used, never recomputed from `shapes`."""
    net_h, net_w = net_hw
    shapes = batch.get("shapes")
    h0, w0 = shapes[si] if shapes is not None else (net_h, net_w)
    dn = d.copy()
    rps = batch.get("ratio_pads")
    if rps is not None or (h0, w0) != (net_h, net_w):
        dn[:, :4] = scale_coords(
            (net_h, net_w), torch.from_numpy(d[:, :4]), (h0, w0),
            ratio_pad=None if rps is None else rps[si]).numpy()
    if jdict is not None:
        for x1, y1, x2, y2, conf, cls in dn:
            jdict.append({"image_id": image_id, "category_id": int(cls),
                          "bbox": [round(float(x1), 3), round(float(y1), 3),
                                   round(float(x2 - x1), 3),
                                   round(float(y2 - y1), 3)],
                          "score": round(float(conf), 5)})
    if save_txt is not None:
        os.makedirs(save_txt, exist_ok=True)
        write_yolo_txt(f"{save_txt}/{image_id}.txt", dn, (h0, w0),
                       ".5f" if save_conf else None)


def write_yolo_txt(path, d: np.ndarray, shape0,
                   conf_fmt: str | None) -> None:
    """One image's detections (n, 6) [x1,y1,x2,y2,conf,cls] in native
    pixels as YOLO label lines, `cls cx cy w h` normalized by the native
    (h0, w0), with the confidence in `conf_fmt` when it is given."""
    h0, w0 = shape0
    xywh = (xyxy2xywh(torch.from_numpy(d[:, :4]))
            / torch.tensor([w0, h0, w0, h0], dtype=torch.float32)).numpy()
    with open(path, "w") as fh:
        for (cx, cy, bw, bh), conf, cls in zip(xywh, d[:, 4], d[:, 5]):
            tail = f" {conf:{conf_fmt}}" if conf_fmt else ""
            fh.write(f"{int(cls)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
                     f"{tail}\n")


def _coco_eval(anno_json: str, save_json: str) -> dict:
    """COCOeval of the written predictions, where pycocotools is
    installed; a failure is reported and the run goes on."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        print("pycocotools not installed -- skipping COCOeval "
              "(predictions json written)")
        return {}
    try:
        anno = COCO(anno_json)
        ce = COCOeval(anno, anno.loadRes(save_json), "bbox")
        ce.evaluate()
        ce.accumulate()
        ce.summarize()
        return {"coco_map": float(ce.stats[0]),
                "coco_map50": float(ce.stats[1])}
    except Exception as e:  # anno / predictions mismatch: report, go on
        print(f"COCOeval failed: {e}")
        return {}


def evaluate(model, batches, *, nc: int, img_size: int,
             device: str | torch.device = "cuda", conf_thres: float = 0.001,
             iou_thres: float = 0.6, max_det: int = 300, top_k: int = 4096,
             merge: bool = True, names=None, verbose: bool = False,
             save_json: str | None = None, save_txt: str | None = None,
             save_conf: bool = False, save_hybrid: bool = False,
             augment: bool = False, confusion: bool = False,
             anno_json: str | None = None) -> dict[str, Any]:
    """Run the mAP protocol over `batches` (dicts from
    data.make_eval_batches; a rect batch's `net_shape` scales its ground
    truth). `model` may be a list (an NMS ensemble). Returns the metrics
    dict; `save_json` / `save_txt` name the export files, written in
    native pixels. speed_ms times the step and the fetch of its result;
    the ground truth goes to the device, before the clock starts, only
    for `save_hybrid`. `confusion` adds "confusion_matrix", the
    (nc + 1)^2 matrix of `utils.metrics.ConfusionMatrix`."""
    from .. import resolve_device
    dev = resolve_device(device)
    models = list(model) if isinstance(model, (list, tuple)) else [model]
    for m in models:
        cache_rel_bias(m)
    step = make_eval_step(model, conf_thres=conf_thres, iou_thres=iou_thres,
                          max_det=max_det, top_k=top_k, merge=merge,
                          augment=augment, hybrid_labels=save_hybrid)
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    cm = ConfusionMatrix(nc=nc) if confusion else None
    seen = 0
    t_infer = 0.0
    jdict = [] if save_json is not None else None
    for batch in batches:
        img = torch.from_numpy(batch["img"]).to(dev)
        ir = torch.from_numpy(batch["ir"]).to(dev)
        targets, tmask = batch["targets"], batch["tmask"]
        gt_dev = ((torch.from_numpy(targets).to(dev),
                   torch.from_numpy(tmask).to(dev)) if save_hybrid else ())
        _sync(dev)
        t0 = time.perf_counter()
        dets, valid, _ = step(img, ir, *gt_dev)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        t_infer += time.perf_counter() - t0

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
            if cm is not None:
                cm.process_batch(d, labels5)
            stats.append((correct, d[:, 4], d[:, 5], tcls))
            if save_json is not None or save_txt is not None:
                _export(d, batch, si, (net_h, net_w),
                        _image_id(batch, si, seen), jdict, save_txt,
                        save_conf)

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
    if cm is not None:
        out["confusion_matrix"] = cm.matrix
    if save_json is not None:
        with open(save_json, "w") as fh:
            json.dump(jdict, fh)
        if anno_json is not None:
            out.update(_coco_eval(anno_json, save_json))
    if verbose and names and out.get("per_class"):
        print(f"{'class':>12} {'P':>8} {'R':>8} {'mAP50':>8} {'mAP':>8}")
        print(f"{'all':>12} {out['mp']:8.4f} {out['mr']:8.4f} "
              f"{out['map50']:8.4f} {out['map']:8.4f}")
        for c, v in out["per_class"].items():
            nm = names[c] if c < len(names) else str(c)
            print(f"{nm:>12} {v['p']:8.4f} {v['r']:8.4f} "
                  f"{v['ap50']:8.4f} {v['ap']:8.4f}")
    return out
