"""Evaluation: batched inference -> on-device NMS -> mAP
(`sodt_tpu/train/evaluate.py`).

Protocol as in the JAX package: conf 0.001, iou 0.6, multi-label,
merge-NMS with the 1 < n < 3000 gate and redundancy drop, IoU vector
0.5:0.95:10, top_k 4096. The forward, decode and NMS run on the device;
the greedy GT matching and AP accumulation run on host numpy.

Two ways through the batches, as in JAX:

  * the whole pass (JAX's scan eval; `scan` True, or None where there is
    more than one batch, one image shape and the stacked images fit
    SCAN_BUDGET_BYTES): every batch's uint8 images (and labels) stacked on
    the device, the step issued for every batch with no host
    synchronisation in between, its results written into device tensors
    and fetched once at the end. speed_ms is the pass's wall time, fetch
    included, over the images seen. JAX folds the pass into one
    `lax.scan` dispatch; here it is a Python loop issuing the same steps;
  * the per-batch path (rect batches, a single batch, `scan=False`, or an
    auto estimate over the budget): the step and the fetch of its result
    per batch; speed_ms their summed wall time, synchronized with the
    device.

`EvalRunner` is JAX's: the step built once for a protocol, the whole-pass
runner built lazily once, and `_stacks`, the device-resident stacks kept
under `evaluate(stack_cache=)` so that a fixed val set is uploaded once a
run. The runner owns its eval module(s): each call loads the weights of
the model it is given into them in place and refreshes their cached
rel-pos biases and bf16 kernel weights in place (tensor addresses stay),
so one runner evaluates any number of weight sets of one architecture.

The protocol's extras are JAX's: test-time augmentation (`train/tta.py`),
NMS ensembles (a list of models whose decoded predictions are concatenated
before one NMS), hybrid labels (the ground truth as unit-confidence
candidates), the COCO-style json and YOLO txt exports in native pixels,
and an optional COCOeval pass where pycocotools is installed. `loss_cfg`
fills `val_loss`, the mean of the batches' losses, for a single model
without `augment`. `evaluate(confusion=True)` (`val --plots`) adds the
IoU-matched confusion matrix.
"""

from __future__ import annotations

import inspect
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
                   augment: bool = False, approx_topk: bool = False,
                   hybrid_labels: bool = False):
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
    misstate an ensemble. `approx_topk` is accepted and keeps the exact
    stable sort (JAX's `lax.approx_max_k` is a TPU serving knob; its
    results are the same whenever the candidates that clear conf_thres fit
    in top_k, and JAX's CPU path is exact). The step reads no device value
    on the host: a whole pass issues it batch after batch without
    waiting."""
    del approx_topk
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
            # xywh times (w, h, w, h), column by column: f32 products of
            # Python numbers, no copy from the host
            xywh = torch.stack([targets[..., 1 + i] * (w, h)[i % 2]
                                for i in range(4)], -1)
            obj = tmask.to(pred.dtype)[..., None]
            # one-hot as jax.nn.one_hot: a class out of range is all zeros
            onehot = (targets[..., :1].long() == torch.arange(
                nc, device=pred.device)).to(pred.dtype)
            gt = torch.cat([xywh.to(pred.dtype), obj, onehot * obj], -1)
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


SCAN_BUDGET_BYTES = 1e9   # auto whole pass: 2 x the stacked images' bytes


class EvalRunner:
    """Reusable eval machinery for callers that evaluate repeatedly (the
    trainer's per-epoch eval, JAX's `EvalRunner`): the step, built once
    for one protocol (`step_kw`, `make_eval_step`'s keywords, recorded
    fully resolved so that `evaluate` can refuse a call under another
    protocol), the whole-pass runner (`scan_fn`, built on first use) and
    `_stacks`, the device-resident stacks of `evaluate(stack_cache=)`.

    `model` (a module or a list of modules: an NMS ensemble) becomes the
    runner's own eval module(s), put in eval mode: every `evaluate` call
    loads the weights of the model it is given into them in place and
    refreshes their caches in place (`cache_bias`)."""

    def __init__(self, model, **step_kw):
        self.model = model
        self.models = (list(model) if isinstance(model, (list, tuple))
                       else [model])
        for m in self.models:
            m.eval()
        self.step = make_eval_step(model, **step_kw)
        bound = inspect.signature(make_eval_step).bind(model, **step_kw)
        bound.apply_defaults()
        self.step_kw = {k: v for k, v in bound.arguments.items()
                        if k != "model"}
        self._scan_fn = None
        self._stacks: dict[str, Any] = {}

    def scan_fn(self):
        """The whole-pass runner over this runner's step (one object for
        the runner's life)."""
        if self._scan_fn is None:
            self._scan_fn = _make_scan_runner(self.step)
        return self._scan_fn

    def load(self, model) -> None:
        """The weights of `model` (a module, a state_dict, or a list of
        either for an ensemble runner) into the runner's module(s), in
        place: their tensors keep their addresses."""
        srcs = list(model) if isinstance(model, (list, tuple)) else [model]
        if len(srcs) != len(self.models):
            raise ValueError(f"{len(srcs)} weight set(s) for a runner of "
                             f"{len(self.models)} model(s)")
        with torch.no_grad():
            for dst, src in zip(self.models, srcs):
                if src is not dst:
                    dst.load_state_dict(src.state_dict() if isinstance(
                        src, torch.nn.Module) else src)

    def cache_bias(self) -> None:
        """`cache_rel_bias` of the runner's module(s), in place."""
        for m in self.models:
            cache_rel_bias(m)


def _make_scan_runner(step):
    """The whole pass over a step (JAX's `lax.scan` runner): (imgs, irs,
    targets, tmask), each stacked (n, B, ...) on the device (targets and
    tmask may be None) -> (dets (n, B, max_det, 6), valid (n, B, max_det),
    losses {name: (n,)} or None) on the device. The step is issued for
    every batch and its results are copied into tensors allocated once
    for a given shape; nothing in the loop waits on the device."""
    bufs: dict = {}

    def slots(i, n, d, v, losses):
        key = (n, tuple(d.shape), None if losses is None else tuple(losses))
        if bufs.get("key") != key:
            bufs.clear()
            bufs.update(key=key, dets=d.new_empty((n,) + d.shape),
                        valid=v.new_empty((n,) + v.shape),
                        losses=(None if losses is None else
                                {k: x.new_empty((n,) + x.shape)
                                 for k, x in losses.items()}))
        return bufs["dets"], bufs["valid"], bufs["losses"]

    @torch.no_grad()
    def run_all(imgs, irs, targets=None, tmask=None):
        n = imgs.shape[0]
        for i in range(n):
            gt = () if targets is None else (targets[i], tmask[i])
            d, v, losses = step(imgs[i], irs[i], *gt)
            dets, valid, loss_out = slots(i, n, d, v, losses)
            dets[i].copy_(d)
            valid[i].copy_(v)
            for k, x in (losses or {}).items():
                loss_out[k][i].copy_(x)
        return bufs["dets"], bufs["valid"], bufs["losses"]

    return run_all


def _try_scan_eval(step, batches, scan, dev, runner=None, stack_cache=None):
    """Every batch's step in one whole pass, the results fetched once.

    Returns (the batch dicts carrying "_results", wall seconds of the pass
    and its fetch) when eligible, else (the batches, None). Eligible, as in
    JAX: more than one batch, one image shape (rect eval keeps the
    per-batch path) and, under `scan=None`, 2 x the stacked images' bytes
    within SCAN_BUDGET_BYTES.

    `stack_cache`: with a runner, the stacked device tensors and the
    batches' metadata (without img / ir) are kept under this key, and a
    later call under it does not touch `batches`: a fixed val set is
    uploaded once. Only for calls that evaluate the same batches."""
    cached = (runner._stacks.get(stack_cache)
              if runner is not None and stack_cache else None)
    if cached is not None:
        blist, imgs, irs, tg, tm = cached
    else:
        blist = list(batches)
        if len(blist) < 2:
            return iter(blist), None
        shapes = {tuple(b["img"].shape) for b in blist}
        if len(shapes) != 1:
            return iter(blist), None
        itemsize = np.dtype(blist[0]["img"].dtype).itemsize
        est = 2 * len(blist) * int(np.prod(next(iter(shapes)))) * itemsize
        if scan is None and est > SCAN_BUDGET_BYTES:
            return iter(blist), None
        up = lambda k: torch.from_numpy(np.stack([b[k] for b in blist])).to(
            dev)
        has_t = all(b.get("targets") is not None for b in blist)
        imgs, irs = up("img"), up("ir")
        tg, tm = (up("targets"), up("tmask")) if has_t else (None, None)
        if runner is not None and stack_cache:
            blist = [{k: v for k, v in b.items() if k not in ("img", "ir")}
                     for b in blist]
            runner._stacks[stack_cache] = (blist, imgs, irs, tg, tm)

    run_all = (runner.scan_fn() if runner is not None
               else _make_scan_runner(step))
    _sync(dev)
    t0 = time.perf_counter()
    dets, valid, losses = run_all(imgs, irs, tg, tm)
    dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
    if losses is not None:
        losses = {k: v.cpu().numpy() for k, v in losses.items()}
    t_scan = time.perf_counter() - t0
    out = []
    for i, b in enumerate(blist):
        b = dict(b)
        b["_results"] = (dets[i], valid[i], None if losses is None else
                         {k: v[i] for k, v in losses.items()})
        out.append(b)
    return iter(out), t_scan


def evaluate(model, batches, *, nc: int, img_size: int,
             device: str | torch.device = "cuda", conf_thres: float = 0.001,
             iou_thres: float = 0.6, max_det: int = 300, top_k: int = 4096,
             merge: bool = True, loss_cfg: LossConfig | None = None,
             names=None, verbose: bool = False,
             save_json: str | None = None, save_txt: str | None = None,
             save_conf: bool = False, save_hybrid: bool = False,
             augment: bool = False, confusion: bool = False,
             anno_json: str | None = None, cache_bias: bool = True,
             scan: bool | None = None, runner: EvalRunner | None = None,
             stack_cache: str | None = None) -> dict[str, Any]:
    """Run the mAP protocol over `batches` (dicts from
    data.make_eval_batches; a rect batch's `net_shape` scales its ground
    truth). `model` may be a list (an NMS ensemble). Returns the metrics
    dict; `save_json` / `save_txt` name the export files, written in
    native pixels. `confusion` adds "confusion_matrix", the (nc + 1)^2
    matrix of `utils.metrics.ConfusionMatrix`; `loss_cfg` adds "val_loss".

    `scan`: True forces the whole pass, False the per-batch path, None
    takes the whole pass where it is eligible (module doc). On the
    per-batch path speed_ms times the step and the fetch of its result;
    the ground truth goes to the device, before the clock starts, only
    for `save_hybrid` or `loss_cfg`.

    `runner`: an EvalRunner built under the same protocol (a call that
    asks for another raises ValueError naming each argument that
    differs). `model` is then a module or a state_dict (a list of them
    for an ensemble runner) whose weights the runner's own module(s)
    evaluate. `stack_cache` (with a runner): keep the whole pass's device
    stacks under this key (`_try_scan_eval`). `cache_bias=False` skips
    `cache_rel_bias`."""
    from .. import resolve_device
    dev = resolve_device(device)
    if runner is not None:
        want = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                    max_det=max_det, top_k=top_k, merge=merge,
                    loss_cfg=loss_cfg, augment=augment,
                    hybrid_labels=save_hybrid)
        diff = {k: (v, runner.step_kw[k]) for k, v in want.items()
                if k in runner.step_kw and runner.step_kw[k] != v}
        if diff:
            raise ValueError(
                "evaluate() protocol args disagree with the prebuilt "
                "runner's (requested, runner): "
                + ", ".join(f"{k}={v}" for k, v in sorted(diff.items()))
                + " — build the EvalRunner with matching kwargs")
        runner.load(model)
        if cache_bias:
            runner.cache_bias()
        step = runner.step
    else:
        if cache_bias:
            for m in (model if isinstance(model, (list, tuple))
                      else [model]):
                cache_rel_bias(m)
        step = make_eval_step(model, conf_thres=conf_thres,
                              iou_thres=iou_thres, max_det=max_det,
                              top_k=top_k, merge=merge, loss_cfg=loss_cfg,
                              augment=augment, hybrid_labels=save_hybrid)
    t_scan = None
    if scan is not False:
        batches, t_scan = _try_scan_eval(step, batches, scan, dev, runner,
                                         stack_cache)
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    cm = ConfusionMatrix(nc=nc) if confusion else None
    seen = 0
    t_infer = 0.0
    losses_acc = []
    jdict = [] if save_json is not None else None
    for batch in batches:
        targets, tmask = batch["targets"], batch["tmask"]
        pre = batch.get("_results")
        if pre is not None:            # the whole pass: results fetched
            dets, valid, losses = pre
        else:
            img = torch.from_numpy(batch["img"]).to(dev)
            ir = torch.from_numpy(batch["ir"]).to(dev)
            gt_dev = ((torch.from_numpy(targets).to(dev),
                       torch.from_numpy(tmask).to(dev))
                      if save_hybrid or loss_cfg is not None else ())
            _sync(dev)
            t0 = time.perf_counter()
            dets, valid, losses = step(img, ir, *gt_dev)
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            t_infer += time.perf_counter() - t0
        if losses is not None:
            losses_acc.append({k: float(v) for k, v in losses.items()})

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

    if t_scan is not None:
        t_infer = t_scan               # the one pass did the work
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
    if losses_acc:
        out["val_loss"] = {k: float(np.mean([l[k] for l in losses_acc]))
                           for k in losses_acc[0]}
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
