"""Evaluation CLI of the port (`val.py` of the JAX package), on the card.

    python -m sodt_tpu_torch.val --task val --synthetic --synthetic-n 8 \\
        --img-size 512 --batch-size 4
    python -m sodt_tpu_torch.val --task speed --batch-size 8
    python -m sodt_tpu_torch.val --int8 --task val --synthetic ...
    python -m sodt_tpu_torch.val --data data.yaml --task test --rect \\
        --weights checkpoints/flagship_r5_150ep_ema.npz \\
        --save-json --save-txt --save-conf --save-dir runs/val/exp
    python -m sodt_tpu_torch.val --synthetic --augment --weights ...
    python -m sodt_tpu_torch.val --synthetic --weights a.npz,b.npz
    python -m sodt_tpu_torch.val --task study --study-sizes 384,640,1024

Tasks: val, test and train (mAP protocol on the data yaml's fold list of
that name, a VEDAI folder of PNGs decoded by the port itself, or on
--synthetic data), speed (ms per image at conf 0.25 / iou 0.45) and study
(the mAP protocol at each of --study-sizes, default 256..1536 step 128,
with a fresh model and dataset at each size; a size that fails is
reported and skipped). --rect batches by aspect ratio, each batch
letterboxed to its own shape (stride 32, pad 0.5). bf16 compute is on by
default (--no-bf16 for f32). The mAP tasks take the whole-pass eval where
it is eligible, as JAX's val.py does (`evaluate(scan=None)`: more than one
batch of one shape within the stacked-image budget; every batch's step
issued with no host wait, the results fetched once); --rect batches of
several shapes and a single batch run batch by batch. speed_ms is the
inference + NMS time an image either way.

Weights come from --weights (JAX's flag: a .npz state_dict, such as the
trained flagship's checkpoints/flagship_r5_150ep_ema.npz, or a checkpoint
of the port's trainer, whose EMA weights are taken; a comma list is an NMS
ensemble, the members' predictions concatenated before one NMS) or
--weights-npz (a state_dict converted with
sodt_tpu_torch.weights.from_jax_variables and saved with save_npz), else
from a torch.Generator seeded with 0.

The eval extras are JAX's: --augment (test-time augmentation),
--save-hybrid (the labels as candidates of confidence 1), --single-cls,
--save-json (COCO-style predictions.json in native pixels; with
--anno-json a COCOeval pass where pycocotools is installed), --save-txt /
--save-conf (YOLO labels/<image id>.txt). per_class.csv and per_class.xlsx
are always written to --save-dir. --plots writes confusion_matrix.png
(the mAP tasks) or study.png (--task study) to --save-dir where
matplotlib is installed; where it is not, it prints one line saying that
no plot was written and why.

--device (alias --platform) defaults to cuda and raises when no card is
visible; --device cpu runs the plain PyTorch path. --int8 runs every task
inside `kernels.int8_serving()` (K12: the int8 bodies on JAX's gate) and
says "int8": true in the metrics line. Prints one metrics JSON line (study:
one line per size, then the rows as one JSON list).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import torch
import yaml

from . import resolve_device
from .kernels import int8_serving
from .data import (SyntheticVedai, VedaiDataset, apply_single_cls,
                   make_eval_batches)
from .models import build_model
from .models.compiler import resolve_config_path
from .train.evaluate import evaluate, make_eval_step, cache_rel_bias
from .train.checkpoint import load_into
from .utils.metrics import write_per_class_csv
from .utils.plots import missing_reason, plot_confusion_matrix, plot_study
from .utils.xlsx import write_per_class_xlsx
from .weights import init_weights

CH_IN = {"RGB": 3, "IR": 3, "RGB+IR": 4, "RGB+IR+fusion": 8, "RGB+IR+MF": 3}
STUDY_SIZES = range(256, 1537, 128)


def build(a, img_size: int):
    """The models (one per --weights entry, on their device, rel-pos
    biases cached), the dataset at `img_size`, nc, names, the device."""
    dev = resolve_device(a.device)
    with open(resolve_config_path(a.data)) as f:
        data_cfg = yaml.safe_load(f)
    nc = int(data_cfg.get("nc", 8))
    names = data_cfg.get("names", [str(i) for i in range(nc)])
    dtype = torch.bfloat16 if a.bf16 else torch.float32
    sources = (a.weights.split(",") if a.weights
               else [a.weights_npz or None])
    models = []
    for src in sources:
        model = build_model(a.cfg, ch_in=CH_IN[a.input_mode], nc=nc,
                            dtype=dtype, input_mode=a.input_mode)
        if src:
            load_into(model, src)
        else:
            init_weights(model, seed=0)
        models.append(cache_rel_bias(model.to(dev).eval()))
    if a.synthetic:
        ds = SyntheticVedai(n=a.synthetic_n, img_size=img_size, nc=nc,
                            seed=1)
    else:
        ds = VedaiDataset(data_cfg.get(a.task if a.task in ("val", "test",
                                                            "train")
                                       else "val", data_cfg["val"]),
                          img_size=img_size)
    if a.single_cls:
        apply_single_cls(ds)
        nc, names = 1, ["item"]
    return models, ds, nc, names, dev


def run_map(a, img_size: int) -> dict:
    """The mAP protocol at `img_size`; per_class.csv / .xlsx and the
    exports asked for go to --save-dir."""
    models, ds, nc, names, dev = build(a, img_size)
    save_dir = Path(a.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    m = evaluate(models,
                 make_eval_batches(ds, a.batch_size, img_size, rect=a.rect),
                 nc=nc, img_size=img_size, device=dev,
                 conf_thres=a.conf_thres, iou_thres=a.iou_thres, names=names,
                 verbose=a.verbose, augment=a.augment,
                 anno_json=a.anno_json or None,
                 save_json=(str(save_dir / "predictions.json")
                            if a.save_json else None),
                 save_txt=str(save_dir / "labels") if a.save_txt else None,
                 save_conf=a.save_conf, save_hybrid=a.save_hybrid,
                 confusion=a.plots)
    if a.plots and "confusion_matrix" in m:
        plot_confusion_matrix(m["confusion_matrix"],
                              save_dir / "confusion_matrix.png", names)
    m["images_per_s"] = m["seen"] / (time.perf_counter() - t0)
    m["int8"] = a.int8
    m["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    write_per_class_csv(m, names, save_dir / "per_class.csv")
    write_per_class_xlsx(m, names, save_dir / "per_class.xlsx")
    return m


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default="configs/model.yaml")
    p.add_argument("--data", default="configs/data_vedai.yaml")
    p.add_argument("--weights", default="",
                   help="a .npz state_dict or a checkpoint of the port; a "
                        "comma list is an NMS ensemble")
    p.add_argument("--weights-npz", default="")
    p.add_argument("--task", default="val",
                   choices=["val", "test", "train", "speed", "study"])
    p.add_argument("--study-sizes", default="",
                   help="comma list of sizes for --task study (default "
                        "256..1536 step 128)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--input_mode", default="RGB+IR")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", type=int, default=16)
    p.add_argument("--no-bf16", action="store_false", dest="bf16")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--plots", action="store_true",
                   help="confusion_matrix.png / study.png in --save-dir "
                        "(needs matplotlib)")
    p.add_argument("--save-dir", default="runs/val/exp")
    p.add_argument("--save-json", action="store_true")
    p.add_argument("--save-txt", action="store_true")
    p.add_argument("--save-conf", action="store_true",
                   help="include confidences in --save-txt labels")
    p.add_argument("--save-hybrid", action="store_true",
                   help="seed NMS with the labels (autolabelling)")
    p.add_argument("--single-cls", action="store_true",
                   help="treat as single-class dataset")
    p.add_argument("--rect", action="store_true",
                   help="rectangular eval batching (pad 0.5): one batch "
                        "shape per aspect-ratio group")
    p.add_argument("--augment", action="store_true",
                   help="test-time augmentation")
    p.add_argument("--anno-json", default="",
                   help="COCO annotations json for an optional COCOeval "
                        "pass on --save-json")
    p.add_argument("--device", "--platform", default="cuda")
    p.add_argument("--int8", action="store_true",
                   help="int8 serving: the quantized projection GEMMs of the "
                        "block kernels (K12), on JAX's gate; measures the mAP "
                        "and speed of the quantized path. Takes effect only "
                        "in bf16, as in JAX: with --no-bf16 nothing is "
                        "quantized")
    return p


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    if a.plots and missing_reason():
        print(f"--plots: no plot written: {missing_reason()}")
    if a.task == "speed":
        a.synthetic = True
    # the int8 gate wraps every task, as in the JAX CLI
    with int8_serving() if a.int8 else contextlib.nullcontext():
        return _run(a)


def _run(a) -> dict:
    if a.task == "study":
        rows = []
        sizes = ([int(s) for s in a.study_sizes.split(",")]
                 if a.study_sizes else STUDY_SIZES)
        for s in sizes:
            try:
                m = run_map(a, s)
                rows.append({"img_size": s, "map50": m["map50"],
                             "map": m["map"], "speed_ms": m["speed_ms"]})
                print(rows[-1])
            except Exception as e:  # keep sweeping, as JAX does
                print({"img_size": s, "error": str(e)})
        print(json.dumps(rows))
        if a.plots and rows:
            Path(a.save_dir).mkdir(parents=True, exist_ok=True)
            plot_study(rows, Path(a.save_dir) / "study.png")
        return {"study": rows}
    if a.task != "speed":
        m = run_map(a, a.img_size)
        print(json.dumps({k: v for k, v in m.items()
                          if isinstance(v, (int, float, str))}))
        return m
    models, _, _, _, dev = build(a, a.img_size)
    step = make_eval_step(models, conf_thres=0.25, iou_thres=0.45)
    x = torch.zeros((a.batch_size, a.img_size, a.img_size, 3),
                    dtype=torch.uint8, device=dev)
    step(x, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        step(x, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / (n * a.batch_size) * 1000
    m = {"ms_per_image": dt, "img_size": a.img_size,
         "batch_size": a.batch_size, "int8": a.int8}
    print(json.dumps(m))
    return m


if __name__ == "__main__":
    main()
