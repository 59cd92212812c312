"""Evaluation CLI of the port (`val.py` of the JAX package), on the card.

    python -m sodt_tpu_torch.val --task val --synthetic --synthetic-n 8 \\
        --img-size 512 --batch-size 4
    python -m sodt_tpu_torch.val --task speed --batch-size 8
    python -m sodt_tpu_torch.val --int8 --task val --synthetic ...
    python -m sodt_tpu_torch.val --data data.yaml --task test --rect \\
        --weights checkpoints/flagship_r5_150ep_ema.npz

Tasks: val, test and train (mAP protocol on the data yaml's fold list of
that name, a VEDAI folder of PNGs decoded by the port itself, or on
--synthetic data) and speed (ms per image at conf 0.25 / iou 0.45).
--rect batches by aspect ratio, each batch letterboxed to its own shape
(stride 32, pad 0.5). bf16 compute is on by default (--no-bf16 for f32). Weights come
from --weights (JAX's flag: a .npz state_dict, such as the trained
flagship's checkpoints/flagship_r5_150ep_ema.npz, or a checkpoint of the
port's trainer, whose EMA weights are taken) or --weights-npz (a state_dict
converted with sodt_tpu_torch.weights.from_jax_variables and saved with
save_npz), else from a torch.Generator seeded with 0. --device defaults to
cuda and raises when no card is visible; --device cpu runs the plain
PyTorch path.
--int8 runs every task inside `kernels.int8_serving()` (K12: the int8
bodies on JAX's gate) and says "int8": true in the metrics line. Prints one
metrics JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
import yaml

from . import resolve_device
from .kernels import int8_serving
from .data import SyntheticVedai, VedaiDataset, make_eval_batches
from .models import build_model
from .models.compiler import resolve_config_path
from .train.evaluate import evaluate, make_eval_step, cache_rel_bias
from .train.checkpoint import load_weights
from .weights import init_weights

CH_IN = {"RGB": 3, "IR": 3, "RGB+IR": 4, "RGB+IR+fusion": 8, "RGB+IR+MF": 3}


def build(a):
    """Model (on its device, rel-pos biases cached), dataset, nc, names."""
    dev = resolve_device(a.device)
    with open(resolve_config_path(a.data)) as f:
        data_cfg = yaml.safe_load(f)
    nc = int(data_cfg.get("nc", 8))
    names = data_cfg.get("names", [str(i) for i in range(nc)])
    dtype = torch.bfloat16 if a.bf16 else torch.float32
    model = build_model(a.cfg, ch_in=CH_IN[a.input_mode], nc=nc, dtype=dtype,
                        input_mode=a.input_mode)
    if a.weights or a.weights_npz:
        model.load_state_dict(load_weights(a.weights or a.weights_npz))
    else:
        init_weights(model, seed=0)
    model = model.to(dev).eval()
    cache_rel_bias(model)
    if a.synthetic:
        ds = SyntheticVedai(n=a.synthetic_n, img_size=a.img_size, nc=nc,
                            seed=1)
    else:
        ds = VedaiDataset(data_cfg.get(a.task if a.task in ("val", "test",
                                                            "train")
                                       else "val", data_cfg["val"]),
                          img_size=a.img_size)
    return model, ds, nc, names, dev


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default="configs/model.yaml")
    p.add_argument("--data", default="configs/data_vedai.yaml")
    p.add_argument("--weights", default="",
                   help="a .npz state_dict or a checkpoint of the port")
    p.add_argument("--weights-npz", default="")
    p.add_argument("--task", default="val",
                   choices=["val", "test", "train", "speed"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--conf-thres", type=float, default=0.001)
    p.add_argument("--iou-thres", type=float, default=0.6)
    p.add_argument("--input_mode", default="RGB+IR")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", type=int, default=16)
    p.add_argument("--rect", action="store_true",
                   help="rectangular eval batching (pad 0.5): one batch "
                        "shape per aspect-ratio group")
    p.add_argument("--no-bf16", action="store_false", dest="bf16")
    p.add_argument("--device", default="cuda")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="int8 serving: the quantized projection GEMMs of the "
                        "block kernels (K12), on JAX's gate; measures the mAP "
                        "and speed of the quantized path. Takes effect only "
                        "in bf16, as in JAX: with --no-bf16 nothing is "
                        "quantized")
    return p


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    if a.task == "speed":
        a.synthetic = True
    # the int8 gate wraps every task, as in the JAX CLI
    with int8_serving() if a.int8 else contextlib.nullcontext():
        return _run(a)


def _run(a) -> dict:
    model, ds, nc, names, dev = build(a)
    if a.task != "speed":
        t0 = time.perf_counter()
        m = evaluate(model, make_eval_batches(ds, a.batch_size, a.img_size,
                                              rect=a.rect), nc=nc,
                     img_size=a.img_size, device=dev, conf_thres=a.conf_thres,
                     iou_thres=a.iou_thres)
        wall = time.perf_counter() - t0
        m["images_per_s"] = m["seen"] / wall
        m["int8"] = a.int8
        m["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")
        if a.verbose:
            for c, v in m["per_class"].items():
                print(f"{names[c]:>12} {v['p']:8.4f} {v['r']:8.4f} "
                      f"{v['ap50']:8.4f} {v['ap']:8.4f}")
        print(json.dumps({k: v for k, v in m.items()
                          if isinstance(v, (int, float, str))}))
        return m
    step = make_eval_step(model, conf_thres=0.25, iou_thres=0.45)
    x = torch.zeros((a.batch_size, a.img_size, a.img_size, 3),
                    dtype=torch.uint8, device=dev)
    step(x, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        dets, valid = step(x, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / (n * a.batch_size) * 1000
    m = {"ms_per_image": dt, "img_size": a.img_size,
         "batch_size": a.batch_size, "int8": a.int8}
    print(json.dumps(m))
    return m


if __name__ == "__main__":
    main()
