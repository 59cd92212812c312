"""Trace the eval step (or a training step, or the augmentation) on the
card and print a breakdown by kernel (`tools/profile_eval.py` of the JAX
system):

    python -m sodt_tpu_torch.tools.profile_eval [--batch 64] [--iters 3]
    python -m sodt_tpu_torch.tools.profile_eval --train --batch 16
    python -m sodt_tpu_torch.tools.profile_eval --aug --batch 16
    python -m sodt_tpu_torch.tools.profile_eval --no-kernels   # A/B
    python -m sodt_tpu_torch.tools.profile_eval --int8

The flagship (configs/model.yaml, RGB+IR) in bf16 with weights from a
torch.Generator seeded with 0, at --img-size: the eval step (forward,
decode, NMS at conf 0.25, IoU 0.45, one label a box, top-k 512), or with
--train one training step (forward, loss, backward, SGD update, EMA) on
a batch with three boxes an image, or with --aug one step of the device
bank's augmentation (mosaic, HSV, flips) on SyntheticVedai tiles. After
one warm call, --iters calls are timed (steady state: ms an iteration,
images/s), then --iters more are traced by torch.profiler with the CUDA
activity alone; the Chrome trace goes to <--out>/trace.json and its
kernel events are summed into the 25 largest categories (a kernel's name
with its template arguments and numeric suffix collapsed) and the 40
largest kernels, with their shares of the device time.

--no-kernels runs inside `kernels.no_kernels()` (JAX's composition, no
kernel of the port launched: the A/B against the kernels), --int8 inside
`kernels.int8_serving()`. The last line is one JSON object with the
numbers printed. --device cpu profiles the host ops by their own time.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..kernels import int8_serving, no_kernels
from ..utils.profiler import (breakdown, cpu_rows, format_breakdown,
                              trace_kernels)

CFG = "configs/model.yaml"
PROFILE_TRIES = 5       # CUPTI now and then hands a session no kernel


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--train", action="store_true",
                   help="profile a training step, not the eval step")
    p.add_argument("--aug", action="store_true",
                   help="profile the device bank's augmentation (mosaic, "
                        "HSV, flips), not the model")
    p.add_argument("--no-kernels", action="store_true",
                   help="JAX's composition, no kernel of the port")
    p.add_argument("--int8", action="store_true",
                   help="int8 serving (K12's bodies)")
    p.add_argument("--out", default="runs/profile",
                   help="directory of the Chrome trace")
    p.add_argument("--device", "--platform", default="cuda")
    return p


def _model(dev, train: bool):
    from ..models import build_model
    from ..train.evaluate import cache_rel_bias
    from ..weights import init_weights
    model = init_weights(build_model(CFG, ch_in=4, dtype=torch.bfloat16,
                                     input_mode="RGB+IR"), seed=0).to(dev)
    return model.train() if train else cache_rel_bias(model.eval())


def _eval_step(a, dev):
    from ..train.evaluate import make_eval_step
    estep = make_eval_step(_model(dev, False), conf_thres=0.25,
                           iou_thres=0.45, multi_label=False, top_k=512,
                           approx_topk=True)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(size=(a.batch, a.img_size, a.img_size,
                                             3)).astype(np.float32)).to(dev)
    return lambda: estep(img, img)


def _train_step(a, dev):
    import yaml
    from ..models.compiler import resolve_config_path
    from ..train.optim import make_optimizer
    from ..train.state import TrainState, make_train_step
    from ..train.trainer import loss_config, scale_hyp

    model = _model(dev, True)
    with open(resolve_config_path("configs/hyp.scratch.yaml")) as f:
        hyp = scale_hyp(yaml.safe_load(f), len(model.spec.anchors), 8,
                        a.img_size)
    tx = make_optimizer(hyp, dict(model.named_parameters()), epochs=1, nb=1)
    state = TrainState.create(model, tx)
    tstep = make_train_step(model, tx, loss_config(model, hyp, 8))
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(size=(a.batch, a.img_size, a.img_size,
                                             3)).astype(np.float32)).to(dev)
    targets = torch.zeros((a.batch, 60, 5), device=dev)
    targets[:, :3] = torch.tensor([0, 0.5, 0.5, 0.1, 0.1], device=dev)
    tmask = torch.zeros((a.batch, 60), dtype=torch.bool, device=dev)
    tmask[:, :3] = True
    batch = {"img": img, "ir": img, "targets": targets, "tmask": tmask}
    return lambda: tstep(state, batch)


def _aug_step(a, dev):
    from ..data import SyntheticVedai
    from ..data.loader import make_bank_feed
    hyp = {"mosaic": 1.0, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
           "degrees": 0.0, "translate": 0.1, "scale": 0.5, "shear": 0.0,
           "perspective": 0.0, "flipud": 0.0, "fliplr": 0.5, "mixup": 0.0}
    ds = SyntheticVedai(n=max(4 * a.batch, 64), img_size=a.img_size)
    feed = make_bank_feed(ds, a.batch, a.img_size, hyp, seed=0,
                          device=dev, device_bank=True)
    return feed.augment_step


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_loop(step, dev, iters: int, batch: int, out: str) -> dict:
    """Steady-state ms an iteration of `step` and the breakdown of a
    traced run of `iters` calls (its Chrome trace written under `out`)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    print(f"steady-state: {dt * 1e3:.2f} ms/iter, {batch / dt:.1f} img/s")

    cuda = dev.type == "cuda"
    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    path = Path(out) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    for i in range(PROFILE_TRIES if cuda else 1):
        time.sleep(0.1 * i)
        with profile(activities=[act]) as prof:
            for _ in range(iters):
                step()
            _sync(dev)
        prof.export_chrome_trace(str(path))
        rows = (trace_kernels(json.loads(path.read_text())) if cuda
                else cpu_rows(prof))
        if rows:
            break
    b = breakdown(rows, iters)
    print()
    print(format_breakdown(b, "device" if cuda else "the host"))
    return {"ms_per_iter": dt * 1e3, "images_per_s": batch / dt,
            "trace": str(path), "sessions": i + 1, **b}


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    dev = resolve_device(a.device)
    with contextlib.ExitStack() as ctx:
        if a.no_kernels:
            ctx.enter_context(no_kernels())
        if a.int8:
            ctx.enter_context(int8_serving())
        make = _aug_step if a.aug else _train_step if a.train else _eval_step
        res = profile_loop(make(a, dev), dev, a.iters, a.batch, a.out)
    res.update(mode="aug" if a.aug else "train" if a.train else "eval",
               batch=a.batch, img_size=a.img_size, no_kernels=a.no_kernels,
               int8=a.int8,
               device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
