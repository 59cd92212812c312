"""Benchmark: VEDAI end-to-end images/s on one card at 512 px, the JAX
system's root `bench.py` as `python -m sodt_tpu_torch.bench`.

The flagship (`configs/model.yaml`, RGB+IR, 4 input channels, bf16,
weights drawn by `init_weights` from seed 0) runs the serving path: uint8
images -> /255 -> forward -> Detect decode -> NMS on the card (conf 0.25,
IoU 0.45, best class only, `top_k` candidates). `run(argv)` returns one
record and `main()` prints it as ONE JSON line; anything else the run
prints goes to stderr. The fields, each measured as JAX measures it:

  * `inference_ips` (= `value`): one whole pass of `EvalRunner`'s runner
    (`train/evaluate.py` `_make_scan_runner`, every batch's step issued
    with no host wait) over a device-resident stack of `iters` batches,
    drawn from four rotating uint8 inputs by index i % 4; the window ends
    in one host read of a checksum, the sum of the pass's dets; best of 3;
  * `e2e_host_ips`: one step per numpy batch, uploaded inside the window,
    the checksum read at its end; best of 2. `e2e_feed_mbps`: the host ->
    device bytes (uint8 RGB + IR) that rate moves;
  * `gflops_per_img`, `inference_mfu`: the eval step's FLOPs at the bench's
    batch, counted by `utils.profiler.flops_estimate` on the card inside
    `kernels.no_kernels()` (the counter cannot see inside the hand-written
    kernels, so it counts their composition, as JAX counts its own), over
    the H100's dense bf16 peak. FlopCounterMode counts matmuls,
    convolutions and attention only; XLA's cost analysis also counts
    element-wise work, decode and NMS, so JAX's count of the same model is
    larger by construction and the two are not scaled to each other;
  * `int8_ips` (`--int8`): the same pass inside `kernels.int8_serving()`;
  * `topk_path`: always "exact": the port's eval step keeps the exact sort
    (`make_eval_step` ignores `approx_topk`), where JAX prints the field
    only after its approximate top-k failed to compile;
  * `train_ips`, `train_mfu`: `max(iters // 2, 2)` training steps (forward,
    loss, backward, optimizer, EMA) of a model built with `remat` (not
    under `--quick`) on device-resident uint8 images fed as both `img` and
    `ir`, the losses summed on the card and read once; best of 2. The
    step's FLOPs are counted inside `no_kernels()` on a copy of the
    training state (a counted step applies its update), the backward and
    the remat recompute included, as XLA counts JAX's rematerialized step:
    `train_mfu` is thus the hardware's FLOP utilisation, above the model's
    by the recompute's share. The count is taken on the batch's first 1
    and 2 images and carried to the whole batch along the line through
    them: the counter's count is affine in the batch (per-image work and
    a part that does not depend on it), and a count at the whole batch
    took 6x the timed step's memory on the card;
  * `train_feed_ips`: the trainer's per-step feed (`make_train_batches`
    over `SyntheticVedai`, mosaic and the rest of the augmentation on the
    card), one step a batch; `train_scan_feed_ips`: its epoch path
    (`make_bank_feed(device_bank=True)` + `make_epoch_scan`);
  * `device` (the card's name, or "cpu"), `power_limit_w` (nvidia-smi;
    None on the CPU), `vs_baseline` (None: JAX's denominator was an
    estimate for another card, never a measurement here) and, on the card,
    `peak_memory_bytes`: `torch.cuda.max_memory_allocated()` of each path.

The MFU fields and `gflops_per_img` are absent on the CPU, as in JAX. There
is no fallback: without a card and without `--device cpu` the bench raises
(`resolve_device`), and on the card a FLOP count that fails fails the run.
JAX's watchdog around its TPU backend's start-up has no counterpart.

  python -m sodt_tpu_torch.bench                 # 512 px, batch 128 / 32
  python -m sodt_tpu_torch.bench --int8          # and int8_ips
  python -m sodt_tpu_torch.bench --quick --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from . import kernels, resolve_device
from .data import SyntheticVedai
from .data.loader import make_bank_feed, make_train_batches
from .models import build_model
from .train.evaluate import EvalRunner
from .train.loss import LossConfig
from .train.optim import make_optimizer
from .train.state import TrainState, make_epoch_scan, make_train_step
from .utils.profiler import flops_estimate
from .weights import init_weights

METRIC = "VEDAI end-to-end images/sec/chip at 512px"
H100_BF16_PEAK_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores
N_INPUTS = 4                    # rotating inputs: no cache can hide work
EVAL_KW = dict(conf_thres=0.25, iou_thres=0.45, multi_label=False)
HYP = {"lr0": 0.01, "lrf": 0.2, "momentum": 0.937, "warmup_iters": 1,
       "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "box": 0.05,
       "cls": 0.5, "cls_pw": 1.0, "obj": 1.0, "obj_pw": 1.0,
       "anchor_t": 4.0, "fl_gamma": 0.0}
HYP_AUG = dict(HYP, mosaic=1.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4,
               translate=0.1, scale=0.5, fliplr=0.5)
N_TARGETS = 30


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m sodt_tpu_torch.bench")
    p.add_argument("--quick", action="store_true",
                   help="small shapes for CPU verification")
    p.add_argument("--batch-size", type=int, default=0, help="0 = auto")
    p.add_argument("--train-batch-size", type=int, default=0)
    p.add_argument("--img-size", type=int, default=0)
    p.add_argument("--cfg", default="configs/model.yaml")
    p.add_argument("--iters", type=int, default=0)
    p.add_argument("--top-k", type=int, default=0, help="NMS candidate cap")
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="also time the int8 serving path (K12's bodies); "
                        "reported as int8_ips")
    p.add_argument("--device", "--platform", default="cuda")
    return p


def timed_window(run_iter, iters: int, repeats: int) -> float:
    """Best of `repeats` windows of `iters` calls, seconds: each call
    returns a device scalar that joins a checksum read on the host at the
    window's end, so no launch can be left unfinished inside it."""
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        acc = 0.0
        for i in range(iters):
            acc = acc + run_iter(i)
        if not math.isfinite(float(acc)):
            raise FloatingPointError("the checksum of a timed window is "
                                     "not finite")
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def peak_memory(dev: torch.device, peaks: dict, path: str):
    """`torch.cuda.max_memory_allocated()` of the block into peaks[path]
    (on the card only)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    yield
    if dev.type == "cuda":
        peaks[path] = torch.cuda.max_memory_allocated(dev)


def eval_runner(model, top_k: int) -> EvalRunner:
    """The serving step's runner (the bench's settings), its rel-pos biases
    and bf16 / int8 kernel weights cached."""
    runner = EvalRunner(model, top_k=top_k, **EVAL_KW)
    runner.cache_bias()
    return runner


def pass_checksum(runner: EvalRunner, imgs, irs) -> torch.Tensor:
    """One whole pass over stacked (n, B, H, W, 3) uint8 batches: the sum
    of its dets, a device scalar."""
    dets, _, _ = runner.scan_fn()(imgs, irs)
    return dets.sum()


def eval_flops(runner: EvalRunner, img, ir) -> float | None:
    """FLOPs of one eval step on (img, ir), counted on the composition."""
    with kernels.no_kernels():
        return flops_estimate(runner.step, img, ir)


def train_batch(img_u8, targets, tmask) -> dict:
    """uint8 images scaled on the card and fed as both modalities."""
    img = img_u8.float() / 255.0
    return {"img": img, "ir": img, "targets": targets, "tmask": tmask}


def train_flops(state: TrainState, loss_cfg: LossConfig,
                batch: dict) -> float | None:
    """FLOPs of one training step on `batch` (forward, loss, backward; the
    update's element-wise work is not counted), counted on the composition
    at its first 1 and 2 images and carried to its size along the line
    through them (module doc). Each count runs on a copy of `state`, which
    a counted step updates: `state` is left as it was."""
    def count(m: int) -> float | None:
        twin = copy.deepcopy(state)
        step = make_train_step(twin.model, twin.tx, loss_cfg)
        with kernels.no_kernels():
            # the counter runs fn under no_grad; the step differentiates
            return flops_estimate(torch.enable_grad()(step), twin,
                                  {k: v[:m] for k, v in batch.items()})
    n = len(batch["img"])
    c1, c2 = count(1), count(2)
    return c2 + (n - 2) * (c2 - c1) if c1 and c2 else None


def power_limit_w(dev: torch.device) -> float | None:
    """The card's power limit in W (nvidia-smi), None on the CPU."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _counted(fl: float | None, what: str) -> float:
    if not fl:
        raise RuntimeError(f"the FLOP count of {what} failed on the card "
                           "(flops_estimate's warning names the cause)")
    return fl


def _eval_fields(a, dev, img_size: int, rng, peaks: dict) -> dict:
    batch = a.batch_size or (2 if a.quick else 128)
    iters = a.iters or (3 if a.quick else 8)
    top_k = a.top_k or (1024 if a.quick else 512)
    model = build_model(a.cfg, ch_in=4, dtype=torch.bfloat16,
                        input_mode="RGB+IR")
    runner = eval_runner(init_weights(model, seed=0).to(dev), top_k)
    shape = (batch, img_size, img_size, 3)
    imgs = [rng.integers(0, 256, shape, np.uint8) for _ in range(N_INPUTS)]
    irs = [rng.integers(0, 256, shape, np.uint8) for _ in range(N_INPUTS)]
    idx = torch.arange(iters) % N_INPUTS
    imgs_d = torch.stack([torch.from_numpy(x) for x in imgs])[idx].to(dev)
    irs_d = torch.stack([torch.from_numpy(x) for x in irs])[idx].to(dev)

    def one_pass(_i):
        return pass_checksum(runner, imgs_d, irs_d)

    out = {}
    with peak_memory(dev, peaks, "inference"):
        one_pass(0).item()                              # warm
        ips = batch * iters / timed_window(one_pass, 1, 3)

    def host_iter(i):
        img = torch.from_numpy(imgs[i % N_INPUTS]).to(dev)
        ir = torch.from_numpy(irs[i % N_INPUTS]).to(dev)
        return runner.step(img, ir)[0].sum()

    with peak_memory(dev, peaks, "e2e_host"):
        host_ips = batch * iters / timed_window(host_iter, iters, 2)
    out.update(metric=METRIC, value=ips, unit="images/sec/chip",
               vs_baseline=None, inference_ips=ips, e2e_host_ips=host_ips,
               e2e_feed_mbps=host_ips * 2 * 3 * img_size * img_size / 1e6,
               topk_path="exact")
    if dev.type == "cuda":
        with peak_memory(dev, peaks, "inference_flops"):
            fl = _counted(eval_flops(runner, imgs_d[0], irs_d[0]),
                          "the eval step")
        out["gflops_per_img"] = fl / batch / 1e9
        out["inference_mfu"] = fl / batch * ips / H100_BF16_PEAK_FLOPS
    if a.int8:
        with kernels.int8_serving(), peak_memory(dev, peaks, "int8"):
            one_pass(0).item()
            out["int8_ips"] = batch * iters / timed_window(one_pass, 1, 3)
    return out


def _train_fields(a, dev, img_size: int, rng, peaks: dict) -> dict:
    iters = a.iters or (3 if a.quick else 8)
    tbatch = a.train_batch_size or (2 if a.quick else 32)
    model = build_model(a.cfg, ch_in=4, dtype=torch.bfloat16,
                        input_mode="RGB+IR", remat=not a.quick)
    model = init_weights(model, seed=0).to(dev)
    loss_cfg = LossConfig(nc=model.spec.nc, anchors=model.spec.anchors,
                          strides=model.spec.detect_strides)
    tx = make_optimizer(HYP, dict(model.named_parameters()), epochs=10,
                        nb=100)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, loss_cfg)
    targets = np.zeros((tbatch, N_TARGETS, 5), np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.2, 0.2]
    tmask = np.zeros((tbatch, N_TARGETS), bool)
    tmask[:, 0] = True
    tj, tm = torch.from_numpy(targets).to(dev), torch.from_numpy(tmask).to(dev)
    shape = (tbatch, img_size, img_size, 3)
    timgs = torch.stack([torch.from_numpy(rng.integers(0, 256, shape,
                                                       np.uint8))
                         for _ in range(N_INPUTS)]).to(dev)
    titers = max(iters // 2, 2)

    def window(_i):
        acc = torch.zeros((), device=dev)
        for i in range(titers):
            _, m = step(state, train_batch(timgs[i % N_INPUTS], tj, tm))
            acc = acc + m["loss"]
        return acc

    out = {}
    with peak_memory(dev, peaks, "train"):
        window(0).item()                                # warm
        tips = tbatch * titers / timed_window(window, 1, 2)
    out["train_ips"] = tips
    if dev.type == "cuda":
        with peak_memory(dev, peaks, "train_flops"):
            tfl = _counted(train_flops(state, loss_cfg,
                                       train_batch(timgs[0], tj, tm)),
                           "the training step")
        out["train_mfu"] = tfl / tbatch * tips / H100_BF16_PEAK_FLOPS
    del timgs

    # the trainer's per-step feed: the bank, augmented on the card, one
    # step a batch
    wsteps = max(titers, 4)
    with peak_memory(dev, peaks, "train_feed"):
        ds = SyntheticVedai(n=max(2 * tbatch, 64), img_size=img_size,
                            nc=loss_cfg.nc)
        feed = make_train_batches(ds, tbatch, img_size, HYP_AUG, seed=0,
                                  device=dev)
        float(step(state, next(feed))[1]["loss"])       # warm
        t0 = time.perf_counter()
        for _ in range(wsteps):
            _, m = step(state, next(feed))
        if not math.isfinite(float(m["loss"])):
            raise FloatingPointError("train_feed: the loss is not finite")
        out["train_feed_ips"] = tbatch * wsteps / (time.perf_counter() - t0)
    del feed

    # its epoch path: gather -> augment -> step for a whole epoch, the
    # losses fetched once an epoch (an epoch of wsteps steps)
    with peak_memory(dev, peaks, "train_scan_feed"):
        bfeed = make_bank_feed(SyntheticVedai(n=tbatch * wsteps,
                                              img_size=img_size,
                                              nc=loss_cfg.nc),
                               tbatch, img_size, HYP_AUG, seed=0,
                               device=dev, device_bank=True)
        epoch_fn = make_epoch_scan(step, bfeed)

        def run_epoch() -> float:
            _, keys, ms = epoch_fn(state, *bfeed.epoch_schedule())
            return float(ms[:, keys.index("loss")].sum())

        run_epoch()                                     # warm
        n_epochs = max(2, 2 * wsteps // bfeed.steps_per_epoch)
        t0 = time.perf_counter()
        acc = sum(run_epoch() for _ in range(n_epochs))
        if not math.isfinite(acc):
            raise FloatingPointError("train_scan_feed: the loss is not "
                                     "finite")
        out["train_scan_feed_ips"] = (tbatch * bfeed.steps_per_epoch
                                      * n_epochs
                                      / (time.perf_counter() - t0))
    return out


def run(argv=None) -> dict:
    """The bench's record (module doc) for the command line `argv`."""
    a = parser().parse_args(argv)
    dev = resolve_device(a.device)
    img_size = a.img_size or (128 if a.quick else 512)
    rng = np.random.default_rng(0)
    peaks: dict = {}
    out = _eval_fields(a, dev, img_size, rng, peaks)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not a.skip_train:
        out.update(_train_fields(a, dev, img_size, rng, peaks))
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    out["power_limit_w"] = power_limit_w(dev)
    if dev.type == "cuda":
        out["peak_memory_bytes"] = peaks
    return out


def main(argv=None) -> dict:
    """Prints the record as one JSON line on stdout; whatever the run
    prints on its way (the feed's lines) goes to stderr."""
    with contextlib.redirect_stdout(sys.stderr):
        out = run(argv)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
