"""The training loop (`sodt_tpu/train/trainer.py`, the part that this
slice of the port covers).

Synthetic data only, square un-augmented batches padded to `MAX_LABELS`
labels per image, the hyp gain scaling of the JAX trainer, a per-step loop
(`state.make_train_step`), and a final `evaluate` of the EMA weights
through the eval path. Augmentation, VEDAI folders, checkpoints / resume,
autoanchor, rect and multi-scale batches, the SR branch, evolve and W&B are
not ported yet (ROADMAP.md Queue 1 items 9-11): their options are absent
from `TrainConfig`.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import numpy as np
import torch
import yaml

from .. import resolve_device
from ..data import SyntheticVedai, make_eval_batches
from ..data.synthetic import pad_labels
from ..models import build_model
from ..models.compiler import resolve_config_path
from ..weights import batch_to_torch, init_weights, load_npz
from .evaluate import evaluate
from .loss import LossConfig
from .optim import make_optimizer
from .state import TrainState, make_train_step

NOMINAL_BATCH = 64
MAX_LABELS = 30      # label slots per image in a padded batch
LOG_EVERY = 10       # steps between the loss samples of an epoch's mean
CH_IN = {"RGB": 3, "IR": 3, "RGB+IR": 4, "RGB+IR+fusion": 8, "RGB+IR+MF": 3}


@dataclass
class TrainConfig:
    cfg: str = "configs/model.yaml"
    data: str = "configs/data_vedai.yaml"
    hyp: str = "configs/hyp.scratch.yaml"
    epochs: int = 300
    batch_size: int = 16
    img_size: int = 512
    input_mode: str = "RGB+IR"
    adam: bool = False
    linear_lr: bool = False
    synthetic: bool = False
    synthetic_n: int = 64
    seed: int = 0
    bf16: bool = True
    notest: bool = False             # only evaluate the final epoch
    nbs: int = NOMINAL_BATCH         # nominal batch for grad accumulation
    freeze: tuple = ()               # parameter-name substrings to freeze
    weights_npz: str = ""            # initial state_dict (weights.save_npz)
    device: str = "cuda"


def make_train_batches(dataset, batch_size: int, max_labels: int, seed: int,
                       epoch: int):
    """One epoch of square un-augmented batches in a seeded random order,
    the remainder dropped (nb = n // batch_size): dicts of numpy arrays
    with uint8 images."""
    order = np.random.default_rng(seed * 7919 + epoch).permutation(len(dataset))
    for start in range(0, len(order) - batch_size + 1, batch_size):
        rgbs, irs, labs, msks = [], [], [], []
        for i in order[start:start + batch_size]:
            rgb, ir, lab = dataset[int(i)]
            pl, pm = pad_labels(lab, max_labels)
            rgbs.append(rgb)
            irs.append(ir)
            labs.append(pl)
            msks.append(pm)
        yield {"img": np.stack(rgbs), "ir": np.stack(irs),
               "targets": np.stack(labs), "tmask": np.stack(msks)}


def scale_hyp(hyp: dict, nl: int, nc: int, img_size: int) -> dict:
    """The loss gains scaled to the number of levels, classes and the
    image size, as the JAX trainer scales them."""
    hyp = dict(hyp)
    hyp["box"] = hyp["box"] * 3.0 / nl
    hyp["cls"] = hyp["cls"] * nc / 80.0 * 3.0 / nl
    hyp["obj"] = hyp["obj"] * (img_size / 640) ** 2 * 3.0 / nl
    return hyp


def loss_config(model, hyp: dict, nc: int) -> LossConfig:
    return LossConfig(
        nc=nc, anchors=model.spec.anchors, strides=model.spec.detect_strides,
        hyp_box=hyp["box"], hyp_obj=hyp["obj"], hyp_cls=hyp["cls"],
        cls_pw=hyp.get("cls_pw", 1.0), obj_pw=hyp.get("obj_pw", 1.0),
        anchor_t=hyp.get("anchor_t", 4.0), fl_gamma=hyp.get("fl_gamma", 0.0))


def ema_model(state: TrainState) -> torch.nn.Module:
    """A copy of the model that holds the EMA weights and statistics."""
    m = copy.deepcopy(state.model)
    m.load_state_dict(state.ema, strict=False)
    return m.eval()


def train(tc: TrainConfig, on_step=None, on_grads=None) -> dict:
    """Train, evaluate the EMA weights, return the metrics. Two hooks for
    measurements: `on_step(state, metrics)` is called after every step,
    `on_grads(grads)` with every step's gradients (`make_train_step`)."""
    dev = resolve_device(tc.device)
    if not tc.synthetic:
        raise NotImplementedError(
            "VEDAI folder datasets and augmentation: ROADMAP.md Queue 1 "
            "item 9; use --synthetic")
    with open(resolve_config_path(tc.hyp)) as f:
        hyp = yaml.safe_load(f)
    with open(resolve_config_path(tc.data)) as f:
        data_cfg = yaml.safe_load(f)
    nc = int(data_cfg.get("nc", 8))
    dtype = torch.bfloat16 if tc.bf16 else torch.float32

    train_ds = SyntheticVedai(n=tc.synthetic_n, img_size=tc.img_size, nc=nc,
                              seed=tc.seed)
    val_ds = SyntheticVedai(n=max(tc.synthetic_n // 4, 4),
                            img_size=tc.img_size, nc=nc, seed=tc.seed + 1)
    model = build_model(tc.cfg, ch_in=CH_IN[tc.input_mode], nc=nc,
                        dtype=dtype, input_mode=tc.input_mode)
    if tc.weights_npz:
        model.load_state_dict(load_npz(tc.weights_npz))
    else:
        init_weights(model, seed=tc.seed)
    model = model.to(dev)
    nb = max(len(train_ds) // tc.batch_size, 1)
    accumulate = max(round(tc.nbs / tc.batch_size), 1)
    hyp = scale_hyp(hyp, len(model.spec.anchors), nc, tc.img_size)

    params = dict(model.named_parameters())
    tx = make_optimizer(hyp, params, epochs=tc.epochs, nb=nb, adam=tc.adam,
                        linear_lr=tc.linear_lr, accumulate=accumulate)
    state = TrainState.create(model, tx)
    step_fn = make_train_step(model, tx, loss_config(model, hyp, nc),
                              freeze=tuple(tc.freeze), on_grads=on_grads)
    nparams = sum(p.numel() for p in params.values())
    print(f"model {tc.cfg} ({nparams / 1e6:.2f}M params), device {dev}, "
          f"nb={nb}/epoch, accumulate={accumulate}")

    metrics_out: dict = {}
    history = []
    t_start = time.time()
    for epoch in range(tc.epochs):
        t_epoch = time.time()
        losses = []
        batches = make_train_batches(train_ds, tc.batch_size, MAX_LABELS,
                                     tc.seed, epoch)
        for bi, batch in enumerate(batches):
            state, m = step_fn(state, batch_to_torch(batch, dev))
            if on_step is not None:
                on_step(state, m)
            if bi % LOG_EVERY == 0:
                losses.append({k: float(v) for k, v in m.items()})
        mean_losses = ({k: float(np.mean([l[k] for l in losses]))
                        for k in losses[0]} if losses else {})
        ips = tc.batch_size * nb / (time.time() - t_epoch)
        line = (f"epoch {epoch}/{tc.epochs - 1} "
                + " ".join(f"{k}={v:.4f}" for k, v in mean_losses.items())
                + f" img/s={ips:.1f}")
        if epoch == tc.epochs - 1 or not tc.notest:
            metrics_out = evaluate(
                ema_model(state), make_eval_batches(val_ds, tc.batch_size),
                nc=nc, img_size=tc.img_size, device=dev)
            line += (f" mAP50={metrics_out['map50']:.4f} "
                     f"mAP={metrics_out['map']:.4f}")
        print(line)
        history.append(mean_losses)
    metrics_out["train_time_s"] = time.time() - t_start
    metrics_out["losses"] = history
    metrics_out["steps"] = state.step
    metrics_out["device"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
    return metrics_out
