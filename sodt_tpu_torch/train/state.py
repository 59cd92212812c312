"""TrainState and the train step (`sodt_tpu/train/state.py`).

The JAX package's step is a pure function over an immutable pytree. Here
the parameters and BatchNorm statistics live in the model, and the step
updates the model, the optimizer state and the EMA copy IN PLACE; it
returns the same `TrainState` object for symmetry with the JAX signature:

  forward in training mode (batch BN statistics, running stats updated)
  -> detection loss (+ the SR branch's L1) -> gradients (f32, on the f32 master parameters)
  -> optimizer update (schedules are functions of the optimizer step)
  -> EMA of parameters and BN statistics, only on steps where the
     optimizer fired.

No GradScaler: bf16 keeps the f32 exponent range.

`make_epoch_scan` is JAX's epoch path (`lax.scan` over gather -> augment
-> train step, one dispatch an epoch): here a Python loop over the same
steps, fed from a schedule uploaded to the device once, with the metrics
kept on the device and fetched once a chunk, so that the host never
waits on the card between steps.

Data parallelism (`parallel.mesh`, W > 1 ranks): each rank runs the step
on its B / W rows; the loss is its share of the global loss
(`loss.compute_loss`), the gradients are summed over the ranks in one
all-reduce a dtype before `on_grads` and the optimizer (an accumulation
then sums global micro-step gradients, as JAX's does), and the metrics
are summed, so every rank logs the global values and takes the same
update. The model is not wrapped in DistributedDataParallel: the step
takes its gradients with `torch.autograd.grad`, which DDP's reducer does
not see. `make_epoch_scan` gives each rank its rows of every step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.resize import resize_bilinear
from ..parallel.mesh import all_reduce_dict, all_reduce_tensors, shard_rows, \
    world_size
from .loss import LossConfig, compute_loss
from .optim import Optimizer, ema_update


def sr_l1(sr_out: torch.Tensor, img: torch.Tensor, ir, mode: str):
    """The SR branch's L1 loss against the full-resolution images."""
    if mode == "IR":
        return 0.5 * (sr_out - ir).abs().mean()
    if mode == "RGB":
        return 0.5 * (sr_out - img).abs().mean()
    return 0.1 * ((sr_out[..., 0:3] - img).abs().mean()
                  + (sr_out[..., 3:4] - ir[..., 0:1]).abs().mean())


def ema_tensors(model: nn.Module) -> dict:
    """What the EMA tracks: every parameter and every persistent buffer
    (the BatchNorm running statistics), name -> tensor."""
    out = dict(model.named_parameters())
    out.update({k: v for k, v in model.state_dict(keep_vars=True).items()
                if k not in out})
    return out


@dataclass
class TrainState:
    model: nn.Module                 # parameters + BN statistics
    tx: Optimizer                    # optimizer state
    ema: dict                        # EMA of parameters and BN statistics
    step: int = 0                    # data iterations taken
    ema_updates: int = 0             # EMA update counter

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        ema = {k: v.detach().clone() for k, v in ema_tensors(model).items()}
        return cls(model=model, tx=tx, ema=ema)


def make_train_step(model: nn.Module, tx: Optimizer, loss_cfg: LossConfig, *,
                    sr: bool = False, down_factor: int = 1,
                    freeze: tuple = (), on_grads=None):
    """Build `train_step(state, batch) -> (state, metrics)`.

    batch: dict of tensors on the model's device: img, ir (B, H, W, 3)
    float in [0, 1]; targets (B, M, 5) [cls, cx, cy, w, h] normalized;
    tmask (B, M) bool. metrics: loss, box, obj, cls (0-d tensors), and sr
    when the SR loss is on.

    The SR regime (`sr`, `down_factor`), as in JAX: with down_factor > 1
    the model takes the batch resized to H / down_factor, W / down_factor
    (JAX's antialiased bilinear), and the SR output of a model built with
    the SR branch is held in f32 to the full-resolution images by L1:
    0.5 x mean |sr - img| (or ir) for one modality, 0.1 x (mean |sr[..., :3]
    - img| + mean |sr[..., 3:] - ir[..., :1]|) for the fused modes.

    `freeze`: substrings of parameter names (`l0.stage1_0.attn.qkv.weight`);
    a matching parameter gets zero gradients AND zero updates, so neither
    the gradient step nor the weight decay moves it.

    Gradient accumulation is the optimizer's (`make_optimizer(...,
    accumulate=n)`): `tx.just_stepped` says whether its gate fired.
    `on_grads(grads)` is called with the step's gradients (name -> f32
    tensor, frozen ones zeroed) before the update; the step keeps no
    reference to them."""
    params = dict(model.named_parameters())
    frozen = {k for k in params if any(f in k for f in freeze)}

    def train_step(state: TrainState, batch: dict):
        model.train()
        img, ir = batch["img"], batch.get("ir")
        img_in, ir_in = img, ir
        if down_factor > 1:
            size = (img.shape[1] // down_factor, img.shape[2] // down_factor)
            img_in = resize_bilinear(img, size)
            ir_in = resize_bilinear(ir, size) if ir is not None else None
        out = model(img_in, ir_in)
        world = world_size()
        total, parts = compute_loss(out["raw"], batch["targets"],
                                    batch["tmask"], loss_cfg, world)
        if sr and "sr" in out:
            sr_loss = sr_l1(out["sr"].float(), img, ir, model.input_mode)
            if world > 1:       # a mean over equal shards
                sr_loss = sr_loss / world
            total = total + sr_loss
            parts = dict(parts, sr=sr_loss)
        names = list(params)
        gs = torch.autograd.grad(total, [params[k] for k in names])
        if world > 1:
            gs = all_reduce_tensors(list(gs))
        grads = {k: (torch.zeros_like(g) if k in frozen else g)
                 for k, g in zip(names, gs)}
        if on_grads is not None:
            on_grads(grads)
        updates = tx.update(grads, params)
        with torch.no_grad():
            if updates is not None:
                for k, u in updates.items():
                    if k not in frozen:
                        params[k].add_(u)
            if tx.just_stepped:
                state.ema_updates += 1
                ema_update(state.ema, ema_tensors(model), state.ema_updates)
        state.step += 1
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in parts.items()}}
        if world > 1:
            metrics = all_reduce_dict(metrics)
        return state, metrics

    return train_step


def make_epoch_scan(train_step, feed):
    """Build `epoch_fn(state, prim, sec, draws, on_step=None) -> (state,
    keys, metrics)`: the steps of a schedule (`BankFeed.epoch_schedule`
    rows, one or several epochs stacked: prim / sec (K, B, 4), draws
    (K, B, N_DRAWS), numpy), each gather -> augment -> `train_step` from
    `feed`'s bank. The schedule goes to the device in one upload a tensor;
    each step's metrics stay on the device, stacked into `metrics`, a
    (K, len(keys)) f32 tensor on the device that the caller fetches once.
    Nothing between two steps reads a device value on the host, except
    `on_step(state, step_metrics)` where a caller passes one.

    Under W > 1 ranks each rank augments and trains on its rows of every
    step of the global schedule (JAX's sharding constraint on the
    augmented batch; the augmentation is per sample)."""

    def epoch_fn(state, prim, sec, draws, on_step=None):
        dev = feed.device
        mine = shard_rows(prim.shape[1])
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, mine])).to(
            dev)
        p, d = up(prim), up(draws)
        q = None if sec is None else up(sec)
        rows = []
        for k in range(p.shape[0]):
            batch = feed.augment_device(p[k], None if q is None else q[k],
                                        d[k])
            state, m = train_step(state, batch)
            if on_step is not None:
                on_step(state, m)
            rows.append(m)
        keys = list(rows[0])
        return state, keys, torch.stack(
            [torch.stack([m[key].float() for key in keys]) for m in rows])

    return epoch_fn
