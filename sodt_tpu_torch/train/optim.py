"""Optimizer, LR / momentum schedules, parameter groups, EMA
(`sodt_tpu/train/optim.py`, there an optax chain).

  * groups: weight decay for >= 2-D kernels only, a separate bias group
    with its own warmup, the hardcoded 0.00048 decay,
  * SGD with Nesterov momentum (`optax.trace(nesterov=True)` after
    `add_decayed_weights`) or Adam with beta1 = momentum,
  * cosine one-cycle LR 1 -> lrf over epochs, or linear,
  * per-iteration warmup over max(3 epochs, 1000 iterations): LR from 0
    (biases from warmup_bias_lr), momentum from warmup_momentum; LR and
    momentum are functions of the OPTIMIZER step,
  * EMA with decay 0.9999 * (1 - exp(-step / 2000)) over parameters and
    BatchNorm statistics.

Gradient accumulation replays the reference exactly: gradients are SUMMED
across data iterations and the optimizer fires when `gate_fn(ni)` says so,
with `accumulate` itself interpolated 1 -> nbs/bs over the warmup span.

The optimizer works on dicts name -> tensor (the model's
`named_parameters()`), updates nothing itself and returns the updates, as
an optax transformation does: the train step applies them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

REFERENCE_WD = 0.00048   # hardcoded over the hyp file's weight_decay


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100):
    """Cosine ramp y1 -> y2."""
    def f(x):
        return ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1
    return f


def linear_lf(lrf: float, epochs: int):
    def f(x):
        return (1 - x / (epochs - 1)) * (1.0 - lrf) + lrf
    return f


def warmup_iters_of(hyp: dict, nb: int) -> int:
    """Warmup span in data iterations: max(3 epochs, 1000);
    hyp["warmup_iters"] overrides for tests and short runs."""
    wi = hyp.get("warmup_iters",
                 max(round(hyp.get("warmup_epochs", 3.0) * nb), 1000))
    return max(int(wi), 1)


def warmup_accumulate_plan(accumulate_final: int, warmup_iters: int):
    """For each data iteration ni in [0, warmup_iters] the reference sets
    accumulate = max(1, round(interp(ni, [0, nw], [1, nbs/bs]))) and fires
    the optimizer when ni % accumulate == 0. Returns
      gate_fn(ni) -> bool   (the optimizer fires at data iteration ni)
      ni_of_step(g) -> ni   (data iteration of the g-th optimizer step),
    tables over the warmup span and closed forms after it."""
    k_final = max(int(accumulate_final), 1)
    nw = int(warmup_iters)
    gates, ni_steps = [], []
    for ni in range(nw + 1):
        k = max(1, int(round(np.interp(ni, [0, nw], [1.0, float(k_final)]))))
        fire = ni % k == 0
        gates.append(fire)
        if fire:
            ni_steps.append(ni)
    n_warm_steps = len(ni_steps)
    first_tail_ni = (nw // k_final + 1) * k_final   # first multiple > nw

    def gate_fn(ni: int) -> bool:
        return gates[min(max(ni, 0), nw)] if ni <= nw else ni % k_final == 0

    def ni_of_step(g: int) -> int:
        if g < n_warm_steps:
            return ni_steps[min(max(g, 0), n_warm_steps - 1)]
        return first_tail_ni + (g - n_warm_steps) * k_final

    return gate_fn, ni_of_step


def lr_schedules(hyp: dict, epochs: int, nb: int, *, linear_lr: bool = False,
                 accumulate: int = 1, ni_of_step=None):
    """Per-optimizer-step schedules (lr_weights, lr_bias, momentum,
    warmup_iters). `nb` = batches per epoch; `ni_of_step` maps the
    optimizer step to its data iteration (exact under the interpolated
    accumulation), else `step * accumulate`."""
    lr0, lrf = hyp["lr0"], hyp["lrf"]
    lf = linear_lf(lrf, epochs) if linear_lr else one_cycle(1.0, lrf, epochs)
    warmup_iters = warmup_iters_of(hyp, nb)
    if ni_of_step is None:
        ni_of_step = lambda step: step * accumulate

    def base_lr(ni):
        return lr0 * lf(ni / nb)

    def interp(ni, y0, y1):
        t = min(max(ni / warmup_iters, 0.0), 1.0)
        return y0 + t * (y1 - y0)

    def lr_weights(step):
        ni = ni_of_step(step)
        return interp(ni, 0.0, base_lr(ni)) if ni < warmup_iters else base_lr(ni)

    def lr_bias(step):
        ni = ni_of_step(step)
        if ni < warmup_iters:
            return interp(ni, hyp.get("warmup_bias_lr", 0.1), base_lr(ni))
        return base_lr(ni)

    def momentum(step):
        ni = ni_of_step(step)
        if ni < warmup_iters:
            return interp(ni, hyp.get("warmup_momentum", 0.8), hyp["momentum"])
        return hyp["momentum"]

    return lr_weights, lr_bias, momentum, warmup_iters


def jax_leaf_name(name: str, p: torch.Tensor) -> str:
    """The flax leaf a parameter of the port corresponds to: "weight" is a
    "kernel" (>= 2-D) or a LayerNorm / BatchNorm "scale" (1-D)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight":
        return "kernel" if p.ndim >= 2 else "scale"
    return leaf


def param_labels(named_params: dict) -> dict:
    """name -> 'decay' | 'bias' | 'nodecay', by the JAX package's rule on
    the flax leaf name: 'decay' for >= 2-D leaves without "bias" in the
    name (kernels, pos_embed), 'bias' for leaves named bias, 'nodecay' for
    the rest (norm scales, and the relative_position_bias_table, whose
    name holds "bias", and SwinV2's q_bias / v_bias, which are not NAMED
    bias). SwinV2's 3-D logit_scale has no "bias" in its name and decays."""
    out = {}
    for name, p in named_params.items():
        leaf = jax_leaf_name(name, p)
        if p.ndim >= 2 and "bias" not in leaf:
            out[name] = "decay"
        elif leaf == "bias":
            out[name] = "bias"
        else:
            out[name] = "nodecay"
    return out


class Optimizer:
    """The optax chain of `make_optimizer` as one object: per group
    (add_decayed_weights ->) Nesterov trace or Adam moments -> scale by
    -lr, the hyperparameters read at the optimizer step count; optionally
    wrapped in the reference accumulation.

    `update(grads, params)` returns the updates (name -> tensor) to ADD to
    the parameters, or None when the accumulation gate did not fire;
    `just_stepped` says which."""

    def __init__(self, labels: dict, lr_w, lr_b, mom, *, adam: bool,
                 gate_fn=None):
        self.labels, self.adam = labels, adam
        self.lr_of = {"decay": lr_w, "nodecay": lr_w, "bias": lr_b}
        self.mom, self.gate_fn = mom, gate_fn
        self.count = 0               # optimizer steps taken
        self.ni = 0                  # data iterations seen (accumulation)
        self.acc: dict | None = None
        self.trace: dict = {}        # SGD momentum buffers / Adam mu
        self.nu: dict = {}           # Adam second moments
        self.just_stepped = False

    def state_dict(self) -> dict:
        """The optimizer's state (step counters, accumulated gradients,
        momentum / Adam moments), tensors on the CPU."""
        return self._tree(lambda v: v.detach().cpu())

    def snapshot(self) -> dict:
        """`state_dict`'s content as clones on the state's device (the
        checkpoint's snapshot, `checkpoint.snapshot_tree`)."""
        return self._tree(lambda v: v.detach().clone())

    def _tree(self, leaf) -> dict:
        each = lambda d: None if d is None else {k: leaf(v)
                                                 for k, v in d.items()}
        return {"count": self.count, "ni": self.ni, "acc": each(self.acc),
                "trace": each(self.trace), "nu": each(self.nu)}

    def load_state_dict(self, sd: dict, device) -> None:
        dev = lambda d: None if d is None else {k: v.to(device)
                                                 for k, v in d.items()}
        self.count, self.ni = int(sd["count"]), int(sd["ni"])
        self.acc, self.trace, self.nu = (dev(sd["acc"]), dev(sd["trace"]),
                                         dev(sd["nu"]))

    def _inner(self, grads: dict, params: dict) -> dict:
        m = self.mom(self.count)
        b2, eps = 0.999, 1e-8
        ups = {}
        for name, g in grads.items():
            label = self.labels[name]
            if label == "decay":
                g = g + REFERENCE_WD * params[name].detach()
            t = self.trace.get(name)
            if self.adam:
                mu = (1 - m) * g if t is None else m * t + (1 - m) * g
                nu = ((1 - b2) * g * g if name not in self.nu
                      else b2 * self.nu[name] + (1 - b2) * g * g)
                self.trace[name], self.nu[name] = mu, nu
                c = self.count + 1
                u = (mu / (1 - m ** c)) / (torch.sqrt(nu / (1 - b2 ** c)) + eps)
            else:
                t = g if t is None else g + m * t
                self.trace[name] = t
                u = g + m * t                          # Nesterov
            ups[name] = -self.lr_of[label](self.count) * u
        self.count += 1
        return ups

    @torch.no_grad()
    def update(self, grads: dict, params: dict) -> dict | None:
        if self.gate_fn is None:
            self.just_stepped = True
            return self._inner(grads, params)
        self.acc = (dict(grads) if self.acc is None
                    else {k: self.acc[k] + g for k, g in grads.items()})
        fire = self.gate_fn(self.ni)
        self.ni += 1
        self.just_stepped = fire
        if not fire:
            return None
        ups = self._inner(self.acc, params)
        self.acc = None
        return ups


def make_optimizer(hyp: dict, named_params: dict, epochs: int, nb: int, *,
                   adam: bool = False, linear_lr: bool = False,
                   accumulate: int = 1) -> Optimizer:
    """Grouped weight decay + schedules + (for accumulate > 1) the
    reference accumulation."""
    gate_fn = ni_of_step = None
    if accumulate > 1:
        gate_fn, ni_of_step = warmup_accumulate_plan(
            accumulate, warmup_iters_of(hyp, nb))
    lr_w, lr_b, mom, _ = lr_schedules(hyp, epochs, nb, linear_lr=linear_lr,
                                      accumulate=accumulate,
                                      ni_of_step=ni_of_step)
    return Optimizer(param_labels(named_params), lr_w, lr_b, mom, adam=adam,
                     gate_fn=gate_fn)


def ema_decay(step, base: float = 0.9999, tau: float = 2000.0) -> float:
    """EMA decay ramp d = base * (1 - exp(-step / tau)), in f32 as the JAX
    package computes it."""
    s = np.float32(step)
    return float(np.float32(base) * (np.float32(1.0)
                                     - np.exp(-s / np.float32(tau))))


@torch.no_grad()
def ema_update(ema: dict, new: dict, step: int) -> None:
    """One EMA step over name -> tensor (parameters and BatchNorm
    statistics), IN PLACE on `ema`: e <- e * d + (1 - d) * p."""
    d = ema_decay(step)
    for k, e in ema.items():
        e.mul_(d).add_(new[k].detach().to(e.dtype), alpha=1.0 - d)
