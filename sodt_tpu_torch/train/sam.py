"""Sharpness-Aware Minimization (`sodt_tpu/train/sam.py`): optax's opaque
SAM (`optax.contrib.sam(base, adv, opaque_mode=True)`, sync period 2,
adversarial state reset) around the port's `Optimizer`.

One update of `SAM.update(grads, params, grad_fn=...)`:

  1. the adversarial step, JAX's transform `normalize()` then
     `scale(rho)`, whose output optax's SAM negates before applying it:
     p_adv = p - rho * g / ||g||, with ||g|| the global L2 norm over every
     tensor. That is downhill; the textbook SAM steps to p + rho * g / ||g||.
     The port keeps JAX's sign;
  2. g_adv = grad_fn(p_adv, 0);
  3. the base optimizer's update of the outer parameters p with g_adv.

The base optimizer's schedules are calibrated for `accumulate` (the
optimizer step k sits at data iteration k * accumulate), without its own
accumulation: the gate (`optim.warmup_accumulate_plan`) stands outside SAM,
as in JAX, so that the ascent sees the summed gradients. Between two
firings `update` returns None and `just_stepped` is False. (JAX's wrapper
at accumulate > 1 passes no `grad_fn` to the opaque SAM and cannot run;
the port runs that composition as the wrapper lays it out.)

`grad_fn(params, i)` takes and returns dicts name -> tensor; nothing here
touches a model, so BatchNorm statistics are the caller's (opaque mode:
the caller's forward at p_adv decides whether they update). JAX wires
SAM into no trainer, and neither does the port.

Under a process group of W > 1 ranks (`parallel.mesh`) `grads` and what
`grad_fn` returns are this rank's shares, and both are summed over the
ranks before they are used: the ascent's norm is the global gradient's.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import all_reduce_dict
from .optim import (Optimizer, lr_schedules, param_labels,
                    warmup_accumulate_plan, warmup_iters_of)


class SAM:
    """SAM(base) with the accumulation gate outside it; see the module
    doc. `update` returns the updates to ADD to the parameters, or None."""

    def __init__(self, base: Optimizer, rho: float = 0.05, gate_fn=None):
        self.base, self.rho, self.gate_fn = base, rho, gate_fn
        self.ni = 0
        self.acc: dict | None = None
        self.just_stepped = False

    @torch.no_grad()
    def adversarial_params(self, grads: dict, params: dict) -> dict:
        """p - rho * g / ||g||_global (JAX's sign)."""
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        return {k: params[k].detach() - self.rho * (g / norm)
                for k, g in grads.items()}

    def update(self, grads: dict, params: dict, *, grad_fn) -> dict | None:
        grads = all_reduce_dict(grads)
        if self.gate_fn is not None:
            self.acc = (dict(grads) if self.acc is None
                        else {k: self.acc[k] + g for k, g in grads.items()})
            fire = self.gate_fn(self.ni)
            self.ni += 1
            self.just_stepped = fire
            if not fire:
                return None
            grads, self.acc = self.acc, None
        self.just_stepped = True
        adv_grads = all_reduce_dict(grad_fn(self.adversarial_params(grads,
                                                                    params), 0))
        return self.base.update(adv_grads, params)


def make_sam_optimizer(hyp: dict, named_params: dict, epochs: int, nb: int,
                       *, rho: float = 0.05, adam: bool = False,
                       linear_lr: bool = False, accumulate: int = 1) -> SAM:
    """SAM around `make_optimizer`'s grouping and schedules, rho 0.05 by
    default."""
    lr_w, lr_b, mom, _ = lr_schedules(hyp, epochs, nb, linear_lr=linear_lr,
                                      accumulate=accumulate)
    base = Optimizer(param_labels(named_params), lr_w, lr_b, mom, adam=adam)
    gate_fn = None
    if accumulate > 1:
        gate_fn, _ = warmup_accumulate_plan(accumulate,
                                            warmup_iters_of(hyp, nb))
    return SAM(base, rho=rho, gate_fn=gate_fn)
