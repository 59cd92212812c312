"""Experiment logging (`sodt_tpu/utils/loggers.py`): a JSONL event stream,
TensorBoard and optional W&B.

`events.jsonl` in the run directory is the machine-readable record of a
run: one object a `log_scalars` call, {"t", "step", tag: value...}.
TensorBoard scalars go to `<save_dir>/tb` where `torch.utils.tensorboard`
imports (it is imported when a logger is made, never with this module);
W&B where wandb is installed and asked for, with its artifact lifecycle
(`wandb_utils.WandbLifecycle`, inert without a run).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

from .wandb_utils import WandbLifecycle

# the 13 per-epoch scalar tags of the reference trainer
TAGS = ["train/box_loss", "train/obj_loss", "train/cls_loss",
        "metrics/precision", "metrics/recall", "metrics/mAP_0.5",
        "metrics/mAP_0.5:0.95", "val/box_loss", "val/obj_loss",
        "val/cls_loss", "x/lr0", "x/lr1", "x/lr2"]


def _summary_writer(log_dir: Path):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    return SummaryWriter(log_dir=str(log_dir))


def _wandb_init(**kw):
    try:
        import wandb
    except Exception:
        return None
    return wandb.init(**kw)


class RunLogger:
    def __init__(self, save_dir: str | Path, use_tb: bool = True,
                 use_wandb: bool = False, config: dict | None = None,
                 project: str = "sodt_tpu"):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.save_dir / "events.jsonl", "a")
        self.tb = _summary_writer(self.save_dir / "tb") if use_tb else None
        self.wandb_run = (_wandb_init(project=project, config=config,
                                      dir=str(self.save_dir), resume="allow")
                          if use_wandb else None)
        self.lifecycle = WandbLifecycle(self.wandb_run)

    @property
    def wandb_id(self) -> str | None:
        return self.wandb_run.id if self.wandb_run is not None else None

    def log_scalars(self, scalars: dict[str, float], step: int):
        rec = {"t": time.time(), "step": step, **scalars}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)
        if self.wandb_run is not None:
            self.wandb_run.log(scalars, step=step)

    def log_epoch(self, epoch: int, train_losses: dict, metrics: dict,
                  lrs: tuple = ()):
        """The TAGS of one eval: train losses, P / R / mAPs, val losses
        where the eval gave them, the three learning rates."""
        scalars = {}
        for k, tag in (("box", "train/box_loss"), ("obj", "train/obj_loss"),
                       ("cls", "train/cls_loss")):
            if k in train_losses:
                scalars[tag] = train_losses[k]
        for k, tag in (("mp", "metrics/precision"), ("mr", "metrics/recall"),
                       ("map50", "metrics/mAP_0.5"),
                       ("map", "metrics/mAP_0.5:0.95")):
            if k in metrics:
                scalars[tag] = metrics[k]
        for k, v in (metrics.get("val_loss") or {}).items():
            scalars[f"val/{k}_loss"] = v
        for i, lr in enumerate(lrs):
            scalars[f"x/lr{i}"] = float(lr)
        self.log_scalars(scalars, epoch)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()
