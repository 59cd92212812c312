"""W&B experiment lifecycle (`sodt_tpu/utils/wandb_utils.py`): resume
detection, model and dataset artifacts, bbox media.

Everything is import-gated: where wandb is not installed the helpers are
inert and the training loop runs unchanged; `--resume
wandb-artifact://...` then raises, naming the missing package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    import wandb
    _HAS_WANDB = True
except Exception:
    wandb = None
    _HAS_WANDB = False

WANDB_ARTIFACT_PREFIX = "wandb-artifact://"


def is_wandb_artifact(path: str) -> bool:
    """Whether a --resume string names a model artifact instead of a local
    checkpoint."""
    return isinstance(path, str) and path.startswith(WANDB_ARTIFACT_PREFIX)


def resolve_artifact_checkpoint(resume: str, alias: str = "latest") -> str:
    """Download the checkpoint artifact behind a wandb-artifact:// resume
    string and return its local path."""
    if not _HAS_WANDB:
        raise RuntimeError("wandb not installed; cannot resolve "
                           f"{resume!r}")
    name = resume[len(WANDB_ARTIFACT_PREFIX):]
    if ":" not in name.rsplit("/", 1)[-1]:
        name = f"{name}:{alias}"
    artifact = wandb.Api().artifact(name, type="model")
    return artifact.download()


class WandbLifecycle:
    """Artifact and media logging for one run (no-op without a live run)."""

    def __init__(self, run=None):
        self.run = run

    @property
    def active(self) -> bool:
        return self.run is not None and _HAS_WANDB

    def log_model(self, ckpt_path: str | Path, *, epoch: int,
                  fitness: float, best: bool = False):
        """Version a checkpoint as a model artifact, aliased latest,
        epoch{N} and (when it is the best so far) best."""
        if not self.active:
            return None
        art = wandb.Artifact(
            f"run_{self.run.id}_model", type="model",
            metadata={"epoch": epoch, "fitness": float(fitness)})
        p = Path(ckpt_path)
        if p.is_dir():
            art.add_dir(str(p))
        else:
            art.add_file(str(p))
        aliases = ["latest", f"epoch{epoch}"] + (["best"] if best else [])
        self.run.log_artifact(art, aliases=aliases)
        return art

    def log_dataset(self, data_cfg: dict, name: str = "dataset"):
        """The data yaml's fold lists as a dataset artifact."""
        if not self.active:
            return None
        art = wandb.Artifact(name, type="dataset", metadata=dict(data_cfg))
        for key in ("train", "val", "test"):
            lst = data_cfg.get(key)
            if lst and Path(lst).exists():
                art.add_file(str(lst), name=f"{key}.txt")
        self.run.log_artifact(art)
        return art

    def bbox_images(self, images_u8, dets, valid, names,
                    max_images: int = 16):
        """wandb.Image bbox panels for a validation batch. images_u8:
        (B, H, W, 3) uint8; dets (B, max_det, 6) xyxy + conf + cls; valid
        (B, max_det) bool."""
        if not self.active:
            return []
        out = []
        class_labels = {i: str(n) for i, n in enumerate(names)}
        for bi in range(min(len(images_u8), max_images)):
            h, w = images_u8[bi].shape[:2]
            boxes = []
            for d, ok in zip(np.asarray(dets[bi]), np.asarray(valid[bi])):
                if not ok:
                    continue
                boxes.append({
                    "position": {"minX": float(d[0]) / w,
                                 "minY": float(d[1]) / h,
                                 "maxX": float(d[2]) / w,
                                 "maxY": float(d[3]) / h},
                    "class_id": int(d[5]),
                    "box_caption": f"{class_labels.get(int(d[5]), d[5])} "
                                   f"{d[4]:.3f}",
                    "scores": {"conf": float(d[4])},
                })
            out.append(wandb.Image(
                images_u8[bi],
                boxes={"predictions": {"box_data": boxes,
                                       "class_labels": class_labels}}))
        return out

    def log_media(self, key: str, images, step: int | None = None):
        if self.active and images:
            self.run.log({key: images}, step=step)
