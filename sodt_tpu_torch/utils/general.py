"""Misc utilities (`sodt_tpu/utils/general.py`): label statistics for
--image-weights, config paths, image sizes, run directories, terminal
colours and logging.

JAX's `enable_compile_cache` turns on XLA's persistent compilation cache;
the port has no XLA, and its counterpart is the kernel build directory
(`kernels/_build.py`: each CUDA source is compiled once into
`build/sodt_tpu_torch/` and reloaded while its source is unchanged).
"""

from __future__ import annotations

import logging
import math
import re
from pathlib import Path

import numpy as np


def resolve_config_path(path) -> str:
    """A relative path names a file of this package first (so
    "configs/model.yaml", or just "model_swinv2.yaml", is the port's own
    copy), else the path as given."""
    p = Path(path)
    pkg = Path(__file__).resolve().parent.parent
    own = [] if p.is_absolute() else [pkg / p, pkg / "configs" / p]
    for cand in own + [p]:
        if cand.exists():
            return str(cand)
    raise FileNotFoundError(path)


def set_logging(rank: int = 0):
    logging.basicConfig(
        format="%(message)s",
        level=logging.INFO if rank in (-1, 0) else logging.WARN)


def check_img_size(img_size: int, s: int = 32) -> int:
    """Round img_size up to a multiple of the stride s."""
    new_size = int(math.ceil(img_size / s) * s)
    if new_size != img_size:
        print(f"WARNING: --img-size {img_size} must be multiple of {s}, "
              f"updating to {new_size}")
    return new_size


def colorstr(*inputs):
    """An ANSI-coloured string: colorstr("red", "bold", "text"), or
    colorstr("text") in bold blue."""
    *args, string = inputs if len(inputs) > 1 else ("blue", "bold", inputs[0])
    colors = {"black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
              "yellow": "\033[33m", "blue": "\033[34m",
              "magenta": "\033[35m", "cyan": "\033[36m", "white": "\033[37m",
              "bright_red": "\033[91m", "bright_green": "\033[92m",
              "end": "\033[0m", "bold": "\033[1m", "underline": "\033[4m"}
    return "".join(colors[x] for x in args) + f"{string}" + colors["end"]


def clean_str(s: str) -> str:
    return re.sub(pattern="[|@#!¡·$€%&()=?¿^*;:,¨´><+]", repl="_", string=s)


def labels_to_class_weights(labels, nc: int = 80) -> np.ndarray:
    """Inverse-frequency class weights, normalized to sum 1."""
    if not len(labels) or labels[0] is None:
        return np.zeros(0)
    cat = np.concatenate(labels, 0)
    classes = cat[:, 0].astype(np.int32)
    weights = np.bincount(classes, minlength=nc).astype(np.float64)
    weights[weights == 0] = 1
    weights = 1 / weights
    return weights / weights.sum()


def labels_to_image_weights(labels, nc: int = 80,
                            class_weights=None) -> np.ndarray:
    """Per-image sampling weights: the class weights of its labels."""
    if class_weights is None:
        class_weights = np.ones(nc)
    counts = np.array([np.bincount(x[:, 0].astype(int), minlength=nc)
                       for x in labels])
    return (class_weights.reshape(1, nc) * counts).sum(1)


def increment_path(path, exist_ok: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... (the first that is free)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    for n in range(2, 9999):
        p = Path(f"{path}{n}")
        if not p.exists():
            return p
    raise RuntimeError("increment_path exhausted")


def get_latest_run(search_dir: str = ".") -> str:
    """The most recently written last* checkpoint under search_dir, for
    --resume."""
    paths = sorted(Path(search_dir).rglob("last*"),
                   key=lambda p: p.stat().st_mtime)
    return str(paths[-1]) if paths else ""
