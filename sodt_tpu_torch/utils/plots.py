"""Plotting (`sodt_tpu/utils/plots.py`): batch mosaics with boxes, PR and
metric-confidence curves, the confusion matrix, label statistics, the
results curves of a run, the evolution scatter, the study curve and the
LR schedule.

matplotlib only, imported inside the functions (it imports PIL, which the
port's import graph must not hold). Where it is missing every function
writes nothing and returns None; a written plot returns its path.
`missing_reason()` says why nothing can be written, for the CLIs' "no
plot written" line.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib does
    not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def missing_reason() -> str | None:
    """None where plots can be written, else why not."""
    try:
        import matplotlib  # noqa: F401
    except Exception as e:
        return f"matplotlib is not installed ({type(e).__name__}: {e})"
    return None


def _save(fig, plt, path, dpi: int) -> Path:
    fig.savefig(str(path), dpi=dpi)
    plt.close(fig)
    return Path(path)


def color_for(cls: int):
    rng = np.random.default_rng(int(cls) + 7)
    return tuple(rng.uniform(0.2, 0.95, 3))


def plot_images(images: np.ndarray, targets: np.ndarray,
                tmasks: np.ndarray, path: str | Path, names=None,
                max_images: int = 16):
    """A batch mosaic with normalized-xywh boxes. images (B, H, W, 3) in
    [0, 1]; targets (B, M, 5) [cls, cx, cy, w, h]; tmasks (B, M)."""
    plt = _pyplot()
    if plt is None:
        return None
    b = min(images.shape[0], max_images)
    cols = int(math.ceil(math.sqrt(b)))
    rows = int(math.ceil(b / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= b:
            continue
        img = np.clip(np.asarray(images[i]), 0, 1)
        h, w = img.shape[:2]
        ax.imshow(img)
        for t, ok in zip(np.asarray(targets[i]), np.asarray(tmasks[i])):
            if not ok:
                continue
            cls, cx, cy, bw, bh = t[:5]
            x1, y1 = (cx - bw / 2) * w, (cy - bh / 2) * h
            ax.add_patch(plt.Rectangle((x1, y1), bw * w, bh * h,
                                       fill=False, lw=1.5,
                                       edgecolor=color_for(int(cls))))
            label = (names[int(cls)] if names and int(cls) < len(names)
                     else str(int(cls)))
            ax.text(x1, y1 - 2, label, fontsize=7,
                    color=color_for(int(cls)))
    fig.tight_layout()
    return _save(fig, plt, path, 120)


def boxes_as_targets(d: np.ndarray, hw):
    """(n, 6) xyxy + conf + cls in pixels of an (h, w) image -> the
    (1, max(n, 1), 5) [cls, cx, cy, w, h] normalized targets and their
    (1, max(n, 1)) mask, as `plot_images` takes them."""
    h, w = hw
    t = np.zeros((1, max(len(d), 1), 5), np.float32)
    m = np.zeros((1, max(len(d), 1)), bool)
    for i, (x1, y1, x2, y2, _, cls) in enumerate(d):
        t[0, i] = [cls, (x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                   (x2 - x1) / w, (y2 - y1) / h]
        m[0, i] = True
    return t, m


def plot_pr_curve(px, py, ap, path: str | Path, names=()):
    """Precision against recall per class and their mean."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if len(py) else np.zeros((1000, 0))
    if 0 < len(names) < 21:
        for i in range(py.shape[1]):
            ax.plot(px, py[:, i], linewidth=1,
                    label=f"{names[i]} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    if py.shape[1]:
        ax.plot(px, py.mean(1), linewidth=3, color="blue",
                label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(loc="lower left", fontsize=8)
    return _save(fig, plt, path, 250)


def plot_mc_curve(px, py, path: str | Path, names=(), xlabel="Confidence",
                  ylabel="Metric"):
    """A metric against confidence per class and their mean."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i in range(py.shape[0]):
            ax.plot(px, py[i], linewidth=1, label=names[i])
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = py.mean(0)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(loc="lower left", fontsize=8)
    return _save(fig, plt, path, 250)


def plot_confusion_matrix(matrix: np.ndarray, path: str | Path, names=()):
    """The (nc + 1)^2 matrix of `metrics.ConfusionMatrix`, each column
    normalized, background last."""
    plt = _pyplot()
    if plt is None:
        return None
    nc = matrix.shape[0] - 1
    norm = matrix / (matrix.sum(0, keepdims=True) + 1e-6)
    fig, ax = plt.subplots(figsize=(10, 8), tight_layout=True)
    im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
    fig.colorbar(im)
    labels = (list(names) + ["background"]
              if names and len(names) == nc else None)
    if labels:
        ax.set_xticks(range(nc + 1))
        ax.set_xticklabels(labels, rotation=90, fontsize=8)
        ax.set_yticks(range(nc + 1))
        ax.set_yticklabels(labels, fontsize=8)
    if nc < 30:
        for i in range(nc + 1):
            for j in range(nc + 1):
                if norm[i, j] >= 0.005:
                    ax.text(j, i, f"{norm[i, j]:.2f}", ha="center",
                            va="center", fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    return _save(fig, plt, path, 250)


def plot_labels(labels: np.ndarray, path_dir: str | Path, nc: int,
                names=()):
    """`<path_dir>/labels.png`: the class histogram, the centres, the sizes
    and their density, of (n, 5) [cls, cx, cy, w, h] labels."""
    plt = _pyplot()
    if plt is None or labels.shape[0] == 0:
        return None
    c, boxes = labels[:, 0], labels[:, 1:5]
    fig, axes = plt.subplots(2, 2, figsize=(10, 10), tight_layout=True)
    axes[0, 0].hist(c, bins=np.arange(nc + 1) - 0.5, rwidth=0.8)
    axes[0, 0].set_xlabel("classes")
    axes[0, 1].scatter(boxes[:, 0], boxes[:, 1], s=3, alpha=0.4)
    axes[0, 1].set_xlabel("cx")
    axes[0, 1].set_ylabel("cy")
    axes[1, 0].scatter(boxes[:, 2], boxes[:, 3], s=3, alpha=0.4)
    axes[1, 0].set_xlabel("w")
    axes[1, 0].set_ylabel("h")
    axes[1, 1].hist2d(boxes[:, 2], boxes[:, 3], bins=50)
    axes[1, 1].set_xlabel("wh density")
    return _save(fig, plt, Path(path_dir) / "labels.png", 200)


def plot_results(results_jsonl: str | Path, path: str | Path):
    """The training curves of a run: one panel a tag of the last record of
    its events.jsonl, against the records' step."""
    plt = _pyplot()
    if plt is None:
        return None
    rows = []
    with open(results_jsonl) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    if not rows:
        return None
    keys = [k for k in rows[-1] if k not in ("t", "step")]
    n = len(keys)
    cols = 4
    r = int(math.ceil(n / cols))
    fig, axes = plt.subplots(r, cols, figsize=(4 * cols, 3 * r),
                             squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        xs = [row["step"] for row in rows if k in row]
        ys = [row[k] for row in rows if k in row]
        ax.plot(xs, ys, marker=".")
        ax.set_title(k, fontsize=9)
    for i in range(n, r * cols):
        axes[i // cols][i % cols].axis("off")
    fig.tight_layout()
    return _save(fig, plt, path, 150)


def plot_evolution(evolve_file, path, keys=None):
    """After --evolve: fitness against each hyperparameter's value, one
    panel a hyperparameter, the best generation marked."""
    plt = _pyplot()
    if plt is None:
        return None
    if keys is None:
        from ..train.evolve import META
        keys = list(META.keys())
    data = np.loadtxt(str(evolve_file), ndmin=2)
    if data.size == 0:
        return None
    fit = data[:, 0]
    best = int(fit.argmax())
    n = len(keys)
    cols = 5
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.5 * rows))
    for i, k in enumerate(keys):
        ax = axes.ravel()[i]
        v = data[:, i + 1]
        ax.scatter(v, fit, c=fit, cmap="viridis", alpha=0.8,
                   edgecolors="none", s=16)
        ax.scatter(v[best], fit[best], marker="+", color="r", s=80)
        ax.set_title(f"{k} = {v[best]:.3g}", fontsize=8)
        ax.tick_params(labelsize=6)
    for j in range(n, rows * cols):
        axes.ravel()[j].axis("off")
    fig.tight_layout()
    return _save(fig, plt, path, 150)


def plot_study(rows, path):
    """`val --task study`: mAP@0.5 against latency, one point a size."""
    plt = _pyplot()
    if plt is None:
        return None
    rows = [r for r in rows if "map50" in r]
    if not rows:
        return None
    ms = [r["speed_ms"] for r in rows]
    m50 = [100 * r["map50"] for r in rows]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(ms, m50, ".-", linewidth=2, markersize=8)
    for r, x, y in zip(rows, ms, m50):
        ax.annotate(str(r["img_size"]), (x, y), fontsize=7,
                    textcoords="offset points", xytext=(4, 4))
    ax.set_xlabel("latency (ms/img)")
    ax.set_ylabel("mAP@0.5 (%)")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    return _save(fig, plt, path, 150)


def plot_lr_schedule(lr_fns, steps: int, path, labels=("weights", "bias")):
    """The learning rates against the optimizer step (the schedules are
    functions of it)."""
    plt = _pyplot()
    if plt is None:
        return None
    xs = np.arange(steps)
    fig, ax = plt.subplots(figsize=(6, 4))
    for fn, lab in zip(lr_fns, labels):
        ax.plot(xs, [float(fn(int(x))) for x in xs], label=lab)
    ax.set_xlabel("optimizer step")
    ax.set_ylabel("LR")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    return _save(fig, plt, path, 150)
