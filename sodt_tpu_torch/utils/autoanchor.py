"""AutoAnchor: the best-possible-recall gate, whitened k-means and the
genetic refinement (`sodt_tpu/utils/autoanchor.py`, a numpy copy).

The anchor / label wh-ratio metric, the gate at BPR 0.98, Lloyd's k-means
with restarts on sigma-whitened label sizes, then 1000 generations of
clipped gaussian mutation maximizing the thresholded mean best ratio. The
`np.random.default_rng(seed)` draws come in JAX's order, so the anchors
are bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np


def anchor_metric(wh: np.ndarray, k: np.ndarray, thr: float = 4.0):
    """(bpr, aat): best-possible recall and anchors-above-threshold.

    wh: (N, 2) label sizes in pixels; k: (na, 2) anchors.
    """
    r = wh[:, None] / k[None]
    x = np.minimum(r, 1.0 / r).min(2)
    best = x.max(1)
    aat = (x > 1.0 / thr).sum(1).mean()
    bpr = (best > 1.0 / thr).mean()
    return bpr, aat


def _kmeans(points: np.ndarray, n: int, iters: int = 30, seed: int = 0,
            restarts: int = 10):
    """Lloyd's k-means with restarts, best distortion wins (replaces
    scipy.cluster.vq.kmeans, whose `iter` argument is a restart count)."""
    rng = np.random.default_rng(seed)
    best, best_d = None, np.inf
    for _ in range(restarts):
        centers = points[rng.choice(len(points), n, replace=False)].copy()
        for _ in range(iters):
            d = ((points[:, None] - centers[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for j in range(n):
                sel = points[assign == j]
                if len(sel):
                    centers[j] = sel.mean(0)
                else:  # re-seed empty cluster
                    centers[j] = points[rng.integers(len(points))]
        d = ((points[:, None] - centers[None]) ** 2).sum(-1)
        distortion = np.sqrt(d.min(1)).mean()
        if distortion < best_d:
            best, best_d = centers, distortion
    return best


def label_wh(labels: list[np.ndarray], shapes: np.ndarray,
             img_size: int) -> np.ndarray:
    """Collect label wh in pixels at training scale (autoanchor.py:112-114)."""
    s = img_size * shapes / shapes.max(1, keepdims=True)
    whs = [l[:, 3:5] * si for si, l in zip(s, labels) if len(l)]
    return np.concatenate(whs, 0) if whs else np.zeros((0, 2))


def kmean_anchors(labels: list[np.ndarray], shapes: np.ndarray, *,
                  n: int = 9, img_size: int = 640, thr: float = 4.0,
                  gen: int = 1000, seed: int = 0,
                  verbose: bool = False) -> np.ndarray:
    """K-means + GA anchor fit (autoanchor.py:63-158). Returns (n, 2)."""
    thr_i = 1.0 / thr
    wh0 = label_wh(labels, shapes, img_size)
    wh = wh0[(wh0 >= 2.0).any(1)]
    if len(wh) < n:
        raise ValueError(f"not enough labels ({len(wh)}) for {n} anchors")

    def fitness(k):
        r = wh[:, None] / k[None]
        x = np.minimum(r, 1.0 / r).min(2)
        best = x.max(1)
        return (best * (best > thr_i)).mean()

    s = wh.std(0)
    k = _kmeans(wh / s, n, iters=30, seed=seed) * s

    rng = np.random.default_rng(seed)
    f, sh, mp, sigma = fitness(k), k.shape, 0.9, 0.1
    for _ in range(gen):
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random(sh) < mp) * rng.random()
                 * rng.standard_normal(sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k.copy() * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()
            if verbose:
                print(f"autoanchor GA fitness {f:.4f}")
    return k[np.argsort(k.prod(1))]


def check_anchors(labels: list[np.ndarray], shapes: np.ndarray,
                  anchors_px: np.ndarray, *, img_size: int = 640,
                  thr: float = 4.0, seed: int = 0):
    """BPR gate (autoanchor.py:24-60): return (anchors, changed, bpr).

    anchors_px: (nl, na, 2) pixel anchors. A 0.9-1.1 random scale jitter is
    applied to shapes like the reference.
    """
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.9, 1.1, size=(shapes.shape[0], 1))
    wh = label_wh(labels, shapes * scale, img_size)
    flat = anchors_px.reshape(-1, 2)
    bpr, aat = anchor_metric(wh, flat, thr)
    if bpr >= 0.98:
        return anchors_px, False, float(bpr)
    new = kmean_anchors(labels, shapes, n=flat.shape[0], img_size=img_size,
                        thr=thr, seed=seed)
    new_bpr, _ = anchor_metric(wh, new, thr)
    if new_bpr > bpr:
        out = new.reshape(anchors_px.shape)
        # keep area ascending with stride ascending (check_anchor_order)
        areas = out.prod(-1).mean(-1)
        if len(areas) > 1 and areas[0] > areas[-1]:
            out = out[::-1]
        return out, True, float(new_bpr)
    return anchors_px, False, float(bpr)
