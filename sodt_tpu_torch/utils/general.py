"""Label statistics for --image-weights (`sodt_tpu/utils/general.py`, the
two functions this flag needs)."""

from __future__ import annotations

import numpy as np


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
