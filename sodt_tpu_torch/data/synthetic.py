"""Synthetic VEDAI-like dataset: deterministic aerial-style scenes.

A copy of `sodt_tpu/data/synthetic.py` (numpy only), with `pad_labels`.

No VEDAI data ships with the repository, so tests and the chip smoke run
use a generator with the same *interface* as VedaiDataset:
paired RGB/IR uint8 images plus (n, 5) normalized [cls, cx, cy, w, h]
labels. Objects are small bright rectangles (VEDAI-scale: ~2-8% of image
side) on a textured background; the IR channel sees the same objects with a
different response so multimodal fusion has signal to learn.
"""

from __future__ import annotations

import numpy as np


class SyntheticVedai:
    def __init__(self, n: int = 64, img_size: int = 512, nc: int = 8,
                 max_objects: int = 6, seed: int = 0):
        self.n = n
        self.img_size = img_size
        self.nc = nc
        self.max_objects = max_objects
        self.seed = seed
        self.labels = [self._labels_for(i) for i in range(n)]

    def __len__(self):
        return self.n

    def _rng(self, i: int):
        return np.random.default_rng(self.seed * 100003 + i)

    def _labels_for(self, i: int) -> np.ndarray:
        rng = self._rng(i)
        k = int(rng.integers(1, self.max_objects + 1))
        cls = rng.integers(0, self.nc, k)
        wh = rng.uniform(0.02, 0.08, (k, 2))
        cxy = rng.uniform(0.1, 0.9, (k, 2))
        return np.concatenate([cls[:, None].astype(np.float32),
                               cxy.astype(np.float32),
                               wh.astype(np.float32)], axis=1)

    def __getitem__(self, i: int):
        rng = self._rng(i)
        s = self.img_size
        base = rng.integers(40, 120, (s // 16, s // 16, 3), np.uint8)
        rgb = np.kron(base, np.ones((16, 16, 1), np.uint8))
        ir = (0.4 * rgb.mean(-1, keepdims=True)
              + rng.integers(0, 30, (s, s, 1))).astype(np.uint8)
        labels = self.labels[i]
        for cls, cx, cy, w, h in labels:
            x1 = int((cx - w / 2) * s)
            y1 = int((cy - h / 2) * s)
            x2 = max(x1 + 2, int((cx + w / 2) * s))
            y2 = max(y1 + 2, int((cy + h / 2) * s))
            color = np.array([(int(cls) * 37 + 120) % 256,
                              (int(cls) * 83 + 160) % 256,
                              (int(cls) * 53 + 200) % 256], np.uint8)
            rgb[y1:y2, x1:x2] = color
            ir[y1:y2, x1:x2] = min(150 + int(cls) * 12, 255)
        return rgb, np.repeat(ir, 3, axis=-1), labels.copy()


def pad_labels(labels: np.ndarray, m: int):
    """(n, 5) -> ((m, 5), (m,) mask), truncating beyond capacity."""
    out = np.zeros((m, 5), np.float32)
    mask = np.zeros((m,), bool)
    n = min(len(labels), m)
    if n:
        out[:n] = labels[:n]
        mask[:n] = True
    return out, mask
