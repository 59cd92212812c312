"""uint8 image resize with OpenCV's arithmetic, in numpy: the resize of
`_resize_longest` (`sodt_tpu/data/vedai.py:64-82`), whose cv2 branch the
JAX package takes where cv2 imports (`INTER_AREA` when shrinking,
`INTER_LINEAR` when enlarging). cv2 rounds differently on each of its
paths, and each is reproduced:

  integer factor k, area        the mean of each k x k cell. At k = 2 cv2's
                                vector path rounds half up, (s + 2) >> 2;
                                at other k its scalar path multiplies the
                                sum by the float 1 / k^2 and rounds half to
                                even (8x: rint(s / 64), not (s + 32) >> 6).
  other factors, area           cv2's `resizeArea`: per output pixel, the
                                covered source pixels with float32 weights,
                                summed along x and then along y in cv2's
                                order, in float32, rounded half to even.
  enlarging, linear             cv2's fixed point: 11-bit weights, a
                                horizontal integer pass, a vertical pass
                                through 16-bit products (its vector body)
                                at every byte of the row: cv2 rounds the
                                bytes past the last whole 16 as its vector
                                steps do, not at 22 bits as its scalar loop
                                would (5.0 at 1, 3 and 4 channels, 4.6 at
                                3, tested).

Images are (H, W, C) uint8; the result keeps the channel axis (cv2 drops a
trailing axis of 1, which `_resize_longest` restores).
"""

from __future__ import annotations

import math

import numpy as np

COEF_BITS = 11                     # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS
EPS = float(np.finfo(np.float64).eps)


def _scale(n_in: int, n_out: int) -> float:
    """cv2's source step per output pixel: 1 / (n_out / n_in) in double."""
    return 1.0 / (n_out / n_in)


def _area_integer(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    c = img.shape[2]
    s = np.zeros((img.shape[0] // ky, img.shape[1] // kx, c), np.int32)
    for i in range(ky):
        for j in range(kx):
            s += img[i::ky, j::kx]
    if kx == 2 and ky == 2 and c != 2:
        return ((s + 2) >> 2).astype(np.uint8)
    scale = np.float32(1.0) / np.float32(kx * ky)
    return np.clip(np.rint(s.astype(np.float32) * scale), 0, 255).astype(
        np.uint8)


def _area_tab(n_in: int, n_out: int, scale: float):
    """cv2's `computeResizeAreaTab`: (dst index, src index, float32
    weight) of every tap, in cv2's order."""
    tab = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - f1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, np.float32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(f2 - s2, 1.0), cell)
                                          / cell)))
    return tab


def _taps(tab, n_out: int):
    """The tab as (n_out, K) src indices and float32 weights, each output's
    taps in order, padded with weight 0 (adding 0 * x leaves a float
    sum as it is)."""
    k = max(sum(1 for t in tab if t[0] == d) for d in range(n_out))
    idx = np.zeros((n_out, k), np.int64)
    wt = np.zeros((n_out, k), np.float32)
    fill = np.zeros(n_out, np.int64)
    for d, s, a in tab:
        idx[d, fill[d]] = s
        wt[d, fill[d]] = a
        fill[d] += 1
    return idx, wt


def _area_general(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """cv2's `ResizeArea_Invoker` for uint8 (float32 sums)."""
    h, w, c = img.shape
    xi, xw = _taps(_area_tab(w, ow, _scale(w, ow)), ow)
    ytab = _area_tab(h, oh, _scale(h, oh))
    src = img.astype(np.float32)
    out = np.empty((oh, ow, c), np.uint8)
    acc, prev = None, ytab[0][0]
    for dy, sy, beta in ytab:
        buf = np.zeros((ow, c), np.float32)
        row = src[sy]
        for k in range(xi.shape[1]):
            buf = buf + row[xi[:, k]] * xw[:, k, None]
        term = beta * buf
        if dy != prev:
            out[prev] = np.clip(np.rint(acc), 0, 255)
            acc, prev = term, dy
        else:
            acc = term if acc is None else acc + term
    out[prev] = np.clip(np.rint(acc), 0, 255)
    return out


def _linear_coeffs(n_in: int, n_out: int, clamp: bool):
    """cv2's two source indices and 11-bit weights per output position.
    Along x (`clamp`) a tap left of the first or right of the last source
    pixel takes weight 0 at the edge pixel; along y cv2 keeps the weights
    and clamps only the rows it reads."""
    scale = _scale(n_in, n_out)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        lo = s < 0
        f[lo], s[lo] = 0, 0
        hi = s >= n_in - 1
        f[hi], s[hi] = 0, n_in - 1
    a1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int32)
    a0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(
        np.int32)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), a0, a1)


def _linear(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """cv2's `INTER_LINEAR` for uint8: horizontal pass in int32, vertical
    pass as cv2's vector steps ((S >> 4) * b >> 16, summed, + 2 >> 2) over
    the whole row."""
    h, w, c = img.shape
    x0, x1, a0, a1 = _linear_coeffs(w, ow, clamp=True)
    y0, y1, b0, b1 = _linear_coeffs(h, oh, clamp=False)
    src = img.astype(np.int32)
    hor = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    hor = hor.reshape(h, ow * c)
    s0, s1 = hor[y0], hor[y1]
    bb0, bb1 = b0[:, None], b1[:, None]
    v = (((s0 >> 4) * bb0) >> 16) + (((s1 >> 4) * bb1) >> 16)
    v = (v + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape(oh, ow, c)


def resize_longest(img: np.ndarray, size: int) -> np.ndarray:
    """Resize (H, W, C) uint8 so that the longest side is `size`, as JAX's
    `_resize_longest` does through cv2: sides int(side * r), INTER_AREA
    when shrinking, INTER_LINEAR when enlarging, the image itself when
    r == 1; the channel axis kept."""
    h, w = img.shape[:2]
    r = size / max(h, w)
    if r == 1.0:
        return img
    ow, oh = int(w * r), int(h * r)
    if r > 1:
        return _linear(img, ow, oh)
    sx, sy = _scale(w, ow), _scale(h, oh)
    kx, ky = round(sx), round(sy)
    if abs(sx - kx) < EPS and abs(sy - ky) < EPS:
        return _area_integer(img, kx, ky)
    return _area_general(img, ow, oh)
