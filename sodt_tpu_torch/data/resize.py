"""Image resize with OpenCV's arithmetic, in numpy: the resize of
`_resize_longest` (`sodt_tpu/data/vedai.py:64-82`), whose cv2 branch the
JAX package takes where cv2 imports (`INTER_AREA` when shrinking,
`INTER_LINEAR` when enlarging), for every dtype `_read_image` returns.
cv2 rounds differently on each of its paths, and each is reproduced (cv2
5.0 with its IPP, probed dtype by dtype):

  integer factor k, area        the mean of each k x k cell. At k = 2 and
                                1, 3 or 4 channels cv2's vector path:
                                uint8, uint16, int16 (s + 2) >> 2 (a floor
                                for int16), float32 ((a + b) + (c + d)) *
                                0.25; at other k and channels its scalar
                                path sums the cell row by row (four taps at
                                a time), in float (double for float64), and
                                multiplies by the float 1 / k^2, rounding
                                half to even to an integer dtype (8x: rint(s
                                / 64), not (s + 32) >> 6).
  other factors, area           cv2's `resizeArea`: per output pixel, the
                                covered source pixels with float32 weights,
                                summed along x and then along y in cv2's
                                order, in float32 (float64 for float64),
                                rounded half to even to an integer dtype.
  enlarging, linear, uint8      cv2's fixed point: 11-bit weights, a
                                horizontal integer pass, a vertical pass
                                through 16-bit products (its vector body)
                                at every byte of the row: cv2 rounds the
                                bytes past the last whole 16 as its vector
                                steps do, not at 22 bits as its scalar loop
                                would (5.0 at 1, 3 and 4 channels, 4.6 at
                                3, tested).
  enlarging, linear, uint16,    IPP's linear resize, which cv2 takes for
  int16, float32                these where both sides are 2 px or more: a
                                horizontal pass, then a vertical one, each
                                fma(t, p1 - p0, p0) in float32 with t the
                                double fraction rounded to float32, the
                                borders replicated; the float32 result
                                rounded half to even and saturated. int16's
                                border rows and columns (where one axis is
                                replicated) are p0 + rint(t (p1 - p0)).
  enlarging, float64; float32   raise NotImplementedError: IPP's rounding
    of 3-4 channels; a side of    there (float64; float32's border columns)
    1 px or 2 channels            was not found bit for bit, and cv2 keeps
                                  its own float path for the others, which
                                  no reader's image reaches.

Images are (H, W, C); the result keeps the channel axis (cv2 drops a
trailing axis of 1, which `_resize_longest` restores) and the dtype. The
dtypes cv2 refuses (int8, int32, uint32, 64-bit integers, float16) raise
TypeError where a resize is needed, as cv2.resize raises. A bool image
(PIL's 1-bit reads) is resized as uint8 0 / 1, which cv2 refuses.
"""

from __future__ import annotations

import math

import numpy as np

COEF_BITS = 11                     # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS
EPS = float(np.finfo(np.float64).eps)
RESIZABLE = (np.uint8, np.uint16, np.int16, np.float32, np.float64)


def _scale(n_in: int, n_out: int) -> float:
    """cv2's source step per output pixel: 1 / (n_out / n_in) in double."""
    return 1.0 / (n_out / n_in)


def _work(dtype) -> type:
    """cv2's accumulator type of the area paths: float, double for
    float64."""
    return np.float64 if dtype == np.float64 else np.float32


def _store(v: np.ndarray, dtype) -> np.ndarray:
    """cv2's saturate_cast of float sums to the image's dtype: round half to
    even, clamp (integer dtypes); as they are (float)."""
    if np.dtype(dtype).kind == "f":
        return v.astype(dtype)
    info = np.iinfo(dtype)
    return np.clip(np.rint(v), info.min, info.max).astype(dtype)


def _area_integer(img: np.ndarray, kx: int, ky: int) -> np.ndarray:
    h, w, c = img.shape
    oh, ow = h // ky, w // kx
    cells = [img[i::ky, j::kx][:oh, :ow] for i in range(ky) for j in range(kx)]
    vector = kx == 2 and ky == 2 and c in (1, 3, 4)
    if img.dtype.kind in "ui":
        s = np.zeros((oh, ow, c), np.int64)
        for x in cells:
            s += x
        if vector:
            return (s + 2 >> 2).astype(img.dtype)
        scale = np.float32(1.0) / np.float32(kx * ky)
        return _store(s.astype(np.float32) * scale, img.dtype)
    wt = _work(img.dtype)
    cells = [x.astype(wt) for x in cells]
    if vector and img.dtype == np.float32 and c != 3:
        return ((cells[0] + cells[1]) + (cells[2] + cells[3])) * wt(0.25)
    s = np.zeros((oh, ow, c), wt)
    for k in range(0, len(cells) - 3, 4):          # cv2's unrolled loop
        s = s + (((cells[k] + cells[k + 1]) + cells[k + 2]) + cells[k + 3])
    for k in range(len(cells) // 4 * 4, len(cells)):
        s = s + cells[k]
    scale = np.float32(1.0) / np.float32(kx * ky)
    return (s * wt(scale)).astype(img.dtype)


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
    taps in order, and the mask of real taps (the padding is skipped, so a
    NaN or inf pixel reaches only the outputs cv2 sums it into)."""
    k = max(sum(1 for t in tab if t[0] == d) for d in range(n_out))
    idx = np.zeros((n_out, k), np.int64)
    wt = np.zeros((n_out, k), np.float32)
    real = np.zeros((n_out, k), bool)
    fill = np.zeros(n_out, np.int64)
    for d, s, a in tab:
        idx[d, fill[d]] = s
        wt[d, fill[d]] = a
        real[d, fill[d]] = True
        fill[d] += 1
    return idx, wt, real


def _area_general(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """cv2's `ResizeArea_Invoker` (float sums, double for float64)."""
    h, w, c = img.shape
    wt = _work(img.dtype)
    xi, xw, real = _taps(_area_tab(w, ow, _scale(w, ow)), ow)
    ytab = _area_tab(h, oh, _scale(h, oh))
    src = img.astype(wt)
    out = np.empty((oh, ow, c), img.dtype)
    acc, prev = None, ytab[0][0]
    for dy, sy, beta in ytab:
        buf = np.zeros((ow, c), wt)
        row = src[sy]
        for k in range(xi.shape[1]):
            tap = row[xi[:, k]] * xw[:, k, None].astype(wt)
            buf = np.where(real[:, k, None], buf + tap, buf)
        term = wt(beta) * buf
        if dy != prev:
            out[prev] = _store(acc, img.dtype)
            acc, prev = term, dy
        else:
            acc = term if acc is None else acc + term
    out[prev] = _store(acc, img.dtype)
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


def fma32(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32, of float32 operands: the product
    is exact in double, the sum's rounding error is recovered (TwoSum),
    and a double sum that lands on a float32 tie is moved toward the exact
    value before it is rounded."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64)
               for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    diff = s - r.astype(np.float64)
    away = np.nextafter(r, np.where(diff > 0, np.float32(np.inf),
                                    np.float32(-np.inf)).astype(np.float32))
    tie = (diff != 0) & (2 * diff == away.astype(np.float64)
                         - r.astype(np.float64))
    return np.where(tie & (err != 0) & (np.sign(err) == np.sign(diff)),
                    away, r).astype(np.float32)


def _ipp_axis(n_in: int, n_out: int):
    """IPP's taps along one axis: the source pair, the float32 fraction
    (the double one rounded), and the border outputs, whose pair is one
    replicated pixel."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f).astype(np.int64)
    t = (f - s).astype(np.float32)
    border = (s < 0) | (s >= n_in - 1)
    s = np.clip(s, 0, n_in - 1)
    t[border] = 0
    return s, np.where(border, s, s + 1), t, border


def _lerp(p0, p1, t, exact_int: bool):
    if exact_int:                   # p0 + rint(t (p1 - p0)), int16 borders
        return p0 + np.rint(t * (p1 - p0))
    return fma32(t, (p1 - p0).astype(np.float32), p0)


def _linear_ipp(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """IPP's linear resize (module doc)."""
    h, w, c = img.shape
    x0, x1, tx, bx = _ipp_axis(w, ow)
    y0, y1, ty, by = _ipp_axis(h, oh)
    src = img.astype(np.float32)
    tx, ty = tx[None, :, None], ty[:, None, None]
    hor = _lerp(src[:, x0], src[:, x1], tx, False)
    hor[:, bx] = src[:, x0[bx]]              # replicated: copies, not sums
    out = _lerp(hor[y0], hor[y1], ty, False)
    out[by] = hor[y0[by]]
    if img.dtype == np.int16:
        rows = _lerp(src[y0][by][:, x0], src[y0][by][:, x1], tx, True)
        cols = _lerp(src[y0][:, x0[bx]], src[y1][:, x0[bx]], ty, True)
        out[by] = rows
        out[:, bx] = cols
    return _store(out, img.dtype)


def resize_longest(img: np.ndarray, size: int) -> np.ndarray:
    """Resize (H, W, C) so that the longest side is `size`, as JAX's
    `_resize_longest` does through cv2: sides int(side * r), INTER_AREA
    when shrinking, INTER_LINEAR when enlarging, the image itself when
    r == 1; the channel axis and the dtype kept (module doc)."""
    h, w = img.shape[:2]
    r = size / max(h, w)
    if r == 1.0:
        return img
    if img.dtype == bool:
        img = img.astype(np.uint8)
    if img.dtype.type not in RESIZABLE:
        raise TypeError(f"cv2.resize takes uint8, uint16, int16, float32 and "
                        f"float64 images, not {img.dtype}")
    ow, oh = int(w * r), int(h * r)
    if r > 1:
        if img.dtype == np.uint8:
            return _linear(img, ow, oh)
        if img.dtype == np.float64:
            raise NotImplementedError(
                "enlarging a float64 image: cv2 takes IPP's double linear "
                "resize there, whose rounding the port does not reproduce")
        c = img.shape[2]
        if h < 2 or w < 2 or c == 2:
            raise NotImplementedError(
                f"enlarging a {img.dtype} image of {h} x {w} x {c}: cv2 "
                "keeps its own float path there, not IPP's")
        if img.dtype == np.float32 and c > 1:
            raise NotImplementedError(
                f"enlarging a float32 image of {c} channels: IPP's border "
                "columns there round some channels with an fma and some "
                "without, which the port does not reproduce")
        return _linear_ipp(img, ow, oh)
    sx, sy = _scale(w, ow), _scale(h, oh)
    kx, ky = round(sx), round(sy)
    if abs(sx - kx) < EPS and abs(sy - ky) < EPS:
        return _area_integer(img, kx, ky)
    return _area_general(img, ow, oh)

