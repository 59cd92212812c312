"""Letterbox geometry and resize (`sodt_tpu/ops/letterbox.py`).

`letterbox_params` is JAX's. `letterbox_image` resizes on the device with
`ops.resize.resize_bilinear` (JAX's `jax.image.resize` "linear"), and
`letterbox_image_np` on the host in uint8 with PIL's BILINEAR resample
reproduced (`pil_resize_bilinear`): the card's machine has no PIL.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .resize import resize_bilinear

PRECISION_BITS = 32 - 8 - 2        # PIL's fixed point for 8-bit images


def letterbox_params(shape_hw, new_shape_hw, *, auto: bool = False,
                     scale_fill: bool = False, scaleup: bool = True,
                     stride: int = 32):
    """(ratio, new_unpad (w, h), (dw, dh)) for letterboxing `shape_hw` into
    `new_shape_hw`; dw / dh are the total padding halved."""
    h0, w0 = shape_hw
    if isinstance(new_shape_hw, int):
        new_shape_hw = (new_shape_hw, new_shape_hw)
    nh, nw = new_shape_hw

    r = min(nh / h0, nw / w0)
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(w0 * r)), int(round(h0 * r)))  # (w, h)
    dw, dh = nw - new_unpad[0], nh - new_unpad[1]
    if auto:  # minimum rectangle: pad only to a stride multiple
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0.0, 0.0
        new_unpad = (nw, nh)
        ratio = (nw / w0, nh / h0)
    dw /= 2
    dh /= 2
    return ratio, new_unpad, (dw, dh)


def _geometry(shape_hw, new_shape_hw, scaleup: bool):
    """(resized h, w) and the (top, bottom, left, right) pads."""
    (_, _), (uw, uh), (dw, dh) = letterbox_params(shape_hw, new_shape_hw,
                                                  scaleup=scaleup)
    pads = (int(round(dh - 0.1)), int(round(dh + 0.1)),
            int(round(dw - 0.1)), int(round(dw + 0.1)))
    return (uh, uw), pads


def letterbox_image(img: torch.Tensor, new_shape_hw, *, scaleup: bool = True,
                    pad_value: float = 114.0) -> torch.Tensor:
    """Letterbox an HWC image to exactly `new_shape_hw` (f32 out), on the
    image's device."""
    h0, w0, c = img.shape
    if isinstance(new_shape_hw, int):
        new_shape_hw = (new_shape_hw, new_shape_hw)
    (uh, uw), (top, bottom, left, right) = _geometry((h0, w0), new_shape_hw,
                                                     scaleup)
    out = img.float()
    if (uh, uw) != (h0, w0):
        out = resize_bilinear(out[None], (uh, uw))[0]
    out = torch.nn.functional.pad(out.permute(2, 0, 1),
                                  (left, right, top, bottom),
                                  value=pad_value).permute(1, 2, 0)
    assert out.shape == (*new_shape_hw, c), (out.shape, new_shape_hw)
    return out


def _pil_coeffs(n_in: int, n_out: int):
    """PIL's `precompute_coeffs` + `normalize_coeffs_8bpc` for the
    bilinear filter (support 1, widened by the scale when shrinking):
    (n_out, K) source indices and fixed-point weights."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 1.0 * fscale
    ss = 1.0 / fscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((n_out, ksize), np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        k = np.zeros(xmax)
        for x in range(xmax):
            v = abs((x + xmin - center + 0.5) * ss)
            k[x] = 1.0 - v if v < 1.0 else 0.0
        ww = k.sum()
        if ww != 0.0:
            k = k / ww
        fixed = np.where(k < 0, np.trunc(-0.5 + k * (1 << PRECISION_BITS)),
                         np.trunc(0.5 + k * (1 << PRECISION_BITS)))
        idx[xx, :xmax] = xmin + np.arange(xmax)
        kk[xx, :xmax] = fixed
    return idx, kk


def _pil_pass(img: np.ndarray, axis: int, n_out: int) -> np.ndarray:
    idx, kk = _pil_coeffs(img.shape[axis], n_out)
    src = np.moveaxis(img, axis, 0).astype(np.int64)       # (n_in, ..., C)
    acc = np.full((n_out,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for k in range(idx.shape[1]):
        acc += src[idx[:, k]] * kk[:, k].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_resize_bilinear(img: np.ndarray, size_hw) -> np.ndarray:
    """PIL's `Image.resize((w, h), Image.BILINEAR)` of uint8 (H, W, C):
    the horizontal pass, then the vertical, each in PIL's fixed point."""
    oh, ow = size_hw
    out = np.asarray(img, np.uint8)
    if out.shape[1] != ow:
        out = _pil_pass(out, 1, ow)
    if out.shape[0] != oh:
        out = _pil_pass(out, 0, oh)
    return out


def letterbox_image_np(img, new_shape_hw, *, scaleup: bool = True,
                       pad_value: int = 114):
    """Host-side uint8 letterbox with `letterbox_image`'s geometry, the
    resize PIL's BILINEAR (as JAX's)."""
    h0, w0 = img.shape[:2]
    if isinstance(new_shape_hw, int):
        new_shape_hw = (new_shape_hw, new_shape_hw)
    (uh, uw), (top, bottom, left, right) = _geometry((h0, w0), new_shape_hw,
                                                     scaleup)
    resized = np.asarray(img)
    if (uh, uw) != (h0, w0):
        resized = pil_resize_bilinear(np.asarray(img, np.uint8), (uh, uw))
    out = np.pad(resized, ((top, bottom), (left, right), (0, 0)),
                 constant_values=pad_value)
    assert out.shape[:2] == tuple(new_shape_hw)
    return out.astype(np.uint8)
