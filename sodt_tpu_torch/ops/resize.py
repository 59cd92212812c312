"""`jax.image.resize(..., "bilinear")` on NHWC tensors: the one resize of
the port that the JAX package's `jax.image.resize` calls become (the
pos-embed resample off the config size, the multi-scale buckets and the
letterbox, the SR decoder, the SR regime's downsampled model input).

JAX builds, per resized axis, an (in, out) matrix of triangle weights
(`jax._src.image.scale.compute_weight_mat`): the kernel widens by in / out
when the axis shrinks (antialiasing), each output column is normalized,
and a sample outside the input gets no weight. The resize is a product
with that matrix along each axis that changes; an axis of unchanged size
is left as it is. Everything in f32 (TF32 must be off on the card).
"""

from __future__ import annotations

import numpy as np
import torch


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) f32 weights of one axis, as JAX computes them: the
    scale out / in and its inverse in double, the samples in f32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = ((torch.arange(n_out, dtype=f32) + 0.5)
              * torch.tensor(inv_scale, dtype=f32) - 0.5)
    x = ((sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
         / torch.tensor(kernel_scale, dtype=f32))
    w = (1 - x).clamp(min=0)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.to(device)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C) for `size` (h, w), or an int for a
    square, in x's dtype (f32 for the pixel feeds and the pos embed; the
    SR decoder passes its compute dtype, as JAX casts the weights to the
    image's)."""
    h, w = (size, size) if isinstance(size, int) else size
    if x.shape[1] != h:
        x = torch.einsum("oh,bhwc->bowc",
                         resize_weights(x.shape[1], h, x.device).to(x.dtype),
                         x)
    if x.shape[2] != w:
        x = torch.einsum("pw,bhwc->bhpc",
                         resize_weights(x.shape[2], w, x.device).to(x.dtype),
                         x)
    return x
