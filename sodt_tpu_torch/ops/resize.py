"""`jax.image.resize` on NHWC tensors: the one resize of the port that the
JAX package's `jax.image.resize` calls become (bilinear: the pos-embed
resample off the config size, the multi-scale buckets and the letterbox,
the SR decoder, the SR regime's downsampled model input; any method:
`Upsample` layers other than nearest).

JAX builds, per resized axis, an (in, out) matrix of kernel weights
(`jax._src.image.scale.compute_weight_mat`): the kernel widens by in / out
when the axis shrinks (antialiasing), each output column is normalized,
and a sample outside the input gets no weight. The kernels are JAX's:
the triangle (linear), Keys' cubic with a = -0.5 (torch's bicubic uses
-0.75 and clamps at the edges, so `F.interpolate` is not JAX's) and
Lanczos of radius 3 and 5, evaluated in f32 in JAX's order of operations.
The resize is a product with that matrix along each axis that changes; an
axis of unchanged size is left as it is. Everything in f32 (TF32 must be
off on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _triangle(x):
    return (1 - x).clamp(min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float):
    def kernel(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        den = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


# jax.image.ResizeMethod.from_string's names (nearest is Upsample's repeat)
KERNELS = {**dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"),
                           _triangle),
           **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
           "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def check_method(method: str) -> None:
    """JAX's refusal of a method it does not know."""
    if method != "nearest" and method not in KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')


def resize_weights(n_in: int, n_out: int, device=None,
                   method: str = "linear") -> torch.Tensor:
    """(n_out, n_in) f32 weights of one axis, as JAX computes them: the
    scale out / in and its inverse in double, the samples in f32."""
    check_method(method)
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = ((torch.arange(n_out, dtype=f32) + 0.5)
              * torch.tensor(inv_scale, dtype=f32) - 0.5)
    x = ((sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
         / torch.tensor(kernel_scale, dtype=f32))
    w = KERNELS[method](x)
    tot = w.sum(0, keepdim=True)
    w = torch.where(tot.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.to(
        device, non_blocking=True)


def resize(x: torch.Tensor, size, method: str = "linear") -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C) for `size` (h, w), or an int for a
    square, in x's dtype (f32 for the pixel feeds and the pos embed; the
    SR decoder and Upsample pass their compute dtype, as JAX casts the
    weights to the image's)."""
    h, w = (size, size) if isinstance(size, int) else size
    if x.shape[1] != h:
        x = torch.einsum("oh,bhwc->bowc", resize_weights(
            x.shape[1], h, x.device, method).to(x.dtype), x)
    if x.shape[2] != w:
        x = torch.einsum("pw,bhwc->bhpc", resize_weights(
            x.shape[2], w, x.device, method).to(x.dtype), x)
    return x


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """`resize` with JAX's "bilinear" (the triangle kernel)."""
    return resize(x, size, "linear")
