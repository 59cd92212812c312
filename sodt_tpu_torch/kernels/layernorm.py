"""K13: LayerNorm over the last axis and the fused residual add + LayerNorm.

Counterpart of `sodt_tpu/pallas/layernorm.py`:

  layernorm(x, weight, bias, eps)          -> LN(x)
  add_layernorm(a, b, weight, bias, eps)   -> (a + b, LN(a + b))

Statistics in f32 as var = E[x^2] - mu^2, eps 1e-5 by default, the result
cast back to the input dtype (`_reference_ln`); the add is taken in the
input dtype first and LN sees the rounded sum (`_add_ln_kernel`). On a CUDA
bf16 tensor the forward is the hand-written kernel of csrc/layernorm.cu
(rows packed to their width: `ln_body`) and the backward follows `_ln_grad` / `_add_ln_core_bwd` (analytic, in plain
PyTorch, as the JAX package leaves it to XLA). f32 and CPU tensors take the
plain version, differentiated by autograd.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from . import _build


# ----------------------------------------------------------- plain versions

def layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def add_layernorm_plain(a, b, weight, bias, eps: float = 1e-5):
    s = a + b
    return s, layernorm_plain(s, weight, bias, eps)


def ln_grad_plain(x, weight, g, eps: float = 1e-5):
    """Analytic LN backward in f32 (`_ln_grad`): (dx in x's dtype, dweight,
    dbias in f32), the last two summed over every leading axis."""
    c = x.shape[-1]
    x32, g32 = x.float().reshape(-1, c), g.float().reshape(-1, c)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * rstd
    gs = g32 * weight.float()
    dx = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    return (dx.to(x.dtype).reshape(x.shape), (g32 * xhat).sum(0), g32.sum(0))


# ----------------------------------------------------------------- kernels

def kernel_supported(c: int) -> bool:
    """The domain of csrc/layernorm.cu: rows of whole 16-byte vectors that
    one warp keeps in registers."""
    return c % 8 == 0 and 0 < c <= 1024


# the widths the system runs, 24 * 2^k: lanes a row at three 16-byte
# vectors a lane
PACKED_LANES = {24: 1, 48: 2, 96: 4, 192: 8, 384: 16, 768: 32}


def ln_body(c: int) -> tuple[int, int]:
    """(lanes a row, 16-byte vectors a lane) of csrc/layernorm.cu's row body
    at width c, as `ln_dispatch` there picks it (the kernel's template
    arguments L and V): rows packed to their width at 24 * 2^k (C / 24
    lanes of three vectors: 32 / L rows a warp, no lane idle), a whole warp
    of four vectors a lane at any other width of the domain. The same for
    all four entries (LN, add + LN, K2's LN2 on f32 rows, K4's front)."""
    if not kernel_supported(c):
        raise ValueError(f"layernorm: C={c} (needs a multiple of 8, at most "
                         "1024)")
    if c in PACKED_LANES:
        return PACKED_LANES[c], 3
    return 32, 4


def _check(name: str, c: int, **tensors) -> None:
    if not kernel_supported(c):
        raise ValueError(f"{name}: C={c} (needs a multiple of 8, at most 1024)")
    for k, t in tensors.items():
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{name}: {k} must be a contiguous tensor on "
                             "the card")


def _f32(p: torch.Tensor) -> torch.Tensor:
    return p.detach().float().contiguous()


def _launch_ln(x, weight, bias, eps):
    c = x.shape[-1]
    w, b = _f32(weight), _f32(bias)
    _check("layernorm", c, x=x, weight=w, bias=b)
    y = torch.empty_like(x)
    _build.check(_build.library().sodt_layernorm(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        x.numel() // c, c, eps, _build.stream_ptr()), "layernorm")
    LAUNCHES["layernorm"] += 1
    return y


def _launch_add_ln(a, b, weight, bias, eps):
    c = a.shape[-1]
    w, bb = _f32(weight), _f32(bias)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError("add_layernorm: a and b differ in shape or dtype")
    _check("add_layernorm", c, a=a, b=b, weight=w, bias=bb)
    s, y = torch.empty_like(a), torch.empty_like(a)
    _build.check(_build.library().sodt_add_layernorm(
        a.data_ptr(), b.data_ptr(), w.data_ptr(), bb.data_ptr(), s.data_ptr(),
        y.data_ptr(), a.numel() // c, c, eps, _build.stream_ptr()),
        "add_layernorm")
    LAUNCHES["add_layernorm"] += 1
    return s, y


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _launch_ln(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = ln_grad_plain(x, weight, g, ctx.eps)
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


class _AddLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, weight, bias, eps):
        ctx.eps = eps
        s, y = _launch_add_ln(a, b, weight, bias, eps)
        # the rounded sum is an output already: saving it costs nothing and
        # equals `_add_ln_core_bwd`'s recomputed (a + b) in the input dtype
        ctx.save_for_backward(s, weight)
        return s, y

    @staticmethod
    def backward(ctx, g_sum, g_ln):
        s, weight = ctx.saved_tensors
        dx, dw, db = ln_grad_plain(s, weight, g_ln, ctx.eps)
        dsum = (g_sum.float() + dx.float()).to(s.dtype)
        return dsum, dsum, dw.to(weight.dtype), db.to(weight.dtype), None


def _on_card(x: torch.Tensor) -> bool:
    # JAX gates its kernels to bf16; f32 takes the plain version
    return x.is_cuda and x.dtype == torch.bfloat16


def layernorm(x, weight, bias, eps: float = 1e-5):
    """LN over the last axis. Replaces `sodt_tpu/pallas/layernorm.py`
    `layernorm` (l.149, body `_ln_kernel` l.67). x (..., C) bf16 on the
    card, weight and bias (C,) f32: one kernel launch, or a ValueError
    outside `kernel_supported`."""
    if not _on_card(x):
        return layernorm_plain(x, weight, bias, eps)
    return _LayerNorm.apply(x.contiguous(), weight, bias, eps)


def add_layernorm(a, b, weight, bias, eps: float = 1e-5):
    """(a + b, LN(a + b)). Replaces `sodt_tpu/pallas/layernorm.py`
    `add_layernorm` (l.205, body `_add_ln_kernel` l.72): the sum is written
    once and normalized from registers, which saves one read and one write
    of the residual stream."""
    if not _on_card(a):
        return add_layernorm_plain(a, b, weight, bias, eps)
    return _AddLayerNorm.apply(a.contiguous(), b.contiguous(), weight, bias,
                               eps)
