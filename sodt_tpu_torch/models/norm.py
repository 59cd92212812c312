"""LayerNorm and fused residual-add + LayerNorm (`sodt_tpu/models/norm.py`).

Statistics in f32 as var = E[x^2] - mu^2, eps 1e-5, result cast back to
the input dtype (`sodt_tpu/pallas/layernorm.py` `_reference_ln`). Parameter
names follow torch ("weight", "bias"); the weight bridge maps flax "scale".
"""

from __future__ import annotations

import torch
from torch import nn


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class AddLayerNorm(LayerNorm):
    """Residual + LN: (a, b) -> (a + b, LN(a + b))."""

    def forward(self, a, b):
        s = a + b
        return s, layer_norm(s, self.weight, self.bias, self.eps)
