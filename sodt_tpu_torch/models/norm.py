"""LayerNorm and fused residual-add + LayerNorm (`sodt_tpu/models/norm.py`).

Statistics in f32 as var = E[x^2] - mu^2, eps 1e-5, result cast back to
the input dtype (`sodt_tpu/pallas/layernorm.py` `_reference_ln`). Parameter
names follow torch ("weight", "bias"); the weight bridge maps flax "scale".
Both modules go through `kernels.layernorm`, which launches K13 for a bf16
tensor on the card and takes the plain version elsewhere.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.layernorm import layernorm as layer_norm, add_layernorm


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
        return add_layernorm(a, b, self.weight, self.bias, self.eps)
