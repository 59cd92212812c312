"""GELU with the JAX package's dtype rule (`sodt_tpu/ops/activations.py`):
exact erf in float32, tanh approximation below float32. The hand-written
kernels always use the tanh form; they run in bfloat16 only."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in f32, tanh-approximate in lower precision."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return F.gelu(x, approximate="tanh")
