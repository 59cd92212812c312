"""PyTorch/CUDA port of `sodt_tpu` for one NVIDIA H100.

The JAX package `sodt_tpu` stays the reference; this package mirrors its
layout (`ops/`, `models/`, `kernels/` for `pallas/`, `train/`, `data/`,
`utils/`) and never imports JAX or anything of `sodt_tpu`. Activations
keep the JAX package's NHWC layout at every public function. Entry points
run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. "cuda" is the default and raises
    when no card is visible: the port never continues on the CPU unless
    the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sodt_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev
