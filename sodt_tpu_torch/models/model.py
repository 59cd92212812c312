"""DetectionModel: the assembled detector (`sodt_tpu/models/model.py`).

Input-mode routing, the split-mode graph walk with `from`-index gathers,
and Detect. Parameters stay f32; `dtype` is the compute dtype every layer
casts its input and weights to, as the flax modules' `dtype` does.
Submodule names mirror the flax tree (`l0` = the encoder, `l3`.. = head
layers, `detect`), so the weight bridge is a name map.

The JAX package's `train` argument is the module's mode here:
`model.train()` makes every BatchNorm use and update batch statistics,
`model.eval()` the running ones. Either way the forward returns the raw
Detect maps; decoding belongs to the eval step.
"""

from __future__ import annotations

import torch
from torch import nn

from .compiler import ModelSpec, build_module
from .detect import Detect

INPUT_MODES = ("RGB", "IR", "RGB+IR", "RGB+IR+fusion", "RGB+IR+MF")


class DetectionModel(nn.Module):
    def __init__(self, spec: ModelSpec, input_mode: str = "RGB+IR",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if input_mode not in INPUT_MODES:
            raise ValueError(f"unknown input_mode {input_mode!r}")
        if input_mode in ("RGB+IR+fusion", "RGB+IR+MF"):
            raise NotImplementedError(
                f"input_mode {input_mode!r}: ROADMAP.md Queue 1 item 10")
        self.spec, self.input_mode, self.dtype = spec, input_mode, dtype
        self.head_defs = [ld for ld in spec.head if ld.name != "Detect"]
        setattr(self, "l0", build_module(spec.backbone[0]))
        for ld in self.head_defs:
            setattr(self, f"l{ld.i}", build_module(ld))
        self.detect = Detect(spec.nc, spec.anchors, spec.detect_strides,
                             spec.detect_ch)

    @property
    def anchors_per_level(self):
        import numpy as np
        a = np.asarray(self.spec.anchors, dtype=np.float32)
        return a.reshape(len(self.spec.anchors), -1, 2)

    @property
    def strides(self):
        return self.spec.detect_strides

    def _route(self, x, ir):
        mode = self.input_mode
        if mode == "RGB":
            return x
        if mode == "IR":
            return ir if ir is not None else x
        return torch.cat([x, ir[..., 0:1]], dim=-1)            # RGB+IR

    def forward(self, x, ir=None):
        """x, ir: NHWC float inputs in [0, 1] (RGB 3ch, IR 3ch). Returns
        {"raw": [(B, ny, nx, na, no), ...]} in the compute dtype."""
        steam = self._route(x, ir).to(self.dtype)
        y: dict[int, torch.Tensor] = {}
        feats = self.l0(steam)
        for j, fmap in enumerate(feats):
            y[j] = fmap
        x_cur = feats[-1]
        save = set(self.spec.save) | set(self.spec.detect_from)
        for ld in self.head_defs:
            if ld.f != (ld.i - 1,):
                inputs = [x_cur if j == -1 or j == ld.i - 1 else y[j]
                          for j in ld.f]
                x_in = inputs if len(inputs) > 1 else inputs[0]
            else:
                x_in = x_cur
            x_cur = getattr(self, f"l{ld.i}")(x_in)
            if ld.i in save:
                y[ld.i] = x_cur
        det_in = [y[j] if j in y else x_cur for j in self.spec.detect_from]
        return {"raw": self.detect(det_in)}
