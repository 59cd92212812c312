"""DetectionModel: the assembled detector (`sodt_tpu/models/model.py`).

Input-mode routing (RGB, IR, RGB+IR, the learned stems of RGB+IR+fusion,
the [rgb, ir] pair of RGB+IR+MF), the graph walk with `from`-index
gathers in both compiler modes (split: the encoder's [P3, P4, P5], then
the head; unified: every layer, the routed input first), Detect, and the
optional super-resolution branch on the taps y[l1], y[l2]. Parameters
stay f32; `dtype` is the compute dtype every layer casts its input and
weights to, as the flax modules' `dtype` does. Submodule names mirror the
flax tree (`l0`.. the layers, `l1000`.. the steam, `detect`, `model_up`),
so the weight bridge is a name map.

The JAX package's `train` argument is the module's mode here:
`model.train()` makes every BatchNorm use and update batch statistics,
`model.eval()` the running ones. Either way the forward returns the raw
Detect maps (and the SR output while `sr` is set); decoding belongs to
the eval step.
"""

from __future__ import annotations

import torch
from torch import nn

from .compiler import ModelSpec, build_module
from .detect import Detect
from .sr import DeepLabSR

INPUT_MODES = ("RGB", "IR", "RGB+IR", "RGB+IR+fusion", "RGB+IR+MF")


class DetectionModel(nn.Module):
    def __init__(self, spec: ModelSpec, input_mode: str = "RGB+IR",
                 dtype: torch.dtype = torch.float32, sr: bool = False,
                 sr_factor: int = 2, remat: bool = False):
        super().__init__()
        if input_mode not in INPUT_MODES:
            raise ValueError(f"unknown input_mode {input_mode!r}")
        layers = [ld for ld in spec.backbone + spec.head
                  if ld.name != "Detect"]
        if input_mode == "RGB+IR+fusion" and not spec.steam:
            raise ValueError("input_mode 'RGB+IR+fusion' needs a config "
                             "with steam layers")
        if input_mode == "RGB+IR+MF" and layers[0].name != "MF":
            raise ValueError("input_mode 'RGB+IR+MF' needs a config whose "
                             "first layer is MF")
        if sr and not spec.sr_taps:
            raise ValueError("the SR branch needs a config with SR taps "
                             "(l1, l2)")
        self.spec, self.input_mode, self.dtype = spec, input_mode, dtype
        self.layer_defs = layers
        self.sr = sr
        for ld in layers:
            setattr(self, f"l{ld.i}", build_module(ld, remat=remat))
        # flax creates the steam's parameters only where the route runs it
        self.steam_defs = spec.steam if input_mode == "RGB+IR+fusion" else ()
        for ld in self.steam_defs:
            setattr(self, f"l{ld.i}", build_module(ld))
        self.detect = Detect(spec.nc, spec.anchors, spec.detect_strides,
                             spec.detect_ch)
        if sr:
            l1, l2 = spec.sr_taps
            c1, c2 = spec.sr_ch
            self.model_up = DeepLabSR(
                3 if input_mode in ("RGB", "IR") else 4, spec.ch[l1],
                spec.ch[l2], c1, c2, factor=sr_factor)

    @property
    def anchors_per_level(self):
        import numpy as np
        a = np.asarray(self.spec.anchors, dtype=np.float32)
        return a.reshape(len(self.spec.anchors), -1, 2)

    @property
    def strides(self):
        return self.spec.detect_strides

    def _steam(self, x):
        for ld in self.steam_defs:
            x = getattr(self, f"l{ld.i}")(x)
        return x

    def _route(self, x, ir):
        mode, dt = self.input_mode, self.dtype
        if mode == "RGB":
            return x.to(dt)
        if mode == "IR":
            return (ir if ir is not None else x).to(dt)
        if mode == "RGB+IR":
            return torch.cat([x, ir[..., 0:1]], dim=-1).to(dt)
        if mode == "RGB+IR+fusion":
            return torch.cat([self._steam(x.to(dt)), self._steam(ir.to(dt))],
                             dim=-1)
        return [x.to(dt), ir[..., 0:1].to(dt)]                  # RGB+IR+MF

    def forward(self, x, ir=None):
        """x, ir: NHWC float inputs in [0, 1] (RGB 3ch, IR 3ch). Returns
        {"raw": [(B, ny, nx, na, no), ...]} in the compute dtype, and
        "sr" (B, H', W', 3 or 4) while the SR branch is on."""
        x_cur = self._route(x, ir)
        y: dict[int, torch.Tensor] = {}
        save = set(self.spec.save) | set(self.spec.detect_from)
        layers = self.layer_defs
        if self.spec.mode == "split":
            feats = self.l0(x_cur)
            y.update(enumerate(feats))
            x_cur, layers = feats[-1], layers[1:]
        for ld in layers:
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
        out = {"raw": self.detect(det_in)}
        if self.sr:
            l1, l2 = self.spec.sr_taps
            out["sr"] = self.model_up(y[l1], y[l2])
        return out
