"""The super-resolution auxiliary branch (`sodt_tpu/models/sr.py`), used in
training only (`--super`).

A decoder fuses a low-level tap (y[l1]) with a high-level one (y[l2]):
1x1 convs to c1 // 2 and c2 // 2 channels, the high-level map resized
(JAX's antialiased bilinear, `ops.resize`) to the low-level size times
factor // 2 (the low-level map too when factor > 1), concat, a three-conv
head to 64 channels. EDSR then: a 3x3 head conv, 16 residual blocks, a x8
pixel-shuffle upsampler and a 3x3 conv to the output channels. The scale
of EDSR is 8 whatever the factor, as in JAX. NHWC throughout.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.resize import resize_bilinear
from .swin import Conv


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC depth-to-space in torch.nn.PixelShuffle's channel order: the
    channels read as (C, r, r)."""
    b, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(b, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, co)


class SRDecoder(nn.Module):
    """Feature-fusion decoder; `low_in` / `high_in` are the taps' channels,
    c1 / c2 the config's widths (outputs c1 // 2 and c2 // 2)."""

    def __init__(self, low_in: int, high_in: int, c1: int, c2: int,
                 factor: int = 2):
        super().__init__()
        self.factor = factor
        self.conv1 = Conv(low_in, c1 // 2, 1, bias=False)
        self.conv2 = Conv(high_in, c2 // 2, 1, bias=False)
        self.last_conv0 = Conv(c1 // 2 + c2 // 2, 256, 3, 1, 1, bias=False)
        self.last_conv1 = Conv(256, 128, 3, 1, 1, bias=False)
        self.last_conv2 = Conv(128, 64, 1, bias=True)

    def forward(self, x, low_level_feat):
        low = torch.relu(self.conv1(low_level_feat))
        x = torch.relu(self.conv2(x))
        _, lh, lw, _ = low.shape
        size = (lh * (self.factor // 2), lw * (self.factor // 2))
        x = resize_bilinear(x, size)
        if self.factor > 1:
            low = resize_bilinear(low, size)
        y = torch.relu(self.last_conv0(torch.cat([x, low], dim=-1)))
        y = torch.relu(self.last_conv1(y))
        return self.last_conv2(y)


class EDSR(nn.Module):
    """Head conv (64 channels in and out) -> 16 residual blocks -> x8 by
    three x2 pixel shuffles -> conv to `num_channels`."""

    WIDTH, DEPTH, UPS = 64, 16, 3

    def __init__(self, num_channels: int = 3):
        super().__init__()
        w = self.WIDTH
        conv = lambda c1, c2: Conv(c1, c2, 3, 1, 1, bias=True)
        self.head = conv(w, w)
        for i in range(self.DEPTH):
            setattr(self, f"body{i}_0", conv(w, w))
            setattr(self, f"body{i}_1", conv(w, w))
        self.body_out = conv(w, w)
        for k in range(self.UPS):
            setattr(self, f"tail_up{k}", conv(w, 4 * w))
        self.tail_out = conv(w, num_channels)

    def forward(self, x):
        x = self.head(x)
        res = x
        for i in range(self.DEPTH):
            y = torch.relu(getattr(self, f"body{i}_0")(res))
            res = res + getattr(self, f"body{i}_1")(y)
        x = x + self.body_out(res)
        for k in range(self.UPS):
            x = pixel_shuffle(getattr(self, f"tail_up{k}")(x), 2)
        return self.tail_out(x)


class DeepLabSR(nn.Module):
    """Decoder + EDSR(x8), called as model_up(y[l1], y[l2])."""

    def __init__(self, out_ch: int, low_in: int, high_in: int,
                 c1: int = 128, c2: int = 512, factor: int = 2):
        super().__init__()
        if factor // 2 < 1:
            # the decoder would resize to low_level_size * (factor // 2) = 0;
            # JAX fails there too (a concat of an empty map)
            raise ValueError(f"the SR branch needs --factor >= 2, got "
                             f"factor {factor}")
        self.sr_decoder = SRDecoder(low_in, high_in, c1, c2, factor)
        self.edsr = EDSR(num_channels=out_ch)

    def forward(self, low_level_feat, x):
        return self.edsr(self.sr_decoder(x, low_level_feat))
