"""The YOLO building blocks of the shipped configs
(`sodt_tpu/models/layers.py`): ConvBnAct, Bottleneck, C3, SPP, Focus,
Upsample, Concat, SEBlock and the RGB+IR fusion block MF. NHWC;
BatchNorm with eps 1e-3, normalized in f32 as flax does (running
statistics in eval mode, batch statistics and the momentum-0.97 running
update in training mode); SiLU in the working dtype. flax infers a
layer's input channels; here each module is built with them (the
compiler's `LayerDef.c1`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .swin import Conv


def silu(x):
    return x * torch.sigmoid(x)


class BatchNorm(nn.Module):
    """(x - mean) * (rsqrt(var + eps) * weight) + bias, in f32, cast to the
    input dtype (flax `_normalize`). In eval mode mean and var are the
    running statistics. In training mode (`module.train()`, the JAX
    package's `train=True`) they are the batch statistics over (B, H, W) in
    f32, var = max(0, E[x^2] - E[x]^2) (flax's fast variance, biased), and
    running <- momentum * running + (1 - momentum) * batch with that same
    biased variance (flax `momentum=0.97`; torch's BatchNorm2d would store
    the unbiased estimate)."""

    def __init__(self, c: int, eps: float = 1e-3, momentum: float = 0.97):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        x32 = x.float()
        mean, var = self.running_mean, self.running_var
        if self.training:
            mean = x32.mean(dim=(0, 1, 2))
            var = ((x32 * x32).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():   # in place: the buffers are the state
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(x.dtype)


class ConvBnAct(nn.Module):
    """Bias-free conv + BatchNorm + SiLU (the reference `Conv`)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = Conv(c1, c2, k, s, k // 2, bias=False)   # 'same' pad
        self.bn = BatchNorm(c2)

    def forward(self, x):
        return silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c_, c_, shortcut, e=1.0))
        self.cv2 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=-1))


class Upsample(nn.Module):
    """Nearest upsample of an NHWC map."""

    def __init__(self, scale: int = 2, method: str = "nearest"):
        super().__init__()
        if method != "nearest":
            raise NotImplementedError(
                f"Upsample {method!r}: ROADMAP.md Queue 1 item 10 (rest)")
        self.scale = scale

    def forward(self, x):
        s = self.scale
        return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, dim=-1)


class SPP(nn.Module):
    """Spatial pyramid pooling: a 1x1 conv to c1 // 2, stride-1 max-pools
    of sizes `k` (padding k // 2, the padded cells -inf), concatenated
    with their input, and a 1x1 conv to c2."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv2 = ConvBnAct(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        xc = x.permute(0, 3, 1, 2)
        pools = [F.max_pool2d(xc, k, 1, k // 2).permute(0, 2, 3, 1)
                 for k in self.k]
        return self.cv2(torch.cat([x] + pools, dim=-1))


class Focus(nn.Module):
    """Space-to-depth stem: the four 2x2 phases concatenated in the order
    (::2, ::2), (1::2, ::2), (::2, 1::2), (1::2, 1::2), then a ConvBnAct."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv = ConvBnAct(4 * c1, c2, k, 1)

    def forward(self, x):
        return self.conv(torch.cat(
            [x[:, ::2, ::2], x[:, 1::2, ::2], x[:, ::2, 1::2],
             x[:, 1::2, 1::2]], dim=-1))


class SEBlock(nn.Module):
    """Squeeze-and-excitation: global mean, Linear to c // reduction, ReLU,
    Linear back to c, sigmoid, scale; both Linears without bias."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(c, c // reduction, bias=False)
        self.fc2 = nn.Linear(c // reduction, c, bias=False)

    def forward(self, x):
        dt = x.dtype
        y = x.mean(dim=(1, 2))
        y = torch.relu(F.linear(y, self.fc1.weight.to(dt)))
        y = torch.sigmoid(F.linear(y, self.fc2.weight.to(dt)))
        return x * y[:, None, None, :]


class MF(nn.Module):
    """The SuperYOLO RGB+IR fusion block: takes [rgb, ir] (c_rgb channels
    and one) and returns 64 channels, 48 from RGB and 16 from IR. Each
    modality is squeezed and excited, masked by a 1x1 conv of itself (the
    RGB mask repeated over its channels), added back to its input, and
    taken through a bias-free 3x3 conv; the concat is excited once more."""

    def __init__(self, c_rgb: int = 3, reduction: int = 3):
        super().__init__()
        self.se_r = SEBlock(c_rgb, reduction)
        self.se_i = SEBlock(1, 1)
        self.mask_map_r = Conv(c_rgb, 1, 1, bias=True)
        self.mask_map_i = Conv(1, 1, 1, bias=True)
        self.bottleneck1 = Conv(1, 16, 3, 1, 1, bias=False)
        self.bottleneck2 = Conv(c_rgb, 48, 3, 1, 1, bias=False)
        self.se = SEBlock(64, 16)

    def forward(self, xs):
        rgb_ori, ir_ori = xs
        rgb, ir = self.se_r(rgb_ori), self.se_i(ir_ori)
        masked_rgb = self.mask_map_r(rgb) * rgb
        masked_ir = self.mask_map_i(ir) * ir
        out_ir = self.bottleneck1(masked_ir + ir_ori)
        out_rgb = self.bottleneck2(masked_rgb + rgb_ori)
        return self.se(torch.cat([out_rgb, out_ir], dim=-1))
