"""The YOLO building blocks (`sodt_tpu/models/layers.py`): those of the
shipped configs (ConvBnAct, Bottleneck, C3, SPP, Focus, Upsample, Concat,
SEBlock and the RGB+IR fusion block MF) and the rest of JAX's registry
(Contract, Expand, Sum, the CSP blocks BottleneckCSP, BottleneckCSP2 and
SPPCSP, CrossConv, GhostConv, GhostBottleneck, MixConv2d, AttentionModel,
ACmix), with Classify and ScaledDotProductAttentionOnly, which JAX keeps
outside its registry. NHWC; BatchNorm with eps 1e-3, normalized in f32
as flax does (running statistics in eval mode, batch statistics and the
momentum-0.97 running update in training mode); activations in the
working dtype. flax infers a layer's input channels; here each module is
built with them (the compiler's `LayerDef.c1`). Where JAX multiplies a
map by an f32 parameter (Sum's weights, ACmix's rates) its result is
f32, which the next flax module casts back to its dtype: here the product
is taken in f32 and cast to the input's dtype at once."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import check_method, resize
from ..parallel.mesh import all_reduce_sum, world_size
from .swin import Conv


def silu(x):
    return x * torch.sigmoid(x)


def leaky_relu_01(x):
    return F.leaky_relu(x, 0.1)


def mish(x):
    return x * torch.tanh(F.softplus(x))


class BatchNorm(nn.Module):
    """(x - mean) * (rsqrt(var + eps) * weight) + bias, in f32, cast to the
    input dtype (flax `_normalize`). In eval mode mean and var are the
    running statistics. In training mode (`module.train()`, the JAX
    package's `train=True`) they are the batch statistics over (B, H, W) in
    f32, var = max(0, E[x^2] - E[x]^2) (flax's fast variance, biased), and
    running <- momentum * running + (1 - momentum) * batch with that same
    biased variance (flax `momentum=0.97`; torch's BatchNorm2d would store
    the unbiased estimate).

    Under a process group of W > 1 ranks (`parallel.mesh`) the batch is
    the global one, as under JAX's mesh: the per-channel f32 sums of x and
    x^2 and the element count are all-reduced with autograd (the backward
    carries the cross-shard terms), mean and var are formed from the
    global sums, and every rank updates its running statistics alike."""

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
        if self.training and world_size() > 1:
            c = x32.shape[-1]
            n = x32.new_full((1,), x32.numel() // c)
            sums = all_reduce_sum(torch.cat([
                x32.sum(dim=(0, 1, 2)), (x32 * x32).sum(dim=(0, 1, 2)), n]))
            mean = sums[:c] / sums[-1]
            var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
        elif self.training:
            mean = x32.mean(dim=(0, 1, 2))
            var = ((x32 * x32).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
        if self.training:
            with torch.no_grad():   # in place: the buffers are the state
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean) * mul + self.bias).to(x.dtype)


class ConvBnAct(nn.Module):
    """Bias-free conv + BatchNorm + activation (the reference `Conv`): 'same'
    padding k // 2 on each axis, `k` / `s` ints or (h, w) pairs, `g`
    groups, `act` SiLU by default (None: the identity)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, g: int = 1, act=silu):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.conv = Conv(c1, c2, (kh, kw), s, (kh // 2, kw // 2), bias=False,
                         g=g)
        self.bn = BatchNorm(c2)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return self.act(y) if self.act is not None else y


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
    """Upsample of an NHWC map by `scale`: nearest repeats each cell, any
    other method is `jax.image.resize`'s (`ops.resize`: linear / bilinear
    / triangle, cubic / bicubic, lanczos3, lanczos5); a method that JAX
    does not know raises its ValueError."""

    def __init__(self, scale: int = 2, method: str = "nearest"):
        super().__init__()
        check_method(method)
        self.scale, self.method = scale, method

    def forward(self, x):
        s = self.scale
        if self.method == "nearest":
            return x.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
        return resize(x, (x.shape[1] * s, x.shape[2] * s), self.method)


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
        return self.cv2(torch.cat([x] + max_pools(x, self.k), dim=-1))


def max_pools(x, ks) -> list:
    """Stride-1 max-pools of an NHWC map, one for each size in `ks`,
    padding k // 2 with -inf cells (flax `max_pool`'s padding)."""
    xc = x.permute(0, 3, 1, 2)
    return [F.max_pool2d(xc, k, 1, k // 2).permute(0, 2, 3, 1) for k in ks]


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


class Contract(nn.Module):
    """Fold gain x gain space into channels: (n, h, w, c) -> (n, h / g,
    w / g, c g^2), the channel index (row phase, column phase, c)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        n, h, w, c = x.shape
        s = self.gain
        x = x.reshape(n, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h // s, w // s, c * s * s)


class Expand(nn.Module):
    """Contract's inverse: (n, h, w, c) -> (n, h g, w g, c / g^2)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain

    def forward(self, x):
        n, h, w, c = x.shape
        s = self.gain
        x = x.reshape(n, h, w, s, s, c // (s * s)).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h * s, w * s, c // (s * s))


class Sum(nn.Module):
    """The sum of n inputs; with `weight`, each input after the first is
    scaled by 2 sigmoid(w_i), w initialized to -(1, 2, ..., n - 1) / 2."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.w = (nn.Parameter(-torch.arange(1.0, n) / 2.0) if weight
                  else None)

    def forward(self, xs):
        y = xs[0]
        if self.w is None:
            for i in range(self.n - 1):
                y = y + xs[i + 1]
            return y
        w = torch.sigmoid(self.w) * 2.0
        y = y.float()
        for i in range(self.n - 1):
            y = y + xs[i + 1].float() * w[i]
        return y.to(xs[0].dtype)


class Classify(nn.Module):
    """Classification head: the global mean of each input (one map or a
    list), concatenated, through a k x k conv with bias ('same' padding on
    the 1 x 1 map) -> (B, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.k = k
        self.conv = Conv(c1, c2, k, s, 0, bias=True)

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        y = torch.cat([t.mean(dim=(1, 2), keepdim=True) for t in xs], dim=-1)
        lo = (self.k - 1) // 2
        y = F.pad(y, (0, 0, lo, self.k - 1 - lo, lo, self.k - 1 - lo))
        y = self.conv(y)
        return y.reshape(y.shape[0], -1)


class BottleneckCSP(nn.Module):
    """CSP bottleneck, v4 style: cv1 and n bottlenecks then a bias-free 1x1
    (cv3) on one branch, a bias-free 1x1 of the input (cv2) on the other,
    BatchNorm and LeakyReLU(0.1) over their concat, cv4."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c_, c_, shortcut, e=1.0))
        self.cv3 = Conv(c_, c_, 1, bias=False)
        self.cv2 = Conv(c1, c_, 1, bias=False)
        self.bn = BatchNorm(2 * c_)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1)

    def forward(self, x):
        y1 = self.cv1(x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        y = torch.cat([self.cv3(y1), self.cv2(x)], dim=-1)
        return self.cv4(leaky_relu_01(self.bn(y)))


class BottleneckCSP2(nn.Module):
    """CSP2: cv1 to c2, then n bottlenecks (no shortcut by default) beside
    a bias-free 1x1 of cv1's output, BatchNorm and LeakyReLU(0.1), cv3."""

    def __init__(self, c1: int, c2: int, n: int = 1,
                 shortcut: bool = False):
        super().__init__()
        self.n = n
        self.cv1 = ConvBnAct(c1, c2, 1, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c2, c2, shortcut, e=1.0))
        self.cv2 = Conv(c2, c2, 1, bias=False)
        self.bn = BatchNorm(2 * c2)
        self.cv3 = ConvBnAct(2 * c2, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv1(x)
        y1 = x1
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        y = torch.cat([y1, self.cv2(x1)], dim=-1)
        return self.cv3(leaky_relu_01(self.bn(y)))


class SPPCSP(nn.Module):
    """CSP-wrapped SPP: cv1, cv3 (3x3), cv4, the max-pools of sizes `k`
    concatenated with their input, cv5, cv6 (3x3) on one branch, a
    bias-free 1x1 of the input (cv2) on the other, BatchNorm and Mish over
    their concat, cv7. `n` is taken and unused, as in JAX."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5,
                 k=(5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1)
        self.cv3 = ConvBnAct(c_, c_, 3, 1)
        self.cv4 = ConvBnAct(c_, c_, 1, 1)
        self.cv5 = ConvBnAct(c_ * (len(self.k) + 1), c_, 1, 1)
        self.cv6 = ConvBnAct(c_, c_, 3, 1)
        self.cv2 = Conv(c1, c_, 1, bias=False)
        self.bn = BatchNorm(2 * c_)
        self.cv7 = ConvBnAct(2 * c_, c2, 1, 1)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = self.cv6(self.cv5(torch.cat([x1] + max_pools(x1, self.k),
                                         dim=-1)))
        y = torch.cat([y1, self.cv2(x)], dim=-1)
        return self.cv7(mish(self.bn(y)))


class CrossConv(nn.Module):
    """A (1, k) ConvBnAct of stride (1, s), then a (k, 1) one of stride
    (s, 1); the input added where `shortcut` and c1 == c2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, (1, k), (1, s))
        self.cv2 = ConvBnAct(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class GhostConv(nn.Module):
    """Ghost convolution: a ConvBnAct to c2 / 2, then a depthwise 5x5
    ConvBnAct of it, concatenated; `act=None` is the linear variant."""

    def __init__(self, c1: int, c2: int, k=1, s=1, g: int = 1, act=silu):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, g=g, act=act)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=-1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: GhostConv to c2 / 2, at s = 2 a linear depthwise
    k x k conv of stride 2 (dw), a linear GhostConv to c2; always summed
    with a shortcut: the input at s = 1 (c1 == c2), else a linear
    depthwise conv of stride 2 (sc_dw) and a linear 1x1 (sc_pw)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.g1 = GhostConv(c1, c_, 1, 1)
        if s == 2:
            self.dw = ConvBnAct(c_, c_, k, s, g=c_, act=None)
            self.sc_dw = ConvBnAct(c1, c1, k, s, g=c1, act=None)
            self.sc_pw = ConvBnAct(c1, c2, 1, 1, act=None)
        self.g2 = GhostConv(c_, c2, 1, 1, act=None)

    def forward(self, x):
        y = self.g1(x)
        if self.s == 2:
            y = self.g2(self.dw(y))
            return y + self.sc_pw(self.sc_dw(x))
        return self.g2(y) + x


class MixConv2d(nn.Module):
    """Bias-free convs of sizes `k` (stride s, 'same' padding) splitting c2
    equally (the remainder to the first), concatenated, BatchNorm, and the
    input added to their LeakyReLU(0.1) (c1 == c2)."""

    def __init__(self, c1: int, c2: int, k=(1, 3), s: int = 1):
        super().__init__()
        self.k = tuple(k)
        splits = [c2 // len(self.k)] * len(self.k)
        splits[0] += c2 - sum(splits)
        for i, (ki, ci) in enumerate(zip(self.k, splits)):
            setattr(self, f"m{i}", Conv(c1, ci, ki, s, ki // 2, bias=False))
        self.bn = BatchNorm(c2)

    def forward(self, x):
        y = torch.cat([getattr(self, f"m{i}")(x)
                       for i in range(len(self.k))], dim=-1)
        return x + leaky_relu_01(self.bn(y))


class AttentionModel(nn.Module):
    """Sigmoid spatial attention residual: x + x exp(sigmoid(conv3x3(x)))
    with a one-channel conv with bias."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv = Conv(c1, 1, 3, 1, 1, bias=True)

    def forward(self, x):
        return x + x * torch.exp(torch.sigmoid(self.conv(x)))


class ScaledDotProductAttentionOnly(nn.Module):
    """Channel-token attention over the flattened map: inputs (v, k, q),
    softmax over channels of (q / temperature) k^T, times v."""

    def __init__(self, temperature: float = 1.0):
        super().__init__()
        self.temperature = temperature

    def forward(self, qkv):
        v, k, q = qkv
        b, h, w, c = q.shape
        flat = lambda t: t.reshape(b, h * w, c).transpose(1, 2)  # (b, c, n)
        attn = torch.einsum("bcn,bdn->bcd", flat(q) / self.temperature,
                            flat(k)).softmax(dim=-1)
        out = torch.einsum("bcd,bdn->bcn", attn, flat(v))
        return out.transpose(1, 2).reshape(b, h, w, c)


class ACmix(nn.Module):
    """ACmix: shared 1x1 q / k / v projections (conv1-conv3) feeding (a)
    local attention over kernel_att x kernel_att neighbourhoods (reflect
    padding by kernel_att // 2, queries taken at stride s) with a
    positional encoding, a 1x1 conv (conv_p) of the 2-channel linspace
    coordinate map, and (b) a conv branch: a bias-free Linear (fc) over
    the stacked q / k / v heads of each head channel, then a depthwise-
    grouped (hd groups) bias-free kernel_conv conv (dep_conv, stride s);
    mixed as rate1 att + rate2 conv, both rates initialized to 0.5."""

    def __init__(self, c1: int, c2: int, kernel_att: int = 7, head: int = 4,
                 kernel_conv: int = 3, s: int = 1):
        super().__init__()
        self.c2, self.head, self.ka, self.kc, self.s = (c2, head, kernel_att,
                                                        kernel_conv, s)
        hd = c2 // head
        self.conv1 = Conv(c1, c2, 1)
        self.conv2 = Conv(c1, c2, 1)
        self.conv3 = Conv(c1, c2, 1)
        self.conv_p = Conv(2, hd, 1)
        self.fc = nn.Linear(3 * head, kernel_conv ** 2, bias=False)
        # the reference's reset_parameters removes dep_conv's bias
        self.dep_conv = Conv(hd * kernel_conv ** 2, c2, kernel_conv, s,
                             kernel_conv // 2, bias=False, g=hd)
        self.rate1 = nn.Parameter(torch.full((1,), 0.5))
        self.rate2 = nn.Parameter(torch.full((1,), 0.5))

    def _unfold(self, t, h_out: int, w_out: int):
        """(B, h, w, hd) -> (B, hd, ka^2, h_out, w_out): reflect-padded
        ka x ka patches at stride s, channel slowest."""
        pad = self.ka // 2
        tn = F.pad(t.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="reflect")
        p = F.unfold(tn, self.ka, stride=self.s)
        return p.reshape(t.shape[0], t.shape[3], self.ka ** 2, h_out, w_out)

    def forward(self, x):
        b, h, w, _ = x.shape
        co, nh, s, dt = self.c2, self.head, self.s, x.dtype
        hd = co // nh
        q, k, v = self.conv1(x), self.conv2(x), self.conv3(x)
        loc_w = torch.linspace(-1.0, 1.0, w, device=x.device)[None, :].expand(
            h, w)
        loc_h = torch.linspace(-1.0, 1.0, h, device=x.device)[:, None].expand(
            h, w)
        pe = self.conv_p(torch.stack([loc_w, loc_h], dim=-1)[None].to(dt))
        h_out, w_out = h // s, w // s

        def heads(t):   # (b, h, w, co) -> (b * nh, h, w, hd)
            return (t.reshape(b, h, w, nh, hd).permute(0, 3, 1, 2, 4)
                    .reshape(b * nh, h, w, hd))

        q_att = heads(q) * hd ** -0.5
        q_pe = pe
        if s > 1:
            q_att, q_pe = q_att[:, ::s, ::s], pe[:, ::s, ::s]
        q_att_n = q_att.permute(0, 3, 1, 2)[:, :, None]
        q_pe_n = q_pe.permute(0, 3, 1, 2)[:, :, None]
        att = (q_att_n * (self._unfold(heads(k), h_out, w_out) + q_pe_n
                          - self._unfold(pe, h_out, w_out))).sum(1)
        att = att.softmax(dim=1)                        # over ka^2
        out_att = (att[:, None]
                   * self._unfold(heads(v), h_out, w_out)).sum(2)
        out_att = (out_att.reshape(b, nh, hd, h_out, w_out)
                   .permute(0, 3, 4, 1, 2).reshape(b, h_out, w_out, co))

        f_all = torch.cat([t.reshape(b, h * w, nh, hd) for t in (q, k, v)],
                          dim=2)                        # (b, hw, 3 nh, hd)
        f_all = f_all.transpose(2, 3)                   # (b, hw, hd, 3 nh)
        f_fc = F.linear(f_all, self.fc.weight.to(dt))   # (b, hw, hd, kc^2)
        out_conv = self.dep_conv(f_fc.reshape(b, h, w, -1))
        return (self.rate1 * out_att.float()
                + self.rate2 * out_conv.float()).to(dt)
