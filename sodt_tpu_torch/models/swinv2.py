"""SwinV2 backbone variant: cosine attention + continuous rel-pos bias
(`sodt_tpu/models/swinv2.py`).

  input (B, H, W, 4) RGB+IR
    -> 4 per-channel patch embeds (kernel 4, stride 4, pad 0, 1 -> 24 ch)
    -> CAttentionBlockV2 (window 2, no shift, scale before the softmax,
       residual + LN inside the windows), concat to 96 ch
    -> 1x1 patch embed 96 -> 96
    -> 4 stages, depths 2/2/6/2, heads 3/6/12/24, window 8, V2 blocks:
       cosine attention with a clamped learned logit scale, a cpb-MLP
       relative position bias scaled 16 * sigmoid, a qkv bias whose K part
       is zero, POST-norm residuals whose norms start at zero, PatchMerging
       between the stages
    -> taps after stages 0, 2, 3 -> 1x1 necks 96 -> 128, 384 -> 256,
       768 -> 512: [P3 @ /4, P4 @ /16, P5 @ /32]

The blocks carry (B, H, W, C) maps, as the port's v1 blocks do (the JAX
blocks carry the same tokens flattened to (B, H*W, C)). Every block's
attention core runs on pre-partitioned (B * nW, N, 3C) windows: K11 on a
bf16 tensor on the card, forward and backward. A block SHRINKS its window
to a map that is no larger than it (no padding, unlike v1), so a stage's
map must divide by 8 or be at most 8 wide: image sizes 64, 128, 256 and
512 px (and larger multiples of 256).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from .norm import LayerNorm
from .swin import (Conv, PatchEmbed, PatchMerging, RelPosBias, _mask_tensor,
                   linear, relative_position_index, window_partition,
                   window_unpartition)
from ..kernels import window_attention as kwa
from ..ops.activations import gelu


def relative_coords_table(ws: int, pretrained_ws: int = 0) -> np.ndarray:
    """Normalized log-spaced relative coordinates, ((2ws-1)^2, 2)."""
    rh = np.arange(-(ws - 1), ws, dtype=np.float32)
    rw = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(rh, rw, indexing="ij"), axis=-1)
    denom = (pretrained_ws - 1) if pretrained_ws > 0 else (ws - 1)
    table = table / max(denom, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8)
    return table.reshape(-1, 2)


@lru_cache(maxsize=64)
def _bias_inputs(ws: int, pretrained_ws: int, device: torch.device):
    """The coordinate table and the gather index of a ws x ws window."""
    table = torch.from_numpy(relative_coords_table(ws, pretrained_ws))
    index = torch.from_numpy(relative_position_index(ws).reshape(-1)).long()
    return (table.to(device, non_blocking=True),
            index.to(device, non_blocking=True))


class WindowAttentionV2(RelPosBias):
    """Cosine window attention with a cpb-MLP bias on (B_, N, C) window
    tokens. Parameters: logit_scale (nh, 1, 1), cpb_mlp0 (2 -> 512),
    cpb_mlp1 (512 -> nh, no bias), qkv (no bias), q_bias, v_bias (C,),
    proj. `window_size` is the nominal window; a forward may run at a
    smaller one (N tokens), the parameters do not depend on it."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, pretrained_window_size: int = 0):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.pretrained_window_size = pretrained_window_size
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp0 = nn.Linear(2, 512)
        self.cpb_mlp1 = nn.Linear(512, num_heads, bias=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.zeros(dim))
            self.v_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.q_bias = self.v_bias = None
        self.proj = nn.Linear(dim, dim)

    def bias_params(self) -> list:
        return list(self.cpb_mlp0.parameters()) + [self.cpb_mlp1.weight]

    def materialize_bias(self, ws: int, dt: torch.dtype) -> torch.Tensor:
        """16 * sigmoid(cpb_mlp(table))[index] as (nh, N, N) f32; the MLP
        runs in the compute dtype, the sigmoid in f32."""
        table, index = _bias_inputs(ws, self.pretrained_window_size,
                                    self.cpb_mlp0.weight.device)
        h1 = linear(table.to(dt), self.cpb_mlp0)
        bias_table = linear(torch.relu(h1), self.cpb_mlp1)
        n = ws * ws
        bias = bias_table[index].reshape(n, n, self.num_heads).permute(2, 0, 1)
        return 16.0 * torch.sigmoid(bias.float())

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        b_, n, c = x.shape
        nh, dt = self.num_heads, x.dtype
        hd = c // nh
        bias = self.rel_bias(math.isqrt(n), dt)
        qkv = linear(x, self.qkv)
        if self.q_bias is not None:
            # the K part of the bias is zero by construction
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                                   self.v_bias]).to(dt)
        q, k, v = qkv.reshape(b_, n, 3, nh, hd).unbind(2)   # (B_, N, nh, hd)
        # cosine attention = scaled-dot attention on the NORMALIZED q / k
        # with the clamped per-head logit scale folded into q, so the core
        # runs with scale 1: normalized in f32, cast to the compute dtype
        # before packing
        qn = q / (q.float().norm(dim=-1, keepdim=True) + 1e-12)
        kn = k / (k.float().norm(dim=-1, keepdim=True) + 1e-12)
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        qs = (qn * scale.reshape(nh, 1)).to(dt)
        pack = torch.cat([qs.reshape(b_, n, c), kn.to(dt).reshape(b_, n, c),
                          v.reshape(b_, n, c)], dim=-1)      # (B_, N, 3C)
        nw = mask.shape[0] if mask is not None else 1
        out = kwa.window_attention_core(pack, bias, mask, nw, nh, 1.0)
        return linear(out, self.proj)


class SwinBlockV2(nn.Module):
    """V2 block over an NHWC map: x + LN(attn(x)), then x + LN(mlp(x));
    the two post-norms start at zero scale (the block starts as the
    identity)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, pretrained_window_size: int = 0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.attn = WindowAttentionV2(dim, window_size, num_heads, qkv_bias,
                                      pretrained_window_size)
        self.norm1 = LayerNorm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0         # the window shrinks, no padding
        if h % ws or w % ws:
            raise ValueError(
                f"SwinBlockV2: a {h}x{w} map does not divide into windows of "
                f"{ws}: the SwinV2 family takes image sizes whose stage maps "
                f"divide by {self.window_size} or are no larger (64, 128, "
                "256, 512 px)")
        xs = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
        mask = _mask_tensor(h, w, ws, shift, x.device) if shift else None
        xw = self.attn(window_partition(xs, ws), mask)
        xs = window_unpartition(xw, ws, (h, w))
        if shift:
            xs = torch.roll(xs, (shift, shift), (1, 2))
        x = x + self.norm1(xs)
        y = linear(gelu(linear(x, self.mlp_fc1)), self.mlp_fc2)
        return x + self.norm2(y)


class CAttentionBlockV2(nn.Module):
    """V2 cross-channel fusion over four NHWC maps (r, g, b, ir): window 2,
    projection-free multi-head attention with the 1/sqrt(d) scale BEFORE
    the softmax, residual + LN inside the windows, outputs concatenated.
    Windows of 4 tokens and head dim 2: plain PyTorch, as the JAX package
    computes it outside any kernel."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 window_size: int = 2):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        for i in range(1, 5):
            setattr(self, f"norm{i}", LayerNorm(embedding_dim))

    def _cattn(self, q, k, v):
        b_, n, c = q.shape
        nh = self.num_heads
        hd = c // nh
        split = lambda t: t.reshape(b_, n, nh, hd).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        a = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        a = torch.softmax(a / math.sqrt(hd), dim=-1).to(q.dtype)
        return torch.matmul(a, vh).transpose(1, 2).reshape(b_, n, c)

    def forward(self, r, g, b, ir):
        _, h, w, _ = r.shape
        ws = self.window_size
        rw, gw, bw, irw = (window_partition(t, ws) for t in (r, g, b, ir))
        x1 = self.norm1(rw + self._cattn(rw, gw, gw))
        x2 = self.norm2(gw + self._cattn(gw, bw, bw))
        x3 = self.norm3(bw + self._cattn(bw, irw, irw))
        x4 = self.norm4(irw + self._cattn(irw, gw, gw))
        return torch.cat([window_unpartition(t, ws, (h, w))
                          for t in (x1, x2, x3, x4)], dim=-1)


class ImageEncoderSwinV2(nn.Module):
    """The SwinV2 variant encoder -> [P3 (128 ch), P4 (256), P5 (512)].
    `img_size` is kept for config parity: the maps follow the input."""

    def __init__(self, img_size: int = 512, patch_size: int = 4,
                 embed_dim: int = 96, in_chans: int = 4, window_size: int = 8,
                 chan_embed_dim: int = 24, chan_heads: int = 12,
                 depths: tuple = (2, 2, 6, 2),
                 num_heads: tuple = (3, 6, 12, 24), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.in_chans, self.depths = in_chans, tuple(depths)
        for ch in "rgbi":
            setattr(self, f"channel_embed_{ch}",
                    PatchEmbed(1, chan_embed_dim, patch_size, 4, 0))
        self.chan_block = CAttentionBlockV2(chan_embed_dim, chan_heads)
        self.patch_embed = PatchEmbed(4 * chan_embed_dim, embed_dim, 1, 1, 0)
        dim, tap_dims = embed_dim, []
        for li, (depth, nh) in enumerate(zip(depths, num_heads)):
            for bi in range(depth):
                setattr(self, f"layer{li}_blk{bi}", SwinBlockV2(
                    dim, nh, window_size, 0 if bi % 2 == 0 else window_size // 2,
                    mlp_ratio, qkv_bias, pretrained_window_size=8))
            if li in (0, 2, 3):
                tap_dims.append(dim)
            if li < len(depths) - 1:
                setattr(self, f"downsample{li}", PatchMerging(dim))
                dim *= 2
        for i, (td, nch) in enumerate(zip(tap_dims, (128, 256, 512)), 1):
            setattr(self, f"neck{i}", Conv(td, nch, 1, bias=False))

    def forward(self, x):
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels, got "
                             f"shape {tuple(x.shape)}")
        r, g, b, ir = (getattr(self, f"channel_embed_{ch}")(x[..., i:i + 1])
                       for i, ch in enumerate("rgbi"))
        x = self.patch_embed(self.chan_block(r, g, b, ir))
        taps = []
        for li, depth in enumerate(self.depths):
            for bi in range(depth):
                x = getattr(self, f"layer{li}_blk{bi}")(x)
            if li in (0, 2, 3):
                taps.append(x)
            if li < len(self.depths) - 1:
                x = getattr(self, f"downsample{li}")(x)
        return [getattr(self, f"neck{i}")(t) for i, t in enumerate(taps, 1)]
