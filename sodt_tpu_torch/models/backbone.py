"""Enhanced-SWIN backbone with cross-channel attention fusion
(`sodt_tpu/models/backbone.py` `ImageEncoderViT`), RGB+IR only.

  input (B, H, W, 4) RGB+IR
    -> 4 per-channel patch embeds (kernel 4, stride 4, 1->48ch; the R
       embed keeps the (1,1) padding quirk, G/B/IR use (0,0))
    -> CAttentionBlock cross-channel fusion
    -> concat to 192 -> 1x1 patch embed to embed_dim + abs pos embed
       (resampled bilinearly, with JAX's antialiasing, off the config size)
    -> stage1: 6 Swin blocks, window 8, shifts [0,2,0,2,0,2]; taps 4, 5
    -> PatchMerging -> stage2: 4 blocks -> P4
    -> PatchMerging -> stage3: 1 global block (window 32) -> P5
    -> 1x1 necks: P3 from the two stage-1 taps as two sliced GEMMs,
       P4 -> out_chans, P5 -> 2*out_chans
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .swin import SwinBlock, PatchMerging, PatchEmbed, Conv
from .cattention import CAttentionBlock


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of `jax.image.resize(..., "bilinear")` along one
    axis: a triangle kernel that widens by in/out when downsampling
    (antialiasing), rows normalized, as jax._src.image.scale builds them."""
    scale = np.float32(out_size / in_size)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0), np.float32(1) - np.abs(x / kscale))
    total = w.sum(axis=0, keepdims=True)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_bilinear_nhwc(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(1, H0, W0, C) -> (1, h, w, C), matching jax.image.resize bilinear."""
    wy = torch.from_numpy(_triangle_weights(x.shape[1], h)).to(x)
    wx = torch.from_numpy(_triangle_weights(x.shape[2], w)).to(x)
    return torch.einsum("bhwc,hy,wx->byxc", x, wy, wx)


class Neck1(nn.Module):
    """neck1 of the JAX package (a (1,1,2C,out) conv over the concat of the
    two stage-1 taps) held as its two halves, so P3 = a @ Wa^T + b @ Wb^T
    never materializes the (B, H, W, 2C) concat."""

    def __init__(self, c: int, out: int):
        super().__init__()
        self.a = nn.Linear(c, out, bias=False)
        self.b = nn.Linear(c, out, bias=False)

    def forward(self, ta, tb):
        dt = ta.dtype
        return (torch.matmul(ta, self.a.weight.to(dt).t())
                + torch.matmul(tb, self.b.weight.to(dt).t()))


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 512, patch_size: int = 4,
                 embed_dim: int = 192, in_chans: int = 4,
                 out_chans: int = 256, window_size: int = 4,
                 num_heads: int = 12, mlp_ratio: float = 4.0):
        # window_size is the config's ctor arg, kept for parity: the stages
        # use windows 8 / 8 / 32
        super().__init__()
        self.in_chans = in_chans
        ps, ce = patch_size, 48                  # 48 channels per modality
        self.channel_embed_r = PatchEmbed(1, ce, ps, 4, 1)
        self.channel_embed_g = PatchEmbed(1, ce, ps, 4, 0)
        self.channel_embed_b = PatchEmbed(1, ce, ps, 4, 0)
        self.channel_embed_i = PatchEmbed(1, ce, ps, 4, 0)
        self.chan_block = CAttentionBlock(ce, num_heads)
        self.patch_embed = PatchEmbed(4 * ce, embed_dim, 1, 1, 0)
        g = img_size // 4
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        shifts = (0, 2, 0, 2, 0, 2)
        blk = lambda d, ws, s: SwinBlock(d, num_heads, ws, s, mlp_ratio,
                                         linear_mlp=s == 0)
        for i in range(6):
            setattr(self, f"stage1_{i}", blk(embed_dim, 8, shifts[i]))
        self.pmerging1 = PatchMerging(embed_dim)
        for i in range(4):
            setattr(self, f"stage2_{i}", blk(2 * embed_dim, 8, shifts[i]))
        self.pmerging2 = PatchMerging(2 * embed_dim)
        self.stage3_0 = blk(4 * embed_dim, 32, 0)
        self.neck1 = Neck1(embed_dim, out_chans)
        self.neck2 = Conv(2 * embed_dim, out_chans, 1, bias=False)
        self.neck3 = Conv(4 * embed_dim, 2 * out_chans, 1, bias=False)

    def forward(self, x):
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels, got "
                             f"shape {tuple(x.shape)}")
        r = self.channel_embed_r(x[..., 0:1])
        g = self.channel_embed_g(x[..., 1:2])
        b = self.channel_embed_b(x[..., 2:3])
        ir = self.channel_embed_i(x[..., 3:4])
        if r.shape != g.shape:
            # the (1,1)-padded R embed is one row/col larger at some sizes
            raise ValueError(f"image size {tuple(x.shape[1:3])}: R embed "
                             f"{tuple(r.shape)} != G embed {tuple(g.shape)}")
        r, g, b, ir = self.chan_block(r, g, b, ir)
        x = self.patch_embed(torch.cat([r, g, b, ir], dim=-1))
        _, h, w, _ = x.shape
        pos = self.pos_embed
        if tuple(pos.shape[1:3]) != (h, w):
            pos = resize_bilinear_nhwc(pos, h, w)
        x = x + pos.to(x.dtype)

        taps = []
        for i in range(6):
            x = getattr(self, f"stage1_{i}")(x)
            if i in (4, 5):
                taps.append(x)
        x = self.pmerging1(x)
        for i in range(4):
            x = getattr(self, f"stage2_{i}")(x)
        p4 = x
        x = self.pmerging2(x)
        p5 = self.stage3_0(x)
        return [self.neck1(taps[0], taps[1]), self.neck2(p4), self.neck3(p5)]
