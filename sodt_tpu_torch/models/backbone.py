"""Enhanced-SWIN backbone with cross-channel attention fusion
(`sodt_tpu/models/backbone.py` `ImageEncoderViT`), and its RGB-only mono
variant (`mono=True`: one patch embed, kernel and stride 4, from the
input's channels to embed_dim, no cross-channel block).

  input (B, H, W, 4) RGB+IR
    -> 4 per-channel patch embeds (kernel 4, stride 4, 1->48ch; the R
       embed keeps the (1,1) padding quirk, G/B/IR use (0,0))
    -> CAttentionBlock cross-channel fusion
    -> concat to 192 -> 1x1 patch embed to embed_dim
       [mono: input (B, H, W, 3) -> the one patch embed]
    -> abs pos embed
       (resampled bilinearly, with JAX's antialiasing, off the config size)
    -> stage1: 6 Swin blocks, window 8, shifts [0,2,0,2,0,2]; taps 4, 5
    -> PatchMerging -> stage2: 4 blocks -> P4
    -> PatchMerging -> stage3: 1 global block (window 32) -> P5
    -> 1x1 necks: P3 from the two stage-1 taps as two sliced GEMMs,
       P4 -> out_chans, P5 -> 2*out_chans

`remat` (JAX's `nn.remat(SwinBlock)`) checkpoints each Swin block of the
three stages while autograd records: the backward runs the block's
forward again (its kernels launch a second time) in place of keeping its
activations. Nothing in a block draws at random, so the gradients are
those of the run without it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.resize import resize_bilinear
from .swin import SwinBlock, PatchMerging, PatchEmbed, Conv
from .cattention import CAttentionBlock


def resize_bilinear_nhwc(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The pos-embed resample: `ops.resize.resize_bilinear` to (h, w)."""
    return resize_bilinear(x, (h, w))


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
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 mono: bool = False, remat: bool = False):
        # window_size is the config's ctor arg, kept for parity: the stages
        # use windows 8 / 8 / 32
        super().__init__()
        self.in_chans, self.mono, self.remat = in_chans, mono, remat
        ps, ce = patch_size, 48                  # 48 channels per modality
        if mono:
            self.patch_embed = PatchEmbed(in_chans, embed_dim, ps, ps, 0)
        else:
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

    def _fused_embed(self, x):
        """The four per-channel embeds, the cross-channel block and the
        1x1 patch embed of the RGB+IR encoder."""
        r = self.channel_embed_r(x[..., 0:1])
        g = self.channel_embed_g(x[..., 1:2])
        b = self.channel_embed_b(x[..., 2:3])
        ir = self.channel_embed_i(x[..., 3:4])
        if r.shape != g.shape:
            # the (1,1)-padded R embed is one row/col larger at some sizes
            raise ValueError(f"image size {tuple(x.shape[1:3])}: R embed "
                             f"{tuple(r.shape)} != G embed {tuple(g.shape)}")
        r, g, b, ir = self.chan_block(r, g, b, ir)
        return self.patch_embed(torch.cat([r, g, b, ir], dim=-1))

    def _block(self, name: str, x):
        blk = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, x, use_reentrant=False)
        return blk(x)

    def forward(self, x):
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected {self.in_chans} input channels, got "
                             f"shape {tuple(x.shape)}")
        x = self.patch_embed(x) if self.mono else self._fused_embed(x)
        _, h, w, _ = x.shape
        pos = self.pos_embed
        if tuple(pos.shape[1:3]) != (h, w):
            pos = resize_bilinear_nhwc(pos, h, w)
        x = x + pos.to(x.dtype)

        taps = []
        for i in range(6):
            x = self._block(f"stage1_{i}", x)
            if i in (4, 5):
                taps.append(x)
        x = self.pmerging1(x)
        for i in range(4):
            x = self._block(f"stage2_{i}", x)
        p4 = x
        x = self.pmerging2(x)
        p5 = self._block("stage3_0", x)
        return [self.neck1(taps[0], taps[1]), self.neck2(p4), self.neck3(p5)]
