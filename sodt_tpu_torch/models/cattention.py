"""Cross-channel attention fusion (`sodt_tpu/models/cattention.py`).

Four projection-free multi-head cross-attention units chained over the
per-channel token maps (r<-g, g<-b, b<-ir, ir<-g), each followed by
residual + LayerNorm. The quirks are kept: no q/k/v/out projections, and
the shift mask is added BEFORE the 1/sqrt(d) scaling. At window 1 (the
live configuration) softmax over one logit is 1, so each unit returns its
V input exactly: the fast path below.
"""

from __future__ import annotations

import torch
from torch import nn

from .norm import LayerNorm
from .swin import window_partition, window_unpartition, shift_attn_mask


class CAttention(nn.Module):
    """q, k, v: (B_, N, C) window tokens -> (B_, N, C)."""

    def __init__(self, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads

    def forward(self, q, k, v, mask=None):
        b_, n, c = q.shape
        nh = self.num_heads
        hd = c // nh
        split = lambda t: t.reshape(b_, n, nh, hd).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, nh, n, n)
            attn = attn + mask.to(attn)[None, :, None]
            attn = attn.reshape(b_, nh, n, n)
        attn = attn / torch.sqrt(torch.tensor(float(hd)))  # after the mask
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        out = torch.matmul(attn, vh.to(q.dtype))
        return out.transpose(1, 2).reshape(b_, n, c)


class CAttentionBlock(nn.Module):
    """Pairwise cross-channel fusion over four NHWC maps (r, g, b, ir)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 window_size: int = 1, shift_size: int = 0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        if not (window_size == 1 and shift_size == 0):
            self.r2g_attn = CAttention(num_heads)
            self.rg2b_attn = CAttention(num_heads)
            self.rgb2ir_attn = CAttention(num_heads)
            self.ir2rgb_attn = CAttention(num_heads)
        for i in range(1, 5):
            setattr(self, f"norm{i}", LayerNorm(embedding_dim))

    def forward(self, r, g, b, ir):
        _, h, w, _ = r.shape
        ws, shift = self.window_size, self.shift_size
        if ws == 1 and shift == 0:
            r_out, g_out, b_out, ir_out = g, b, ir, g
        else:
            def part(x):
                if shift > 0:
                    x = torch.roll(x, (-shift, -shift), (1, 2))
                return window_partition(x, ws)

            def unpart(xw):
                x = window_unpartition(xw, ws, (h, w))
                if shift > 0:
                    x = torch.roll(x, (shift, shift), (1, 2))
                return x

            mask = (torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(
                r.device, non_blocking=True) if shift > 0 else None)
            rw, gw, bw, irw = part(r), part(g), part(b), part(ir)
            r_out = unpart(self.r2g_attn(rw, gw, gw, mask))
            g_out = unpart(self.rg2b_attn(gw, bw, bw, mask))
            b_out = unpart(self.rgb2ir_attn(bw, irw, irw, mask))
            ir_out = unpart(self.ir2rgb_attn(irw, gw, gw, mask))
        return (self.norm1(r + r_out), self.norm2(g + g_out),
                self.norm3(b + b_out), self.norm4(ir + ir_out))
