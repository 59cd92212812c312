"""Swin-block kernels: the megakernels K2 (whole linear block) and K4 (conv
tail with the un-shift, residual and LN2), and the LN-free MLP tails K6
(linear) and K7 (conv).

Counterpart of `sodt_tpu/pallas/swin_block.py`:

  fused_swin_block(x, ...)              = the whole block, linear MLP
  fused_conv_mlp_tail(x, a, ...)        = r + fc2(gelu(conv2x2(pad(fc1(LN2(r))))))
                                          with r = x + roll(a, +shift)
  fused_mlp_tail(r, y, ...)             = r + fc2(gelu(fc1(y)))
  fused_conv_mlp_tail_noln(r, y, ...)   = r + fc2(gelu(conv2x2(pad(fc1(y)))))

For the tails, the caller has already formed r = x + attn_out and
y = LN2(r). Weights use torch's layout: Linear (out, in); the 2x2 conv as
(out, kh, kw, in), the OIHW weight with the input channels last, which is
the layout both conv kernels read (`conv_taps`). Plain versions mirror
`_compose_swin_block` / `_compose_conv_tail` / `_compose_mlp_tail` /
`_compose_conv_tail_noln` with the dtype-dependent `gelu`; the kernels use
the tanh form, as the Pallas kernels do.

On the card every wrapper is a `window_attention.Replay` function: the
forward launches the kernel, the backward replays the plain composition
(`dispatch=True`: its LayerNorms and attention core go through K13 and
K1 -> K9) and differentiates it, as `_fsb_bwd`, `_fct_bwd`, `_fmt_bwd` and
`_fctn_bwd` do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES
from . import _build
from .layernorm import layernorm, layernorm_plain
from .window_attention import (Replay, _check_cuda, _check_window_args,
                               _require, block_attention_ln_plain, gemm_bias)
from ..ops.activations import gelu


# ----------------------------------------------------------- plain versions

def conv_taps(wc: torch.Tensor) -> torch.Tensor:
    """OIHW (out, in, 2, 2) conv weight -> the kernels' (out, 2, 2, in)."""
    return wc.permute(0, 2, 3, 1).contiguous()


def conv2x2_pad_br(f1: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor):
    """NHWC 2x2 VALID conv (OIHW weight) over f1 zero-padded by one row at
    the bottom and one column at the right (the pad goes on fc1's OUTPUT:
    fc1(0) != 0)."""
    dt = f1.dtype
    x = F.pad(f1.permute(0, 3, 1, 2), (0, 1, 0, 1))
    z = F.conv2d(x, wc.to(dt)) + bc.to(dt)[:, None, None]
    return z.permute(0, 2, 3, 1)


def mlp_tail_plain(r, y, w1, b1, w2, b2):
    dt = r.dtype
    f1 = torch.matmul(y, w1.to(dt).t()) + b1.to(dt)
    return r + (torch.matmul(gelu(f1), w2.to(dt).t()) + b2.to(dt))


def conv_mlp_tail_noln_plain(r, y, w1, b1, wc, bc, w2, b2):
    """K7's plain version; wc in the kernels' (out, 2, 2, in) layout."""
    dt = r.dtype
    f1 = torch.matmul(y, w1.to(dt).t()) + b1.to(dt)
    z = conv2x2_pad_br(f1, wc.permute(0, 3, 1, 2), bc)
    return r + (torch.matmul(gelu(z), w2.to(dt).t()) + b2.to(dt))


def swin_block_plain(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1,
                     w2, b2, bias, mask, ws: int, nh: int, scale: float,
                     shift: int = 0, dispatch: bool = False):
    """K2's plain version: `_compose_swin_block` (l.279) on
    roll(x, -shift), rolled back by +shift. `dispatch=True` (a backward's
    replay): the LNs and the attention core go through their kernel
    wrappers."""
    ln = layernorm if dispatch else layernorm_plain
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    res1 = x + block_attention_ln_plain(x, ln1w, ln1b, wqkv, bqkv, wp, bp,
                                        bias, mask, ws, nh, scale,
                                        dispatch=dispatch)
    out = mlp_tail_plain(res1, ln(res1, ln2w, ln2b), w1, b1, w2, b2)
    if shift:
        out = torch.roll(out, (shift, shift), (1, 2))
    return out


def conv_mlp_tail_plain(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                        shift: int = 0, dispatch: bool = False):
    """K4's plain version: `_compose_conv_tail` (l.468) on
    roll(a, (+shift, +shift)); wc in the kernels' (out, 2, 2, in) layout.
    `dispatch=True` (a backward's replay): LN2 goes through K13's wrapper."""
    ln = layernorm if dispatch else layernorm_plain
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    res1 = x + a
    return conv_mlp_tail_noln_plain(res1, ln(res1, ln2w, ln2b), w1, b1, wc,
                                    bc, w2, b2)


# ----------------------------------------------------------------- kernels

def megakernel_supported(c: int, nh: int, ws: int) -> bool:
    """The domain of csrc/swin_block.cu (K2, K3, K4): c <= 256, JAX's own
    gate for its megakernels (at c = 256 K4 takes 224 of the 227 KB of
    shared memory a CTA may have); head dims of whole 16-wide tensor-core
    tiles; windows of at most 64 tokens (one CTA holds a window)."""
    return (c <= 256 and c % 16 == 0 and c % nh == 0
            and (c // nh) % 16 == 0 and ws * ws <= 64)


def fused_swin_block(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1,
                     w2, b2, bias, mask, ws: int, nh: int, scale: float,
                     shift: int = 0):
    """The whole Swin block with the linear MLP, one kernel launch.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_swin_block` (l.294,
    body `_mega_kernel` l.93). x (B, H, W, C) bf16; LN weights (C,) f32;
    wqkv (3C, C), wp (C, C), w1 (hidden, C), w2 (C, hidden) and their
    biases bf16; bias (nh, N, N) f32; mask (nW, N, N) f32 or None. Every
    op after the attention is per token, so the cyclic shift folds into
    the kernel's gather and scatter: a shifted block runs here too (JAX
    sends that case to its XLA composition).

    On the H100 it is bound by operations (24*C^2 FLOPs per token in the
    four projections). Design: one CTA per window
    (csrc/swin_block.cu swin_window_kernel<true>): LN1 reads the window's
    tokens straight from x at their shifted positions; qkv, scores, the
    attention output, the f32 residual, LN2 and the hidden layer stay in
    shared memory, and each weight streams through double-buffered 64x64
    tiles, so only x and the block output touch device memory.
    """
    if not x.is_cuda:
        return swin_block_plain(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b,
                                w1, b1, w2, b2, bias, mask, ws, nh, scale,
                                shift)
    name = "fused_swin_block"
    b, h, w, c = x.shape
    hid = w1.shape[0]
    _check_cuda(name, torch.bfloat16, x=x, wqkv=wqkv, bqkv=bqkv, wp=wp, bp=bp,
                w1=w1, b1=b1, w2=w2, b2=b2)
    _check_cuda(name, torch.float32, ln1w=ln1w, ln1b=ln1b, ln2w=ln2w,
                ln2b=ln2b, bias=bias, mask=mask)
    _require(megakernel_supported(c, nh, ws) and hid % 64 == 0
             and hid <= 4 * c, f"{name}: C={c}, hidden={hid}, nh={nh}, "
             f"window {ws}")
    _require(tuple(wqkv.shape) == (3 * c, c) and tuple(wp.shape) == (c, c)
             and tuple(w1.shape) == (hid, c) and tuple(w2.shape) == (c, hid),
             f"{name}: weight shapes")
    _check_window_args(name, b, h, w, nh, ws, bias, mask, shift)
    return Replay.apply(_launch_swin_block, _compose_swin_block,
                        (ws, nh, scale, shift), x, ln1w, ln1b, wqkv, bqkv, wp,
                        bp, ln2w, ln2b, w1, b1, w2, b2, bias, mask)


def _compose_swin_block(*args):
    return swin_block_plain(*args, dispatch=True)


def _launch_swin_block(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1,
                       w2, b2, bias, mask, ws, nh, scale, shift):
    b, h, w, c = x.shape
    hid = w1.shape[0]
    out = torch.empty_like(x)
    scale_dt = float(torch.tensor(scale, dtype=x.dtype))
    _build.check(_build.library().sodt_swin_block(
        x.data_ptr(), ln1w.data_ptr(), ln1b.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wp.data_ptr(), bp.data_ptr(), ln2w.data_ptr(),
        ln2b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, h, w, c, hid, nh, ws, shift, int(mask is not None), scale_dt,
        _build.stream_ptr()), "fused_swin_block")
    LAUNCHES["swin_block"] += 1
    return out


def fused_conv_mlp_tail(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                        shift: int = 0):
    """Un-shift + residual + LN2 + fc1 + 2x2 conv + GELU + fc2 + residual.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_conv_mlp_tail` (l.482,
    body `_conv_tail_kernel` l.329). x (B, H, W, C) bf16, the block input;
    a (B, H, W, C) bf16, K3's output in SHIFTED coordinates, read at
    (i - shift, j - shift); LN2 weights (C,) f32; w1, w2 (C, C), wc
    (C, 2, 2, C) and the biases bf16.

    On the H100 it is bound by operations (12*C^2 FLOPs per token in fc1,
    the four conv taps and fc2). Design: one CTA per 4 x 16 output pixels
    (csrc/swin_block.cu conv_tail_kernel) forms res1 and LN2 on the
    5 x 17 halo, runs fc1 there and zeroes it outside the map (the pad on
    fc1's OUTPUT), then runs the conv as one GEMM with K = 4C whose A rows
    are the halo rows shifted by each tap, and fc2 with the residual: only
    x, a and the output touch device memory.
    """
    if not x.is_cuda:
        return conv_mlp_tail_plain(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                                   shift)
    name = "fused_conv_mlp_tail"
    b, h, w, c = x.shape
    _check_cuda(name, torch.bfloat16, x=x, a=a, w1=w1, b1=b1, wc=wc, bc=bc,
                w2=w2, b2=b2)
    _check_cuda(name, torch.float32, ln2w=ln2w, ln2b=ln2b)
    _require(a.shape == x.shape, f"{name}: x/a shapes")
    _require(c <= 256 and c % 16 == 0, f"{name}: C={c}")
    _require(tuple(w1.shape) == (c, c) and tuple(w2.shape) == (c, c)
             and tuple(wc.shape) == (c, 2, 2, c), f"{name}: weight shapes")
    _require(0 <= shift < min(h, w), f"{name}: shift {shift}")
    return Replay.apply(_launch_conv_tail, _compose_conv_tail, (shift,), x, a,
                        ln2w, ln2b, w1, b1, wc, bc, w2, b2)


def _compose_conv_tail(*args):
    return conv_mlp_tail_plain(*args, dispatch=True)


def _launch_conv_tail(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2, shift):
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    _build.check(_build.library().sodt_conv_tail(
        x.data_ptr(), a.data_ptr(), ln2w.data_ptr(), ln2b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), wc.data_ptr(), bc.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), b, h, w, c, shift,
        _build.stream_ptr()), "fused_conv_mlp_tail")
    LAUNCHES["conv_mlp_tail"] += 1
    return out


def _mlp2(a, w1, b1, w2, b2, r, taps: int):
    """Launch the fused GEMM -> tanh-GELU -> GEMM (+ residual) kernel of
    csrc/common.cuh: one tap for K6 (`sodt_mlp_tail`), four for K7
    (`sodt_conv_mlp_tail`, the 2x2 conv's shifted rows of `a` with the
    bottom/right zero pad)."""
    b, h, w, k = a.shape
    hid = w1.shape[0]
    n = w2.shape[0]
    out = torch.empty_like(r)
    lib = _build.library()
    fn = lib.sodt_mlp_tail if taps == 1 else lib.sodt_conv_mlp_tail
    _build.check(fn(a.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), r.data_ptr(), out.data_ptr(), b, h, w, k,
                    hid, n, _build.stream_ptr()), "mlp tail")
    return out


def fused_mlp_tail(r, y, w1, b1, w2, b2):
    """r + fc2(tanh-GELU(fc1(y))), y already normed.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_mlp_tail` (l.598, body
    `_mlp_tail_kernel` l.544). r, y (B, H, W, C) bf16; w1 (hidden, C);
    w2 (C, hidden).

    On the H100 it is bound by operations (4*C*hidden FLOPs per token
    against 4*C bytes of activations). Design: one CTA per 32 tokens keeps
    its y rows and the whole bf16 hidden row block in shared memory, so
    the (M, hidden) activation never reaches device memory; both GEMMs run
    on the tensor cores (wmma bf16, f32 accumulation) with bias, GELU and
    the residual folded into their epilogues.
    """
    if not r.is_cuda:
        return mlp_tail_plain(r, y, w1, b1, w2, b2)
    name = "fused_mlp_tail"
    c = r.shape[-1]
    hid = w1.shape[0]
    _check_cuda(name, torch.bfloat16, r=r, y=y, w1=w1, b1=b1, w2=w2, b2=b2)
    _require(y.shape == r.shape, f"{name}: r/y shapes")
    _require(tuple(w1.shape) == (hid, c) and tuple(w2.shape) == (c, hid),
             f"{name}: weight shapes")
    _require(c % 16 == 0 and hid % 16 == 0 and hid <= 2048 and c <= 1024,
             f"{name}: C={c}, hidden={hid}")
    return Replay.apply(_launch_mlp_tail, mlp_tail_plain, (), r, y, w1, b1,
                        w2, b2)


def _launch_mlp_tail(r, y, w1, b1, w2, b2):
    out = _mlp2(y, w1, b1, w2, b2, r, taps=1)
    LAUNCHES["mlp_tail"] += 1
    return out


def fused_conv_mlp_tail_noln(r, y, w1, b1, wc, bc, w2, b2):
    """r + fc2(tanh-GELU(conv2x2(pad_br(fc1(y))))), y already normed.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_conv_mlp_tail_noln`
    (l.691, body `_conv_tail_noln_kernel` l.622 + `_conv_gelu_fc2` l.374).
    r, y (B, H, W, C) bf16; w1, w2 (C, C); wc (C, 2, 2, C).

    On the H100 it is bound by operations (the four conv taps are four
    C x C GEMMs). Design: fc1 runs as the GEMM kernel and writes f1 in
    bf16 (the Pallas kernel rounds f1 to bf16 before the conv too); the
    fused kernel then gathers, for 32 tokens, the four shifted f1 rows of
    the 2x2 taps into shared memory — a tap that falls below the last row
    or right of the last column reads zeros, which is the bottom/right pad
    of fc1's output (the TPU kernel's zeroed last-strip halo) — and runs
    conv -> GELU -> fc2 + residual without the conv output reaching device
    memory.
    """
    if not r.is_cuda:
        return conv_mlp_tail_noln_plain(r, y, w1, b1, wc, bc, w2, b2)
    name = "fused_conv_mlp_tail_noln"
    c = r.shape[-1]
    _check_cuda(name, torch.bfloat16, r=r, y=y, w1=w1, b1=b1, wc=wc, bc=bc,
                w2=w2, b2=b2)
    _require(y.shape == r.shape, f"{name}: r/y shapes")
    _require(tuple(w1.shape) == (c, c) and tuple(w2.shape) == (c, c)
             and tuple(wc.shape) == (c, 2, 2, c), f"{name}: weight shapes")
    _require(c % 16 == 0 and c <= 512, f"{name}: C={c}")
    return Replay.apply(_launch_conv_tail_noln, conv_mlp_tail_noln_plain, (),
                        r, y, w1, b1, wc, bc, w2, b2)


def _launch_conv_tail_noln(r, y, w1, b1, wc, bc, w2, b2):
    f1 = gemm_bias(y, w1, b1)
    out = _mlp2(f1, wc, bc, w2, b2, r, taps=4)
    LAUNCHES["conv_mlp_tail_noln"] += 1
    return out
