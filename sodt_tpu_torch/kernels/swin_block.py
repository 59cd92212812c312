"""Swin-block kernels: K2 (the whole linear block) and K4 (the conv tail
with the un-shift, residual and LN2), each a chain of launches, and the
LN-free MLP tails K6 (linear) and K7 (conv).

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
from .quant import (_q8, _q8_deq, _q8_point, _scale, conv_gelu_fc2_q8,
                    fc1_halo_q8, gelu_tanh, ln_f32, log_kernel_amax, q8_dot,
                    q8_weights, tail_ws, to_strips)
from .window_attention import (Replay, _check_cuda, _check_window_args,
                               _require, attention_fwd_mirror,
                               block_attention_ln_plain, fwd_groups,
                               reference_attention_nhwc,
                               window_attention_core_nhwc,
                               window_core_supported)
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


def conv2x2_taps_gemm_plain(f1, taps, bc):
    """`conv2x2_pad_br` as one GEMM, the way K7's conv launch computes it:
    for each token the (kh, kw, in)-ordered 4C-vector of its 2x2 window of
    f1 zero-padded at the bottom and right, times taps (out, 2, 2, in)
    viewed as (C, 4C), plus bc."""
    dt = f1.dtype
    b, h, w, c = f1.shape
    x = F.pad(f1, (0, 0, 0, 1, 0, 1))
    cols = torch.cat([x[:, di:di + h, dj:dj + w] for di in (0, 1)
                      for dj in (0, 1)], -1)
    return (torch.matmul(cols, taps.to(dt).reshape(taps.shape[0], 4 * c).t())
            + bc.to(dt))


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


def swin_block_chain_plain(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1,
                           b1, w2, b2, bias, mask, ws: int, nh: int,
                           scale: float, shift: int = 0,
                           res1_rounded: bool = False):
    """The plain mirror of K2's chain (csrc/swin_block_chain.cu), each launch
    in f32 with the kernel's rounding points made explicit, in map order:
    ln1 = bf16(LN(x)); qkv = bf16(ln1 Wqkv^T + bqkv); the attention core
    as `attention_fwd_mirror` rounds it, on the windows of the map rolled
    by -shift, its output rolled back; res1 = x + (attn Wp^T + bp) in f32,
    never rounded; ln2 = bf16(LN(res1)); h1 = bf16(gelu_tanh(ln2 W1^T +
    b1)); out = bf16(res1 + (h1 W2^T + b2)). Returns (B, H, W, C) f32.
    `res1_rounded` rounds res1 to bf16 (the control a check of the f32
    residual must tell apart)."""
    rnd = lambda z: z.to(torch.bfloat16).float()
    lin = lambda z, w, b: torch.matmul(z, w.float().t()) + b.float()
    x = x.float()
    qkv = rnd(lin(rnd(ln_f32(x, ln1w, ln1b)), wqkv, bqkv))
    attn = attention_fwd_mirror(qkv, bias, mask, ws, nh, scale, shift)
    if shift:
        attn = torch.roll(attn, (shift, shift), (1, 2))
    res1 = x + lin(attn, wp, bp)
    if res1_rounded:
        res1 = rnd(res1)
    h1 = rnd(gelu_tanh(lin(rnd(ln_f32(res1, ln2w, ln2b)), w1, b1)))
    return rnd(res1 + lin(h1, w2, b2))


def conv_tail_chain_plain(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                          shift: int = 0, res1_rounded: bool = False):
    """The plain mirror of K4's chain (csrc/shifted_block_chain.cu), each
    launch in f32 with the kernel's rounding points made explicit: res1 =
    x + roll(a, (+shift, +shift)) in f32, never rounded; t = bf16(LN(res1));
    f1 = bf16(t W1^T + b1); z = bf16(gelu_tanh(conv2x2(f1) + bc)) with f1
    zero-padded at the bottom and right (`conv2x2_taps_gemm_plain`, the
    conv launch's gather); out = bf16(res1 + (z W2^T + b2)). wc in the
    kernels' (out, 2, 2, in) layout. Returns (B, H, W, C) f32.
    `res1_rounded` rounds res1 to bf16 (the control a check of the f32
    residual must tell apart)."""
    rnd = lambda z: z.to(torch.bfloat16).float()
    lin = lambda z, w, b: torch.matmul(z, w.float().t()) + b.float()
    a = a.float()
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    res1 = x.float() + a
    if res1_rounded:
        res1 = rnd(res1)
    f1 = rnd(lin(rnd(ln_f32(res1, ln2w, ln2b)), w1, b1))
    z = rnd(gelu_tanh(conv2x2_taps_gemm_plain(f1, wc.float(), bc.float())))
    return rnd(res1 + lin(z, w2, b2))


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


# ------------------------------------------------- plain int8 bodies (K12)
#
# From the `int8=True` Pallas bodies line by line, with their rounding
# points (`quant` has the quantizers). Each takes its bf16 plain version's
# arguments (its kernel launcher's too) with `q8`: the int8 weights and
# their scales by name, or None to quantize the given weights here.
# `dispatch=True` sends the attention core through its kernel wrapper (K1
# on the card, which the int8 kernels run as their core), so a kernel can
# be held against its plain int8 version with no other difference than the
# int8 arithmetic.

def swin_block_q8_plain(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1,
                        b1, w2, b2, bias, mask, ws: int, nh: int,
                        scale: float, shift: int = 0, q8=None,
                        dispatch: bool = False):
    """`_mega_q8_kernel` (l.158), the unshifted block only (JAX's gate):
    LN1 in f32 -> `_q8_dot` + bqkv -> working dtype -> attention core ->
    f32 -> res1 = x + `_q8_dot` + bp (f32) -> LN2 (f32) -> `_q8_dot` + b1
    -> tanh GELU (f32) -> out = res1 + `_q8_dot` + b2, per strip of ws
    rows."""
    _require(shift == 0 and mask is None, "swin_block int8: JAX quantizes "
             f"only the unshifted linear block (shift {shift})")
    qw = q8_weights(q8, wqkv=wqkv, wp=wp, w1=w1, w2=w2)
    b, h, w, c = x.shape
    dt = x.dtype
    x32 = to_strips(x.float(), ws)
    qkv = (q8_dot(ln_f32(x32, ln1w, ln1b), *qw["wqkv"])
           + bqkv.float()).to(dt)
    core = window_attention_core_nhwc if dispatch else reference_attention_nhwc
    attn = core(qkv.reshape(b, h, w, 3 * c), bias, None, ws, nh, scale)
    res1 = x32 + q8_dot(to_strips(attn.float(), ws), *qw["wp"]) + bp.float()
    h1 = gelu_tanh(q8_dot(ln_f32(res1, ln2w, ln2b), *qw["w1"]) + b1.float())
    out = res1 + q8_dot(h1, *qw["w2"]) + b2.float()
    return out.reshape(b, h, w, c).to(dt)


def conv_tail_halo_rows(h: int, ws: int, shift: int) -> tuple[list, list]:
    """The rows the conv tail's halo of each strip of ws rows reads: x's
    row min(r + 1, nr - 1) * ws (the clamped `nxt` BlockSpec), and the
    row of the UNSHIFTED attention output: the same row without a shift,
    row (r + 1) * ws mod H with one (the Pallas kernel takes it from the
    current strip's shifted rows, l.341-347). The two differ on the last
    strip when shift > 0, a property of the reference the int8 body keeps:
    the fc1 scale covers that row, whose fc1 output is then zeroed."""
    nr = h // ws
    nxt = [min(r + 1, nr - 1) * ws for r in range(nr)]
    return nxt, ([(r + 1) * ws % h for r in range(nr)] if shift else nxt)


def conv_mlp_tail_q8_plain(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                           shift: int = 0, q8=None):
    """`_conv_tail_kernel` with s1 / sc / s2 (l.329), strips of
    `tail_ws(H)` rows: res1 = x + roll(a, +shift) in f32; LN2 (f32) of
    the strip and its halo row; fc1 as `_q8_dot` over both (halo zeroed on
    the last strip); the 2x2 conv, GELU and fc2 (`conv_gelu_fc2_q8`); out
    = res1 + that. wc in the kernels' (out, 2, 2, in) layout."""
    qw = q8_weights(q8, w1=w1, wc=wc, w2=w2)
    b, h, w, c = x.shape
    ws = tail_ws(h)
    a_un = torch.roll(a, (shift, shift), (1, 2)) if shift else a
    res1 = to_strips(x.float() + a_un.float(), ws)
    x_rows, a_rows = conv_tail_halo_rows(h, ws, shift)
    halo = x[:, x_rows].float() + a_un[:, a_rows].float()
    t = ln_f32(torch.cat([res1, halo], dim=2), ln2w, ln2b)
    f1 = fc1_halo_q8(t, ws, w, qw["w1"], b1)
    z = conv_gelu_fc2_q8(f1, ws, w, *qw["wc"], bc, *qw["w2"], b2)
    return (res1 + z).reshape(b, h, w, c).to(x.dtype)


def mlp_tail_q8_plain(r, y, w1, b1, w2, b2, q8=None):
    """`_mlp_tail_kernel` with s1 / s2 (l.544), strips of `tail_ws(H)`
    rows: y -> f32 -> `_q8_dot` + b1 -> tanh GELU (f32) -> `_q8_dot` + b2;
    out = r + that."""
    qw = q8_weights(q8, w1=w1, w2=w2)
    ws = tail_ws(r.shape[1])
    f1 = q8_dot(to_strips(y.float(), ws), *qw["w1"]) + b1.float()
    z = q8_dot(gelu_tanh(f1), *qw["w2"]) + b2.float()
    return (to_strips(r.float(), ws) + z).reshape(r.shape).to(r.dtype)


def conv_mlp_tail_noln_q8_plain(r, y, w1, b1, wc, bc, w2, b2, q8=None):
    """`_conv_tail_noln_kernel` with s1 / sc / s2 (l.622): fc1 as
    `_q8_dot` over each strip of y and its halo row (the next strip's
    first row, clamped; zeroed after fc1 on the last strip), then the conv
    tail as K4's; out = r + that."""
    qw = q8_weights(q8, w1=w1, wc=wc, w2=w2)
    b, h, w, c = r.shape
    ws = tail_ws(h)
    x_rows, _ = conv_tail_halo_rows(h, ws, 0)
    t = torch.cat([to_strips(y, ws), y[:, x_rows]], dim=2).float()
    f1 = fc1_halo_q8(t, ws, w, qw["w1"], b1)
    z = conv_gelu_fc2_q8(f1, ws, w, *qw["wc"], bc, *qw["w2"], b2)
    return (to_strips(r.float(), ws) + z).reshape(b, h, w, c).to(r.dtype)


# --------------------------------- mirrors of K12's chains (tests only)
#
# csrc/int8_chains.cu launch by launch: rows in the chain's own layout (M
# map rows, then the conv tails' halo rows, one map row a strip, in strip
# order), one abs-max slot a strip (`quant._q8_point`: the fold, then the
# int8 codes under the finished scale), products of int8 codes, the conv as the
# core's gather over f1's codes. Each is bit-equal to its plain int8 body
# on the CPU (the tests hold them so), and logs its slots as a kernel does.

def swin_block_q8_chain_plain(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b,
                              w1, b1, w2, b2, bias, mask, ws: int, nh: int,
                              scale: float, shift: int = 0, q8=None,
                              dispatch: bool = False):
    """The mirror of `sodt_swin_block_q8`: LN1 fold / codes, qkv, the
    core, att fold / codes, proj (f32 res1), LN2 fold / codes, fc1 fold /
    codes, fc2; strips of ws map rows over the (M, C) rows."""
    _require(shift == 0 and mask is None, "swin_block int8: JAX quantizes "
             f"only the unshifted linear block (shift {shift})")
    qw = q8_weights(q8, wqkv=wqkv, wp=wp, w1=w1, w2=w2)
    b, h, w, c = x.shape
    m, s = b * h * w, b * (h // ws)
    strip = torch.arange(m, device=x.device) // (ws * w)
    x32 = x.float().reshape(m, c)
    slots = []

    def point(v):
        codes, sl = _q8_point(v, strip, s)
        slots.append(sl)
        return codes, sl

    ln1 = point(ln_f32(x32, ln1w, ln1b))
    qkv = (_q8_deq(ln1[0], *qw["wqkv"], ln1[1], strip)
           + bqkv.float()).to(x.dtype)
    core = window_attention_core_nhwc if dispatch else reference_attention_nhwc
    att = core(qkv.reshape(b, h, w, 3 * c), bias, None, ws, nh, scale)
    att = point(att.float().reshape(m, c))
    res1 = x32 + _q8_deq(att[0], *qw["wp"], att[1], strip) + bp.float()
    ln2 = point(ln_f32(res1, ln2w, ln2b))
    hid = point(gelu_tanh(_q8_deq(ln2[0], *qw["w1"], ln2[1], strip)
                          + b1.float()))
    out = res1 + _q8_deq(hid[0], *qw["w2"], hid[1], strip) + b2.float()
    log_kernel_amax(torch.cat(slots), len(slots))
    return out.reshape(b, h, w, c).to(x.dtype)


def mlp_tail_q8_chain_plain(r, y, w1, b1, w2, b2, q8=None):
    """The mirror of `sodt_mlp_tail_q8`: y fold / codes, fc1's
    tanh-GELU(v + b1) fold / codes, fc2 with the residual r + (v + b2);
    strips of `tail_ws(H)` map rows over the (M, C) rows."""
    qw = q8_weights(q8, w1=w1, w2=w2)
    b, h, w, c = r.shape
    ws = tail_ws(h)
    m, s = b * h * w, b * (h // ws)
    strip = torch.arange(m, device=r.device) // (ws * w)
    slots = []

    def point(v):
        codes, sl = _q8_point(v, strip, s)
        slots.append(sl)
        return codes, sl

    yq = point(y.float().reshape(m, c))
    hid = point(gelu_tanh(_q8_deq(yq[0], *qw["w1"], yq[1], strip)
                          + b1.float()))
    out = (r.float().reshape(m, c)
           + (_q8_deq(hid[0], *qw["w2"], hid[1], strip) + b2.float()))
    log_kernel_amax(torch.cat(slots), len(slots))
    return out.reshape(b, h, w, c).to(r.dtype)


def conv_gather_codes(f1: torch.Tensor, b: int, h: int, w: int,
                      ws: int) -> torch.Tensor:
    """The conv launch's A: for each of the M = b*h*w tokens (i, j) the
    (kh, kw, in)-ordered 4C codes of its 2x2 window over f1's codes (M map
    rows, then a halo row a strip): tap (di, dj) reads row i + di, column
    j + dj; below the last row of the strip that is the strip's halo row,
    right of the last column a zero (`GsCopy` with GS_CONV2X2)."""
    m, c = b * h * w, f1.shape[-1]
    tok = torch.arange(m, device=f1.device)
    j, i, bi = tok % w, (tok // w) % h, tok // (w * h)
    below = torch.where(i % ws == ws - 1,
                        m + (bi * (h // ws) + i // ws) * w + j, tok + w)
    taps = []
    for di in (0, 1):
        for dj in (0, 1):
            row = (below if di else tok) + dj
            ok = (j + dj < w)[:, None]
            taps.append(torch.where(ok, f1[row.clamp(max=f1.shape[0] - 1)],
                                    torch.zeros_like(f1[:1])))
    return torch.cat(taps, -1).reshape(m, 4 * c)


def _conv_tail_q8_chain(x, a, ln, w1, b1, wc, bc, w2, b2, shift, q8):
    """The mirror of `sodt_conv_tail_q8`: the LN (or y) over the map rows
    and the halo rows, fold / codes; fc1 (halo rows of an image's last
    strip zeroed) fold / codes; the conv over f1's codes fold / codes; fc2
    with the residual."""
    qw = q8_weights(q8, w1=w1, wc=wc, w2=w2)
    b, h, w, c = x.shape
    ws = tail_ws(h)
    nr = h // ws
    m, s = b * h * w, b * nr
    rows = torch.arange(m + s * w, device=x.device)
    strip = torch.where(rows < m, rows // (ws * w), (rows - m) // w)
    # the halo row of strip r: x's row min(r + 1, nr - 1) * ws, and with a
    # shift a's un-shifted row (r + 1) * ws mod H (`ConvTailIn`)
    nxt = [min(r + 1, nr - 1) * ws for r in range(nr)]
    a_nxt = [(r + 1) * ws % h for r in range(nr)] if shift else nxt
    if ln is not None:
        a_un = torch.roll(a, (shift, shift), (1, 2)) if shift else a
        res = x.float() + a_un.float()
        halo = x[:, nxt].float() + a_un[:, a_nxt].float()
    else:
        res, halo = x.float(), a[:, nxt].float()
    t = torch.cat([(a.float() if ln is None else res).reshape(m, c),
                   halo.reshape(s * w, c)])
    slots = []

    def point(v, st):
        codes, sl = _q8_point(v, st, s)
        slots.append(sl)
        return codes, sl

    t = point(ln_f32(t, *ln) if ln is not None else t, strip)
    f1 = _q8_deq(t[0], *qw["w1"], t[1], strip) + b1.float()
    last = (rows >= m) & (((rows - m) // w) % nr == nr - 1)
    f1 = point(torch.where(last[:, None], torch.zeros_like(f1), f1), strip)
    main = strip[:m]
    wcq, sc = qw["wc"]
    y = point(gelu_tanh(_q8_deq(conv_gather_codes(f1[0], b, h, w, ws),
                                wcq.reshape(c, 4 * c), sc, f1[1], main)
                        + bc.float()), main)
    out = (res.reshape(m, c)
           + (_q8_deq(y[0], *qw["w2"], y[1], main) + b2.float()))
    log_kernel_amax(torch.cat(slots), len(slots))
    return out.reshape(b, h, w, c).to(x.dtype)


def conv_mlp_tail_q8_chain_plain(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                                 shift: int = 0, q8=None):
    """K4's twin as `sodt_conv_tail_q8` runs it (`_conv_tail_q8_chain`)."""
    return _conv_tail_q8_chain(x, a, (ln2w, ln2b), w1, b1, wc, bc, w2, b2,
                               shift, q8)


def conv_mlp_tail_noln_q8_chain_plain(r, y, w1, b1, wc, bc, w2, b2, q8=None):
    """K7's twin as `sodt_conv_tail_q8` runs it (`_conv_tail_q8_chain`)."""
    return _conv_tail_q8_chain(r, y, None, w1, b1, wc, bc, w2, b2, 0, q8)


# ----------------------------------------------------------------- kernels

def megakernel_supported(c: int, nh: int, ws: int) -> bool:
    """The domain of K2, K3 and K4 (csrc/swin_block_chain.cu,
    csrc/shifted_block_chain.cu, and csrc/swin_block.cu at head dims above
    64): c <= 256, JAX's own gate for its megakernels; head dims of whole
    16-wide tensor-core tiles; windows of at most 64 tokens (one CTA of
    swin_block.cu holds a window, the register attention core takes at
    most 64 tokens)."""
    return (c <= 256 and c % 16 == 0 and c % nh == 0
            and (c // nh) % 16 == 0 and ws * ws <= 64)


def swin_block_body(c: int, nh: int, ws: int) -> str:
    """K2's and K3's body for a block of width c, nh heads and window ws
    (inside `megakernel_supported`): "chain" at head dims of at most 64
    (every configuration of the repo: the launches of
    csrc/swin_block_chain.cu, K2, or csrc/shifted_block_chain.cu, K3, on
    the wgmma GEMM core and the forward's register attention core) or
    "window" above (swin_window_kernel<true> / <false> of
    csrc/swin_block.cu, one CTA per window). K4's chain takes every
    width."""
    return "chain" if c // nh <= 64 else "window"


def fused_swin_block(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1,
                     w2, b2, bias, mask, ws: int, nh: int, scale: float,
                     shift: int = 0, int8: bool = False, q8=None):
    """The whole Swin block with the linear MLP, one counted launch.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_swin_block` (l.294,
    body `_mega_kernel` l.93). x (B, H, W, C) bf16; LN weights (C,) f32;
    wqkv (3C, C), wp (C, C), w1 (hidden, C), w2 (C, hidden) and their
    biases bf16; bias (nh, N, N) f32; mask (nW, N, N) f32 or None. Every
    op after the attention is per token, so the cyclic shift folds into
    the kernel's gather and scatter: a shifted block runs here too (JAX
    sends that case to its XLA composition).

    Two bodies, chosen by `swin_block_body`:
    - head dim <= 64 (every configuration): a chain of seven launches
      from one C entry (csrc/swin_block_chain.cu), all in map order:
      K13's LN body on x; qkv on the wgmma GEMM core (+ bqkv); the
      forward's register attention core, which at a shift reads and
      writes each token at ((r + s) mod H, (c + s) mod W), so no roll is
      materialized; the projection with res1 = x + (. + bp) written in
      f32; LN over the f32 res1; fc1 + tanh GELU; fc2 + the f32 res1,
      rounded once. At the flagship's stage 1 it is bound by bytes (qkv,
      the hidden and the f32 res1 through device memory: ~0.7 GB a call
      at batch 4 against 58 GFLOP). `swin_block_chain_plain` mirrors its
      rounding points; the scratch (ln / attention / ln2 in one bf16
      buffer, qkv / the hidden in another, res1 in f32) is allocated
      here.
    - head dim > 64: one CTA per window (csrc/swin_block.cu
      swin_window_kernel<true>): LN1 reads the window's tokens straight
      from x at their shifted positions; qkv, scores, the attention
      output, the f32 residual, LN2 and the hidden layer stay in shared
      memory, and each weight streams through double-buffered 64x64
      tiles, so only x and the block output touch device memory.

    int8=True: K12's twin of this body (`swin_block_q8_plain` says what it
    computes; `q8` the quantized weights, else quantized here), for the
    unshifted block only, as JAX's gate has it: see `_swin_block_q8`.
    """
    if int8:
        return _swin_block_q8(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b,
                              w1, b1, w2, b2, bias, mask, ws, nh, scale, shift,
                              q8)
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
    ptrs = [t.data_ptr() for t in (x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w,
                                   ln2b, w1, b1, w2, b2, bias)]
    ptrs += [None if mask is None else mask.data_ptr(), out.data_ptr()]
    lib = _build.library()
    if swin_block_body(c, nh, ws) == "chain":
        # the chain's launches move 16-byte pieces of every operand
        _require(all(p % 16 == 0 for p in ptrs if p is not None),
                 "fused_swin_block: operands must be 16-byte aligned")
        m = b * h * w
        ln = torch.empty((m, c), dtype=x.dtype, device=x.device)
        wide = torch.empty((m, max(3 * c, hid)), dtype=x.dtype,
                           device=x.device)
        res1 = torch.empty((m, c), dtype=torch.float32, device=x.device)
        groups = fwd_groups(b * (h // ws) * (w // ws), ws * ws, nh)
        err = lib.sodt_swin_block_chain(
            *ptrs, ln.data_ptr(), wide.data_ptr(), res1.data_ptr(), b, h, w,
            c, hid, nh, ws, shift, int(mask is not None), scale_dt, groups,
            _build.stream_ptr())
    else:
        err = lib.sodt_swin_block(
            *ptrs, b, h, w, c, hid, nh, ws, shift, int(mask is not None),
            scale_dt, _build.stream_ptr())
    _build.check(err, "fused_swin_block")
    LAUNCHES["swin_block"] += 1
    return out


def fused_conv_mlp_tail(x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                        shift: int = 0, int8: bool = False, q8=None):
    """Un-shift + residual + LN2 + fc1 + 2x2 conv + GELU + fc2 + residual.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_conv_mlp_tail` (l.482,
    body `_conv_tail_kernel` l.329). x (B, H, W, C) bf16, the block input;
    a (B, H, W, C) bf16, K3's output in SHIFTED coordinates, read at
    (i - shift, j - shift); LN2 weights (C,) f32; w1, w2 (C, C), wc
    (C, 2, 2, C) and the biases bf16.

    Design: a chain of four launches from one C entry
    (csrc/shifted_block_chain.cu), all in map order: one per-token pass
    forms res1 = x + a read at ((i - shift) mod H, (j - shift) mod W) in
    f32, writes it in f32 and writes LN2(res1) in bf16 (csrc/layernorm.cu);
    fc1 (+ b1) on the wgmma GEMM core writes f1 in bf16; the 2x2 conv as
    one GEMM with K = 4C over f1's gathered 2x2 window, a tap below the
    last row or right of the last column reading zeros (the pad on fc1's
    OUTPUT, JAX's zeroed last-strip halo), + bc and the tanh GELU; fc2 +
    b2 + the f32 res1, rounded once. At the flagship's stage 1 it is bound
    by bytes (~0.33 GB a call at batch 4 against 29 GFLOP).
    `conv_tail_chain_plain` mirrors its rounding points; the scratch (res1
    in f32; LN2, then z; f1) is allocated here.

    int8=True: K12's twin (`conv_mlp_tail_q8_plain`; `_conv_tail_q8`).
    """
    if int8:
        return _conv_tail_q8(x, a, (ln2w, ln2b), w1, b1, wc, bc, w2, b2,
                             shift, q8)
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
    ptrs = [t.data_ptr() for t in (x, a, ln2w, ln2b, w1, b1, wc, bc, w2, b2,
                                   out)]
    # the chain's launches move 16-byte pieces of every operand
    _require(all(p % 16 == 0 for p in ptrs),
             "fused_conv_mlp_tail: operands must be 16-byte aligned")
    m = b * h * w
    res1 = torch.empty((m, c), dtype=torch.float32, device=x.device)
    t, f1 = (torch.empty((m, c), dtype=x.dtype, device=x.device)
             for _ in range(2))
    _build.check(_build.library().sodt_conv_tail_chain(
        *ptrs, res1.data_ptr(), t.data_ptr(), f1.data_ptr(), b, h, w, c,
        shift, _build.stream_ptr()), "fused_conv_mlp_tail")
    LAUNCHES["conv_mlp_tail"] += 1
    return out


# The GEMM core of K6 and K7 (csrc/gemm_core.cuh): one launch computes
# bf16(epi(A . W^T + b)) with one of these epilogues (and, for GEMM_CONV,
# A gathered from the 2x2 conv's taps over a (B, H, W, C) map)
GEMM_GELU, GEMM_BIAS, GEMM_RESIDUAL, GEMM_CONV = range(4)


def gemm_core_plain(a, w, b, mode: int, r=None):
    """The plain version of one launch of the GEMM core: `a @ w^T + b` with
    the dtype-dependent GELU (GEMM_GELU), nothing (GEMM_BIAS) or `+ r`
    (GEMM_RESIDUAL) after it; GEMM_CONV is `gelu(conv2x2_taps_gemm_plain)`
    with w the (out, 2, 2, in) conv weight."""
    dt = a.dtype
    if mode == GEMM_CONV:
        return gelu(conv2x2_taps_gemm_plain(a, w, b))
    z = torch.matmul(a, w.to(dt).t()) + b.to(dt)
    if mode == GEMM_GELU:
        return gelu(z)
    return z + r if mode == GEMM_RESIDUAL else z


def gemm_core(a, w, b, mode: int, r=None):
    """One launch of the GEMM core of K6 and K7 on the card (its plain
    version for a CPU tensor). a (..., K), or for GEMM_CONV the map f1
    (B, H, W, C); w (N, K) or the conv weight (N, 2, 2, C); b (N,); r
    (..., N) for GEMM_RESIDUAL. Returns (..., N) bf16. Not a counted
    kernel of its own: K6 and K7 count one launch per call. The checks
    build their messages only on failure: a K6 call is short enough on the
    card that the Python around it shows in its time."""
    if not a.is_cuda:
        return gemm_core_plain(a, w, b, mode, r)
    _check_cuda("gemm_core", torch.bfloat16, a=a, w=w, b=b, r=r)
    k = a.shape[-1]
    n = w.shape[0]
    m = a.numel() // k
    h = wd = 0
    if mode == GEMM_CONV:
        ok = a.dim() == 4 and w.shape == (n, 2, 2, k)
        h, wd = a.shape[1], a.shape[2]
        k = 4 * k
    else:
        ok = w.shape == (n, k)
    # the kernel moves 16-byte chunks: K, N and every address a multiple
    ok = (ok and b.shape == (n,) and k % 8 == 0 and n % 8 == 0 and m > 0
          and (m + 127) // 128 <= 65535
          and (mode != GEMM_RESIDUAL
               or (r is not None and r.shape == a.shape[:-1] + (n,)))
          and all(t.data_ptr() % 16 == 0 for t in (a, w, b, r)
                  if t is not None))
    if not ok:
        raise ValueError(
            f"gemm_core: a {tuple(a.shape)}, w {tuple(w.shape)}, b "
            f"{tuple(b.shape)}, r {None if r is None else tuple(r.shape)}, "
            f"mode {mode}: shapes, multiples of 8 or 16-byte alignment")
    out = torch.empty(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    _build.check(_build.library().sodt_gemm_core(
        a.data_ptr(), w.data_ptr(), b.data_ptr(),
        r.data_ptr() if r is not None else None, out.data_ptr(), m, n, k, h,
        wd, mode, _build.stream_ptr()), "gemm_core")
    return out


def mlp_tail_split(r, y, w1, b1, w2, b2):
    """K6 as its two launches of the GEMM core: H = bf16(gelu(fc1(y))),
    then r + fc2(H). On the CPU each launch is its plain version."""
    hid = gemm_core(y, w1, b1, GEMM_GELU)
    return gemm_core(hid, w2, b2, GEMM_RESIDUAL, r)


def conv_mlp_tail_noln_split(r, y, w1, b1, wc, bc, w2, b2):
    """K7 as its three launches of the GEMM core: f1 = bf16(fc1(y)),
    z = bf16(gelu(conv2x2(pad_br(f1)))), then r + fc2(z); wc in the
    kernels' (out, 2, 2, in) layout. On the CPU each launch is its plain
    version."""
    f1 = gemm_core(y, w1, b1, GEMM_BIAS)
    z = gemm_core(f1, wc, bc, GEMM_CONV)
    return gemm_core(z, w2, b2, GEMM_RESIDUAL, r)


def fused_mlp_tail(r, y, w1, b1, w2, b2, int8: bool = False, q8=None):
    """r + fc2(tanh-GELU(fc1(y))), y already normed.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_mlp_tail` (l.598, body
    `_mlp_tail_kernel` l.544). r, y (B, H, W, C) bf16; w1 (hidden, C);
    w2 (C, hidden).

    On the H100 it is bound by operations (4*C*hidden FLOPs per token
    against 4*C bytes of activations). Design: two launches of the GEMM
    core (csrc/gemm_core.cuh; `mlp_tail_split`): fc1 with b1 and the tanh
    GELU in its epilogue writes the hidden in bf16 (the Pallas kernel's
    own rounding point), then fc2 with b2 and the residual. The hidden's
    round trip through device memory (2 x 2*hidden bytes a token) costs
    less than the FLOPs at the flagship's shapes, and keeping it on chip
    would take a 128 x C f32 tile in registers or 32-token CTAs that read
    all of W1 and W2 for every 32 tokens.

    int8=True: K12's twin (`mlp_tail_q8_plain`; `_mlp_tail_q8`).
    """
    if int8:
        return _mlp_tail_q8(r, y, w1, b1, w2, b2, q8)
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
    out = mlp_tail_split(r, y, w1, b1, w2, b2)
    LAUNCHES["mlp_tail"] += 1
    return out


def fused_conv_mlp_tail_noln(r, y, w1, b1, wc, bc, w2, b2,
                             int8: bool = False, q8=None):
    """r + fc2(tanh-GELU(conv2x2(pad_br(fc1(y))))), y already normed.

    Replaces `sodt_tpu/pallas/swin_block.py` `fused_conv_mlp_tail_noln`
    (l.691, body `_conv_tail_noln_kernel` l.622 + `_conv_gelu_fc2` l.374).
    r, y (B, H, W, C) bf16; w1, w2 (C, C); wc (C, 2, 2, C).

    On the H100 it is bound by operations (the four conv taps are four
    C x C GEMMs). Design: three launches of the GEMM core
    (csrc/gemm_core.cuh; `conv_mlp_tail_noln_split`): fc1 writes f1 in
    bf16 (the Pallas kernel rounds f1 to bf16 before the conv too); the
    conv is one GEMM with K = 4C whose A rows are gathered from f1's 2x2
    window as they are copied in (a tap below the last row or right of
    the last column reads zeros, the bottom/right pad of fc1's output,
    the TPU kernel's zeroed last-strip halo), with bc and GELU in its
    epilogue; fc2 adds b2 and the residual.

    int8=True: K12's twin (`conv_mlp_tail_noln_q8_plain`; `_conv_tail_q8`).
    """
    if int8:
        return _conv_tail_q8(r, y, None, w1, b1, wc, bc, w2, b2, 0, q8)
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
    out = conv_mlp_tail_noln_split(r, y, w1, b1, wc, bc, w2, b2)
    LAUNCHES["conv_mlp_tail_noln"] += 1
    return out


# ------------------------------------------------------------ K12 (int8)
#
# The int8 bodies on the card. A strip's activation scale must be known
# before any CTA quantizes it, and a strip spans many CTAs, so each body
# runs as launches split at its quantization points, each producer folding
# max|x| into a per-strip slot with atomicMax. Every twin (K2, K3 / K5 in
# `window_attention`, K4 / K7, K6) is a chain of csrc/int8_chains.cu on the
# s8 wgmma core of csrc/gemm_s8_core.cuh: each producer runs twice, a fold
# and then the same values again written as int8 codes under the finished
# scale, so every activation but K2's f32 res1 crosses launches as codes
# (the conv's and K6's fc1 output are stored in f32 once and a row pass
# writes their codes: faster there): K2's 11 kernels, K3's / K5's 7, K4's
# and K7's 7, K6's 5 (and a memset of the slots). The mirrors
# `*_q8_chain_plain` follow the chains launch by launch. Every wrapper is a
# `Replay`: the backward replays the bf16 composition (`_fsb_bwd`,
# `_fct_bwd`, `_fmt_bwd`, `_fctn_bwd`). On the CPU the forward is the plain
# int8 body, which takes the launcher's arguments. Each launcher hands its
# slots to `quant.strip_amax_log`.

def _swin_block_q8(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1, w2,
                   b2, bias, mask, ws, nh, scale, shift, q8):
    qw = q8_weights(q8, wqkv=wqkv, wp=wp, w1=w1, w2=w2)
    if x.is_cuda:
        name = "fused_swin_block int8"
        b, h, w, c = x.shape
        hid = w1.shape[0]
        _require(shift == 0 and mask is None, f"{name}: JAX quantizes only "
                 f"the unshifted linear block (shift {shift})")
        _check_cuda(name, torch.bfloat16, x=x, wqkv=wqkv, bqkv=bqkv, wp=wp,
                    bp=bp, w1=w1, b1=b1, w2=w2, b2=b2)
        _check_cuda(name, torch.float32, ln1w=ln1w, ln1b=ln1b, ln2w=ln2w,
                    ln2b=ln2b, bias=bias)
        _require(c % nh == 0 and c % 32 == 0 and c <= 512 and hid % 32 == 0
                 and window_core_supported(ws * ws, c // nh),
                 f"{name}: C={c}, hidden={hid}, nh={nh}, window {ws}")
        _require(tuple(wqkv.shape) == (3 * c, c) and tuple(wp.shape) == (c, c)
                 and tuple(w1.shape) == (hid, c) and tuple(w2.shape) == (c, hid),
                 f"{name}: weight shapes")
        _require(b * h * w <= 65535 * 128, f"{name}: {b * h * w} tokens")
        _check_window_args(name, b, h, w, nh, ws, bias, None, 0)
        launch = _launch_swin_block_q8
    else:
        launch = swin_block_q8_plain
    compose = lambda *a: _compose_swin_block(*a[:-1])
    return Replay.apply(launch, compose, (ws, nh, scale, shift, qw), x, ln1w,
                        ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1, w2, b2,
                        bias, mask)


def _launch_swin_block_q8(x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1,
                          b1, w2, b2, bias, mask, ws, nh, scale, shift, qw):
    b, h, w, c = x.shape
    hid = w1.shape[0]
    m = b * h * w
    out = torch.empty_like(x)
    res1 = torch.empty(m * c, dtype=torch.float32, device=x.device)
    codes = torch.empty(m * c, dtype=torch.int8, device=x.device)
    hidden = torch.empty(m * hid, dtype=torch.int8, device=x.device)
    bf16ws = torch.empty(m * 4 * c, dtype=torch.bfloat16, device=x.device)
    amax = torch.empty(4 * b * (h // ws), dtype=torch.float32, device=x.device)
    bqkv, bp, b1, b2 = (t.contiguous() for t in (bqkv, bp, b1, b2))
    (wqkv_q, sqkv), (wp_q, sp) = qw["wqkv"], qw["wp"]
    (w1_q, s1), (w2_q, s2) = qw["w1"], qw["w2"]
    scale_dt = float(torch.tensor(scale, dtype=x.dtype))
    ptrs = [t.data_ptr() for t in (
        x, ln1w, ln1b, wqkv_q, sqkv, bqkv, wp_q, sp, bp, ln2w, ln2b, w1_q, s1,
        b1, w2_q, s2, b2, bias, out, res1, codes, hidden, bf16ws, amax)]
    groups = fwd_groups(b * (h // ws) * (w // ws), ws * ws, nh)
    _build.check(_build.library().sodt_swin_block_q8(
        *ptrs, b, h, w, c, hid, nh, ws, scale_dt, groups, _build.stream_ptr()),
        "fused_swin_block int8")
    LAUNCHES["swin_block_q8"] += 1
    log_kernel_amax(amax, 4)
    return out


def _conv_tail_q8(x, a, ln, w1, b1, wc, bc, w2, b2, shift, q8):
    """K4's int8 body (`ln` = LN2's (weight, bias); x the block input, a
    K3's output in shifted coordinates) or K7's (ln None; x = r, a = y)."""
    qw = q8_weights(q8, w1=w1, wc=wc, w2=w2)
    if x.is_cuda:
        name = ("fused_conv_mlp_tail" if ln is not None
                else "fused_conv_mlp_tail_noln") + " int8"
        b, h, w, c = x.shape
        _check_cuda(name, torch.bfloat16, x=x, a=a, w1=w1, b1=b1, wc=wc,
                    bc=bc, w2=w2, b2=b2)
        lnw, lnb = ln if ln is not None else (None, None)
        _check_cuda(name, torch.float32, lnw=lnw, lnb=lnb)
        _require(a.shape == x.shape, f"{name}: input shapes")
        _require(c % 32 == 0 and c <= 512, f"{name}: C={c}")
        _require(tuple(w1.shape) == (c, c) and tuple(w2.shape) == (c, c)
                 and tuple(wc.shape) == (c, 2, 2, c), f"{name}: weight shapes")
        _require(0 <= shift < min(h, w), f"{name}: shift {shift}")
        _require(b * h * w + b * h * w // tail_ws(h) <= 65535 * 128,
                 f"{name}: {b * h * w} tokens")
    if ln is None:
        launch = (_launch_conv_tail_noln_q8 if x.is_cuda
                  else conv_mlp_tail_noln_q8_plain)
        compose = lambda *r: conv_mlp_tail_noln_plain(*r[:-1])
        return Replay.apply(launch, compose, (qw,), x, a, w1, b1, wc, bc, w2,
                            b2)
    launch = _launch_conv_tail_q8 if x.is_cuda else conv_mlp_tail_q8_plain
    compose = lambda *r: _compose_conv_tail(*r[:-1])
    return Replay.apply(launch, compose, (shift, qw), x, a, *ln, w1, b1, wc,
                        bc, w2, b2)


def _launch_conv_tail_q8(x, a, lnw, lnb, w1, b1, wc, bc, w2, b2, shift, qw):
    out = _conv_tail_q8_entry(x, a, lnw, lnb, w1, b1, wc, bc, w2, b2, shift,
                              qw)
    LAUNCHES["conv_mlp_tail_q8"] += 1
    return out


def _launch_conv_tail_noln_q8(r, y, w1, b1, wc, bc, w2, b2, qw):
    out = _conv_tail_q8_entry(r, y, None, None, w1, b1, wc, bc, w2, b2, 0, qw)
    LAUNCHES["conv_mlp_tail_noln_q8"] += 1
    return out


def _conv_tail_q8_entry(x, a, lnw, lnb, w1, b1, wc, bc, w2, b2, shift, qw):
    """`sodt_conv_tail_q8`, K4's body with the LN (lnw given), K7's
    without."""
    b, h, w, c = x.shape
    ws = tail_ws(h)
    rows = b * h * w + b * (h // ws) * w
    out = torch.empty_like(x)
    i8ws = torch.empty(rows * c * 3, dtype=torch.int8, device=x.device)
    f32ws = torch.empty(b * h * w * c, dtype=torch.float32, device=x.device)
    amax = torch.empty(3 * b * (h // ws), dtype=torch.float32, device=x.device)
    b1, bc, b2 = (t.contiguous() for t in (b1, bc, b2))
    (w1_q, s1), (wc_q, sc), (w2_q, s2) = qw["w1"], qw["wc"], qw["w2"]
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.check(_build.library().sodt_conv_tail_q8(
        x.data_ptr(), a.data_ptr(), ptr(lnw), ptr(lnb), w1_q.data_ptr(),
        s1.data_ptr(), b1.data_ptr(), wc_q.data_ptr(), sc.data_ptr(),
        bc.data_ptr(), w2_q.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), i8ws.data_ptr(), f32ws.data_ptr(), amax.data_ptr(),
        int(lnw is not None), b, h, w, c, ws, shift, _build.stream_ptr()),
        "fused_conv_mlp_tail int8")
    log_kernel_amax(amax, 3)
    return out


def _mlp_tail_q8(r, y, w1, b1, w2, b2, q8):
    qw = q8_weights(q8, w1=w1, w2=w2)
    if r.is_cuda:
        name = "fused_mlp_tail int8"
        b, h, w, c = r.shape
        hid = w1.shape[0]
        _check_cuda(name, torch.bfloat16, r=r, y=y, w1=w1, b1=b1, w2=w2, b2=b2)
        _require(y.shape == r.shape, f"{name}: r/y shapes")
        _require(tuple(w1.shape) == (hid, c) and tuple(w2.shape) == (c, hid),
                 f"{name}: weight shapes")
        _require(c % 32 == 0 and c <= 512 and hid % 32 == 0,
                 f"{name}: C={c}, hidden={hid}")
        _require(b * h * w <= 65535 * 128, f"{name}: {b * h * w} tokens")
        launch = _launch_mlp_tail_q8
    else:
        launch = mlp_tail_q8_plain
    compose = lambda *a: mlp_tail_plain(*a[:-1])
    return Replay.apply(launch, compose, (qw,), r, y, w1, b1, w2, b2)


def _launch_mlp_tail_q8(r, y, w1, b1, w2, b2, qw):
    b, h, w, c = r.shape
    hid = w1.shape[0]
    m, ws = b * h * w, tail_ws(h)
    out = torch.empty_like(r)
    codes = torch.empty(m * c, dtype=torch.int8, device=r.device)
    hidden = torch.empty(m * hid, dtype=torch.int8, device=r.device)
    f32ws = torch.empty(m * hid, dtype=torch.float32, device=r.device)
    amax = torch.empty(2 * b * (h // ws), dtype=torch.float32, device=r.device)
    (w1_q, s1), (w2_q, s2) = qw["w1"], qw["w2"]
    ptrs = [t.data_ptr() for t in (r, y, w1_q, s1, b1, w2_q, s2, b2, out,
                                   codes, hidden, f32ws, amax)]
    _build.check(_build.library().sodt_mlp_tail_q8(
        *ptrs, b, h, w, c, hid, ws, _build.stream_ptr()), "fused_mlp_tail int8")
    LAUNCHES["mlp_tail_q8"] += 1
    log_kernel_amax(amax, 2)
    return out


# ------------------------------------ K12 chains' pieces, one launch each
#
# For the tests on the card: one launch of the s8 core or of a row pass as
# the chains run them (csrc/int8_chains.cu `sodt_gemm_s8`,
# `sodt_q8_rowpass`), and their plain versions for a CPU tensor. No path
# calls them, so they count no launch.

S8_FOLD, S8_CODES, S8_F32, S8_BF16 = 0, 1, 2, 3


def gemm_s8(a, wq, sw, b, amax_in, mode: int, amax_out=None,
            strip_rows: int = 0, conv=None):
    """One launch of the s8 core. a: (M, K) int8 codes in strips of
    `strip_rows` rows, or (conv = (B, H, W, ws)) f1's codes of a (B, H, W)
    map, its M = B H W rows and then one halo row a strip of ws rows, K =
    4C; wq (N, K) int8, sw (N,) f32, b (N,) bf16, amax_in one f32 slot a
    strip. mode S8_FOLD / S8_F32 / S8_CODES runs the chains' producer
    tanh-GELU(v + b) and returns (None / its f32 values / its int8 codes
    under the scales of `amax_out`, the output's slots); S8_BF16 returns
    (bf16(v + b), None)."""
    m = a.shape[0] if conv is None else conv[0] * conv[1] * conv[2]
    n, k = wq.shape
    if not a.is_cuda:
        return gemm_s8_plain(a, wq, sw, b, amax_in, mode, amax_out,
                             strip_rows, conv)
    name = "gemm_s8"
    _require(a.dtype == wq.dtype == torch.int8 and b.dtype == torch.bfloat16
             and n % 8 == 0 and k % 32 == 0, f"{name}: N={n}, K={k}")
    bb, hh, ww, ws = conv if conv is not None else (1, 1, 1, 1)
    strips = (-(-m // strip_rows) if conv is None else bb * (hh // ws))
    if mode == S8_CODES:
        amax = amax_out
    else:
        amax = torch.zeros(strips, dtype=torch.float32, device=a.device)
    out = (torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
           if mode == S8_BF16 else
           torch.empty((m, n), dtype=torch.float32 if mode == S8_F32
                       else torch.int8, device=a.device))
    _build.check(_build.library().sodt_gemm_s8(
        a.data_ptr(), wq.data_ptr(), sw.data_ptr(), b.data_ptr(),
        amax_in.data_ptr(), amax.data_ptr(), out.data_ptr(), m, n, k,
        strip_rows, hh, ww, ws, int(conv is not None), mode,
        _build.stream_ptr()), name)
    if mode == S8_BF16:
        return out, None
    return (None if mode == S8_FOLD else out), amax


def gemm_s8_plain(a, wq, sw, b, amax_in, mode: int, amax_out=None,
                  strip_rows: int = 0, conv=None):
    """`gemm_s8` in plain PyTorch (the mirrors' pieces)."""
    if conv is None:
        strip = torch.arange(a.shape[0], device=a.device) // strip_rows
    else:
        bb, hh, ww, ws = conv
        strip = torch.arange(bb * hh * ww, device=a.device) // (ws * ww)
        a = conv_gather_codes(a, bb, hh, ww, ws)
    v = _q8_deq(a, wq, sw, amax_in, strip) + b.float()
    if mode == S8_BF16:
        return v.to(torch.bfloat16), None
    y = gelu_tanh(v)
    if mode == S8_CODES:
        return _q8(y, _scale(amax_out)[strip][:, None]).to(torch.int8), amax_out
    _, slots = _q8_point(y, strip, len(amax_in))
    return (y if mode == S8_F32 else None), slots


def q8_rowpass(x, g, b, mode: int, strip_rows: int, amax=None,
               round_bf16: bool = False, shift=None):
    """One row pass over (rows, C) x (bf16 or f32) in strips of
    `strip_rows` rows, or (shift given) over the rows of a bf16 (B, H, W,
    C) map read at its (-shift, -shift)-rolled position: LN(x) * g + b in
    f32 (`round_bf16`: then rounded to bf16), or x itself where g is None;
    mode S8_FOLD / S8_F32 / S8_CODES returns (None / the f32 values / their
    int8 codes under the scales of `amax`, the slots), one row a row of
    the (rolled) map."""
    if not x.is_cuda:
        return q8_rowpass_plain(x, g, b, mode, strip_rows, amax, round_bf16,
                                shift)
    c = x.shape[-1]
    rows = x.numel() // c
    hh, ww = x.shape[1:3] if shift is not None else (0, 0)
    _require(x.dtype in (torch.bfloat16, torch.float32) and c % 4 == 0
             and c <= 512 and (shift is None or x.dtype == torch.bfloat16)
             and (g is not None or not round_bf16), f"q8_rowpass: C={c}")
    if mode != S8_CODES:
        amax = torch.zeros(rows // strip_rows, dtype=torch.float32,
                           device=x.device)
    out = torch.empty((rows, c), device=x.device, dtype=(
        torch.int8 if mode == S8_CODES else torch.float32))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    ln = 0 if g is None else 2 if round_bf16 else 1
    _build.check(_build.library().sodt_q8_rowpass(
        x.data_ptr(), ptr(g), ptr(b), amax.data_ptr(), out.data_ptr(), rows,
        c, strip_rows, ln, mode, int(x.dtype == torch.float32), hh, ww,
        shift or 0, _build.stream_ptr()), "q8_rowpass")
    return (None if mode == S8_FOLD else out), amax


def q8_rowpass_plain(x, g, b, mode: int, strip_rows: int, amax=None,
                     round_bf16: bool = False, shift=None):
    """`q8_rowpass` in plain PyTorch."""
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = x.reshape(-1, x.shape[-1])
    v = x.float() if g is None else ln_f32(x.float(), g, b)
    if round_bf16:
        v = v.to(torch.bfloat16).float()
    strip = torch.arange(x.shape[0], device=x.device) // strip_rows
    if mode == S8_CODES:
        return _q8(v, _scale(amax)[strip][:, None]).to(torch.int8), amax
    _, slots = _q8_point(v, strip, x.shape[0] // strip_rows)
    return (v if mode == S8_F32 else None), slots
