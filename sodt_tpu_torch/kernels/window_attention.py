"""Window attention: K1 (windowed core), K3 (LN + qkv + W-MSA + proj), K5
(qkv + W-MSA + proj) and K8 (global / large-window attention).

Counterpart of `sodt_tpu/pallas/window_attention.py`. Weights use torch's
Linear layout (out, in): the kernels read B of every product K-contiguous,
which is the layout the tensor cores' B operand wants.

Plain versions mirror the JAX compositions (`reference_attention_qkv`,
`reference_attention_nhwc`, `_compose_block_attention`): q is scaled in the
working dtype before QK^T, scores and softmax are f32, probabilities are
cast back to the working dtype before PV.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from . import _build


def layer_norm(x, weight, bias):
    """`models.norm.layer_norm` (imported here at call time: the models
    package imports this module)."""
    from ..models.norm import layer_norm as ln
    return ln(x, weight, bias)


# ----------------------------------------------------------- plain versions

def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is rounded to the working dtype first, like JAX's weak-typed
    # python scalar and the kernels' jnp.asarray(scale, x.dtype)
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def reference_attention_qkv(qkv, bias, mask, nw: int, nh: int, scale: float):
    """qkv (W, N, 3C) -> (W, N, C); bias (nh, N, N) f32, mask (nw, N, N)."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    split = lambda t: t.reshape(w, n, nh, hd).transpose(1, 2)
    qh = split(qkv[..., :c])
    kh = split(qkv[..., c:2 * c])
    vh = split(qkv[..., 2 * c:])
    attn = torch.matmul(_scaled(qh, scale).float(),
                        kh.float().transpose(-1, -2))
    attn = attn + bias[None].float()
    if mask is not None:
        attn = attn.reshape(w // nw, nw, nh, n, n)
        attn = attn + mask.float()[None, :, None]
        attn = attn.reshape(w, nh, n, n)
    p = torch.softmax(attn, dim=-1).to(qkv.dtype)
    out = torch.matmul(p, vh)
    return out.transpose(1, 2).reshape(w, n, c)


def reference_attention_nhwc(qkv, bias, mask, ws: int, nh: int,
                             scale: float):
    """qkv (B, H, W, 3C) -> (B, H, W, C), windows of ws x ws."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    g = (h // ws) * (w // ws)
    x = qkv.reshape(b, h // ws, ws, w // ws, ws, c3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b * g, ws * ws, c3)
    out = reference_attention_qkv(x, bias, mask, g, nh, scale)
    out = out.reshape(b, h // ws, w // ws, ws, ws, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def block_attention_plain(x, wqkv, bqkv, wp, bp, bias, mask, ws: int,
                          nh: int, scale: float, shift: int = 0):
    """K5's plain version: `_compose_block_attention` on roll(x, -shift).
    The output stays in shifted coordinates."""
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    dt = x.dtype
    qkv = torch.matmul(x, wqkv.to(dt).t()) + bqkv.to(dt)
    out = reference_attention_nhwc(qkv, bias, mask, ws, nh, scale)
    return torch.matmul(out, wp.to(dt).t()) + bp.to(dt)


def block_attention_ln_plain(x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask,
                             ws: int, nh: int, scale: float, shift: int = 0):
    """K3's plain version: LN1, then K5's plain version (the LN is per
    token, so it commutes with the roll)."""
    return block_attention_plain(layer_norm(x, lnw, lnb), wqkv, bqkv, wp, bp,
                                 bias, mask, ws, nh, scale, shift)


def global_attention_plain(qkv, bias, nh: int, scale: float,
                           ws: int | None = None, mask=None):
    """K8's plain version: `reference_attention_nhwc`, by default with one
    window over the whole map."""
    return reference_attention_nhwc(qkv, bias, mask, ws or qkv.shape[1], nh,
                                    scale)


# ----------------------------------------------------------------- helpers

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, dtype: torch.dtype, **tensors) -> None:
    for k, t in tensors.items():
        if t is None:
            continue
        _require(t.is_cuda, f"{name}: {k} must be on the card")
        _require(t.dtype == dtype, f"{name}: {k} must be {dtype}, got {t.dtype}")
        _require(t.is_contiguous(), f"{name}: {k} must be contiguous")


def window_core_supported(n: int, hd: int) -> bool:
    """The domain of the windowed attention core of csrc/block_attention.cu
    (K1 and K5's core): windows of up to 256 tokens — JAX's own gate for K1
    and K5, ws*ws <= 256 — and head dims that are whole 16-wide tensor-core
    tiles, at most 64 (the shared-memory budget at 256 tokens)."""
    return n <= 256 and hd % 16 == 0 and hd <= 64


def gemm_bias(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (M, K) @ (N, K)^T + b, f32 accumulation, one bf16 rounding: the
    GEMM kernel of csrc/block_attention.cu that K5 and K7 launch for their
    projections. Not a counted kernel of its own."""
    k = a.shape[-1]
    m = a.numel() // k
    n = w.shape[0]
    _require(k % 8 == 0 and w.shape[1] == k, f"gemm_bias: bad K {k}")
    _require((m + 63) // 64 <= 65535, f"gemm_bias: {m} rows exceed the grid")
    out = torch.empty(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    lib = _build.library()
    _build.check(lib.sodt_gemm_bias(a.data_ptr(), w.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), m, n, k, k, n,
                                    _build.stream_ptr()), "gemm_bias")
    return out


# ---------------------------------------------------------------------- K5

def fused_block_attention(x, wqkv, bqkv, wp, bp, bias, mask, ws: int,
                          nh: int, scale: float, shift: int = 0):
    """qkv projection + (shifted) W-MSA + output projection.

    Replaces `sodt_tpu/pallas/window_attention.py` `fused_block_attention`
    (l.651, body `_block_attn_kernel` l.491, no LN). x (B, H, W, C) bf16;
    wqkv (3C, C); bqkv (3C,); wp (C, C); bp (C,) bf16; bias (nh, N, N) f32;
    mask (nW, N, N) f32 or None. The output is in SHIFTED coordinates, as
    in JAX.

    On the H100 the work is bound by operations, most of them in the two
    projections (8*C^2 FLOPs per token against 4*N*C in the windowed core,
    N=64); the core itself is small and bound by its shared-memory round
    trips. Design: the qkv GEMM runs on
    the unrolled map (a per-token product commutes with the roll); the
    attention kernel, one CTA per (window, head), reads its tokens at
    ((r + shift) mod H, (c + shift) mod W) — the shift is index arithmetic,
    no roll is materialized — keeps scores, mask, f32 softmax and P in
    shared memory and writes the head's output in shifted coordinates; the
    proj GEMM is a second launch of the same GEMM kernel. Window packing
    (`_pick_pack`, a TPU MXU-filling trick) is not carried over.
    """
    if not x.is_cuda:
        return block_attention_plain(x, wqkv, bqkv, wp, bp, bias, mask, ws,
                                     nh, scale, shift)
    name = "fused_block_attention"
    b, h, w, c = x.shape
    hd = c // nh
    n = ws * ws
    _check_cuda(name, torch.bfloat16, x=x, wqkv=wqkv, bqkv=bqkv, wp=wp, bp=bp)
    _check_cuda(name, torch.float32, bias=bias, mask=mask)
    _require(c % nh == 0 and window_core_supported(n, hd),
             f"{name}: window of {n} tokens, head dim {hd}")
    _require(tuple(wqkv.shape) == (3 * c, c) and tuple(wp.shape) == (c, c),
             f"{name}: weight shapes")
    _check_window_args(name, b, h, w, nh, ws, bias, mask, shift)
    qkv = gemm_bias(x, wqkv, bqkv)
    attn = _window_core(qkv, bias, mask, ws, nh, scale, shift, name)
    out = gemm_bias(attn, wp, bp)
    LAUNCHES["block_attention"] += 1
    return out


def _check_window_args(name, b, h, w, nh, ws, bias, mask, shift):
    n = ws * ws
    _require(h % ws == 0 and w % ws == 0, f"{name}: map {h}x{w} not a "
             f"multiple of window {ws}")
    _require(tuple(bias.shape) == (nh, n, n), f"{name}: bias shape")
    if mask is not None:
        _require(tuple(mask.shape) == ((h // ws) * (w // ws), n, n),
                 f"{name}: mask shape")
    _require(0 <= shift < ws, f"{name}: shift {shift}")
    _require(b * (h // ws) * (w // ws) <= 65535, f"{name}: too many windows")


def _window_core(qkv, bias, mask, ws, nh, scale, shift, name):
    """Launch the windowed attention core of csrc/block_attention.cu on an
    unpartitioned (B, H, W, 3C) qkv map."""
    b, h, w, c3 = qkv.shape
    attn = torch.empty(qkv.shape[:-1] + (c3 // 3,), dtype=qkv.dtype,
                       device=qkv.device)
    scale_dt = float(torch.tensor(scale, dtype=qkv.dtype))
    _build.check(_build.library().sodt_window_attention(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), attn.data_ptr(),
        b, h, w, c3 // 3, nh, ws, shift, int(mask is not None), scale_dt,
        _build.stream_ptr()), name)
    return attn


# ---------------------------------------------------------------------- K3

def fused_block_attention_ln(x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask,
                             ws: int, nh: int, scale: float, shift: int = 0):
    """LN1 + qkv projection + (shifted) W-MSA + output projection, one
    kernel launch.

    Replaces `sodt_tpu/pallas/window_attention.py` `fused_block_attention_ln`
    (l.690, body `_block_attn_kernel` l.491 with the LN). x (B, H, W, C)
    bf16; lnw, lnb (C,) f32; weights as for K5. The output is in SHIFTED
    coordinates, as in JAX; `swin_block.fused_conv_mlp_tail` un-shifts it
    while reading.

    On the H100 it is bound by operations (the two projections). Design:
    one CTA per window (csrc/swin_block.cu swin_window_kernel<false>): LN1
    reads the window's tokens straight from x at their shifted positions,
    and the normed rows, qkv, scores and the attention output stay in
    shared memory; only x and the projected output touch device memory.
    Domain: `swin_block.megakernel_supported`.
    """
    if not x.is_cuda:
        return block_attention_ln_plain(x, lnw, lnb, wqkv, bqkv, wp, bp, bias,
                                        mask, ws, nh, scale, shift)
    from .swin_block import megakernel_supported
    name = "fused_block_attention_ln"
    b, h, w, c = x.shape
    _check_cuda(name, torch.bfloat16, x=x, wqkv=wqkv, bqkv=bqkv, wp=wp, bp=bp)
    _check_cuda(name, torch.float32, lnw=lnw, lnb=lnb, bias=bias, mask=mask)
    _require(megakernel_supported(c, nh, ws), f"{name}: C={c}, nh={nh}, "
             f"window {ws}")
    _require(tuple(wqkv.shape) == (3 * c, c) and tuple(wp.shape) == (c, c),
             f"{name}: weight shapes")
    _check_window_args(name, b, h, w, nh, ws, bias, mask, shift)
    out = torch.empty_like(x)
    scale_dt = float(torch.tensor(scale, dtype=x.dtype))
    _build.check(_build.library().sodt_block_attention_ln(
        x.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wp.data_ptr(), bp.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, h, w, c, nh, ws, shift, int(mask is not None), scale_dt,
        _build.stream_ptr()), name)
    LAUNCHES["block_attention_ln"] += 1
    return out


# ---------------------------------------------------------------------- K1

def fused_window_attention_nhwc(qkv, bias, mask, ws: int, nh: int,
                                scale: float):
    """Windowed multi-head attention core on an unpartitioned qkv map.

    Replaces `sodt_tpu/pallas/window_attention.py`
    `fused_window_attention_nhwc` (l.750, body `_strip_kernel` l.378).
    qkv (B, H, W, 3C) bf16 (already padded/rolled by the caller); bias
    (nh, N, N) f32; mask (nW, N, N) f32 or None. Returns (B, H, W, C).

    On the H100 it is bound by its shared-memory round trips (the f32
    scores) more than by bytes or operations: 4*N*C FLOPs per token at
    N <= 256. Design: the kernel K5 launches between its projections
    (csrc/block_attention.cu window_attn_kernel, shift 0): one CTA per
    (head, window), each warp 16 query rows, scores and the f32 softmax in
    the warp's shared scratch, no window partition copies. Window packing
    (`_pick_pack`) is a TPU MXU trick and is not carried over.
    """
    if not qkv.is_cuda:
        return reference_attention_nhwc(qkv, bias, mask, ws, nh, scale)
    name = "fused_window_attention_nhwc"
    b, h, w, c3 = qkv.shape
    hd = c3 // 3 // nh
    _check_cuda(name, torch.bfloat16, qkv=qkv)
    _check_cuda(name, torch.float32, bias=bias, mask=mask)
    _require(c3 % (3 * nh) == 0 and window_core_supported(ws * ws, hd),
             f"{name}: window of {ws * ws} tokens, head dim {hd}")
    _check_window_args(name, b, h, w, nh, ws, bias, mask, 0)
    out = _window_core(qkv, bias, mask, ws, nh, scale, 0, name)
    LAUNCHES["window_attention"] += 1
    return out


# ---------------------------------------------------------------------- K8

def fused_global_attention(qkv, bias, nh: int, scale: float,
                           ws: int | None = None, mask=None):
    """Single-window attention over the whole map.

    Replaces `sodt_tpu/pallas/window_attention.py` `fused_global_attention`
    (l.1115, body `_global_kernel` l.941). qkv (B, H, W, 3C) bf16 with the
    fused [q | k | v] layout; bias (nh, N, N) f32, N = H*W. Returns
    (B, H, W, C). With `ws` smaller than the map it attends within each
    ws x ws window (N = ws*ws, optional (nW, N, N) f32 mask): the windows
    of more than 256 tokens that JAX leaves to its XLA composition
    (flagship stage 3 off the 512 px size, e.g. 640 px: a 40x40 map padded
    to four 32x32 windows).

    On the H100 the bound is bytes: the f32 (nh, N, N) bias is 50 MB at
    N=1024 and nh=12, five times the qkv tensor at batch 2. Design: flash
    style, one CTA per (batch, head, 64 query rows); it streams 64-key
    blocks of K and V straight from the fused qkv layout (no head-split
    transpose), reads each bias tile once per batch element, and keeps the
    online-softmax state and the output accumulator in shared memory, so
    the (N, N) scores never reach device memory.
    """
    if not qkv.is_cuda:
        return global_attention_plain(qkv, bias, nh, scale, ws, mask)
    name = "fused_global_attention"
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ws = ws or h
    hd = c // nh
    _check_cuda(name, torch.bfloat16, qkv=qkv)
    _check_cuda(name, torch.float32, bias=bias, mask=mask)
    _require(ws * ws % 64 == 0, f"{name}: N={ws * ws} must be a multiple "
             "of 64")
    _require(c % nh == 0 and hd % 16 == 0 and hd <= 128,
             f"{name}: head dim {hd}")
    _check_window_args(name, b, h, w, nh, ws, bias, mask, 0)
    _require(b * (h // ws) * (w // ws) * nh <= 65535,
             f"{name}: too many (window, head) pairs")
    out = torch.empty(qkv.shape[:-1] + (c,), dtype=qkv.dtype,
                      device=qkv.device)
    lib = _build.library()
    scale_dt = float(torch.tensor(scale, dtype=qkv.dtype))
    _build.check(lib.sodt_global_attention(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), b, h, w,
        c, nh, ws, int(mask is not None), scale_dt, _build.stream_ptr()),
        name)
    LAUNCHES["global_attention"] += 1
    return out


# ---------------------------------------------------------------- dispatch

def window_attention_core_nhwc(qkv, bias, mask, ws: int, nh: int,
                               scale: float):
    """The attention core of the generic block path
    (`window_attention_core_nhwc` l.909). On a CUDA bf16 tensor: windows of
    up to 256 tokens go to K1 (JAX's gate), larger ones to K8 — one window
    as in JAX, several (which JAX leaves to XLA) through K8's windowed
    form. Each wrapper raises outside its kernel's domain. f32 and CPU
    tensors take the plain version, as JAX gates its kernels to bf16."""
    if qkv.is_cuda and qkv.dtype == torch.bfloat16:
        if ws * ws <= 256:
            return fused_window_attention_nhwc(qkv, bias, mask, ws, nh, scale)
        return fused_global_attention(qkv, bias, nh, scale, ws, mask)
    return reference_attention_nhwc(qkv, bias, mask, ws, nh, scale)
