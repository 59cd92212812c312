"""Window attention: K1 (windowed core on a map), K3 (LN + qkv + W-MSA +
proj), K5 (qkv + W-MSA + proj), K8 (global / large-window attention), K11
(windowed core on pre-partitioned windows) and the backward kernels K9 (of
K1), K10 (of K8) and K11's own.

Counterpart of `sodt_tpu/pallas/window_attention.py`. Weights use torch's
Linear layout (out, in): the kernels read B of every product K-contiguous,
which is the layout the tensor cores' B operand wants.

Plain versions mirror the JAX compositions (`reference_attention_qkv`,
`reference_attention_nhwc`, `_compose_block_attention`): q is scaled in the
working dtype before QK^T, scores and softmax are f32, probabilities are
cast back to the working dtype before PV.

Gradients. On the card K1, K8 and K11 are `torch.autograd.Function`s whose
backward launches K9 / K10 / K11's backward kernel on the saved (qkv, bias,
mask), as the JAX package's `custom_vjp`s do. The fused wrappers K3 and K5 (and K2, K4, K6, K7
in `swin_block`) save their inputs and, in backward, replay the plain
composition with `dispatch=True` - its LayerNorms and its attention core
then go through the kernel wrappers (K13, K1 -> K9, K8 -> K10) - and
differentiate that (`_fba_bwd`, `_fbal_bwd`, `_fsb_bwd`, ...). On the CPU
every wrapper is its plain version and autograd differentiates it.
"""

from __future__ import annotations

import math

import torch

from . import LAUNCHES
from . import _build
from .layernorm import layernorm, layernorm_plain
from .quant import (_q8_deq, _q8_point, ln_f32, log_kernel_amax, q8_dot,
                    q8_weights, to_strips)


# ----------------------------------------------------------- plain versions

def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    # the scale is rounded to the working dtype first, like JAX's weak-typed
    # python scalar and the kernels' jnp.asarray(scale, x.dtype)
    return q * float(torch.tensor(scale, dtype=q.dtype))


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
                          nh: int, scale: float, shift: int = 0,
                          dispatch: bool = False):
    """K5's plain version: `_compose_block_attention` on roll(x, -shift).
    The output stays in shifted coordinates. `dispatch=True` is the
    composition a backward replays: the attention core goes through
    `window_attention_core_nhwc` (K1 / K8 and their backward kernels on
    the card) instead of the plain reference."""
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    dt = x.dtype
    qkv = torch.matmul(x, wqkv.to(dt).t()) + bqkv.to(dt)
    core = window_attention_core_nhwc if dispatch else reference_attention_nhwc
    out = core(qkv, bias, mask, ws, nh, scale)
    return torch.matmul(out, wp.to(dt).t()) + bp.to(dt)


def block_attention_ln_plain(x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask,
                             ws: int, nh: int, scale: float, shift: int = 0,
                             dispatch: bool = False):
    """K3's plain version: LN1, then K5's plain version (the LN is per
    token, so it commutes with the roll). `dispatch=True`: the LN goes
    through `layernorm` (K13 on the card) and the core through its
    wrapper."""
    ln = layernorm if dispatch else layernorm_plain
    return block_attention_plain(ln(x, lnw, lnb), wqkv, bqkv, wp, bp, bias,
                                 mask, ws, nh, scale, shift, dispatch)


def block_attention_q8_plain(x, wqkv, bqkv, wp, bp, bias, mask, ws: int,
                             nh: int, scale: float, shift: int = 0, q8=None,
                             dispatch: bool = False, ln=None):
    """The int8 body of K5 (with `ln` = (weight, bias): of K3), from
    `_block_attn_kernel` with `sqkv_ref` / `sp_ref` (l.491): on the
    (-shift, -shift)-rolled map, per strip of ws rows, [LN rounded to the
    working dtype ->] f32 -> `_q8_dot` + bqkv -> working dtype -> the
    attention core -> f32 -> `_q8_dot` + bp. The output stays in shifted
    coordinates. `q8`: {"wqkv", "wp"} -> (int8, scales), else quantized
    here; `dispatch=True`: the core goes through its wrapper (K1 on the
    card, the int8 kernel's own core)."""
    qw = q8_weights(q8, wqkv=wqkv, wp=wp)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    b, h, w, c = x.shape
    dt = x.dtype
    if ln is not None:
        x = ln_f32(x.float(), *ln).to(dt)
    qkv = (q8_dot(to_strips(x.float(), ws), *qw["wqkv"])
           + bqkv.float()).to(dt)
    core = window_attention_core_nhwc if dispatch else reference_attention_nhwc
    attn = core(qkv.reshape(b, h, w, 3 * c), bias, mask, ws, nh, scale)
    y = q8_dot(to_strips(attn.float(), ws), *qw["wp"]) + bp.float()
    return y.reshape(b, h, w, c).to(dt)


def block_attention_ln_q8_plain(x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask,
                                ws: int, nh: int, scale: float,
                                shift: int = 0, q8=None,
                                dispatch: bool = False):
    """K3's int8 body: `block_attention_q8_plain` with the LN."""
    return block_attention_q8_plain(x, wqkv, bqkv, wp, bp, bias, mask, ws, nh,
                                    scale, shift, q8, dispatch, ln=(lnw, lnb))


def attention_qkv_bwd_plain(qkv, bias, mask, nw: int, nh: int, scale: float,
                            gy):
    """The plain version of K11's backward (and, through the window
    partition, of K9's), from `_bwd_kernel`'s formulas in f32:
    S = scale * Q K^T + bias (+ mask[w mod nw]) with q NOT pre-scaled,
    P = softmax(S), dV = P^T dO, dP = dO V^T,
    dS = P * (dP - rowsum(dP * P)), dQ = scale * dS K, dK = scale * dS^T Q,
    dbias = sum over the windows of dS. qkv (W, N, 3C), gy (W, N, C) ->
    (dqkv in qkv's dtype, dbias (nh, N, N) f32)."""
    dx, ds = _attention_bwd_windows(qkv, bias, mask, nw, nh, scale, gy, False)
    return dx, ds.sum(dim=0)


def _attention_bwd_windows(qkv, bias, mask, nw, nh, scale, gy, rounded):
    """`attention_qkv_bwd_plain`'s dqkv and the dS of every window (W, nh,
    N, N) f32; `rounded`: P rounded to bf16 before dV, dS before dQ and dK,
    as K9's register body rounds them."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if rounded
           else (lambda x: x))

    def heads(t):          # (W, N, k*C) -> k tensors (W, nh, N, hd)
        k = t.shape[-1] // c
        return t.float().reshape(w, n, k, nh, hd).permute(2, 0, 3, 1, 4)

    q, k, v = heads(qkv)
    do = heads(gy)[0]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + bias[None].float()
    if mask is not None:
        s = (s.reshape(w // nw, nw, nh, n, n)
             + mask.float()[None, :, None]).reshape(w, nh, n, n)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(rnd(p).transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = scale * torch.matmul(rnd(ds), k)
    dk = scale * torch.matmul(rnd(ds).transpose(-1, -2), q)
    dx = torch.stack([dq, dk, dv]).to(qkv.dtype)     # (3, W, nh, N, hd)
    return dx.permute(1, 3, 0, 2, 4).reshape(w, n, c3), ds


def _to_windows(t, ws: int):
    """(B, H, W, k) -> (B * nW, ws * ws, k), windows in row-major order."""
    b, h, w, k = t.shape
    t = t.reshape(b, h // ws, ws, w // ws, ws, k)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, k)


def _from_windows(t, b: int, h: int, w: int, ws: int):
    t = t.reshape(b, h // ws, w // ws, ws, ws, t.shape[-1])
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, t.shape[-1])


def attention_nhwc_bwd_plain(qkv, bias, mask, ws: int, nh: int, scale: float,
                             gy):
    """K9's plain version (`_bwd_strip_kernel`): `attention_qkv_bwd_plain`
    on the windows of the map. qkv (B, H, W, 3C), gy (B, H, W, C) -> (dqkv
    in qkv's dtype, dbias (nh, N, N) f32)."""
    b, h, w, _ = qkv.shape
    dx, dbias = attention_qkv_bwd_plain(_to_windows(qkv, ws), bias, mask,
                                        (h // ws) * (w // ws), nh, scale,
                                        _to_windows(gy, ws))
    return _from_windows(dx, b, h, w, ws), dbias


def attention_qkv_bwd_mirror(qkv, bias, mask, nw: int, nh: int,
                             scale: float, gy, groups: int | None = None,
                             rounded: bool = True):
    """The plain mirror of the register backward body (N <= 64,
    csrc/window_attention_bwd.cuh) on pre-partitioned windows (K11's
    backward): `attention_qkv_bwd_plain`'s formulas with P rounded to bf16
    before dV and dS before dQ and dK (`rounded`), and dbias summed in the
    kernel's order: each group adds its stages group, group + groups, ...
    in turn, a stage's window slots (four at N <= 16) in slot order, then
    the groups in order. `groups` defaults to the wrapper's (`bwd_groups`).
    Same arguments and results as `attention_qkv_bwd_plain`."""
    total, n = qkv.shape[:2]
    dx, ds = _attention_bwd_windows(qkv, bias, mask, nw, nh, scale, gy,
                                    rounded)
    wpi = stage_windows(n)
    groups = groups or bwd_groups(total, n, nh)
    iters = -(-total // (wpi * groups))
    ds = torch.cat([ds, ds.new_zeros((iters * groups * wpi - total,
                                      *ds.shape[1:]))])
    ds = ds.reshape(iters, groups, wpi, *ds.shape[1:])
    acc = ds[0]
    for i in range(1, iters):
        acc = acc + ds[i]
    slots = acc[:, 0]
    for i in range(1, wpi):
        slots = slots + acc[:, i]
    dbias = slots[0]
    for i in range(1, groups):
        dbias = dbias + slots[i]
    return dx, dbias


def attention_nhwc_bwd_mirror(qkv, bias, mask, ws: int, nh: int,
                              scale: float, gy, groups: int | None = None,
                              rounded: bool = True):
    """The plain mirror of K9's register body: `attention_qkv_bwd_mirror`
    on the windows of the map. Same arguments and results as
    `attention_nhwc_bwd_plain`."""
    b, h, w, _ = qkv.shape
    dx, dbias = attention_qkv_bwd_mirror(
        _to_windows(qkv, ws), bias, mask, (h // ws) * (w // ws), nh, scale,
        _to_windows(gy, ws), groups, rounded)
    return _from_windows(dx, b, h, w, ws), dbias


LOG2E = 1.4426950408889634


def attention_qkv_fwd_mirror(qkv, bias, mask, nw: int, nh: int,
                             scale: float, rounded: bool = True):
    """The plain mirror of the forward register body (N <= 64,
    csrc/window_attention_fwd.cuh) on pre-partitioned windows, qkv
    (W, N, 3C) -> (W, N, C) f32. With `rounded`, the kernel's arithmetic:
    q times the scale rounded to bf16, the product rounded to bf16;
    S = q k^T in f32; the bias (+ mask[w mod nw]) added in log2 units;
    P = 2^(x - max) times 1 / its sum in f32, rounded to bf16 before PV;
    the output rounded to bf16. Without it, the same formulas in f32
    throughout (the Pallas forwards on f32 inputs)."""
    w, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if rounded
           else (lambda x: x))
    q, k, v = qkv.float().reshape(w, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
    x = (torch.matmul(q, k.transpose(-1, -2)) * LOG2E
         + bias[None].float() * LOG2E)
    if mask is not None:
        x = (x.reshape(w // nw, nw, nh, n, n)
             + mask.float()[None, :, None] * LOG2E).reshape(w, nh, n, n)
    e = torch.exp2(x - x.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    out = rnd(torch.matmul(rnd(p), v))
    return out.transpose(1, 2).reshape(w, n, c)


def attention_fwd_mirror(qkv, bias, mask, ws: int, nh: int, scale: float,
                         shift: int = 0, rounded: bool = True):
    """`attention_qkv_fwd_mirror` on the ws x ws windows of an
    unpartitioned (B, H, W, 3C) map, read at ((r + shift) mod H,
    (c + shift) mod W) and written at (r, c): K5's shifted core, K1 at
    shift 0. Returns (B, H, W, C) f32."""
    b, h, w, _ = qkv.shape
    if shift:
        qkv = torch.roll(qkv, (-shift, -shift), (1, 2))
    out = attention_qkv_fwd_mirror(_to_windows(qkv, ws), bias, mask,
                                   (h // ws) * (w // ws), nh, scale, rounded)
    return _from_windows(out, b, h, w, ws)


def block_attention_chain_plain(x, wqkv, bqkv, wp, bp, bias, mask,
                                ws: int, nh: int, scale: float,
                                shift: int = 0, core_rounded: bool = True,
                                ln=None):
    """The plain mirror of K5's chain (csrc/block_attention.cu; with `ln`
    = (lnw, lnb), of K3's, csrc/shifted_block_chain.cu), each launch in f32
    with the kernel's rounding points made explicit, in map order: (K3: ln
    = bf16(LN(x)), which takes x's place;) qkv = bf16(x Wqkv^T + bqkv); the
    attention core as `attention_fwd_mirror` rounds it, read at ((r + shift)
    mod H, (c + shift) mod W) and written at (r, c); out = bf16(attn Wp^T +
    bp). Returns (B, H, W, C) f32 in SHIFTED coordinates, as JAX's kernel.
    `core_rounded=False` keeps q * scale, P and the attention output in f32
    (the control a check of the core's rounding points must tell apart)."""
    rnd = lambda z: z.to(torch.bfloat16).float()
    lin = lambda z, w, b: torch.matmul(z, w.float().t()) + b.float()
    z = x.float() if ln is None else rnd(ln_f32(x.float(), *ln))
    qkv = rnd(lin(z, wqkv, bqkv))
    attn = attention_fwd_mirror(qkv, bias, mask, ws, nh, scale, shift,
                                core_rounded)
    return rnd(lin(attn, wp, bp))


def block_attention_ln_chain_plain(x, lnw, lnb, wqkv, bqkv, wp, bp, bias,
                                   mask, ws: int, nh: int, scale: float,
                                   shift: int = 0, core_rounded: bool = True):
    """The plain mirror of K3's chain: `block_attention_chain_plain` with
    the LN."""
    return block_attention_chain_plain(x, wqkv, bqkv, wp, bp, bias, mask, ws,
                                       nh, scale, shift, core_rounded,
                                       ln=(lnw, lnb))


def global_attention_bwd_plain(qkv, bias, nh: int, scale: float, gy,
                               ws: int | None = None, mask=None):
    """K10's plain version (`_global_chunk_grads` and the two kernels that
    use it compute the same formulas as K9's, over one window of the whole
    map by default)."""
    return attention_nhwc_bwd_plain(qkv, bias, mask, ws or qkv.shape[1], nh,
                                    scale, gy)


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
    # messages are built only on failure: this runs on every kernel call
    for k, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {k} must be on the card")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {k} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def window_core_supported(n: int, hd: int) -> bool:
    """The domain of the windowed attention core (K1, K5's core, K11
    forward and backward, K9): the strip bodies of csrc/window_attention.cuh
    and the register bodies of csrc/window_attention_fwd.cuh and
    csrc/window_attention_bwd.cuh (N <= 64) take the same head dims.
    Windows of up to 256 tokens — JAX's own
    gate for K1, K5 and K11, N <= 256 — and head dims that are whole
    16-wide tensor-core tiles, at most 64 (the shared-memory budget at 256
    tokens)."""
    return n <= 256 and hd % 16 == 0 and hd <= 64


class Replay(torch.autograd.Function):
    """A fused kernel with a replayed backward (the JAX package's
    `custom_vjp`s `_fsb_bwd`, `_fba_bwd`, ...): forward runs
    `launch(*tensors, *consts)` and saves the tensors; backward runs
    `compose(*leaves, *consts)` on detached leaves under enable_grad and
    returns `torch.autograd.grad` of it. The kernels inside `compose` (K13,
    K1 -> K9, K8 -> K10) carry their own backward."""

    @staticmethod
    def forward(ctx, launch, compose, consts, *tensors):
        ctx.compose, ctx.consts = compose, consts
        ctx.save_for_backward(*tensors)
        return launch(*tensors, *consts)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.compose(*leaves, *ctx.consts)
            grads = iter(torch.autograd.grad(
                out, [l for l, n in zip(leaves, needs) if n], g))
        return (None, None, None,
                *[next(grads) if n else None for n in needs])


# ---------------------------------------------------------------------- K5

def fused_block_attention(x, wqkv, bqkv, wp, bp, bias, mask, ws: int,
                          nh: int, scale: float, shift: int = 0,
                          int8: bool = False, q8=None):
    """qkv projection + (shifted) W-MSA + output projection.

    Replaces `sodt_tpu/pallas/window_attention.py` `fused_block_attention`
    (l.651, body `_block_attn_kernel` l.491, no LN). x (B, H, W, C) bf16;
    wqkv (3C, C); bqkv (3C,); wp (C, C); bp (C,) bf16; bias (nh, N, N) f32;
    mask (nW, N, N) f32 or None. The output is in SHIFTED coordinates, as
    in JAX.

    On the H100 the work is bound by operations, most of them in the two
    projections (8*C^2 FLOPs per token against 4*N*C in the windowed core,
    N=64). Design: K3's chain less the LN, three launches from one C entry
    (csrc/block_attention.cu, `sodt_block_attention_chain`): the qkv GEMM
    on the wgmma GEMM core (+ bqkv) over the unrolled map (a per-token
    product commutes with the roll); the attention core (the forward's
    register body at N <= 64, the strip body above) with the shifted
    addressing: it reads its tokens at ((r + shift) mod H, (c + shift) mod
    W) — the shift is index arithmetic, no roll is materialized — and
    writes the head's output in shifted coordinates; the projection on the
    same core (+ bp). `block_attention_chain_plain` mirrors its rounding
    points; the scratch (qkv, the attention output) is allocated here.
    Window packing (`_pick_pack`, a TPU MXU-filling trick) is not carried
    over.

    int8=True is K12's body (`block_attention_q8_plain` says what it
    computes; `q8` the quantized weights, else quantized here): see
    `_block_attention_q8`.
    """
    if int8:
        return _block_attention_q8(x, None, wqkv, bqkv, wp, bp, bias, mask, ws,
                                   nh, scale, shift, q8)
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
    return Replay.apply(_launch_block_attention, _compose_block_attention,
                        (ws, nh, scale, shift), x, wqkv, bqkv, wp, bp, bias,
                        mask)


def _launch_block_attention(x, wqkv, bqkv, wp, bp, bias, mask, ws, nh, scale,
                            shift):
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, wqkv, bqkv, wp, bp, bias)]
    ptrs += [None if mask is None else mask.data_ptr(), out.data_ptr()]
    # the chain's launches move 16-byte pieces of every operand
    _require(all(p % 16 == 0 for p in ptrs if p is not None),
             "fused_block_attention: operands must be 16-byte aligned")
    m = b * h * w
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty((m, c), dtype=x.dtype, device=x.device)
    groups = fwd_groups(b * (h // ws) * (w // ws), ws * ws, nh)
    _build.check(_build.library().sodt_block_attention_chain(
        *ptrs, qkv.data_ptr(), attn.data_ptr(), b, h, w, c, nh, ws, shift,
        int(mask is not None), float(torch.tensor(scale, dtype=x.dtype)),
        groups, _build.stream_ptr()), "fused_block_attention")
    LAUNCHES["block_attention"] += 1
    return out


def _compose_block_attention(*args):
    return block_attention_plain(*args, dispatch=True)


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
    """Launch the windowed attention forward of csrc/block_attention.cu
    (`fwd_body` picks its body) on an unpartitioned (B, H, W, 3C) qkv
    map."""
    b, h, w, c3 = qkv.shape
    attn = torch.empty(qkv.shape[:-1] + (c3 // 3,), dtype=qkv.dtype,
                       device=qkv.device)
    scale_dt = float(torch.tensor(scale, dtype=qkv.dtype))
    groups = fwd_groups(b * (h // ws) * (w // ws), ws * ws, nh)
    _build.check(_build.library().sodt_window_attention(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), attn.data_ptr(),
        b, h, w, c3 // 3, nh, ws, shift, int(mask is not None), scale_dt,
        groups, _build.stream_ptr()), name)
    return attn


# ---------------------------------------------------------------------- K3

def fused_block_attention_ln(x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask,
                             ws: int, nh: int, scale: float, shift: int = 0,
                             int8: bool = False, q8=None):
    """LN1 + qkv projection + (shifted) W-MSA + output projection, one
    counted launch.

    Replaces `sodt_tpu/pallas/window_attention.py` `fused_block_attention_ln`
    (l.690, body `_block_attn_kernel` l.491 with the LN). x (B, H, W, C)
    bf16; lnw, lnb (C,) f32; weights as for K5. The output is in SHIFTED
    coordinates, as in JAX; `swin_block.fused_conv_mlp_tail` un-shifts it
    while reading.

    Two bodies, chosen by `swin_block.swin_block_body` (as K2's):
    - head dim <= 64 (every configuration): a chain of four launches from
      one C entry (csrc/shifted_block_chain.cu): K13's LN body on x; qkv on
      the wgmma GEMM core (+ bqkv); the forward's register attention core,
      which at a shift reads each token at ((r + s) mod H, (c + s) mod W)
      and writes it at (r, c) (`FwdShiftedMap`, K5's core); the projection
      (+ bp), per token, so it writes in shifted order too. Bound by bytes
      at the flagship's stage 1 (~0.30 GB a call at batch 4 against 22.5
      GFLOP). `block_attention_ln_chain_plain` mirrors its rounding
      points; the scratch (ln, then the attention output; qkv) is
      allocated here.
    - head dim > 64: one CTA per window (csrc/swin_block.cu
      swin_window_kernel<false>): LN1 reads the window's tokens straight
      from x at their shifted positions, and the normed rows, qkv, scores
      and the attention output stay in shared memory.
    Domain: `swin_block.megakernel_supported`. int8=True: K12's body, as
    for `fused_block_attention`, with the LN.
    """
    if int8:
        return _block_attention_q8(x, (lnw, lnb), wqkv, bqkv, wp, bp, bias,
                                   mask, ws, nh, scale, shift, q8)
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
    return Replay.apply(_launch_block_attention_ln,
                        _compose_block_attention_ln, (ws, nh, scale, shift),
                        x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask)


def _launch_block_attention_ln(x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask,
                               ws, nh, scale, shift):
    from .swin_block import swin_block_body
    b, h, w, c = x.shape
    out = torch.empty_like(x)
    scale_dt = float(torch.tensor(scale, dtype=x.dtype))
    ptrs = [t.data_ptr() for t in (x, lnw, lnb, wqkv, bqkv, wp, bp, bias)]
    ptrs += [None if mask is None else mask.data_ptr(), out.data_ptr()]
    lib = _build.library()
    if swin_block_body(c, nh, ws) == "chain":
        # the chain's launches move 16-byte pieces of every operand
        _require(all(p % 16 == 0 for p in ptrs if p is not None),
                 "fused_block_attention_ln: operands must be 16-byte aligned")
        m = b * h * w
        ln = torch.empty((m, c), dtype=x.dtype, device=x.device)
        qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
        groups = fwd_groups(b * (h // ws) * (w // ws), ws * ws, nh)
        err = lib.sodt_block_attention_ln_chain(
            *ptrs, ln.data_ptr(), qkv.data_ptr(), b, h, w, c, nh, ws, shift,
            int(mask is not None), scale_dt, groups, _build.stream_ptr())
    else:
        err = lib.sodt_block_attention_ln(
            *ptrs, b, h, w, c, nh, ws, shift, int(mask is not None),
            scale_dt, _build.stream_ptr())
    _build.check(err, "fused_block_attention_ln")
    LAUNCHES["block_attention_ln"] += 1
    return out


def _compose_block_attention_ln(*args):
    return block_attention_ln_plain(*args, dispatch=True)


def block_attention_q8_chain_plain(x, wqkv, bqkv, wp, bp, bias, mask,
                                   ws: int, nh: int, scale: float,
                                   shift: int = 0, q8=None,
                                   dispatch: bool = False, ln=None):
    """The mirror of `sodt_block_attention_q8` (csrc/int8_chains.cu, tests
    only), launch by launch over the (M, C) rows of the rolled map: the
    fold and codes of x (with `ln`: of its LN rounded to the working
    dtype), qkv, the core, att fold / codes, proj; one slot a strip of ws
    map rows (`quant._q8_point`). Bit-equal to `block_attention_q8_plain`
    on the CPU."""
    qw = q8_weights(q8, wqkv=wqkv, wp=wp)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    b, h, w, c = x.shape
    m, s = b * h * w, b * (h // ws)
    dt = x.dtype
    strip = torch.arange(m, device=x.device) // (ws * w)
    v = x.float().reshape(m, c)
    if ln is not None:
        v = ln_f32(v, *ln).to(dt).float()
    slots = []

    def point(v):
        codes, sl = _q8_point(v, strip, s)
        slots.append(sl)
        return codes, sl

    xq = point(v)
    qkv = (_q8_deq(xq[0], *qw["wqkv"], xq[1], strip) + bqkv.float()).to(dt)
    core = window_attention_core_nhwc if dispatch else reference_attention_nhwc
    att = core(qkv.reshape(b, h, w, 3 * c), bias, mask, ws, nh, scale)
    aq = point(att.float().reshape(m, c))
    y = _q8_deq(aq[0], *qw["wp"], aq[1], strip) + bp.float()
    log_kernel_amax(torch.cat(slots), len(slots))
    return y.reshape(b, h, w, c).to(dt)


def block_attention_ln_q8_chain_plain(x, lnw, lnb, wqkv, bqkv, wp, bp, bias,
                                      mask, ws: int, nh: int, scale: float,
                                      shift: int = 0, q8=None,
                                      dispatch: bool = False):
    """K3's twin as `sodt_block_attention_q8` runs it: the mirror with the
    LN."""
    return block_attention_q8_chain_plain(x, wqkv, bqkv, wp, bp, bias, mask,
                                          ws, nh, scale, shift, q8, dispatch,
                                          ln=(lnw, lnb))

# ------------------------------------------------------- K12 for K3 and K5

def _block_attention_q8(x, ln, wqkv, bqkv, wp, bp, bias, mask, ws, nh, scale,
                        shift, q8):
    """The int8 body of K3 (`ln` given) or K5, a `Replay` whose backward
    replays the bf16 composition (`_fbal_bwd` / `_fba_bwd`): on the card
    the chain `sodt_block_attention_q8` of csrc/int8_chains.cu, on the CPU
    `block_attention_[ln_]q8_plain` (`block_attention_q8_chain_plain`
    mirrors the chain).

    Design (csrc/int8_chains.cu, on the s8 wgmma core of
    csrc/gemm_s8_core.cuh): a strip's scale must be known before any CTA
    quantizes it, so the body runs as launches split at its two
    quantization points, and each point's producer runs twice, a fold of
    the strip abs-max and then the int8 codes under the finished scale: a
    row pass over the (-shift, -shift)-rolled map read in place ([LN1
    rounded to bf16 ->] fold, codes), the qkv GEMM (s8 x s8 -> s32 wgmma,
    bf16(v + bqkv) in its epilogue), K1's bf16 attention core, the row
    passes of its output, the proj GEMM (bf16(v + bp)). Bound by
    operations (8*C^2 per token in the projections at twice the bf16 rate)
    at the flagship's shapes; the chain's own traffic (28 M*C bytes: qkv
    and att in bf16 between launches, the codes) takes longer than that."""
    qw = q8_weights(q8, wqkv=wqkv, wp=wp)
    if x.is_cuda:
        name = ("fused_block_attention_ln" if ln is not None
                else "fused_block_attention") + " int8"
        b, h, w, c = x.shape
        _check_cuda(name, torch.bfloat16, x=x, wqkv=wqkv, bqkv=bqkv, wp=wp,
                    bp=bp)
        lnw, lnb = ln if ln is not None else (None, None)
        _check_cuda(name, torch.float32, lnw=lnw, lnb=lnb, bias=bias,
                    mask=mask)
        _require(c % nh == 0 and c % 32 == 0 and c <= 512
                 and window_core_supported(ws * ws, c // nh),
                 f"{name}: C={c}, nh={nh}, window of {ws * ws} tokens")
        _require(tuple(wqkv.shape) == (3 * c, c) and tuple(wp.shape) == (c, c),
                 f"{name}: weight shapes")
        _require(b * h * w <= 65535 * 128, f"{name}: {b * h * w} tokens")
        _check_window_args(name, b, h, w, nh, ws, bias, mask, shift)
    consts = (ws, nh, scale, shift, qw)
    tensors = (wqkv, bqkv, wp, bp, bias, mask)
    if ln is None:
        launch = (_launch_block_attention_q8 if x.is_cuda
                  else block_attention_q8_plain)
        compose = lambda *a: _compose_block_attention(*a[:-1])
        return Replay.apply(launch, compose, consts, x, *tensors)
    launch = (_launch_block_attention_ln_q8 if x.is_cuda
              else block_attention_ln_q8_plain)
    compose = lambda *a: _compose_block_attention_ln(*a[:-1])
    return Replay.apply(launch, compose, consts, x, *ln, *tensors)


def _launch_block_attention_q8(x, wqkv, bqkv, wp, bp, bias, mask, ws, nh,
                               scale, shift, qw):
    out = _block_attention_q8_entry(x, None, None, wqkv, bqkv, wp, bp, bias,
                                    mask, ws, nh, scale, shift, qw)
    LAUNCHES["block_attention_q8"] += 1
    return out


def _launch_block_attention_ln_q8(x, lnw, lnb, wqkv, bqkv, wp, bp, bias,
                                  mask, ws, nh, scale, shift, qw):
    out = _block_attention_q8_entry(x, lnw, lnb, wqkv, bqkv, wp, bp, bias,
                                    mask, ws, nh, scale, shift, qw)
    LAUNCHES["block_attention_ln_q8"] += 1
    return out


def _block_attention_q8_entry(x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask,
                              ws, nh, scale, shift, qw):
    """`sodt_block_attention_q8`: K3's body with the LN (lnw given), K5's
    without."""
    b, h, w, c = x.shape
    m = b * h * w
    out = torch.empty_like(x)
    codes = torch.empty(m * c, dtype=torch.int8, device=x.device)
    bf16ws = torch.empty(m * 4 * c, dtype=torch.bfloat16, device=x.device)
    amax = torch.empty(2 * b * (h // ws), dtype=torch.float32, device=x.device)
    (wqkv_q, sqkv), (wp_q, sp) = qw["wqkv"], qw["wp"]
    ptr = lambda t: None if t is None else t.data_ptr()
    scale_dt = float(torch.tensor(scale, dtype=x.dtype))
    groups = fwd_groups(b * (h // ws) * (w // ws), ws * ws, nh)
    _build.check(_build.library().sodt_block_attention_q8(
        x.data_ptr(), ptr(lnw), ptr(lnb), wqkv_q.data_ptr(), sqkv.data_ptr(),
        bqkv.data_ptr(), wp_q.data_ptr(), sp.data_ptr(), bp.data_ptr(),
        bias.data_ptr(), ptr(mask), out.data_ptr(), codes.data_ptr(),
        bf16ws.data_ptr(), amax.data_ptr(), int(lnw is not None), b, h, w, c,
        nh, ws, shift, int(mask is not None), scale_dt, groups,
        _build.stream_ptr()), "fused_block_attention int8")
    log_kernel_amax(amax, 2)
    return out


# ---------------------------------------------------------------------- K1

def fused_window_attention_nhwc(qkv, bias, mask, ws: int, nh: int,
                                scale: float):
    """Windowed multi-head attention core on an unpartitioned qkv map.

    Replaces `sodt_tpu/pallas/window_attention.py`
    `fused_window_attention_nhwc` (l.750, body `_strip_kernel` l.378).
    qkv (B, H, W, 3C) bf16 (already padded/rolled by the caller); bias
    (nh, N, N) f32; mask (nW, N, N) f32 or None. Returns (B, H, W, C).

    On the H100 it is bound by bytes: 8 * C bytes per token (qkv read, out
    written) against 4*N*C operations. Two hand-written bodies, chosen by
    the window's N = ws * ws (`fwd_body`), the core K5 launches between
    its projections too:
    - N <= 64 (ws 8 and 4: every configuration of the repo): the register
      body of csrc/window_attention_fwd.cuh, one CTA per (head, group of
      windows), `fwd_groups` groups; a two-stage cp.async ring of the
      head's Q, K, V (+ mask) rows; each warp takes 16 query rows with S
      and P in registers (mma.sync), P packed to bf16 A fragments for PV,
      the output staged by stmatrix and stored 16 bytes a lane.
    - N > 64 (ws 16, no configuration): the strip body of
      csrc/window_attention.cuh, one CTA per (head, window), scores and
      the f32 softmax in shared memory.
    q is scaled in bf16 as in JAX, P rounded to bf16 before PV
    (`attention_fwd_mirror` mirrors the register body). Window packing
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
    return _WindowAttention.apply(qkv, bias, mask, ws, nh, scale)


class _WindowAttention(torch.autograd.Function):
    """K1 forward, K9 backward, on the residuals (qkv, bias, mask)."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, ws, nh, scale):
        ctx.consts = (ws, nh, scale)
        ctx.save_for_backward(qkv, bias, mask)
        out = _window_core(qkv, bias, mask, ws, nh, scale, 0,
                           "fused_window_attention_nhwc")
        LAUNCHES["window_attention"] += 1
        return out

    @staticmethod
    def backward(ctx, gy):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, mask, *ctx.consts, gy)
        return dqkv, dbias, None, None, None, None


# ------------------------------------------------- K1, K5, K11 forward rules

FWD_CTAS = 3 * 132  # the forward's register body: the CTAs a launch aims at


def fwd_body(n: int) -> str:
    """The forward's body for windows of n tokens (K1, K5's core, K11's
    forward, K12's cores): "regs" (n <= 64, every window of the repo's
    configurations: window_attn_fwd_kernel of csrc/window_attention_fwd.cuh,
    the scores in registers) or "strips" (n > 64: window_attn_kernel of
    csrc/window_attention.cuh, the scores in shared memory)."""
    return "regs" if n <= 64 else "strips"


def fwd_groups(total: int, n: int, nh: int) -> int:
    """Groups of windows (CTAs per head) of the forward over `total`
    windows of n tokens and nh heads.

    Register body: the launch has nh * groups CTAs, one per (head, group),
    each walking its group's stages through its cp.async ring, and aims at
    FWD_CTAS = 3 * 132, one wave of the three CTAs that fit on each of the
    H100's 132 SMs (their registers: 164-168 a thread at head dims 16 and
    32), so groups = ceil(FWD_CTAS / nh), at most the number of stages (a
    CTA takes at least one) and at least 1. On the H100, 264, 528, 660, 792
    and 1,056 CTAs timed level or up to 1.5x slower than 396
    (`tools/bench_window_attention_fwd.py --ctas`). Strip body: one CTA per
    (head, window), `total` (the kernel does not read it)."""
    if fwd_body(n) == "strips":
        return total
    stages = -(-total // stage_windows(n))
    return max(1, min(stages, -(-FWD_CTAS // nh)))


# ---------------------------------------------------------------------- K9

BWD_GROUPS = 128    # CTAs (dbias partials) per head: the strip body (N > 64)
BWD_CTAS = 2 * 132  # the register body (N <= 64): the CTAs a launch aims at


def bwd_body(n: int) -> str:
    """The backward's body for windows of n tokens (K9 and K11's
    backward): "regs" (n <= 64, every window of the repo's configurations:
    window_attn_bwd_regs_kernel of csrc/window_attention_bwd.cuh, the
    scores in registers) or "strips" (n > 64: window_attn_bwd_kernel of
    csrc/window_attention.cuh, the score strips in shared memory)."""
    return "regs" if n <= 64 else "strips"


def stage_windows(n: int) -> int:
    """Windows of one 64-row stage of the register bodies (forward and
    K9): four at n <= 16 (padded to 16 tokens), else one (padded to 64)."""
    return 4 if n <= 16 else 1


def bwd_groups(total: int, n: int, nh: int) -> int:
    """Groups of windows (CTAs per head, dbias partials) of the backward
    (K9, and K11's on its token windows) over `total` windows of n tokens
    and nh heads.

    Register body: the launch has nh * groups CTAs, one per (head, group),
    and aims at BWD_CTAS = 2 * 132, one wave of the two CTAs that fit on
    each of the H100's 132 SMs (their registers: 223 and 249 a thread at
    head dims 16 and 32), so groups = ceil(BWD_CTAS / nh), at most the
    number of stages (a CTA takes at least one) and at least 1. At the
    flagship's 12 heads that is 22 groups, 264 CTAs; on the H100 two and
    four CTAs an SM timed level or slower, three (1.5 waves) slower still
    (`tools/bench_window_attention_bwd.py --ctas`). Fewer groups also mean
    fewer dbias partials to write and sum. Strip body:
    min(total, BWD_GROUPS)."""
    if bwd_body(n) == "strips":
        return min(total, BWD_GROUPS)
    stages = -(-total // stage_windows(n))
    return max(1, min(stages, -(-BWD_CTAS // nh)))


def window_attention_bwd(qkv, bias, mask, ws: int, nh: int, scale: float, gy):
    """Backward of the windowed attention core: (dqkv, dbias).

    Replaces `sodt_tpu/pallas/window_attention.py`
    `_pallas_attention_nhwc_bwd` (l.836, body `_bwd_strip_kernel` l.761,
    `_unpack_dbias` l.824). qkv (B, H, W, 3C) bf16 and bias / mask as K1
    saved them; gy (B, H, W, C) bf16, made contiguous here (autograd may
    hand over a view). Returns dqkv (B, H, W, 3C) bf16 and dbias
    (nh, N, N) f32, summed over the batch and the windows.

    Two hand-written bodies, chosen by the window's N = ws * ws
    (`bwd_body`; csrc/window_attention_bwd.cu):
    - N <= 64 (ws 8 and 4: every configuration of the repo): one CTA per
      (head, group of windows), `bwd_groups` groups; a two-stage cp.async
      ring of the head's Q, K, V, dO (+ mask) rows; each warp takes 16
      query rows with S, P, dP and dS in registers (mma.sync), dQ from dS
      packed in registers, P and dS stored once as bf16, then 16 key rows
      for dV = P^T dO and dK = dS^T Q through ldmatrix.trans: five
      products, no score recomputed. The bias rows sit in registers, and
      the CTA's dbias partial too, written once.
    - N > 64 (ws 16, no configuration): the strip body of
      csrc/window_attention.cuh, min(B * nW, 128) groups.
    K11's backward runs the same two bodies on its token windows
    (`window_attention_tokens_bwd`).
    The bound is bytes (7 * C * 2 per token against 10 * N * C
    operations). dbias is summed in two deterministic passes (a partial
    per group, each address owned by one thread, then a reduction in
    group order): no f32 atomics, bit-equal repeats. P and dS are rounded
    to bf16 before their products (`attention_nhwc_bwd_mirror` mirrors
    it); the f32 scores are scaled by the unrounded `scale` (the Pallas
    backward does not pre-scale q in bf16 as its forward does).
    """
    if not qkv.is_cuda:
        return attention_nhwc_bwd_plain(qkv, bias, mask, ws, nh, scale, gy)
    name = "window_attention_bwd"
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    n = ws * ws
    gy = gy.contiguous()
    _check_cuda(name, torch.bfloat16, qkv=qkv, gy=gy)
    _check_cuda(name, torch.float32, bias=bias, mask=mask)
    _require(c3 % (3 * nh) == 0 and window_core_supported(n, hd),
             f"{name}: window of {n} tokens, head dim {hd}")
    _require(tuple(gy.shape) == (b, h, w, c), f"{name}: gy shape")
    _check_window_args(name, b, h, w, nh, ws, bias, mask, 0)
    groups = bwd_groups(b * (h // ws) * (w // ws), n, nh)
    lib = _build.library()
    entry = (lib.sodt_window_attention_bwd_regs if bwd_body(n) == "regs"
             else lib.sodt_window_attention_bwd)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((groups, nh, n, n), dtype=torch.float32,
                       device=qkv.device)
    dbias = torch.empty((nh, n, n), dtype=torch.float32, device=qkv.device)
    _build.check(entry(
        qkv.data_ptr(), gy.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
        part.data_ptr(), dbias.data_ptr(), b, h, w, c, nh, ws,
        int(mask is not None), float(scale), groups, _build.stream_ptr()),
        name)
    LAUNCHES["window_attention_bwd"] += 1
    return dqkv, dbias


# --------------------------------------------------------------------- K11

def fused_window_attention(qkv, bias, mask, nw: int, nh: int, scale: float):
    """Windowed multi-head attention core on pre-partitioned windows.

    Replaces `sodt_tpu/pallas/window_attention.py` `fused_window_attention`
    (l.156, body `_kernel` l.61). qkv (W, N, 3C) bf16, the layout the qkv
    projection of window tokens leaves; bias (nh, N, N) f32; mask
    (nw, N, N) f32 or None, window w takes mask[w mod nw] (nw = 1 and any W
    when there is no mask). Returns (W, N, C):
    softmax(q * scale @ k^T + bias[h] + mask[w mod nw]) @ v per head, q
    scaled in bf16, scores and softmax f32, P rounded to bf16 before P @ V.

    On the H100 its bound is bytes (8 * C bytes per token against 4 * N * C
    operations, N <= 256). Design (csrc/window_attention_tokens.cu): K1's
    forward with the token addressing — at N <= 64 the register body, one
    CTA per (head, group of windows, `fwd_groups`) copying each window's N
    contiguous rows with 16-byte cp.async, scores and P in registers;
    above, the strip body — so no copy into map layout stands on the path.
    The TPU kernel's window groups (`_pick_group`, sized to VMEM) are not
    carried over.
    """
    if not qkv.is_cuda:
        return reference_attention_qkv(qkv, bias, mask, nw, nh, scale)
    _check_tokens_args("fused_window_attention", qkv, bias, mask, nw, nh)
    return _WindowAttentionTokens.apply(qkv, bias, mask, nw, nh, scale)


def _check_tokens_args(name, qkv, bias, mask, nw, nh):
    """The domain K11's forward and backward share."""
    _require(qkv.ndim == 3, f"{name}: qkv must be (W, N, 3C)")
    w, n, c3 = qkv.shape
    _check_cuda(name, torch.bfloat16, qkv=qkv)
    _check_cuda(name, torch.float32, bias=bias, mask=mask)
    _require(c3 % (3 * nh) == 0 and window_core_supported(n, c3 // 3 // nh),
             f"{name}: window of {n} tokens, head dim {c3 // 3 // nh}")
    _require(tuple(bias.shape) == (nh, n, n), f"{name}: bias shape")
    if mask is None:
        _require(nw == 1, f"{name}: nw must be 1 without a mask")
    else:
        _require(tuple(mask.shape) == (nw, n, n) and w % nw == 0,
                 f"{name}: mask shape {tuple(mask.shape)} for {w} windows, "
                 f"nw {nw}")
    _require(1 <= w <= 65535, f"{name}: {w} windows")


class _WindowAttentionTokens(torch.autograd.Function):
    """K11 forward, K11 backward, on the residuals (qkv, bias, mask)."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, nw, nh, scale):
        ctx.consts = (nw, nh, scale)
        ctx.save_for_backward(qkv, bias, mask)
        w, n, c3 = qkv.shape
        out = torch.empty((w, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
        scale_dt = float(torch.tensor(scale, dtype=qkv.dtype))
        _build.check(_build.library().sodt_window_attention_tokens(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), w, n,
            c3 // 3, nh, nw, scale_dt, fwd_groups(w, n, nh),
            _build.stream_ptr()), "fused_window_attention")
        LAUNCHES["window_attention_tokens"] += 1
        return out

    @staticmethod
    def backward(ctx, gy):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_tokens_bwd(qkv, bias, mask,
                                                  *ctx.consts, gy)
        return dqkv, dbias, None, None, None, None


def window_attention_tokens_bwd(qkv, bias, mask, nw: int, nh: int,
                                scale: float, gy):
    """Backward of K11: (dqkv, dbias).

    Replaces `sodt_tpu/pallas/window_attention.py` `_pallas_attention_bwd`
    (l.264, body `_bwd_kernel` l.206). qkv (W, N, 3C) bf16 and bias / mask
    as the forward saved them; gy (W, N, C) bf16, made contiguous here.
    Returns dqkv (W, N, 3C) bf16 and dbias (nh, N, N) f32 summed over the
    windows.

    K9's two bodies with the token addressing, chosen by the window's N
    (`bwd_body`; csrc/window_attention_tokens.cu):
    - N <= 64 (every window of the repo's configurations: SwinV2's are 64
      tokens at head dim 32): K9's register body of
      csrc/window_attention_bwd.cuh (`WrTokens`: window w's rows are
      w * N ..., its mask mask[w mod nw]), one CTA per (head, group of
      windows), `bwd_groups` groups, S / P / dP / dS in registers, five
      products (`window_attention_bwd` describes it);
      `attention_qkv_bwd_mirror` mirrors it.
    - N > 64: the strip body of csrc/window_attention.cuh
      (`TokenWindows`), min(W, 128) groups.
    The f32 scores are scaled by the unrounded `scale`, P and dS are
    rounded to bf16 before the tensor-core products (the Pallas kernel
    keeps them in f32), and dbias takes two deterministic passes - a
    partial per group of windows, then a reduction in group order - where
    the TPU kernel accumulates across its sequential grid: no f32 atomics,
    at the price of groups * nh * N * N floats of scratch.
    """
    if not qkv.is_cuda:
        return attention_qkv_bwd_plain(qkv, bias, mask, nw, nh, scale, gy)
    name = "window_attention_tokens_bwd"
    gy = gy.contiguous()
    _check_tokens_args(name, qkv, bias, mask, nw, nh)
    w, n, c3 = qkv.shape
    _check_cuda(name, torch.bfloat16, gy=gy)
    _require(tuple(gy.shape) == (w, n, c3 // 3), f"{name}: gy shape")
    groups = bwd_groups(w, n, nh)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((groups, nh, n, n), dtype=torch.float32,
                       device=qkv.device)
    dbias = torch.empty((nh, n, n), dtype=torch.float32, device=qkv.device)
    _build.check(_build.library().sodt_window_attention_tokens_bwd(
        qkv.data_ptr(), gy.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
        part.data_ptr(), dbias.data_ptr(), w, n, c3 // 3, nh, nw,
        float(scale), groups, _build.stream_ptr()), name)
    LAUNCHES["window_attention_tokens_bwd"] += 1
    return dqkv, dbias


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
    (flagship stage 3 off the 512 px size, e.g. 608 px: a 38x38 map padded
    to four 32x32 windows).

    On the H100 the bound is bytes: the f32 (nh, N, N) bias is 50 MB at
    N=1024 and nh=12. Design (csrc/global_attention.cu, body in
    csrc/global_attention.cuh): flash style, one CTA of 4 warps per (64
    query rows, window, head); scores, softmax state, P and the output
    accumulator stay in registers (mma.sync from ldmatrix operands); K, V
    (straight from the fused qkv layout) and the bias (+ mask) tiles come
    through a two-stage cp.async ring; the grid runs the windows of one
    (head, query block) side by side, so each bias tile comes from HBM
    about once. Under autograd it also keeps each row's log-sum-exp and
    its output in f32 for K10 where K10's scores equal its own
    (`lse_reusable`).
    """
    if not qkv.is_cuda:
        return global_attention_plain(qkv, bias, nh, scale, ws, mask)
    ws = ws or qkv.shape[1]
    _check_global_args("fused_global_attention", qkv, bias, mask, nh, ws)
    return _GlobalAttention.apply(qkv, bias, mask, nh, scale, ws)


def _check_global_args(name, qkv, bias, mask, nh, ws):
    """The domain K8 and K10 share."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
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


def lse_reusable(scale: float) -> bool:
    """Whether K10 may take K8's log-sum-exp. K8 scales q in bf16 before
    QK^T (`_global_kernel`), K10 scales the f32 scores
    (`_global_chunk_grads`); the two S agree only where q * scale is exact
    in bf16, that is where the scale is a power of two (head dim 16 or 64)."""
    return math.frexp(scale)[0] == 0.5


def _launch_global(qkv, bias, mask, nh: int, scale: float, ws: int,
                   with_stats: bool = False):
    """K8's launch: (out, stats). With `with_stats` stats = (O in f32 with
    P's bf16 rounding residue added back, (B, H, W, C); each row's
    log-sum-exp, (B*nW, nh, N) f32), what K10 takes where `lse_reusable`;
    else None. `out` does not depend on `with_stats`."""
    b, h, w, c3 = qkv.shape
    out = torch.empty(qkv.shape[:-1] + (c3 // 3,), dtype=qkv.dtype,
                      device=qkv.device)
    stats = None
    if with_stats:
        stats = (torch.empty(out.shape, dtype=torch.float32,
                             device=qkv.device),
                 torch.empty((b * (h // ws) * (w // ws), nh, ws * ws),
                             dtype=torch.float32, device=qkv.device))
    scale_dt = float(torch.tensor(scale, dtype=qkv.dtype))
    _build.check(_build.library().sodt_global_attention(
        qkv.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if stats is None else stats[1].data_ptr(),
        None if stats is None else stats[0].data_ptr(), b, h, w, c3 // 3, nh,
        ws, int(mask is not None), scale_dt, _build.stream_ptr()),
        "fused_global_attention")
    LAUNCHES["global_attention"] += 1
    return out, stats


class _GlobalAttention(torch.autograd.Function):
    """K8 forward, K10 backward, on the residuals (qkv, bias, mask) and,
    where `lse_reusable(scale)`, K8's f32 output and log-sum-exp."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, nh, scale, ws):
        ctx.consts = (nh, scale, ws)
        keep = lse_reusable(scale) and any(ctx.needs_input_grad[:2])
        out, stats = _launch_global(qkv, bias, mask, nh, scale, ws, keep)
        ctx.save_for_backward(qkv, bias, mask, *(stats or (None, None)))
        return out

    @staticmethod
    def backward(ctx, gy):
        qkv, bias, mask, o32, lse = ctx.saved_tensors
        nh, scale, ws = ctx.consts
        dqkv, dbias = global_attention_bwd(
            qkv, bias, nh, scale, gy, ws, mask,
            stats=None if lse is None else (o32, lse))
        return dqkv, dbias, None, None, None, None


# --------------------------------------------------------------------- K10

def _heads(t, ws: int, nh: int, k: int):
    """(B, H, W, k*C) -> (k, B*nW, nh, N, hd) f32, windows in K8 / K10's
    order (b * nW + window index)."""
    b, h, w, kc = t.shape
    hd = kc // k // nh
    t = t.reshape(b, h // ws, ws, w // ws, ws, k, nh, hd)
    return (t.permute(5, 0, 1, 3, 6, 2, 4, 7).float()
            .reshape(k, -1, nh, ws * ws, hd))


def _scores(qkv, bias, nh: int, scale: float, ws: int, mask, forward: bool):
    """S of every (window, head): K8's (q scaled in the working dtype, then
    QK^T) with `forward`, else K10's ((q k^T) * scale in f32), + bias
    (+ mask), (B*nW, nh, N, N) f32."""
    q, k, _ = _heads(qkv, ws, nh, 3)
    if forward:
        c = qkv.shape[-1] // 3
        q = _heads(_scaled(qkv[..., :c], scale), ws, nh, 1)[0]
        s = torch.matmul(q, k.transpose(-1, -2))
    else:
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, *s.shape[1:])
             + mask.float()[None, :, None]).reshape(s.shape)
    return s


def global_attention_lse_plain(qkv, bias, nh: int, scale: float,
                               ws: int | None = None, mask=None,
                               forward: bool = False):
    """The natural log-sum-exp over the keys of every row, (B*nW, nh, N)
    f32: of K8's S with `forward` (what K8 keeps for K10), else of K10's
    S (what K10's statistics step computes)."""
    return torch.logsumexp(_scores(qkv, bias, nh, scale, ws or qkv.shape[1],
                                   mask, forward), dim=-1)


def global_attention_delta_plain(out, gy, nh: int, ws: int | None = None):
    """delta = rowsum(dO * O) per (window, head, row), (B*nW, nh, N) f32,
    from K8's output O and the cotangent dO, both (B, H, W, C)."""
    ws = ws or out.shape[1]
    return (_heads(out, ws, nh, 1)[0] * _heads(gy, ws, nh, 1)[0]).sum(-1)


def global_attention_bwd_stats_plain(qkv, bias, nh: int, scale: float, gy,
                                     lse, delta, ws: int | None = None,
                                     mask=None):
    """K10's arithmetic from given row statistics, in f32: P = exp(S -
    lse), dS = P * (dO V^T - delta), dQ = scale dS K, dK = scale dS^T Q,
    dV = P^T dO, dbias = dS summed over batch and windows. Returns (dqkv
    in qkv's dtype, dbias (nh, N, N) f32)."""
    b, h, w, c3 = qkv.shape
    ws = ws or h
    q, k, v = _heads(qkv, ws, nh, 3)
    do = _heads(gy, ws, nh, 1)[0]
    p = torch.exp(_scores(qkv, bias, nh, scale, ws, mask, False)
                  - lse[..., None])
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta[..., None])
    dq = scale * torch.matmul(ds, k)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dx = torch.stack([dq, dk, dv])          # (3, B*nW, nh, N, hd)
    hd = dx.shape[-1]
    dx = dx.reshape(3, b, h // ws, w // ws, nh, ws, ws, hd)
    dx = dx.permute(1, 2, 5, 3, 6, 0, 4, 7).reshape(b, h, w, c3)
    return dx.to(qkv.dtype), ds.sum(dim=0)


def global_attention_bwd(qkv, bias, nh: int, scale: float, gy,
                         ws: int | None = None, mask=None, stats=None):
    """Backward of K8: (dqkv, dbias), over the whole domain K8 takes (one
    window, or several ws x ws windows with an optional mask).

    Replaces `sodt_tpu/pallas/window_attention.py`
    `_pallas_global_attention_bwd` (l.1071, bodies
    `_global_bwd_dqkv_kernel` l.1023 and `_global_bwd_dbias_kernel` l.1053).
    qkv (B, H, W, 3C) bf16, gy (B, H, W, C) bf16 (made contiguous here) ->
    dqkv bf16 and dbias (nh, N, N) f32 summed over batch and windows.
    `stats` = K8's (f32 output, log-sum-exp) from `_launch_global`, given
    only where `lse_reusable(scale)`; without it the kernel computes the
    statistics.

    On the H100 the bound is bytes at small batch: the f32 bias read and
    the f32 dbias written are 50 MB each at N = 1024, nh = 12. Design
    (csrc/global_attention_bwd.cu): the row statistics (log-sum-exp and
    delta = rowsum(dO * O), O in f32 with P's bf16 rounding residue added
    back) from K8 or from K8's body in a statistics mode; a dQ + dbias kernel, one CTA per (32 query rows, head) walking
    every window in order with its 32 x N dbias slab in shared memory
    (one owner thread per entry: deterministic, no atomics, written once);
    a dK / dV kernel, one CTA per (64 keys, window, head) over the query
    blocks. Scores, P, dS and the accumulators live in registers; tiles
    come through two-stage cp.async rings. One counted launch per call.
    """
    if not qkv.is_cuda:
        return global_attention_bwd_plain(qkv, bias, nh, scale, gy, ws, mask)
    name = "global_attention_bwd"
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    ws = ws or h
    n = ws * ws
    gy = gy.contiguous()
    _check_global_args(name, qkv, bias, mask, nh, ws)
    _check_cuda(name, torch.bfloat16, gy=gy)
    _require(tuple(gy.shape) == (b, h, w, c), f"{name}: gy shape")
    total = b * (h // ws) * (w // ws)
    out = lse = None
    if stats is not None:
        out, lse = stats
        _require(lse_reusable(scale), f"{name}: K8's statistics are of "
                 f"another S at scale {scale}")
        _check_cuda(name, torch.float32, out=out, lse=lse)
        _require(tuple(out.shape) == (b, h, w, c)
                 and tuple(lse.shape) == (total, nh, n), f"{name}: stats")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((nh, n, n), dtype=torch.float32, device=qkv.device)
    scratch = torch.empty((2, total, nh, n), dtype=torch.float32,
                          device=qkv.device)
    _build.check(_build.library().sodt_global_attention_bwd(
        qkv.data_ptr(), gy.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if out is None else out.data_ptr(),
        None if lse is None else lse.data_ptr(), dqkv.data_ptr(),
        dbias.data_ptr(), scratch.data_ptr(), b, h, w, c, nh, ws,
        int(mask is not None), float(scale), _build.stream_ptr()), name)
    LAUNCHES["global_attention_bwd"] += 1
    return dqkv, dbias


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


def window_attention_core(qkv, bias, mask, nw: int, nh: int, scale: float):
    """The attention core on pre-partitioned (W, N, 3C) windows
    (`window_attention_core` l.185), by JAX's gate: a CUDA bf16 tensor
    with windows of up to 256 tokens goes to K11, whose wrapper raises
    outside the kernel's domain (`window_core_supported`: head dims of
    whole tensor-core tiles); f32, CPU tensors and larger windows take the
    plain composition."""
    if qkv.is_cuda and qkv.dtype == torch.bfloat16 and qkv.shape[1] <= 256:
        return fused_window_attention(qkv, bias, mask, nw, nh, scale)
    return reference_attention_qkv(qkv, bias, mask, nw, nh, scale)
