"""int8 serving arithmetic (K12): the weight and activation quantizers of
`sodt_tpu/pallas/swin_block.py` (`_q8_weight` l.72, `_q8_dot` l.80,
`_q8_weight_conv` l.417) in torch's weight layout, and the plain pieces the
int8 bodies share.

  weights      one scale per output channel, s = max(max|w|, 1e-8) / 127
               over the input axis (Linear (out, in): per row; the conv in
               `conv_taps` layout (out, 2, 2, in): over (kh, kw, in), one
               scale for the four taps), q = clip(round(w / s), -127, 127)
               with round half to even and a true division
  activations  one scalar per strip, sx = max(max|x|, 1e-8) / 127, the
               same rounding; the int32 product is exact and dequantizes as
               acc.float() * (s_w * sx)

A strip is one Pallas grid program: image b and `ws` whole map rows (the
shifted rows for a shifted block), plus the conv's halo row for the conv
tails. The plain versions keep a strip as the leading axes of a
(B, strips, rows, K) tensor. `int8 @ int8` in torch returns int8, and int32
products do not exist on the card, so the plain product runs in float64:
exact, since |acc| <= 127^2 * K < 2^53, and `.float()` of it rounds as
JAX's `acc.astype(f32)` does.

`strip_amax_log()` makes the strip scales visible: within it, every int8
body appends what its activation scales are made of, so a kernel's scales
can be held against its plain version's (the output alone hides them: a
wrong scale moves each value by less than one code step).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_amax_log: list | None = None


@contextlib.contextmanager
def strip_amax_log():
    """Yields a list that collects, for each quantization point of every
    int8 body run within the context, in the body's order, one f32 tensor
    (strips, r): the abs-max of each strip's rows, whose max over r is the
    strip's abs-max (the scale is max(it, 1e-8) / 127). The plain bodies
    give every row of a strip (r = its rows, in strip order: the halo row
    last); the kernels give r = 1, the slot that atomicMax filled."""
    global _amax_log
    prev, _amax_log = _amax_log, []
    try:
        yield _amax_log
    finally:
        _amax_log = prev


def log_kernel_amax(amax: torch.Tensor, points: int) -> None:
    """A kernel's per-strip slots, `points` quantization points of as many
    strips each, into the open `strip_amax_log`, if any."""
    if _amax_log is not None:
        _amax_log.extend(a[:, None] for a in amax.view(points, -1))


def tail_ws(h: int, target: int = 8) -> int:
    """Strip height of the tail kernels (`_tail_ws`): the window size when
    it divides H, else the largest divisor <= target."""
    if h % target == 0:
        return target
    for ws in range(min(target, h), 0, -1):
        if h % ws == 0:
            return ws
    return 1


def _q8(x32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / s), -127, 127)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as a true division on any device: divided by
    a python number, a CUDA tensor is multiplied by its f32 reciprocal,
    which rounds 1 in ~20 quotients differently (torch.full: no copy from
    the host)."""
    return torch.clamp_min(amax, 1e-8) / torch.full((), 127.0,
                                                    device=amax.device)


def q8_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 (out, in), f32 (out,) scales)."""
    w32 = w.float()
    s = _scale(w32.abs().amax(dim=1))
    return _q8(w32, s[:, None]).to(torch.int8).contiguous(), s.contiguous()


def q8_weight_conv(wc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, 2, 2, in) conv taps -> int8 taps and ONE f32 scale per output
    channel for the four taps (their int32 sums add before dequantizing)."""
    w32 = wc.float()
    s = _scale(w32.abs().amax(dim=(1, 2, 3)))
    return (_q8(w32, s[:, None, None, None]).to(torch.int8).contiguous(),
            s.contiguous())


def q8_weights(q8: dict | None, **weights) -> dict:
    """{name: (int8, scales)} of the named weights (compute dtype): `q8`
    itself when the caller holds them (`SwinBlock.cache_kernel_weights`),
    else quantized now, as JAX quantizes `w.astype(dt)` at each call. The
    conv is the entry named "wc"."""
    if q8 is not None:
        return {k: q8[k] for k in weights}
    return {k: q8_weight_conv(w) if k == "wc" else q8_weight(w)
            for k, w in weights.items()}


def strip_scale(x32: torch.Tensor) -> torch.Tensor:
    """Per-strip activation scale of x32 (..., rows, K): (..., 1, 1)."""
    return _scale(x32.abs().amax(dim=(-2, -1), keepdim=True))


def q8_quantize(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x32 (..., rows, K) -> (codes as float, per-strip scale)."""
    if _amax_log is not None:
        _amax_log.append(x32.abs().amax(-1).reshape(-1, x32.shape[-2]))
    sx = strip_scale(x32)
    return _q8(x32, sx), sx


def q8_matmul(codes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of codes (..., K) and int8 wq (N, K), as f32."""
    return torch.matmul(codes.double(), wq.double().t()).float()


def _q8_point(v: torch.Tensor, strip: torch.Tensor, s: int):
    """A quantization point of a chain over rows v (rows, K) f32, `strip`
    the strip of each row: the strip slots (max |v| a strip, what atomicMax
    folds) and the int8 codes of v under its strip's finished scale."""
    slots = torch.zeros(s, dtype=torch.float32, device=v.device).scatter_reduce(
        0, strip, v.abs().amax(-1), "amax")
    sx = _scale(slots)[strip][:, None]
    return _q8(v, sx).to(torch.int8), slots


def _q8_deq(codes, wq, sw, slots, strip) -> torch.Tensor:
    """The s8 core's dequantized product float(acc) * (sw * sx(m))."""
    return q8_matmul(codes, wq) * (sw * _scale(slots)[strip][:, None])


def q8_dot(x32: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor):
    """`_q8_dot`: x32 (..., rows, K) f32, one scale per strip (the leading
    axes) -> dequantized f32 (..., rows, N)."""
    codes, sx = q8_quantize(x32)
    return q8_matmul(codes, wq) * (sw * sx)


def ln_f32(x32: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
           eps: float = 1e-5) -> torch.Tensor:
    """`_ln_rows_vpu(x) * g + b` in f32: E[x^2] - mu^2 statistics."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`_gelu_in_kernel`: the tanh GELU the Pallas kernels always use."""
    return F.gelu(x, approximate="tanh")


def to_strips(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, K) -> (B, H // ws, ws * W, K): one strip per Pallas grid
    program."""
    b, h, w, k = x.shape
    return x.reshape(b, h // ws, ws * w, k)


def fc1_halo_q8(t: torch.Tensor, ws: int, w: int, w1q8, b1) -> torch.Tensor:
    """fc1 of the conv tails over each strip and its halo row, t
    (B, nr, (ws+1)*W, C) f32, as `_q8_dot` with one scale over both; the
    last strip's halo row is then zeroed (the pad on fc1's output), as the
    Pallas kernels do it, by a factor 0."""
    f1 = q8_dot(t, *w1q8) + b1.float()
    flag = torch.ones(f1.shape[1], device=f1.device)
    flag[-1] = 0.0
    halo = f1[:, :, ws * w:] * flag[None, :, None, None]
    return torch.cat([f1[:, :, :ws * w], halo], dim=2)


def conv_gelu_fc2_q8(f1: torch.Tensor, ws: int, w: int, wcq, sc, bc, w2q,
                     s2, b2) -> torch.Tensor:
    """The int8 branch of `_conv_gelu_fc2` (l.374): f1 (B, nr, (ws+1)*W, C)
    f32, the fc1 output of each strip with its halo row (already zeroed on
    the last strip), quantized ONCE with one scale over the strip and its
    halo; the four 2x2 taps read it padded by a zero column at the right
    and sum exactly in int32; then + bc, tanh GELU (f32), and fc2 as
    `_q8_dot` with its own strip scale. Returns (B, nr, ws*W, C) f32, fc2's
    bias included, no residual."""
    b, nr, _, c = f1.shape
    codes, sf = q8_quantize(f1)
    codes = F.pad(codes.reshape(b, nr, ws + 1, w, c), (0, 0, 0, 1))
    acc = 0
    for di in (0, 1):
        for dj in (0, 1):
            patch = codes[:, :, di:di + ws, dj:dj + w].reshape(b, nr, ws * w, c)
            acc = acc + torch.matmul(patch.double(), wcq[:, di, dj].double().t())
    y = gelu_tanh(acc.float() * (sc * sf) + bc.float())
    return q8_dot(y, w2q, s2) + b2.float()
