"""K12, the int8 serving bodies: the port's quantizers and the plain int8
versions of its five bodies vs the JAX package's (`_q8_weight`,
`_q8_weight_conv`, `_q8_dot`, and the Pallas bodies with int8=True run in
interpret mode), f32 on the CPU.

The quantizers are bit-equal. A body is held to 2e-3 of max |ref|: both
sides compute the same codes in f32, but an LN or a GELU that differs in
the last ulp between the two CPU backends can move a value across a
rounding boundary, which changes one code by one step (one 127th of a
strip's range times a weight) - far below 2e-3 of the output. Each body
also differs by more than 1e-6 from the un-quantized composition, so the
quantization ran (tests/test_pallas.py holds JAX's own that way).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import window_attention as jwa, swin_block as jsb
from sodt_tpu_torch import kernels
from sodt_tpu_torch.kernels import quant, window_attention as twa, swin_block as tsb

from torch_port_common import rand, t, j, close, interpret_mode

TOL = 2e-3


def _rel_close(out, ref, tol=TOL):
    out, ref = np.asarray(out.detach()), np.asarray(ref)
    assert out.shape == ref.shape
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel <= tol, rel


def _quantized(out, ref):
    assert np.abs(np.asarray(out.detach()) - np.asarray(ref)).max() > 1e-6


def _ln(c, seed):
    return 1.0 + rand((c,), seed, 0.1), rand((c,), seed + 1, 0.1)


# ------------------------------------------------------------ quantizers

@pytest.mark.parametrize("shape,scale", [((32, 96), 0.1), ((64, 48), 3.0)])
def test_q8_weight_bit_equal(shape, scale):
    w = rand(shape, 1, scale)               # JAX (K, N); torch (N, K)
    w[0, 3] = 0.0
    w[:, 5] = 0.0                           # an all-zero output channel
    jq, js = jsb._q8_weight(j(w))
    tq, ts = quant.q8_weight(t(w.T))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])
    assert tq.dtype == torch.int8 and int(tq.abs().max()) == 127


def test_q8_weight_conv_bit_equal():
    wc = rand((2, 2, 32, 48), 2, 0.2)       # HWIO
    jq, js = jsb._q8_weight_conv(j(wc))
    tq, ts = quant.q8_weight_conv(t(wc.transpose(3, 0, 1, 2)))
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(jq).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[0])


def test_q8_weight_rounds_half_to_even():
    # one channel of max 127 (scale exactly 1): 2.5 -> 2, 3.5 -> 4, -0.5 -> 0
    w = np.array([[127.0, 2.5, 3.5, -0.5, -1.5]], np.float32)
    q, s = quant.q8_weight(t(w))
    assert s.item() == 1.0
    assert q.tolist() == [[127, 2, 4, 0, -2]]


class _Ref:
    def __init__(self, v):
        self.v = v

    def __getitem__(self, _):
        return self.v


@pytest.mark.parametrize("scale", [1.0, 1e-10])
def test_q8_dot_bit_equal(scale):
    """One strip: codes, scale and the exact int32 product as f32. At
    1e-10 the abs-max floor 1e-8 decides the scale."""
    x = rand((48, 64), 3, scale)
    w = rand((64, 40), 4, 0.1)
    wq, ws = jsb._q8_weight(j(w))
    ref = jsb._q8_dot(j(x), _Ref(wq), _Ref(ws))
    tq, ts = quant.q8_weight(t(w.T))
    out = quant.q8_dot(t(x), tq, ts)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_q8_quantize_strips_are_independent():
    x = rand((2, 3, 16, 8), 5)
    x[1, 2] *= 100.0
    codes, sx = quant.q8_quantize(t(x))
    assert sx.shape == (2, 3, 1, 1)
    for b in range(2):
        for r in range(3):
            one, s1 = quant.q8_quantize(t(x[b, r]))
            assert torch.equal(codes[b, r], one) and torch.equal(sx[b, r], s1)


# ----------------------------------------------------------------- bodies

def _att(c, seed):
    return (rand((c, 3 * c), seed, 0.1), rand((3 * c,), seed + 1, 0.1),
            rand((c, c), seed + 2, 0.1), rand((c,), seed + 3, 0.1))


def test_swin_block_q8_plain_matches_pallas():
    """K2's int8 twin, `_pallas_swin_block_q8`: 16 x 24 map, two strips."""
    b, h, w, c, nh, ws = 2, 16, 24, 32, 4, 8
    x = rand((b, h, w, c), 11)
    ln1, ln2 = _ln(c, 12), _ln(c, 14)
    wqkv, bqkv, wp, bp = _att(c, 16)
    w1, b1 = rand((c, 4 * c), 20, 0.1), rand((4 * c,), 21, 0.1)
    w2, b2 = rand((4 * c, c), 22, 0.1), rand((c,), 23, 0.1)
    bias = rand((nh, ws * ws, ws * ws), 24)
    scale = (c // nh) ** -0.5
    jargs = [j(a) for a in (x, *ln1, wqkv, bqkv, wp, bp, *ln2, w1, b1, w2,
                            b2, bias)]
    with interpret_mode():
        ref = jsb._pallas_swin_block_q8(*jargs, ws, nh, scale)
    targs = (t(x), t(ln1[0]), t(ln1[1]), t(wqkv.T), t(bqkv), t(wp.T), t(bp),
             t(ln2[0]), t(ln2[1]), t(w1.T), t(b1), t(w2.T), t(b2), t(bias))
    out = tsb.swin_block_q8_plain(*targs, None, ws, nh, scale)
    _rel_close(out, ref)
    _quantized(out, jsb._compose_swin_block(*jargs, ws, nh, scale))
    # the wrapper takes the plain int8 body for a CPU tensor, no launch
    kernels.reset_launches()
    out2 = tsb.fused_swin_block(*targs[:-1], t(bias), None, ws, nh, scale,
                                int8=True)
    assert torch.equal(out2, out)
    assert not any(kernels.launches().values())


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("shift", [0, 2])
def test_block_attention_q8_plain_matches_pallas(ln, shift):
    """K3's (with the LN) and K5's int8 twin, `_pallas_block_attention(
    int8=True)`: the shifted strips, masked."""
    b, hw, c, nh, ws = 2, 16, 32, 4, 8
    x = rand((b, hw, hw, c), 31)
    lnw, lnb = _ln(c, 32)
    wqkv, bqkv, wp, bp = _att(c, 34)
    bias = rand((nh, ws * ws, ws * ws), 38)
    scale = (c // nh) ** -0.5
    mask = shift_attn_mask(hw, hw, ws, shift) if shift else None
    jln = (j(lnw), j(lnb)) if ln else None
    with interpret_mode():
        ref = jwa._pallas_block_attention(
            j(x), j(wqkv), j(bqkv), j(wp), j(bp), j(bias), mask, ws, nh,
            scale, ln=jln, shift=shift, int8=True)
    tm = None if mask is None else t(mask)
    tw = (t(wqkv.T), t(bqkv), t(wp.T), t(bp), t(bias), tm, ws, nh, scale,
          shift)
    if ln:
        out = twa.fused_block_attention_ln(t(x), t(lnw), t(lnb), *tw,
                                           int8=True)
    else:
        out = twa.fused_block_attention(t(x), *tw, int8=True)
    _rel_close(out, ref)
    xr = jnp.roll(j(x), (-shift, -shift), (1, 2))
    _quantized(out, jwa._compose_block_attention(
        xr, j(wqkv), j(bqkv), j(wp), j(bp), j(bias), mask, ws, nh, scale,
        ln=jln))


def _conv_weights(c, seed):
    return (rand((c, c), seed, 0.1), rand((c,), seed + 1, 0.1),
            rand((2, 2, c, c), seed + 2, 0.1), rand((c,), seed + 3, 0.1),
            rand((c, c), seed + 4, 0.1), rand((c,), seed + 5, 0.1))


def _torch_conv_weights(w1, b1, wc, bc, w2, b2):
    return (t(w1.T), t(b1), t(wc.transpose(3, 0, 1, 2)), t(bc), t(w2.T),
            t(b2))


@pytest.mark.parametrize("shift", [0, 2])
def test_conv_mlp_tail_q8_plain_matches_pallas(shift):
    """K4's int8 twin, `_pallas_conv_tail(int8=True)`: three strips of 8
    rows, so the last one zeroes its halo."""
    b, h, w, c = 2, 24, 16, 32
    x, a = rand((b, h, w, c), 41), rand((b, h, w, c), 42)
    lnw, lnb = _ln(c, 43)
    cw = _conv_weights(c, 45)
    with interpret_mode():
        ref = jsb._pallas_conv_tail(j(x), j(a), j(lnw), j(lnb),
                                    *[j(v) for v in cw], 8, shift=shift,
                                    int8=True)
    out = tsb.fused_conv_mlp_tail(t(x), t(a), t(lnw), t(lnb),
                                  *_torch_conv_weights(*cw), shift, int8=True)
    _rel_close(out, ref)
    ar = jnp.roll(j(a), (shift, shift), (1, 2))
    _quantized(out, jsb._compose_conv_tail(j(x), ar, j(lnw), j(lnb),
                                           *[j(v) for v in cw]))


def test_mlp_tail_q8_plain_matches_pallas():
    """K6's int8 twin, `_pallas_mlp_tail(int8=True)`."""
    b, h, w, c = 2, 16, 8, 32
    r, y = rand((b, h, w, c), 51), rand((b, h, w, c), 52)
    w1, b1 = rand((c, 4 * c), 53, 0.1), rand((4 * c,), 54, 0.1)
    w2, b2 = rand((4 * c, c), 55, 0.1), rand((c,), 56, 0.1)
    with interpret_mode():
        ref = jsb._pallas_mlp_tail(j(r), j(y), j(w1), j(b1), j(w2), j(b2), 8,
                                   int8=True)
    out = tsb.fused_mlp_tail(t(r), t(y), t(w1.T), t(b1), t(w2.T), t(b2),
                             int8=True)
    _rel_close(out, ref)
    _quantized(out, jsb._compose_mlp_tail(j(r), j(y), j(w1), j(b1), j(w2),
                                          j(b2)))


@pytest.mark.parametrize("h", [8, 24])
def test_conv_mlp_tail_noln_q8_plain_matches_pallas(h):
    """K7's int8 twin, `_pallas_conv_tail_noln(int8=True)`: one strip (its
    halo is its own first row, zeroed) and three."""
    b, w, c = 2, 16, 32
    r, y = rand((b, h, w, c), 61), rand((b, h, w, c), 62)
    cw = _conv_weights(c, 63)
    with interpret_mode():
        ref = jsb._pallas_conv_tail_noln(j(r), j(y), *[j(v) for v in cw], 8,
                                         int8=True)
    out = tsb.fused_conv_mlp_tail_noln(t(r), t(y), *_torch_conv_weights(*cw),
                                       int8=True)
    _rel_close(out, ref)
    _quantized(out, jsb._compose_conv_tail_noln(j(r), j(y),
                                                *[j(v) for v in cw]))


def test_conv_tail_halo_scale_quirk():
    """K4 with shift > 0: the last strip's halo row is x's row (nr-1)*ws
    plus a's UNSHIFTED row 0 (nr*ws mod H), not a row of that strip, and
    its LN enters that strip's fc1 scale though its fc1 output is zeroed.
    On this input (a large unshifted row 0) the port's scale differs from
    the strip-only abs-max, and the whole body still matches JAX's."""
    b, h, w, c, shift, ws = 1, 16, 8, 32, 2, 8
    x = rand((b, h, w, c), 71, 0.1)
    a = rand((b, h, w, c), 72, 0.1)
    # a's unshifted row 0 = shifted row H - shift: make its LN outputs large
    # in one channel
    a[:, h - shift, :, 0] = 50.0
    lnw, lnb = _ln(c, 73)
    cw = _conv_weights(c, 75)
    x_rows, a_rows = tsb.conv_tail_halo_rows(h, ws, shift)
    assert x_rows == [8, 8] and a_rows == [8, 0]
    a_un = torch.roll(t(a), (shift, shift), (1, 2))
    res1 = quant.to_strips(t(x) + a_un, ws)
    halo = t(x)[:, x_rows] + a_un[:, a_rows]
    with_halo = quant.ln_f32(torch.cat([res1, halo], 2), t(lnw), t(lnb))
    strip_only = quant.ln_f32(res1, t(lnw), t(lnb))
    s_port = quant.strip_scale(with_halo)[0, 1].item()
    s_strip = quant.strip_scale(strip_only)[0, 1].item()
    assert s_port > 1.05 * s_strip
    with interpret_mode():
        ref = jsb._pallas_conv_tail(j(x), j(a), j(lnw), j(lnb),
                                    *[j(v) for v in cw], 8, shift=shift,
                                    int8=True)
    with quant.strip_amax_log() as log:
        out = tsb.conv_mlp_tail_q8_plain(t(x), t(a), t(lnw), t(lnb),
                                         *_torch_conv_weights(*cw), shift)
    _rel_close(out, ref)
    # the log holds what the scale was made of: the halo row is in it
    assert log[0].amax(-1)[1].item() == with_halo[0, 1].abs().max().item()


def _body_args(name, b, h, w, c, nh, ws, shift):
    """Small torch inputs of one plain int8 body, and its quantization
    points (K2 4, K3 / K5 2, K4 / K7 3 with the halo row, K6 2)."""
    x, a = t(rand((b, h, w, c), 91)), t(rand((b, h, w, c), 92))
    ln1, ln2 = [t(v) for v in _ln(c, 93)], [t(v) for v in _ln(c, 95)]
    wqkv, bqkv, wp, bp = _att(c, 97)
    att = (t(wqkv.T), t(bqkv), t(wp.T), t(bp))
    lin = (t(rand((4 * c, c), 101, 0.1)), t(rand((4 * c,), 102, 0.1)),
           t(rand((c, 4 * c), 103, 0.1)), t(rand((c,), 104, 0.1)))
    conv = _torch_conv_weights(*_conv_weights(c, 105))
    bias = t(rand((nh, ws * ws, ws * ws), 111))
    mask = t(shift_attn_mask(h, w, ws, shift)) if shift else None
    win = (bias, mask, ws, nh, (c // nh) ** -0.5, shift)
    return {
        "swin_block": (tsb.swin_block_q8_plain,
                       (x, *ln1, *att, *ln2, *lin, *win), 4),
        "block_attention": (twa.block_attention_q8_plain, (x, *att, *win), 2),
        "block_attention_ln": (twa.block_attention_ln_q8_plain,
                               (x, *ln1, *att, *win), 2),
        "conv_mlp_tail": (tsb.conv_mlp_tail_q8_plain,
                          (x, a, *ln2, *conv, shift), 3),
        "mlp_tail": (tsb.mlp_tail_q8_plain, (x, a, *lin), 2),
        "conv_mlp_tail_noln": (tsb.conv_mlp_tail_noln_q8_plain,
                               (x, a, *conv), 3)}[name]


@pytest.mark.parametrize("name,shift", [
    ("swin_block", 0), ("block_attention", 2), ("block_attention_ln", 2),
    ("conv_mlp_tail", 2), ("mlp_tail", 0), ("conv_mlp_tail_noln", 0)])
def test_strip_amax_log_sees_every_quantization_point(name, shift):
    """`quant.strip_amax_log` (what the card's kernels are held to): one
    entry per quantization point in the body's order, one row per strip
    (image-major), the strip's rows (+ the conv tails' halo row) as
    columns; the first point's abs-max is that of the body's first strip
    input: the shifted strips for a shifted block, y and its halo row (the
    next strip's first row, clamped) for K7."""
    b, h, w, c, nh, ws = 2, 16, 8, 32, 2, 8
    body, args, points = _body_args(name, b, h, w, c, nh, ws, shift)
    with quant.strip_amax_log() as log:
        body(*args)
    assert len(log) == points
    halo = name.startswith("conv")
    for k, e in enumerate(log):
        rows = ws * w + (w if halo and k < 2 else 0)
        assert tuple(e.shape) == (b * h // ws, rows)
    x0 = torch.roll(args[0], (-shift, -shift), (1, 2))
    if name == "mlp_tail":
        x0 = args[1]
    elif name == "conv_mlp_tail_noln":
        y = args[1]
        x0 = torch.cat([quant.to_strips(y, ws), y[:, [8, 8]]], 2)
    if name in ("block_attention", "mlp_tail", "conv_mlp_tail_noln"):
        want = x0.reshape(b * h // ws, -1).abs().amax(-1)
        torch.testing.assert_close(log[0].amax(-1), want, rtol=0, atol=0)
    assert not quant._amax_log                  # closed with the context


def test_int8_wrappers_backward_replays_the_bf16_composition():
    """`_fmt_bwd`: the gradient of the int8 wrapper is the gradient of the
    un-quantized composition (nothing trains in this mode)."""
    b, h, w, c = 1, 8, 8, 32
    r, y = rand((b, h, w, c), 81), rand((b, h, w, c), 82)
    ws_ = [t(rand((4 * c, c), 83, 0.1)), t(rand((4 * c,), 84, 0.1)),
           t(rand((c, 4 * c), 85, 0.1)), t(rand((c,), 86, 0.1))]
    leaves = [t(r).requires_grad_(), t(y).requires_grad_()] + [
        v.clone().requires_grad_() for v in ws_]
    g_out = t(rand((b, h, w, c), 87))
    g8 = torch.autograd.grad(tsb.fused_mlp_tail(*leaves, int8=True), leaves,
                             g_out)
    g = torch.autograd.grad(tsb.mlp_tail_plain(*leaves), leaves, g_out)
    for a_, b_ in zip(g8, g):
        close(a_, b_.detach().numpy(), 1e-6)


# ------------------------------------ mirrors of the chains on the card
#
# K2's and K4's / K7's twins run on the card as chains of launches that
# store int8 codes and halo rows the plain bodies never materialise
# (csrc/int8_chains.cu). Their mirrors (`*_q8_chain_plain`) follow the
# launches: per-strip slots, the codes of each intermediate, the halo rows
# after the map rows, the conv as a gather over f1's codes with zero taps.
# Each is bit-equal to its plain body and within TOL of the Pallas body: at
# C 32 as max |diff| / max |ref| (both sides agree to ~1e-7 there); at C 64
# XLA's and torch's f32 LN and GELU differ in the last ulp often enough to
# flip isolated codes by one step (up to ~5e-3 of max |ref| in those few
# elements, the plain body the same), so there TOL holds the relative L2
# distance (measured 2.7e-4 to 5.3e-4) and fewer than 1% of the elements
# may differ by more than 1e-3 of max |ref|.


def _mirror_close(out, ref, c, flips=False):
    """`flips`: XLA's and torch's f32 LN flip isolated codes at C 32 too."""
    if c == 32 and not flips:
        _rel_close(out, ref)
        return
    out, ref = np.asarray(out.detach()), np.asarray(ref)
    d = np.abs(out - ref)
    assert np.linalg.norm(d) / np.linalg.norm(ref) <= TOL
    assert (d > 1e-3 * np.abs(ref).max()).mean() < 0.01

def _swin_args(h, c, seed):
    b, w, nh, ws = 2, 16, c // 16, 8
    x = rand((b, h, w, c), seed)
    ln1, ln2 = _ln(c, seed + 1), _ln(c, seed + 3)
    wqkv, bqkv, wp, bp = _att(c, seed + 5)
    w1, b1 = rand((c, 4 * c), seed + 9, 0.1), rand((4 * c,), seed + 10, 0.1)
    w2, b2 = rand((4 * c, c), seed + 11, 0.1), rand((c,), seed + 12, 0.1)
    bias = rand((nh, ws * ws, ws * ws), seed + 13)
    return (x, *ln1, wqkv, bqkv, wp, bp, *ln2, w1, b1, w2, b2, bias), nh, ws


@pytest.mark.parametrize("c", [32, 64])
def test_swin_block_q8_chain_mirror(c):
    """`swin_block_q8_chain_plain`: 24 map rows in three 8-row strips,
    bit-equal to `swin_block_q8_plain` (output and every strip slot), and
    within TOL of `_pallas_swin_block_q8` in interpret mode."""
    a, nh, ws = _swin_args(24, c, 200 + c)
    scale = (c // nh) ** -0.5
    targs = (t(a[0]), t(a[1]), t(a[2]), t(a[3].T), t(a[4]), t(a[5].T),
             t(a[6]), t(a[7]), t(a[8]), t(a[9].T), t(a[10]), t(a[11].T),
             t(a[12]), t(a[13]), None, ws, nh, scale)
    with quant.strip_amax_log() as plog:
        ref = tsb.swin_block_q8_plain(*targs)
    with quant.strip_amax_log() as mlog:
        out = tsb.swin_block_q8_chain_plain(*targs)
    assert torch.equal(out, ref)
    assert len(mlog) == len(plog) == 4
    for m_, p_ in zip(mlog, plog):
        assert torch.equal(m_[:, 0], p_.amax(-1))
    with interpret_mode():
        pal = jsb._pallas_swin_block_q8(*[j(v) for v in a], ws, nh, scale)
    _mirror_close(out, pal, c)


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("ln", [False, True])
def test_block_attention_q8_chain_mirror(ln, shift, c):
    """`block_attention_[ln_]q8_chain_plain`: K3's twin (with the LN,
    rounded to the working dtype before its codes) and K5's as
    `sodt_block_attention_q8` runs them, on a 24 x 16 map in three 8-row
    strips of the rolled map, masked where shifted; bit-equal to
    `block_attention_[ln_]q8_plain` (output and both points' strip slots),
    and within TOL of `_pallas_block_attention(int8=True)` in interpret
    mode (`_mirror_close`: max |diff| / max |ref| at C 32, relative L2 at
    C 64). With the LN, TOL holds the relative L2 at C 32 too: XLA's and
    torch's f32 LN differ in the last ulp in half of the values, which at
    C 32, shift 2 flips two of the 24,576 LN codes and moves 0.5% of the
    outputs by more than 1e-3 of max |ref| (the plain body the same)."""
    b, h, w, ws = 2, 24, 16, 8
    nh = c // 16
    x = rand((b, h, w, c), 500 + c)
    lnw, lnb = _ln(c, 501 + c)
    wqkv, bqkv, wp, bp = _att(c, 503 + c)
    bias = rand((nh, ws * ws, ws * ws), 507 + c)
    scale = (c // nh) ** -0.5
    mask = shift_attn_mask(h, w, ws, shift) if shift else None
    targs = (t(x), *((t(lnw), t(lnb)) if ln else ()), t(wqkv.T), t(bqkv),
             t(wp.T), t(bp), t(bias), None if mask is None else t(mask), ws,
             nh, scale, shift)
    plain, chain = ((twa.block_attention_ln_q8_plain,
                     twa.block_attention_ln_q8_chain_plain) if ln else
                    (twa.block_attention_q8_plain,
                     twa.block_attention_q8_chain_plain))
    with quant.strip_amax_log() as plog:
        ref = plain(*targs)
    with quant.strip_amax_log() as mlog:
        out = chain(*targs)
    assert torch.equal(out, ref)
    assert len(mlog) == len(plog) == 2
    for m_, p_ in zip(mlog, plog):
        assert torch.equal(m_[:, 0], p_.amax(-1))
    with interpret_mode():
        pal = jwa._pallas_block_attention(
            j(x), j(wqkv), j(bqkv), j(wp), j(bp), j(bias), mask, ws, nh,
            scale, ln=(j(lnw), j(lnb)) if ln else None, shift=shift,
            int8=True)
    _mirror_close(out, pal, c, flips=ln)


@pytest.mark.parametrize("c", [32, 64])
def test_mlp_tail_q8_chain_mirror(c):
    """`mlp_tail_q8_chain_plain`: K6's twin as `sodt_mlp_tail_q8` runs it
    (y fold / codes, fc1 fold / codes, fc2 with the residual), three 8-row
    strips, hidden 4C; bit-equal to `mlp_tail_q8_plain` (output and both
    points' strip slots), within TOL of `_pallas_mlp_tail(int8=True)` in
    interpret mode (`_mirror_close`)."""
    b, h, w = 2, 24, 16
    r, y = rand((b, h, w, c), 600 + c), rand((b, h, w, c), 601 + c)
    w1, b1 = rand((c, 4 * c), 602 + c, 0.1), rand((4 * c,), 603 + c, 0.1)
    w2, b2 = rand((4 * c, c), 604 + c, 0.1), rand((c,), 605 + c, 0.1)
    targs = (t(r), t(y), t(w1.T), t(b1), t(w2.T), t(b2))
    with quant.strip_amax_log() as plog:
        ref = tsb.mlp_tail_q8_plain(*targs)
    with quant.strip_amax_log() as mlog:
        out = tsb.mlp_tail_q8_chain_plain(*targs)
    assert torch.equal(out, ref)
    assert len(mlog) == len(plog) == 2
    for m_, p_ in zip(mlog, plog):
        assert torch.equal(m_[:, 0], p_.amax(-1))
    with interpret_mode():
        pal = jsb._pallas_mlp_tail(j(r), j(y), j(w1), j(b1), j(w2), j(b2), 8,
                                   int8=True)
    _mirror_close(out, pal, c)


@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("shift", [0, 2])
def test_conv_mlp_tail_q8_chain_mirror(shift, c):
    """`conv_mlp_tail_q8_chain_plain`: K4's twin with its halo rows after
    the map rows, three 8-row strips (the last one's fc1 halo zeroed before
    the conv's quantization), bit-equal to `conv_mlp_tail_q8_plain` and its
    slots, within TOL of `_pallas_conv_tail(int8=True)`."""
    b, h, w = 2, 24, 16
    x, a = rand((b, h, w, c), 300 + c), rand((b, h, w, c), 301 + c)
    lnw, lnb = _ln(c, 302 + c)
    cw = _conv_weights(c, 304 + c)
    targs = (t(x), t(a), t(lnw), t(lnb), *_torch_conv_weights(*cw), shift)
    with quant.strip_amax_log() as plog:
        ref = tsb.conv_mlp_tail_q8_plain(*targs)
    with quant.strip_amax_log() as mlog:
        out = tsb.conv_mlp_tail_q8_chain_plain(*targs)
    assert torch.equal(out, ref)
    for m_, p_ in zip(mlog, plog):
        assert torch.equal(m_[:, 0], p_.amax(-1))
    with interpret_mode():
        pal = jsb._pallas_conv_tail(j(x), j(a), j(lnw), j(lnb),
                                    *[j(v) for v in cw], 8, shift=shift,
                                    int8=True)
    _mirror_close(out, pal, c)


@pytest.mark.parametrize("h", [8, 24])
def test_conv_mlp_tail_noln_q8_chain_mirror(h):
    """`conv_mlp_tail_noln_q8_chain_plain`: K7's twin, one strip (its halo
    its own first row, zeroed) and three; bit-equal to
    `conv_mlp_tail_noln_q8_plain`, within TOL of the Pallas body."""
    b, w, c = 2, 16, 32
    r, y = rand((b, h, w, c), 401), rand((b, h, w, c), 402)
    cw = _conv_weights(c, 403)
    targs = (t(r), t(y), *_torch_conv_weights(*cw))
    out = tsb.conv_mlp_tail_noln_q8_chain_plain(*targs)
    assert torch.equal(out, tsb.conv_mlp_tail_noln_q8_plain(*targs))
    with interpret_mode():
        pal = jsb._pallas_conv_tail_noln(j(r), j(y), *[j(v) for v in cw], 8,
                                         int8=True)
    _rel_close(out, pal)


def test_conv_tail_halo_scale_quirk_chain_mirror():
    """K4's halo quirk (`test_conv_tail_halo_scale_quirk`'s input) through
    the chain's layout: the halo row of the last strip, x's row (nr-1)*ws
    plus a's UNSHIFTED row 0, sits after the map rows and enters that
    strip's LN slot; the mirror's slots and output equal the plain body's."""
    b, h, w, c, shift = 1, 16, 8, 32, 2
    x = rand((b, h, w, c), 71, 0.1)
    a = rand((b, h, w, c), 72, 0.1)
    a[:, h - shift, :, 0] = 50.0
    lnw, lnb = _ln(c, 73)
    cw = _conv_weights(c, 75)
    targs = (t(x), t(a), t(lnw), t(lnb), *_torch_conv_weights(*cw), shift)
    with quant.strip_amax_log() as plog:
        ref = tsb.conv_mlp_tail_q8_plain(*targs)
    with quant.strip_amax_log() as mlog:
        out = tsb.conv_mlp_tail_q8_chain_plain(*targs)
    assert torch.equal(out, ref)
    assert torch.equal(mlog[0][:, 0], plog[0].amax(-1))
    # the last strip's LN slot is its halo row's, above its own rows
    assert mlog[0][1, 0] > plog[0][1, :8 * w].max()
    with interpret_mode():
        pal = jsb._pallas_conv_tail(j(x), j(a), j(lnw), j(lnb),
                                    *[j(v) for v in cw], 8, shift=shift,
                                    int8=True)
    _rel_close(out, pal)


def test_conv_gather_codes_zero_taps():
    """`conv_gather_codes` (the conv launch's A): a token's (kh, kw, in)
    taps read the next row, or below a strip's last row its halo row, and
    zeros right of the last column."""
    b, h, w, c, ws = 1, 16, 4, 16, 8
    m = b * h * w
    rows = m + (h // ws) * w
    f1 = torch.arange(rows, dtype=torch.float32)[:, None].repeat(1, c)
    g = tsb.conv_gather_codes(f1, b, h, w, ws).reshape(m, 4, c)[:, :, 0]
    tok = lambda i, jj: i * w + jj
    assert g[tok(0, 0)].tolist() == [tok(0, 0), tok(0, 1), tok(1, 0), tok(1, 1)]
    assert g[tok(7, 3)].tolist() == [tok(7, 3), 0, m + 3, 0]      # strip 0's halo
    assert g[tok(15, 1)].tolist() == [tok(15, 1), tok(15, 2), m + w + 1,
                                      m + w + 2]                  # strip 1's halo


def test_one_launch_pieces_plain():
    """The plain versions of the chains' one-launch probes
    (`gemm_s8_plain`, `q8_rowpass_plain`, what `gemm_s8` / `q8_rowpass`
    take for a CPU tensor): the codes of the recomputing run are those of
    the stored values under the folded slots; the fold is their max."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randint(-127, 128, (48, 64), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (32, 64), generator=gen, dtype=torch.int8)
    sw = torch.rand(32, generator=gen) * 1e-3
    b = (torch.randn(32, generator=gen) * 0.1).to(torch.bfloat16)
    amax_in = torch.rand(3, generator=gen) + 0.5
    vals, slots = tsb.gemm_s8(a, wq, sw, b, amax_in, tsb.S8_F32, strip_rows=16)
    codes, _ = tsb.gemm_s8(a, wq, sw, b, amax_in, tsb.S8_CODES, slots,
                           strip_rows=16)
    assert torch.equal(slots, vals.abs().reshape(3, -1).amax(-1))
    sx = quant._scale(slots).repeat_interleave(16)[:, None]
    assert torch.equal(codes, quant._q8(vals, sx).to(torch.int8))
    x = torch.randn((48, 32), generator=gen).to(torch.bfloat16)
    lnw, lnb = torch.ones(32), torch.zeros(32)
    vals, slots = tsb.q8_rowpass(x, lnw, lnb, tsb.S8_F32, 16)
    torch.testing.assert_close(vals, quant.ln_f32(x.float(), lnw, lnb),
                               rtol=0, atol=0)
    codes, _ = tsb.q8_rowpass(x, lnw, lnb, tsb.S8_CODES, 16, slots)
    sx = quant._scale(slots).repeat_interleave(16)[:, None]
    assert torch.equal(codes, quant._q8(vals, sx).to(torch.int8))


def test_rowpass_plain_rounded_and_shifted():
    """The row pass probe's plain version in K3's and K5's modes: a bf16
    map read at its (-shift, -shift)-rolled position is the rolled map's
    rows, and the LN rounded to bf16 is the bf16 value of the LN; the codes
    of either are those of its values under the folded slots."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 8, 12, 32), generator=gen).to(torch.bfloat16)
    lnw, lnb = 1 + 0.1 * torch.randn(32, generator=gen), torch.zeros(32)
    r = 4 * 12
    rolled = torch.roll(x, (-2, -2), (1, 2)).reshape(-1, 32)
    vals, slots = tsb.q8_rowpass(x, None, None, tsb.S8_F32, r, shift=2)
    assert torch.equal(vals, rolled.float())
    vals, slots = tsb.q8_rowpass(x, lnw, lnb, tsb.S8_F32, r, round_bf16=True,
                                 shift=2)
    ln = quant.ln_f32(rolled.float(), lnw, lnb)
    assert torch.equal(vals, ln.to(torch.bfloat16).float())
    assert torch.equal(slots, vals.abs().reshape(4, -1).amax(-1))
    codes, _ = tsb.q8_rowpass(x, lnw, lnb, tsb.S8_CODES, r, slots,
                              round_bf16=True, shift=2)
    sx = quant._scale(slots).repeat_interleave(r)[:, None]
    assert torch.equal(codes, quant._q8(vals, sx).to(torch.int8))
