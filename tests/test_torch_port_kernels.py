"""The plain versions of the port's kernels (K1-K8) vs the JAX Pallas
kernels run in interpret mode (the JAX package's own CPU route to them),
f32.

The CUDA kernels themselves run only on the card: test_torch_port_cuda.py
holds each against these plain versions there. Tolerance 1e-4 as in
tests/test_pallas.py for the attention kernels; the kernels with an MLP
(K2, K4, K6, K7) take that file's 2e-3 because the Pallas kernels always
use the tanh GELU while the f32 plain versions (like the JAX compositions)
use the exact erf; against the JAX compositions themselves the plain
versions agree to 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import window_attention as jwa, swin_block as jsb
from sodt_tpu_torch.kernels import window_attention as twa, swin_block as tsb

from torch_port_common import rand, t, j, close, interpret_mode


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_block_attention_plain_matches_pallas(shift, masked):
    b, hw, c, nh, ws = 2, 16, 32, 4, 8
    x = rand((b, hw, hw, c), 21)
    wqkv, bqkv = rand((c, 3 * c), 22, 0.1), rand((3 * c,), 23, 0.1)
    wp, bp = rand((c, c), 24, 0.1), rand((c,), 25, 0.1)
    bias = rand((nh, ws * ws, ws * ws), 26)
    scale = (c // nh) ** -0.5
    mask = shift_attn_mask(hw, hw, ws, 2) if masked else None
    with interpret_mode():
        ref = jwa._pallas_block_attention(
            j(x), j(wqkv), j(bqkv), j(wp), j(bp), j(bias), mask, ws, nh,
            scale, shift=shift)
    out = twa.fused_block_attention(
        t(x), t(wqkv.T), t(bqkv), t(wp.T), t(bp), t(bias),
        None if mask is None else t(mask), ws, nh, scale, shift)
    close(out, ref, 1e-4)


def test_global_attention_plain_matches_pallas():
    b, hw, c, nh = 2, 8, 64, 4                      # N = 64
    qkv = rand((b, hw, hw, 3 * c), 11)
    bias = rand((nh, hw * hw, hw * hw), 12)
    scale = (c // nh) ** -0.5
    with interpret_mode():
        ref = jwa._pallas_global_attention(j(qkv), j(bias), nh, scale)
    close(twa.fused_global_attention(t(qkv), t(bias), nh, scale), ref, 1e-4)
    # the generic-path dispatch takes the same plain version on the CPU
    close(twa.window_attention_core_nhwc(t(qkv), t(bias), None, hw, nh,
                                         scale), ref, 1e-4)


def test_mlp_tail_plain_matches_pallas():
    b, hw, c = 2, 16, 32
    r, y = rand((b, hw, hw, c), 101), rand((b, hw, hw, c), 102)
    w1, b1 = rand((c, 4 * c), 103, 0.1), rand((4 * c,), 104, 0.1)
    w2, b2 = rand((4 * c, c), 105, 0.1), rand((c,), 106, 0.1)
    out = tsb.fused_mlp_tail(t(r), t(y), t(w1.T), t(b1), t(w2.T), t(b2))
    with interpret_mode():
        ref = jsb._pallas_mlp_tail(j(r), j(y), j(w1), j(b1), j(w2), j(b2), 8)
    close(out, ref, 2e-3)
    close(out, jsb._compose_mlp_tail(j(r), j(y), j(w1), j(b1), j(w2),
                                     j(b2)), 1e-5)


@pytest.mark.parametrize("hw", [16, 24])
def test_conv_mlp_tail_noln_plain_matches_pallas(hw):
    # 24 rows = three 8-row strips: the last strip's halo row is zeroed
    b, c = 2, 32
    r, y = rand((b, hw, hw, c), 121), rand((b, hw, hw, c), 122)
    w1, b1 = rand((c, c), 123, 0.1), rand((c,), 124, 0.1)
    wc, bc = rand((2, 2, c, c), 125, 0.1), rand((c,), 126, 0.1)
    w2, b2 = rand((c, c), 127, 0.1), rand((c,), 128, 0.1)
    out = tsb.fused_conv_mlp_tail_noln(
        t(r), t(y), t(w1.T), t(b1), t(wc.transpose(3, 0, 1, 2)), t(bc),
        t(w2.T), t(b2))
    with interpret_mode():
        ref = jsb._pallas_conv_tail_noln(j(r), j(y), j(w1), j(b1), j(wc),
                                         j(bc), j(w2), j(b2), 8)
    close(out, ref, 2e-3)
    close(out, jsb._compose_conv_tail_noln(j(r), j(y), j(w1), j(b1), j(wc),
                                           j(bc), j(w2), j(b2)), 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_plain_matches_pallas(masked):
    """K1, the windowed core of JAX's generic block path."""
    b, hw, c, nh, ws = 2, 16, 32, 4, 8
    qkv = rand((b, hw, hw, 3 * c), 31)
    bias = rand((nh, ws * ws, ws * ws), 32)
    mask = shift_attn_mask(hw, hw, ws, 2) if masked else None
    scale = (c // nh) ** -0.5
    with interpret_mode():
        ref = jwa._pallas_attention_nhwc(
            j(qkv), j(bias), None if mask is None else j(mask), ws, nh, scale)
    tm = None if mask is None else t(mask)
    close(twa.fused_window_attention_nhwc(t(qkv), t(bias), tm, ws, nh, scale),
          ref, 1e-4)
    close(twa.window_attention_core_nhwc(t(qkv), t(bias), tm, ws, nh, scale),
          ref, 1e-4)


def _ln(c, seed):
    return 1.0 + rand((c,), seed, 0.1), rand((c,), seed + 1, 0.1)


@pytest.mark.parametrize("shift", [0, 2])
def test_block_attention_ln_plain_matches_pallas(shift):
    """K3: LN1 folded into K5's body."""
    b, hw, c, nh, ws = 2, 16, 32, 4, 8
    x = rand((b, hw, hw, c), 41)
    lnw, lnb = _ln(c, 42)
    wqkv, bqkv = rand((c, 3 * c), 44, 0.1), rand((3 * c,), 45, 0.1)
    wp, bp = rand((c, c), 46, 0.1), rand((c,), 47, 0.1)
    bias = rand((nh, ws * ws, ws * ws), 48)
    mask = shift_attn_mask(hw, hw, ws, shift) if shift else None
    scale = (c // nh) ** -0.5
    with interpret_mode():
        ref = jwa._pallas_block_attention(
            j(x), j(wqkv), j(bqkv), j(wp), j(bp), j(bias), mask, ws, nh,
            scale, ln=(j(lnw), j(lnb)), shift=shift)
    out = twa.fused_block_attention_ln(
        t(x), t(lnw), t(lnb), t(wqkv.T), t(bqkv), t(wp.T), t(bp), t(bias),
        None if mask is None else t(mask), ws, nh, scale, shift)
    close(out, ref, 1e-4)


def test_swin_block_plain_matches_pallas():
    """K2: the whole non-shifted linear-MLP block."""
    b, hw, c, nh, ws = 2, 16, 32, 4, 8
    x = rand((b, hw, hw, c), 51)
    ln1, ln2 = _ln(c, 52), _ln(c, 54)
    wqkv, bqkv = rand((c, 3 * c), 56, 0.1), rand((3 * c,), 57, 0.1)
    wp, bp = rand((c, c), 58, 0.1), rand((c,), 59, 0.1)
    w1, b1 = rand((c, 4 * c), 60, 0.1), rand((4 * c,), 61, 0.1)
    w2, b2 = rand((4 * c, c), 62, 0.1), rand((c,), 63, 0.1)
    bias = rand((nh, ws * ws, ws * ws), 64)
    scale = (c // nh) ** -0.5
    jargs = [j(a) for a in (x, *ln1, wqkv, bqkv, wp, bp, *ln2, w1, b1, w2,
                            b2, bias)]
    with interpret_mode():
        ref = jsb._pallas_swin_block(*jargs, ws, nh, scale)
    out = tsb.fused_swin_block(
        t(x), t(ln1[0]), t(ln1[1]), t(wqkv.T), t(bqkv), t(wp.T), t(bp),
        t(ln2[0]), t(ln2[1]), t(w1.T), t(b1), t(w2.T), t(b2), t(bias), None,
        ws, nh, scale)
    close(out, ref, 2e-3)
    close(out, jsb._compose_swin_block(*jargs, ws, nh, scale), 1e-5)


@pytest.mark.parametrize("hw,shift", [(16, 0), (24, 0), (24, 2)])
def test_conv_mlp_tail_plain_matches_pallas(hw, shift):
    """K4: un-shift on read + residual + LN2 + conv MLP; at 24 rows the last
    of three 8-row strips zeroes its fc1 halo row."""
    b, c = 2, 32
    x, a = rand((b, hw, hw, c), 71), rand((b, hw, hw, c), 72)
    lnw, lnb = _ln(c, 73)
    w1, b1 = rand((c, c), 75, 0.1), rand((c,), 76, 0.1)
    wc, bc = rand((2, 2, c, c), 77, 0.1), rand((c,), 78, 0.1)
    w2, b2 = rand((c, c), 79, 0.1), rand((c,), 80, 0.1)
    with interpret_mode():
        ref = jsb._pallas_conv_tail(j(x), j(a), j(lnw), j(lnb), j(w1), j(b1),
                                    j(wc), j(bc), j(w2), j(b2), 8, shift)
    out = tsb.fused_conv_mlp_tail(
        t(x), t(a), t(lnw), t(lnb), t(w1.T), t(b1), t(wc.transpose(3, 0, 1, 2)),
        t(bc), t(w2.T), t(b2), shift)
    close(out, ref, 2e-3)


def test_wrappers_take_plain_version_only_on_cpu():
    """A CPU tensor goes to the plain version and counts no launch."""
    from sodt_tpu_torch import kernels
    kernels.reset_launches()
    c = 32
    x = t(rand((1, 8, 8, c), 1))
    twa.fused_block_attention(x, t(rand((3 * c, c), 2)), t(rand((3 * c,), 3)),
                              t(rand((c, c), 4)), t(rand((c,), 5)),
                              t(rand((4, 64, 64), 6)), None, 8, 4, 0.35)
    assert kernels.launches() == {k: 0 for k in kernels.LAUNCHES}
