"""The windowed-attention forward's register body (csrc/window_attention_fwd.cuh,
windows of up to 64 tokens: K1, K5's shifted core, K11's forward) on the
CPU: its plain mirror `attention_fwd_mirror` / `attention_qkv_fwd_mirror`
against the Pallas forwards in interpret mode, and the wrappers' choice of
body and of their group count as plain functions.

The mirror is the kernel's arithmetic: q times the bf16 scale rounded to
bf16, S in f32 with the bias (+ mask) added in log2 units, the softmax
2^(x - max) times 1 / its sum in f32, P rounded to bf16 before PV, the
output rounded to bf16. Without the rounding, on f32 inputs, it holds the
Pallas forwards to 1e-5 of max |ref| (the same f32 formulas; exp2 in place
of exp); with it, on bf16 inputs, 2e-2, the card's KERNEL_TOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import window_attention as jwa
from sodt_tpu_torch.kernels import window_attention as twa

from torch_port_common import rand, t, j, interpret_mode

KERNEL_TOL = 2e-2

# (nh, c, ws, b, h, w): head dims 8 (x 2 heads) and 16, windows of 16 and
# 64 tokens, maps of more than one window a side
SHAPES = [(2, 16, 4, 2, 8, 12), (2, 32, 4, 1, 8, 8), (2, 32, 8, 1, 16, 24),
          (4, 64, 8, 2, 16, 16)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf(x):
    """The bf16 value of every element, as f32."""
    return t(x).to(torch.bfloat16).float().numpy()


def _jin(x, bf16):
    return j(x).astype(jnp.bfloat16) if bf16 else j(x)


def _map_inputs(nh, c, ws, b, h, w, masked, seed=0):
    n = ws * ws
    qkv = _bf(rand((b, h, w, 3 * c), 81 + seed))
    bias = rand((nh, n, n), 82 + seed)
    mask = shift_attn_mask(h, w, ws, ws // 2) if masked else None
    return qkv, bias, mask


def _pallas_nhwc(qkv, bias, mask, ws, nh, scale, bf16):
    with interpret_mode():
        out = jwa._pallas_attention_nhwc(
            _jin(qkv, bf16), j(bias), None if mask is None else j(mask), ws,
            nh, scale)
    return np.asarray(out.astype(jnp.float32))


def _mirror_nhwc(qkv, bias, mask, ws, nh, scale, **kw):
    return twa.attention_fwd_mirror(
        t(qkv), t(bias), None if mask is None else t(mask), ws, nh, scale,
        **kw).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_k1_mirror_without_rounding_matches_pallas(shape, masked):
    nh, c, ws, b, h, w = shape
    qkv, bias, mask = _map_inputs(*shape, masked)
    scale = (c // nh) ** -0.5
    ref = _pallas_nhwc(qkv, bias, mask, ws, nh, scale, False)
    got = _mirror_nhwc(qkv, bias, mask, ws, nh, scale, rounded=False)
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_k1_mirror_rounded_within_card_tolerance(shape, masked):
    """On bf16 inputs the rounded mirror holds the bf16 Pallas forward to
    KERNEL_TOL, and differs from the unrounded one (the rounding is really
    applied)."""
    nh, c, ws, b, h, w = shape
    qkv, bias, mask = _map_inputs(*shape, masked, seed=1)
    scale = (c // nh) ** -0.5
    ref = _pallas_nhwc(qkv, bias, mask, ws, nh, scale, True)
    got = _mirror_nhwc(qkv, bias, mask, ws, nh, scale)
    unrounded = _mirror_nhwc(qkv, bias, mask, ws, nh, scale, rounded=False)
    assert _rel(got, ref) < KERNEL_TOL
    assert _rel(got, unrounded) > 1e-6


# K11: (W windows, N, C, nh, nw): nw windows per image, W = images * nw;
# windows of 4, 16 and 64 tokens, and 36 (padded to 64)
K11_SHAPES = [(8, 4, 32, 2, 4), (6, 16, 16, 2, 3), (8, 64, 64, 4, 4),
              (4, 36, 32, 2, 2)]


def _k11_inputs(w, n, c, nh, nw, masked, seed=0):
    qkv = _bf(rand((w, n, 3 * c), 91 + seed))
    bias = rand((nh, n, n), 92 + seed)
    mask = None
    if masked:
        mask = np.where(rand((nw, n, n), 93 + seed) > 0.5, -100.0,
                        0.0).astype(np.float32)
        for m in mask:
            np.fill_diagonal(m, 0.0)       # no fully masked row
    return qkv, bias, mask, (nw if masked else 1)


@pytest.mark.parametrize("shape", K11_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k11_mirror_matches_pallas(shape, masked, bf16):
    """`_pallas_attention` (K11's forward, window w takes mask[w mod nw])
    against the mirror: unrounded on f32 inputs to 1e-5, rounded on bf16
    inputs to KERNEL_TOL; scale 1.0 as SwinV2 calls it, and hd ** -0.5."""
    w, n, c, nh, nw = shape
    qkv, bias, mask, nw = _k11_inputs(*shape, masked, seed=int(bf16))
    for scale in (1.0, (c // nh) ** -0.5):
        with interpret_mode():
            ref = jwa._pallas_attention(
                _jin(qkv, bf16), j(bias), None if mask is None else j(mask),
                nw, nh, scale)
        ref = np.asarray(ref.astype(jnp.float32))
        got = twa.attention_qkv_fwd_mirror(
            t(qkv), t(bias), None if mask is None else t(mask), nw, nh,
            scale, rounded=bf16).numpy()
        assert _rel(got, ref) < (KERNEL_TOL if bf16 else 1e-5)


@pytest.mark.parametrize("ws,shift", [(4, 2), (8, 4), (8, 2)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k5_shifted_core_mirror_matches_pallas(ws, shift, bf16):
    """K5's shifted read: `_pallas_block_attention` with a shift and the
    mask against the qkv projection, the mirror read at ((r + shift) mod
    H, (c + shift) mod W), and the output projection, in the Pallas
    kernel's rounding order (the projections accumulate in f32 and round
    once)."""
    b, c, nh = 2, 32, 2
    h, w, n = 2 * ws, 3 * ws, ws * ws
    x = rand((b, h, w, c), 101)
    wqkv, bqkv = rand((c, 3 * c), 102, 0.2), rand((3 * c,), 103, 0.1)
    wp, bp = rand((c, c), 104, 0.2), rand((c,), 105, 0.1)
    if bf16:
        x, wqkv, bqkv, wp, bp = map(_bf, (x, wqkv, bqkv, wp, bp))
    bias = rand((nh, n, n), 106)
    mask = shift_attn_mask(h, w, ws, shift)
    scale = (c // nh) ** -0.5
    with interpret_mode():
        ref = jwa._pallas_block_attention(
            *(_jin(a, bf16) for a in (x, wqkv, bqkv, wp, bp)), j(bias),
            j(mask), ws, nh, scale, shift=shift)
    ref = np.asarray(ref.astype(jnp.float32))
    rnd = ((lambda a: a.to(torch.bfloat16).float()) if bf16
           else (lambda a: a))
    qkv = rnd(t(x) @ t(wqkv) + t(bqkv))
    attn = twa.attention_fwd_mirror(qkv, t(bias), t(mask), ws, nh, scale,
                                    shift=shift, rounded=bf16)
    got = rnd(attn @ t(wp) + t(bp)).numpy()
    assert _rel(got, ref) < (KERNEL_TOL if bf16 else 1e-5)
    # the read really is shifted: the unshifted core gives another output
    flat = twa.attention_fwd_mirror(qkv, t(bias), t(mask), ws, nh, scale,
                                    rounded=bf16)
    assert _rel(rnd(flat @ t(wp) + t(bp)).numpy(), ref) > 1e-2


def test_fwd_body_by_window_size():
    """The register body for every window of up to 64 tokens (ws 2 to 8),
    the strip body above (ws 16, N 256; and N 81, 100); four windows to a
    64-row stage at N <= 16, else one."""
    assert [twa.fwd_body(ws * ws) for ws in (2, 3, 4, 5, 6, 7, 8)] == \
        ["regs"] * 7
    assert [twa.fwd_body(n) for n in (65, 81, 100, 256)] == ["strips"] * 4
    assert [twa.stage_windows(n) for n in (4, 9, 16, 17, 36, 64)] == \
        [4, 4, 4, 1, 1, 1]
    # the forward and K9 share the register bodies' domain
    assert all(twa.fwd_body(n) == twa.bwd_body(n) for n in range(1, 257))


def test_fwd_groups_rule():
    """ceil(FWD_CTAS / nh) groups, at most one per stage, at least 1; the
    strip body takes one CTA per (head, window)."""
    ctas = twa.FWD_CTAS
    # the flagship's two stages at batch 4 (1,024 and 256 windows, 12
    # heads), SwinV2's four (3, 6, 12 and 24 heads)
    for total, nh in ((1024, 12), (256, 12), (1024, 3), (256, 6)):
        gr = twa.fwd_groups(total, 64, nh)
        assert gr == -(-ctas // nh) and nh * gr >= ctas > nh * (gr - 1)
    assert twa.fwd_groups(64, 64, 12) == min(64, -(-ctas // 12))
    assert twa.fwd_groups(16, 64, 24) == 16
    # fewer windows than groups, and a count that is no multiple of them
    assert twa.fwd_groups(3, 64, 12) == 3
    assert twa.fwd_groups(2 * ctas + 1, 64, 1) == ctas
    # four windows to a stage at N <= 16: ceil(10 / 4) stages
    assert twa.fwd_groups(10, 16, 2) == 3
    assert twa.fwd_groups(4 * ctas, 16, 1) == ctas
    assert twa.fwd_groups(1, 9, 4) == 1
    # the strip body
    assert twa.fwd_groups(16, 256, 4) == 16
    assert twa.fwd_groups(1000, 100, 4) == 1000


def test_forward_wrappers_on_the_cpu_are_the_plain_versions():
    """On a CPU tensor K1's and K11's wrappers return their plain versions
    (whatever body their N would take on the card); the mirror's unrounded
    form agrees with them in f32."""
    nh, c, ws = 2, 32, 4
    qkv, bias, mask = _map_inputs(nh, c, ws, 1, 8, 8, True, seed=3)
    args = (t(qkv), t(bias), t(mask), ws, nh, (c // nh) ** -0.5)
    out = twa.fused_window_attention_nhwc(*args)
    assert torch.equal(out, twa.reference_attention_nhwc(*args))
    assert _rel(twa.attention_fwd_mirror(*args, rounded=False), out) < 1e-5
    qkv, bias, mask, nw = _k11_inputs(8, 16, 32, 2, 4, True, seed=4)
    args = (t(qkv), t(bias), t(mask), nw, 2, 1.0)
    out = twa.fused_window_attention(*args)
    assert torch.equal(out, twa.reference_attention_qkv(*args))
    assert _rel(twa.attention_qkv_fwd_mirror(*args, rounded=False), out) \
        < 1e-5
