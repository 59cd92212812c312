"""K3's and K4's chains (csrc/shifted_block_chain.cu) and K5's
(csrc/block_attention.cu) on the CPU: their plain mirrors
`block_attention_ln_chain_plain`, `conv_tail_chain_plain` and
`block_attention_chain_plain`, each launch in f32 with the kernel's
rounding points, against the Pallas kernels in interpret mode on the same
bf16 inputs (`_pallas_block_attention(..., ln=..., shift=...)`, with and
without the LN, and `_pallas_conv_tail`), at shift 0 and at shift 2 with
JAX's `shift_attn_mask`; and the wrappers' choice of body as a plain
function (K3's, and K13's row body by width).

The mirrors and the Pallas kernels round at the same points (K3: ln, qkv,
q * scale, P, the attention output, the output; K5 the same less ln; K4:
LN2, f1, the GELU's output z, the output) and K4 keeps res1 in f32: what
separates them is the f32 summation order and exp against exp2, which
rounds a few intermediates the other way. The bound is relative L2,
MIRROR_L2 = 1e-3 (max |diff| is no measure here: one flipped bf16 step of
one element is 4e-3 of max |ref|); the mirrors read below 2e-4. Each has a
control that must read above it (~3e-3): K3's and K5's with the attention
core's rounding points in f32, K4's with res1 rounded to bf16 (the error a
GEMM epilogue that reads the residual in bf16 would make).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import swin_block as jsb
from sodt_tpu.pallas import window_attention as jwa
from sodt_tpu_torch import kernels
from sodt_tpu_torch.kernels import layernorm as tln
from sodt_tpu_torch.kernels import swin_block as tsb
from sodt_tpu_torch.kernels import window_attention as twa

from torch_port_common import rand, t, j, interpret_mode

MIRROR_L2 = 1e-3


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def _bf(shape, seed, scale=1.0):
    return t(rand(shape, seed, scale)).to(torch.bfloat16)


def _ln(c, seed):
    return t(1 + rand((c,), seed, 0.1)), t(rand((c,), seed + 1, 0.1))


def _jbf(z):
    return jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)


def _from_jax(out):
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# ---------------------------------------------------------------------- K3

# (ws, nh, c, b, h, w): head dims 16 and 32, windows of 64 tokens (one a
# stage of the core) and of 16 (four a stage), a map that is not square
K3_SHAPES = [(8, 2, 32, 1, 16, 16), (8, 2, 64, 2, 16, 16),
             (4, 2, 32, 1, 16, 24)]


def _k3_args(ws, nh, c, b, h, w, shift, seed=0):
    """bf16 x and weights (torch layout: Linear (out, in)), f32 LN weights,
    bias and mask, as the card's kernel takes them."""
    n = ws * ws
    mask = t(shift_attn_mask(h, w, ws, shift)) if shift else None
    return (_bf((b, h, w, c), seed + 1), *_ln(c, seed + 2),
            _bf((3 * c, c), seed + 4, c ** -0.5), _bf((3 * c,), seed + 5, 0.1),
            _bf((c, c), seed + 6, c ** -0.5), _bf((c,), seed + 7, 0.1),
            t(rand((nh, n, n), seed + 8)), mask, ws, nh, (c // nh) ** -0.5,
            shift)


def _k3_pallas(args):
    x, lnw, lnb, wqkv, bqkv, wp, bp, bias, mask, ws, nh, scale, shift = args
    with interpret_mode():
        out = jwa._pallas_block_attention(
            _jbf(x), _jbf(wqkv.t()), _jbf(bqkv), _jbf(wp.t()), _jbf(bp),
            j(bias), None if mask is None else j(mask), ws, nh, scale,
            ln=(j(lnw), j(lnb)), shift=shift)
    return _from_jax(out)


@pytest.mark.parametrize("shape", K3_SHAPES)
@pytest.mark.parametrize("shift", [0, 2])
def test_k3_chain_mirror_matches_pallas(shape, shift):
    """K3's mirror against `_pallas_block_attention` with the LN in
    interpret mode: within MIRROR_L2 over the map and over its wrapping
    windows (the last window row and column); the mirror with the core's
    q * scale, P and output in f32 reads above the bound; at a shift the
    output is in shifted coordinates, and the unshifted mirror is another
    function."""
    args = _k3_args(*shape, shift)
    ref = _k3_pallas(args)
    mir = twa.block_attention_ln_chain_plain(*args)
    control = twa.block_attention_ln_chain_plain(*args, core_rounded=False)
    assert mir.shape == ref.shape
    assert _rel_l2(control, ref) > MIRROR_L2
    assert _rel_l2(mir, ref) < MIRROR_L2
    ws = shape[0]
    for edge in ((slice(None), slice(-ws, None)),
                 (slice(None), slice(None), slice(-ws, None))):
        assert _rel_l2(mir[edge], ref[edge]) < MIRROR_L2
    # every value is a bf16 value: the projection's one rounding
    assert torch.equal(mir, mir.to(torch.bfloat16).float())
    if shift:
        flat = twa.block_attention_ln_chain_plain(*args[:-1], 0)
        assert _rel_l2(flat, ref) > 10 * MIRROR_L2


# ---------------------------------------------------------------------- K5

# (ws, nh, c, b, h, w): head dims 16 and 32 at windows of 64 tokens, and
# of 16 (four a stage) on a map that is not square
K5_SHAPES = [(8, 2, 32, 1, 16, 16), (8, 2, 64, 2, 16, 16),
             (4, 1, 32, 1, 16, 24)]


def _k5_args(ws, nh, c, b, h, w, shift, seed=20):
    """K3's arguments less the LN weights."""
    x, _, _, *rest = _k3_args(ws, nh, c, b, h, w, shift, seed)
    return (x, *rest)


def _k5_pallas(args):
    x, wqkv, bqkv, wp, bp, bias, mask, ws, nh, scale, shift = args
    with interpret_mode():
        out = jwa._pallas_block_attention(
            _jbf(x), _jbf(wqkv.t()), _jbf(bqkv), _jbf(wp.t()), _jbf(bp),
            j(bias), None if mask is None else j(mask), ws, nh, scale,
            ln=None, shift=shift)
    return _from_jax(out)


@pytest.mark.parametrize("shape", K5_SHAPES)
@pytest.mark.parametrize("shift", [0, 2])
def test_k5_chain_mirror_matches_pallas(shape, shift):
    """K5's mirror against `_pallas_block_attention` without the LN in
    interpret mode: within MIRROR_L2 over the map and over its wrapping
    windows; the mirror with the core's q * scale, P and output in f32
    reads above the bound; every value a bf16 value (the projection's one
    rounding); at a shift the output is in shifted coordinates."""
    args = _k5_args(*shape, shift)
    ref = _k5_pallas(args)
    mir = twa.block_attention_chain_plain(*args)
    control = twa.block_attention_chain_plain(*args, core_rounded=False)
    assert mir.shape == ref.shape
    assert _rel_l2(control, ref) > MIRROR_L2
    assert _rel_l2(mir, ref) < MIRROR_L2
    ws = shape[0]
    for edge in ((slice(None), slice(-ws, None)),
                 (slice(None), slice(None), slice(-ws, None))):
        assert _rel_l2(mir[edge], ref[edge]) < MIRROR_L2
    assert torch.equal(mir, mir.to(torch.bfloat16).float())
    if shift:
        flat = twa.block_attention_chain_plain(*args[:-1], 0)
        assert _rel_l2(flat, ref) > 10 * MIRROR_L2


@pytest.mark.parametrize("shift", [0, 2])
def test_k5_chain_mirror_matches_plain(shift):
    """The mirror against the port's plain version `block_attention_plain`
    in f32 on the same bf16 inputs (its rounding points alone separate
    them, within the card's 2e-2 of max |ref|), and K3's mirror is K5's on
    the rounded LN of x."""
    args = _k5_args(8, 2, 32, 2, 16, 16, shift, seed=30)
    f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    ref = twa.block_attention_plain(*f32)
    mir = twa.block_attention_chain_plain(*args)
    assert float((mir - ref).abs().max() / ref.abs().max()) < 2e-2
    lnw, lnb = _ln(32, 33)
    ln = tln.layernorm_plain(args[0].float(), lnw, lnb).to(torch.bfloat16)
    assert torch.equal(
        twa.block_attention_ln_chain_plain(args[0], lnw, lnb, *args[1:]),
        twa.block_attention_chain_plain(ln, *args[1:]))


# ---------------------------------------------------------------------- K4

# (b, h, w, c): 16 rows (two 8-row strips), and 24 (three: the last zeroes
# its fc1 halo row) on a map that is not square
K4_SHAPES = [(1, 16, 16, 32), (2, 24, 16, 32), (1, 16, 16, 64)]


def _k4_args(b, h, w, c, shift, seed=40):
    """bf16 x, a and weights (wc in the kernels' (out, 2, 2, in) layout),
    f32 LN weights."""
    return (_bf((b, h, w, c), seed + 1), _bf((b, h, w, c), seed + 2),
            *_ln(c, seed + 3), _bf((c, c), seed + 5, c ** -0.5),
            _bf((c,), seed + 6, 0.1), _bf((c, 2, 2, c), seed + 7,
                                          (4 * c) ** -0.5),
            _bf((c,), seed + 8, 0.1), _bf((c, c), seed + 9, c ** -0.5),
            _bf((c,), seed + 10, 0.1), shift)


def _k4_pallas(args):
    x, a, lnw, lnb, w1, b1, wc, bc, w2, b2, shift = args
    with interpret_mode():
        out = jsb._pallas_conv_tail(
            _jbf(x), _jbf(a), j(lnw), j(lnb), _jbf(w1.t()), _jbf(b1),
            _jbf(wc.permute(1, 2, 3, 0)), _jbf(bc), _jbf(w2.t()), _jbf(b2),
            jsb._tail_ws(x.shape[1]), shift)
    return _from_jax(out)


@pytest.mark.parametrize("shape", K4_SHAPES)
@pytest.mark.parametrize("shift", [0, 2])
def test_k4_chain_mirror_matches_pallas(shape, shift):
    """K4's mirror against `_pallas_conv_tail` in interpret mode (the
    un-shift on read, the zeroed halo of the last strip, the right pad):
    within MIRROR_L2 over the map and over its last row and column, where
    the conv reads the pad; the mirror with res1 rounded to bf16 reads
    above the bound."""
    args = _k4_args(*shape, shift)
    ref = _k4_pallas(args)
    mir = tsb.conv_tail_chain_plain(*args)
    control = tsb.conv_tail_chain_plain(*args, res1_rounded=True)
    assert mir.shape == ref.shape
    assert _rel_l2(mir, ref) < MIRROR_L2
    for edge in ((slice(None), slice(-1, None)),
                 (slice(None), slice(None), slice(-1, None))):
        assert _rel_l2(mir[edge], ref[edge]) < MIRROR_L2
    assert _rel_l2(control, ref) > MIRROR_L2
    assert torch.equal(mir, mir.to(torch.bfloat16).float())
    if shift:
        flat = tsb.conv_tail_chain_plain(*args[:-1], 0)
        assert _rel_l2(flat, ref) > 10 * MIRROR_L2


@pytest.mark.parametrize("shift", [0, 2])
def test_k4_chain_mirror_matches_plain(shift):
    """The mirror against the port's plain version `conv_mlp_tail_plain`
    in f32 on the same bf16 inputs: the mirror's bf16 rounding points
    alone separate them, within the card's 2e-2 of max |ref|."""
    args = _k4_args(2, 24, 16, 32, shift, seed=60)
    f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    ref = tsb.conv_mlp_tail_plain(*f32)
    mir = tsb.conv_tail_chain_plain(*args)
    assert float((mir - ref).abs().max() / ref.abs().max()) < 2e-2


# ------------------------------------------------------- bodies, wrappers

def test_shifted_block_bodies():
    """K3 takes the chain at head dims of at most 64 (the flagship's stage
    1: 192 / 12; 64 / 1) and its per-window kernel above (256 / 2,
    128 / 1), by the shape alone; K4's chain has no head-dim limit, and the
    gate of both is unchanged (c <= 256, whole 16-wide head dims, windows
    of at most 64 tokens)."""
    assert [tsb.swin_block_body(c, nh, ws) for c, nh, ws in
            ((192, 12, 8), (64, 1, 8), (96, 2, 4), (256, 2, 8),
             (128, 1, 8))] == ["chain"] * 3 + ["window"] * 2
    assert tsb.megakernel_supported(192, 12, 8)
    assert not tsb.megakernel_supported(384, 12, 8)
    assert not tsb.megakernel_supported(192, 12, 16)


def test_layernorm_bodies():
    """K13's row body by width, the same for its four entries (csrc/
    layernorm.cu `ln_dispatch`): rows packed to their width at every width
    the system runs, 24 * 2^k (C / 24 lanes of three 16-byte vectors, 32 /
    L rows a warp, every lane busy), a whole warp of four vectors a lane
    at any other width of the domain; outside it a ValueError."""
    packed = {24: 1, 48: 2, 96: 4, 192: 8, 384: 16, 768: 32}
    for c, lanes in packed.items():
        assert tln.ln_body(c) == (lanes, 3)
        assert lanes * 3 * 8 == c and 32 % lanes == 0
    for c in (8, 40, 64, 128, 256, 1000, 1024):
        lanes, vecs = tln.ln_body(c)
        assert (lanes, vecs) == (32, 4) and c <= lanes * vecs * 8
    for c in (0, 20, 1032):
        with pytest.raises(ValueError, match=f"C={c}"):
            tln.ln_body(c)


def test_wrappers_on_the_cpu_are_the_plain_versions():
    """On CPU tensors K3's, K4's and K5's wrappers return their plain
    versions and count no launch, whatever body the shape would take on
    the card."""
    kernels.reset_launches()
    args = _k3_args(4, 2, 32, 1, 8, 8, 2, seed=70)
    assert torch.equal(twa.fused_block_attention_ln(*args),
                       twa.block_attention_ln_plain(*args))
    args = _k5_args(4, 2, 32, 1, 8, 8, 2, seed=75)
    assert torch.equal(twa.fused_block_attention(*args),
                       twa.block_attention_plain(*args))
    args = _k4_args(1, 8, 8, 32, 2, seed=80)
    assert torch.equal(tsb.fused_conv_mlp_tail(*args),
                       tsb.conv_mlp_tail_plain(*args))
    assert kernels.launches() == {k: 0 for k in kernels.LAUNCHES}
