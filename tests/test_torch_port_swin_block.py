"""K2's chain (csrc/swin_block_chain.cu) on the CPU: its plain mirror
`swin_block_chain_plain`, each launch in f32 with the kernel's rounding
points, against the Pallas megakernel `_pallas_swin_block` in interpret
mode (shift 0, the only block JAX's kernel takes) and against the port's
plain version `swin_block_plain` at shift ws / 2 with the mask; and the
wrapper's choice of body as a plain function.

The mirror and the Pallas kernel round at the same points (ln1, qkv, q *
scale, P, the attention output, ln2, the hidden, the output) and keep the
residual res1 in f32: what separates them is the f32 summation order and
exp against exp2, which rounds a few intermediates the other way. Over
the output that reads below 5e-4 relative L2 (max |diff| is no measure
here: one flipped bf16 step of one element is 4e-3 of max |ref|, and a
wrong rounding point moves half the elements by one step). The bound is
MIRROR_L2 = 1e-3; the same mirror with res1 rounded to bf16 (the error a
GEMM epilogue that reads and writes the residual in bf16 would make) reads
~3.2e-3 and must stay above it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import swin_block as jsb
from sodt_tpu_torch.kernels import swin_block as tsb

from torch_port_common import rand, t, j, interpret_mode

MIRROR_L2, KERNEL_TOL = 1e-3, 2e-2

# (ws, nh, c, b, hw): windows of 16 and 64 tokens, head dims 16 and 32,
# hidden 4C
SHAPES = [(4, 2, 32, 1, 16), (8, 2, 32, 1, 16), (8, 2, 64, 1, 16),
          (4, 2, 64, 2, 8)]


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _args(ws, nh, c, b, hw, shift=0, seed=0):
    """bf16 x and weights, f32 LN weights, bias and mask, as the card's
    kernel takes them (torch layout: Linear weights (out, in))."""
    hid, n = 4 * c, ws * ws
    bf = lambda shape, k, s=1.0: t(rand(shape, seed + k, s)).to(torch.bfloat16)
    x = bf((b, hw, hw, c), 1)
    ln = lambda k: (t(1 + rand((c,), seed + k, 0.1)),
                    t(rand((c,), seed + k + 1, 0.1)))
    mask = t(shift_attn_mask(hw, hw, ws, shift)) if shift else None
    return (x, *ln(2), bf((3 * c, c), 4, c ** -0.5), bf((3 * c,), 5, 0.1),
            bf((c, c), 6, c ** -0.5), bf((c,), 7, 0.1), *ln(8),
            bf((hid, c), 10, c ** -0.5), bf((hid,), 11, 0.1),
            bf((c, hid), 12, hid ** -0.5), bf((c,), 13, 0.1),
            t(rand((nh, n, n), seed + 14)), mask, ws, nh, (c // nh) ** -0.5,
            shift)


def _pallas(args):
    (x, ln1w, ln1b, wqkv, bqkv, wp, bp, ln2w, ln2b, w1, b1, w2, b2, bias, _,
     ws, nh, scale, _) = args
    jb = lambda z: jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)
    with interpret_mode():
        out = jsb._pallas_swin_block(
            jb(x), j(ln1w), j(ln1b), jb(wqkv.t()), jb(bqkv), jb(wp.t()),
            jb(bp), j(ln2w), j(ln2b), jb(w1.t()), jb(b1), jb(w2.t()), jb(b2),
            j(bias), ws, nh, scale)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_mirror_matches_pallas(shape):
    """The mirror against `_pallas_swin_block` in interpret mode on the
    same bf16 inputs: within MIRROR_L2; the mirror with res1 rounded to
    bf16 reads above it."""
    args = _args(*shape)
    ref = _pallas(args)
    mir = tsb.swin_block_chain_plain(*args)
    control = tsb.swin_block_chain_plain(*args, res1_rounded=True)
    assert mir.shape == ref.shape
    assert _rel_l2(mir, ref) < MIRROR_L2
    assert _rel_l2(control, ref) > MIRROR_L2
    # every value the mirror returns is a bf16 value: the output's one
    # rounding
    assert torch.equal(mir, mir.to(torch.bfloat16).float())


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_mirror_shifted_matches_plain(shape):
    """At shift ws / 2 with the mask (JAX sends that block to its XLA
    composition), the mirror against `swin_block_plain` in f32 on the same
    bf16 inputs: the mirror's bf16 rounding points alone separate them,
    within the card's KERNEL_TOL; the wrapping windows (the last window
    row and column) hold it as the rest of the map does. Its res1-rounded
    control differs from it by more than MIRROR_L2."""
    ws = shape[0]
    args = _args(*shape, shift=ws // 2, seed=20)
    f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    ref = tsb.swin_block_plain(*f32)
    mir = tsb.swin_block_chain_plain(*args)
    assert _rel(mir, ref) < KERNEL_TOL
    edge = (slice(None), slice(-ws, None), slice(-ws, None))
    assert _rel(mir[edge], ref[edge]) < KERNEL_TOL
    control = tsb.swin_block_chain_plain(*args, res1_rounded=True)
    assert _rel_l2(control, mir) > MIRROR_L2
    # the shift is really applied: the unshifted mirror is another block
    unshifted = tsb.swin_block_chain_plain(*args[:14], None, *args[15:18], 0)
    assert _rel(unshifted, ref) > KERNEL_TOL


def test_swin_block_body():
    """The chain at head dims of at most 64 (the flagship's stage 1: 192
    / 12; 64 / 1), the per-window body above (256 / 2, 128 / 1)."""
    assert [tsb.swin_block_body(c, nh, 8) for c, nh in
            ((192, 12), (64, 1), (96, 2), (32, 2), (256, 2), (128, 1))] == \
        ["chain"] * 4 + ["window"] * 2
    assert tsb.swin_block_body(192, 12, 4) == "chain"


def test_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper returns `swin_block_plain`, whatever the
    body its shape would take on the card."""
    args = _args(4, 2, 32, 1, 8, shift=2, seed=30)
    assert torch.equal(tsb.fused_swin_block(*args),
                       tsb.swin_block_plain(*args))
