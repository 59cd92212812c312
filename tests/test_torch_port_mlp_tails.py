"""The pieces of K6 and K7 on the GEMM core (csrc/gemm_core.cuh), on the
CPU, f32: the conv of K7 as one GEMM over a gathered (M, 4C) A (its second
launch) against the conv it replaces and against the JAX composition's
conv, and the launch splits of both kernels (each launch its plain
version) against the kernels' plain versions.

The CUDA launches themselves run only on the card
(test_torch_port_cuda.py holds them against these plain pieces there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu_torch.kernels import swin_block as tsb

from torch_port_common import rand, t, close

SHAPES = [(1, 8, 8, 32), (2, 5, 7, 48), (1, 64, 64, 16)]


def _conv_args(shape, seed):
    b, h, w, c = shape
    f1 = rand(shape, seed)
    wc = rand((2, 2, c, c), seed + 1, (4 * c) ** -0.5)   # flax HWIO
    bc = rand((c,), seed + 2, 0.1)
    return f1, wc, bc


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_taps_gemm_matches_conv2d(shape):
    """The gather-GEMM against `conv2x2_pad_br` (F.conv2d on the padded
    map): the same sums in another order."""
    f1, wc, bc = _conv_args(shape, 200)
    taps = t(wc.transpose(3, 0, 1, 2))                   # (out, kh, kw, in)
    out = tsb.conv2x2_taps_gemm_plain(t(f1), taps, t(bc))
    ref = tsb.conv2x2_pad_br(t(f1), taps.permute(0, 3, 1, 2), t(bc))
    assert out.shape == ref.shape == t(f1).shape
    close(out, ref.numpy(), 1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_taps_gemm_matches_jax_conv(shape):
    """The gather-GEMM against the conv of JAX's `_compose_conv_tail_noln`
    (sodt_tpu/pallas/swin_block.py): pad fc1's output by one row at the
    bottom and one column at the right, VALID 2x2 conv in HWIO, + bc."""
    f1, wc, bc = _conv_args(shape, 210)
    padded = jnp.pad(jnp.asarray(f1), ((0, 0), (0, 1), (0, 1), (0, 0)))
    ref = jax.lax.conv_general_dilated(
        padded, jnp.asarray(wc), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + jnp.asarray(bc)
    out = tsb.conv2x2_taps_gemm_plain(t(f1), t(wc.transpose(3, 0, 1, 2)),
                                      t(bc))
    close(out, np.asarray(ref), 1e-5)


@pytest.mark.parametrize("shape", [(1, 8, 8, 32), (2, 5, 7, 48)])
def test_mlp_tail_split_matches_plain(shape):
    """K6's two launches (H = gelu(fc1(y)), then r + fc2(H)), each its
    plain version on the CPU, bit-equal to `mlp_tail_plain` in f32."""
    b, h, w, c = shape
    hid = 4 * c
    r, y = t(rand(shape, 220)), t(rand(shape, 221))
    w1, b1 = t(rand((hid, c), 222, c ** -0.5)), t(rand((hid,), 223, 0.1))
    w2, b2 = t(rand((c, hid), 224, hid ** -0.5)), t(rand((c,), 225, 0.1))
    out = tsb.mlp_tail_split(r, y, w1, b1, w2, b2)
    assert torch.equal(out, tsb.mlp_tail_plain(r, y, w1, b1, w2, b2))


@pytest.mark.parametrize("shape", [(1, 8, 8, 32), (2, 5, 7, 48)])
def test_conv_mlp_tail_noln_split_matches_plain(shape):
    """K7's three launches (f1 = fc1(y), z = gelu(conv(f1)) as the
    gather-GEMM, r + fc2(z)), each its plain version on the CPU: bit-equal
    to the same chain written from the plain pieces, and to
    `conv_mlp_tail_noln_plain` (whose conv is F.conv2d) to 1e-5."""
    b, h, w, c = shape
    r, y = t(rand(shape, 230)), t(rand(shape, 231))
    w1, b1 = t(rand((c, c), 232, c ** -0.5)), t(rand((c,), 233, 0.1))
    wc = t(rand((c, 2, 2, c), 234, (4 * c) ** -0.5))
    bc = t(rand((c,), 235, 0.1))
    w2, b2 = t(rand((c, c), 236, c ** -0.5)), t(rand((c,), 237, 0.1))
    out = tsb.conv_mlp_tail_noln_split(r, y, w1, b1, wc, bc, w2, b2)
    f1 = torch.matmul(y, w1.t()) + b1
    z = tsb.gelu(tsb.conv2x2_taps_gemm_plain(f1, wc, bc))
    chain = r + (torch.matmul(z, w2.t()) + b2)
    assert torch.equal(out, chain)
    close(out, tsb.conv_mlp_tail_noln_plain(r, y, w1, b1, wc, bc, w2,
                                            b2).numpy(), 1e-5)


@pytest.mark.parametrize("mode", ["gelu", "bias", "residual"])
def test_gemm_core_plain_modes(mode):
    """The plain version of one launch of the core, on a ragged M (not a
    multiple of the 128-row tile) and N = 48: bias, GELU (f32: exact erf,
    as the dtype-dependent `gelu`) and the residual, each against its
    formula."""
    m, n, k = 200, 48, 96
    a, w = t(rand((m, k), 240)), t(rand((n, k), 241, k ** -0.5))
    b, r = t(rand((n,), 242, 0.1)), t(rand((m, n), 243))
    code = {"gelu": tsb.GEMM_GELU, "bias": tsb.GEMM_BIAS,
            "residual": tsb.GEMM_RESIDUAL}[mode]
    out = tsb.gemm_core(a, w, b, code, r if mode == "residual" else None)
    z = a.double() @ w.double().t() + b.double()
    if mode == "gelu":
        z = torch.nn.functional.gelu(z)
    elif mode == "residual":
        z = z + r.double()
    close(out, z.float().numpy(), 1e-5)
