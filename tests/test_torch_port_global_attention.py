"""The plain pieces that K8 / K10's kernels rest on, against the JAX
package's Pallas global attention in interpret mode, f32 on the CPU.

K10 runs on row statistics: each row's log-sum-exp over the keys and
delta = rowsum(dO * O). `global_attention_bwd_stats_plain` (P = exp(S -
lse), dS = P * (dP - delta), dbias = dS summed over batch and windows) on
`global_attention_lse_plain` and `global_attention_delta_plain` (with O
from `_pallas_global_attention`) gives `_pallas_global_attention_bwd`'s
gradients to 1e-5: the same f32 formulas, summed in another order.

The scale trap: K8 scales q in the working dtype before QK^T, K10 scales
the f32 scores. In bf16 the two S agree only where q * scale is exact,
that is where the scale is a power of two; only there may K10 take K8's
log-sum-exp (`lse_reusable`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import window_attention as jwa
from sodt_tpu_torch.kernels import window_attention as twa

from torch_port_common import rand, t, j, close, interpret_mode


@pytest.mark.parametrize("b,hw,c,nh", [(2, 8, 64, 4), (1, 16, 32, 2)])
def test_lse_and_delta_match_pallas_forward(b, hw, c, nh):
    """The log-sum-exp reproduces the Pallas forward: softmax(S) V =
    exp(S - lse) V; delta from its output is rowsum(dO * O)."""
    n = hw * hw
    qkv, gy = rand((b, hw, hw, 3 * c), 61), rand((b, hw, hw, c), 62)
    bias = rand((nh, n, n), 63)
    scale = (c // nh) ** -0.5
    with interpret_mode():
        out = np.asarray(jwa._pallas_global_attention(j(qkv), j(bias), nh,
                                                      scale))
    for forward in (False, True):
        lse = twa.global_attention_lse_plain(t(qkv), t(bias), nh, scale,
                                             forward=forward)
        assert tuple(lse.shape) == (b, nh, n)
        s = twa._scores(t(qkv), t(bias), nh, scale, hw, None, forward)
        v = twa._heads(t(qkv), hw, nh, 3)[2]
        o = torch.matmul(torch.exp(s - lse[..., None]), v)   # (B, nh, N, hd)
        close(o.permute(0, 2, 1, 3).reshape(b, hw, hw, c), out, 1e-5)
    delta = twa.global_attention_delta_plain(t(out), t(gy), nh)
    ref = (out.reshape(b, n, nh, -1) * gy.reshape(b, n, nh, -1)).sum(-1)
    close(delta, ref.transpose(0, 2, 1), 1e-5)


@pytest.mark.parametrize("b,hw,c,nh", [(2, 16, 64, 4), (1, 20, 32, 2),
                                       (3, 8, 32, 2)])
def test_bwd_from_stats_matches_pallas(b, hw, c, nh):
    """K10's arithmetic from the row statistics (lse of K10's S, delta
    from the Pallas forward's output) against the Pallas backward:
    N = 256, N = 400 (a Pallas row chunk of 200) and dbias over 3
    windows of a batch."""
    n = hw * hw
    qkv, gy = rand((b, hw, hw, 3 * c), 64), rand((b, hw, hw, c), 65)
    bias = rand((nh, n, n), 66)
    scale = (c // nh) ** -0.5
    with interpret_mode():
        out = jwa._pallas_global_attention(j(qkv), j(bias), nh, scale)
        pq, pb = jwa._pallas_global_attention_bwd(j(qkv), j(bias), nh, scale,
                                                  j(gy))
    lse = twa.global_attention_lse_plain(t(qkv), t(bias), nh, scale)
    delta = twa.global_attention_delta_plain(t(np.asarray(out)), t(gy), nh)
    dqkv, dbias = twa.global_attention_bwd_stats_plain(
        t(qkv), t(bias), nh, scale, t(gy), lse, delta)
    close(dqkv, pq, 1e-5)
    close(dbias, pb, 1e-5)
    # and the same from K8's log-sum-exp, f32 (no rounding of q * scale)
    lse_f = twa.global_attention_lse_plain(t(qkv), t(bias), nh, scale,
                                           forward=True)
    dqkv, dbias = twa.global_attention_bwd_stats_plain(
        t(qkv), t(bias), nh, scale, t(gy), lse_f, delta)
    close(dqkv, pq, 1e-5)
    close(dbias, pb, 1e-5)


def test_bwd_from_stats_windows_and_mask():
    """K10's wider domain (four windows per image, a shift mask): the
    pieces against the plain K10, which the Pallas kernels do not cover."""
    b, hw, ws, c, nh = 2, 16, 8, 32, 2
    qkv, gy = rand((b, hw, hw, 3 * c), 67), rand((b, hw, hw, c), 68)
    bias = rand((nh, 64, 64), 69)
    mask = t(shift_attn_mask(hw, hw, ws, 2))
    scale = (c // nh) ** -0.5
    args = (t(qkv), t(bias), nh, scale)
    out = twa.global_attention_plain(*args, ws, mask)
    lse = twa.global_attention_lse_plain(*args, ws, mask)
    delta = twa.global_attention_delta_plain(out, t(gy), nh, ws)
    assert tuple(lse.shape) == tuple(delta.shape) == (b * 4, nh, 64)
    dqkv, dbias = twa.global_attention_bwd_stats_plain(*args, t(gy), lse,
                                                       delta, ws, mask)
    rq, rb = twa.global_attention_bwd_plain(*args, t(gy), ws, mask)
    close(dqkv, rq, 1e-5)
    close(dbias, rb, 1e-5)


def _lse_gap(hd: int, nh: int = 2, hw: int = 8, seed: int = 70) -> float:
    """max |forward lse - backward lse| on bf16 inputs: K8's S (q * scale
    rounded to bf16, the Pallas body's `x[0, 0] * jnp.asarray(scale,
    x.dtype)`) against K10's ((q k^T) * scale in f32)."""
    c = nh * hd
    n = hw * hw
    qkv = t(rand((1, hw, hw, 3 * c), seed, 2.0)).to(torch.bfloat16)
    bias = t(rand((nh, n, n), seed + 1))
    scale = hd ** -0.5
    fwd = twa.global_attention_lse_plain(qkv, bias, nh, scale, forward=True)
    bwd = twa.global_attention_lse_plain(qkv, bias, nh, scale)
    # the forward's S as JAX forms it, from the same bf16 numbers
    x = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    x = x.reshape(1, n, 3, nh, hd).transpose(2, 0, 3, 1, 4)
    q = (x[0] * jnp.asarray(scale, x.dtype)).astype(jnp.float32)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, x[1].astype(jnp.float32))
    ref = jax.scipy.special.logsumexp(s + j(bias.numpy())[None], axis=-1)
    close(fwd, np.asarray(ref), 1e-5)
    return (fwd - bwd).abs().max().item()


@pytest.mark.parametrize("hd,reusable", [(32, False), (64, True), (16, True),
                                         (48, False)])
def test_scale_trap(hd, reusable):
    """At head dims 16 and 64 (scale 1/4, 1/8) the forward's log-sum-exp
    is the backward's; at 32 and 48 it is not, by far more than f32
    rounding (bf16(q * scale) moves each q by up to 2^-9 of itself)."""
    gap = _lse_gap(hd)
    assert twa.lse_reusable(hd ** -0.5) == reusable
    if reusable:
        assert gap < 1e-5
    else:
        assert gap > 1e-3
