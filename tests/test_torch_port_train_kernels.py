"""The plain versions of the training kernels (K9, K10, K13) and the
replayed backward of the fused wrappers (K2-K7) vs the JAX package, f32 on
the CPU.

K9 / K10: `attention_nhwc_bwd_plain` / `global_attention_bwd_plain` against
the Pallas backward kernels in interpret mode (1e-4: the same f32 formulas)
and against jax.vjp of `reference_attention_nhwc` (2e-3, the tolerance of
tests/test_pallas.py: the reference scales q before the product). K13: the
plain forward against `_pallas_ln` / `_pallas_add_ln` in interpret mode and
the plain backward against `_ln_grad` / `_add_ln_core_bwd` (1e-5). K2-K7:
the gradients that `Replay` returns against jax.grad of the `_compose_*`
functions (1e-4; 2e-3 where a roll and a mask are involved is not needed:
both sides are f32 compositions of the same ops).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import (window_attention as jwa, swin_block as jsb,
                             layernorm as jln)
from sodt_tpu_torch.kernels import (window_attention as twa, swin_block as tsb,
                                    layernorm as tln)

from torch_port_common import rand, t, j, close, interpret_mode


# ---------------------------------------------------------------- K9, K10

@pytest.mark.parametrize("nh,c,ws,b,h,w", [
    (2, 16, 4, 1, 8, 12),     # gx = 3: unpacked windows
    (2, 16, 4, 1, 8, 16),     # gx = 4, N = 16: the Pallas kernel packs
    (2, 32, 8, 2, 16, 32)])   # N = 64, packed by 2
@pytest.mark.parametrize("masked", [False, True])
def test_torch_window_attention_bwd_plain_matches_pallas(nh, c, ws, b, h, w,
                                                         masked):
    n = ws * ws
    qkv, gy = rand((b, h, w, 3 * c), 41), rand((b, h, w, c), 43)
    bias = rand((nh, n, n), 42)
    scale = (c // nh) ** -0.5
    mask = shift_attn_mask(h, w, ws, ws // 2) if masked else None
    tm = None if mask is None else t(mask)
    dqkv, dbias = twa.window_attention_bwd(t(qkv), t(bias), tm, ws, nh, scale,
                                           t(gy))
    with interpret_mode():
        pq, pb = jwa._pallas_attention_nhwc_bwd(
            j(qkv), j(bias), None if mask is None else j(mask), ws, nh, scale,
            j(gy))
    close(dqkv, pq, 1e-4)
    close(dbias, pb, 1e-4)
    _, vjp = jax.vjp(lambda q_, b_: jwa.reference_attention_nhwc(
        q_, b_, mask, ws, nh, scale), j(qkv), j(bias))
    rq, rb = vjp(j(gy))
    close(dqkv, rq, 2e-3)
    close(dbias, rb, 2e-3)
    # autograd of the CPU wrapper (the plain forward) agrees too
    q = t(qkv).requires_grad_()
    bi = t(bias).requires_grad_()
    out = twa.fused_window_attention_nhwc(q, bi, tm, ws, nh, scale)
    aq, ab = torch.autograd.grad(out, [q, bi], t(gy))
    close(aq, rq, 1e-4)
    close(ab, rb, 1e-4)


@pytest.mark.parametrize("b,hw,c,nh", [(2, 16, 64, 4), (1, 20, 32, 2)])
def test_torch_global_attention_bwd_plain_matches_pallas(b, hw, c, nh):
    """N = 256 and N = 400 (a row chunk of 200 in the Pallas kernel)."""
    n = hw * hw
    qkv, gy = rand((b, hw, hw, 3 * c), 13), rand((b, hw, hw, c), 15)
    bias = rand((nh, n, n), 14)
    scale = (c // nh) ** -0.5
    dqkv, dbias = twa.global_attention_bwd(t(qkv), t(bias), nh, scale, t(gy))
    with interpret_mode():
        pq, pb = jwa._pallas_global_attention_bwd(j(qkv), j(bias), nh, scale,
                                                  j(gy))
    close(dqkv, pq, 1e-4)
    close(dbias, pb, 1e-4)
    _, vjp = jax.vjp(lambda q_, b_: jwa.reference_attention_nhwc(
        q_, b_, None, hw, nh, scale), j(qkv), j(bias))
    rq, rb = vjp(j(gy))
    close(dqkv, rq, 2e-3)
    close(dbias, rb, 2e-3)


def test_torch_global_attention_bwd_plain_windows_and_mask():
    """K10's wider domain (several windows with a mask), which JAX leaves
    to autodiff of the reference."""
    b, hw, ws, c, nh = 1, 16, 8, 32, 2
    qkv, gy = rand((b, hw, hw, 3 * c), 16), rand((b, hw, hw, c), 17)
    bias = rand((nh, 64, 64), 18)
    mask = shift_attn_mask(hw, hw, ws, 2)
    scale = (c // nh) ** -0.5
    dqkv, dbias = twa.global_attention_bwd(t(qkv), t(bias), nh, scale, t(gy),
                                           ws, t(mask))
    _, vjp = jax.vjp(lambda q_, b_: jwa.reference_attention_nhwc(
        q_, b_, mask, ws, nh, scale), j(qkv), j(bias))
    rq, rb = vjp(j(gy))
    close(dqkv, rq, 2e-3)
    close(dbias, rb, 2e-3)


# -------------------------------------------------------------------- K13

@pytest.mark.parametrize("r,c", [(64, 48), (256, 192), (32, 384)])
def test_torch_layernorm_plain_matches_pallas(r, c):
    x, y = rand((r, c), 21) * 2 + 0.5, rand((r, c), 22)
    w, b = 1 + rand((c,), 23, 0.1), rand((c,), 24, 0.1)
    g, g2 = rand((r, c), 25), rand((r, c), 26)
    with interpret_mode():
        ref = jln._pallas_ln(j(x), j(w), j(b), 1e-5)
        rs, rln = jln._pallas_add_ln(j(x), j(y), j(w), j(b), 1e-5)
    close(tln.layernorm(t(x), t(w), t(b)), ref, 1e-5)
    close(tln.layernorm_plain(t(x), t(w), t(b)),
          jln._reference_ln(j(x), j(w), j(b), 1e-5), 1e-6)
    s, ln = tln.add_layernorm(t(x), t(y), t(w), t(b))
    close(s, rs, 1e-6)
    close(ln, rln, 1e-5)
    # backward: the analytic formulas, and autograd of the plain forward
    jdx, jdw, jdb = jln._ln_grad(j(x), j(w), j(g), 1e-5)
    dx, dw, db = tln.ln_grad_plain(t(x), t(w), t(g))
    close(dx, jdx, 1e-5)
    close(dw, jdw, 1e-4)
    close(db, jdb, 1e-4)
    xs = [t(a).requires_grad_() for a in (x, w, b)]
    auto = torch.autograd.grad(tln.layernorm(*xs), xs, t(g))
    for a, ref in zip(auto, (jdx, jdw, jdb)):
        close(a, ref, 1e-4)
    ja, jb_, jw, jbias = jln._add_ln_core_bwd(
        1e-5, (j(x), j(y), j(w), j(b)), (j(g2), j(g)))
    xs = [t(a).requires_grad_() for a in (x, y, w, b)]
    ts, tl = tln.add_layernorm(*xs)
    auto = torch.autograd.grad([ts, tl], xs, [t(g2), t(g)])
    for a, ref in zip(auto, (ja, jb_, jw, jbias)):
        close(a, ref, 1e-4)


def test_torch_layernorm_bf16_add_rounds_first():
    """add_layernorm adds in the input dtype and normalizes the ROUNDED
    sum, as `_add_ln_kernel` does."""
    a = t(rand((8, 64), 27)).bfloat16()
    b = t(rand((8, 64), 28)).bfloat16()
    w, bias = torch.ones(64), torch.zeros(64)
    s, ln = tln.add_layernorm(a, b, w, bias)
    assert s.dtype == torch.bfloat16 and torch.equal(s, a + b)
    assert torch.equal(ln, tln.layernorm_plain(a + b, w, bias))
    with interpret_mode():
        rs, rln = jln._pallas_add_ln(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(b.float().numpy(), jnp.bfloat16),
                                     j(w), j(bias), 1e-5)
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(rs.astype(jnp.float32)))
    close(ln.float(), rln.astype(jnp.float32), 1e-2)   # one bf16 step


# ------------------------------------------------- K2-K7: replayed backward

def _ln(c, seed):
    return 1.0 + rand((c,), seed, 0.1), rand((c,), seed + 1, 0.1)


def _replay_grads(plain, tensors, consts, g, mask_at=None):
    """Gradients through `Replay` with the plain version standing in for
    the kernel launch (the CUDA launch itself runs only on the card). The
    tensor at `mask_at` (the shift mask) asks for no gradient."""
    leaves = [None if a is None else t(a).requires_grad_(i != mask_at)
              for i, a in enumerate(tensors)]
    compose = lambda *args: plain(*args, dispatch=True) \
        if "dispatch" in plain.__code__.co_varnames else plain(*args)
    out = twa.Replay.apply(lambda *a: plain(*a), compose, consts, *leaves)
    wanted = [l for l in leaves if l is not None and l.requires_grad]
    return out, torch.autograd.grad(out, wanted, t(g))


def _attn_weights(c, seed):
    return (rand((c, 3 * c), seed, 0.1), rand((3 * c,), seed + 1, 0.1),
            rand((c, c), seed + 2, 0.1), rand((c,), seed + 3, 0.1))


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("with_ln", [False, True], ids=["K5", "K3"])
def test_torch_block_attention_replay_grad_matches_jax(shift, with_ln):
    b, hw, c, nh, ws = 2, 16, 32, 4, 8
    x, g = rand((b, hw, hw, c), 31), rand((b, hw, hw, c), 32)
    ln = _ln(c, 33)
    wqkv, bqkv, wp, bp = _attn_weights(c, 35)
    bias = rand((nh, 64, 64), 39)
    mask = shift_attn_mask(hw, hw, ws, shift) if shift else None
    scale = (c // nh) ** -0.5

    def jf(x_, lnw, lnb, *a):
        xr = jnp.roll(x_, (-shift, -shift), (1, 2)) if shift else x_
        return (jwa._compose_block_attention(
            xr, *a, mask, ws, nh, scale, ln=(lnw, lnb) if with_ln else None)
            * j(g)).sum()
    jg = jax.grad(jf, argnums=tuple(range(8)))(
        j(x), j(ln[0]), j(ln[1]), j(wqkv), j(bqkv), j(wp), j(bp), j(bias))
    tw = (wqkv.T, bqkv, wp.T, bp, bias, mask)
    if with_ln:
        _, tg = _replay_grads(twa.block_attention_ln_plain, (x, *ln, *tw),
                              (ws, nh, scale, shift), g, mask_at=8)
        refs = [jg[0], jg[1], jg[2], jg[3].T, jg[4], jg[5].T, jg[6], jg[7]]
    else:
        _, tg = _replay_grads(twa.block_attention_plain, (x, *tw),
                              (ws, nh, scale, shift), g, mask_at=6)
        refs = [jg[0], jg[3].T, jg[4], jg[5].T, jg[6], jg[7]]
    assert len(tg) == len(refs)
    for a, ref in zip(tg, refs):
        close(a, ref, 1e-4)


@pytest.mark.parametrize("shift", [0, 2])
def test_torch_swin_block_replay_grad_matches_jax(shift):
    """K2; the port also takes a shifted linear block, whose replay rolls
    in, passes the mask and rolls back."""
    b, hw, c, nh, ws = 2, 16, 32, 4, 8
    x, g = rand((b, hw, hw, c), 51), rand((b, hw, hw, c), 50)
    ln1, ln2 = _ln(c, 52), _ln(c, 54)
    wqkv, bqkv, wp, bp = _attn_weights(c, 56)
    w1, b1 = rand((c, 4 * c), 60, 0.1), rand((4 * c,), 61, 0.1)
    w2, b2 = rand((4 * c, c), 62, 0.1), rand((c,), 63, 0.1)
    bias = rand((nh, 64, 64), 64)
    mask = shift_attn_mask(hw, hw, ws, shift) if shift else None
    scale = (c // nh) ** -0.5

    def jf(x_, l1w, l1b, wqkv_, bqkv_, wp_, bp_, l2w, l2b, w1_, b1_, w2_, b2_,
           bias_):
        if not shift:
            out = jsb._compose_swin_block(x_, l1w, l1b, wqkv_, bqkv_, wp_, bp_,
                                          l2w, l2b, w1_, b1_, w2_, b2_, bias_,
                                          ws, nh, scale)
        else:   # the same composition on the rolled map, with the mask
            xr = jnp.roll(x_, (-shift, -shift), (1, 2))
            a = jwa._compose_block_attention(xr, wqkv_, bqkv_, wp_, bp_, bias_,
                                             mask, ws, nh, scale,
                                             ln=(l1w, l1b))
            res1 = xr + a
            out = jsb._compose_mlp_tail(
                res1, jln.layernorm(res1, l2w, l2b), w1_, b1_, w2_, b2_)
            out = jnp.roll(out, (shift, shift), (1, 2))
        return (out * j(g)).sum()
    jargs = [j(a) for a in (x, *ln1, wqkv, bqkv, wp, bp, *ln2, w1, b1, w2, b2,
                            bias)]
    jg = jax.grad(jf, argnums=tuple(range(14)))(*jargs)
    tensors = (x, *ln1, wqkv.T, bqkv, wp.T, bp, *ln2, w1.T, b1, w2.T, b2,
               bias, mask)
    _, tg = _replay_grads(tsb.swin_block_plain, tensors,
                          (ws, nh, scale, shift), g, mask_at=14)
    transposed = {3, 5, 9, 11}
    assert len(tg) == 14
    for i, (a, ref) in enumerate(zip(tg, jg)):
        close(a, ref.T if i in transposed else ref, 1e-4)


@pytest.mark.parametrize("shift", [0, 2])
def test_torch_conv_mlp_tail_replay_grad_matches_jax(shift):
    """K4 (un-shift of `a` + residual + LN2 + conv MLP)."""
    b, hw, c = 2, 16, 32
    x, a, g = (rand((b, hw, hw, c), s) for s in (71, 72, 70))
    lnw, lnb = _ln(c, 73)
    w1, b1 = rand((c, c), 75, 0.1), rand((c,), 76, 0.1)
    wc, bc = rand((2, 2, c, c), 77, 0.1), rand((c,), 78, 0.1)
    w2, b2 = rand((c, c), 79, 0.1), rand((c,), 80, 0.1)

    def jf(x_, a_, *rest):
        ar = jnp.roll(a_, (shift, shift), (1, 2)) if shift else a_
        return (jsb._compose_conv_tail(x_, ar, *rest) * j(g)).sum()
    jg = jax.grad(jf, argnums=tuple(range(10)))(
        *[j(v) for v in (x, a, lnw, lnb, w1, b1, wc, bc, w2, b2)])
    tensors = (x, a, lnw, lnb, w1.T, b1, wc.transpose(3, 0, 1, 2), bc, w2.T, b2)
    _, tg = _replay_grads(tsb.conv_mlp_tail_plain, tensors, (shift,), g)
    fix = {4: lambda r: r.T, 6: lambda r: r.transpose(3, 0, 1, 2),
           8: lambda r: r.T}
    for i, (got, ref) in enumerate(zip(tg, jg)):
        close(got, fix.get(i, lambda r: r)(np.asarray(ref)), 1e-4)


def test_torch_mlp_tails_replay_grad_matches_jax():
    """K6 and K7."""
    b, hw, c = 2, 16, 32
    r, y, g = (rand((b, hw, hw, c), s) for s in (101, 102, 100))
    w1, b1 = rand((c, 4 * c), 103, 0.1), rand((4 * c,), 104, 0.1)
    w2, b2 = rand((4 * c, c), 105, 0.1), rand((c,), 106, 0.1)
    jg = jax.grad(lambda *a: (jsb._compose_mlp_tail(*a) * j(g)).sum(),
                  argnums=tuple(range(6)))(*[j(v) for v in (r, y, w1, b1, w2, b2)])
    _, tg = _replay_grads(tsb.mlp_tail_plain, (r, y, w1.T, b1, w2.T, b2), (), g)
    for i, (got, ref) in enumerate(zip(tg, jg)):
        close(got, ref.T if i in (2, 4) else ref, 1e-4)

    w1, b1 = rand((c, c), 123, 0.1), rand((c,), 124, 0.1)
    wc, bc = rand((2, 2, c, c), 125, 0.1), rand((c,), 126, 0.1)
    w2, b2 = rand((c, c), 127, 0.1), rand((c,), 128, 0.1)
    jg = jax.grad(lambda *a: (jsb._compose_conv_tail_noln(*a) * j(g)).sum(),
                  argnums=tuple(range(8)))(
        *[j(v) for v in (r, y, w1, b1, wc, bc, w2, b2)])
    _, tg = _replay_grads(tsb.conv_mlp_tail_noln_plain,
                          (r, y, w1.T, b1, wc.transpose(3, 0, 1, 2), bc, w2.T,
                           b2), (), g)
    fix = {2: lambda a: a.T, 4: lambda a: a.transpose(3, 0, 1, 2),
           6: lambda a: a.T}
    for i, (got, ref) in enumerate(zip(tg, jg)):
        close(got, fix.get(i, lambda a: a)(np.asarray(ref)), 1e-4)


def test_torch_replay_backward_runs_the_composition_once():
    """The replay differentiates `compose`, not the launch: a launch whose
    output is detached from its inputs still yields the gradients."""
    x, w = t(rand((4, 8), 1)).requires_grad_(), t(rand((8, 8), 2)).requires_grad_()
    calls = []

    def launch(x_, w_, k):
        return (x_.detach() @ w_.detach() * k).clone()

    def compose(x_, w_, k):
        calls.append(k)
        return x_ @ w_ * k
    out = twa.Replay.apply(launch, compose, (3.0,), x, w)
    gx, gw = torch.autograd.grad(out.sum(), [x, w])
    assert calls == [3.0]
    close(gx, (3.0 * w.detach().sum(1)).expand(4, 8), 1e-6)
    close(gw, (3.0 * x.detach().sum(0))[:, None].expand(8, 8), 1e-6)
