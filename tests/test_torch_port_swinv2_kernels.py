"""K11 (the windowed attention core on pre-partitioned windows, forward and
backward) and its v1 caller vs the JAX package, on the CPU.

Forward: `reference_attention_qkv` / the CPU wrapper `fused_window_attention`
against the Pallas kernel `fused_window_attention` in interpret mode, 1e-5
in f32 (the same ops; the order of the sums differs) and 2e-2 of max |ref|
in bf16 (the kernel and the plain version round q * scale, P and the output
to bf16 at the same points, XLA and PyTorch sum in other orders).
Backward: `attention_qkv_bwd_plain` against `_pallas_attention_bwd` in
interpret mode, 1e-4 (the same f32 formulas), and against jax.vjp of the
reference, 2e-3 (the reference scales q before the product; the tolerance
of tests/test_pallas.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu.models import swin as jswin
from sodt_tpu.pallas import window_attention as jwa
from sodt_tpu_torch.kernels import window_attention as twa
from sodt_tpu_torch.models import swin as tswin
from sodt_tpu_torch.weights import from_jax_variables

from torch_port_common import rand, t, j, close, interpret_mode

# (windows, N, C, heads, windows per image): N 16 and 64, head dims 16 and
# 32, one window per image, several images
SHAPES = [(8, 16, 32, 2, 4), (4, 16, 64, 2, 2), (8, 64, 32, 2, 4),
          (4, 64, 96, 3, 4), (6, 64, 64, 4, 1)]


def _mask(nw, n, seed):
    m = np.where(rand((nw, n, n), seed) > 0.5, -100.0, 0.0).astype(np.float32)
    m[:, np.arange(n), np.arange(n)] = 0.0
    return m


def _inputs(w, n, c, nh, nw, masked):
    qkv, gy = rand((w, n, 3 * c), 1), rand((w, n, c), 3)
    bias = rand((nh, n, n), 2)
    mask = _mask(nw, n, 4) if masked else None
    return qkv, gy, bias, mask, (nw if masked else 1)


@pytest.mark.parametrize("w,n,c,nh,nw", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scale_one", [True, False], ids=["v2", "v1"])
def test_torch_window_attention_tokens_plain_matches_pallas(w, n, c, nh, nw,
                                                            masked, scale_one):
    qkv, _, bias, mask, nw = _inputs(w, n, c, nh, nw, masked)
    scale = 1.0 if scale_one else (c // nh) ** -0.5
    tm = None if mask is None else t(mask)
    jm = None if mask is None else j(mask)
    with interpret_mode():
        ref = jwa.fused_window_attention(j(qkv), j(bias), jm, nw, nh, scale)
    out = twa.fused_window_attention(t(qkv), t(bias), tm, nw, nh, scale)
    close(out, ref, 1e-5)
    close(twa.window_attention_core(t(qkv), t(bias), tm, nw, nh, scale), ref,
          1e-5)
    close(out, jwa.reference_attention_qkv(j(qkv), j(bias), jm, nw, nh, scale),
          1e-5)


@pytest.mark.parametrize("w,n,c,nh,nw", SHAPES[:2] + SHAPES[3:4])
def test_torch_window_attention_tokens_plain_bf16(w, n, c, nh, nw):
    qkv, _, bias, mask, nw = _inputs(w, n, c, nh, nw, True)
    with interpret_mode():
        ref = jwa.fused_window_attention(jnp.asarray(qkv, jnp.bfloat16),
                                         j(bias), j(mask), nw, nh, 1.0)
    out = twa.fused_window_attention(t(qkv).bfloat16(), t(bias), t(mask), nw,
                                     nh, 1.0)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("w,n,c,nh,nw", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_torch_window_attention_tokens_bwd_plain_matches_pallas(w, n, c, nh,
                                                                nw, masked):
    qkv, gy, bias, mask, nw = _inputs(w, n, c, nh, nw, masked)
    scale = (c // nh) ** -0.5
    tm = None if mask is None else t(mask)
    jm = None if mask is None else j(mask)
    dqkv, dbias = twa.window_attention_tokens_bwd(t(qkv), t(bias), tm, nw, nh,
                                                  scale, t(gy))
    with interpret_mode():
        pq, pb = jwa._pallas_attention_bwd(j(qkv), j(bias), jm, nw, nh, scale,
                                           j(gy))
    close(dqkv, pq, 1e-4)
    close(dbias, pb, 1e-4)
    assert np.abs(np.asarray(pq)).max() > 0
    _, vjp = jax.vjp(lambda q_, b_: jwa.reference_attention_qkv(
        q_, b_, jm, nw, nh, scale), j(qkv), j(bias))
    rq, rb = vjp(j(gy))
    close(dqkv, rq, 2e-3)
    close(dbias, rb, 2e-3)
    # autograd of the CPU wrapper (the plain forward) agrees too
    q = t(qkv).requires_grad_()
    bi = t(bias).requires_grad_()
    out = twa.fused_window_attention(q, bi, tm, nw, nh, scale)
    aq, ab = torch.autograd.grad(out, [q, bi], t(gy))
    close(aq, rq, 1e-4)
    close(ab, rb, 1e-4)


def test_torch_window_attention_bwd_plain_is_the_tokens_one_on_windows():
    """K9's plain version is K11's on the partitioned map."""
    b, hw, ws, c, nh = 2, 16, 8, 32, 2
    qkv, gy = t(rand((b, hw, hw, 3 * c), 5)), t(rand((b, hw, hw, c), 6))
    bias = t(rand((nh, 64, 64), 7))
    mask = t(jswin.shift_attn_mask(hw, hw, ws, 4))
    dq, db = twa.attention_nhwc_bwd_plain(qkv, bias, mask, ws, nh, 0.25, gy)
    pq, pb = twa.attention_qkv_bwd_plain(
        tswin.window_partition(qkv, ws), bias, mask, 4, nh, 0.25,
        tswin.window_partition(gy, ws))
    assert torch.equal(dq, tswin.window_unpartition(pq, ws, (hw, hw)))
    assert torch.equal(db, pb)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_ln", [False, True])
def test_torch_window_attention_module_on_tokens_matches_jax(masked, with_ln):
    """`WindowAttention` on (B_, N, C) window tokens (optional LN first),
    and the same parameters on the unpartitioned map."""
    dim, ws, nh, b, hw = 32, 4, 2, 2, 8
    x = rand((b, hw, hw, dim), 11)
    mask = jswin.shift_attn_mask(hw, hw, ws, 2) if masked else None
    ln = (1 + rand((dim,), 12, 0.1), rand((dim,), 13, 0.1)) if with_ln else None
    jmod = jswin.WindowAttention(dim, ws, nh)
    xw = np.asarray(jswin.window_partition(j(x), ws))
    v = jmod.init(jax.random.PRNGKey(0), j(xw))
    # the parameters only: `init` also fills the serving path's bias cache
    v = {"params": jax.tree.map(
        lambda a: np.asarray(a) + rand(a.shape, 14, 0.05), v["params"])}
    jln = None if ln is None else (j(ln[0]), j(ln[1]))
    ref = jmod.apply(v, j(xw), mask, ln=jln)
    tmod = tswin.WindowAttention(dim, ws, nh)
    tmod.load_state_dict(from_jax_variables(v))
    tln = None if ln is None else (t(ln[0]), t(ln[1]))
    tm = None if mask is None else t(mask)
    out = tmod(t(xw), tm, ln=tln)
    assert tuple(out.shape) == (b * 4, ws * ws, dim)
    close(out, ref, 1e-5)
    on_map = tmod(t(x), tm, ln=tln)
    close(tswin.window_partition(on_map, ws), ref, 1e-5)
