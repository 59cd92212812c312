"""Swin block, window helpers and cross-channel attention: port vs the JAX
package's modules (XLA path on the CPU), f32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sodt_tpu.models import swin as jswin
from sodt_tpu.models.cattention import CAttentionBlock as JCAB
from sodt_tpu_torch.models import swin as tswin
from sodt_tpu_torch.models.cattention import CAttentionBlock as TCAB
from sodt_tpu_torch.weights import from_jax_variables

from torch_port_common import rand, t, j, close, randomize_variables


def test_window_helpers_match():
    x = rand((2, 16, 24, 5), 0)
    w = tswin.window_partition(t(x), 8)
    close(w, jswin.window_partition(j(x), 8), 0)
    close(tswin.window_unpartition(w, 8, (16, 24)), x, 0)
    np.testing.assert_array_equal(tswin.shift_attn_mask(16, 24, 8, 2),
                                  jswin.shift_attn_mask(16, 24, 8, 2))
    np.testing.assert_array_equal(tswin.relative_position_index(8),
                                  jswin.relative_position_index(8))


def _pair(dim, nh, ws, shift, hw, seed):
    jb = jswin.SwinBlock(dim=dim, input_resolution=hw, num_heads=nh,
                         window_size=ws, shift_size=shift,
                         linear_mlp=shift == 0)
    x = rand((2, hw[0], hw[1], dim), seed)
    v = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(seed), j(x)))
    v = randomize_variables(v, seed)
    tb = tswin.SwinBlock(dim, nh, ws, shift, linear_mlp=shift == 0)
    tb.load_state_dict(from_jax_variables(v))
    return jb, v, tb.eval(), x


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("dim,hw", [(32, (16, 16)), (48, (16, 24))])
def test_split_block_matches_jax_block(shift, dim, hw):
    """The port's LN-outside split (the main-path dispatch on the card,
    here through the kernels' plain versions) vs JAX SwinBlock, 2e-3."""
    jb, v, tb, x = _pair(dim, 4, 8, shift, hw, 3 + shift)
    ref = jb.apply(v, j(x))
    ws = 8
    mask = (torch.from_numpy(tswin.shift_attn_mask(hw[0], hw[1], ws, shift))
            if shift else None)
    with torch.no_grad():
        out = tswin.split_block(tb, t(x), mask, shift)
    close(out, ref, 2e-3)


@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("dim,hw", [(32, (16, 16)), (48, (16, 24))])
def test_mega_block_matches_jax_block(linear, shift, dim, hw):
    """The port's megakernel path for c <= 256 (K2 for a linear-MLP block,
    K3 + K4 for a conv-MLP block; here through their plain versions) vs JAX
    SwinBlock, 2e-3. A shifted linear block, which JAX sends to its XLA
    composition, runs through K2 here."""
    jb = jswin.SwinBlock(dim=dim, input_resolution=hw, num_heads=4,
                         window_size=8, shift_size=shift, linear_mlp=linear)
    x = rand((2, hw[0], hw[1], dim), 11 + shift)
    v = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(shift), j(x)))
    v = randomize_variables(v, 12 + shift)
    tb = tswin.SwinBlock(dim, 4, 8, shift, linear_mlp=linear)
    tb.load_state_dict(from_jax_variables(v))
    mask = (torch.from_numpy(tswin.shift_attn_mask(hw[0], hw[1], 8, shift))
            if shift else None)
    with torch.no_grad():
        out = tswin.mega_block(tb.eval(), t(x), mask, shift)
    close(out, jb.apply(v, j(x)), 2e-3)


@pytest.mark.parametrize("dim,nh,ws,shift,hw", [
    (32, 4, 8, 0, (16, 16)),
    (32, 4, 8, 2, (16, 16)),
    (32, 4, 8, 2, (12, 20)),     # padded to a window multiple, then cropped
    (64, 4, 32, 0, (8, 8)),      # global: one 32x32 window, padded tokens
])
def test_block_plain_path_matches_jax_block(dim, nh, ws, shift, hw):
    jb, v, tb, x = _pair(dim, nh, ws, shift, hw, 7)
    with torch.no_grad():
        out = tb(t(x))
    close(out, jb.apply(v, j(x)), 1e-5)


@pytest.mark.parametrize("ws,shift", [(1, 0), (4, 0), (4, 2)])
def test_cattention_block_matches_jax(ws, shift):
    maps = [rand((2, 8, 8, 24), 40 + i) for i in range(4)]
    jm = JCAB(embedding_dim=24, num_heads=4, window_size=ws, shift_size=shift)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         *[j(m) for m in maps]))
    v = randomize_variables(v, 1)
    tm = TCAB(24, 4, ws, shift)
    tm.load_state_dict(from_jax_variables(v))
    ref = jm.apply(v, *[j(m) for m in maps])
    with torch.no_grad():
        out = tm(*[t(m) for m in maps])
    for a, b in zip(out, ref):
        close(a, b, 1e-5)
