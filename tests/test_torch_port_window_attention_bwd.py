"""The register backward body (csrc/window_attention_bwd.cuh, windows of up
to 64 tokens) on the CPU, for its two callers: K9 on the map, its plain
mirror `attention_nhwc_bwd_mirror` against the Pallas backward
`_pallas_attention_nhwc_bwd` in interpret mode, and K11's backward on
pre-partitioned windows, `attention_qkv_bwd_mirror` against
`_pallas_attention_bwd`; and the wrappers' choice of body and of its group
count as plain functions.

The mirror is the kernel's arithmetic: P rounded to bf16 before dV = P^T
dO, dS before dQ and dK, dbias summed per group over its stages in order,
then over the groups. Without the rounding it holds the Pallas gradients
to 1e-5 of max |ref| (the same f32 formulas); with it dq / dk / dv hold
2e-2 and dbias 1e-3, the card's tolerances (chip_smoke KERNEL_TOL,
DBIAS_TOL). The group count changes only dbias's summation order: 1e-6.
"""

import numpy as np
import pytest
import torch

from sodt_tpu.models.swin import shift_attn_mask
from sodt_tpu.pallas import window_attention as jwa
from sodt_tpu_torch.kernels import window_attention as twa

from torch_port_common import rand, t, j, interpret_mode

KERNEL_TOL, DBIAS_TOL = 2e-2, 1e-3

# (nh, c, ws, b, h, w): head dims 16 and 8 x 2, windows of 16 and 64 tokens
SHAPES = [(2, 32, 4, 2, 8, 16), (2, 32, 8, 1, 16, 24), (4, 64, 8, 2, 16, 16)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(nh, c, ws, b, h, w, masked, seed=0):
    """bf16-valued f32 inputs (the kernel's inputs are bf16)."""
    n = ws * ws
    bf = lambda x: t(x).to(torch.bfloat16).float().numpy()
    qkv = bf(rand((b, h, w, 3 * c), 71 + seed))
    gy = bf(rand((b, h, w, c), 72 + seed))
    bias = rand((nh, n, n), 73 + seed)
    mask = shift_attn_mask(h, w, ws, ws // 2) if masked else None
    return qkv, gy, bias, mask


def _pallas(qkv, gy, bias, mask, ws, nh, scale):
    with interpret_mode():
        pq, pb = jwa._pallas_attention_nhwc_bwd(
            j(qkv), j(bias), None if mask is None else j(mask), ws, nh, scale,
            j(gy))
    return np.asarray(pq), np.asarray(pb)


def _mirror(qkv, gy, bias, mask, ws, nh, scale, **kw):
    dq, db = twa.attention_nhwc_bwd_mirror(
        t(qkv), t(bias), None if mask is None else t(mask), ws, nh, scale,
        t(gy), **kw)
    return dq.numpy(), db.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_mirror_without_rounding_matches_pallas(shape, masked):
    nh, c, ws, b, h, w = shape
    qkv, gy, bias, mask = _inputs(*shape, masked)
    scale = (c // nh) ** -0.5
    pq, pb = _pallas(qkv, gy, bias, mask, ws, nh, scale)
    mq, mb = _mirror(qkv, gy, bias, mask, ws, nh, scale, rounded=False)
    for k in range(3):              # dq, dk, dv: their scales differ
        sl = slice(k * c, (k + 1) * c)
        assert _rel(mq[..., sl], pq[..., sl]) < 1e-5
    assert _rel(mb, pb) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_mirror_rounded_within_card_tolerances(shape, masked):
    """P and dS rounded to bf16 at the kernel's points: within the
    tolerances the card holds K9 to, and not equal to the unrounded
    gradients (the rounding is really applied)."""
    nh, c, ws, b, h, w = shape
    qkv, gy, bias, mask = _inputs(*shape, masked, seed=1)
    scale = (c // nh) ** -0.5
    pq, pb = _pallas(qkv, gy, bias, mask, ws, nh, scale)
    mq, mb = _mirror(qkv, gy, bias, mask, ws, nh, scale)
    uq, _ = _mirror(qkv, gy, bias, mask, ws, nh, scale, rounded=False)
    for k in range(3):
        sl = slice(k * c, (k + 1) * c)
        assert _rel(mq[..., sl], pq[..., sl]) < KERNEL_TOL
        assert _rel(mq[..., sl], uq[..., sl]) > 1e-6
    assert _rel(mb, pb) < DBIAS_TOL


@pytest.mark.parametrize("ws,masked", [(4, False), (8, True)])
def test_dbias_group_counts_change_only_the_order(ws, masked):
    """dbias in f32 over 1, 3 and 128 groups (128: more groups than stages
    at ws 4, padded with empty stages) agree to 1e-6 of max |dbias|, and
    with the plain version's sum; dqkv does not depend on the groups."""
    nh, c = 2, 32
    qkv, gy, bias, mask = _inputs(nh, c, ws, 2, 32, 32, masked, seed=2)
    scale = (c // nh) ** -0.5
    outs = [_mirror(qkv, gy, bias, mask, ws, nh, scale, groups=gr,
                    rounded=False) for gr in (1, 3, 128)]
    for dq, db in outs[1:]:
        assert _rel(db, outs[0][1]) < 1e-6
        np.testing.assert_array_equal(dq, outs[0][0])
    _, pb = twa.attention_nhwc_bwd_plain(
        t(qkv), t(bias), None if mask is None else t(mask), ws, nh, scale,
        t(gy))
    assert _rel(outs[0][1], pb.numpy()) < 1e-6


def test_bwd_body_by_window_size():
    """The register body for every window of up to 64 tokens (ws 2 to 8),
    the strip body above (ws 16, N 256)."""
    assert [twa.bwd_body(ws * ws) for ws in (2, 3, 4, 5, 6, 7, 8)] == \
        ["regs"] * 7
    assert twa.bwd_body(256) == "strips" and twa.bwd_body(81) == "strips"
    assert [twa.stage_windows(ws * ws) for ws in (2, 4, 5, 8)] == \
        [4, 4, 1, 1]


def test_bwd_groups_rule():
    """ceil(BWD_CTAS / nh) groups, at most one per stage, at least 1; the
    strip body keeps min(windows, BWD_GROUPS)."""
    ctas = twa.BWD_CTAS
    # the flagship's two stages at batch 4 (1,024 and 256 windows, 12 heads)
    for total in (1024, 256):
        gr = twa.bwd_groups(total, 64, 12)
        assert gr == -(-ctas // 12) and 12 * gr >= ctas > 12 * (gr - 1)
    # fewer windows than groups, and a count that is no multiple of them
    assert twa.bwd_groups(3, 64, 12) == 3
    assert twa.bwd_groups(2 * ctas + 1, 64, 1) == ctas
    # four windows to a stage at N <= 16
    assert twa.bwd_groups(10, 16, 2) == 3
    assert twa.bwd_groups(4 * ctas, 16, 1) == ctas
    assert twa.bwd_groups(1, 9, 4) == 1
    # the strip body
    assert twa.bwd_groups(16, 256, 4) == 16
    assert twa.bwd_groups(1000, 256, 4) == twa.BWD_GROUPS


def test_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper returns the plain version, whatever the
    body its N would take on the card."""
    nh, c, ws = 2, 32, 4
    qkv, gy, bias, mask = _inputs(nh, c, ws, 1, 8, 8, True, seed=3)
    args = (t(qkv), t(bias), t(mask), ws, nh, (c // nh) ** -0.5, t(gy))
    dq, db = twa.window_attention_bwd(*args)
    rq, rb = twa.attention_nhwc_bwd_plain(*args)
    assert torch.equal(dq, rq) and torch.equal(db, rb)


# ----------------------------------------------- K11: pre-partitioned windows

# (windows, N, C, nh, nw): head dims 16 and 32, windows of 16 and 64 tokens,
# nw > 1 (window w takes mask[w mod nw]), window counts that are no
# multiple of the group count (5 at 4 windows to a stage, 7 and 12 in
# 2 and 5 groups)
K11_SHAPES = [(8, 16, 32, 2, 4), (5, 16, 32, 2, 5), (6, 64, 64, 2, 3),
              (12, 64, 96, 3, 4)]


def _k11_inputs(w, n, c, nh, nw, masked, seed=0):
    """bf16-valued f32 inputs; a 0 / -100 mask with its diagonal kept (no
    fully masked row), as the shift mask of a SwinV2 stage."""
    bf = lambda x: t(x).to(torch.bfloat16).float().numpy()
    qkv = bf(rand((w, n, 3 * c), 81 + seed))
    gy = bf(rand((w, n, c), 82 + seed))
    bias = rand((nh, n, n), 83 + seed)
    mask = None
    if masked:
        mask = np.where(rand((nw, n, n), 84 + seed) > 0.5, -100.0,
                        0.0).astype(np.float32)
        for m in mask:
            np.fill_diagonal(m, 0.0)
    return qkv, gy, bias, mask, (nw if masked else 1)


def _pallas_tokens(qkv, gy, bias, mask, nw, nh, scale):
    with interpret_mode():
        pq, pb = jwa._pallas_attention_bwd(
            j(qkv), j(bias), None if mask is None else j(mask), nw, nh,
            scale, j(gy))
    return np.asarray(pq), np.asarray(pb)


def _mirror_tokens(qkv, gy, bias, mask, nw, nh, scale, **kw):
    dq, db = twa.attention_qkv_bwd_mirror(
        t(qkv), t(bias), None if mask is None else t(mask), nw, nh, scale,
        t(gy), **kw)
    return dq.numpy(), db.numpy()


@pytest.mark.parametrize("shape", K11_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_tokens_mirror_matches_pallas(shape, masked):
    """K11's mirror against `_pallas_attention_bwd` in interpret mode:
    without the rounding the same f32 formulas, 1e-5 of max |ref|; with it
    dq / dk / dv within the card's KERNEL_TOL and dbias within DBIAS_TOL,
    and not equal to the unrounded gradients."""
    w, n, c, nh, nw = shape
    qkv, gy, bias, mask, nw = _k11_inputs(*shape, masked)
    scale = (c // nh) ** -0.5
    pq, pb = _pallas_tokens(qkv, gy, bias, mask, nw, nh, scale)
    uq, ub = _mirror_tokens(qkv, gy, bias, mask, nw, nh, scale,
                            rounded=False)
    mq, mb = _mirror_tokens(qkv, gy, bias, mask, nw, nh, scale)
    for k in range(3):
        sl = slice(k * c, (k + 1) * c)
        assert _rel(uq[..., sl], pq[..., sl]) < 1e-5
        assert _rel(mq[..., sl], pq[..., sl]) < KERNEL_TOL
        assert _rel(mq[..., sl], uq[..., sl]) > 1e-6
    assert _rel(ub, pb) < 1e-5
    assert _rel(mb, pb) < DBIAS_TOL


def test_tokens_mirror_is_the_map_mirror_on_its_windows():
    """One body, two addressings: K9's mirror on a map is K11's mirror on
    the map's windows taken out in row-major order, bit for bit (the same
    windows in the same order give the same dbias sum)."""
    nh, c, ws = 2, 32, 4
    qkv, gy, bias, mask = _inputs(nh, c, ws, 2, 8, 16, True, seed=4)
    scale = (c // nh) ** -0.5
    mq, mb = _mirror(qkv, gy, bias, mask, ws, nh, scale)
    win = lambda x: twa._to_windows(t(x), ws).numpy()
    tq, tb = _mirror_tokens(win(qkv), win(gy), bias, mask, mask.shape[0],
                            nh, scale)
    np.testing.assert_array_equal(
        twa._from_windows(t(tq), 2, 8, 16, ws).numpy(), mq)
    np.testing.assert_array_equal(tb, mb)


def test_tokens_bwd_groups_as_the_wrapper_uses_them():
    """K11's backward takes `bwd_groups` of its windows: at SwinV2's four
    stages at batch 4 (1,024 / 256 / 64 / 16 windows of 64 tokens, 3 / 6 /
    12 / 24 heads) ceil(BWD_CTAS / nh) groups, at most one per window; the
    strip body above 64 tokens keeps min(windows, BWD_GROUPS)."""
    ctas = twa.BWD_CTAS
    got = [twa.bwd_groups(w, 64, nh)
           for w, nh in ((1024, 3), (256, 6), (64, 12), (16, 24))]
    assert got == [-(-ctas // 3), -(-ctas // 6), -(-ctas // 12), 11]
    assert [twa.bwd_body(n) for n in (4, 16, 64, 100, 256)] == \
        ["regs"] * 3 + ["strips"] * 2
    assert twa.bwd_groups(300, 100, 2) == twa.BWD_GROUPS


def test_tokens_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor K11's backward wrapper returns the plain version."""
    w, n, c, nh, nw = K11_SHAPES[0]
    qkv, gy, bias, mask, nw = _k11_inputs(w, n, c, nh, nw, True, seed=5)
    args = (t(qkv), t(bias), t(mask), nw, nh, (c // nh) ** -0.5, t(gy))
    dq, db = twa.window_attention_tokens_bwd(*args)
    rq, rb = twa.attention_qkv_bwd_plain(*args)
    assert torch.equal(dq, rq) and torch.equal(db, rb)
