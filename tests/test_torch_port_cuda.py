"""The port's CUDA kernels vs their plain versions, on the card.

Marked `cuda`: each test skips (inside the test, never at import) when no
card is visible. Run them on a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda

Inputs are bf16; each kernel is compared with its plain version computed
in f32 from the same bf16 inputs. Tolerance 2e-2 of max |ref|: bf16 keeps
8 mantissa bits (a relative step of 2^-8 = 3.9e-3), and the kernels round
q*scale, qkv, P, the hidden activations and the output to bf16 at other
points than an f32 reference does, so a few bf16 steps separate them.
"""

import pytest
import torch

from sodt_tpu_torch import kernels
from sodt_tpu_torch.kernels import window_attention as wa, swin_block as sb
from sodt_tpu_torch.models.swin import shift_attn_mask

pytestmark = pytest.mark.cuda
TOL = 2e-2
BF = torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rnd(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).cuda()


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("b,hw,c", [(1, 16, 32), (2, 128, 192), (2, 64, 384)])
@pytest.mark.parametrize("shift", [0, 2])
def test_block_attention_kernel(card, b, hw, c, shift):
    nh, ws = (2 if c == 32 else 12), 8
    x = _rnd((b, hw, hw, c), 1).to(BF)
    w = [_rnd((3 * c, c), 2, c ** -0.5).to(BF), _rnd((3 * c,), 3, 0.1).to(BF),
         _rnd((c, c), 4, c ** -0.5).to(BF), _rnd((c,), 5, 0.1).to(BF)]
    bias = _rnd((nh, 64, 64), 6)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
            if shift else None)
    scale = (c // nh) ** -0.5
    out = wa.fused_block_attention(x, *w, bias, mask, ws, nh, scale, shift)
    ref = wa.block_attention_plain(x.float(), *[t.float() for t in w], bias,
                                   mask, ws, nh, scale, shift)
    torch.cuda.synchronize()
    assert _rel(out, ref) < TOL


def _check_mlp_tails(b, h, w, c, hid):
    """K6 and K7 against their plain versions in f32 on the same bf16
    inputs, and each bit-equal over two runs (no atomics, no split-K)."""
    r, y = _rnd((b, h, w, c), 7).to(BF), _rnd((b, h, w, c), 8).to(BF)
    w6 = [_rnd((hid, c), 9, c ** -0.5).to(BF), _rnd((hid,), 10, 0.1).to(BF),
          _rnd((c, hid), 11, hid ** -0.5).to(BF), _rnd((c,), 12, 0.1).to(BF)]
    out = sb.fused_mlp_tail(r, y, *w6)
    ref = sb.mlp_tail_plain(r.float(), y.float(), *[t.float() for t in w6])
    assert _rel(out, ref) < TOL
    assert torch.equal(out, sb.fused_mlp_tail(r, y, *w6))
    w7 = [_rnd((c, c), 13, c ** -0.5).to(BF), _rnd((c,), 14, 0.1).to(BF),
          _rnd((c, 2, 2, c), 15, (4 * c) ** -0.5).to(BF),
          _rnd((c,), 16, 0.1).to(BF), _rnd((c, c), 17, c ** -0.5).to(BF),
          _rnd((c,), 18, 0.1).to(BF)]
    out = sb.fused_conv_mlp_tail_noln(r, y, *w7)
    ref = sb.conv_mlp_tail_noln_plain(r.float(), y.float(),
                                      *[t.float() for t in w7])
    torch.cuda.synchronize()
    assert _rel(out, ref) < TOL
    assert torch.equal(out, sb.fused_conv_mlp_tail_noln(r, y, *w7))


@pytest.mark.parametrize("b,hw,c", [(1, 16, 32), (2, 128, 192), (2, 64, 384),
                                    (3, 20, 384)])
def test_mlp_tails_kernels(card, b, hw, c):
    """At (3, 20, 384) M = 1200 is no multiple of the core's 128-row tile
    and its tiles cross images (the conv's gather reads across them)."""
    _check_mlp_tails(b, hw, hw, c, 4 * c)


def test_mlp_tails_narrow(card):
    """The narrowest domain: C = 48 (K7's conv K = 192 spans taps inside a
    32-deep K step), hidden 192, a 9 x 13 map."""
    _check_mlp_tails(1, 9, 13, 48, 192)


@pytest.mark.parametrize("m,n,k", [(1000, 1536, 384), (1000, 384, 1536)])
@pytest.mark.parametrize("mode", ["gelu", "bias", "residual"])
def test_gemm_core_kernel(card, m, n, k, mode):
    """One launch of the GEMM core against an f32 torch.matmul of the same
    bf16 inputs (M = 1000: a ragged last row tile; both tile widths).
    The kernel rounds once, at the store: within one bf16 step (2^-8) of
    max |ref|."""
    a, w = _rnd((m, k), 40).to(BF), _rnd((n, k), 41, k ** -0.5).to(BF)
    b, r = _rnd((n,), 42, 0.1).to(BF), _rnd((m, n), 43).to(BF)
    code = {"gelu": sb.GEMM_GELU, "bias": sb.GEMM_BIAS,
            "residual": sb.GEMM_RESIDUAL}[mode]
    rr = r if mode == "residual" else None
    out = sb.gemm_core(a, w, b, code, rr)
    z = torch.matmul(a.float(), w.float().t()) + b.float()
    if mode == "gelu":
        z = torch.nn.functional.gelu(z, approximate="tanh")
    elif mode == "residual":
        z = z + r.float()
    torch.cuda.synchronize()
    assert out.shape == (m, n) and _rel(out, z) < 2 ** -8
    assert torch.equal(out, sb.gemm_core(a, w, b, code, rr))


@pytest.mark.parametrize("b,hw,c,nh,ws", [(1, 8, 64, 4, 8),
                                          (2, 32, 768, 12, 32),
                                          (1, 64, 768, 12, 32),
                                          (2, 32, 384, 12, 32),
                                          (4, 32, 768, 12, 32),
                                          (16, 32, 768, 12, 32),
                                          (4, 64, 384, 12, 32),
                                          (2, 32, 256, 2, 32)])
@pytest.mark.parametrize("masked", [False, True])
def test_global_attention_kernel(card, b, hw, c, nh, ws, masked):
    """K8: one window over the map, or (64 px map, ws 32) four windows of
    1024 tokens, with and without a shift mask; head dims 16, 32 (a scale
    that is no power of two), 64 and 128; batch 1 to 16 (the raster runs
    the windows of one bias tile side by side)."""
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 19).to(BF)
    bias = _rnd((nh, n, n), 20)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, 2)).cuda()
            if masked and hw > ws else None)
    scale = (c // nh) ** -0.5
    out = wa.fused_global_attention(qkv, bias, nh, scale, ws, mask)
    ref = wa.global_attention_plain(qkv.float(), bias, nh, scale, ws, mask)
    torch.cuda.synchronize()
    assert _rel(out, ref) < TOL


@pytest.mark.parametrize("b,hw,c,nh,ws,masked", [(2, 32, 768, 12, 32, False),
                                                 (2, 32, 384, 12, 32, False),
                                                 (1, 64, 768, 12, 32, True)])
def test_global_attention_lse(card, b, hw, c, nh, ws, masked):
    """K8 with its statistics for K10: the output bit-equal to K8's
    without them; the log-sum-exp that of K8's own S (q scaled in bf16) to
    1e-4 of its value (f32 sums of unrounded exponentials); the f32 output
    that of the plain version with P in f32 (O = softmax(S) V) to 1e-4, far
    closer than the bf16 output (P rounded, ~4e-3)."""
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 21).to(BF)
    bias = _rnd((nh, n, n), 22)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, 2)).cuda()
            if masked else None)
    scale = (c // nh) ** -0.5
    out, none = wa._launch_global(qkv, bias, mask, nh, scale, ws, False)
    out2, (o32, lse) = wa._launch_global(qkv, bias, mask, nh, scale, ws, True)
    ref = wa.global_attention_lse_plain(qkv, bias, nh, scale, ws, mask,
                                        forward=True)
    s = wa._scores(qkv, bias, nh, scale, ws, mask, True)
    v = wa._heads(qkv, ws, nh, 3)[2]
    o = torch.matmul(torch.softmax(s, -1), v)          # (B*nW, nh, N, hd)
    o = o.reshape(b, hw // ws, hw // ws, nh, ws, ws, -1)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, hw, hw, c)
    torch.cuda.synchronize()
    assert none is None and torch.equal(out, out2)
    assert _rel(lse, ref) < 1e-4
    assert _rel(o32, o) < 1e-4


@pytest.mark.parametrize("b,hw,c,nh,ws", [(1, 16, 32, 2, 8), (2, 80, 384, 12, 8),
                                          (1, 32, 256, 4, 16)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_kernel(card, b, hw, c, nh, ws, masked):
    """K1 at head dims 16, 32 and 64 and windows of 64 and 256 tokens."""
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 21).to(BF)
    bias = _rnd((nh, n, n), 22)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, ws // 4)).cuda()
            if masked else None)
    scale = (c // nh) ** -0.5
    out = wa.fused_window_attention_nhwc(qkv, bias, mask, ws, nh, scale)
    ref = wa.reference_attention_nhwc(qkv.float(), bias, mask, ws, nh, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref) < TOL


def _block_weights(c, seed):
    g = lambda shape, k, s: _rnd(shape, seed + k, s)
    ln = lambda k: ((1 + g((c,), k, 0.1)).float(), g((c,), k + 1, 0.1).float())
    return dict(
        ln1=ln(0), ln2=ln(2),
        att=[g((3 * c, c), 4, c ** -0.5).to(BF), g((3 * c,), 5, 0.1).to(BF),
             g((c, c), 6, c ** -0.5).to(BF), g((c,), 7, 0.1).to(BF)],
        lin=[g((4 * c, c), 8, c ** -0.5).to(BF), g((4 * c,), 9, 0.1).to(BF),
             g((c, 4 * c), 10, (4 * c) ** -0.5).to(BF), g((c,), 11, 0.1).to(BF)],
        conv=[g((c, c), 12, c ** -0.5).to(BF), g((c,), 13, 0.1).to(BF),
              g((c, 2, 2, c), 14, (4 * c) ** -0.5).to(BF),
              g((c,), 15, 0.1).to(BF), g((c, c), 16, c ** -0.5).to(BF),
              g((c,), 17, 0.1).to(BF)])


def _f32(ts):
    return [t.float() for t in ts]


@pytest.mark.parametrize("b,hw,c,nh", [(1, 16, 32, 2), (2, 128, 192, 12)])
@pytest.mark.parametrize("shift", [0, 2])
def test_megakernels(card, b, hw, c, nh, shift):
    """K2 (whole linear block), K3 (LN1 + attention, shifted output) and K4
    (un-shift + residual + LN2 + conv MLP)."""
    ws = 8
    wt = _block_weights(c, 30)
    x = _rnd((b, hw, hw, c), 1).to(BF)
    bias = _rnd((nh, 64, 64), 6)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
            if shift else None)
    scale = (c // nh) ** -0.5
    out = sb.fused_swin_block(x, *wt["ln1"], *wt["att"], *wt["ln2"],
                              *wt["lin"], bias, mask, ws, nh, scale, shift)
    ref = sb.swin_block_plain(x.float(), *wt["ln1"], *_f32(wt["att"]),
                              *wt["ln2"], *_f32(wt["lin"]), bias, mask, ws,
                              nh, scale, shift)
    assert _rel(out, ref) < TOL
    a = wa.fused_block_attention_ln(x, *wt["ln1"], *wt["att"], bias, mask, ws,
                                    nh, scale, shift)
    ref_a = wa.block_attention_ln_plain(x.float(), *wt["ln1"], *_f32(wt["att"]),
                                        bias, mask, ws, nh, scale, shift)
    assert _rel(a, ref_a) < TOL
    out = sb.fused_conv_mlp_tail(x, a, *wt["ln2"], *wt["conv"], shift)
    ref = sb.conv_mlp_tail_plain(x.float(), a.float(), *wt["ln2"],
                                 *_f32(wt["conv"]), shift)
    torch.cuda.synchronize()
    assert _rel(out, ref) < TOL


# K2's chain (csrc/swin_block_chain.cu: K13's LN body, the wgmma GEMM core,
# the forward's register attention core) against its rounded mirror
# `swin_block_chain_plain`, in f32 from the same bf16 inputs. They round at
# the same points and keep res1 in f32; the GEMMs' summation order and
# ex2.approx round a few intermediates the other way, which moves a few
# output elements by one bf16 step: below 1e-3 relative L2 (5e-4 between
# the mirror and the Pallas kernel on the CPU,
# tests/test_torch_port_swin_block.py). The mirror with res1 rounded to bf16
# reads ~3e-3 and must stay above the bound. Max |diff| cannot tell them
# apart (one bf16 step of the largest element is 4e-3 of max |ref|): it is
# held to TOL.
K2_CHAIN_L2 = 1e-3


def _rel_l2_of(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).norm() / ref.norm()).item()


# the flagship's stage 1 at 512 px and 608 px (a 152 x 152 map, 19
# windows a row) at batch 4, head dims 16, 32 and 64
@pytest.mark.parametrize("b,hw,c,nh", [(4, 128, 192, 12), (4, 152, 192, 12),
                                       (2, 32, 128, 4), (2, 24, 64, 1)])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_block_chain_vs_mirror(card, b, hw, c, nh, shifted):
    """K2 through the chain, at shift 0 and at ws / 2 with the mask (the
    rolled core reads and writes at ((r + s) mod H, (c + s) mod W)),
    against the mirror: relative L2 below K2_CHAIN_L2 over the map and
    over its wrapping windows (the last window row and column), max
    |diff| below TOL; the res1-rounded mirror reads above the bound;
    bit-equal over two runs, one counted launch a call."""
    ws = 8
    shift = ws // 2 if shifted else 0
    assert sb.swin_block_body(c, nh, ws) == "chain"
    wt = _block_weights(c, 80)
    x = _rnd((b, hw, hw, c), 81).to(BF)
    bias = _rnd((nh, 64, 64), 82)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
            if shift else None)
    args = (x, *wt["ln1"], *wt["att"], *wt["ln2"], *wt["lin"], bias, mask,
            ws, nh, (c // nh) ** -0.5, shift)
    kernels.reset_launches()
    out = sb.fused_swin_block(*args)
    again = sb.fused_swin_block(*args)
    mir = sb.swin_block_chain_plain(*args)
    control = sb.swin_block_chain_plain(*args, res1_rounded=True)
    torch.cuda.synchronize()
    assert out.dtype == BF and out.shape == x.shape
    assert kernels.launches()["swin_block"] == 2
    assert _rel(out, mir) < TOL
    assert _rel_l2_of(out, mir) < K2_CHAIN_L2
    for edge in ((slice(None), slice(-ws, None)),
                 (slice(None), slice(None), slice(-ws, None))):
        assert _rel_l2_of(out[edge], mir[edge]) < K2_CHAIN_L2
    assert _rel_l2_of(control, mir) > K2_CHAIN_L2
    assert torch.equal(out, again)


def test_swin_block_bodies_by_kernel_name(card):
    """The kernels the profiler sees in a K2 call: the chain's GEMM core,
    LN and register attention core (FwdMap at shift 0, FwdRolledMap at a
    shift) at head dim 16; swin_window_kernel<true> at head dim 128, which
    the chain does not take, still held to the plain version."""
    c, nh, ws, hw = 64, 4, 8, 16
    wt = _block_weights(c, 84)
    x = _rnd((1, hw, hw, c), 85).to(BF)
    bias = _rnd((nh, 64, 64), 86)
    mask = torch.from_numpy(shift_attn_mask(hw, hw, ws, 4)).cuda()
    run = lambda *a: sb.fused_swin_block(x, *wt["ln1"], *wt["att"],
                                         *wt["ln2"], *wt["lin"], *a)
    parts = ("layernorm_kernel", "gemm_core_kernel",
             "window_attn_fwd_kernel<16, 64, sodt::FwdMap>")
    names = _device_kernel_names(lambda: run(bias, None, ws, nh, 0.25, 0),
                                 *parts)
    for part in parts:
        assert any(part in k for k in names), (part, names)
    assert not any("swin_window_kernel" in k for k in names)
    rolled = "window_attn_fwd_kernel<16, 64, sodt::FwdRolledMap>"
    names = _device_kernel_names(lambda: run(bias, mask, ws, nh, 0.25, 4),
                                 rolled)
    assert any(rolled in k for k in names), names
    c, nh = 256, 2
    assert sb.swin_block_body(c, nh, ws) == "window"
    wt = _block_weights(c, 87)
    x = _rnd((1, hw, hw, c), 88).to(BF)
    bias = _rnd((nh, 64, 64), 89)
    args = (x, *wt["ln1"], *wt["att"], *wt["ln2"], *wt["lin"], bias, mask,
            ws, nh, (c // nh) ** -0.5, 4)
    names = _device_kernel_names(lambda: sb.fused_swin_block(*args),
                                 "swin_window_kernel<true>")
    assert any("swin_window_kernel<true>" in k for k in names), names
    out = sb.fused_swin_block(*args)
    ref = sb.swin_block_plain(*[a.float() if torch.is_tensor(a)
                                and a.dtype == BF else a for a in args])
    torch.cuda.synchronize()
    assert _rel(out, ref) < TOL


# K3's and K4's chains (csrc/shifted_block_chain.cu) against their rounded
# mirrors `block_attention_ln_chain_plain` and `conv_tail_chain_plain`, in
# f32 from the same bf16 inputs, to K2_CHAIN_L2, as K2's chain: the mirrors
# hold the Pallas kernels to 2e-4 relative L2 on the CPU
# (tests/test_torch_port_block_chains.py), and the kernels' GEMM summation
# order and ex2.approx move a few elements by one bf16 step. Each mirror's
# control (K3: the core's q * scale, P and output kept in f32; K4: res1
# rounded to bf16) reads ~3e-3 and must stay above the bound.
SHIFTED_SHAPES = [(4, 128, 192, 12), (4, 152, 192, 12), (2, 32, 128, 4),
                  (2, 24, 64, 1)]


def _check_chain(fn, mirror, plain, args, counter, control_kw):
    """The chain's output against its mirror by relative L2 over the map
    and over its wrapping last window row and column, against the f32
    plain version by max |diff| (TOL); the control above the bound;
    bit-equal over two runs, one counted launch a call."""
    ws = 8
    kernels.reset_launches()
    out = fn(*args)
    again = fn(*args)
    mir = mirror(*args)
    control = mirror(*args, **control_kw)
    ref = plain(*[a.float() if torch.is_tensor(a) and a.dtype == BF else a
                  for a in args])
    torch.cuda.synchronize()
    assert out.dtype == BF and out.shape == args[0].shape
    assert kernels.launches()[counter] == 2
    assert _rel(out, ref) < TOL
    assert _rel_l2_of(out, mir) < K2_CHAIN_L2
    for edge in ((slice(None), slice(-ws, None)),
                 (slice(None), slice(None), slice(-ws, None))):
        assert _rel_l2_of(out[edge], mir[edge]) < K2_CHAIN_L2
    assert _rel_l2_of(control, mir) > K2_CHAIN_L2
    assert torch.equal(out, again)


@pytest.mark.parametrize("b,hw,c,nh", SHIFTED_SHAPES)
@pytest.mark.parametrize("shift", [0, 2])
def test_block_attention_ln_chain_vs_mirror(card, b, hw, c, nh, shift):
    """K3 through the chain at the flagship's stage 1 at 512 and 608 px and
    at two small shapes (head dims 16, 32, 64), at shift 0 and at shift 2
    with the mask (the core reads at ((r + 2) mod H, (c + 2) mod W) and
    writes at (r, c): the output in shifted coordinates)."""
    ws = 8
    assert sb.swin_block_body(c, nh, ws) == "chain"
    wt = _block_weights(c, 90)
    x = _rnd((b, hw, hw, c), 91).to(BF)
    bias = _rnd((nh, 64, 64), 92)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
            if shift else None)
    _check_chain(wa.fused_block_attention_ln, wa.block_attention_ln_chain_plain,
                 wa.block_attention_ln_plain,
                 (x, *wt["ln1"], *wt["att"], bias, mask, ws, nh,
                  (c // nh) ** -0.5, shift), "block_attention_ln",
                 {"core_rounded": False})


@pytest.mark.parametrize("b,hw,c,nh", SHIFTED_SHAPES)
@pytest.mark.parametrize("shift", [0, 2])
def test_conv_tail_chain_vs_mirror(card, b, hw, c, nh, shift):
    """K4 through the chain at the same shapes: a read at ((i - 2) mod H,
    (j - 2) mod W) (the un-shift), the conv's zero taps below the last row
    and right of the last column, res1 in f32 from its sum to fc2."""
    wt = _block_weights(c, 93)
    x = _rnd((b, hw, hw, c), 94).to(BF)
    a = _rnd((b, hw, hw, c), 95).to(BF)
    _check_chain(sb.fused_conv_mlp_tail, sb.conv_tail_chain_plain,
                 sb.conv_mlp_tail_plain,
                 (x, a, *wt["ln2"], *wt["conv"], shift), "conv_mlp_tail",
                 {"res1_rounded": True})


def test_shifted_block_chains_by_kernel_name(card):
    """The kernels the profiler sees in a K3 and a K4 call at head dim 16
    and shift 4: K13's LN body, the GEMM core and the register attention
    core with K5's addressing (FwdShiftedMap) for K3; K13's body with the
    un-shift add front (mode 3; a whole warp a row at C 64), the GEMM core
    and its conv gather (loader 1) for K4; no
    kernel of csrc/swin_block.cu. swin_window_kernel<false> at head dim
    128, which the chain does not take, still held to the plain version."""
    c, nh, ws, hw = 64, 4, 8, 16
    wt = _block_weights(c, 96)
    x = _rnd((1, hw, hw, c), 97).to(BF)
    bias = _rnd((nh, 64, 64), 98)
    mask = torch.from_numpy(shift_attn_mask(hw, hw, ws, 4)).cuda()
    parts = ("layernorm_kernel", "gemm_core_kernel<0, 1, 96",
             "window_attn_fwd_kernel<16, 64, sodt::FwdShiftedMap>")
    names = _device_kernel_names(
        lambda: wa.fused_block_attention_ln(x, *wt["ln1"], *wt["att"], bias,
                                            mask, ws, nh, 0.25, 4), *parts)
    for part in parts:
        assert any(part in k for k in names), (part, names)
    assert not any("swin_window_kernel" in k for k in names)
    parts = ("layernorm_kernel<3, 4, 32>", "gemm_core_kernel<0, 1, 96",
             "gemm_core_kernel<1, 0, 96", "gemm_core_kernel<0, 4, 96")
    names = _device_kernel_names(
        lambda: sb.fused_conv_mlp_tail(x, x, *wt["ln2"], *wt["conv"], 4),
        *parts)
    for part in parts:
        assert any(part in k for k in names), (part, names)
    assert not any("conv_tail" in k for k in names)
    c, nh = 256, 2
    assert sb.swin_block_body(c, nh, ws) == "window"
    wt = _block_weights(c, 99)
    x = _rnd((1, hw, hw, c), 100).to(BF)
    bias = _rnd((nh, 64, 64), 101)
    args = (x, *wt["ln1"], *wt["att"], bias, mask, ws, nh, (c // nh) ** -0.5,
            4)
    names = _device_kernel_names(lambda: wa.fused_block_attention_ln(*args),
                                 "swin_window_kernel<false>")
    assert any("swin_window_kernel<false>" in k for k in names), names
    out = wa.fused_block_attention_ln(*args)
    ref = wa.block_attention_ln_plain(*[a.float() if torch.is_tensor(a)
                                        and a.dtype == BF else a
                                        for a in args])
    torch.cuda.synchronize()
    assert _rel(out, ref) < TOL


# K5's chain (csrc/block_attention.cu) against its rounded mirror
# `block_attention_chain_plain` as K3's: relative L2 K2_CHAIN_L2 over the
# map and its wrapping windows, the f32 plain version by max |diff|, the
# core's rounding points in f32 as the control
@pytest.mark.parametrize("b,hw,c,nh", [(2, 64, 384, 12), (1, 16, 32, 2)])
@pytest.mark.parametrize("shift", [0, 2])
def test_block_attention_chain_vs_mirror(card, b, hw, c, nh, shift):
    """K5 through the chain at the flagship's stage 2 (qkv N = 1,152 on
    the core's 128-wide tiles, the projection on its 96-wide ones) and at
    a small shape, at shift 0 and at shift 2 with the mask (output in
    shifted coordinates)."""
    ws = 8
    wt = _block_weights(c, 110)
    x = _rnd((b, hw, hw, c), 111).to(BF)
    bias = _rnd((nh, 64, 64), 112)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
            if shift else None)
    _check_chain(wa.fused_block_attention, wa.block_attention_chain_plain,
                 wa.block_attention_plain,
                 (x, *wt["att"], bias, mask, ws, nh, (c // nh) ** -0.5,
                  shift), "block_attention", {"core_rounded": False})


def test_block_attention_chain_by_kernel_name(card):
    """The kernels the profiler sees in a K5 call at C 384, 12 heads (head
    dim 32): the GEMM core with the bias epilogue at both tile widths (qkv
    N 1,152: 128; the projection N 384: 96) and the register attention
    core with FwdMap at shift 0, FwdShiftedMap at shift 4, and nothing
    else: no gemm_bias_kernel (the WMMA GEMM K5 ran before)."""
    c, nh, ws, hw = 384, 12, 8, 16
    wt = _block_weights(c, 113)
    x = _rnd((1, hw, hw, c), 114).to(BF)
    bias = _rnd((nh, 64, 64), 115)
    mask = torch.from_numpy(shift_attn_mask(hw, hw, ws, 4)).cuda()
    for shift, core in ((0, "FwdMap"), (4, "FwdShiftedMap")):
        parts = ("gemm_core_kernel<0, 1, 128, 3>", "gemm_core_kernel<0, 1, 96, 4>",
                 f"window_attn_fwd_kernel<32, 64, sodt::{core}>")
        names = _device_kernel_names(
            lambda: wa.fused_block_attention(x, *wt["att"], bias,
                                             mask if shift else None, ws, nh,
                                             0.25, shift), *parts,
            device_only=True)
        for part in parts:
            assert any(part in k for k in names), (part, names)
        assert all(("gemm_core_kernel<0, 1, " in k
                    or "window_attn_fwd_kernel" in k) for k in names), names


def test_block_attention_chain_strip_core(card):
    """K5's chain at windows of 256 tokens (ws 16), where its core is the
    strip body of csrc/window_attention.cuh, against the f32 plain version
    (TOL), at shift 0 and at shift 8 with the mask."""
    c, nh, ws, hw = 64, 2, 16, 32
    wt = _block_weights(c, 116)
    x = _rnd((2, hw, hw, c), 117).to(BF)
    bias = _rnd((nh, 256, 256), 118)
    for shift in (0, 8):
        mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
                if shift else None)
        args = (x, *wt["att"], bias, mask, ws, nh, (c // nh) ** -0.5, shift)
        out = wa.fused_block_attention(*args)
        ref = wa.block_attention_plain(*[a.float() if torch.is_tensor(a)
                                         and a.dtype == BF else a
                                         for a in args])
        torch.cuda.synchronize()
        assert _rel(out, ref) < TOL


def test_bf16_forward_runs_no_gemm_bias_kernel(card):
    """The whole bf16 forward at 512 px: no kernel named gemm_bias_kernel,
    and K5's two GEMM shapes on the core (qkv N 1,152 takes its 128-wide
    tiles, as K3's and K2's qkv at N 576 do)."""
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    m = build_model("configs/model.yaml", ch_in=4, dtype=BF)
    m = cache_rel_bias(init_weights(m, 0).cuda().eval())
    x = torch.rand((1, 512, 512, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))

    def forward():
        with torch.no_grad():
            m(x, x)

    names = _device_kernel_names(forward, "gemm_core_kernel<0, 1, 128, 3>",
                                 device_only=True)
    assert any("gemm_core_kernel<0, 1, 128, 3>" in n for n in names), names
    assert not any("gemm_bias" in n for n in names), names


def test_wrappers_raise_on_cuda_f32(card):
    x = _rnd((1, 16, 16, 32), 1)
    with pytest.raises(ValueError, match="bfloat16"):
        sb.fused_mlp_tail(x, x, _rnd((128, 32), 2), _rnd((128,), 3),
                          _rnd((32, 128), 4), _rnd((32,), 5))


MAIN = {"swin_block": 3, "block_attention_ln": 3, "conv_mlp_tail": 3,
        "block_attention": 4, "mlp_tail": 2, "conv_mlp_tail_noln": 2,
        "window_attention": 0, "global_attention": 1,
        "window_attention_bwd": 0, "global_attention_bwd": 0,
        "window_attention_tokens": 0, "window_attention_tokens_bwd": 0,
        # K13: the four cross-channel LNs, stage 2's four LN1, stage 3's
        # LN1, two PatchMergings; add+LN2 of stage 2's blocks and stage 3's
        "layernorm": 11, "add_layernorm": 5,
        # K12, int8 serving only
        "swin_block_q8": 0, "block_attention_ln_q8": 0, "conv_mlp_tail_q8": 0,
        "block_attention_q8": 0, "mlp_tail_q8": 0, "conv_mlp_tail_noln_q8": 0}
# 608 px: stage 2's 76x76 map is no window multiple, so its four blocks
# take the generic path (K1 core); stage 3's 38x38 map pads to 64x64, four
# 32x32 windows for K8
OFF_WINDOW = dict(MAIN, block_attention=0, mlp_tail=0, conv_mlp_tail_noln=0,
                  window_attention=4)


@pytest.mark.parametrize("img,counts", [(512, MAIN), (128, MAIN), (320, MAIN),
                                        (640, MAIN), (608, OFF_WINDOW)])
def test_flagship_forward_dispatch(card, img, counts):
    """Launches per forward and bf16-vs-f32 Detect maps at the config size
    and off it: at 128 and 320 px stage 3 (8x8, 20x20) pads up to one
    32x32 window for K8; at 640 px its 40x40 map pads to 64x64, four
    windows of 1024 tokens, which K8 also takes."""
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    raws = {}
    for dt in (BF, torch.float32):
        m = build_model("configs/model.yaml", ch_in=4, dtype=dt)
        m = cache_rel_bias(init_weights(m, 0).cuda().eval())
        x = torch.rand((1, img, img, 3), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
        kernels.reset_launches()
        with torch.no_grad():
            raws[dt] = m(x, x)["raw"][0].float()
        torch.cuda.synchronize()
        if dt == BF:
            assert kernels.launches() == counts
        else:
            assert sum(kernels.launches().values()) == 0   # f32: plain path
    a, b = raws[BF], raws[torch.float32]
    assert torch.isfinite(a).all()
    assert ((a - b).norm() / b.norm()).item() < TOL


# ------------------------------------------------------ K12: int8 serving
#
# Each int8 body against its plain int8 version on the SAME bf16 inputs
# (the rounding points are part of the function): both compute the same
# codes but for a value that an f32 LN or GELU rounded differently across a
# code boundary (one step of a strip's 127), so TOL holds with room. Held
# tightly against the plain version with the kernels' own attention core
# (`dispatch=True`): relative L2 Q8_REL_L2, which the un-quantized bf16
# kernel must miss, and every strip's abs-max slot (`strip_amax_log`)
# within Q8_AMAX_TOL (chip_smoke.py's limits, which say why).
Q8_REL_L2 = 3e-3
Q8_AMAX_TOL = 1e-2


def _rel_l2(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).norm() / ref.norm()).item()


def _amax_err(klog, plog):
    assert len(klog) == len(plog) > 0
    return max(((k.amax(-1) - p.amax(-1)).abs() / p.amax(-1)).max().item()
               for k, p in zip(klog, plog))


@pytest.mark.parametrize("b,hw,c,nh", [(1, 16, 32, 2), (2, 128, 192, 12),
                                       (2, 64, 384, 12), (1, 152, 192, 12)])
@pytest.mark.parametrize("shift", [0, 2])
def test_int8_kernels(card, b, hw, c, nh, shift):
    """K12's five bodies; 152 x 152 (the 608 px stage 1) has 19 windows
    per strip, more CTAs per strip scale than a cluster could hold."""
    from sodt_tpu_torch.kernels.quant import strip_amax_log
    ws = 8
    wt = _block_weights(c, 90)
    x = _rnd((b, hw, hw, c), 91).to(BF)
    a = _rnd((b, hw, hw, c), 92).to(BF)
    bias = _rnd((nh, 64, 64), 93)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
            if shift else None)
    scale = (c // nh) ** -0.5
    win = (bias, mask, ws, nh, scale, shift)
    # (name, kernel, plain int8 version, its arguments, has a core)
    cases = [
        ("block_attention_q8", wa.fused_block_attention,
         wa.block_attention_q8_plain, (x, *wt["att"], *win), True),
        ("block_attention_ln_q8", wa.fused_block_attention_ln,
         wa.block_attention_ln_q8_plain, (x, *wt["ln1"], *wt["att"], *win),
         True),
        ("conv_mlp_tail_q8", sb.fused_conv_mlp_tail,
         sb.conv_mlp_tail_q8_plain, (x, a, *wt["ln2"], *wt["conv"], shift),
         False),
        ("mlp_tail_q8", sb.fused_mlp_tail, sb.mlp_tail_q8_plain,
         (x, a, *wt["lin"]), False),
        ("conv_mlp_tail_noln_q8", sb.fused_conv_mlp_tail_noln,
         sb.conv_mlp_tail_noln_q8_plain, (x, a, *wt["conv"]), False)]
    if shift == 0:
        cases.append(("swin_block_q8", sb.fused_swin_block,
                      sb.swin_block_q8_plain,
                      (x, *wt["ln1"], *wt["att"], *wt["ln2"], *wt["lin"],
                       bias, None, ws, nh, scale, 0), True))
    # the bf16 megakernels K2-K4 hold c <= 256; their int8 bodies do not
    mega = sb.megakernel_supported(c, nh, ws)
    for name, kern, plain, args, core in cases:
        kernels.reset_launches()
        with strip_amax_log() as klog:
            out = kern(*args, int8=True)
        assert kernels.launches()[name] == 1, name
        ref = plain(*args)
        with strip_amax_log() as plog:
            same = plain(*args, **({"dispatch": True} if core else {}))
        torch.cuda.synchronize()
        assert out.dtype == BF and torch.isfinite(out).all(), name
        assert _rel(out, ref) < TOL, name
        assert _rel_l2(out, same) <= Q8_REL_L2, name
        assert _amax_err(klog, plog) <= Q8_AMAX_TOL, name
        if mega or name in ("block_attention_q8", "mlp_tail_q8",
                            "conv_mlp_tail_noln_q8"):
            bf = kern(*args)                     # un-quantized: the control
            assert _rel_l2(bf, same) > Q8_REL_L2, name


def test_int8_scales_divide_truly_on_the_card(card):
    """The quantizers' scales max(amax, 1e-8) / 127 on the card are the
    CPU's, bit for bit: a true division, as the kernels' (a python divisor
    would make torch multiply by the f32 reciprocal, ~5% of quotients one
    ulp off)."""
    from sodt_tpu_torch.kernels import quant
    w = torch.randn((4096, 64), generator=torch.Generator().manual_seed(3))
    for fn in (quant.q8_weight, lambda t: (quant.strip_scale(t[:, None]),)):
        for a, b in zip(fn(w.cuda()), fn(w)):
            assert torch.equal(a.cpu(), b)


def test_int8_conv_tail_halo_scale_quirk(card):
    """K4 with shift > 0 on the card: the last strip's fc1 scale covers
    x's row (nr-1)*ws plus a's UNSHIFTED row 0 (`conv_tail_halo_rows`), as
    the reference's does. a's row 0 made large: the kernel's slot for that
    strip is the plain version's, above the strip's own abs-max."""
    from sodt_tpu_torch.kernels.quant import strip_amax_log
    b, h, w, c, shift = 1, 16, 16, 32, 2
    wt = _block_weights(c, 94)
    x = (_rnd((b, h, w, c), 95) * 0.1).to(BF)
    a = (_rnd((b, h, w, c), 96) * 0.1)
    a[:, h - shift, :, 0] = 50.0                 # a's unshifted row 0
    a = a.to(BF)
    args = (x, a, *wt["ln2"], *wt["conv"], shift)
    with strip_amax_log() as klog:
        out = sb.fused_conv_mlp_tail(*args, int8=True)
    with strip_amax_log() as plog:
        ref = sb.conv_mlp_tail_q8_plain(*args)
    torch.cuda.synchronize()
    assert _amax_err(klog, plog) <= Q8_AMAX_TOL
    assert _rel_l2(out, ref) <= Q8_REL_L2
    strip_only = plog[0][1, :8 * w].max().item()
    assert klog[0][1].max().item() > 1.05 * strip_only


def test_int8_wrappers_raise_outside_domain(card):
    """A CUDA tensor outside an int8 kernel's domain raises; nothing falls
    back to the plain version or to the bf16 kernel."""
    c = 48
    x = _rnd((1, 16, 16, c), 1).to(BF)
    lin = [_rnd((4 * c, c), 2).to(BF), _rnd((4 * c,), 3).to(BF),
           _rnd((c, 4 * c), 4).to(BF), _rnd((c,), 5).to(BF)]
    kernels.reset_launches()
    with pytest.raises(ValueError, match="C=48"):
        sb.fused_mlp_tail(x, x, *lin, int8=True)
    with pytest.raises(ValueError, match="bfloat16"):
        sb.fused_mlp_tail(x.float(), x.float(), *lin, int8=True)
    wt = _block_weights(32, 6)
    x = _rnd((1, 16, 16, 32), 7).to(BF)
    bias = _rnd((2, 64, 64), 8)
    with pytest.raises(ValueError, match="unshifted"):
        sb.fused_swin_block(x, *wt["ln1"], *wt["att"], *wt["ln2"], *wt["lin"],
                            bias, None, 8, 2, 0.25, 2, int8=True)
    x = _rnd((1, 20, 20, 32), 9).to(BF)
    with pytest.raises(ValueError, match="400 tokens"):
        wa.fused_block_attention(x, *wt["att"], _rnd((2, 400, 400), 10), None,
                                 20, 2, 0.25, 0, int8=True)
    assert sum(kernels.launches().values()) == 0


def _codes_of(vals, slots, rows_per_strip=None, strip=None):
    """int8 codes of f32 rows under their strips' scales, in torch on the
    card (a true division, as the kernels')."""
    from sodt_tpu_torch.kernels.quant import _q8, _scale
    if strip is None:
        strip = torch.arange(vals.shape[0], device=vals.device) // rows_per_strip
    return _q8(vals, _scale(slots)[strip][:, None]).to(torch.int8)


@pytest.mark.parametrize("src,dtype", [
    (s, d) for s in ("rows", "ln", "ln_bf16") for d in (BF, torch.float32)]
    + [("shifted", BF), ("shifted_ln_bf16", BF)])
def test_int8_rowpass_codes_are_its_values_codes(card, src, dtype):
    """A quantization point's two runs (csrc/int8_chains.cu): the pass
    that writes the codes computes the values the folding pass saw. Its
    codes equal those of the f32 values a third run stores, under the slots
    the fold finished (bit for bit), the fold's slots equal the storing
    run's, and repeats are bit-equal. 3 strips of 1,000 rows, C 192; the
    sources: rows as they are, their LN, the LN rounded to bf16 (K3's
    twin), and a bf16 (3, 10, 100, C) map read at its (-2, -2)-rolled
    position (K3's and K5's twins, bf16 only), as it is or its LN rounded
    to bf16. The rounded values are bf16 values; the rolled map's are the
    plain version's on the rolled rows."""
    rows, c, r = 3000, 192, 1000
    x = (_rnd((rows, c), 120) * 3).to(dtype)
    ln = src != "rows" and src != "shifted"
    g = (1 + _rnd((c,), 121, 0.1)).float() if ln else None
    b = _rnd((c,), 122, 0.1).float() if ln else None
    kw = dict(round_bf16=src.endswith("bf16"))
    if src.startswith("shifted"):
        x = x.reshape(3, 10, 100, c)
        kw["shift"] = 2
    _, slots = sb.q8_rowpass(x, g, b, sb.S8_FOLD, r, **kw)
    vals, slots_f = sb.q8_rowpass(x, g, b, sb.S8_F32, r, **kw)
    codes, _ = sb.q8_rowpass(x, g, b, sb.S8_CODES, r, slots, **kw)
    again, _ = sb.q8_rowpass(x, g, b, sb.S8_CODES, r, slots, **kw)
    torch.cuda.synchronize()
    assert torch.equal(slots, slots_f)
    assert torch.equal(codes, _codes_of(vals, slots, r))
    assert torch.equal(codes, again)
    if kw["round_bf16"]:
        assert torch.equal(vals, vals.to(BF).float())
    ref, ref_slots = sb.q8_rowpass_plain(x.cpu(), None if g is None else g.cpu(),
                                         None if b is None else b.cpu(),
                                         sb.S8_F32, r, **kw)
    # a rounded value may land one bf16 step away from the CPU's
    assert _rel(vals.cpu(), ref) < (4e-3 if kw["round_bf16"] else 1e-5)
    assert _rel(slots.cpu(), ref_slots) < (4e-3 if kw["round_bf16"] else 1e-5)


@pytest.mark.parametrize("m,n,k", [(3000, 768, 192), (1000, 96, 64),
                                   (640, 32, 1536)])
def test_int8_gemm_s8_core(card, m, n, k):
    """The s8 wgmma core on ragged shapes (M not a multiple of 64; N 768 in
    four 192-wide tiles, 96 in one 128-wide tile, 32 in one 64-wide; K 64
    ends inside a 128-deep step): the bf16(v + b) epilogue bit-equal to the
    plain version (an exact int32 sum, the same f32 dequantization), and the
    producer's two runs as in the row pass: codes of the stored values under
    the folded slots, bit-equal repeats, slots equal."""
    gen = torch.Generator().manual_seed(123)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    sw = torch.rand(n, generator=gen) * 1e-3 + 1e-4
    b = (torch.randn(n, generator=gen) * 0.1).to(BF)
    r = 500
    amax_in = torch.rand((m + r - 1) // r, generator=gen) * 4 + 0.5
    cpu = (a, wq, sw, b, amax_in)
    dev = [t.cuda() for t in cpu]
    out, _ = sb.gemm_s8(*dev, sb.S8_BF16, strip_rows=r)
    ref, _ = sb.gemm_s8_plain(*cpu, sb.S8_BF16, strip_rows=r)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)
    if m % r:
        return                                  # the producer takes whole strips
    _, slots = sb.gemm_s8(*dev, sb.S8_FOLD, strip_rows=r)
    vals, slots_f = sb.gemm_s8(*dev, sb.S8_F32, strip_rows=r)
    codes, _ = sb.gemm_s8(*dev, sb.S8_CODES, slots, strip_rows=r)
    again, _ = sb.gemm_s8(*dev, sb.S8_CODES, slots, strip_rows=r)
    torch.cuda.synchronize()
    assert torch.equal(slots, slots_f)
    assert torch.equal(codes, _codes_of(vals, slots, r))
    assert torch.equal(codes, again)
    pv, _ = sb.gemm_s8_plain(*cpu, sb.S8_F32, strip_rows=r)
    assert _rel(vals.cpu(), pv) < 1e-5


@pytest.mark.parametrize("b,h,w,c", [(2, 24, 20, 64), (1, 64, 64, 384)])
def test_int8_conv_gather_core(card, b, h, w, c):
    """The conv launch (GS_CONV2X2 over f1's codes and its halo rows, the
    zero taps right of the last column): its values against the plain
    gather (`conv_gather_codes`) within GELU's last-ulp differences, and
    its two runs as in the row pass. 20 columns: a 64-row tile spans
    several 20-row halo strips."""
    gen = torch.Generator().manual_seed(7)
    ws = 8
    s = b * (h // ws)
    rows = b * h * w + s * w
    f1 = torch.randint(-127, 128, (rows, c), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (c, 4 * c), generator=gen, dtype=torch.int8)
    sw = torch.rand(c, generator=gen) * 1e-4 + 1e-5
    bias = (torch.randn(c, generator=gen) * 0.1).to(BF)
    amax_in = torch.rand(s, generator=gen) * 4 + 0.5
    cpu = (f1, wq, sw, bias, amax_in)
    dev = [t.cuda() for t in cpu]
    geo = (b, h, w, ws)
    _, slots = sb.gemm_s8(*dev, sb.S8_FOLD, conv=geo)
    vals, slots_f = sb.gemm_s8(*dev, sb.S8_F32, conv=geo)
    codes, _ = sb.gemm_s8(*dev, sb.S8_CODES, slots, conv=geo)
    again, _ = sb.gemm_s8(*dev, sb.S8_CODES, slots, conv=geo)
    torch.cuda.synchronize()
    main = torch.arange(b * h * w, device="cuda") // (ws * w)
    assert torch.equal(slots, slots_f)
    assert torch.equal(codes, _codes_of(vals, slots, strip=main))
    assert torch.equal(codes, again)
    pv, pslots = sb.gemm_s8_plain(*cpu, sb.S8_F32, conv=geo)
    assert _rel(vals.cpu(), pv) < 1e-5
    assert _rel(slots.cpu(), pslots) < 1e-5


def test_int8_chains_run_on_the_s8_core(card):
    """Every int8 body launches the s8 wgmma core and the row passes (the
    profiler's kernel names): K2's twin and K4's / K7's, and K3's (shift
    2, masked), K5's at shift 0 and 2 and K6's twin, which run nothing
    else but the attention core's register body and the memset of the
    slots (their weights quantized beforehand, as the model's cache hands
    them over). No WMMA q8_gemm_kernel anywhere."""
    from sodt_tpu_torch.kernels.quant import q8_weights
    c, nh, ws = 192, 12, 8
    wt = _block_weights(c, 97)
    x = _rnd((1, 32, 32, c), 98).to(BF)
    a = _rnd((1, 32, 32, c), 99).to(BF)
    bias = _rnd((nh, 64, 64), 100)
    mask = torch.from_numpy(shift_attn_mask(32, 32, ws, 2)).cuda()
    sc = (c // nh) ** -0.5
    q_att = q8_weights(None, wqkv=wt["att"][0], wp=wt["att"][2])
    q_lin = q8_weights(None, w1=wt["lin"][0], w2=wt["lin"][2])
    calls = [
        lambda: sb.fused_swin_block(x, *wt["ln1"], *wt["att"], *wt["ln2"],
                                    *wt["lin"], bias, None, ws, nh, sc, 0,
                                    int8=True),
        lambda: sb.fused_conv_mlp_tail(x, a, *wt["ln2"], *wt["conv"], 2,
                                       int8=True),
        lambda: sb.fused_conv_mlp_tail_noln(x, a, *wt["conv"], int8=True)]
    only = [
        lambda: wa.fused_block_attention_ln(x, *wt["ln1"], *wt["att"], bias,
                                            mask, ws, nh, sc, 2, int8=True,
                                            q8=q_att),
        lambda: wa.fused_block_attention(x, *wt["att"], bias, None, ws, nh,
                                         sc, 0, int8=True, q8=q_att),
        lambda: wa.fused_block_attention(x, *wt["att"], bias, mask, ws, nh,
                                         sc, 2, int8=True, q8=q_att),
        lambda: sb.fused_mlp_tail(x, a, *wt["lin"], int8=True, q8=q_lin)]
    for k, fn in enumerate(calls + only):
        names = _device_kernel_names(fn, "gemm_s8_kernel", "q8_rowpass_kernel",
                                     device_only=True)
        assert any("gemm_s8_kernel" in n for n in names), names
        assert any("q8_rowpass_kernel" in n for n in names), names
        assert not any("q8_gemm_kernel" in n for n in names), names
        if k >= len(calls):
            allowed = ("gemm_s8_kernel", "q8_rowpass_kernel",
                       "window_attn_fwd_kernel", "Memset")
            assert all(any(w in n for w in allowed) for n in names), names


def test_int8_forward_runs_no_wmma_gemm(card):
    """The whole int8 forward at 512 px (every K12 body, the bf16 kernels
    outside JAX's int8 gate): no kernel named q8_gemm_kernel, and the s8
    core runs."""
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    m = build_model("configs/model.yaml", ch_in=4, dtype=BF)
    m = cache_rel_bias(init_weights(m, 0).cuda().eval())
    x = torch.rand((1, 512, 512, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))

    def forward():
        with torch.no_grad(), kernels.int8_serving():
            m(x, x)

    names = _device_kernel_names(forward, "gemm_s8_kernel")
    assert any("gemm_s8_kernel" in n for n in names), names
    assert not any("q8_gemm_kernel" in n for n in names), names


# int8 serving: each bf16 K2-K7 launch becomes its int8 twin's; at 608 px
# stage 2 (76 x 76) is off the window grid, un-quantized in JAX too
INT8 = dict(MAIN, swin_block=0, block_attention_ln=0, conv_mlp_tail=0,
            block_attention=0, mlp_tail=0, conv_mlp_tail_noln=0,
            swin_block_q8=3, block_attention_ln_q8=3, conv_mlp_tail_q8=3,
            block_attention_q8=4, mlp_tail_q8=2, conv_mlp_tail_noln_q8=2)
INT8_OFF = dict(INT8, block_attention_q8=0, mlp_tail_q8=0,
                conv_mlp_tail_noln_q8=0, window_attention=4)


@pytest.mark.parametrize("img,counts", [(512, INT8), (128, INT8),
                                        (608, INT8_OFF)])
def test_flagship_int8_forward_dispatch(card, img, counts):
    """Launches per forward inside int8_serving() (JAX's gate), and the
    int8 Detect maps against the bf16 kernels' on the same weights: finite,
    moved by the quantization, within 5e-2."""
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    m = build_model("configs/model.yaml", ch_in=4, dtype=BF)
    m = cache_rel_bias(init_weights(m, 0).cuda().eval())
    x = torch.rand((1, img, img, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    kernels.reset_launches()
    with torch.no_grad(), kernels.int8_serving():
        q8 = m(x, x)["raw"][0].float()
    torch.cuda.synchronize()
    assert kernels.launches() == counts
    with torch.no_grad():
        bf = m(x, x)["raw"][0].float()
    assert torch.isfinite(q8).all()
    assert 0 < ((q8 - bf).norm() / bf.norm()).item() < 5e-2


# ------------------------------------------------- training kernels (K9-K13)
#
# Tolerances. dq/dk/dv are bf16 outputs of products whose P and dS operands
# the kernels round to bf16: TOL (2e-2 of max |ref|) as for the forward
# kernels. dbias is an f32 sum of dS over up to thousands of windows, each
# term computed from exact bf16 inputs in f32: only the summation order and
# expf differ from the f32 plain version, DBIAS_TOL = 1e-3 of max |ref|.
DBIAS_TOL = 1e-3


@pytest.mark.parametrize("b,hw,c,nh,ws", [(1, 16, 32, 2, 8), (2, 128, 192, 12, 8),
                                          (2, 64, 384, 12, 8), (4, 128, 192, 12, 8),
                                          (1, 32, 256, 4, 16), (3, 8, 64, 2, 4),
                                          (2, 32, 192, 4, 8), (1, 24, 96, 2, 8),
                                          (3, 64, 384, 12, 8), (2, 32, 64, 4, 4),
                                          (1, 12, 32, 2, 4), (1, 30, 64, 2, 5),
                                          (2, 12, 32, 2, 6), (1, 9, 32, 2, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_bwd_kernel(card, b, hw, c, nh, ws, masked):
    """K9 at head dims 16, 32, 48 and 64; windows of 64 tokens (ws 8) and
    16 (ws 4: four windows to a stage, one stage part-filled at 9
    windows) through the register body, padded windows of 9, 25 (a mask
    row not a multiple of 4 floats) and 36 tokens through it too, and 256
    (ws 16) through the strip body; more windows than dbias groups (4 x
    256 windows, and 192, no multiple of the 44 groups), fewer than the
    groups rule asks for (4, 9)."""
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 40).to(BF)
    gy = _rnd((b, hw, hw, c), 41).to(BF)
    bias = _rnd((nh, n, n), 42)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, ws // 4)).cuda()
            if masked else None)
    scale = (c // nh) ** -0.5
    dqkv, dbias = wa.window_attention_bwd(qkv, bias, mask, ws, nh, scale, gy)
    rq, rb = wa.attention_nhwc_bwd_plain(qkv.float(), bias, mask, ws, nh,
                                         scale, gy.float())
    torch.cuda.synchronize()
    assert dqkv.dtype == BF and dbias.dtype == torch.float32
    for k in range(3):      # dq, dk, dv separately: their scales differ
        assert _rel(dqkv[..., k * c:(k + 1) * c], rq[..., k * c:(k + 1) * c]) < TOL
    assert _rel(dbias, rb) < DBIAS_TOL
    # deterministic: no atomics
    d2, b2 = wa.window_attention_bwd(qkv, bias, mask, ws, nh, scale, gy)
    assert torch.equal(d2, dqkv) and torch.equal(b2, dbias)


# K9's register body against its rounded mirror (P and dS rounded to bf16
# where the kernel rounds them, dbias in the kernel's order), in f32 from
# the same bf16 inputs: what separates them is dq / dk / dv's one bf16
# rounding at the store (2^-9 of an element: <= 2e-3 of max |ref|) and a
# rare P or dS that rounds the other way, so 5e-3, a quarter of TOL; dbias
# differs by expf and the f32 summation order alone: 1e-5, a hundredth of
# DBIAS_TOL.
MIRROR_TOL, MIRROR_DBIAS_TOL = 5e-3, 1e-5


@pytest.mark.parametrize("b,hw,c,nh,ws", [(4, 128, 192, 12, 8), (4, 64, 384, 12, 8),
                                          (2, 32, 256, 4, 8), (2, 32, 64, 4, 4)])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_bwd_kernel_vs_rounded_mirror(card, b, hw, c, nh, ws, masked):
    """K9 at the flagship's two stages (batch 4), head dim 64 and ws 4
    against `attention_nhwc_bwd_mirror`, tighter than TOL."""
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 46).to(BF)
    gy = _rnd((b, hw, hw, c), 47).to(BF)
    bias = _rnd((nh, n, n), 48)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, ws // 4)).cuda()
            if masked else None)
    scale = (c // nh) ** -0.5
    assert wa.bwd_body(n) == "regs"
    dqkv, dbias = wa.window_attention_bwd(qkv, bias, mask, ws, nh, scale, gy)
    mq, mb = wa.attention_nhwc_bwd_mirror(qkv.float(), bias, mask, ws, nh,
                                          scale, gy.float())
    torch.cuda.synchronize()
    for k in range(3):
        assert _rel(dqkv[..., k * c:(k + 1) * c], mq[..., k * c:(k + 1) * c]) < MIRROR_TOL
    assert _rel(dbias, mb) < MIRROR_DBIAS_TOL


# The windowed-attention forward's register body (csrc/window_attention_fwd.cuh,
# N <= 64: K1, K5's core, K11's forward) against its plain version (TOL) and
# its rounded mirror (`attention_fwd_mirror`: q scaled and rounded in bf16,
# the softmax in log2 units, P and the output rounded to bf16), in f32 from
# the same bf16 inputs: what separates kernel and mirror is the f32
# summation order and ex2.approx, enough to round an output element or a P
# the other way (one bf16 step, <= 3.9e-3 of max |ref|): MIRROR_TOL, a
# quarter of TOL. Head dims 16, 32, 48, 64; ws 3 to 8 (padded keys at 9,
# 25, 36, 49 tokens; four windows to a stage at ws <= 4, one part-filled at
# 9 windows); window counts that are no multiple of the groups (125 windows
# in 88 groups at 6 heads; 75 and 1,024 in 44); the flagship's shapes at
# batch 4 and 608 px.
FWD_SHAPES = [(4, 128, 192, 12, 8), (4, 64, 384, 12, 8), (2, 80, 384, 12, 8),
              (2, 32, 192, 4, 8), (2, 32, 256, 4, 8), (5, 40, 96, 6, 8),
              (3, 8, 64, 2, 4), (1, 12, 32, 2, 4), (1, 9, 32, 2, 3),
              (1, 30, 64, 2, 5), (2, 12, 32, 2, 6), (3, 35, 192, 12, 7)]


@pytest.mark.parametrize("b,hw,c,nh,ws", FWD_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "masked", "shifted"])
def test_window_attention_fwd_regs_kernel(card, b, hw, c, nh, ws, mode):
    """K1 (unmasked, and masked at shift 0 as the replays call it) and K5's
    core (`_window_core` with the shift: read at ((r + s) mod H, (c + s)
    mod W), the wrapping windows included, written at (r, c)) through the
    register body, against the plain version and the rounded mirror, and
    bit-equal over two runs."""
    n = ws * ws
    assert wa.fwd_body(n) == "regs"
    qkv = _rnd((b, hw, hw, 3 * c), 60).to(BF)
    bias = _rnd((nh, n, n), 61)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, ws // 2)).cuda()
            if mode != "plain" else None)
    shift = ws // 2 if mode == "shifted" else 0
    scale = (c // nh) ** -0.5
    kernels.reset_launches()
    if shift:
        run = lambda: wa._window_core(qkv, bias, mask, ws, nh, scale, shift,
                                      "test")
    else:
        run = lambda: wa.fused_window_attention_nhwc(qkv, bias, mask, ws, nh,
                                                     scale)
    out = run()
    rolled = torch.roll(qkv.float(), (-shift, -shift), (1, 2))
    ref = wa.reference_attention_nhwc(rolled, bias, mask, ws, nh, scale)
    mir = wa.attention_fwd_mirror(qkv.float(), bias, mask, ws, nh, scale,
                                  shift=shift)
    again = run()
    torch.cuda.synchronize()
    assert out.dtype == BF and out.shape == ref.shape
    assert kernels.launches()["window_attention"] == (0 if shift else 2)
    assert _rel(out, ref) < TOL
    assert _rel(out, mir) < MIRROR_TOL
    assert torch.equal(out, again)


K11_FWD_SHAPES = [(1024, 64, 96, 3, 256), (256, 64, 192, 6, 64),
                  (64, 64, 384, 12, 16), (16, 64, 768, 24, 4),
                  (8, 4, 96, 3, 2), (6, 16, 96, 3, 2), (300, 64, 64, 4, 2),
                  (10, 36, 96, 2, 5)]


@pytest.mark.parametrize("w,n,c,nh,nw", K11_FWD_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_tokens_fwd_vs_rounded_mirror(card, w, n, c, nh, nw,
                                                       masked):
    """K11's forward through the register body (the SwinV2 family's four
    stages at batch 4, scale 1.0; windows of 4, 16 and 36 tokens) against
    `attention_qkv_fwd_mirror`, window w taking mask[w mod nw]; bit-equal
    over two runs."""
    qkv, _, bias, mask, nw = _k11_inputs(w, n, c, nh, nw, masked)
    assert wa.fwd_body(n) == "regs"
    out = wa.fused_window_attention(qkv, bias, mask, nw, nh, 1.0)
    mir = wa.attention_qkv_fwd_mirror(qkv.float(), bias, mask, nw, nh, 1.0)
    again = wa.fused_window_attention(qkv, bias, mask, nw, nh, 1.0)
    torch.cuda.synchronize()
    assert _rel(out, mir) < MIRROR_TOL
    assert torch.equal(out, again)


def _device_kernel_names(fn, *want, tries=5, device_only=False):
    """The names torch.profiler records over a call of `fn` (`device_only`:
    of what ran on the card, no runtime calls). CUPTI now and
    then drops a session's kernel records, all of them or some (one run on
    the H100 kept dbias_reduce_kernel and lost the K9 body launched before
    it): a session whose names miss one of the `want` substrings is run
    again, up to `tries` sessions, and the names of all of them are
    returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names = set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names |= {e.key for e in prof.key_averages()
                  if not device_only or e.device_type == DeviceType.CUDA}
        if all(any(w in k for k in names) for w in want):
            break
    return names


def test_forward_bodies_by_kernel_name(card):
    """The kernels the profiler sees: the register body, with the
    addressing of each caller, at N <= 64 (K1, K5's shifted core, K11's
    forward); the strip body at ws 16."""
    c, nh = 64, 4
    qkv = _rnd((1, 32, 32, 3 * c), 62).to(BF)
    mask = torch.from_numpy(shift_attn_mask(32, 32, 8, 4)).cuda()
    for name, fn in (
            ("window_attn_fwd_kernel<16, 64, sodt::FwdMap>",
             lambda: wa.fused_window_attention_nhwc(
                 qkv, _rnd((nh, 64, 64), 63), None, 8, nh, 0.25)),
            ("window_attn_fwd_kernel<16, 64, sodt::FwdShiftedMap>",
             lambda: wa._window_core(qkv, _rnd((nh, 64, 64), 63), mask, 8,
                                     nh, 0.25, 4, "test")),
            ("window_attn_fwd_kernel<16, 16, sodt::FwdTokens>",
             lambda: wa.fused_window_attention(
                 qkv.reshape(64, 16, 3 * c), _rnd((nh, 16, 16), 64), None,
                 1, nh, 1.0)),
            ("window_attn_kernel<sodt::MapWindows>",
             lambda: wa.fused_window_attention_nhwc(
                 qkv, _rnd((nh, 256, 256), 65), None, 16, nh, 0.25))):
        names = _device_kernel_names(fn, name)
        assert any(name in k for k in names), (name, names)
    assert wa.fwd_body(256) == "strips"


@pytest.mark.parametrize("b,hw,c,nh,ws", [(1, 8, 64, 4, 8), (2, 32, 768, 12, 32),
                                          (4, 32, 768, 12, 32),
                                          (1, 64, 768, 12, 32),
                                          (2, 32, 384, 12, 32),
                                          (1, 32, 768, 12, 32),
                                          (16, 32, 768, 12, 32),
                                          (4, 64, 384, 12, 32),
                                          (2, 32, 256, 2, 32)])
@pytest.mark.parametrize("masked", [False, True])
def test_global_attention_bwd_kernel(card, b, hw, c, nh, ws, masked):
    """K10 (computing its own row statistics) at one 64-token window, one
    1024-token window (batch 1, 2, 4 and 16: dbias summed over 16
    windows), head dims 16, 32, 64 and 128 (whose dbias slab does not fit
    in shared memory beside the ring: added in device memory), and four
    1024-token windows with and without a shift mask; bit-equal on a
    repeat."""
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 43).to(BF)
    gy = _rnd((b, hw, hw, c), 44).to(BF)
    bias = _rnd((nh, n, n), 45)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, 2)).cuda()
            if masked and hw > ws else None)
    scale = (c // nh) ** -0.5
    dqkv, dbias = wa.global_attention_bwd(qkv, bias, nh, scale, gy, ws, mask)
    rq, rb = wa.global_attention_bwd_plain(qkv.float(), bias, nh, scale,
                                           gy.float(), ws, mask)
    torch.cuda.synchronize()
    for k in range(3):
        assert _rel(dqkv[..., k * c:(k + 1) * c], rq[..., k * c:(k + 1) * c]) < TOL
    assert _rel(dbias, rb) < DBIAS_TOL
    d2, b2 = wa.global_attention_bwd(qkv, bias, nh, scale, gy, ws, mask)
    assert torch.equal(d2, dqkv) and torch.equal(b2, dbias)


@pytest.mark.parametrize("b,hw,c,nh,ws,masked", [(1, 32, 768, 12, 32, False),
                                                 (4, 32, 768, 12, 32, False),
                                                 (1, 8, 64, 4, 8, False),
                                                 (4, 64, 768, 12, 32, True)])
def test_global_attention_bwd_with_k8_stats(card, b, hw, c, nh, ws, masked):
    """K10 on K8's log-sum-exp and output (head dims 64 and 16, scales that
    are powers of two): within the same tolerances of the plain version as
    K10 on its own statistics, and of K10 on its own statistics; bit-equal
    on a repeat. At a scale that is no power of two K10 refuses them."""
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 49).to(BF)
    gy = _rnd((b, hw, hw, c), 50).to(BF)
    bias = _rnd((nh, n, n), 51)
    mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, 2)).cuda()
            if masked else None)
    scale = (c // nh) ** -0.5
    assert wa.lse_reusable(scale)
    _, stats = wa._launch_global(qkv, bias, mask, nh, scale, ws, True)
    dqkv, dbias = wa.global_attention_bwd(qkv, bias, nh, scale, gy, ws, mask,
                                          stats=stats)
    oq, ob = wa.global_attention_bwd(qkv, bias, nh, scale, gy, ws, mask)
    rq, rb = wa.global_attention_bwd_plain(qkv.float(), bias, nh, scale,
                                           gy.float(), ws, mask)
    torch.cuda.synchronize()
    for k in range(3):
        sl = slice(k * c, (k + 1) * c)
        assert _rel(dqkv[..., sl], rq[..., sl]) < TOL
        assert _rel(dqkv[..., sl], oq[..., sl].float()) < TOL
    assert _rel(dbias, rb) < DBIAS_TOL and _rel(dbias, ob) < DBIAS_TOL
    d2, b2 = wa.global_attention_bwd(qkv, bias, nh, scale, gy, ws, mask,
                                     stats=stats)
    assert torch.equal(d2, dqkv) and torch.equal(b2, dbias)
    with pytest.raises(ValueError):
        wa.global_attention_bwd(qkv, bias, nh, 0.17, gy, ws, mask, stats=stats)


@pytest.mark.parametrize("kind", ["window", "global", "global_hd32"])
def test_attention_functions_grad(card, kind):
    """torch.autograd.grad through K1 -> K9 and K8 -> K10 (with a
    non-contiguous cotangent) against autograd of the f32 plain version;
    K10 on K8's statistics at head dim 64, on its own at head dim 32."""
    if kind == "window":
        b, hw, c, nh, ws = 2, 64, 384, 12, 8
    elif kind == "global":
        b, hw, c, nh, ws = 2, 32, 768, 12, 32
    else:
        b, hw, c, nh, ws = 2, 32, 384, 12, 32
    n = ws * ws
    qkv = _rnd((b, hw, hw, 3 * c), 46).to(BF).requires_grad_()
    bias = _rnd((nh, n, n), 47).requires_grad_()
    gy = _rnd((b, hw, c, hw), 48).to(BF).transpose(2, 3)   # a view
    scale = (c // nh) ** -0.5
    kernels.reset_launches()
    if kind == "window":
        out = wa.fused_window_attention_nhwc(qkv, bias, None, ws, nh, scale)
    else:
        out = wa.fused_global_attention(qkv, bias, nh, scale)
    dq, db = torch.autograd.grad(out, [qkv, bias], gy)
    q32 = qkv.detach().float().requires_grad_()
    b32 = bias.detach().clone().requires_grad_()
    ref = wa.reference_attention_nhwc(q32, b32, None, ws, nh, scale)
    rq, rb = torch.autograd.grad(ref, [q32, b32], gy.float())
    torch.cuda.synchronize()
    counts = kernels.launches()
    fwd, bwd = (("window_attention", "window_attention_bwd") if kind == "window"
                else ("global_attention", "global_attention_bwd"))
    assert counts[fwd] == 1 and counts[bwd] == 1
    # the plain forward scales q in the working dtype first, the backward
    # kernels scale the f32 scores (as the Pallas pair does): same TOL
    assert _rel(dq, rq) < TOL and _rel(db, rb) < 5e-3


@pytest.mark.parametrize("r,c", [(64, 48), (2 * 64 * 64, 384), (1000, 192),
                                 (2 * 32 * 32, 768), (9, 1024),
                                 (4 * 4096 + 7, 24), (1001, 48), (333, 96),
                                 (77, 40), (5, 192)])
def test_layernorm_kernels(card, r, c):
    """K13 forward (LN and add+LN) and its backward against the plain
    versions; rows that do not fill the last CTA, and (4 * 4096 + 7 at C
    24: 32 rows a warp; 1001 at 48: 16; 333 at 96: 8; 1000 and 5 at 192:
    4) rows that leave the last warp's row groups partly past R."""
    from sodt_tpu_torch.kernels import layernorm as kln
    x = _rnd((r, c), 50).to(BF).requires_grad_()
    y2 = _rnd((r, c), 51).to(BF).requires_grad_()
    w = (1 + _rnd((c,), 52, 0.1)).requires_grad_()
    bb = _rnd((c,), 53, 0.1).requires_grad_()
    g = _rnd((r, c), 54).to(BF)
    kernels.reset_launches()
    out = kln.layernorm(x, w, bb)
    ref = kln.layernorm_plain(x.detach().float(), w.detach(), bb.detach())
    assert _rel(out, ref) < TOL
    s, ln = kln.add_layernorm(x, y2, w, bb)
    rs, rln = kln.add_layernorm_plain(x.detach(), y2.detach(), w.detach(),
                                      bb.detach())
    assert torch.equal(s, rs)        # the bf16 add is exact to the last bit
    assert _rel(ln, rln) < TOL
    assert kernels.launches()["layernorm"] == 1
    assert kernels.launches()["add_layernorm"] == 1
    grads = torch.autograd.grad([s, ln], [x, y2, w, bb], [g, g])
    xs = [t.detach().float().requires_grad_() for t in (x, y2, w, bb)]
    rs, rln = kln.add_layernorm_plain(*xs)
    refs = torch.autograd.grad([rs, rln], xs, [g.float(), g.float()])
    torch.cuda.synchronize()
    for a, bref in zip(grads, refs):
        assert _rel(a, bref) < TOL
    with pytest.raises(ValueError, match="C=20"):
        kln.layernorm(_rnd((4, 20), 55).to(BF), torch.ones(20).cuda(),
                      torch.zeros(20).cuda())
    # f32 on the card takes the plain version (JAX's bf16 gate)
    kernels.reset_launches()
    kln.layernorm(x.detach().float(), w.detach(), bb.detach())
    assert kernels.launches()["layernorm"] == 0


@pytest.mark.parametrize("c", [24, 48, 96, 192, 384, 768, 40])
def test_layernorm_bodies_by_kernel_name(card, c):
    """The instantiation of K13's row body the profiler sees for LN (front
    0) and add + LN (front 2) is the one `ln_body` names: layernorm_kernel
    <front, V, L>, L lanes of V vectors a row. A session profiles 20 calls:
    one call of a few microseconds alone left sessions with no record."""
    from sodt_tpu_torch.kernels import layernorm as kln
    lanes, vecs = kln.ln_body(c)
    x = _rnd((4099, c), 56).to(BF)
    w, bb = 1 + _rnd((c,), 57, 0.1), _rnd((c,), 58, 0.1)
    for front, fn in ((0, lambda: kln.layernorm(x, w, bb)),
                      (2, lambda: kln.add_layernorm(x, x, w, bb))):
        want = f"layernorm_kernel<{front}, {vecs}, {lanes}>"
        names = _device_kernel_names(lambda: [fn() for _ in range(20)], want,
                                     device_only=True)
        assert any(want in k for k in names), (want, names)
        assert all("layernorm_kernel" in k for k in names), names


def test_fused_wrappers_replay_grad(card):
    """Each of K2-K7 as an autograd function on the card: gradients of the
    replayed composition against autograd of the f32 plain version."""
    b, hw, ws = 2, 32, 8
    for c, nh in ((192, 12), (384, 12)):
        wt = _block_weights(c, 60)
        x = _rnd((b, hw, hw, c), 61).to(BF)
        a = _rnd((b, hw, hw, c), 62).to(BF)
        g = _rnd((b, hw, hw, c), 63).to(BF)
        bias = _rnd((nh, 64, 64), 64)
        scale = (c // nh) ** -0.5
        for shift in (0, 2):
            mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
                    if shift else None)
            cases = [
                (wa.fused_block_attention, wa.block_attention_plain,
                 [x, *wt["att"], bias], (mask, ws, nh, scale, shift)),
                (sb.fused_mlp_tail, sb.mlp_tail_plain, [x, a, *wt["lin"]], ()),
                (sb.fused_conv_mlp_tail_noln, sb.conv_mlp_tail_noln_plain,
                 [x, a, *wt["conv"]], ())]
            if c <= 256:
                cases += [
                    (sb.fused_swin_block, sb.swin_block_plain,
                     [x, *wt["ln1"], *wt["att"], *wt["ln2"], *wt["lin"], bias],
                     (mask, ws, nh, scale, shift)),
                    (wa.fused_block_attention_ln, wa.block_attention_ln_plain,
                     [x, *wt["ln1"], *wt["att"], bias],
                     (mask, ws, nh, scale, shift)),
                    (sb.fused_conv_mlp_tail, sb.conv_mlp_tail_plain,
                     [x, a, *wt["ln2"], *wt["conv"]], (shift,))]
            for fn, plain, tensors, consts in cases:
                leaves = [t.detach().requires_grad_() for t in tensors]
                grads = torch.autograd.grad(fn(*leaves, *consts), leaves, g)
                l32 = [t.detach().float().requires_grad_() for t in tensors]
                refs = torch.autograd.grad(plain(*l32, *consts), l32, g.float())
                torch.cuda.synchronize()
                for i, (ga, gr) in enumerate(zip(grads, refs)):
                    assert ga.dtype == tensors[i].dtype
                    assert _rel(ga, gr) < 3e-2, (fn.__name__, c, shift, i)


def test_flagship_backward_reaches_every_parameter(card):
    """A backward through the bf16 flagship on the card leaves no trainable
    parameter without a (finite, non-zero) gradient: no launcher cuts the
    graph, and the caches of detached weights are not read under grad."""
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    m = build_model("configs/model.yaml", ch_in=4, dtype=BF)
    m = cache_rel_bias(init_weights(m, 0).cuda().eval())   # stale caches
    m.train()
    x = torch.rand((2, 256, 256, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    kernels.reset_launches()
    out = m(x, x)["raw"][0]
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert counts["window_attention_bwd"] == 10
    assert counts["global_attention_bwd"] == 1
    assert counts["window_attention"] == 10 and counts["global_attention"] == 1
    assert counts["layernorm"] == 23 and counts["add_layernorm"] == 5
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


# ------------------------------------------- K11: pre-partitioned windows
#
# The corners of the kernel's domain: head dims 16, 32 and 64, windows of 4
# (a 2x2 map: SwinV2's last stage at 64 px), 16, 64, 100 (padded to 112 in
# shared memory) and 256 tokens, one window,
# more windows than dbias groups, and the four full-width shapes of the
# SwinV2 family at 512 px (batch 2; stage 3's nw = 4).
K11_SHAPES = [(8, 4, 96, 3, 2), (4, 16, 32, 2, 4), (6, 16, 96, 3, 2),
              (1, 16, 768, 24, 1),
              (512, 64, 96, 3, 256), (128, 64, 192, 6, 64),
              (32, 64, 384, 12, 16), (8, 64, 768, 24, 4),
              (6, 100, 64, 2, 3), (3, 256, 128, 2, 3), (300, 64, 64, 4, 2)]


def _k11_inputs(w, n, c, nh, nw, masked):
    qkv = _rnd((w, n, 3 * c), 70).to(BF)
    gy = _rnd((w, n, c), 71).to(BF)
    bias = _rnd((nh, n, n), 72)
    mask = None
    if masked:
        mask = torch.where(_rnd((nw, n, n), 73) > 0.5, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()    # no fully masked row
    return qkv, gy, bias, mask, (nw if masked else 1)


@pytest.mark.parametrize("w,n,c,nh,nw", K11_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scale_one", [True, False], ids=["v2", "v1"])
def test_window_attention_tokens_kernel(card, w, n, c, nh, nw, masked,
                                        scale_one):
    """K11 forward against its plain version; scale 1.0 (the V2 caller) and
    hd ** -0.5 (the v1 token-layout caller)."""
    qkv, _, bias, mask, nw = _k11_inputs(w, n, c, nh, nw, masked)
    scale = 1.0 if scale_one else (c // nh) ** -0.5
    kernels.reset_launches()
    out = wa.fused_window_attention(qkv, bias, mask, nw, nh, scale)
    ref = wa.reference_attention_qkv(qkv.float(), bias, mask, nw, nh, scale)
    torch.cuda.synchronize()
    assert out.dtype == BF and tuple(out.shape) == (w, n, c)
    assert kernels.launches()["window_attention_tokens"] == 1
    assert _rel(out, ref) < TOL
    # the map kernel (K1) on the same windows, each as a ws x ws map of its
    # own, agrees to the last bit: one body, two addressings
    ws = int(n ** 0.5)
    if ws * ws == n and not masked:
        k1 = wa.fused_window_attention_nhwc(qkv.reshape(w, ws, ws, 3 * c),
                                            bias, None, ws, nh, scale)
        assert torch.equal(k1.reshape(w, n, c), out)


@pytest.mark.parametrize("w,n,c,nh,nw", K11_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_tokens_bwd_kernel(card, w, n, c, nh, nw, masked):
    """K11 backward against its plain version, dq / dk / dv singly, the f32
    dbias, and bit-equal results run to run (no atomics)."""
    qkv, gy, bias, mask, nw = _k11_inputs(w, n, c, nh, nw, masked)
    scale = (c // nh) ** -0.5
    kernels.reset_launches()
    dqkv, dbias = wa.window_attention_tokens_bwd(qkv, bias, mask, nw, nh,
                                                 scale, gy)
    rq, rb = wa.attention_qkv_bwd_plain(qkv.float(), bias, mask, nw, nh,
                                        scale, gy.float())
    torch.cuda.synchronize()
    assert kernels.launches()["window_attention_tokens_bwd"] == 1
    assert dqkv.dtype == BF and dbias.dtype == torch.float32
    assert dqkv.float().abs().max() > 0
    for k in range(3):
        assert _rel(dqkv[..., k * c:(k + 1) * c], rq[..., k * c:(k + 1) * c]) < TOL
    assert _rel(dbias, rb) < DBIAS_TOL
    d2, b2 = wa.window_attention_tokens_bwd(qkv, bias, mask, nw, nh, scale, gy)
    assert torch.equal(d2, dqkv) and torch.equal(b2, dbias)


# K11's backward through K9's register body (csrc/window_attention_bwd.cuh
# with the token addressing WrTokens) against its rounded mirror at K9's
# mirror bounds: the SwinV2 family's four stages at batch 4 (scale 1.0,
# head dim 32; 1,024 windows in 88 groups and 256 in 44, no multiple of
# them), head dims 16, 48 and 64, windows of 16 tokens (four to a stage,
# the last part-filled at 10 windows) and 4 (a 2 x 2 map); dbias bit-equal
# over two runs.
K11_BWD_SHAPES = [(1024, 64, 96, 3, 256), (256, 64, 192, 6, 64),
                  (64, 64, 384, 12, 16), (16, 64, 768, 24, 4),
                  (300, 64, 64, 4, 2), (40, 64, 96, 2, 4),
                  (30, 64, 128, 2, 5), (10, 16, 64, 2, 5), (8, 4, 96, 3, 2)]


@pytest.mark.parametrize("w,n,c,nh,nw", K11_BWD_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_tokens_bwd_vs_rounded_mirror(card, w, n, c, nh, nw,
                                                       masked):
    qkv, gy, bias, mask, nw = _k11_inputs(w, n, c, nh, nw, masked)
    scale = 1.0 if c // nh == 32 else (c // nh) ** -0.5
    assert wa.bwd_body(n) == "regs"
    dqkv, dbias = wa.window_attention_tokens_bwd(qkv, bias, mask, nw, nh,
                                                 scale, gy)
    mq, mb = wa.attention_qkv_bwd_mirror(qkv.float(), bias, mask, nw, nh,
                                         scale, gy.float())
    d2, b2 = wa.window_attention_tokens_bwd(qkv, bias, mask, nw, nh, scale,
                                            gy)
    torch.cuda.synchronize()
    for k in range(3):
        assert _rel(dqkv[..., k * c:(k + 1) * c], mq[..., k * c:(k + 1) * c]) < MIRROR_TOL
    assert _rel(dbias, mb) < MIRROR_DBIAS_TOL
    assert torch.equal(d2, dqkv) and torch.equal(b2, dbias)


@pytest.mark.parametrize("w,n,c,nh", [(64, 64, 64, 2), (90, 64, 96, 3),
                                       (10, 16, 64, 2), (3, 256, 64, 2)])
def test_tokens_bwd_is_k9s_body_on_the_same_windows(card, w, n, c, nh):
    """One body, two addressings: K11's backward on w windows of n tokens
    and K9 on a map of w images of one ws x ws window each (the same
    windows in the same order, the same groups) agree to the last bit,
    dbias included - the register body at n <= 64 (four windows to a
    stage at 16), the strip body at 256 (`bwd_body`), where the other body
    would sum dbias over other groups in another order."""
    ws = int(n ** 0.5)
    qkv, gy, bias, _, _ = _k11_inputs(w, n, c, nh, 1, False)
    scale = (c // nh) ** -0.5
    dq, db = wa.window_attention_tokens_bwd(qkv, bias, None, 1, nh, scale, gy)
    mq, mb = wa.window_attention_bwd(qkv.reshape(w, ws, ws, 3 * c), bias,
                                     None, ws, nh, scale,
                                     gy.reshape(w, ws, ws, c))
    torch.cuda.synchronize()
    assert wa.bwd_body(n) == ("regs" if n <= 64 else "strips")
    assert dq.float().abs().max() > 0
    assert torch.equal(mq.reshape(w, n, 3 * c), dq) and torch.equal(mb, db)


def test_window_attention_tokens_grad(card):
    """torch.autograd.grad through K11 -> K11 backward with a mask and a
    non-contiguous cotangent against autograd of the f32 plain version; the
    dispatcher takes the kernel inside its domain and the plain version
    outside it."""
    w, n, c, nh, nw = 128, 64, 192, 6, 64
    qkv, _, bias, mask, nw = _k11_inputs(w, n, c, nh, nw, True)
    qkv.requires_grad_()
    bias.requires_grad_()
    gy = _rnd((w, c, n), 74).to(BF).transpose(1, 2)
    kernels.reset_launches()
    out = wa.window_attention_core(qkv, bias, mask, nw, nh, 1.0)
    dq, db = torch.autograd.grad(out, [qkv, bias], gy)
    q32 = qkv.detach().float().requires_grad_()
    b32 = bias.detach().clone().requires_grad_()
    ref = wa.reference_attention_qkv(q32, b32, mask, nw, nh, 1.0)
    rq, rb = torch.autograd.grad(ref, [q32, b32], gy.float())
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert counts["window_attention_tokens"] == 1
    assert counts["window_attention_tokens_bwd"] == 1
    assert dq.abs().max() > 0
    assert _rel(dq, rq) < TOL and _rel(db, rb) < 5e-3
    # JAX's gate: f32 on the card and windows of more than 256 tokens take
    # the plain version; bf16 windows of up to 256 tokens go to the kernel,
    # which raises outside its domain (head dim 2) and never falls back
    kernels.reset_launches()
    wa.window_attention_core(qkv.detach().float(), bias.detach(), mask, nw,
                             nh, 1.0)
    wa.window_attention_core(_rnd((2, 400, 96), 75).to(BF),
                             _rnd((2, 400, 400), 76), None, 1, 2, 1.0)
    assert sum(kernels.launches().values()) == 0
    with pytest.raises(ValueError, match="head dim 2"):
        wa.window_attention_core(_rnd((8, 4, 72), 77).to(BF),
                                 _rnd((12, 4, 4), 78), None, 1, 12, 1.0)


def test_window_attention_tokens_refusals(card):
    """The launcher raises outside the kernel's domain; it never falls back."""
    qkv, gy, bias, mask, nw = _k11_inputs(8, 64, 96, 3, 4, True)
    with pytest.raises(ValueError, match="bfloat16"):
        wa.fused_window_attention(qkv.float(), bias, mask, nw, 3, 1.0)
    with pytest.raises(ValueError, match="head dim 8"):
        wa.fused_window_attention(qkv, _rnd((12, 64, 64), 1), mask, nw, 12, 1.0)
    with pytest.raises(ValueError, match="window of 400 tokens"):
        wa.fused_window_attention(_rnd((2, 400, 96), 2).to(BF),
                                  _rnd((2, 400, 400), 3), None, 1, 2, 1.0)
    with pytest.raises(ValueError, match="mask shape"):
        wa.fused_window_attention(qkv, bias, mask, 3, 3, 1.0)
    with pytest.raises(ValueError, match="nw must be 1"):
        wa.fused_window_attention(qkv, bias, None, 4, 3, 1.0)
    with pytest.raises(ValueError, match="bias shape"):
        wa.fused_window_attention(qkv, bias[:2], mask, nw, 3, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        wa.fused_window_attention(qkv.transpose(0, 1).contiguous().transpose(0, 1),
                                  bias, mask, nw, 3, 1.0)
    with pytest.raises(ValueError, match="gy shape"):
        wa.window_attention_tokens_bwd(qkv, bias, mask, nw, 3, 1.0, gy[:4])


# launches per forward of the SwinV2 family: K11 in each of its 12 blocks,
# K13 in the cross-channel block (4), the post-norms (24) and the
# PatchMergings (3); nothing else of the port's kernels
SWINV2 = dict({k: 0 for k in MAIN}, window_attention_tokens=12, layernorm=31)


def _swinv2(dt):
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from torch_port_common import seed_postnorms
    m = build_model("model_swinv2.yaml", ch_in=4, dtype=dt)
    return seed_postnorms(init_weights(m, 0), 0).cuda()


@pytest.mark.parametrize("img", [512, 256, 128, 64])
def test_swinv2_forward_dispatch(card, img):
    """Launches per forward and bf16-vs-f32 Detect maps at every valid
    size: below 512 px the deep stages run on shrunk windows (one 8x8, 4x4
    or 2x2 window per image), which K11 takes too. Post-norm scales from
    the seed: at zero the blocks would be the identity."""
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    raws = {}
    for dt in (BF, torch.float32):
        m = cache_rel_bias(_swinv2(dt).eval())
        x = torch.rand((2, img, img, 3), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
        kernels.reset_launches()
        with torch.no_grad():
            raws[dt] = m(x, x)["raw"][0].float()
        torch.cuda.synchronize()
        if dt == BF:
            assert kernels.launches() == SWINV2
        else:
            assert sum(kernels.launches().values()) == 0   # f32: plain path
    a, b = raws[BF], raws[torch.float32]
    assert torch.isfinite(a).all()
    assert ((a - b).norm() / b.norm()).item() < TOL


def test_swinv2_backward_reaches_every_parameter(card):
    """A backward through the bf16 SwinV2 model on the card: K11's backward
    once per block, and no trainable parameter without a finite, non-zero
    gradient (the cpb-MLP bias and the logit scale included: dbias flows)."""
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    m = cache_rel_bias(_swinv2(BF).eval())      # stale caches
    m.train()
    x = torch.rand((2, 256, 256, 3), device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    kernels.reset_launches()
    out = m(x, x)["raw"][0]
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert kernels.launches() == dict(SWINV2, window_attention_tokens_bwd=12)
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name
