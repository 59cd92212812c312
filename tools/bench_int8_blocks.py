#!/usr/bin/env python3
"""Device times of K12, the six int8 serving bodies, on one CUDA card, each
split by the kernels it launches, beside its bf16 twin (the bf16 kernel of
the same block) and its plain int8 version.

    python tools/bench_int8_blocks.py [--batch 4] [--iters 30] [--label x]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call: unpack it with
`git archive` under `build/`). For each case it prints one JSON line: the
device time per call summed over the CUDA kernels that torch.profiler
records (`device_us`, and by kernel name `kernels_us`), the CUDA-event time
of the whole call with its host work (`event_us`), the call's launches
one by one in launch order (`launches_us`: [kernel, us], null where a
session lost a record; two launches of one instantiation, as K3's and
K5's qkv and proj, stay apart there), the same two for the bf16 twin
(`bf16_device_us`, `bf16_kernels_us`) and the plain int8 version
(`plain_device_us`), the least time of the function's bytes at 3.35 TB/s
(its activations read and its output written once, the int8 weights once:
`bytes_bound_us`) and of its s8 operations at 1,979 TOP/s plus the
attention core's bf16 FLOPs at 989 TFLOP/s (`ops_bound_us`), the bytes the
chain's own launches move (each launch reading its inputs and writing its
outputs once, `chain_bytes` and `chain_bytes_bound_us`; the chains of
csrc/int8_chains.cu), and the card's name and power limit (nvidia-smi).

Cases, at the int8 path's shapes at 512 px (JAX's int8 gate): stage 1
(a 128 x 128 map, C 192, 12 heads, window 8, hidden 768) K2's twin
`swin_block_q8` on the unshifted block, K3's `block_attention_ln_q8` and
K4's `conv_mlp_tail_q8` at shift 2; stage 2 (64 x 64, C 384) K5's
`block_attention_q8` at shift 0 and 2, K6's `mlp_tail_q8` (hidden 1,536) and
K7's `conv_mlp_tail_noln_q8`. Then the two ways to quantize the conv's
output (the dearest producer): run the conv twice (fold, then codes) or
store it in f32 and quantize it in a row pass (`conv_*` lines, where the
tree has the chains' one-launch entries), and the same two ways for fc1's
GELU output of K2's twin (hidden 768) and K6's (hidden 1,536; `fc1_*`
lines). Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.append(".")  # the checkout, after any PYTHONPATH
from bench_window_attention_bwd import card, measure  # noqa: E402


def launch_order(fn, iters: int):
    """The device time of each launch of one call of `fn`, in launch order
    ([kernel, us] averaged over `iters` calls of one torch.profiler
    session), or None where the session's records do not split into
    `iters` equal calls (CUPTI lost some)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not e.name.startswith("Memcpy")),
                key=lambda e: e.time_range.start)
    n = len(ev) // iters
    if not n or len(ev) != n * iters:
        return None
    names = [e.name for e in ev[:n]]
    if any(ev[k].name != names[k % n] for k in range(len(ev))):
        return None
    return [[names[i][:80], sum(ev[c * n + i].time_range.elapsed_us()
                                for c in range(iters)) / iters]
            for i in range(n)]

HBM = 3.35e12
S8_OPS, BF16_FLOPS = 1.979e15, 9.89e14


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_int8_blocks: no CUDA card visible", file=sys.stderr)
        return 1
    from sodt_tpu_torch.kernels import swin_block as sb
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.kernels.quant import q8_weights
    from sodt_tpu_torch.models.swin import shift_attn_mask

    name = card()
    tree = str(Path(sb.__file__).resolve().parents[2])
    b, nh, ws, n = args.batch, 12, 8, 64
    g = torch.Generator().manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)

    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts
                           if t is not None)
    wsize = lambda q8: sum(size(q, s) for q, s in q8.values())

    def emit(row):
        row.update(tree=tree, label=args.label, card=name)
        print(json.dumps(row), flush=True)

    def weights(c, hid):
        ln = (1 + rnd((c,), 0.1, torch.float32), rnd((c,), 0.1, torch.float32))
        att = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.1),
               rnd((c, c), c ** -0.5), rnd((c,), 0.1))
        lin = (rnd((hid, c), c ** -0.5), rnd((hid,), 0.1),
               rnd((c, hid), hid ** -0.5), rnd((c,), 0.1))
        conv = (rnd((c, c), c ** -0.5), rnd((c,), 0.1),
                rnd((c, 2, 2, c), (4 * c) ** -0.5), rnd((c,), 0.1),
                rnd((c, c), c ** -0.5), rnd((c,), 0.1))
        return ln, att, lin, conv

    cases = []
    # stage 1
    hw, c = 128, 192
    m, hid = b * hw * hw, 4 * 192
    mc, halo = m * c, m // ws        # halo: one map row a strip of 8 rows
    ln1, att, lin, conv = weights(c, hid)
    ln2 = weights(c, hid)[0]
    x, a = rnd((b, hw, hw, c)), rnd((b, hw, hw, c))
    bias = rnd((nh, n, n), 1.0, torch.float32)
    mask = torch.from_numpy(shift_attn_mask(hw, hw, ws, 2)).cuda()
    sc = (c // nh) ** -0.5
    q2 = q8_weights(None, wqkv=att[0], wp=att[2], w1=lin[0], w2=lin[2])
    q4 = q8_weights(None, w1=conv[0], wc=conv[2], w2=conv[4])
    core = 4 * m * n * c
    # (name, wrapper, plain int8 body, arguments, int8 weights, s8 ops,
    # bf16 FLOPs, the function's bytes, the chain's bytes or None)
    cases += [
        ("swin_block_q8", sb.fused_swin_block, sb.swin_block_q8_plain,
         (x, *ln1, *att, *ln2, *lin, bias, None, ws, nh, sc, 0), q2,
         2 * m * c * (4 * c + 2 * hid), core,
         2 * size(x) + wsize(q2) + size(*ln1, *ln2, att[1], att[3], lin[1],
                                        lin[3], bias),
         # in M C bytes: x 2 + 2 + 2, codes 1 + 1 + 1 + 1 + 1 + 1, qkv
         # 6 + 6, att 2 + 2 + 2, res1 4 + 4 + 4 + 4, the hidden's 4 + 4,
         # out 2
         mc * 57 + wsize(q2)),
        ("block_attention_ln_q8", wa.fused_block_attention_ln,
         wa.block_attention_ln_q8_plain,
         (x, *ln1, *att, bias, mask, ws, nh, sc, 2),
         {k: q2[k] for k in ("wqkv", "wp")}, 8 * m * c * c, core,
         2 * size(x) + size(*ln1, att[1], att[3], bias, mask)
         + wsize({k: q2[k] for k in ("wqkv", "wp")}),
         # in M C bytes: x 2 + 2, codes 1 + 1 + 1 + 1, qkv 6 + 6, att 2 + 2
         # + 2, out 2
         mc * 28 + wsize({k: q2[k] for k in ("wqkv", "wp")})),
        ("conv_mlp_tail_q8", sb.fused_conv_mlp_tail,
         sb.conv_mlp_tail_q8_plain, (x, a, *ln2, *conv, 2), q4,
         2 * (m + halo) * c * c + 10 * m * c * c, 0,
         3 * size(x) + wsize(q4) + size(*ln2, conv[1], conv[3], conv[5]),
         # x + a over the rows and halo rows 4.5 + 4.5, t 1.125 + 1.125, f1
         # 1.125 + 1.125 + 1.125, the conv's f32 y 4 + 4, y's codes 1 + 1,
         # fc2's x + a + out 6
         int(mc * 30.625) + wsize(q4))]
    # stage 2
    hw, c = 64, 384
    m, hid = b * hw * hw, 4 * 384
    mc, halo = m * c, m // ws
    _, att2, lin2, conv2 = weights(c, hid)
    xb, yb = rnd((b, hw, hw, c)), rnd((b, hw, hw, c))
    sc2 = (c // nh) ** -0.5
    q5 = q8_weights(None, wqkv=att2[0], wp=att2[2])
    q6 = q8_weights(None, w1=lin2[0], w2=lin2[2])
    q7 = q8_weights(None, w1=conv2[0], wc=conv2[2], w2=conv2[4])
    core = 4 * m * n * c
    for sh in (0, 2):
        mk = (torch.from_numpy(shift_attn_mask(hw, hw, ws, sh)).cuda()
              if sh else None)
        cases.append(
            ("block_attention_q8", wa.fused_block_attention,
             wa.block_attention_q8_plain, (xb, *att2, bias, mk, ws, nh, sc2,
                                           sh),
             q5, 8 * m * c * c, core,
             2 * size(xb) + size(att2[1], att2[3], bias, mk) + wsize(q5),
             mc * 28 + wsize(q5)))     # as K3's twin
    cases += [
        ("mlp_tail_q8", sb.fused_mlp_tail, sb.mlp_tail_q8_plain,
         (xb, yb, *lin2), q6, 4 * m * c * hid, 0,
         3 * size(xb) + size(lin2[1], lin2[3]) + wsize(q6),
         # in M C bytes: y 2 + 2, codes 1 + 1 + 1, fc1's f32 hidden 16 +
         # 16, its codes 4 + 4, r 2, out 2
         mc * 50 + wsize(q6)),
        ("conv_mlp_tail_noln_q8", sb.fused_conv_mlp_tail_noln,
         sb.conv_mlp_tail_noln_q8_plain, (xb, yb, *conv2), q7,
         2 * (m + halo) * c * c + 10 * m * c * c, 0,
         3 * size(xb) + size(conv2[1], conv2[3], conv2[5]) + wsize(q7),
         # y over the rows and halo rows 2.25 + 2.25, t 1.125 + 1.125, f1
         # 1.125 + 1.125 + 1.125, the conv's f32 y 4 + 4, y's codes 1 + 1,
         # fc2's r + out 4
         int(mc * 24.125) + wsize(q7))]

    for (cname, fn, plain, blk, q8, ops, flops, fbytes, cbytes) in cases:
        shape = tuple(blk[0].shape)
        shift = blk[-1] if isinstance(blk[-1], int) else 0
        kern = measure(lambda: fn(*blk, int8=True, q8=q8), args.iters)
        kern["launches_us"] = launch_order(
            lambda: fn(*blk, int8=True, q8=q8), args.iters)
        bf = measure(lambda: fn(*blk), args.iters)
        pl = measure(lambda: plain(*blk, q8=q8), max(3, args.iters // 10))
        row = {"case": f"{cname} {shape} shift {shift}", **kern,
               "bf16_device_us": bf["device_us"],
               "bf16_kernels_us": bf["kernels_us"],
               "bf16_event_us": bf["event_us"],
               "plain_device_us": pl["device_us"],
               "bytes_bound_us": 1e6 * fbytes / HBM,
               "ops_bound_us": 1e6 * (ops / S8_OPS + flops / BF16_FLOPS),
               "tops": ops / max(kern["device_us"], 1e-9) / 1e6}
        if cbytes is not None:
            row.update(chain_bytes=cbytes,
                       chain_bytes_bound_us=1e6 * cbytes / HBM)
        emit(row)

    # the conv's quantization point, two ways, at both stages
    if not hasattr(sb, "gemm_s8"):
        return 0
    for (bb, hh, cc) in ((b, 128, 192), (b, 64, 384)):
        mm, s = bb * hh * hh, bb * (hh // ws)
        gen = torch.Generator().manual_seed(1)
        f1 = torch.randint(-127, 128, (mm + s * hh, cc), generator=gen,
                           dtype=torch.int8).cuda()
        wq = torch.randint(-127, 128, (cc, 4 * cc), generator=gen,
                           dtype=torch.int8).cuda()
        sw = (torch.rand(cc, generator=gen) * 1e-4 + 1e-5).cuda()
        bc = (torch.randn(cc, generator=gen) * 0.1).to(torch.bfloat16).cuda()
        amax_in = (torch.rand(s, generator=gen) * 4 + 0.5).cuda()
        geo = (bb, hh, hh, ws)
        op = (f1, wq, sw, bc, amax_in)

        def recompute():
            _, slots = sb.gemm_s8(*op, sb.S8_FOLD, conv=geo)
            return sb.gemm_s8(*op, sb.S8_CODES, slots, conv=geo)

        def store_f32():
            y, slots = sb.gemm_s8(*op, sb.S8_F32, conv=geo)
            return sb.q8_rowpass(y, None, None, sb.S8_CODES, ws * hh, slots)

        for way, fn in (("recompute", recompute), ("f32 + row pass", store_f32)):
            emit({"case": f"conv_{way} ({mm}, {cc}) K {4 * cc}",
                  **measure(fn, args.iters),
                  "ops_bound_us": 1e6 * 2 * mm * cc * 4 * cc / S8_OPS})

    # fc1's quantization point (tanh-GELU(v + b1), hidden 4C), two ways:
    # K2's twin at stage 1, K6's at stage 2, on the codes of a normal (M, C)
    # activation and the int8 weights of a normal fc1 as the chains see
    # them (the GELU fold's cost depends on the values). The row pass reads
    # the f32 hidden as rows of at most 512 (its widest).
    from sodt_tpu_torch.kernels.quant import q8_weight
    for (hh, cc) in ((128, 192), (64, 384)):
        mm, r, hid = b * hh * hh, ws * hh, 4 * cc
        y = rnd((mm // r, r, cc), 1.0, torch.float32)
        amax_in = y.abs().amax((1, 2))
        sx = (amax_in.clamp_min(1e-8) / torch.tensor(127.0, device="cuda"))
        a8 = torch.clamp(torch.round(y / sx[:, None, None]), -127, 127).to(
            torch.int8).reshape(mm, cc)
        wq, sw = q8_weight(rnd((hid, cc), cc ** -0.5))
        op = (a8, wq, sw, rnd((hid,), 0.1), amax_in)
        cw = max(d for d in range(4, 513, 4) if hid % d == 0)

        def recompute():
            _, slots = sb.gemm_s8(*op, sb.S8_FOLD, strip_rows=r)
            return sb.gemm_s8(*op, sb.S8_CODES, slots, strip_rows=r)

        def store_f32():
            h, slots = sb.gemm_s8(*op, sb.S8_F32, strip_rows=r)
            return sb.q8_rowpass(h.view(-1, cw), None, None, sb.S8_CODES,
                                 r * hid // cw, slots)

        for way, fn in (("recompute", recompute), ("f32 + row pass", store_f32)):
            emit({"case": f"fc1_{way} ({mm}, {cc}) N {hid}",
                  **measure(fn, args.iters),
                  "launches_us": launch_order(fn, args.iters),
                  "ops_bound_us": 1e6 * 2 * mm * cc * hid / S8_OPS})
    return 0


if __name__ == "__main__":
    sys.exit(main())
