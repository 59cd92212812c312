#!/usr/bin/env python3
"""Device times of the Swin block kernels, K2 (the whole block with the
linear MLP), K3 (LN1 + shifted attention + projection), K4 (the un-shift,
residual, LN2 and conv MLP tail) and K5 (stage 2's qkv + attention +
projection), and of their bf16 PyTorch compositions, on one CUDA card,
with each kernel's time split by the kernels it launches.

    python tools/bench_swin_block.py [--batch 4] [--iters 30] [--label x]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call: unpack it with
`git archive` under `build/`). For each case it prints one JSON line: the
device time per call summed over the CUDA kernels that torch.profiler
records (`device_us`, and by kernel name `kernels_us`: a chain's LN, GEMM
and attention launches one by one), the CUDA-event time of the whole call
with its host work (`event_us`), the TFLOP/s of the device time, the bytes
bound of the function at 3.35 TB/s (its inputs read and its output written
once, `bytes_bound_us`) and of the chain's own traffic (each launch's
inputs read and outputs written once, `chain_bytes_bound_us`), and the
card's name and power limit (nvidia-smi).

Cases: the flagship's stage 1 (C 192, 12 heads, window 8, hidden 768) at
512 px (a 128 x 128 map) and 608 px (152 x 152, 19 windows a row): K2 on
the unshifted block, K3 and K4 at shift 2 with the mask, each of which the
main path runs three times a forward; beside each its plain version on
the same bf16 arguments (`swin_block_plain`, `block_attention_ln_plain`,
`conv_mlp_tail_plain`); and stage 2 at 512 px (C 384, 12 heads, a 64 x 64
map): K5 at shift 0 and at shift 2 with the mask, each of which the main
path runs twice a forward, beside `block_attention_plain`. Needs a card;
exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.append(".")  # the checkout, after any PYTHONPATH
from bench_window_attention_bwd import card, measure  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_swin_block: no CUDA card visible", file=sys.stderr)
        return 1
    from sodt_tpu_torch.kernels import swin_block as sb
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.models.swin import shift_attn_mask

    name = card()
    tree = str(Path(sb.__file__).resolve().parents[2])
    b, c, nh, ws = args.batch, 192, 12, 8
    hid, n = 4 * c, ws * ws
    g = torch.Generator().manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)

    ln = lambda: (1 + rnd((c,), 0.1, torch.float32),
                  rnd((c,), 0.1, torch.float32))
    ln1, ln2 = ln(), ln()
    att = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.1),
           rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    lin = (rnd((hid, c), c ** -0.5), rnd((hid,), 0.1),
           rnd((c, hid), hid ** -0.5), rnd((c,), 0.1))
    conv = (rnd((c, c), c ** -0.5), rnd((c,), 0.1),
            rnd((c, 2, 2, c), (4 * c) ** -0.5), rnd((c,), 0.1),
            rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    bias = rnd((nh, n, n), 1.0, torch.float32)
    scale = (c // nh) ** -0.5
    size = lambda *ts: sum(t.numel() * t.element_size() for t in ts
                           if t is not None)

    def emit(kname, kern, plain, blk, flops, fbytes, cbytes, tag):
        for label, fn in ((f"{kname} {tag}", lambda: kern(*blk)),
                          (f"{kname} plain {tag}", lambda: plain(*blk))):
            row = {"case": label, "tree": tree, "label": args.label,
                   "card": name, **measure(fn, args.iters)}
            row["tflops"] = flops / max(row["device_us"], 1e-9) / 1e6
            row["bytes_bound_us"] = 1e6 * fbytes / 3.35e12
            row["chain_bytes_bound_us"] = 1e6 * cbytes / 3.35e12
            print(json.dumps(row), flush=True)

    for hw in (128, 152):
        x, a = rnd((b, hw, hw, c)), rnd((b, hw, hw, c))
        mask = torch.from_numpy(shift_attn_mask(hw, hw, ws, 2)).cuda()
        m = b * hw * hw
        mc2 = m * c * 2
        # (name, kernel, plain, arguments, FLOPs, the function's bytes:
        # its inputs and output once, and the chain's: (M, C) bf16 maps,
        # an f32 res1 counting two, as chip_smoke.py counts them)
        cases = (
            ("K2", sb.fused_swin_block, sb.swin_block_plain,
             (x, *ln1, *att, *ln2, *lin, bias, None, ws, nh, scale, 0),
             m * (24 * c * c + 4 * n * c),
             2 * mc2 + size(*ln1, *att, *ln2, *lin, bias),
             29 * mc2 + size(*ln1, *att, *ln2, *lin, bias)),
            ("K3", wa.fused_block_attention_ln, wa.block_attention_ln_plain,
             (x, *ln1, *att, bias, mask, ws, nh, scale, 2),
             m * (8 * c * c + 4 * n * c),
             2 * mc2 + size(*ln1, *att, bias, mask),
             12 * mc2 + size(*ln1, *att, bias, mask)),
            ("K4", sb.fused_conv_mlp_tail, sb.conv_mlp_tail_plain,
             (x, a, *ln2, *conv, 2), 12 * m * c * c,
             3 * mc2 + size(*ln2, *conv), 13 * mc2 + size(*ln2, *conv)))
        for kname, kern, plain, blk, flops, fbytes, cbytes in cases:
            emit(kname, kern, plain, blk, flops, fbytes, cbytes,
                 f"({b},{hw},{hw},{c}) shift {blk[-1]}")
    # stage 2: K5, its chain's own traffic 10 (M, C) bf16 maps (x, qkv
    # written and read, the attention output written and read, out)
    c2, hw = 2 * c, 64
    m = b * hw * hw
    att2 = (rnd((3 * c2, c2), c2 ** -0.5), rnd((3 * c2,), 0.1),
            rnd((c2, c2), c2 ** -0.5), rnd((c2,), 0.1))
    x = rnd((b, hw, hw, c2))
    for shift in (0, 2):
        mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).cuda()
                if shift else None)
        w = size(*att2, bias, mask)
        emit("K5", wa.fused_block_attention, wa.block_attention_plain,
             (x, *att2, bias, mask, ws, nh, (c2 // nh) ** -0.5, shift),
             m * (8 * c2 * c2 + 4 * n * c2), 2 * m * c2 * 2 + w,
             10 * m * c2 * 2 + w, f"({b},{hw},{hw},{c2}) shift {shift}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
