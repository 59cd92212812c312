#!/usr/bin/env python3
"""Device times of K2 (the whole Swin block with the linear MLP) and of its
bf16 PyTorch composition, on one CUDA card, with the kernel's time split by
the kernels it launches.

    python tools/bench_swin_block.py [--batch 4] [--iters 30] [--label x]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call: unpack it with
`git archive` under `build/`). For each case it prints one JSON line: the
device time per call summed over the CUDA kernels that torch.profiler
records (`device_us`, and by kernel name `kernels_us`: the chain's LN,
GEMM and attention launches one by one), the CUDA-event time of the whole
call with its host work (`event_us`), the TFLOP/s of the device time, the
bytes bound of the call at 3.35 TB/s, and the card's name and power limit
(nvidia-smi).

Cases: the flagship's stage 1 (C 192, 12 heads, window 8, hidden 768) at
512 px (a 128 x 128 map) and 608 px (152 x 152, 19 windows a row), the
unshifted block the main path runs three times a forward; beside each
`swin_block_plain` on the same bf16 arguments. Needs a card; exits 1
without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.append(".")  # the checkout, after any PYTHONPATH
from bench_global_attention import card, measure  # noqa: E402


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

    name = card()
    tree = str(Path(sb.__file__).resolve().parents[2])
    b, c, nh, ws = args.batch, 192, 12, 8
    hid, n = 4 * c, ws * ws
    g = torch.Generator().manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)

    ln = lambda: (1 + rnd((c,), 0.1, torch.float32),
                  rnd((c,), 0.1, torch.float32))
    wts = (*ln(), rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.1),
           rnd((c, c), c ** -0.5), rnd((c,), 0.1), *ln(),
           rnd((hid, c), c ** -0.5), rnd((hid,), 0.1),
           rnd((c, hid), hid ** -0.5), rnd((c,), 0.1))
    bias = rnd((nh, n, n), 1.0, torch.float32)
    scale = (c // nh) ** -0.5
    for hw in (128, 152):
        x = rnd((b, hw, hw, c))
        m = b * hw * hw
        flops = m * (24 * c * c + 4 * n * c)
        # x read and the output written once, the weights and the bias
        nbytes = 2 * x.numel() * 2 + sum(t.numel() * t.element_size()
                                         for t in (*wts, bias))
        blk = (x, *wts, bias, None, ws, nh, scale, 0)
        tag = f"({b},{hw},{hw},{c}) hidden {hid} shift 0"
        for label, fn in ((f"K2 {tag}", lambda: sb.fused_swin_block(*blk)),
                          (f"K2 plain {tag}",
                           lambda: sb.swin_block_plain(*blk))):
            row = {"case": label, "tree": tree, "label": args.label,
                   "card": name, **measure(fn, args.iters)}
            row["tflops"] = flops / row["device_us"] / 1e6
            row["bytes_bound_us"] = 1e6 * nbytes / 3.35e12
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
