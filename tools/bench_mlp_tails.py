#!/usr/bin/env python3
"""Device times of K6 and K7 (the stage-2 MLP tails), of each launch of
the GEMM core they run on, and of their bf16 PyTorch compositions, on one
CUDA card.

    python tools/bench_mlp_tails.py [--batch 4] [--iters 50] [--label x]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call). For each case
it prints one JSON line: the device time per call summed over the CUDA
kernels that torch.profiler records (`device_us`, and by kernel name
`kernels_us`), the CUDA-event time of the whole call with its host work
(`event_us`), the TFLOP/s of the device time, and the card's name and
power limit (nvidia-smi).

Cases at the flagship's stage 2 (a 64 x 64 map, C 384, hidden 1536): K6
`fused_mlp_tail` and K7 `fused_conv_mlp_tail_noln`, their plain versions
on the same bf16 arguments (cuBLAS / cuDNN products with elementwise
passes between them), and each of the five core launches alone (K6: fc1 +
GELU, fc2 + residual; K7: fc1, the 2x2 conv + GELU, fc2 + residual), and
one cuBLAS call (`F.linear`, its bias fused) at the three GEMM shapes.
Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.append(".")  # the checkout, after any PYTHONPATH
from bench_global_attention import card, measure  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_mlp_tails: no CUDA card visible", file=sys.stderr)
        return 1
    from sodt_tpu_torch.kernels import swin_block as sb

    name = card()
    b, hw, c = args.batch, 64, 384
    hid, m = 4 * c, args.batch * 64 * 64
    g = torch.Generator().manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to("cuda",
                                                            torch.bfloat16)

    r, y = rnd((b, hw, hw, c)), rnd((b, hw, hw, c))
    w6 = (rnd((hid, c), c ** -0.5), rnd((hid,), 0.1),
          rnd((c, hid), hid ** -0.5), rnd((c,), 0.1))
    w7 = (rnd((c, c), c ** -0.5), rnd((c,), 0.1),
          rnd((c, 2, 2, c), (4 * c) ** -0.5), rnd((c,), 0.1),
          rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    hmap = sb.gemm_core(y, w6[0], w6[1], sb.GEMM_GELU)
    tag = f"({b},{hw},{hw},{c})"
    cases = [
        (f"K6 {tag} hidden {hid}", 4 * m * c * hid,
         lambda: sb.fused_mlp_tail(r, y, *w6)),
        (f"K6 plain {tag} hidden {hid}", 4 * m * c * hid,
         lambda: sb.mlp_tail_plain(r, y, *w6)),
        (f"K7 {tag}", 12 * m * c * c,
         lambda: sb.fused_conv_mlp_tail_noln(r, y, *w7)),
        (f"K7 plain {tag}", 12 * m * c * c,
         lambda: sb.conv_mlp_tail_noln_plain(r, y, *w7)),
        (f"core K6 fc1 + GELU N {hid} K {c}", 2 * m * c * hid,
         lambda: sb.gemm_core(y, w6[0], w6[1], sb.GEMM_GELU)),
        (f"core K6 fc2 + residual N {c} K {hid}", 2 * m * c * hid,
         lambda: sb.gemm_core(hmap, w6[2], w6[3], sb.GEMM_RESIDUAL, r)),
        (f"core K7 fc1 N {c} K {c}", 2 * m * c * c,
         lambda: sb.gemm_core(y, w7[0], w7[1], sb.GEMM_BIAS)),
        (f"core K7 conv + GELU N {c} K {4 * c}", 8 * m * c * c,
         lambda: sb.gemm_core(y, w7[2], w7[3], sb.GEMM_CONV)),
        (f"core K7 fc2 + residual N {c} K {c}", 2 * m * c * c,
         lambda: sb.gemm_core(y, w7[4], w7[5], sb.GEMM_RESIDUAL, r)),
        # one cuBLAS call (with its bias epilogue) at three of those shapes
        (f"F.linear N {hid} K {c}", 2 * m * c * hid,
         lambda: F.linear(y, w6[0], w6[1])),
        (f"F.linear N {c} K {hid}", 2 * m * c * hid,
         lambda: F.linear(hmap, w6[2], w6[3])),
        (f"F.linear N {c} K {c}", 2 * m * c * c,
         lambda: F.linear(y, w7[0], w7[1])),
    ]
    for label, flops, fn in cases:
        row = {"case": label, "label": args.label, "card": name,
               **measure(fn, args.iters)}
        row["tflops"] = flops / row["device_us"] / 1e6
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
