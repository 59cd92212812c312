#!/usr/bin/env python3
"""Device times of K13, the LayerNorm and add + LayerNorm kernels
(`sodt_tpu_torch/kernels/layernorm.py`), at every shape the paths give them,
on one CUDA card, beside `F.layer_norm` on the same rows and each shape's
bytes bound.

    python tools/bench_layernorm.py [--batch 4] [--iters 50] [--label x]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call: unpack it with
`git archive` under `build/`). For each shape it prints one JSON line: the
device time per call summed over the CUDA kernels torch.profiler records
(`device_us`, by name `kernels_us`), the CUDA-event time of the Python call
(`event_us`), the library call's device time (`library_device_us`:
`F.layer_norm`, of `a + b` for add + LN), the bytes bound at 3.35 TB/s (x
read and y written once; add + LN two reads and two writes; g and beta
once) and its share of the device time; then one line per path with the
sums over its calls (`calls` a forward or a step at 512 px, batch 4, as
chip_smoke.py counts them), and the card's name and power limit.

Shapes: the flagship's training step (LN at C 48, 192, 384, 768: 4, 12, 5
and 2 calls; add + LN at 384 and 768: 4 and 1), SwinV2's forward (LN at
C 24 on its cross-channel block's 2 x 2 windows, 96, 192, 384, 768: 4, 4,
5, 13 and 5 calls). Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.append(".")  # the checkout, after any PYTHONPATH
from bench_window_attention_bwd import card, measure  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_layernorm: no CUDA card visible", file=sys.stderr)
        return 1
    from sodt_tpu_torch.kernels import layernorm as kln

    name = card()
    tree = str(Path(kln.__file__).resolve().parents[2])
    b = args.batch
    g = torch.Generator().manual_seed(0)

    def rnd(shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)

    # (path, kind, shape, calls)
    shapes = [("train", "ln", (b, 128, 128, 48), 4),
              ("train", "ln", (b, 128, 128, 192), 12),
              ("train", "ln", (b, 64, 64, 384), 5),
              ("train", "ln", (b, 32, 32, 768), 2),
              ("train", "add_ln", (b, 64, 64, 384), 4),
              ("train", "add_ln", (b, 32, 32, 768), 1),
              ("swinv2", "ln", (b * 4096, 4, 24), 4),
              ("swinv2", "ln", (b, 128, 128, 96), 4),
              ("swinv2", "ln", (b, 64, 64, 192), 5),
              ("swinv2", "ln", (b, 32, 32, 384), 13),
              ("swinv2", "ln", (b, 16, 16, 768), 5)]
    totals = {}
    for path, kind, shape, calls in shapes:
        c = shape[-1]
        x, y = rnd(shape), rnd(shape)
        w, bb = 1 + rnd((c,), 0.1, torch.float32), rnd((c,), 0.1, torch.float32)
        wb, bbb = w.to(torch.bfloat16), bb.to(torch.bfloat16)
        xb = x.numel() * 2
        if kind == "ln":
            fn = lambda: kln.layernorm(x, w, bb)
            lib = lambda: F.layer_norm(x, (c,), wb, bbb)
            nbytes = 2 * xb + 8 * c
        else:
            fn = lambda: kln.add_layernorm(x, y, w, bb)
            lib = lambda: F.layer_norm(x + y, (c,), wb, bbb)
            nbytes = 4 * xb + 8 * c
        row = {"case": f"{kind} {shape}", "path": path, "calls": calls,
               "tree": tree, "label": args.label, "card": name,
               **measure(fn, args.iters)}
        row["library_device_us"] = measure(lib, args.iters)["device_us"]
        row["bytes_bound_us"] = 1e6 * nbytes / HBM_BYTES_PER_S
        row["bound_share"] = row["bytes_bound_us"] / max(row["device_us"],
                                                         1e-9)
        print(json.dumps(row), flush=True)
        tot = totals.setdefault((path, kind), dict.fromkeys(
            ("device_ms", "event_ms", "library_device_ms", "bound_ms",
             "calls"), 0.0))
        tot["device_ms"] += calls * row["device_us"] / 1e3
        tot["event_ms"] += calls * row["event_us"] / 1e3
        tot["library_device_ms"] += calls * row["library_device_us"] / 1e3
        tot["bound_ms"] += calls * row["bytes_bound_us"] / 1e3
        tot["calls"] += calls
    for (path, kind), tot in totals.items():
        print(json.dumps({"case": f"{kind} per {'step' if path == 'train' else 'forward'}",
                          "path": path, "tree": tree, "label": args.label,
                          "card": name, **tot}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
