#!/usr/bin/env python3
"""Device times of K8 and K10 (global attention forward and backward) and
of their PyTorch yardsticks, on one CUDA card.

    python tools/bench_global_attention.py [--batch 4] [--iters 50]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call). For each case
it prints one JSON line: the device time per call summed over the CUDA
kernels that torch.profiler records (`device_us`, and by kernel name
`kernels_us`), the CUDA-event time of the whole call with its host work
(`event_us`), and the card's name and power limit (nvidia-smi).

Cases at the flagship's stage 3 (c 768, 12 heads, head dim 64): K8 on one
32x32 window (512 px) and on four (608 px), K8 keeping K10's statistics
(the training forward), K10 on K8's statistics (the training backward)
and on its own, SDPA forward and backward on the same inputs with the
bias as a bf16 mask (no dbias). Needs a card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def measure(fn, iters: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    event_us = 1e3 * start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0:
            kernels[e.key[:80]] = t / iters
    return {"event_us": event_us, "device_us": sum(kernels.values()),
            "kernels_us": kernels}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_global_attention: no CUDA card visible", file=sys.stderr)
        return 1
    from sodt_tpu_torch.kernels import window_attention as wa

    name = card()
    b, nh, c, ws = args.batch, 12, 768, 32
    n = ws * ws
    g = torch.Generator().manual_seed(0)

    def rnd(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to("cuda", dtype)

    bias = rnd((nh, n, n), torch.float32)
    scale = (c // nh) ** -0.5
    cases = []
    for hw in (32, 64):
        qkv = rnd((b, hw, hw, 3 * c))
        gy = rnd((b, hw, hw, c))
        nw = (hw // ws) ** 2
        heads = (qkv.reshape(b, hw // ws, ws, hw // ws, ws, 3, nh, c // nh)
                 .permute(5, 0, 1, 3, 6, 2, 4, 7)
                 .reshape(3, b * nw, nh, n, c // nh))
        q, k, v = (t.contiguous() for t in heads)
        am = bias.to(torch.bfloat16)[None]
        tag = f"({b},{hw},{hw},{3 * c}) ws {ws}"
        cases.append((f"K8 {tag}", lambda qkv=qkv, hw=hw:
                      wa.fused_global_attention(qkv, bias, nh, scale, ws)))
        cases.append((f"SDPA {tag}", lambda q=q, k=k, v=v, am=am:
                      F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                     scale=scale)))
        if hw != 32:
            continue
        if hasattr(wa, "_launch_global"):
            _, st = wa._launch_global(qkv, bias, None, nh, scale, ws, True)
            cases.append((f"K8 keeping K10's statistics {tag}",
                          lambda qkv=qkv: wa._launch_global(
                              qkv, bias, None, nh, scale, ws, True)))
            cases.append((f"K10 on K8's statistics {tag}",
                          lambda qkv=qkv, gy=gy, st=st: wa.global_attention_bwd(
                              qkv, bias, nh, scale, gy, ws, stats=st)))
        cases.append((f"K10 {tag}", lambda qkv=qkv, gy=gy:
                      wa.global_attention_bwd(qkv, bias, nh, scale, gy, ws)))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=am,
                                             scale=scale)
        go = torch.ones_like(out)
        cases.append((f"SDPA backward {tag}", lambda out=out, go=go, qg=qg,
                      kg=kg, vg=vg: torch.autograd.grad(
                          out, (qg, kg, vg), go, retain_graph=True)))
    for label, fn in cases:
        row = {"case": label, "label": args.label, "card": name,
               **measure(fn, args.iters)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
