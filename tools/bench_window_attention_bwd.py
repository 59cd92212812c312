#!/usr/bin/env python3
"""Device times of K9 and K11's backward (the windowed-attention backward
on the map and on pre-partitioned windows) and of SDPA's backward on the
same inputs, on one CUDA card.

    python tools/bench_window_attention_bwd.py [--batch 4] [--iters 50]
        [--ctas 528 264 ...]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call: unpack it with
`git archive` under `build/`). For each case it prints one JSON line: the
device time per call summed over the CUDA kernels that torch.profiler
records (`device_us`, and by kernel name `kernels_us`), the CUDA-event
time of the whole call with its host work (`event_us`), and the card's
name and power limit (nvidia-smi).

Cases: the flagship training step's four shapes of K9 at 512 px, stage 1
(128 x 128 map, c 192, head dim 16) and stage 2 (64 x 64, c 384, head dim
32), 12 heads, window 8, without and with the shift mask; beside each,
SDPA's backward with the bias (+ mask) as a bf16 mask (no dbias). Then
K11's backward at the SwinV2 family's four stages at 512 px (1,024 / 256 /
64 / 16 windows of 64 tokens at batch 4, C 96 / 192 / 384 / 768, 3 / 6 /
12 / 24 heads, head dim 32, scale 1.0), unmasked and with a 0 / -100 mask
of the stage's windows, SDPA's backward beside each. `--ctas` times K9 and
K11 once for each value of `BWD_CTAS` (the CTAs a launch of the register
body aims at; a version without it is timed once). Needs a card; exits 1
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.append(".")  # the checkout, after any PYTHONPATH


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
    # CUPTI now and then hands a session no kernel record at all: such a
    # session is run again, three sessions at most (device_us 0 if all were)
    kernels, sessions = {}, 0
    while not kernels and sessions < 3:
        sessions += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if t > 0:
                kernels[e.key[:80]] = t / iters
    return {"event_us": event_us, "device_us": sum(kernels.values()),
            "kernels_us": kernels, "profiler_sessions": sessions}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ctas", type=int, nargs="*", default=[])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_window_attention_bwd: no CUDA card visible",
              file=sys.stderr)
        return 1
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.models.swin import shift_attn_mask

    name = card()
    tree = str(Path(wa.__file__).resolve().parents[2])
    b, nh, ws = args.batch, 12, 8
    n = ws * ws
    g = torch.Generator().manual_seed(0)

    def rnd(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to("cuda", dtype)

    bias = rnd((nh, n, n), torch.float32)
    ctas = (args.ctas or [None]) if hasattr(wa, "BWD_CTAS") else [None]
    default_ctas = getattr(wa, "BWD_CTAS", None)
    for hw, c in ((128, 192), (64, 384)):
        qkv, gy = rnd((b, hw, hw, 3 * c)), rnd((b, hw, hw, c))
        scale = (c // nh) ** -0.5
        nw = (hw // ws) ** 2
        heads = (qkv.reshape(b, hw // ws, ws, hw // ws, ws, 3, nh, c // nh)
                 .permute(5, 0, 1, 3, 6, 2, 4, 7)
                 .reshape(3, b * nw, nh, n, c // nh))
        q, k, v = (t.contiguous().requires_grad_() for t in heads)
        for shift in (0, 2):
            mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift))
                    .to("cuda") if shift else None)
            tag = f"({b},{hw},{hw},{3 * c}) shift {shift}"
            for ct in ctas:
                if ct is not None:
                    wa.BWD_CTAS = ct
                row = {"case": f"K9 {tag}", "ctas": ct or default_ctas,
                       "tree": tree, "label": args.label, "card": name,
                       **measure(lambda: wa.window_attention_bwd(
                           qkv, bias, mask, ws, nh, scale, gy), args.iters)}
                print(json.dumps(row), flush=True)
            if default_ctas is not None:
                wa.BWD_CTAS = default_ctas
            full = bias[None].repeat(nw, 1, 1, 1)
            if mask is not None:
                full = full + mask[:, None]
            am = full.to(torch.bfloat16).repeat(b, 1, 1, 1)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                 scale=scale)
            go = torch.ones_like(out)
            row = {"case": f"SDPA backward {tag}", "tree": tree,
                   "label": args.label, "card": name,
                   **measure(lambda: torch.autograd.grad(
                       out, (q, k, v), go, retain_graph=True), args.iters)}
            print(json.dumps(row), flush=True)
    for nw, c, nh2 in ((256, 96, 3), (64, 192, 6), (16, 384, 12),
                       (4, 768, 24)):
        w = b * nw
        qkv, gy = rnd((w, n, 3 * c)), rnd((w, n, c))
        bias2 = rnd((nh2, n, n), torch.float32)
        heads = qkv.reshape(w, n, 3, nh2, c // nh2).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous().requires_grad_() for t in heads)
        for masked in (False, True):
            mask = None
            if masked:
                mask = torch.where(rnd((nw, n, n), torch.float32) > 0.5,
                                   -100.0, 0.0)
                mask.diagonal(dim1=1, dim2=2).zero_()
            mnw = nw if masked else 1
            tag = f"({w},{n},{3 * c}) nh {nh2}" + (" masked" if masked
                                                   else "")
            for ct in ctas:
                if ct is not None:
                    wa.BWD_CTAS = ct
                row = {"case": f"K11 backward {tag}", "ctas": ct or default_ctas,
                       "tree": tree, "label": args.label, "card": name,
                       **measure(lambda: wa.window_attention_tokens_bwd(
                           qkv, bias2, mask, mnw, nh2, 1.0, gy), args.iters)}
                print(json.dumps(row), flush=True)
            if default_ctas is not None:
                wa.BWD_CTAS = default_ctas
            full = bias2[None].repeat(nw, 1, 1, 1)
            if mask is not None:
                full = full + mask[:, None]
            am = full.to(torch.bfloat16).repeat(b, 1, 1, 1)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                 scale=1.0)
            go = torch.ones_like(out)
            row = {"case": f"SDPA backward {tag}", "tree": tree,
                   "label": args.label, "card": name,
                   **measure(lambda: torch.autograd.grad(
                       out, (q, k, v), go, retain_graph=True), args.iters)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
