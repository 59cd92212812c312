#!/usr/bin/env python3
"""Device times of the windowed-attention forward (K1, K5's core, K11's
forward) and of SDPA's forward on the same inputs, on one CUDA card.

    python tools/bench_window_attention_fwd.py [--batch 4] [--iters 50]
        [--ctas 528 396 ...] [--label NAME]

Run from the root of a checkout (or with PYTHONPATH pointing at one, to
time another version of `sodt_tpu_torch` in the same call: unpack it with
`git archive` under `build/`). For each case it prints one JSON line, as
`tools/bench_window_attention_bwd.py` does: the device time per call
summed over the CUDA kernels that torch.profiler records (`device_us`, and
by kernel name `kernels_us`), the CUDA-event time of the whole call with
its host work (`event_us`), and the card's name and power limit.

Cases, 12 heads and window 8 unless stated: K1 at the flagship training
step's four shapes at 512 px (stage 1, 128 x 128, c 192, head dim 16;
stage 2, 64 x 64, c 384, head dim 32; each without and with the shift
mask) and at the 608 px path's two (80 x 80, c 384); K5's core at stage 2
with the shift (`_window_core`, read at ((r + 2) mod H, (c + 2) mod W)),
with the mask; K11's forward at the SwinV2 family's eight (1,024, 256, 64
and 16 windows of 64 tokens at batch 4, c 96 / 192 / 384 / 768, 3 / 6 /
12 / 24 heads, scale 1.0, each without and with the mask). Beside each,
SDPA's forward with the bias (+ mask) as a bf16 attn_mask. `--ctas` times
the kernels once for each value of `FWD_CTAS` (the CTAs a launch of the
register body aims at; a version without it is timed once). Needs a card;
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
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ctas", type=int, nargs="*", default=[])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_window_attention_fwd: no CUDA card visible",
              file=sys.stderr)
        return 1
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.models.swin import shift_attn_mask

    name = card()
    tree = str(Path(wa.__file__).resolve().parents[2])
    b, ws, n = args.batch, 8, 64
    g = torch.Generator().manual_seed(0)

    def rnd(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to("cuda", dtype)

    default_ctas = getattr(wa, "FWD_CTAS", None)
    ctas = (args.ctas or [None]) if default_ctas is not None else [None]

    def emit(case, fn, q, k, v, am, scale):
        """The kernel call `fn` (once per `--ctas` value), then SDPA's
        forward on q, k, v with the additive mask am."""
        for ct in ctas:
            if ct is not None:
                wa.FWD_CTAS = ct
            print(json.dumps({"case": case, "ctas": ct or default_ctas,
                              "tree": tree, "label": args.label, "card": name,
                              **measure(fn, args.iters)}), flush=True)
        if default_ctas is not None:
            wa.FWD_CTAS = default_ctas
        print(json.dumps({"case": "SDPA forward " + case.split(" ", 1)[1],
                          "tree": tree, "label": args.label, "card": name,
                          **measure(lambda: F.scaled_dot_product_attention(
                              q, k, v, attn_mask=am, scale=scale),
                              args.iters)}), flush=True)

    def map_heads(qkv, hw, c, nh):
        """(B, H, W, 3C) -> q, k, v (B * nW, nh, N, hd), windows in order."""
        nw = (hw // ws) ** 2
        h = (qkv.reshape(b, hw // ws, ws, hw // ws, ws, 3, nh, c // nh)
             .permute(5, 0, 1, 3, 6, 2, 4, 7)
             .reshape(3, b * nw, nh, n, c // nh))
        return [t.contiguous() for t in h]

    def attn_mask(bias, mask, nw, images):
        full = bias[None].repeat(nw, 1, 1, 1)
        if mask is not None:
            full = full + mask[:, None]
        return full.to(torch.bfloat16).repeat(images, 1, 1, 1)

    nh = 12
    bias = rnd((nh, n, n), torch.float32)
    for hw, c in ((128, 192), (64, 384), (80, 384)):
        qkv = rnd((b, hw, hw, 3 * c))
        q, k, v = map_heads(qkv, hw, c, nh)
        scale = (c // nh) ** -0.5
        nw = (hw // ws) ** 2
        for shift in (0, 2):
            mask = (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift))
                    .to("cuda") if shift else None)
            am = attn_mask(bias, mask, nw, b)
            tag = f"({b},{hw},{hw},{3 * c}) mask {int(mask is not None)}"
            emit(f"K1 {tag}", lambda: wa.fused_window_attention_nhwc(
                qkv, bias, mask, ws, nh, scale), q, k, v, am, scale)
            if hw == 64 and shift:
                # K5's core reads the unrolled map at its shifted positions
                rolled = torch.roll(qkv, (-shift, -shift), (1, 2))
                q5, k5, v5 = map_heads(rolled, hw, c, nh)
                emit(f"K5core ({b},{hw},{hw},{3 * c}) shift {shift} mask 1",
                     lambda: wa._window_core(qkv, bias, mask, ws, nh, scale,
                                             shift, "bench"),
                     q5, k5, v5, am, scale)

    for nw, c, nh in ((256, 96, 3), (64, 192, 6), (16, 384, 12),
                      (4, 768, 24)):
        w = b * nw
        qkv = rnd((w, n, 3 * c))
        bias2 = rnd((nh, n, n), torch.float32)
        q, k, v = (t.contiguous() for t in
                   qkv.reshape(w, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4))
        side = int(nw ** 0.5) * ws
        for shift in (0, 4):
            mask = (torch.from_numpy(shift_attn_mask(side, side, ws, shift))
                    .to("cuda") if shift else None)
            am = attn_mask(bias2, mask, nw, b)
            mnw = nw if shift else 1
            emit(f"K11 ({w},{n},{3 * c}) nh {nh} mask {int(mask is not None)}",
                 lambda: wa.fused_window_attention(qkv, bias2, mask, mnw, nh,
                                                   1.0),
                 q, k, v, am, 1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
