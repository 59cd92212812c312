#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sodt_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero without
the final ok line:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions
  2. build    nvcc builds the kernels of sodt_tpu_torch/csrc (seconds)
  3. kernels  each kernel vs its plain PyTorch version on the same bf16
              inputs at the shapes its path gives it (batch 2, and the
              paths' batch 4), max |diff| / max |ref| <= 2e-2, with the
              kernel's, the plain version's and (K1, K8) the library call's
              time
  4. main     `python -m sodt_tpu_torch.val --task val --synthetic
              --synthetic-n 8 --img-size 512 --batch-size 4` in-process
              (bf16, seeded weights), launch counts per forward K2 3, K3 3,
              K4 3, K5 4, K6 2, K7 2, K8 1; then raw Detect maps of one
              batch, bf16 kernels vs the f32 plain path on the same
              weights, relative L2 <= 2e-2
     608px    the same at 608 px (4 images): stage 2's 76x76 map takes the
              generic block path, K1 4 launches per forward, and stage 3
              pads into four windows for K8
  5. profile  torch.profiler over one warm eval step at the main path's
              shape: device-busy and idle share, the top 40 kernels by
              device time
  6. the {"kernels": [...]} line, the card line, the ok line.

Needs a CUDA card; exits 1 without one and 2 when the port is missing.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, published peak
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, published
KERNEL_TOL = 2e-2              # max |kernel - plain| / max |plain|, bf16
DETECT_REL_L2 = 2e-2           # ||raw_bf16 - raw_f32|| / ||raw_f32||
MAIN_ARGS = ["--task", "val", "--synthetic", "--synthetic-n", "8",
             "--img-size", "512", "--batch-size", "4"]
MAIN_BATCH = 4
# launches per forward on the main path (512 px): stage 1 K2 x3 + (K3, K4)
# x3; stage 2 K5 x4, K6 x2, K7 x2; stage 3 K8
PER_FORWARD = {"window_attention": 0, "swin_block": 3,
               "block_attention_ln": 3, "conv_mlp_tail": 3,
               "block_attention": 4, "mlp_tail": 2, "conv_mlp_tail_noln": 2,
               "global_attention": 1}
# the off-window path (608 px): stage 2's 76x76 map is no multiple of the
# window, so its four blocks take the generic composition with the K1 core;
# stage 3's 38x38 map pads to four 32x32 windows for K8
OFF_ARGS = ["--task", "val", "--synthetic", "--synthetic-n", "4",
            "--img-size", "608", "--batch-size", "4"]
OFF_FORWARD = dict(PER_FORWARD, window_attention=4, block_attention=0,
                   mlp_tail=0, conv_mlp_tail_noln=0)
# counter name -> (tag, source, TPU kernel it replaces, path whose run
# counts its launches)
TPU_KERNEL = {
    "window_attention": ("K1", "sodt_tpu_torch/csrc/block_attention.cu",
                         "sodt_tpu/pallas/window_attention.py:378", "608px"),
    "swin_block": ("K2", "sodt_tpu_torch/csrc/swin_block.cu",
                   "sodt_tpu/pallas/swin_block.py:93", "main"),
    "block_attention_ln": ("K3", "sodt_tpu_torch/csrc/swin_block.cu",
                           "sodt_tpu/pallas/window_attention.py:690", "main"),
    "conv_mlp_tail": ("K4", "sodt_tpu_torch/csrc/swin_block.cu",
                      "sodt_tpu/pallas/swin_block.py:329", "main"),
    "block_attention": ("K5", "sodt_tpu_torch/csrc/block_attention.cu",
                        "sodt_tpu/pallas/window_attention.py:491", "main"),
    "mlp_tail": ("K6", "sodt_tpu_torch/csrc/mlp_tail.cu",
                 "sodt_tpu/pallas/swin_block.py:544", "main"),
    "conv_mlp_tail_noln": ("K7", "sodt_tpu_torch/csrc/conv_mlp_tail.cu",
                           "sodt_tpu/pallas/swin_block.py:622", "main"),
    "global_attention": ("K8", "sodt_tpu_torch/csrc/global_attention.cu",
                         "sodt_tpu/pallas/window_attention.py:941", "main"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------------ kernels

def _cast(args, dt):
    """The same inputs, bf16 tensors upcast to dt (f32 for the reference)."""
    import torch
    return tuple(a.to(dt) if isinstance(a, torch.Tensor)
                 and a.dtype == torch.bfloat16 else a for a in args)


def kernel_cases(batch: int) -> list[dict]:
    """Every kernel call shape of one flagship forward at 512 px, and K1's
    at 608 px: the kernel and its plain version on the same arguments, the
    bytes and operations the function needs, its calls per forward of its
    path, and (K1, K8) one library call computing the same function."""
    import torch
    import torch.nn.functional as F
    from sodt_tpu_torch.kernels import window_attention as wa
    from sodt_tpu_torch.kernels import swin_block as sb
    from sodt_tpu_torch.models.swin import shift_attn_mask

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(0)

    def rnd(shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)

    def ln(c):
        return (1 + rnd((c,), 0.1, torch.float32), rnd((c,), 0.1, torch.float32))

    def msk(hw, ws, shift):
        return (torch.from_numpy(shift_attn_mask(hw, hw, ws, shift)).to("cuda")
                if shift else None)

    cases = []

    def case(name, shape, kern, plain, args, nb, fl, calls, lib=None):
        cases.append(dict(name=name, shape=shape, kern=kern, plain=plain,
                          args=args, nbytes=nb, flops=fl, calls=calls,
                          lib=lib))

    nh, ws, n = 12, 8, 64
    # stage 1 (c 192): K2 for blocks 0/2/4, K3 + K4 (shift 2) for 1/3/5
    hw, c = 128, 192
    m = batch * hw * hw
    x = rnd((batch, hw, hw, c))
    att = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.1),
           rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    lin = (rnd((4 * c, c), c ** -0.5), rnd((4 * c,), 0.1),
           rnd((c, 4 * c), (4 * c) ** -0.5), rnd((c,), 0.1))
    conv = (rnd((c, c), c ** -0.5), rnd((c,), 0.1),
            rnd((c, 2, 2, c), (4 * c) ** -0.5), rnd((c,), 0.1),
            rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    bias = rnd((nh, n, n), 1.0, torch.float32)
    ln1, ln2 = ln(c), ln(c)
    scale = (c // nh) ** -0.5
    case("swin_block", f"({batch},{hw},{hw},{c}) shift 0",
         sb.fused_swin_block, sb.swin_block_plain,
         (x, *ln1, *att, *ln2, *lin, bias, None, ws, nh, scale, 0),
         nbytes(x, *ln1, *att, *ln2, *lin, bias) + nbytes(x),
         m * (24 * c * c + 4 * n * c), 3)
    mask = msk(hw, ws, 2)
    case("block_attention_ln", f"({batch},{hw},{hw},{c}) shift 2",
         wa.fused_block_attention_ln, wa.block_attention_ln_plain,
         (x, *ln1, *att, bias, mask, ws, nh, scale, 2),
         nbytes(x, *ln1, *att, bias, mask) + nbytes(x),
         m * (8 * c * c + 4 * n * c), 3)
    a = rnd((batch, hw, hw, c))
    case("conv_mlp_tail", f"({batch},{hw},{hw},{c}) shift 2",
         sb.fused_conv_mlp_tail, sb.conv_mlp_tail_plain,
         (x, a, *ln2, *conv, 2), nbytes(x, a, *ln2, *conv) + nbytes(x),
         12 * m * c * c, 3)

    # stage 2 (c 384): the LN-outside split, K5 + K6 / K7
    hw, c = 64, 384
    m = batch * hw * hw
    x = rnd((batch, hw, hw, c))
    wts = (rnd((3 * c, c), c ** -0.5), rnd((3 * c,), 0.1),
           rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    for shift in (0, 2):
        mask = msk(hw, ws, shift)
        case("block_attention", f"({batch},{hw},{hw},{c}) shift {shift}",
             wa.fused_block_attention, wa.block_attention_plain,
             (x, *wts, bias, mask, ws, nh, (c // nh) ** -0.5, shift),
             nbytes(x, *wts, bias, mask) + nbytes(x),
             m * (8 * c * c + 4 * n * c), 2)
    r, y = rnd((batch, hw, hw, c)), rnd((batch, hw, hw, c))
    hid = 4 * c
    w6 = (rnd((hid, c), c ** -0.5), rnd((hid,), 0.1),
          rnd((c, hid), hid ** -0.5), rnd((c,), 0.1))
    case("mlp_tail", f"({batch},{hw},{hw},{c}) hidden {hid}",
         sb.fused_mlp_tail, sb.mlp_tail_plain, (r, y, *w6),
         nbytes(r, y, *w6) + nbytes(r), 4 * m * c * hid, 2)
    w7 = (rnd((c, c), c ** -0.5), rnd((c,), 0.1),
          rnd((c, 2, 2, c), (4 * c) ** -0.5), rnd((c,), 0.1),
          rnd((c, c), c ** -0.5), rnd((c,), 0.1))
    case("conv_mlp_tail_noln", f"({batch},{hw},{hw},{c})",
         sb.fused_conv_mlp_tail_noln, sb.conv_mlp_tail_noln_plain,
         (r, y, *w7), nbytes(r, y, *w7) + nbytes(r), 12 * m * c * c, 2)

    # K1 on the 608 px path: stage 2's 76x76 map padded to 80x80, blocks
    # 0/2 unshifted, 1/3 shifted (masked)
    hw = 80
    qkv = rnd((batch, hw, hw, 3 * c))
    scale = (c // nh) ** -0.5
    nw = (hw // ws) ** 2
    heads = (qkv.reshape(batch, hw // ws, ws, hw // ws, ws, 3, nh, c // nh)
             .permute(5, 0, 1, 3, 6, 2, 4, 7)
             .reshape(3, batch * nw, nh, n, c // nh))
    q1, k1, v1 = (t.contiguous() for t in heads)
    for shift in (0, 2):
        mask = msk(hw, ws, shift)
        full = bias[None].repeat(nw, 1, 1, 1)
        if mask is not None:
            full = full + mask[:, None]
        am = full.to(bf).repeat(batch, 1, 1, 1)
        case("window_attention", f"({batch},{hw},{hw},{3 * c}) shift {shift}",
             wa.fused_window_attention_nhwc, wa.reference_attention_nhwc,
             (qkv, bias, mask, ws, nh, scale),
             nbytes(qkv, bias, mask) + nbytes(qkv) // 3,
             4 * batch * hw * hw * n * c, 2,
             lambda am=am, scale=scale: F.scaled_dot_product_attention(
                 q1, k1, v1, attn_mask=am, scale=scale))

    # stage 3: one 32x32 window, K8
    c, hw = 768, 32
    n = hw * hw
    qkv = rnd((batch, hw, hw, 3 * c))
    bias = rnd((nh, n, n), 1.0, torch.float32)
    scale = (c // nh) ** -0.5
    heads = qkv.reshape(batch, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous() for t in heads)
    mask_bf = bias.to(bf)[None]
    case("global_attention", f"({batch},{hw},{hw},{3 * c}) N {n}",
         wa.fused_global_attention, wa.global_attention_plain,
         (qkv, bias, nh, scale), nbytes(qkv, bias) + nbytes(qkv) // 3,
         4 * batch * n * n * c, 1,
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask_bf,
                                                scale=scale))
    return cases


def phase_kernels(batch: int) -> list[dict]:
    import torch
    rows = []
    for cs in kernel_cases(batch):
        args = cs["args"]
        out = cs["kern"](*args)
        ref = cs["plain"](*_cast(args, torch.float32)).float()
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = time_ms(lambda: cs["kern"](*args))
        pms = time_ms(lambda: cs["plain"](*args))
        lms = time_ms(cs["lib"]) if cs["lib"] is not None else None
        bms, by = bound_ms(cs["nbytes"], cs["flops"])
        row = {"phase": "kernel", "name": cs["name"], "shape": cs["shape"],
               "batch": batch, "calls_per_forward": cs["calls"],
               "max_abs_err": err, "rel_err": rel, "tol": KERNEL_TOL,
               "ms": ms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": bms, "bound_by": by,
               "ok": bool(math.isfinite(rel) and rel <= KERNEL_TOL)}
        emit(row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------- main path

def phase_path(label: str, args: list[str], expected: dict) -> dict:
    """Drive `sodt_tpu_torch.val` in-process with the launch counts set to
    0 just before and read just after; then hold the raw Detect maps of one
    batch, bf16 kernels vs the f32 plain path on the same weights."""
    import torch
    from sodt_tpu_torch import kernels, val
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches

    opt = val.parser().parse_args(args)
    n_img, img_size, bs = opt.synthetic_n, opt.img_size, opt.batch_size
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = val.main(args)
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    forwards = math.ceil(n_img / bs)
    per_fwd = {k: v / forwards for k, v in counts.items()}
    finite = all(math.isfinite(m[k]) for k in ("map50", "map", "speed_ms"))

    ds = SyntheticVedai(n=bs, img_size=img_size, nc=8, seed=1)
    batch = next(make_eval_batches(ds, bs))
    img = torch.from_numpy(batch["img"]).cuda().float() / 255
    ir = torch.from_numpy(batch["ir"]).cuda().float() / 255
    raws = {}
    for dt in (torch.bfloat16, torch.float32):
        model = build_model("configs/model.yaml", ch_in=4, dtype=dt)
        model = cache_rel_bias(init_weights(model, 0).cuda().eval())
        with torch.no_grad():
            raws[dt] = model(img, ir)["raw"][0].float()
    a, b = raws[torch.bfloat16], raws[torch.float32]
    rel_l2 = ((a - b).norm() / b.norm()).item()
    g = img_size // 4
    ok = (per_fwd == {k: float(v) for k, v in expected.items()}
          and finite and bool(torch.isfinite(a).all())
          and tuple(a.shape) == (bs, g, g, 3, 13)
          and m["seen"] == n_img and rel_l2 <= DETECT_REL_L2)
    row = {"phase": label, "args": args, "wall_s": wall,
           "images_per_s": m["images_per_s"], "speed_ms": m["speed_ms"],
           "map50": m["map50"], "map": m["map"], "seen": m["seen"],
           "launches": counts, "launches_per_forward": per_fwd,
           "expected_per_forward": expected,
           "detect_rel_l2_bf16_vs_f32": rel_l2, "rel_l2_bound": DETECT_REL_L2,
           "raw_shape": list(a.shape), "ok": bool(ok)}
    emit(row)
    return row


def phase_profile() -> None:
    """Kernel-time breakdown of one warm eval step (forward + decode + NMS)
    at the main path's shape."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.weights import init_weights
    from sodt_tpu_torch.train.evaluate import cache_rel_bias, make_eval_step

    model = build_model("configs/model.yaml", ch_in=4, dtype=torch.bfloat16)
    model = cache_rel_bias(init_weights(model, 0).cuda().eval())
    step = make_eval_step(model)
    x = torch.randint(0, 255, (MAIN_BATCH, 512, 512, 3), dtype=torch.uint8,
                      device="cuda")
    for _ in range(2):
        step(x, x)
    torch.cuda.synchronize()
    fwd = lambda: model(x.float() / 255, x.float() / 255)
    with torch.no_grad():
        fwd_ms = time_ms(fwd, iters=5, warmup=1)
    step_ms = time_ms(lambda: step(x, x), iters=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        if dev and e.key and not e.key.startswith(("aten::", "cuda", "Memcpy")):
            rows.append({"kernel": e.key[:120], "device_ms": dev / 1e3,
                         "count": e.count})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    ours = sum(r["device_ms"] for r in rows if "sodt::" in r["kernel"])
    # idle share against the unprofiled step time (the profiler's own host
    # overhead stretches the profiled wall)
    out = {"phase": "profile", "batch": MAIN_BATCH, "img": 512,
           "forward_ms": fwd_ms, "eval_step_ms": step_ms,
           "profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
           "port_kernels_ms": ours,
           "idle_share": max(0.0, 1 - busy / step_ms),
           "top": rows[:40]}
    emit(out)


# --------------------------------------------------------------------- main

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    try:
        import sodt_tpu_torch  # noqa: F401
        from sodt_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    failed = []
    card = card_line()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    rows = []
    for batch in (2, MAIN_BATCH):
        try:
            rows += phase_kernels(batch)
        except Exception:
            traceback.print_exc()
            failed.append(f"kernels batch {batch}")
    failed += [f"{r['name']} {r['shape']}" for r in rows if not r["ok"]]
    paths = {}
    for label, args, expected in (("main", MAIN_ARGS, PER_FORWARD),
                                  ("608px", OFF_ARGS, OFF_FORWARD)):
        try:
            paths[label] = phase_path(label, args, expected)
            if not paths[label]["ok"]:
                failed.append(f"{label} path")
        except Exception:
            traceback.print_exc()
            failed.append(f"{label} path")
            paths[label] = {"launches": {}}
    try:
        phase_profile()
    except Exception:
        traceback.print_exc()
        failed.append("profile")

    # per-forward totals at the main path's batch: the sum over one
    # forward's calls of each kernel on its path (calls_per_forward of each
    # shape); launches as counted on that path's run
    entries = []
    for name, (tag, src, tpu, path) in TPU_KERNEL.items():
        mine = [r for r in rows if r["name"] == name and r["batch"] == MAIN_BATCH]
        tot = lambda key: (sum(r["calls_per_forward"] * r[key] for r in mine)
                           if mine and all(r[key] is not None for r in mine)
                           else None)
        entries.append({
            "name": f"{tag} {name}", "route": "cuda", "source": src,
            "replaces": tpu, "path": path,
            "launches": paths[path]["launches"].get(name, 0),
            "max_abs_err": max((r["max_abs_err"] for r in mine), default=None),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": (max(mine, key=lambda r: r["bound_ms"])["bound_by"]
                         if mine else None),
            "library_ms": tot("library_ms")})
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
