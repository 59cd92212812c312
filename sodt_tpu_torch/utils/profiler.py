"""Profiling (`sodt_tpu/utils/profiler.py`): timing, FLOPs, traces.

  * `flops_estimate(fn, *args)`: the FLOPs of one call, counted by
    `torch.utils.flop_counter.FlopCounterMode` (matmuls, convolutions,
    attention; element-wise work is not counted, where JAX's cost
    analysis of the lowered HLO counts it too). fn runs under no_grad: a
    function that differentiates (a training step) turns grad mode on
    itself, and its backward is counted with its forward. A count that
    fails returns None and warns with its cause. The counter does not see
    inside the hand-written kernels, which are extension calls: the
    callers count a model through its plain PyTorch versions, which the
    wrappers take for CPU tensors (`model_info` runs on a CPU copy);
  * `time_fn(fn, *args)`: the time of a call on the card by CUDA events,
    after `warmup` calls that are not timed (on the CPU, wall time);
  * `model_info(model)`: parameters and forward GFLOPs per image;
  * `trace(path)`: a `torch.profiler` session around a block, written as
    a Chrome trace;
  * the breakdown of a trace by kernel (`tools/profile_eval.py` of the
    JAX system): `device_rows(prof)` (a session's device kernels) or
    `trace_kernels(chrome_trace)` (the kernel events of an exported
    trace) -> `breakdown(rows, iters)`: device ms an iteration, the
    largest categories (`kernel_category`: the name with its template
    arguments, parameter list and numeric suffix collapsed) and the
    largest kernels, each with its share; `format_breakdown` prints it.
    `tools/profile_eval.py` and chip_smoke's profile phases share them.
"""

from __future__ import annotations

import contextlib
import copy
import re
import time
import warnings
from pathlib import Path
from typing import Callable

import torch


def flops_estimate(fn: Callable, *args) -> float | None:
    """FLOPs of fn(*args) by FlopCounterMode (None where counting fails,
    with a warning that names the cause)."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            fn(*args)
    except Exception as e:
        warnings.warn(f"flops_estimate: the count failed: {e!r}")
        return None
    return float(fc.get_total_flops())


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> dict:
    """Seconds per call of fn(*args) after `warmup` untimed calls: CUDA
    events around `iters` calls where the first tensor argument is on the
    card, else the wall clock."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1000 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return {"seconds": dt, "iters": iters, "timer": "cuda_events" if cuda
            else "wall"}


def model_info(model: torch.nn.Module, img_size: int = 512, batch: int = 1,
               ch: int = 3) -> dict:
    """Parameters (their count and millions) and forward GFLOPs per image
    at img_size of a DetectionModel, the FLOPs counted on an f32 CPU copy
    in eval mode (the plain versions of the kernels: the counter cannot
    see into an extension call)."""
    n_params = sum(p.numel() for p in model.parameters())
    cpu = copy.deepcopy(model).to("cpu").float().eval()
    cpu.dtype = torch.float32           # the compute dtype of every layer
    x = torch.zeros((batch, img_size, img_size, ch))
    flops = flops_estimate(lambda a, b: cpu(a, b), x, x)
    info = {"params": n_params, "params_m": n_params / 1e6}
    if flops:
        info["gflops"] = flops / 1e9 / batch
    return info


@contextlib.contextmanager
def trace(path: str | Path):
    """A torch.profiler session (CPU, and CUDA where a card is visible)
    around the block, written to `path` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


def device_rows(prof) -> list[dict]:
    """The device kernels of a torch.profiler session, largest first:
    {"kernel", "device_ms", "count"}. Host-side ops (an aten op, an
    autograd function) carry their kernels' time a second time and are
    left out, as are memory copies."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = getattr(e, "cuda_time_total", 0.0)
        if (dev and e.key and e.device_type == DeviceType.CUDA
                and not e.key.startswith("Memcpy")):
            rows.append({"kernel": e.key[:120], "device_ms": dev / 1e3,
                         "count": e.count})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def cpu_rows(prof) -> list[dict]:
    """The host ops of a CPU-only session by their own (self) time, in
    `device_rows`' form: what a CPU run has in place of kernels."""
    rows = [{"kernel": e.key[:120], "device_ms": e.self_cpu_time_total / 1e3,
             "count": e.count} for e in prof.key_averages()
            if e.self_cpu_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def trace_kernels(trace: dict) -> list[dict]:
    """The kernel events (`"cat": "kernel"`, complete events) of a Chrome
    trace as `torch.profiler` exports it, summed by name in
    `device_rows`' form."""
    ms: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e:
            name = e.get("name", "?")
            ms[name] = ms.get(name, 0.0) + e["dur"] / 1e3
            count[name] = count.get(name, 0) + 1
    rows = [{"kernel": k, "device_ms": v, "count": count[k]}
            for k, v in ms.items()]
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def kernel_category(name: str) -> str:
    """A kernel's name with its template arguments, parameter list and
    numeric suffix collapsed: `void sodt::layernorm_kernel<1, 2, 8>(...)`
    -> `sodt::layernorm_kernel`, `gemm_64x3_tn_17` -> `gemm_64x3_tn`."""
    s = name.strip().replace("(anonymous namespace)", "anon")
    s = s[len("void "):] if s.startswith("void ") else s
    s = re.split(r"[<(]", s, maxsplit=1)[0].strip()
    s = re.sub(r"_?\d+$", "", s.split(".")[0])
    return s or name


def breakdown(rows: list[dict], iters: int = 1, top_categories: int = 25,
              top_kernels: int = 40) -> dict:
    """Device ms an iteration of `rows` (over `iters` iterations), the
    `top_categories` largest categories and the `top_kernels` largest
    kernels, each {"name", "ms" (an iteration), "share", "count"}."""
    total = sum(r["device_ms"] for r in rows)
    cats: dict[str, list] = {}
    for r in rows:
        c = cats.setdefault(kernel_category(r["kernel"]), [0.0, 0])
        c[0] += r["device_ms"]
        c[1] += r["count"]

    def entry(name, ms, n):
        return {"name": name, "ms": ms / iters,
                "share": ms / total if total else 0.0, "count": n}
    by_cat = sorted(cats.items(), key=lambda kv: -kv[1][0])
    by_kernel = sorted(rows, key=lambda r: -r["device_ms"])
    return {"device_ms_per_iter": total / iters, "iters": iters,
            "categories": [entry(k, v[0], v[1])
                           for k, v in by_cat[:top_categories]],
            "kernels": [entry(r["kernel"], r["device_ms"], r["count"])
                        for r in by_kernel[:top_kernels]]}


def format_breakdown(b: dict, what: str = "device") -> str:
    """`breakdown`'s tables as the JAX tool prints them."""
    lines = [f"top kernel categories ({b['device_ms_per_iter']:.2f} ms/iter "
             f"on {what}):"]
    lines += [f"  {100 * e['share']:5.1f}%  {e['ms']:8.3f} ms  {e['name']}"
              for e in b["categories"]]
    lines += ["", "top individual kernels:"]
    lines += [f"  {100 * e['share']:5.1f}%  {e['ms']:8.3f} ms  {e['name']}"
              for e in b["kernels"]]
    return "\n".join(lines)
