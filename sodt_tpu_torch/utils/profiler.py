"""Profiling (`sodt_tpu/utils/profiler.py`): timing, FLOPs, traces.

  * `flops_estimate(fn, *args)`: the FLOPs of one call, counted by
    `torch.utils.flop_counter.FlopCounterMode` (matmuls, convolutions,
    attention; element-wise work is not counted, where JAX's cost
    analysis of the lowered HLO counts it too). The counter does not see
    inside the hand-written kernels, which are extension calls: the
    callers count a model through its plain PyTorch versions, which the
    wrappers take for CPU tensors (`model_info` runs on a CPU copy);
  * `time_fn(fn, *args)`: the time of a call on the card by CUDA events,
    after `warmup` calls that are not timed (on the CPU, wall time);
  * `model_info(model)`: parameters and forward GFLOPs per image;
  * `trace(path)`: a `torch.profiler` session around a block, written as
    a Chrome trace.
"""

from __future__ import annotations

import contextlib
import copy
import time
from pathlib import Path
from typing import Callable

import torch


def flops_estimate(fn: Callable, *args) -> float | None:
    """FLOPs of fn(*args) by FlopCounterMode (None where counting fails)."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            fn(*args)
    except Exception:
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
