#!/usr/bin/env python3
"""Host times of the port's tile loader (`sodt_tpu_torch/csrc/tile_loader.cpp`
with its PNG, JPEG, BMP and TIFF decoders) on 1024 px pairs.

    python tools/bench_host_decode.py [--reps 3] [--label x]

Run from the root of a checkout, or with PYTHONPATH pointing at another one
to time that version (unpack it with `git archive` under `build/`); runs of
two versions alternated in one call compare them. The pairs are
`SyntheticVedai(n=4, img_size=1024, seed=5)`'s, written by the port's own
writers: PNG, baseline JPEG (PIL's defaults, chip_smoke's `jpeg` files),
24-bit / 8-bit BMP, TIFF deflated with predictor 2 in 64 x 128 tiles
(chip_smoke's `bmp_tiff` files). For each format it times
`NativeTileLoader.get` of one pair at 1024 px with the cache off (decode and
copy, no resize), `reps` passes over the pairs on the loader's pool and
`reps` with the process held to one core. Prints one JSON line: the label,
the host library it built and the seconds the build took, per format every
time and the medians (ms a pair), and the card's name and power limit where
`nvidia-smi` runs. Needs a C++ compiler, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.append(".")  # the checkout, after any PYTHONPATH

SIDE, PAIRS = 1024, 4


def _write_pairs(root: Path) -> dict:
    """format -> (rgb paths, ir paths) of the same pairs."""
    from sodt_tpu_torch.data import SyntheticVedai
    from sodt_tpu_torch.data.bmp import write_bmp
    from sodt_tpu_torch.data.jpeg import write_jpeg
    from sodt_tpu_torch.data.png import write_png
    from sodt_tpu_torch.data.tiff import write_tiff

    writers = {"png": write_png, "jpg": write_jpeg, "bmp": write_bmp,
               "tif": lambda p, a: write_tiff(p, a, compression="deflate",
                                              predictor=2, tile=(64, 128))}
    src = SyntheticVedai(n=PAIRS, img_size=SIDE, nc=8, seed=5)
    files = {ext: ([], []) for ext in writers}
    for i in range(PAIRS):
        rgb, ir, _ = src[i]
        for ext, write in writers.items():
            co, gray = root / f"{i}_co.{ext}", root / f"{i}_ir.{ext}"
            write(co, rgb)
            write(gray, ir[..., 0])
            files[ext][0].append(str(co))
            files[ext][1].append(str(gray))
    return files


def _pass_ms(rgb: list, ir: list) -> list:
    """ms of `get` for each pair, on a fresh loader with the cache off."""
    from sodt_tpu_torch.data import native_loader
    loader = native_loader.NativeTileLoader(rgb, ir, SIDE, cache_gb=0.0)
    out = []
    try:
        for i in range(len(rgb)):
            t = time.perf_counter()
            loader.get(np.array([i]))
            out.append(1e3 * (time.perf_counter() - t))
    finally:
        loader.close()
    return out


def _card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    from sodt_tpu_torch.data import native_loader
    from sodt_tpu_torch.kernels import _build

    t = time.perf_counter()
    so = _build.build_host()
    out = {"label": args.label, "library": str(so),
           "build_s": time.perf_counter() - t, "card": _card()}
    if native_loader.load_error() is not None:
        raise RuntimeError(native_loader.load_error())
    with tempfile.TemporaryDirectory() as tmp:
        for ext, (rgb, ir) in _write_pairs(Path(tmp)).items():
            pool = [m for _ in range(args.reps) for m in _pass_ms(rgb, ir)]
            # the loader's threads take the mask of the thread that made them
            mask = os.sched_getaffinity(0)
            os.sched_setaffinity(0, {min(mask)})
            try:
                one = [m for _ in range(args.reps)
                       for m in _pass_ms(rgb, ir)]
            finally:
                os.sched_setaffinity(0, mask)
            out[ext] = {"pool_ms": pool, "one_core_ms": one,
                        "pool_median": float(np.median(pool)),
                        "one_core_median": float(np.median(one))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
