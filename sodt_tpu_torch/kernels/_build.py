"""Build and bind the CUDA sources of `sodt_tpu_torch/csrc/`.

At first use every `*.cu` is compiled by its own `nvcc` process (all
started together) for `sm_90a` into an object file, and the objects are
linked into one shared library under `build/sodt_tpu_torch/` of the
checkout, named by a hash of the sources. The library has a plain C
interface and is bound with ctypes: `c_void_p` for every pointer and the
stream, `c_int` for ints, `c_float` for floats. Every entry returns
`cudaGetLastError()`; `check()` raises when it is not 0.

Beside them, `build_host()` compiles the host C++ of `csrc/*.cpp` (the tile
loader and the JPEG decoder: standard library only, no CUDA) with the host
compiler into `libsodt_tiles.so` under the same directory, named by a hash
of those sources and the flags; it needs no `nvcc`, so it builds on any
machine with `c++` or `g++`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sodt_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
# no -ffast-math or -march=native, and no fused multiply-add: the tile
# loader's area resize sums float32 products in OpenCV's order
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
              "-ffp-contract=off"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (see the .cu files)
SIGNATURES = {
    "sodt_block_attention_chain": [P] * 10 + [I] * 8 + [F, I, P],
    "sodt_window_attention": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, P],
    "sodt_gemm_core": [P] * 5 + [I] * 6 + [P],
    "sodt_global_attention": [P] * 6 + [I] * 7 + [F, P],
    "sodt_swin_block": [P] * 16 + [I] * 9 + [F, P],
    "sodt_swin_block_chain": [P] * 19 + [I] * 9 + [F, I, P],
    "sodt_block_attention_ln": [P] * 10 + [I] * 8 + [F, P],
    "sodt_block_attention_ln_chain": [P] * 12 + [I] * 8 + [F, I, P],
    "sodt_conv_tail_chain": [P] * 14 + [I] * 5 + [P],
    "sodt_window_attention_bwd": [P] * 7 + [I] * 7 + [F, I, P],
    "sodt_window_attention_bwd_regs": [P] * 7 + [I] * 7 + [F, I, P],
    "sodt_global_attention_bwd": [P] * 9 + [I] * 7 + [F, P],
    "sodt_window_attention_tokens": [P, P, P, P, I, I, I, I, I, F, I, P],
    "sodt_window_attention_tokens_bwd": [P] * 7 + [I] * 5 + [F, I, P],
    "sodt_layernorm": [P, P, P, P, I, I, F, P],
    "sodt_add_layernorm": [P, P, P, P, P, P, I, I, F, P],
    "sodt_swin_block_q8": [P] * 24 + [I] * 7 + [F, I, P],
    "sodt_block_attention_q8": [P] * 15 + [I] * 9 + [F, I, P],
    "sodt_conv_tail_q8": [P] * 17 + [I] * 7 + [P],
    "sodt_mlp_tail_q8": [P] * 13 + [I] * 6 + [P],
    "sodt_gemm_s8": [P] * 7 + [I] * 9 + [P],
    "sodt_q8_rowpass": [P] * 5 + [I] * 9 + [P],
}

_lib = None
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def cxx_path() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                       "tile loader builds with one")


def _host_hash() -> str:
    h = hashlib.sha256()
    for p in sorted([*CSRC.glob("*.cpp"), *CSRC.glob("*.h")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return h.hexdigest()[:16]


def build_host() -> Path:
    """Compile `csrc/*.cpp` into `libsodt_tiles.so` with the host compiler;
    returns its path (reused when the sources have not changed). Raises
    RuntimeError with the compiler's own words where it fails."""
    out_dir = BUILD_DIR / _host_hash()
    so = out_dir / "libsodt_tiles.so"
    if so.exists():
        return so
    cxx = cxx_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libsodt_tiles.{os.getpid()}.so"
    proc = subprocess.run(
        [cxx, *HOST_FLAGS, *map(str, sorted(CSRC.glob("*.cpp"))), "-o",
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cxx).name} failed:\n"
                           + proc.stdout.decode(errors="replace"))
    os.replace(tmp, so)
    return so


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path (reused when the sources have not changed)."""
    nvcc = nvcc_path()
    out_dir = BUILD_DIR / _source_hash()
    so = out_dir / "libsodt_kernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in srcs:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out_dir / f"libsodt_kernels.{os.getpid()}.so"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
