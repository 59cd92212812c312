"""Hand-written Hopper kernels of the port and their launch counters.

Each `sodt_tpu/pallas` kernel on the main path has here a wrapper that
launches a CUDA C++ kernel (sources in `sodt_tpu_torch/csrc/`, built with
nvcc at first use by `_build.py`) for a tensor on the card, and takes the
plain PyTorch version beside it for a tensor on the CPU. A wrapper adds one
to `LAUNCHES[name]` where it launches its kernel, and nowhere else.

`int8_serving()` is the int8 serving mode (K12, `sodt_tpu.pallas
.int8_serving`): inside it the block dispatch takes JAX's int8 gate, on any
device, and the five fused block wrappers run their int8 bodies (the
`*_q8` counters). It is read at each forward.
"""

from __future__ import annotations

import contextlib

_int8 = False

LAUNCHES: dict[str, int] = {
    "window_attention": 0,      # K1, window_attention.fused_window_attention_nhwc
    "swin_block": 0,            # K2, swin_block.fused_swin_block
    "block_attention_ln": 0,    # K3, window_attention.fused_block_attention_ln
    "conv_mlp_tail": 0,         # K4, swin_block.fused_conv_mlp_tail
    "block_attention": 0,       # K5, window_attention.fused_block_attention
    "mlp_tail": 0,              # K6, swin_block.fused_mlp_tail
    "conv_mlp_tail_noln": 0,    # K7, swin_block.fused_conv_mlp_tail_noln
    "global_attention": 0,      # K8, window_attention.fused_global_attention
    "window_attention_bwd": 0,  # K9, window_attention.window_attention_bwd
    "global_attention_bwd": 0,  # K10, window_attention.global_attention_bwd
    # K11, window_attention.fused_window_attention and its backward,
    # window_attention.window_attention_tokens_bwd
    "window_attention_tokens": 0,
    "window_attention_tokens_bwd": 0,
    "layernorm": 0,             # K13, layernorm.layernorm
    "add_layernorm": 0,         # K13, layernorm.add_layernorm
    # K12, the int8 bodies of K2-K7 (`int8=True` on their wrappers)
    "swin_block_q8": 0,
    "block_attention_ln_q8": 0,
    "conv_mlp_tail_q8": 0,
    "block_attention_q8": 0,
    "mlp_tail_q8": 0,
    "conv_mlp_tail_noln_q8": 0,
}


def int8_enabled() -> bool:
    """True inside `int8_serving()`."""
    return _int8


@contextlib.contextmanager
def int8_serving():
    """Quantized-GEMM serving mode within the context: bf16 blocks on JAX's
    megakernel gate run the int8 bodies, whose backward replays the bf16
    composition (do not train in this mode)."""
    global _int8
    prev = _int8
    _int8 = True
    try:
        yield
    finally:
        _int8 = prev


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)
