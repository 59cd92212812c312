"""Swin windowed-attention blocks, NHWC (`sodt_tpu/models/swin.py`).

Window partition/unpartition, the shifted-window mask (value -100), the
relative-position index, W-MSA with a rel-pos bias materialized once per
weight load, the dual-mode MLP (linear, or fc1 -> 2x2 conv with the zero
pad on fc1's output -> fc2), PatchMerging and PatchEmbed.

`swin_block_forward` holds the port's whole block dispatch in one place.
On a CUDA bf16 tensor with a windowed shape (H, W multiples of the window)
it runs the megakernels where c <= 256 (K2 for a linear-MLP block, K3 + K4
for a conv-MLP block) and the LN-outside split elsewhere (LN1 -> K5 with
the shift folded in -> un-roll -> add+LN2 -> K6 or K7). Every other shape
takes the composition of JAX's generic path, whose attention core goes to
K1 (windows of up to 256 tokens) or K8 (larger windows) on the card.

Inside `kernels.int8_serving()` a bf16 block takes JAX's int8 gate
exactly, on any device (`sodt_tpu/models/swin.py` l.333-412): windows of
at most 256 tokens on a map of whole windows; at c <= 256 the unshifted
linear-MLP block runs K2's int8 body and a conv-MLP block K3's + K4's, at
c > 256 the LN-outside split with K5's and K6's / K7's; every other block
(a shifted linear-MLP block at c <= 256 among them) takes the generic
composition, un-quantized, as in JAX. On the CPU the int8 wrappers run
their plain int8 bodies.

Inside `kernels.no_kernels()` (or with SODT_NO_KERNELS set) every block
takes the generic composition, whose attention core and LayerNorms are
then the plain versions too (`sodt_tpu/models/swin.py` l.333 consults
`kernels_enabled()` the same way): JAX's composition on any device, no
kernel launched, int8 serving off.
"""


from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .norm import LayerNorm, AddLayerNorm
from ..ops.activations import gelu
from ..kernels import int8_enabled, kernels_enabled
from ..kernels import window_attention as kwa
from ..kernels.quant import q8_weights
from ..kernels.layernorm import layernorm as layer_norm
from ..kernels import swin_block as ksb


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C). H, W must be multiples of ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_unpartition(windows: torch.Tensor, ws: int,
                       hw: tuple[int, int]) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA additive mask (nW, ws*ws, ws*ws), values {0, -100}."""
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // ws, ws, w // ws, ws)
    m = m.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def _mask_tensor(h: int, w: int, ws: int, shift: int,
                 device: torch.device) -> torch.Tensor:
    # non_blocking: a copy from host memory with no wait on the stream
    return torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(
        device, non_blocking=True)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """x @ W^T + b in x's dtype (flax nn.Dense with `dtype`)."""
    dt = x.dtype
    y = torch.matmul(x, layer.weight.to(dt).t())
    return y + layer.bias.to(dt) if layer.bias is not None else y


class Conv(nn.Module):
    """NHWC convolution with an OIHW weight (flax nn.Conv with `dtype`):
    input and weight are cast to the input's dtype. `k`, `s` and `p` are
    ints or (h, w) pairs; `g` groups the channels (flax
    `feature_group_count`: the weight is (c2, c1 // g, kh, kw))."""

    def __init__(self, c1: int, c2: int, k=1, s=1, p=0, bias: bool = True,
                 g: int = 1):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.stride, self.padding, self.groups = s, p, g
        self.weight = nn.Parameter(torch.zeros(c2, c1 // g, kh, kw))
        self.bias = nn.Parameter(torch.zeros(c2)) if bias else None

    def forward(self, x):
        dt = x.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt),
                     None if self.bias is None else self.bias.to(dt),
                     self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


def _param_key(params) -> tuple:
    """Identity and in-place version of each parameter: an optimizer step,
    a `load_state_dict` or a device move changes it."""
    return tuple((id(p), p._version, p.device) for p in params)


def _refill(old, new):
    """`new` written into the tensors of `old` where they match in shape,
    dtype and device (dicts and tuples entry by entry), so that a refreshed
    cache keeps its tensors' addresses; `new` itself where they do not. A
    tensor that is its own source (an f32 parameter taken as is) is left
    alone."""
    if isinstance(old, torch.Tensor) and isinstance(new, torch.Tensor):
        if new is old or (old.shape, old.dtype, old.device) != (
                new.shape, new.dtype, new.device):
            return new
        return old.copy_(new)
    if isinstance(old, dict) and isinstance(new, dict):
        return {k: _refill(old.get(k), v) for k, v in new.items()}
    if (isinstance(old, tuple) and isinstance(new, tuple)
            and len(old) == len(new)):
        return tuple(_refill(a, b) for a, b in zip(old, new))
    return new


class RelPosBias(nn.Module):
    """The (nh, N, N) f32 attention bias of a window-attention module, a
    function of parameters, with the one cache rule of the eval path: the
    bias is materialized once per weight load (the JAX package's
    evaluate.cache_rel_bias) and that copy is read only while gradients are
    off and no source parameter was modified, replaced or moved since (see
    `SwinBlock.kernel_weights`). A subclass names the parameters
    (`bias_params`) and computes the bias (`materialize_bias(*variant)`);
    `variant` is whatever else the bias depends on (nothing for the
    rel-pos table, the window size and compute dtype for V2's MLP)."""

    def __init__(self):
        super().__init__()
        self.register_buffer("bias_cache", None, persistent=False)
        self._bias_key = None

    def bias_params(self) -> list:
        raise NotImplementedError

    def materialize_bias(self, *variant) -> torch.Tensor:
        raise NotImplementedError

    def cache_bias(self, *variant) -> None:
        """Materialize the bias, into the cached tensor where one of its
        shape is there (a refresh keeps its address)."""
        with torch.no_grad():
            self.bias_cache = _refill(
                self.bias_cache, self.materialize_bias(*variant).contiguous())
        self._bias_key = (variant, _param_key(self.bias_params()))

    def rel_bias(self, *variant) -> torch.Tensor:
        if (self.bias_cache is not None and not torch.is_grad_enabled()
                and self._bias_key == (variant,
                                       _param_key(self.bias_params()))):
            return self.bias_cache
        return self.materialize_bias(*variant).contiguous()


class WindowAttention(RelPosBias):
    """W-MSA with relative position bias; parameters (torch layout):
    relative_position_bias_table ((2ws-1)^2, nh), qkv (3C, C), proj (C, C)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        n = (2 * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(torch.zeros(n, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)).long(),
            persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias_params(self) -> list:
        return [self.relative_position_bias_table]

    def materialize_bias(self) -> torch.Tensor:
        n = self.window_size ** 2
        t = self.relative_position_bias_table[self.relative_position_index]
        return t.reshape(n, n, self.num_heads).permute(2, 0, 1).float()

    def forward(self, x: torch.Tensor, mask=None, ln=None) -> torch.Tensor:
        """Two input layouts share the parameters: a (B, H, W, C) map
        (already padded/rolled), whose core is K1 / K8 on the card, or
        (B_, N, C) pre-partitioned window tokens with an optional
        (nW, N, N) mask, whose core is K11. `ln` = (weight, bias) of a
        LayerNorm applied first (K13)."""
        nh = self.num_heads
        scale = (x.shape[-1] // nh) ** -0.5
        if ln is not None:
            x = layer_norm(x, ln[0], ln[1])
        qkv = linear(x, self.qkv)
        if x.ndim == 4:
            out = kwa.window_attention_core_nhwc(qkv, self.rel_bias(), mask,
                                                 self.window_size, nh, scale)
        else:
            nw = mask.shape[0] if mask is not None else 1
            out = kwa.window_attention_core(qkv, self.rel_bias(), mask, nw,
                                            nh, scale)
        return linear(out, self.proj)


class Mlp(nn.Module):
    """linear: fc1 (C->hidden) -> GELU -> fc2. conv ("enhanced"): fc1 keeps
    C, the 2x2 conv runs over fc1's output zero-padded bottom/right, then
    GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int, linear_mlp: bool):
        super().__init__()
        self.linear_mlp = linear_mlp
        if linear_mlp:
            self.fc1 = nn.Linear(dim, hidden)
            self.fc2 = nn.Linear(hidden, out)
        else:
            self.fc1 = nn.Linear(dim, dim)
            self.conv1 = Conv(dim, dim, 2, bias=True)
            self.fc2 = nn.Linear(dim, out)

    def forward(self, x):
        if self.linear_mlp:
            return linear(gelu(linear(x, self.fc1)), self.fc2)
        f1 = linear(x, self.fc1)
        z = ksb.conv2x2_pad_br(f1, self.conv1.weight, self.conv1.bias)
        return linear(gelu(z), self.fc2)


class SwinBlock(nn.Module):
    """Swin block over an NHWC map; `forward` is `swin_block_forward`."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 linear_mlp: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window_size, self.shift_size = window_size, shift_size
        self.linear_mlp = linear_mlp
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = AddLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, linear_mlp)
        self._kernel_weights = None

    def forward(self, x):
        return swin_block_forward(self, x)

    def _kernel_params(self) -> list:
        at, mlp = self.attn, self.mlp
        ps = [self.norm1.weight, self.norm1.bias, self.norm2.weight,
              self.norm2.bias, at.qkv.weight, at.qkv.bias, at.proj.weight,
              at.proj.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
              mlp.fc2.bias]
        if not self.linear_mlp:
            ps += [mlp.conv1.weight, mlp.conv1.bias]
        return ps

    def _build_kernel_weights(self, dt: torch.dtype) -> dict:
        """The kernels' weights: dtype dt, LN affines f32, the conv as
        `conv_taps`. The casts are differentiable ops on the f32 master
        parameters (flax's `.astype(dt)`): under grad mode a gradient
        through a kernel lands on the parameter in f32."""
        at, mlp = self.attn, self.mlp
        cast = lambda p: p.to(dt).contiguous()
        f32 = lambda p: p.float().contiguous()
        kw = dict(ln1w=f32(self.norm1.weight), ln1b=f32(self.norm1.bias),
                  ln2w=f32(self.norm2.weight), ln2b=f32(self.norm2.bias),
                  wqkv=cast(at.qkv.weight), bqkv=cast(at.qkv.bias),
                  wp=cast(at.proj.weight), bp=cast(at.proj.bias),
                  w1=cast(mlp.fc1.weight), b1=cast(mlp.fc1.bias),
                  w2=cast(mlp.fc2.weight), b2=cast(mlp.fc2.bias))
        if not self.linear_mlp:
            kw["wc"] = cast(ksb.conv_taps(mlp.conv1.weight))
            kw["bc"] = cast(mlp.conv1.bias)
        return kw

    def cache_kernel_weights(self, dt: torch.dtype = torch.bfloat16) -> None:
        """Build the kernels' weights once per weight load, beside the
        rel-pos bias (`train.evaluate.cache_rel_bias`), for inference: the
        bf16 ones and, from those, the int8 ones of the int8 bodies with
        their scales (`kw["q8"]`, as JAX quantizes `w.astype(dt)`). A
        refresh writes into the cached tensors (their addresses stay)."""
        with torch.no_grad():
            kw = self._build_kernel_weights(dt)
            kw["q8"] = q8_weights(None, **{k: kw[k] for k in (
                "wqkv", "wp", "w1", "w2", "wc") if k in kw})
            kw = _refill(self._kernel_weights or {}, kw)
        kw["dtype"], kw["key"] = dt, _param_key(self._kernel_params())
        self._kernel_weights = kw

    def kernel_weights(self, dt: torch.dtype) -> dict:
        """One rule for both caches (this one and `attn.bias_cache`): a
        cache is read only while gradients are off (`torch.no_grad()`) and
        no source parameter was modified, replaced or moved since it was
        built. Under grad mode the casts and the bias
        gather are part of the graph, so no stale or detached copy is ever
        differentiated (and the int8 wrappers quantize the weights they
        are given)."""
        kw = self._kernel_weights
        if (kw is not None and not torch.is_grad_enabled()
                and kw["dtype"] == dt
                and kw["key"] == _param_key(self._kernel_params())):
            return kw
        return self._build_kernel_weights(dt)


def split_block(blk: SwinBlock, x: torch.Tensor, mask, shift: int,
                int8: bool = False):
    """The LN-outside split (`sodt_tpu/models/swin.py` l.385-412): LN1 ->
    K5 with the shift folded in (output in shifted coordinates) -> roll
    back by (+shift, +shift) -> add+LN2 -> K6 (linear MLP) or K7 (conv
    MLP); int8: their int8 bodies. Each wrapper takes its plain version for
    a tensor on the CPU."""
    kw = blk.kernel_weights(x.dtype)
    q8 = dict(int8=True, q8=kw.get("q8")) if int8 else {}
    ws, nh = blk.window_size, blk.num_heads
    scale = (x.shape[-1] // nh) ** -0.5
    a = kwa.fused_block_attention(
        blk.norm1(x), kw["wqkv"], kw["bqkv"], kw["wp"], kw["bp"],
        blk.attn.rel_bias(), mask, ws, nh, scale, shift, **q8)
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    s, y = blk.norm2(x, a)
    if blk.linear_mlp:
        return ksb.fused_mlp_tail(s, y, kw["w1"], kw["b1"], kw["w2"], kw["b2"],
                                  **q8)
    return ksb.fused_conv_mlp_tail_noln(s, y, kw["w1"], kw["b1"], kw["wc"],
                                        kw["bc"], kw["w2"], kw["b2"], **q8)


def mega_block(blk: SwinBlock, x: torch.Tensor, mask, shift: int,
               int8: bool = False):
    """The megakernel path for c <= 256 (`sodt_tpu/models/swin.py`
    l.342-376): K2 for a linear-MLP block (the shift folds into its gather
    and scatter); K3 (LN1 + attention, output in shifted coordinates) then
    K4 (un-shift on read + residual + LN2 + conv MLP + residual) for a
    conv-MLP block; int8: their int8 bodies. Each wrapper takes its plain
    version for a tensor on the CPU."""
    kw = blk.kernel_weights(x.dtype)
    q8 = dict(int8=True, q8=kw.get("q8")) if int8 else {}
    ws, nh = blk.window_size, blk.num_heads
    scale = (x.shape[-1] // nh) ** -0.5
    bias = blk.attn.rel_bias()
    if blk.linear_mlp:
        return ksb.fused_swin_block(
            x, kw["ln1w"], kw["ln1b"], kw["wqkv"], kw["bqkv"], kw["wp"],
            kw["bp"], kw["ln2w"], kw["ln2b"], kw["w1"], kw["b1"], kw["w2"],
            kw["b2"], bias, mask, ws, nh, scale, shift, **q8)
    a = kwa.fused_block_attention_ln(
        x, kw["ln1w"], kw["ln1b"], kw["wqkv"], kw["bqkv"], kw["wp"],
        kw["bp"], bias, mask, ws, nh, scale, shift, **q8)
    return ksb.fused_conv_mlp_tail(
        x, a, kw["ln2w"], kw["ln2b"], kw["w1"], kw["b1"], kw["wc"], kw["bc"],
        kw["w2"], kw["b2"], shift, **q8)


def swin_block_forward(blk: SwinBlock, x: torch.Tensor) -> torch.Tensor:
    """The port's block dispatch (the module doc says which path runs
    where). Each kernel wrapper raises outside its kernel's domain."""
    b, h, w, c = x.shape
    ws, shift = blk.window_size, blk.shift_size
    if min(h, w) <= ws:
        # the window covers the map: global attention over ONE padded window
        shift = 0
    ph, pw = (-h) % ws, (-w) % ws
    mask = _mask_tensor(h + ph, w + pw, ws, shift, x.device) if shift else None

    windowed = ws * ws <= 256 and h % ws == 0 and w % ws == 0
    if int8_enabled() and x.dtype == torch.bfloat16:
        # JAX's int8 gate (module doc)
        if windowed and c <= 256 and (shift == 0 or not blk.linear_mlp):
            return mega_block(blk, x, mask, shift, int8=True)
        if windowed and c > 256:
            return split_block(blk, x, mask, shift, int8=True)
    elif (kernels_enabled() and x.is_cuda and x.dtype == torch.bfloat16
          and windowed):
        if ksb.megakernel_supported(c, blk.num_heads, ws):
            return mega_block(blk, x, mask, shift)
        return split_block(blk, x, mask, shift)

    # JAX's generic composition; padded tokens take part in attention
    # unmasked
    shortcut = x
    x = blk.norm1(x)
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = blk.attn(x, mask)
    if shift:
        x = torch.roll(x, (shift, shift), (1, 2))
    if ph or pw:
        x = x[:, :h, :w]
    x, y = blk.norm2(shortcut, x)
    return x + blk.mlp(y)


class PatchMerging(nn.Module):
    """2x2 space-to-depth + Linear(4C->2C) + LN, as ONE stride-2 conv whose
    OIHW weight holds the reference's Linear rows in their order
    [x(0::2,0::2); x(1::2,0::2); x(0::2,1::2); x(1::2,1::2)]."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Conv(dim, 2 * dim, 2, 2, bias=False)
        self.norm = LayerNorm(2 * dim)

    def forward(self, x):
        return self.norm(self.reduction(x))


class PatchEmbed(nn.Module):
    """Conv projection to NHWC tokens."""

    def __init__(self, c1: int, embed_dim: int, kernel=16, stride=16,
                 padding=1):
        super().__init__()
        self.proj = Conv(c1, embed_dim, kernel, stride, padding, bias=True)

    def forward(self, x):
        return self.proj(x)
