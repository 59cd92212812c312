"""Weights: the flax variable tree -> a torch state_dict, .npz files, and a
seeded initialization.

`from_jax_variables` takes the JAX package's {"params", "batch_stats"} tree
as nested dicts of numpy arrays (no JAX needed) and maps it onto this
package's module names, which mirror the flax tree:

  Dense kernel (in, out)          -> Linear weight (out, in)   [transpose]
  Conv kernel HWIO                -> weight OIHW
  LN / BN scale, bias             -> weight, bias
  batch_stats mean / var          -> running_mean / running_var
  PatchMerging reduction (4C, 2C) -> stride-2 conv OIHW, rows taken in the
                                     reference order (row block p = 2*dw+dh)
  neck1 (1, 1, 2C, out)           -> neck1.a / neck1.b Linear halves, in the
                                     flagship encoder only (the SwinV2
                                     variant's neck1 is a plain 1x1 conv)
  logit_scale, q_bias, v_bias     -> the same names (SwinV2 attention)
  grouped Conv kernel (kh, kw,    -> weight (out, in / g, kh, kw): the same
    in / g, out)                     transpose (GhostConv's cv2, the
                                     GhostBottleneck's dw / sc_dw, ACmix's
                                     dep_conv)
  w (Sum), rate1 / rate2 (ACmix)  -> the same names

The layers of JAX's registry keep flax's module names (cv1-cv7, bn, m{i},
g1, g2, dw, sc_dw, sc_pw, conv1-conv3, conv_p, fc, dep_conv, conv), so
their leaves take the rules above: ACmix's fc is a Dense kernel (3 heads,
kernel_conv^2) -> Linear, every conv an HWIO kernel -> OIHW.

The mapping is linear per leaf (a transpose, a reshape or a slice), so it
carries any tree of that structure: `from_jax_tree` takes a JAX gradient
tree or the EMA copy (`ema_params`, `ema_batch_stats`) onto the port's
names, and `batch_to_torch` takes a padded JAX batch onto a device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _two_tap_necks(flat: dict) -> set:
    """The encoders whose neck1 reads the concat of two stage-1 taps (the
    flagship `ImageEncoderViT`, told by its `pos_embed`): module paths."""
    return {p.rpartition("/")[0] for p in flat
            if p.rpartition("/")[2] == "pos_embed"}


def from_jax_variables(tree: dict) -> dict[str, torch.Tensor]:
    """flax variables (nested dicts of arrays) -> torch state_dict."""
    sd: dict[str, np.ndarray] = {}
    flat = _flatten(tree.get("params", {}))
    two_tap = _two_tap_necks(flat)
    for path, v in flat.items():
        parts = path.split("/")
        leaf, mods = parts[-1], parts[:-1]
        name = ".".join(mods)
        if leaf == "kernel" and mods[-1] == "reduction":
            c4, out = v.shape
            c = c4 // 4
            hwio = v.reshape(2, 2, c, out).transpose(1, 0, 2, 3)
            sd[f"{name}.weight"] = hwio.transpose(3, 2, 0, 1)
        elif (leaf == "kernel" and mods[-1] == "neck1"
              and "/".join(mods[:-1]) in two_tap):
            w = v[0, 0]                                   # (2C, out)
            c = w.shape[0] // 2
            sd[f"{name}.a.weight"] = w[:c].T
            sd[f"{name}.b.weight"] = w[c:].T
        elif leaf == "kernel" and v.ndim == 2:
            sd[f"{name}.weight"] = v.T
        elif leaf == "kernel" and v.ndim == 4:
            sd[f"{name}.weight"] = v.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            sd[f"{name}.weight"] = v
        else:       # bias, pos_embed, relative_position_bias_table, and
            #         logit_scale, q_bias, v_bias of the SwinV2 attention
            sd[".".join(parts)] = v
    for path, v in _flatten(tree.get("batch_stats", {})).items():
        parts = path.split("/")
        leaf = {"mean": "running_mean", "var": "running_var"}[parts[-1]]
        sd[".".join(parts[:-1] + [leaf])] = v
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def from_jax_tree(params: dict, batch_stats: dict | None = None
                  ) -> dict[str, torch.Tensor]:
    """A tree shaped like the flax "params" (gradients, optimizer moments,
    the EMA parameters), with an optional tree shaped like "batch_stats"
    (the EMA statistics), onto the port's parameter / buffer names."""
    tree = {"params": params}
    if batch_stats is not None:
        tree["batch_stats"] = batch_stats
    return from_jax_variables(tree)


def batch_to_torch(batch: dict, device="cpu") -> dict[str, torch.Tensor]:
    """A padded batch of numpy arrays as both packages' train steps take
    it (img, ir (B, H, W, 3) float in [0, 1], or uint8, scaled here by
    1/255 on the device; targets (B, M, 5) f32; tmask (B, M) bool) ->
    tensors on `device`."""
    out = {}
    for k in ("img", "ir"):
        if batch.get(k) is not None:
            x = torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            out[k] = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    out["targets"] = torch.from_numpy(
        np.asarray(batch["targets"], np.float32)).to(device)
    out["tmask"] = torch.from_numpy(
        np.asarray(batch["tmask"], bool)).to(device)
    return out


def save_npz(state_dict: dict, path, *, compressed: bool = False) -> None:
    """A state_dict as f32 arrays in one .npz (`compressed`: deflated, as
    `np.savez_compressed` writes it; `load_npz` reads either)."""
    save = np.savez_compressed if compressed else np.savez
    save(path, **{k: v.detach().cpu().float().numpy()
                  for k, v in state_dict.items()})


def load_npz(path) -> dict[str, torch.Tensor]:
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _lecun_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # flax lecun_normal: truncated normal (at 2 std) of variance 1/fan_in
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std,
                                            -2 * std, 2 * std, generator=g))


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded torch.Generator, with the flax
    initializers' distributions: lecun-normal kernels, zero biases, unit
    norm scales, trunc-normal(0.02) rel-pos tables, zero pos_embed. The
    Detect biases keep their prior from construction. The SwinV2 blocks
    keep logit_scale = log 10 and zero q_bias / v_bias from construction,
    and their two post-norm scales start at ZERO, so a freshly initialized
    V2 block is the identity."""
    from .models.swinv2 import SwinBlockV2
    g = torch.Generator().manual_seed(seed)
    for mname, mod in model.named_modules():
        if isinstance(mod, SwinBlockV2):
            mod.norm1.weight.zero_()
            mod.norm2.weight.zero_()
        for pname, p in mod.named_parameters(recurse=False):
            if pname == "relative_position_bias_table":
                p.copy_(torch.nn.init.trunc_normal_(
                    torch.empty(p.shape), 0.0, 0.02, -0.04, 0.04, generator=g))
            elif pname == "weight" and p.ndim in (2, 4):
                _lecun_(p, p[0].numel(), g)
            elif pname == "bias" and not mname.startswith("detect"):
                p.zero_()
    return model
