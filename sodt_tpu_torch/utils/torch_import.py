"""Reference PyTorch weights into the port (`sodt_tpu/utils/torch_import.py`).

The reference checkpoints pickle whole nn.Modules whose state_dicts use
the reference's module names. JAX's importers map those names onto its
flax trees (transposing every kernel); here each importer returns the
PORT's state_dict directly: the reference's layouts are the port's own
(Linear (out, in), Conv2d OIHW, LayerNorm / BatchNorm weight and bias,
BatchNorm running_mean / running_var), so only the names move, except
where the port's module differs from the reference's:

  PatchMerging reduction Linear (2C, 4C) -> the port's stride-2 conv
                                  (2C, C, 2, 2), rows taken in the
                                  reference order (row block p = 2*dw+dh)
  the flagship encoder's neck1 -> neck1.a / neck1.b, the halves of its
    (out, 2C, 1, 1)               input channels (a model with pos_embed)

What each importer takes is JAX's selection: the buffers the reference
derives in its __init__ (relative-position indices, masks, anchor grids)
and `num_batches_tracked` are left out. The result equals
`weights.from_jax_variables` of JAX's importer's tree bit for bit; every
value is f32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

SWIN_LEAVES = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
               "attn.relative_position_bias_table", "attn.qkv.weight",
               "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
               "mlp.fc2.bias")
CONV_MLP_LEAVES = ("mlp.conv1.weight", "mlp.conv1.bias")
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _numpy(state_dict: dict[str, Any]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach")
            else np.asarray(v) for k, v in state_dict.items()}


def _tensors(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def _reduction(w: np.ndarray) -> np.ndarray:
    """PatchMerging's Linear (2C, 4C) -> the stride-2 conv (2C, C, 2, 2)."""
    out, c4 = w.shape
    hwio = w.T.reshape(2, 2, c4 // 4, out).transpose(1, 0, 2, 3)
    return hwio.transpose(3, 2, 0, 1)


def _encoder(sd: dict, mono: bool = False) -> dict[str, np.ndarray]:
    out: dict = {}

    def take(*names):
        for n in names:
            out[n] = sd[n]

    if not mono:
        for ch in ("r", "g", "b", "i"):
            take(f"channel_embed_{ch}.proj.weight",
                 f"channel_embed_{ch}.proj.bias")
        for i in range(1, 5):
            take(f"chan_block.norm{i}.weight", f"chan_block.norm{i}.bias")
    take("patch_embed.proj.weight", "patch_embed.proj.bias")
    two_tap = "pos_embed" in sd
    if two_tap:
        take("pos_embed")
    blocks = ([(f"stage1.{i}", f"stage1_{i}", i % 2) for i in range(6)]
              + [(f"stage2.{i}", f"stage2_{i}", i % 2) for i in range(4)]
              + [("stage3.0", "stage3_0", 0)])
    for src, dst, shifted in blocks:
        for leaf in SWIN_LEAVES + (CONV_MLP_LEAVES if shifted else ()):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]
    for pm in ("pmerging1", "pmerging2"):
        out[f"{pm}.reduction.weight"] = _reduction(sd[f"{pm}.reduction.weight"])
        take(f"{pm}.norm.weight", f"{pm}.norm.bias")
    w = sd["neck1.weight"]
    if two_tap:
        c = w.shape[1] // 2
        out["neck1.a.weight"] = w[:, :c, 0, 0]
        out["neck1.b.weight"] = w[:, c:, 0, 0]
    else:
        out["neck1.weight"] = w
    take("neck2.weight", "neck3.weight")
    return out


def import_image_encoder(state_dict: dict[str, Any], mono: bool = False
                         ) -> dict[str, torch.Tensor]:
    """Reference ImageEncoderViT state_dict -> the state_dict of the port's
    `models.backbone.ImageEncoderViT`; mono=True maps the
    backbone_vit_mono variant (no channel attention)."""
    return _tensors(_encoder(_numpy(state_dict), mono))


def _conv_bn(sd: dict, src: str, out: dict, dst: str) -> None:
    """Reference `Conv` (conv + bn) -> the port's ConvBnAct."""
    out[f"{dst}.conv.weight"] = sd[f"{src}.conv.weight"]
    for leaf in BN_LEAVES:
        out[f"{dst}.bn.{leaf}"] = sd[f"{src}.bn.{leaf}"]


def _c3(sd: dict, src: str, out: dict, dst: str, n_bottleneck: int) -> None:
    for cv in ("cv1", "cv2", "cv3"):
        _conv_bn(sd, f"{src}.{cv}", out, f"{dst}.{cv}")
    for i in range(n_bottleneck):
        for cv in ("cv1", "cv2"):
            _conv_bn(sd, f"{src}.m.{i}.{cv}", out, f"{dst}.m{i}.{cv}")


def _detect(sd: dict, src: str, out: dict, spec) -> None:
    for mi in range(len(spec.detect_from)):
        out[f"detect.m{mi}.weight"] = sd[f"{src}.m.{mi}.weight"]
        out[f"detect.m{mi}.bias"] = sd[f"{src}.m.{mi}.bias"]


def import_flagship_model(state_dict: dict[str, Any], spec
                          ) -> dict[str, torch.Tensor]:
    """Full reference Model (split mode) -> the port's DetectionModel
    state_dict: image_encoder.* -> l0.*, the head's detect.{k}.* (its
    nn.Sequential indices) -> l{3+k}.*, the Detect convs
    detect.{last}.m.{i} -> detect.m{i}."""
    sd = _numpy(state_dict)
    enc = {k[len("image_encoder."):]: v for k, v in sd.items()
           if k.startswith("image_encoder.")}
    out = {f"l0.{k}": v for k, v in _encoder(enc).items()}
    for ld in spec.head:
        src = f"detect.{ld.i - 3}"
        if ld.name == "Detect":
            _detect(sd, src, out, spec)
        elif ld.name == "Conv":
            _conv_bn(sd, src, out, f"l{ld.i}")
        elif ld.name == "C3":
            _c3(sd, src, out, f"l{ld.i}", ld.args[1])
        # Upsample / Concat carry no parameters
    return _tensors(out)


def import_unified_model(state_dict: dict[str, Any], spec,
                         src_prefix: str = "model."
                         ) -> dict[str, torch.Tensor]:
    """A reference CNN Model (one backbone + head graph, e.g. SRyolo_PF,
    yolo5m) -> the port's DetectionModel state_dict: `model.{i}.*` ->
    `l{i}.*` with the same submodule names (cv1 / cv2 / m{k} / conv / bn),
    the Detect convs -> `detect.m{k}`. A layer without an importer raises
    NotImplementedError, as in JAX."""
    sd = _numpy(state_dict)
    out: dict = {}
    for ld in (*spec.backbone, *spec.head):
        src, dst = f"{src_prefix}{ld.i}", f"l{ld.i}"
        if ld.name == "Conv":
            _conv_bn(sd, src, out, dst)
        elif ld.name == "Focus":
            _conv_bn(sd, f"{src}.conv", out, f"{dst}.conv")
        elif ld.name == "C3":
            # the depth-scaled bottleneck count is args[1]
            _c3(sd, src, out, dst, ld.args[1])
        elif ld.name == "SPP":
            for cv in ("cv1", "cv2"):
                _conv_bn(sd, f"{src}.{cv}", out, f"{dst}.{cv}")
        elif ld.name == "Detect":
            _detect(sd, src, out, spec)
        elif ld.name not in ("Upsample", "Concat"):
            raise NotImplementedError(
                f"no importer for module {ld.name} (layer {ld.i})")
    return _tensors(out)


def import_swinv2_encoder(state_dict: dict[str, Any]
                          ) -> dict[str, torch.Tensor]:
    """Reference backbone_swinv2 ImageEncoderViT -> the state_dict of the
    port's ImageEncoderSwinV2: channel embeds, chan_block norms, the 1x1
    patch embed, 4 layers of V2 blocks (depths 2, 2, 6, 2: logit_scale,
    the cpb MLP, split q / v biases, post-norms), PatchMerging downsamples,
    necks."""
    sd = _numpy(state_dict)
    out: dict = {}
    for ch in ("r", "g", "b", "i"):
        for leaf in ("weight", "bias"):
            k = f"channel_embed_{ch}.proj.{leaf}"
            out[k] = sd[k]
    for i in range(1, 5):
        for leaf in ("weight", "bias"):
            out[f"chan_block.norm{i}.{leaf}"] = sd[f"chan_block.norm{i}.{leaf}"]
    for leaf in ("weight", "bias"):
        out[f"patch_embed.proj.{leaf}"] = sd[f"patch_embed.proj.{leaf}"]
    depths = (2, 2, 6, 2)
    names = {"norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
             "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
             "attn.logit_scale": "attn.logit_scale",
             "attn.cpb_mlp.0.weight": "attn.cpb_mlp0.weight",
             "attn.cpb_mlp.0.bias": "attn.cpb_mlp0.bias",
             "attn.cpb_mlp.2.weight": "attn.cpb_mlp1.weight",
             "attn.qkv.weight": "attn.qkv.weight",
             "attn.q_bias": "attn.q_bias", "attn.v_bias": "attn.v_bias",
             "attn.proj.weight": "attn.proj.weight",
             "attn.proj.bias": "attn.proj.bias",
             "mlp.fc1.weight": "mlp_fc1.weight",
             "mlp.fc1.bias": "mlp_fc1.bias",
             "mlp.fc2.weight": "mlp_fc2.weight",
             "mlp.fc2.bias": "mlp_fc2.bias"}
    for li, depth in enumerate(depths):
        for bi in range(depth):
            for ref, port in names.items():
                out[f"layer{li}_blk{bi}.{port}"] = sd[
                    f"layers.{li}.blocks.{bi}.{ref}"]
        if li < len(depths) - 1:
            src = f"layers.{li}.downsample"
            out[f"downsample{li}.reduction.weight"] = _reduction(
                sd[f"{src}.reduction.weight"])
            out[f"downsample{li}.norm.weight"] = sd[f"{src}.norm.weight"]
            out[f"downsample{li}.norm.bias"] = sd[f"{src}.norm.bias"]
    for neck in ("neck1", "neck2", "neck3"):
        out[f"{neck}.weight"] = sd[f"{neck}.weight"]
    return _tensors(out)
