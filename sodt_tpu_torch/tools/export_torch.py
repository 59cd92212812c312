"""Export the port's flagship weights in the reference's format
(`tools/export_torch.py` of the JAX system):

    python -m sodt_tpu_torch.tools.export_torch \\
        --weights checkpoints/flagship_r5_150ep_ema.npz --out ours.pt \\
        --no-module [--cfg configs/model.yaml] [--device cuda]

The inverse of `import_torch` for the flagship graph (configs/model.yaml):
the port's state_dict (a .npz, or a checkpoint of the port's trainer,
whose EMA weights are taken, as `val --weights` takes them) -> the
reference Model's state_dict names (basics/models/{model,backbone_vit}.py).
The layouts are the reference's already (Linear (out, in), Conv2d OIHW,
LayerNorm / BatchNorm weight and bias, running_mean / running_var); only
the port's own modules move back:

  stride-2 conv (2C, C, 2, 2)   -> PatchMerging's reduction Linear
                                   (2C, 4C), rows in the reference order
  neck1.a / neck1.b (out, C)    -> neck1 (out, 2C, 1, 1)
  BatchNorm                     -> + num_batches_tracked = 0

Before it writes, the export goes back through the port's importer and
must give the source bit for bit ("round-trip exact over N arrays").
--no-module writes the plain state_dict; without it the file is the
reference's whole-module checkpoint dict {'model': nn.Module, ...}, which
needs the reference tree at --ref-path (its Model class builds the
module); where that tree is absent the tool raises and names --no-module.
The loaded weights are checked by a strict load into the port's model on
--device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..models import build_model
from ..models.compiler import resolve_config_path
from ..train.checkpoint import load_weights
from ..utils.torch_import import (BN_LEAVES, CONV_MLP_LEAVES, SWIN_LEAVES,
                                  import_flagship_model)

NAMES = ["car", "pickup", "camping", "truck", "other", "tractor", "boat",
         "van"]


def _reduction_linear(w: np.ndarray) -> np.ndarray:
    """The port's stride-2 conv (2C, C, 2, 2) -> the reference's Linear
    (2C, 4C) (`utils/torch_import._reduction` inverted)."""
    out = w.shape[0]
    hwio = w.transpose(2, 3, 1, 0).transpose(1, 0, 2, 3)
    return hwio.reshape(-1, out).T


def _image_encoder(src: dict, sd: dict, prefix: str = "image_encoder."
                   ) -> None:
    def put(name, value):
        sd[prefix + name] = np.ascontiguousarray(value)

    def take(*names):
        for n in names:
            put(n, src[n])

    for ch in ("r", "g", "b", "i"):
        take(f"channel_embed_{ch}.proj.weight",
             f"channel_embed_{ch}.proj.bias")
    for i in range(1, 5):
        take(f"chan_block.norm{i}.weight", f"chan_block.norm{i}.bias")
    take("patch_embed.proj.weight", "patch_embed.proj.bias", "pos_embed")
    blocks = ([(f"stage1.{i}", f"stage1_{i}", i % 2) for i in range(6)]
              + [(f"stage2.{i}", f"stage2_{i}", i % 2) for i in range(4)]
              + [("stage3.0", "stage3_0", 0)])
    for dst, name, shifted in blocks:
        for leaf in SWIN_LEAVES + (CONV_MLP_LEAVES if shifted else ()):
            put(f"{dst}.{leaf}", src[f"{name}.{leaf}"])
    for pm in ("pmerging1", "pmerging2"):
        put(f"{pm}.reduction.weight",
            _reduction_linear(src[f"{pm}.reduction.weight"]))
        take(f"{pm}.norm.weight", f"{pm}.norm.bias")
    put("neck1.weight", np.concatenate(
        [src["neck1.a.weight"], src["neck1.b.weight"]], 1)[:, :, None, None])
    take("neck2.weight", "neck3.weight")


def _conv_bn(src: dict, name: str, sd: dict, dst: str) -> None:
    sd[f"{dst}.conv.weight"] = src[f"{name}.conv.weight"]
    for leaf in BN_LEAVES:
        sd[f"{dst}.bn.{leaf}"] = src[f"{name}.bn.{leaf}"]
    sd[f"{dst}.bn.num_batches_tracked"] = np.asarray(0, np.int64)


def export_flagship_state_dict(state_dict: dict, spec) -> dict:
    """The port's DetectionModel state_dict (the flagship) -> the reference
    Model's state_dict, numpy values (the caller makes them tensors)."""
    src = {k: v.detach().cpu().numpy() if hasattr(v, "detach")
           else np.asarray(v) for k, v in state_dict.items()}
    enc = {k[len("l0."):]: v for k, v in src.items() if k.startswith("l0.")}
    sd: dict = {}
    _image_encoder(enc, sd)
    for ld in spec.head:
        dst = f"detect.{ld.i - 3}"
        if ld.name == "Detect":
            for mi in range(len(spec.detect_from)):
                sd[f"{dst}.m.{mi}.weight"] = src[f"detect.m{mi}.weight"]
                sd[f"{dst}.m.{mi}.bias"] = src[f"detect.m{mi}.bias"]
        elif ld.name == "Conv":
            _conv_bn(src, f"l{ld.i}", sd, dst)
        elif ld.name == "C3":
            for cv in ("cv1", "cv2", "cv3"):
                _conv_bn(src, f"l{ld.i}.{cv}", sd, f"{dst}.{cv}")
            for i in range(ld.args[1]):
                for cv in ("cv1", "cv2"):
                    _conv_bn(src, f"l{ld.i}.m{i}.{cv}", sd,
                             f"{dst}.m.{i}.{cv}")
        # Upsample / Concat carry no parameters
    return sd


def tensors(sd: dict) -> dict[str, torch.Tensor]:
    """numpy values -> tensors (a 0-d value, num_batches_tracked, stays
    0-d as the reference's buffer is)."""
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def roundtrip_check(sd: dict, state_dict: dict, spec) -> int:
    """Import the export back through the port's importer: it must give
    `state_dict` key for key and bit for bit. Returns the arrays held."""
    back = import_flagship_model(tensors(sd), spec)
    if sorted(back) != sorted(state_dict):
        odd = sorted(set(back) ^ set(state_dict))
        raise AssertionError(f"round trip: keys differ: {odd[:8]}")
    for k, v in state_dict.items():
        if not torch.equal(back[k], v.detach().cpu().float()):
            raise AssertionError(f"round trip: {k} differs")
    return len(back)


def build_reference_module(sd: dict, cfg: str, ref_path: str, nc: int = 8):
    """The reference's own Model with the exported weights loaded (strict
    on everything but the buffers its __init__ derives: anchors, anchor
    grids, relative-position indices, attention masks). Needs the
    reference tree at `ref_path`."""
    root = Path(ref_path) if ref_path else None
    if root is None or not (root / "basics" / "models" / "model.py").is_file():
        raise FileNotFoundError(
            f"no reference tree at --ref-path {ref_path!r} (it needs "
            "basics/models/model.py to build the whole-module checkpoint); "
            "pass --no-module to write the plain state_dict")
    sys.path.insert(0, str(root))
    from basics.models.model import Model  # the reference's package

    model = Model(resolve_config_path(cfg), input_mode="RGB+IR", ch_steam=3,
                  ch=4, nc=nc)
    missing, unexpected = model.load_state_dict(tensors(sd), strict=False)
    missing = [m for m in missing
               if not m.endswith(("anchors", "anchor_grid",
                                  "relative_position_index", "attn_mask"))]
    if missing or unexpected:
        raise RuntimeError(f"reference module: unmapped {missing[:8]}, "
                           f"extra {unexpected[:8]}")
    return model


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", required=True,
                   help="a .npz state_dict or a checkpoint of the port (its "
                        "EMA weights)")
    p.add_argument("--cfg", default="configs/model.yaml")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--ref-path", default="",
                   help="the reference tree, for the whole-module file")
    p.add_argument("--no-module", action="store_true",
                   help="save a plain state_dict .pt instead of the "
                        "reference's whole-module checkpoint dict")
    p.add_argument("--device", "--platform", default="cuda")
    return p


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    dev = resolve_device(a.device)
    model = build_model(a.cfg, ch_in=4, input_mode="RGB+IR")
    state = load_weights(a.weights)
    model.to(dev).load_state_dict(state)
    sd = export_flagship_state_dict(state, model.spec)
    n = roundtrip_check(sd, state, model.spec)
    print(f"round-trip exact over {n} arrays")
    if a.no_module:
        torch.save(tensors(sd), a.out)
    else:
        module = build_reference_module(sd, a.cfg, a.ref_path,
                                        model.spec.nc)
        # what the reference's trainer attaches before it saves, and its
        # test() reads
        module.names = NAMES[:model.spec.nc]
        module.nc = model.spec.nc
        torch.save({"model": module, "epoch": -1, "best_fitness": None,
                    "optimizer": None}, a.out)
    print(f"wrote {a.out}")
    return {"out": a.out, "arrays": n, "reference_keys": len(sd)}


if __name__ == "__main__":
    main()
