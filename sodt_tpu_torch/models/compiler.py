"""YAML model compiler: config -> static layer graph -> torch modules
(`sodt_tpu/models/compiler.py`), for the split-backbone mode and the
registry entries the flagship uses.

Split mode: the backbone is a single `ImageEncoderViT` or
`ImageEncoderSwinV2` entry producing [P3, P4, P5]; head `from` indices
address y = [P3, P4, P5, head...] and the head channels seed (out_chans,
out_chans, 2*out_chans) at strides (4, 8, 16) for the flagship encoder,
(128, 256, 512) at strides (4, 16, 32) for the SwinV2 variant. Channel arithmetic matches the JAX package: width multiple +
make_divisible(8) on conv-family outputs, depth multiple on repeat counts,
Concat summing. Any other module, and the unified (all-CNN) mode, raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import yaml

from . import layers as L
from .backbone import ImageEncoderViT
from .swinv2 import ImageEncoderSwinV2

_CONV_FAMILY = {"Conv", "Bottleneck", "C3"}
_LATER = {
    "ImageEncoderViTMono": "ROADMAP.md Queue 1 item 5 (mono variant)",
}
_QUEUE_OTHER = "ROADMAP.md Queue 1 item 10 (other model families)"


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


@dataclass(frozen=True)
class LayerDef:
    i: int                 # index of this layer's output in y
    f: tuple[int, ...]     # resolved absolute input indices into y
    name: str              # registry key
    args: tuple            # resolved constructor args
    c1: int                # input channels (first input)
    c2: int                # output channels


@dataclass(frozen=True)
class ModelSpec:
    nc: int
    anchors: tuple
    backbone: tuple
    head: tuple
    detect_from: tuple
    detect_ch: tuple
    detect_strides: tuple
    save: tuple
    ch_in: int


def resolve_config_path(path) -> str:
    """A relative path names a file of this package first (so
    "configs/model.yaml", or just "model_swinv2.yaml", is the port's own
    copy), else the path as given."""
    p = Path(path)
    pkg = Path(__file__).resolve().parent.parent
    own = [] if p.is_absolute() else [pkg / p, pkg / "configs" / p]
    for cand in own + [p]:
        if cand.exists():
            return str(cand)
    raise FileNotFoundError(path)


def load_yaml(cfg) -> dict:
    if isinstance(cfg, dict):
        return dict(cfg)
    with open(resolve_config_path(cfg)) as f:
        return yaml.safe_load(f)


def _round_n(n: int, gd: float) -> int:
    return max(round(n * gd), 1) if n > 1 else n


def _parse_section(defs, ch: list[int], strides: list[float], gd: float,
                   gw: float, no: int, start: int):
    out: list[LayerDef] = []
    save: set[int] = set()
    detect = None
    for k, (f, n, mname, args) in enumerate(defs):
        i = start + k
        fs = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        fs = tuple(i - 1 if x == -1 else x for x in fs)
        n = _round_n(n, gd)                     # C3's bottleneck count
        args = list(args)
        name = mname.replace("nn.", "")
        c1 = ch[fs[0]]
        s_in = strides[fs[0]]
        s_out = s_in
        if name in _CONV_FAMILY:
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c2, *args[1:]]
            if name == "Conv":
                s_out = s_in * (args[2] if len(args) > 2 else 1)
            if name == "C3":
                args = [args[0], n, *args[1:]]
            out.append(LayerDef(i, fs, name, tuple(args), c1, c2))
        elif name == "Upsample":
            scale = args[1] if len(args) > 1 else 2
            method = args[2] if len(args) > 2 else "nearest"
            c2 = c1
            s_out = s_in / scale
            out.append(LayerDef(i, fs, "Upsample", (scale, method), c1, c2))
        elif name == "Concat":
            c2 = sum(ch[x] for x in fs)
            out.append(LayerDef(i, fs, "Concat", (), c1, c2))
        elif name == "Detect":
            detect = (fs, tuple(ch[x] for x in fs),
                      tuple(strides[x] for x in fs))
            c2 = no
            out.append(LayerDef(i, fs, "Detect", (), c1, c2))
        else:
            raise NotImplementedError(
                f"module {mname!r}: {_LATER.get(name, _QUEUE_OTHER)}")
        for x in fs:
            if x != i - 1:
                save.add(x)
        ch.append(c2)
        strides.append(s_out)
    return out, save, detect


def parse_config(cfg, ch_in: int = 4, nc: int | None = None) -> ModelSpec:
    """Parse a model YAML (path or dict) into a static ModelSpec."""
    d = load_yaml(cfg)
    if nc is not None:
        d["nc"] = nc
    nc = int(d["nc"])
    gd, gw = float(d["depth_multiple"]), float(d["width_multiple"])
    anchors = tuple(tuple(a) for a in d["anchors"])
    na = len(anchors[0]) // 2
    no = na * (nc + 5)
    if d.get("steam"):
        raise NotImplementedError(f"steam layers: {_QUEUE_OTHER}")
    bdefs = d["backbone"]
    if not (len(bdefs) == 1 and bdefs[0][2].startswith("ImageEncoder")):
        raise NotImplementedError(f"unified (all-CNN) configs: {_QUEUE_OTHER}")
    enc_name, args = bdefs[0][2], list(bdefs[0][3])
    if enc_name not in MODULE_REGISTRY or len(args) != 6:
        raise NotImplementedError(
            f"backbone {enc_name!r} {args}: "
            f"{_LATER.get(enc_name, _QUEUE_OTHER)}")
    # [img_size, unused, embed_dim, in_chans, out_chans, window_size];
    # patch_size is forced to 4
    enc = dict(img_size=args[0], patch_size=4, embed_dim=args[2],
               in_chans=args[3], out_chans=args[4], window_size=args[5])
    if enc_name == "ImageEncoderSwinV2":
        # the V2 variant's width, necks and tap strides are fixed
        enc["embed_dim"] = 96
        ch = [128, 256, 512]
        strides = [4.0, 16.0, 32.0]
    else:
        oc = enc["out_chans"]
        ch = [oc, oc, 2 * oc]
        strides = [4.0, 8.0, 16.0]
    backbone = (LayerDef(0, (-1,), enc_name, tuple(sorted(enc.items())),
                         ch_in, ch[0]),)
    head, save, detect = _parse_section(d["head"], ch, strides, gd, gw, no,
                                        start=3)
    save |= {0, 1, 2}
    if detect is None:
        raise ValueError("config has no Detect layer")
    det_f, det_ch, det_s = detect
    return ModelSpec(nc=nc, anchors=anchors, backbone=backbone,
                     head=head, detect_from=det_f, detect_ch=det_ch,
                     detect_strides=tuple(float(s) for s in det_s),
                     save=tuple(sorted(save)), ch_in=ch_in)


def build_module(ld: LayerDef):
    """Instantiate the torch module for one LayerDef (registry dispatch)."""
    if ld.name not in MODULE_REGISTRY:
        raise NotImplementedError(
            f"module {ld.name!r}: {_LATER.get(ld.name, _QUEUE_OTHER)}")
    return MODULE_REGISTRY[ld.name](ld)


def _conv(ld):
    c2, *rest = ld.args
    k = rest[0] if len(rest) > 0 else 1
    s = rest[1] if len(rest) > 1 else 1
    return L.ConvBnAct(ld.c1, c2, k, s)


def _c3(ld):
    c2, n, *rest = ld.args
    return L.C3(ld.c1, c2, n=n, shortcut=rest[0] if rest else True)


def _bottleneck(ld):
    c2, *rest = ld.args
    return L.Bottleneck(ld.c1, c2, shortcut=rest[0] if rest else True)


def _upsample(ld):
    scale, method = ld.args
    return L.Upsample(scale=int(scale), method=str(method))


def _encoder(ld):
    return ImageEncoderViT(**dict(ld.args))


def _encoder_swinv2(ld):
    kw = dict(ld.args)
    kw.pop("out_chans", None)       # the necks are fixed in the V2 variant
    return ImageEncoderSwinV2(**kw)


MODULE_REGISTRY = {
    "Concat": lambda ld: L.Concat(),
    "Conv": _conv,
    "C3": _c3,
    "Bottleneck": _bottleneck,
    "Upsample": _upsample,
    "ImageEncoderViT": _encoder,
    "ImageEncoderSwinV2": _encoder_swinv2,
}


def build_model(cfg, *, ch_in: int = 4, nc: int | None = None, dtype=None,
                input_mode: str = "RGB+IR"):
    """Config -> DetectionModel (torch). See model.DetectionModel."""
    import torch
    from .model import DetectionModel

    spec = parse_config(cfg, ch_in=ch_in, nc=nc)
    return DetectionModel(spec, input_mode=input_mode,
                          dtype=dtype or torch.float32)
