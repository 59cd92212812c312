"""YAML model compiler: config -> static layer graph -> torch modules
(`sodt_tpu/models/compiler.py`).

Two graph modes, as in the JAX package:

  * split: the backbone is a single encoder entry (`ImageEncoderViT`, its
    RGB-only `ImageEncoderViTMono`, or `ImageEncoderSwinV2`) producing
    [P3, P4, P5]; head `from` indices address y = [P3, P4, P5, head...]
    and the head channels seed (out_chans, out_chans, 2*out_chans) at
    strides (4, 8, 16), (128, 256, 512) at strides (4, 16, 32) for the
    SwinV2 variant.
  * unified: the classic YOLOv5 walk over backbone + head as one layer
    list (yolo5m, SRyolo_MF, SRyolo_PF); `from` indices address layer
    outputs, the input seeding the channel list. An optional `steam` list
    is the per-modality stem of the RGB+IR+fusion input mode; its layers
    are numbered from 1000 (module names `l1000`...), as in JAX.

Channel arithmetic is JAX's: width multiple + make_divisible(8) on
conv-family outputs, depth multiple on repeat counts (folded into the C3
arguments), Concat summing, Focus halving the resolution, MF's fixed 64
channels, Detect collecting input channels; optional SR taps l1 / l2 with
their widths c1 / c2. Unlike flax, a torch module is built with its input
channels, so every LayerDef carries them (`c1`): the channel list of the
walk, and in the unified mode with a steam twice the steam's output
channels (the two stems' maps concatenated). DWConv builds the same
module as Conv (JAX's registry maps both to one constructor, without
groups). The stride of a conv-family layer comes from its arguments as
JAX reads them (Conv / DWConv args[2], ACmix args[4], MixConv2d args[2],
Focus 2), also where the module itself ignores them (JAX's MixConv2d
constructor runs at stride 1); the repeat count is folded into the
arguments of C3, BottleneckCSP, BottleneckCSP2 and SPPCSP and dropped for
every other module, as JAX drops it; Sum keeps its input's channels,
Contract multiplies them by gain^2 and Expand divides them. A name outside
JAX's registry raises JAX's KeyError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import yaml

from ..utils.general import resolve_config_path  # noqa: F401  (re-export)
from . import layers as L
from .backbone import ImageEncoderViT
from .swinv2 import ImageEncoderSwinV2

# modules whose first argument is the output channel count, scaled by the
# width multiple
_CONV_FAMILY = {
    "Conv", "Bottleneck", "SPP", "DWConv", "MixConv2d", "Focus", "CrossConv",
    "BottleneckCSP", "BottleneckCSP2", "SPPCSP", "C3", "AttentionModel",
    "GhostConv", "GhostBottleneck", "ACmix",
}
# conv-family modules that take the repeat count as their second argument
_REPEATED = ("BottleneckCSP", "BottleneckCSP2", "SPPCSP", "C3")
SPLIT_BACKBONES = ("ImageEncoderViT", "ImageEncoderViTMono",
                   "ImageEncoderSwinV2")


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
    mode: str                       # "split" | "unified"
    nc: int
    anchors: tuple                  # per-level flat (w, h, ...) tuples
    backbone: tuple                 # LayerDefs (split: the single encoder)
    head: tuple                     # LayerDefs, Detect last
    steam: tuple                    # LayerDefs of the RGB+IR+fusion stem
    detect_from: tuple              # y indices feeding Detect
    detect_ch: tuple                # channels of those features
    detect_strides: tuple           # stride per detect level
    save: tuple                     # y indices that must be kept
    sr_taps: tuple                  # (l1, l2) or ()
    sr_ch: tuple                    # (c1, c2) or ()
    ch_in: int
    ch: tuple = ()                  # channels of y[j] (split: 0-2 P3-P5)


def load_yaml(cfg) -> dict:
    if isinstance(cfg, dict):
        return dict(cfg)
    with open(resolve_config_path(cfg)) as f:
        return yaml.safe_load(f)


def _round_n(n: int, gd: float) -> int:
    return max(round(n * gd), 1) if n > 1 else n


def _parse_section(defs, ch: list[int], strides: list[float], gd: float,
                   gw: float, no: int, start: int):
    """Walk one [from, number, module, args] list -> (LayerDefs, save set,
    detect info). `ch[j]` / `strides[j]` hold the channels / stride of
    y[j] and grow as layers are parsed; `start` is the y index of the
    first parsed layer."""
    out: list[LayerDef] = []
    save: set[int] = set()
    detect = None
    for k, (f, n, mname, args) in enumerate(defs):
        i = start + k
        fs = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        fs = tuple(i - 1 if x == -1 else x for x in fs)
        n = _round_n(n, gd)
        args = list(args)
        name = mname.replace("nn.", "")
        if name in SPLIT_BACKBONES:
            raise ValueError(f"{name} is only valid as a split backbone")
        c1 = ch[fs[0]]
        s_in = strides[fs[0]]
        s_out = s_in
        if name in _CONV_FAMILY:
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            args = [c2, *args[1:]]
            s = 1
            if name in ("Conv", "DWConv"):
                s = args[2] if len(args) > 2 else 1
            elif name == "ACmix":
                s = args[4] if len(args) > 4 else 1
            elif name == "MixConv2d" and len(args) > 2:
                s = args[2]
            s_out = s_in * (2 if name == "Focus" else s)
            if name in _REPEATED:
                args = [args[0], n, *args[1:]]
        elif name == "Upsample":
            scale = args[1] if len(args) > 1 else 2
            method = args[2] if len(args) > 2 else "nearest"
            c2 = c1
            s_out = s_in / scale
            args = [scale, method]
        elif name == "Concat":
            c2 = sum(ch[x] for x in fs)
            args = []
        elif name == "MF":
            c2 = 64                         # 48 RGB + 16 IR channels
        elif name == "Detect":
            detect = (fs, tuple(ch[x] for x in fs),
                      tuple(strides[x] for x in fs))
            c2 = no
            args = []
        elif name == "Sum":
            c2 = c1
        elif name == "Contract":
            c2 = c1 * args[0] ** 2
            s_out = s_in * args[0]
        elif name == "Expand":
            c2 = c1 // args[0] ** 2
            s_out = s_in / args[0]
        else:
            raise KeyError(f"unknown module {mname!r} in config")
        out.append(LayerDef(i, fs, name, tuple(args), c1, c2))
        for x in fs:
            if x != i - 1:
                save.add(x)
        ch.append(c2)
        strides.append(s_out)
    return out, save, detect


def _encoder_def(name: str, args: list, ch_in: int):
    """The split backbone's LayerDef and its y seeds (channels, strides)."""
    if len(args) == 6:
        # [img_size, unused, embed_dim, in_chans, out_chans, window_size];
        # patch_size is forced to 4
        enc = dict(img_size=args[0], patch_size=4, embed_dim=args[2],
                   in_chans=args[3], out_chans=args[4], window_size=args[5])
    elif len(args) == 5:
        # SRyolo_resnet50.yaml's order: [img_size, patch_size, in_chans,
        # out_chans, window_size]
        enc = dict(img_size=args[0], patch_size=4, embed_dim=192,
                   in_chans=args[2], out_chans=args[3], window_size=args[4])
    else:
        raise ValueError(f"bad {name} args {args}")
    if name == "ImageEncoderSwinV2":
        # the V2 variant's width, necks and tap strides are fixed
        enc["embed_dim"] = 96
        ch, strides = [128, 256, 512], [4.0, 16.0, 32.0]
    else:
        oc = enc["out_chans"]
        ch, strides = [oc, oc, 2 * oc], [4.0, 8.0, 16.0]
    return (LayerDef(0, (-1,), name, tuple(sorted(enc.items())), ch_in,
                     ch[0]), ch, strides)


def parse_config(cfg, ch_in: int = 4, nc: int | None = None,
                 anchors=None) -> ModelSpec:
    """Parse a model YAML (path or dict) into a static ModelSpec; `nc` and
    `anchors` (per-level flat (w, h, ...) lists: autoanchor's refit)
    override the yaml's."""
    d = load_yaml(cfg)
    if nc is not None:
        d["nc"] = nc
    if anchors is not None:
        d["anchors"] = anchors
    nc = int(d["nc"])
    gd, gw = float(d["depth_multiple"]), float(d["width_multiple"])
    anchors = tuple(tuple(a) for a in d["anchors"])
    no = len(anchors[0]) // 2 * (nc + 5)
    bdefs, hdefs = d["backbone"], d["head"]

    steam: tuple = ()
    if d.get("steam"):
        # each modality's 3 channels go through the stem; the walk is
        # sequential, its `from` indices only informational
        parsed, _, _ = _parse_section(d["steam"], [3], [1.0], gd, gw, no,
                                      start=1)
        steam = tuple(LayerDef(ld.i + 999, tuple(x + 999 for x in ld.f),
                               ld.name, ld.args, ld.c1, ld.c2)
                      for ld in parsed)

    if len(bdefs) == 1 and bdefs[0][2] in SPLIT_BACKBONES:
        mode = "split"
        enc, ch, strides = _encoder_def(bdefs[0][2], list(bdefs[0][3]),
                                        ch_in)
        backbone = (enc,)
        head, save, detect = _parse_section(hdefs, ch, strides, gd, gw, no,
                                            start=3)
        save |= {0, 1, 2}
    else:
        mode = "unified"
        # y[j] is layer j's output; the walk seeds the input at index 0,
        # so the indices are rebased by +1 and shifted back after
        rebase = lambda f: (f if f == -1 else
                            [x if x == -1 else x + 1 for x in f]
                            if isinstance(f, (list, tuple)) else f + 1)
        ch = [2 * steam[-1].c2 if steam else ch_in]
        parsed, save, detect = _parse_section(
            [(rebase(f), n, m, a) for f, n, m, a in list(bdefs) + list(hdefs)],
            ch, [1.0], gd, gw, no, start=1)
        ch = ch[1:]
        parsed = [LayerDef(ld.i - 1, tuple(x - 1 for x in ld.f), ld.name,
                           ld.args, ld.c1, ld.c2) for ld in parsed]
        save = {x - 1 for x in save if x >= 1}
        if detect:
            detect = (tuple(x - 1 for x in detect[0]),) + detect[1:]
        backbone = tuple(parsed[:len(bdefs)])
        head = tuple(parsed[len(bdefs):])
    if detect is None:
        raise ValueError("config has no Detect layer")
    det_f, det_ch, det_s = detect

    sr_taps, sr_ch = (), ()
    if "l1" in d and "l2" in d:
        sr_taps = (int(d["l1"]), int(d["l2"]))
        sr_ch = (int(d.get("c1", 128)), int(d.get("c2", 512)))
    save |= set(sr_taps)
    return ModelSpec(mode=mode, nc=nc, anchors=anchors, backbone=backbone,
                     head=tuple(head), steam=steam, detect_from=det_f,
                     detect_ch=det_ch,
                     detect_strides=tuple(float(s) for s in det_s),
                     save=tuple(sorted(save)), sr_taps=sr_taps,
                     sr_ch=sr_ch, ch_in=ch_in, ch=tuple(ch))


def build_module(ld: LayerDef, remat: bool = False):
    """Instantiate the torch module for one LayerDef (registry dispatch);
    `remat` reaches the Swin encoders, whose blocks it checkpoints."""
    if ld.name in ("ImageEncoderViT", "ImageEncoderViTMono") and remat:
        return MODULE_REGISTRY[ld.name](ld, remat=True)
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


def _spp(ld):
    c2, *rest = ld.args
    return L.SPP(ld.c1, c2, k=tuple(rest[0]) if rest else (5, 9, 13))


def _focus(ld):
    c2, *rest = ld.args
    return L.Focus(ld.c1, c2, k=rest[0] if rest else 1)


def _upsample(ld):
    scale, method = ld.args
    return L.Upsample(scale=int(scale), method=str(method))


def _mf(ld):
    # the RGB+IR+MF route hands MF [rgb (c1 channels), ir[..., 0:1]]
    return L.MF(ld.c1, reduction=ld.args[0] if ld.args else 3)


def _bcsp(ld):
    c2, n, *rest = ld.args
    return L.BottleneckCSP(ld.c1, c2, n=n, shortcut=rest[0] if rest else True)


def _bcsp2(ld):
    c2, n, *rest = ld.args
    return L.BottleneckCSP2(ld.c1, c2, n=n,
                            shortcut=rest[0] if rest else False)


def _sppcsp(ld):
    c2, n, *_ = ld.args
    return L.SPPCSP(ld.c1, c2, n=n)


def _ghostconv(ld):
    c2, *rest = ld.args
    return L.GhostConv(ld.c1, c2, k=rest[0] if rest else 1,
                       s=rest[1] if len(rest) > 1 else 1)


def _acmix(ld):
    # yaml args after c2: [kernel_att, head, kernel_conv, stride]
    c2, *rest = ld.args
    get = lambda j, d: rest[j] if len(rest) > j else d
    return L.ACmix(ld.c1, c2, kernel_att=get(0, 7), head=get(1, 4),
                   kernel_conv=get(2, 3), s=get(3, 1))


def _sum(ld):
    a = ld.args
    return L.Sum(n=a[0] if a else 2, weight=a[1] if len(a) > 1 else False)


def _encoder(ld, remat=False):
    return ImageEncoderViT(**dict(ld.args), remat=remat)


def _encoder_mono(ld, remat=False):
    return ImageEncoderViT(**dict(ld.args), mono=True, remat=remat)


def _encoder_swinv2(ld):
    kw = dict(ld.args)
    kw.pop("out_chans", None)       # the necks are fixed in the V2 variant
    return ImageEncoderSwinV2(**kw)


MODULE_REGISTRY = {
    "Concat": lambda ld: L.Concat(),
    "Conv": _conv,
    "DWConv": _conv,
    "C3": _c3,
    "Bottleneck": _bottleneck,
    "SPP": _spp,
    "Focus": _focus,
    "Upsample": _upsample,
    "MF": _mf,
    "ImageEncoderViT": _encoder,
    "ImageEncoderViTMono": _encoder_mono,
    "ImageEncoderSwinV2": _encoder_swinv2,
    "BottleneckCSP": _bcsp,
    "BottleneckCSP2": _bcsp2,
    "SPPCSP": _sppcsp,
    "Contract": lambda ld: L.Contract(gain=ld.args[0]),
    "Expand": lambda ld: L.Expand(gain=ld.args[0]),
    "AttentionModel": lambda ld: L.AttentionModel(ld.c1),
    "GhostConv": _ghostconv,
    # JAX's constructors take these at their defaults whatever the yaml says
    "GhostBottleneck": lambda ld: L.GhostBottleneck(ld.c1, ld.args[0]),
    "CrossConv": lambda ld: L.CrossConv(ld.c1, ld.args[0]),
    "MixConv2d": lambda ld: L.MixConv2d(ld.c1, ld.args[0]),
    "ACmix": _acmix,
    "Sum": _sum,
}


def build_model(cfg, *, ch_in: int = 4, nc: int | None = None, anchors=None,
                dtype=None, input_mode: str = "RGB+IR", sr: bool = False,
                factor: int = 2, remat: bool = False):
    """Config -> DetectionModel (torch). See model.DetectionModel;
    `remat` checkpoints each Swin block of the encoder (ImageEncoderViT)."""
    import torch
    from .model import DetectionModel

    spec = parse_config(cfg, ch_in=ch_in, nc=nc, anchors=anchors)
    return DetectionModel(spec, input_mode=input_mode, sr=sr,
                          sr_factor=factor, dtype=dtype or torch.float32,
                          remat=remat)
