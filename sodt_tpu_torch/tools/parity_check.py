"""One-command reference-parity check: a reference .pt -> the port's
weights -> mAP (`tools/parity_check.py` of the JAX system):

    python -m sodt_tpu_torch.tools.parity_check --pt reference_best.pt \\
        --data configs/data_vedai.yaml [--ref-map50 0.764] [--device cuda]

  1. convert the reference checkpoint (`import_torch`: a state_dict, or a
     whole-module .pt with --ref-path) into <save-dir>/imported.npz (--out),
  2. run the mAP protocol of `val` (conf 0.001, IoU 0.6; --task, --rect,
     --single-cls, --synthetic / --synthetic-n, --no-bf16) on the dataset
     named by --data,
  3. print one JSON line {map50, map, weights[, ref_map50, delta_pts,
     pass]}: with --ref-map50 (0-1 or percent) `pass` is |delta| <= 0.3
     points, and the exit status is 1 where it is false.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .. import resolve_device, val as val_cli
from .import_torch import convert

PASS_PTS = 0.3          # BASELINE.md's acceptance gate, in mAP points


def run(pt: str, cfg: str, data: str, *, out: str = "",
        input_mode: str = "RGB+IR", nc: int = 8, key: str = "auto",
        ref_path: str = "", img_size: int = 512, batch_size: int = 8,
        task: str = "val", rect: bool = False, synthetic: bool = False,
        synthetic_n: int = 16, bf16: bool = True,
        ref_map50: float | None = None, save_dir: str = "runs/parity",
        single_cls: bool = False, device: str = "cuda") -> dict:
    resolve_device(device)
    out = out or str(Path(save_dir) / "imported.npz")
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    convert(pt, cfg, out, input_mode=input_mode, nc=nc, key=key,
            ref_path=ref_path, device=device)

    a = val_cli.parser().parse_args([])
    vars(a).update(
        cfg=cfg, data=data, weights=out, task=task, batch_size=batch_size,
        img_size=img_size, conf_thres=0.001, iou_thres=0.6,
        input_mode=input_mode, synthetic=synthetic, synthetic_n=synthetic_n,
        bf16=bf16, save_dir=save_dir, single_cls=single_cls, rect=rect,
        device=device)
    m = val_cli.run_map(a, img_size)

    result = {"map50": round(float(m["map50"]), 4),
              "map": round(float(m["map"]), 4),
              "weights": out}
    if ref_map50 is not None:
        # the reference number in either convention (0.764 or 76.4)
        ref01 = ref_map50 / 100.0 if ref_map50 > 1 else ref_map50
        delta = 100.0 * (float(m["map50"]) - ref01)
        result.update(ref_map50=ref01, delta_pts=round(delta, 2),
                      **{"pass": bool(abs(delta) <= PASS_PTS)})
    return result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pt", required=True,
                   help="reference PyTorch checkpoint (.pt)")
    p.add_argument("--cfg", default="configs/model.yaml")
    p.add_argument("--data", default="configs/data_vedai.yaml")
    p.add_argument("--out", default="", help="the imported .npz "
                   "(default <save-dir>/imported.npz)")
    p.add_argument("--input_mode", default="RGB+IR")
    p.add_argument("--nc", type=int, default=8)
    p.add_argument("--key", default="auto", help="checkpoint dict key "
                   "(ema/model/auto)")
    p.add_argument("--ref-path", default="", help="reference repo path "
                   "for whole-module .pt unpickling")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--task", default="val", choices=["val", "test"])
    p.add_argument("--rect", action="store_true")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="run the wiring on the synthetic dataset")
    p.add_argument("--synthetic-n", type=int, default=16)
    p.add_argument("--no-bf16", action="store_false", dest="bf16")
    p.add_argument("--ref-map50", type=float, default=None,
                   help="reference mAP@0.5 to compare against "
                        "(0-1 or percent); enables the 0.3 point gate")
    p.add_argument("--save-dir", default="runs/parity")
    p.add_argument("--device", "--platform", default="cuda")
    return p


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    result = run(a.pt, a.cfg, a.data, out=a.out, input_mode=a.input_mode,
                 nc=a.nc, key=a.key, ref_path=a.ref_path,
                 img_size=a.img_size, batch_size=a.batch_size, task=a.task,
                 rect=a.rect, synthetic=a.synthetic,
                 synthetic_n=a.synthetic_n, bf16=a.bf16,
                 ref_map50=a.ref_map50, save_dir=a.save_dir,
                 single_cls=a.single_cls, device=a.device)
    print(json.dumps(result))
    return 0 if result.get("pass", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
