"""Convert a reference PyTorch checkpoint (.pt) into the port's weights
(`tools/import_torch.py` of the JAX system):

    python -m sodt_tpu_torch.tools.import_torch ref_best.pt --out best.npz \\
        [--cfg configs/model.yaml] [--input_mode RGB+IR] [--nc 8] \\
        [--key auto] [--ref-path REFERENCE_TREE] [--device cuda]

The output is a .npz state_dict (`weights.save_npz`, every value f32),
which `val`, `detect` and `train --weights` read; the JAX tool writes an
orbax directory there. The reference pickles whole nn.Modules into its
training checkpoints, so unpickling such a file needs the reference
package importable (--ref-path), as the reference's own attempt_load
does; plain state_dict files need nothing. A training checkpoint's dict
gives its `ema` entry, else `model` (--key picks one); the DDP prefix
`module.` is stripped. The names map through `utils/torch_import.py`:
a checkpoint with `image_encoder.*` keys is the flagship, anything else
goes through the CNN importer (`model.{i}.*` -> `l{i}`). The result is
loaded strictly into the port's model on --device before it is written.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import resolve_device
from ..models import build_model
from ..utils.downloads import attempt_download
from ..utils.torch_import import import_flagship_model, import_unified_model
from ..val import CH_IN
from ..weights import save_npz


def load_reference(src: str, *, key: str = "auto", ref_path: str = ""
                   ) -> dict[str, torch.Tensor]:
    """The reference state_dict in `src`, f32 wherever it holds floating
    values (half precision included), without the `module.` prefix."""
    # the safe path first: weights_only=True refuses arbitrary pickled
    # code. Full unpickling is needed only for whole-module checkpoints
    # and runs the checkpoint's (and --ref-path's import-time) code: the
    # warning makes that trust decision explicit
    try:
        obj = torch.load(src, map_location="cpu", weights_only=True)
    except Exception:
        print(f"WARNING: {src} is not a plain-tensor checkpoint; falling "
              "back to full unpickling, which executes code from the "
              ".pt file" + (" and imports the --ref-path package"
                            if ref_path else "") + ".", file=sys.stderr)
        if ref_path:
            sys.path.insert(0, ref_path)
        obj = torch.load(src, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and not hasattr(next(iter(obj.values())),
                                             "shape"):
        # a training checkpoint's dict: its ema, else its model
        keys = [key] if key != "auto" else ["ema", "model"]
        for k in keys:
            if obj.get(k) is not None:
                obj = obj[k]
                break
        else:
            raise KeyError(f"none of {keys} in checkpoint {list(obj)}")
    sd = obj.state_dict() if hasattr(obj, "state_dict") else dict(obj)
    return {(k[len("module."):] if k.startswith("module.") else k):
            (v.float() if torch.is_tensor(v) and v.is_floating_point()
             else v)
            for k, v in sd.items()}


def convert(src: str, cfg: str, out: str, *, input_mode: str = "RGB+IR",
            nc: int = 8, key: str = "auto", ref_path: str = "",
            device: str = "cuda") -> dict:
    """`src` -> the port's state_dict, checked by a strict load into the
    model of `cfg` on `device`, written to `out` as .npz."""
    dev = resolve_device(device)
    sd = load_reference(src, key=key, ref_path=ref_path)
    model = build_model(cfg, ch_in=CH_IN[input_mode], nc=nc,
                        input_mode=input_mode)
    if any(k.startswith("image_encoder.") for k in sd):
        state = import_flagship_model(sd, model.spec)
    else:
        state = import_unified_model(sd, model.spec)
    model.to(dev).load_state_dict(state)
    save_npz(state, out)
    return {"out": str(out), "torch_keys": len(sd), "arrays": len(state)}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("src", help=".pt checkpoint (pickled module dict or "
                               "plain state_dict)")
    p.add_argument("--cfg", default="configs/model.yaml",
                   help="matching model yaml")
    p.add_argument("--out", required=True, help="output .npz")
    p.add_argument("--input_mode", default="RGB+IR")
    p.add_argument("--nc", type=int, default=8)
    p.add_argument("--key", default="auto",
                   help="checkpoint dict entry: ema / model / auto")
    p.add_argument("--ref-path", default="",
                   help="path to the reference repo for pickled-module "
                        "checkpoints")
    p.add_argument("--device", "--platform", default="cuda")
    return p


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    resolve_device(a.device)
    a.src = attempt_download(a.src)  # a URL or a missing release file
    result = convert(**vars(a))
    print(result)
    return result


if __name__ == "__main__":
    main()
