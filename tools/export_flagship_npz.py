#!/usr/bin/env python
"""Export the trained flagship's EMA weights for the PyTorch port.

    python tools/export_flagship_npz.py

Runs on the CPU with JAX. Reads the orbax checkpoint
`runs/flagship_r5_150ep/best_stripped` through
`sodt_tpu.train.checkpoint.load_checkpoint` and `eval_variables` (the EMA
weights), maps them onto the port's names with
`sodt_tpu_torch.weights.from_jax_variables` and writes

  checkpoints/flagship_r5_150ep_ema.npz   float32, bit-equal, deflated
  checkpoints/flagship_r5_150ep_ema.json  the npz's sha256, its source, and
                                          JAX's own mAP@0.5 and mAP@0.5:0.95
                                          for these weights on
                                          SyntheticVedai(n=16, seed=1) at
                                          512 px, batch 4, with val.py's
                                          eval settings (conf 0.001, iou
                                          0.6): in f32 (`jax_f32_eval`), in
                                          bf16 (`jax_bf16_eval`, the compose
                                          path: no Pallas kernel runs on the
                                          CPU) and in f32 with test-time
                                          augmentation (`jax_f32_tta_eval`,
                                          `evaluate(augment=True)`)

The npz is written only where its bytes change, so its sha256 stays put
when only the sidecar's evaluations are made again.

The machine with the card has no JAX and no orbax: the npz is how the
trained weights reach it (`val --weights`, `train --weights`).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = "runs/flagship_r5_150ep/best_stripped"
OUT = "checkpoints/flagship_r5_150ep_ema.npz"
EVAL = {"dataset": "SyntheticVedai(n=16, img_size=512, nc=8, seed=1)",
        "img_size": 512, "batch_size": 4, "conf_thres": 0.001,
        "iou_thres": 0.6, "dtype": "float32", "cfg": "configs/model.yaml"}


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def jax_map(variables, dtype: str = "float32", augment: bool = False) -> dict:
    """JAX's eval of `variables` under EVAL's settings in `dtype`, with
    test-time augmentation when `augment`."""
    import jax.numpy as jnp
    from sodt_tpu.data import SyntheticVedai
    from sodt_tpu.data.loader import make_eval_batches
    from sodt_tpu.models import build_model
    from sodt_tpu.train.evaluate import evaluate

    model = build_model(EVAL["cfg"], ch_in=4, nc=8,
                        dtype=getattr(jnp, dtype), input_mode="RGB+IR")
    ds = SyntheticVedai(n=16, img_size=512, nc=8, seed=1)
    m = evaluate(model, variables,
                 make_eval_batches(ds, EVAL["batch_size"], EVAL["img_size"]),
                 nc=8, img_size=EVAL["img_size"],
                 conf_thres=EVAL["conf_thres"], iou_thres=EVAL["iou_thres"],
                 augment=augment)
    return dict(EVAL, dtype=dtype, augment=augment) | {
        k: float(m[k]) for k in ("map50", "map", "mp", "mr")} | {
        "seen": int(m["seen"])}


def main() -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sodt_tpu.train.checkpoint import eval_variables, load_checkpoint
    from sodt_tpu_torch.weights import from_jax_variables, save_npz

    variables = jax.tree.map(np.asarray,
                             eval_variables(load_checkpoint(ROOT / SOURCE)))
    sd = from_jax_variables(variables)
    out = ROOT / OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.stem + ".tmp.npz")
    save_npz(sd, tmp, compressed=True)
    if out.exists() and sha256(out) == sha256(tmp):
        tmp.unlink()
    else:
        tmp.replace(out)
    side = {"npz": OUT, "sha256": sha256(out), "bytes": out.stat().st_size,
            "arrays": len(sd), "dtype": "float32",
            "source": SOURCE + " (EMA variables: eval_variables)",
            "converted_by": "sodt_tpu_torch.weights.from_jax_variables",
            "written_by": "tools/export_flagship_npz.py",
            "jax_f32_eval": jax_map(variables),
            "jax_bf16_eval": jax_map(variables, "bfloat16"),
            "jax_f32_tta_eval": jax_map(variables, augment=True)}
    out.with_suffix(".json").write_text(json.dumps(side, indent=1) + "\n")
    print(json.dumps(side))
    return side


if __name__ == "__main__":
    main()
