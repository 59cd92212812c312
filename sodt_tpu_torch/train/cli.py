"""Training CLI of the port (`train.py` of the JAX package), on the card.

    python -m sodt_tpu_torch.train --synthetic --synthetic-n 16 \\
        --img-size 512 --batch-size 4 --nbs 4 --epochs 2 --notest

Takes the JAX `train.py` flags that this slice covers under their own
names, plus --device (default cuda; raises when no card is visible,
--device cpu runs the plain PyTorch path) and --weights-npz (initial
weights, else a seeded initialization). Synthetic data only; the other
flags of `train.py` raise, naming the ROADMAP item they wait for. Prints
one metrics JSON line.
"""

from __future__ import annotations

import argparse
import json

from .trainer import TrainConfig, train

# flags of the JAX train.py that are not ported yet -> ROADMAP.md Queue 1 item
UNPORTED = {
    "--weights": 9, "--resume": 9, "--save-dir": 9, "--nosave": 9,
    "--save-period": 9, "--image-weights": 9, "--multi-scale": 9,
    "--rect": 9, "--single-cls": 9, "--super": 10, "--factor": 10,
    "--down-factor": 10, "--noautoanchor": 11, "--evolve": 11, "--wandb": 11,
    "--remat": 11, "--scan-epoch": 11, "--eval-every": 9,
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", default="configs/model.yaml")
    p.add_argument("--data", default="configs/data_vedai.yaml")
    p.add_argument("--hyp", default="configs/hyp.scratch.yaml")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", "--train_img_size", type=int, default=512)
    p.add_argument("--input_mode", default="RGB+IR")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-bf16", action="store_false", dest="bf16")
    p.add_argument("--notest", action="store_true",
                   help="only evaluate the final epoch")
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch size for gradient accumulation")
    p.add_argument("--freeze", default="",
                   help="comma-separated parameter-name substrings to freeze")
    p.add_argument("--weights-npz", default="",
                   help="initial weights: a state_dict saved with "
                        "sodt_tpu_torch.weights.save_npz (as val takes it)")
    p.add_argument("--device", default="cuda")
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def main(argv=None, on_step=None, on_grads=None) -> dict:
    """Parse, train, print the metrics line. `on_step` and `on_grads` are
    passed on to `trainer.train` (hooks for measurements)."""
    a = parser().parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(a, flag.lstrip("-").replace("-", "_")) is not None:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP.md Queue 1 item {item}")
    tc = TrainConfig(cfg=a.cfg, data=a.data, hyp=a.hyp, epochs=a.epochs,
                     batch_size=a.batch_size, img_size=a.img_size,
                     input_mode=a.input_mode, adam=a.adam,
                     linear_lr=a.linear_lr, synthetic=a.synthetic,
                     synthetic_n=a.synthetic_n, seed=a.seed, bf16=a.bf16,
                     notest=a.notest, nbs=a.nbs,
                     freeze=tuple(s for s in a.freeze.split(",") if s),
                     weights_npz=a.weights_npz, device=a.device)
    m = train(tc, on_step=on_step, on_grads=on_grads)
    print(json.dumps({k: v for k, v in m.items()
                      if isinstance(v, (int, float, str))}))
    return m


if __name__ == "__main__":
    main()
