"""Training CLI of the port (`train.py` of the JAX package), on the card.

    python -m sodt_tpu_torch.train --synthetic --synthetic-n 16 \\
        --img-size 512 --batch-size 4 --nbs 4 --epochs 2 \\
        --weights checkpoints/flagship_r5_150ep_ema.npz --save-dir runs/ft
    python -m sodt_tpu_torch.train --data data.yaml --img-size 512 \
        --batch-size 4 --weights checkpoints/flagship_r5_150ep_ema.npz
    python -m sodt_tpu_torch.train --resume runs/ft/last.pt
    python -m sodt_tpu_torch.train --cfg SRyolo_MF.yaml \
        --input_mode RGB+IR+MF --super --factor 2 --down-factor 2 \
        --synthetic --img-size 1024 --batch-size 4
    python -m sodt_tpu_torch.train --synthetic --img-size 512 --remat \
        --scan-epoch off --wandb
    python -m sodt_tpu_torch.train --synthetic --img-size 256 --evolve 30
    torchrun --standalone --nproc_per_node 2 -m sodt_tpu_torch.train \
        --synthetic --img-size 512 --batch-size 8

Takes the JAX `train.py` flags that the port covers under their own names
and meanings (--weights: initial weights from a checkpoint or a .npz,
shape-matched; --resume: a checkpoint whose run's opt.yaml is reloaded, so
no other flag is needed; --save-dir, --nosave, --save-period,
--eval-every, --multi-scale, --image-weights, --single-cls, --rect,
--noautoanchor: keep the config's anchors, which autoanchor otherwise
refits where their best possible recall on the training labels is under
0.98; --super / --factor / --down-factor: the SR branch, which fails at
--factor 1 as JAX's does, here with a ValueError that names it), plus
--scan-epoch auto|on|off: the epoch path, on where the tiles fit the bank
gate and neither --multi-scale nor --rect is set, forced on or off;
--remat: checkpoint the encoder's Swin blocks, their forward run again in
the backward; --wandb: W&B scalars and artifacts where wandb is
installed; --evolve N: N generations of hyperparameter evolution, each a
training run in <save-dir>/gen{i}, evolve.txt and hyp_evolved.yaml in
--save-dir), plus --device (default cuda; raises when no card is visible,
--device cpu runs the plain PyTorch path; --platform is the same flag
under JAX's name) and --weights-npz (a state_dict loaded strictly, else a
seeded initialization). Under torchrun (RANK / WORLD_SIZE / LOCAL_RANK
set) the run is data-parallel, one process per card (`parallel.mesh`:
nccl on the card, gloo with --device cpu): --batch-size is the global
batch, which the process count must divide; rank 0 evaluates and writes
the files. Data: the VEDAI fold lists of the --data yaml (`train`, `val`;
PNG folders, decoded by the port itself), or --synthetic. Prints one metrics JSON line (--evolve: the best
fitness).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch.distributed as dist
import yaml

from .evolve import evolve
from .trainer import TrainConfig, train

SCAN_EPOCH = {None: None, "auto": None, "on": True, "off": False}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--weights", default="",
                   help="initial weights, a checkpoint or a .npz: "
                        "shape-matched load, fresh optimizer; use --resume "
                        "for the full state")
    p.add_argument("--single-cls", action="store_true",
                   help="train multi-class data as single-class")
    p.add_argument("--nosave", action="store_true",
                   help="only save the final checkpoint")
    p.add_argument("--notest", action="store_true",
                   help="only evaluate the final epoch")
    p.add_argument("--cfg", default="configs/model.yaml")
    p.add_argument("--data", default="configs/data_vedai.yaml")
    p.add_argument("--hyp", default="configs/hyp.scratch.yaml")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--img-size", "--train_img_size", type=int, default=512)
    p.add_argument("--input_mode", default="RGB+IR")
    p.add_argument("--super", action="store_true", dest="sr",
                   help="train the super-resolution auxiliary branch")
    p.add_argument("--factor", type=int, default=1, dest="sr_factor",
                   help="the SR decoder's factor (the branch needs >= 2)")
    p.add_argument("--down-factor", type=int, default=1,
                   help="model input = img-size / down-factor (SR regime)")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-n", type=int, default=64)
    p.add_argument("--save-dir", "--project", default="runs/train/exp",
                   dest="save_dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--no-bf16", action="store_false", dest="bf16")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize the encoder's Swin blocks in the "
                        "backward (less memory, one more forward of them)")
    p.add_argument("--resume", default="",
                   help="checkpoint to resume from (parameters, optimizer, "
                        "EMA, step, epoch, best fitness); the run's opt.yaml "
                        "beside it is reloaded, so no other flag is needed")
    p.add_argument("--noautoanchor", action="store_false", dest="autoanchor",
                   help="keep the config's anchors (autoanchor refits them "
                        "where their best possible recall is under 0.98)")
    p.add_argument("--image-weights", action="store_true")
    p.add_argument("--rect", action="store_true",
                   help="rectangular training: aspect-ratio batches, each "
                        "letterboxed to its own shape, no mosaic")
    p.add_argument("--multi-scale", action="store_true")
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch size for gradient accumulation")
    p.add_argument("--save-period", type=int, default=-1,
                   help="save an epoch checkpoint every N epochs; -1 "
                        "disables")
    p.add_argument("--freeze", default="",
                   help="comma-separated parameter-name substrings to freeze")
    p.add_argument("--weights-npz", default="",
                   help="initial weights: a state_dict saved with "
                        "sodt_tpu_torch.weights.save_npz, loaded strictly "
                        "(as val takes it)")
    p.add_argument("--scan-epoch", default=None,
                   choices=["auto", "on", "off"],
                   help="the epoch path: whole epochs from a device tile "
                        "bank, the metrics fetched once a chunk (auto: on "
                        "when the tiles fit the bank gate and neither "
                        "--multi-scale nor --rect is set)")
    p.add_argument("--evolve", type=int, default=0, metavar="GENERATIONS",
                   help="evolve the hyperparameters for N generations")
    p.add_argument("--wandb", action="store_true",
                   help="W&B scalars and artifacts (needs wandb)")
    p.add_argument("--device", "--platform", default="cuda",
                   help="cuda (the default; one card a process under "
                        "torchrun) or cpu")
    return p


def resume_config(resume: str) -> TrainConfig | None:
    """The run's TrainConfig from the opt.yaml beside the checkpoint (None
    when there is none: the flags given are used)."""
    opt_path = Path(resume).resolve().parent / "opt.yaml"
    if not opt_path.is_file():
        return None
    opt = yaml.safe_load(opt_path.read_text())
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in opt.items() if k in fields}
    kw["freeze"] = tuple(kw.get("freeze") or ())
    kw["resume"] = resume
    print(f"Resuming from {resume} with {opt_path}")
    return TrainConfig(**kw)


def main(argv=None, on_step=None, on_grads=None, on_start=None) -> dict:
    """Parse, train (or evolve), print the metrics line. `on_step`,
    `on_grads` and `on_start` are passed on to `trainer.train` (hooks for
    measurements; not to the runs of --evolve)."""
    a = parser().parse_args(argv)
    tc = resume_config(a.resume) if a.resume else None
    if tc is None:
        tc = TrainConfig(cfg=a.cfg, data=a.data, hyp=a.hyp, epochs=a.epochs,
                         batch_size=a.batch_size, img_size=a.img_size,
                         input_mode=a.input_mode, sr=a.sr,
                         sr_factor=a.sr_factor, down_factor=a.down_factor,
                         adam=a.adam,
                         linear_lr=a.linear_lr, synthetic=a.synthetic,
                         synthetic_n=a.synthetic_n, save_dir=a.save_dir,
                         autoanchor=a.autoanchor,
                         image_weights=a.image_weights,
                         multi_scale=a.multi_scale, rect=a.rect,
                         seed=a.seed,
                         eval_every=a.eval_every, bf16=a.bf16,
                         remat=a.remat, scan_epoch=SCAN_EPOCH[a.scan_epoch],
                         wandb=a.wandb, resume=a.resume, weights=a.weights,
                         single_cls=a.single_cls, nosave=a.nosave,
                         notest=a.notest, nbs=a.nbs,
                         freeze=tuple(s for s in a.freeze.split(",") if s),
                         save_period=a.save_period,
                         weights_npz=a.weights_npz, device=a.device)
    started = not dist.is_initialized()
    try:
        return _run(a, tc, on_step, on_grads, on_start)
    finally:
        # a process group that this run started ends with it
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(a, tc, on_step, on_grads, on_start) -> dict:
    if a.evolve > 0:
        best_hyp, best_fit = evolve(tc, generations=a.evolve, seed=tc.seed)
        print(json.dumps({"best_fitness": best_fit}))
        return {"best_fitness": best_fit, "hyp": best_hyp}
    m = train(tc, on_step=on_step, on_grads=on_grads, on_start=on_start)
    print(json.dumps({k: v for k, v in m.items()
                      if isinstance(v, (int, float, str))}))
    return m


if __name__ == "__main__":
    main()
