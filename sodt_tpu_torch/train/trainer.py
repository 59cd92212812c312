"""The training loop (`sodt_tpu/train/trainer.py`, the part that the port
covers).

VEDAI folders from the data yaml (`data.vedai.VedaiDataset`: its `train`
and `val` fold lists) or synthetic data, the hyp gain scaling of the JAX
trainer, and one of three feeds, chosen as JAX chooses:

  * the epoch path (`scan_epoch` None: when the uint8 tiles fit the bank
    gate and neither multi_scale nor rect is on; True: forced; False:
    never): the device tile bank (`data.loader.make_bank_feed`) and
    `state.make_epoch_scan`, one chunk of epochs up to the next eval (one
    epoch under image_weights) from a schedule uploaded once, the metrics
    fetched once a chunk; an epoch's losses are the mean over ALL its
    steps;
  * the per-step path (`state.make_train_step` over
    `data.loader.make_train_batches`: the bank when it fits, else
    streaming; its `feed:` line names the regime and the tile source), an
    epoch's losses the mean over every `log_every`-th step, as in JAX;
  * under `rect`, the rect feed (`make_rect_train_batches`: aspect-ratio
    groups, no mosaic; refused with multi_scale and image_weights, as in
    JAX), per step.

Then an eval of the EMA weights every `eval_every` epochs and at the
last, through ONE `EvalRunner` for the run (built by rank 0 before the
first epoch: its module takes the EMA weights in place at each eval, and
the val set is uploaded to the device once, `stack_cache="val"`), and
checkpoints in `save_dir`: `last.pt` after each eval, `best.pt` a copy of
it when the fitness is the best so far, `epoch{N}.pt` every `save_period`
epochs; `nosave` keeps only the final one. Saves are asynchronous, as in
JAX: the main thread takes a snapshot on the device
(`checkpoint.snapshot_tree`: the training updates the live tensors in
place, so the worker never reads them) and one worker thread fetches it
to the host and writes the files while the next epoch trains; at most one
save is in flight (the previous one is waited for, and its error raised,
before the next is submitted), and the final one has landed when `train`
returns. `max_labels` is the label slots an image of a padded batch
holds. `weights` loads initial weights (shape-matched, names with
"anchor" excluded); `resume` restores a run's full state from a checkpoint.
`image_weights` resamples the images by the per-class mAP of the last eval;
`multi_scale` draws each batch's size from 0.75 / 1 / 1.25 x img_size.

`autoanchor` (on by default, as in JAX) holds the config's anchors to the
training labels before the model is built: where their best possible
recall is under 0.98, k-means and a genetic search refit them
(`utils.autoanchor.check_anchors`, seeded by `seed`), and the model, its
Detect decode and the loss take the refit anchors. As in JAX, checkpoints
do not carry them: a later `val` of the run reads the config's.

`sr` trains the super-resolution branch beside the detector (`sr_factor`
its decoder's factor, `down_factor` the model input's reduction, as in
`state.make_train_step`); the evals run the EMA weights at full
resolution without it, as JAX's read only the Detect maps.

The run's record, as JAX writes it: `utils.loggers.RunLogger` appends
the TAGS of each eval and the epoch's wall-clock split (`wall/sched`,
`wall/dispatch`, `wall/fetch`, `wall/chunk` on the epoch path's first
epoch of a chunk; `wall/eval` and `wall/ckpt` (the main thread's blocking
part of a save) at evals, `wall/ckpt_fetch` and `wall/ckpt_write`
measured by the save's worker and logged, under the save's own epoch, by
the main thread once the save has landed; `wall/epoch` always) to
`events.jsonl`, and
to TensorBoard and W&B where they import (`wandb`: W&B scalars, the run
id in the checkpoint's "extra", model and dataset artifacts);
`LR.png`, `labels.png` and, at the end, `results.png` where matplotlib is
installed. `remat` checkpoints the encoder's Swin blocks
(`models.backbone.ImageEncoderViT`). `weights` may be a URL
(`utils.downloads.attempt_download`); `resume` may name a W&B artifact.
Hyperparameter evolution is `train.evolve.evolve` around `train`.

Data parallelism over processes (`parallel.mesh`: started by torchrun,
one process per card, `batch_size` the global batch): each rank feeds and
trains on its B / W rows of every step, with JAX's feed choice at W in
place of JAX's device and process counts (the epoch path only where W
divides the batch; a batch that W does not divide, and --rect at W > 1,
raise). Rank 0 alone evaluates the EMA on the whole validation set (JAX's
eval is not sharded) and writes the logs, plots and checkpoints; the
other ranks wait at a barrier and take rank 0's metrics.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import yaml

from .. import resolve_device
from ..data import (SyntheticVedai, VedaiDataset, apply_single_cls,
                    make_eval_batches)
from ..data.loader import (make_bank_feed, make_rect_train_batches,
                           make_train_batches)
from ..models import build_model
from ..models.compiler import parse_config
from ..parallel.mesh import (barrier, broadcast_object, init_from_env,
                             replicate_tree)
from ..utils.autoanchor import check_anchors
from ..utils.downloads import attempt_download
from ..utils.general import (labels_to_class_weights, labels_to_image_weights,
                             resolve_config_path)
from ..utils.loggers import RunLogger
from ..utils.metrics import fitness
from ..utils.plots import plot_labels, plot_lr_schedule, plot_results
from ..utils.wandb_utils import is_wandb_artifact, resolve_artifact_checkpoint
from ..weights import init_weights, load_npz
from .checkpoint import (clone_checkpoint, fetch_snapshot, load_checkpoint,
                         load_pretrained_variables, restore_train_state,
                         snapshot_tree, write_checkpoint)
from .evaluate import EvalRunner, evaluate
from .loss import LossConfig
from .optim import lr_schedules, make_optimizer
from .state import TrainState, make_epoch_scan, make_train_step

NOMINAL_BATCH = 64
CH_IN = {"RGB": 3, "IR": 3, "RGB+IR": 4, "RGB+IR+fusion": 8, "RGB+IR+MF": 3}


@dataclass
class TrainConfig:
    cfg: str = "configs/model.yaml"
    data: str = "configs/data_vedai.yaml"
    hyp: str = "configs/hyp.scratch.yaml"
    epochs: int = 300
    batch_size: int = 16
    img_size: int = 512
    input_mode: str = "RGB+IR"
    sr: bool = False                 # --super
    sr_factor: int = 1               # --factor
    down_factor: int = 1             # model input = img_size / down_factor
    adam: bool = False
    linear_lr: bool = False
    synthetic: bool = False
    synthetic_n: int = 64
    save_dir: str = "runs/train/exp"
    autoanchor: bool = True          # --noautoanchor turns it off
    image_weights: bool = False      # class-weighted image resampling
    multi_scale: bool = False        # 0.75 / 1 / 1.25 x img_size buckets
    rect: bool = False               # aspect-ratio batches, no mosaic
    seed: int = 0
    eval_every: int = 1
    max_labels: int = 30             # label slots per image in a batch
    log_every: int = 10              # per-step path: steps between samples
    bf16: bool = True
    remat: bool = False              # checkpoint the encoder's Swin blocks
    # the epoch path: None = when the tiles fit the bank gate and neither
    # multi_scale nor rect is on; True forces the bank, False the per-step
    # feed
    scan_epoch: bool | None = None
    wandb: bool = False              # W&B scalars and artifacts
    resume: str = ""                 # checkpoint to resume from
    weights: str = ""                # initial weights: checkpoint or .npz
    single_cls: bool = False         # all labels -> class 0, nc = 1
    nosave: bool = False             # only save the final checkpoint
    notest: bool = False             # only evaluate the final epoch
    nbs: int = NOMINAL_BATCH         # nominal batch for grad accumulation
    freeze: tuple = ()               # parameter-name substrings to freeze
    save_period: int = -1            # epoch-N checkpoints
    weights_npz: str = ""            # initial state_dict, loaded strictly
    device: str = "cuda"


def scale_hyp(hyp: dict, nl: int, nc: int, img_size: int) -> dict:
    """The loss gains scaled to the number of levels, classes and the
    image size, as the JAX trainer scales them."""
    hyp = dict(hyp)
    hyp["box"] = hyp["box"] * 3.0 / nl
    hyp["cls"] = hyp["cls"] * nc / 80.0 * 3.0 / nl
    hyp["obj"] = hyp["obj"] * (img_size / 640) ** 2 * 3.0 / nl
    return hyp


def loss_config(model, hyp: dict, nc: int) -> LossConfig:
    return LossConfig(
        nc=nc, anchors=model.spec.anchors, strides=model.spec.detect_strides,
        hyp_box=hyp["box"], hyp_obj=hyp["obj"], hyp_cls=hyp["cls"],
        cls_pw=hyp.get("cls_pw", 1.0), obj_pw=hyp.get("obj_pw", 1.0),
        anchor_t=hyp.get("anchor_t", 4.0), fl_gamma=hyp.get("fl_gamma", 0.0))


def fitness_from_metrics(m: dict) -> float:
    """`metrics.fitness` of one eval: 0.9 * mAP50 + 0.1 * mAP."""
    row = [[m.get(k, 0.0) for k in ("mp", "mr", "map50", "map")]]
    return float(fitness(np.asarray(row))[0])


def ema_model(state: TrainState) -> torch.nn.Module:
    """A copy of the model that holds the EMA weights and statistics, for
    the evals (the module of the run's `EvalRunner`): its SR branch is off
    (they read only the Detect maps)."""
    m = copy.deepcopy(state.model)
    m.load_state_dict(state.ema, strict=False)
    m.sr = False
    return m.eval()


def anchors_for(tc: TrainConfig, labels, hyp: dict, nc: int):
    """Autoanchor's refit of the config's anchors on the training labels
    (per-level flat lists for `build_model(anchors=)`), or None where they
    are kept; prints JAX's line either way. Too few labels for the
    k-means keeps them too, with JAX's "autoanchor skipped" line."""
    spec = parse_config(tc.cfg, ch_in=CH_IN[tc.input_mode], nc=nc)
    a0 = np.asarray(spec.anchors, np.float32).reshape(len(spec.anchors), -1,
                                                      2)
    shapes = np.full((len(labels), 2), tc.img_size, float)
    try:
        new, changed, bpr = check_anchors(
            labels, shapes, a0, img_size=tc.img_size,
            thr=hyp.get("anchor_t", 4.0), seed=tc.seed)
    except ValueError as e:
        print(f"autoanchor skipped: {e}")
        return None
    print(f"autoanchor: BPR {bpr:.4f}" + (" -> anchors refit" if changed
                                           else ""))
    return ([list(map(float, lvl.reshape(-1))) for lvl in new] if changed
            else None)


def _datasets(tc: TrainConfig, data_cfg: dict, nc: int):
    if tc.synthetic:
        train = SyntheticVedai(n=tc.synthetic_n, img_size=tc.img_size, nc=nc,
                               seed=tc.seed)
        val = SyntheticVedai(n=max(tc.synthetic_n // 4, 4),
                             img_size=tc.img_size, nc=nc, seed=tc.seed + 1)
    else:
        train = VedaiDataset(data_cfg["train"], img_size=tc.img_size)
        val = VedaiDataset(data_cfg.get("val", data_cfg.get("test")),
                           img_size=tc.img_size)
    if tc.single_cls:
        apply_single_cls(train)
        apply_single_cls(val)
    return train, val


def train(tc: TrainConfig, on_step=None, on_grads=None,
          on_start=None) -> dict:
    """Train, evaluate the EMA weights, save checkpoints, return the final
    metrics. Hooks for measurements: `on_start(state)` once before the
    first step (after --resume's restore), `on_step(state, metrics)` after
    every step (on the epoch path too: the only host read between its
    steps), `on_grads(grads)` with every step's gradients
    (`make_train_step`)."""
    dev = resolve_device(tc.device)
    mesh = init_from_env(dev)
    dev, world, main = mesh.device(dev), mesh.world, mesh.rank == 0
    if tc.batch_size % world:
        raise ValueError(f"batch_size {tc.batch_size} not divisible by "
                         f"process_count {world}")
    if tc.rect and (tc.multi_scale or tc.image_weights):
        raise ValueError("--rect is incompatible with --multi-scale and "
                         "--image-weights (rect disables mosaic)")
    if tc.rect and world > 1:
        # each rank's aspect-ratio groups would give it its own shape
        raise ValueError("--rect is single-host only")
    save_dir = Path(tc.save_dir)
    if main:
        save_dir.mkdir(parents=True, exist_ok=True)
    with open(resolve_config_path(tc.hyp)) as f:
        hyp = yaml.safe_load(f)
    with open(resolve_config_path(tc.data)) as f:
        data_cfg = yaml.safe_load(f)
    nc = 1 if tc.single_cls else int(data_cfg.get("nc", 8))
    if main:
        (save_dir / "hyp.yaml").write_text(yaml.safe_dump(hyp))
        (save_dir / "opt.yaml").write_text(yaml.safe_dump(
            {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in dataclasses.asdict(tc).items()}))
    dtype = torch.bfloat16 if tc.bf16 else torch.float32

    train_ds, val_ds = _datasets(tc, data_cfg, nc)
    anchors = (anchors_for(tc, train_ds.labels, hyp, nc) if tc.autoanchor
               else None)
    model = build_model(tc.cfg, ch_in=CH_IN[tc.input_mode], nc=nc,
                        anchors=anchors, dtype=dtype, input_mode=tc.input_mode, sr=tc.sr,
                        factor=tc.sr_factor, remat=tc.remat)
    if tc.weights_npz:
        model.load_state_dict(load_npz(tc.weights_npz))
    else:
        init_weights(model, seed=tc.seed)
    if tc.weights and not tc.resume:
        sd, n_hit, n_all = load_pretrained_variables(
            model.state_dict(), attempt_download(tc.weights))
        model.load_state_dict(sd)
        print(f"pretrained: {n_hit}/{n_all} arrays from {tc.weights}")
    model = replicate_tree(model.to(dev))
    # rect yields ceil(n / bs) groups an epoch (the tail group padded by
    # cycling); the other feeds drop the remainder
    nb = (max(-(-len(train_ds) // tc.batch_size), 1) if tc.rect
          else max(len(train_ds) // tc.batch_size, 1))
    accumulate = max(round(tc.nbs / tc.batch_size), 1)
    hyp = scale_hyp(hyp, len(model.spec.anchors), nc, tc.img_size)

    params = dict(model.named_parameters())
    tx = make_optimizer(hyp, params, epochs=tc.epochs, nb=nb, adam=tc.adam,
                        linear_lr=tc.linear_lr, accumulate=accumulate)
    state = TrainState.create(model, tx)
    start_epoch, best_fitness = 0, 0.0
    if tc.resume:
        if is_wandb_artifact(tc.resume):
            tc.resume = resolve_artifact_checkpoint(tc.resume)
        ckpt = load_checkpoint(tc.resume)
        restore_train_state(state, ckpt)
        start_epoch = int(ckpt["epoch"]) + 1
        best_fitness = float(ckpt["best_fitness"])
    step_fn = make_train_step(model, tx, loss_config(model, hyp, nc),
                              sr=tc.sr, down_factor=tc.down_factor,
                              freeze=tuple(tc.freeze), on_grads=on_grads)
    nparams = sum(p.numel() for p in params.values())
    print(f"model {tc.cfg} ({nparams / 1e6:.2f}M params), device {dev}, "
          f"nb={nb}/epoch, accumulate={accumulate}")

    logger = (RunLogger(save_dir, config=dataclasses.asdict(tc),
                        use_wandb=tc.wandb) if main else _Silent())
    if logger.lifecycle.active:
        logger.lifecycle.log_dataset(data_cfg)
    # the logged learning rates and LR.png read the schedules at the
    # optimizer step, as JAX's do (step x accumulate data iterations)
    lr_w, lr_b, _, _ = lr_schedules(hyp, tc.epochs, nb,
                                    linear_lr=tc.linear_lr,
                                    accumulate=accumulate)
    labelled = [l for l in train_ds.labels if len(l)]
    if main:
        plot_lr_schedule((lr_w, lr_b), max(tc.epochs * nb // accumulate, 2),
                         save_dir / "LR.png")
        if labelled:
            plot_labels(np.concatenate(labelled), save_dir, nc)

    maps = np.zeros(nc)
    cw0 = labels_to_class_weights(train_ds.labels, nc)

    def sample_weights():
        # cw * (1 - maps)^2 / nc -> per-image weights
        return labels_to_image_weights(train_ds.labels, nc,
                                       cw0 * (1 - maps) ** 2 / nc)

    weights_fn = sample_weights if tc.image_weights else None
    # JAX's choice: the epoch path where the bank fits (or is forced), else
    # the per-step feeds; each is positioned at the resumed step
    shards = dict(process_index=mesh.rank, process_count=world)
    feed = None
    if (tc.scan_epoch is not False and not tc.multi_scale and not tc.rect
            and tc.batch_size % world == 0):
        feed = make_bank_feed(
            train_ds, tc.batch_size, tc.img_size, hyp, seed=tc.seed,
            m0=tc.max_labels, sample_weights_fn=weights_fn, device=dev,
            start_step=start_epoch * nb,
            device_bank=True if tc.scan_epoch else None, **shards)
    if feed is not None:
        epoch_fn = make_epoch_scan(step_fn, feed)
        batches = None
        print(f"feed: device bank ({len(train_ds)} tiles in HBM), "
              f"epoch-scan dispatch over {world} device(s), {world} "
              f"process(es), tile source: {feed.source.name} "
              f"({feed.source.why})")
    elif tc.rect:
        batches = make_rect_train_batches(
            train_ds, tc.batch_size, tc.img_size, hyp, seed=tc.seed,
            max_labels_per_image=tc.max_labels, device=dev,
            start_step=start_epoch * nb)
    else:
        batches = make_train_batches(
            train_ds, tc.batch_size, tc.img_size, hyp, seed=tc.seed,
            max_labels_per_image=tc.max_labels, multi_scale=tc.multi_scale,
            device=dev, start_step=start_epoch * nb,
            sample_weights_fn=weights_fn, **shards)
    if on_start is not None:
        on_start(state)

    metrics_out: dict = {}
    history = []
    # one runner for the run (rank 0 alone evaluates) and one save worker
    runner = EvalRunner(ema_model(state)) if main else None
    saver = _Saver(save_dir, tc, logger)
    t_start = time.time()
    try:
        # the epoch path runs the epochs up to the next eval in one chunk (one
        # under image_weights, whose order reads the last eval's maps); the
        # chunk's later epochs report its rate and log their own walls only
        chunk_losses: dict[int, dict] = {}
        chunk_ips = 0.0
        for epoch in range(start_epoch, tc.epochs):
            t_epoch = time.time()
            wall = {}
            if feed is not None:
                if epoch not in chunk_losses:
                    cap = 1 if tc.image_weights else max(tc.eval_every, 1)
                    boundary = epoch + (cap - 1) - (epoch % cap)
                    n_ep = min(boundary, tc.epochs - 1) - epoch + 1
                    t0 = time.time()
                    scheds = [feed.epoch_schedule() for _ in range(n_ep)]
                    prim = np.concatenate([sc[0] for sc in scheds])
                    sec = (None if scheds[0][1] is None
                           else np.concatenate([sc[1] for sc in scheds]))
                    draws = np.concatenate([sc[2] for sc in scheds])
                    wall["sched"] = time.time() - t0
                    t0 = time.time()
                    state, keys, ms = epoch_fn(state, prim, sec, draws,
                                               on_step=on_step)
                    wall["dispatch"] = time.time() - t0
                    t0 = time.time()
                    ms = ms.cpu().numpy().reshape(
                        n_ep, feed.steps_per_epoch, len(keys))
                    chunk_losses = {
                        epoch + i: {k: float(np.mean(ms[i, :, j]))
                                    for j, k in enumerate(keys)}
                        for i in range(n_ep)}
                    wall["fetch"] = time.time() - t0
                    wall["chunk"] = n_ep
                    chunk_ips = (tc.batch_size * nb * n_ep
                                 / max(time.time() - t_epoch, 1e-9))
                mean_losses = chunk_losses.pop(epoch)
                ips = chunk_ips
            else:
                losses = []
                for bi in range(nb):
                    state, m = step_fn(state, next(batches))
                    if on_step is not None:
                        on_step(state, m)
                    if bi % tc.log_every == 0:
                        losses.append({k: float(v) for k, v in m.items()})
                mean_losses = ({k: float(np.mean([l[k] for l in losses]))
                                for k in losses[0]} if losses else {})
                ips = tc.batch_size * nb / (time.time() - t_epoch)
            line = (f"epoch {epoch}/{tc.epochs - 1} "
                    + " ".join(f"{k}={v:.4f}"
                               for k, v in mean_losses.items())
                    + f" img/s={ips:.1f}")
            is_final = epoch == tc.epochs - 1
            if is_final or (not tc.notest
                            and (epoch + 1) % tc.eval_every == 0):
                t0 = time.time()
                if main:
                    metrics_out = evaluate(
                        state.ema,
                        make_eval_batches(val_ds, tc.batch_size,
                                          tc.img_size),
                        nc=nc, img_size=tc.img_size, device=dev,
                        runner=runner, stack_cache="val")
                metrics_out = broadcast_object(metrics_out)
                fit = fitness_from_metrics(metrics_out)
                for c, v in metrics_out["per_class"].items():
                    if c < nc:
                        maps[c] = v["ap"]
                line += (f" mAP50={metrics_out['map50']:.4f} "
                         f"mAP={metrics_out['map']:.4f} fit={fit:.4f}")
                wall["eval"] = time.time() - t0
                t0 = time.time()
                opt_step = state.step // accumulate
                logger.log_epoch(epoch, mean_losses, metrics_out,
                                 lrs=(lr_w(opt_step), lr_w(opt_step),
                                      lr_b(opt_step)))
                best_fitness = max(best_fitness, fit)
                # ties refresh best too: the latest equal wins
                is_best = fit >= best_fitness
                if main:
                    saver.submit(state, epoch, best_fitness, is_best=is_best,
                                 is_final=is_final, fit=fit)
                    if is_final:
                        saver.wait()          # the last save lands first
                barrier()
                wall["ckpt"] = time.time() - t0
            wall["epoch"] = time.time() - t_epoch
            logger.log_scalars({f"wall/{k}": v for k, v in wall.items()},
                               epoch)
            if "eval" in wall:
                line += ("  [wall "
                         + " ".join(f"{k}={int(v)}" if k == "chunk"
                                    else f"{k}={v:.2f}s"
                                    for k, v in wall.items()) + "]")
            if main:
                print(line)
                with open(save_dir / "results.txt", "a") as f:
                    f.write(line + "\n")
            history.append(mean_losses)
        saver.wait()
    finally:
        saver.close()                 # an error waits for the save too
    logger.close()
    if main:
        plot_results(save_dir / "events.jsonl", save_dir / "results.png")
    metrics_out["train_time_s"] = time.time() - t_start
    metrics_out["losses"] = history
    metrics_out["steps"] = state.step
    metrics_out["best_fitness"] = best_fitness
    metrics_out["device"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
    return metrics_out


class _Silent:
    """The run logger of a rank other than 0: it writes nothing."""
    wandb_id = None

    class lifecycle:
        active = False

    def log_epoch(self, *a, **k):
        pass

    log_scalars = close = log_epoch


class _Saver:
    """The run's checkpoints on ONE worker thread, at most one save in
    flight (JAX's pipeline). `submit` waits for the previous save (its
    error is raised here), takes the snapshot on the calling thread and
    hands the fetch and the writes to the worker; `wait` collects the save
    in flight and logs its worker-measured `wall/ckpt_fetch` /
    `wall/ckpt_write` under its own epoch (and the W&B model artifact):
    every logger call stays on the main thread."""

    def __init__(self, save_dir: Path, tc: TrainConfig, logger):
        self.save_dir, self.tc, self.logger = save_dir, tc, logger
        self.pool = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="ckpt")
        self.pending = None

    def submit(self, state, epoch: int, best_fitness: float, *,
               is_best: bool, is_final: bool, fit: float) -> None:
        self.wait()
        tc = self.tc
        last = not tc.nosave or is_final
        period = (tc.save_period > 0 and (epoch + 1) % tc.save_period == 0
                  and not is_final)
        snap = None
        if last or period:
            snap = snapshot_tree(
                state, epoch=epoch, best_fitness=best_fitness,
                extra=({"wandb_id": self.logger.wandb_id}
                       if self.logger.wandb_id else None))
        fut = self.pool.submit(_write_saves, self.save_dir, snap, epoch,
                               last=last, best=last and is_best,
                               period=period)
        self.pending = (fut, epoch, fit, is_best)

    def wait(self) -> None:
        if self.pending is None:
            return
        (fut, epoch, fit, is_best), self.pending = self.pending, None
        t_fetch, t_write = fut.result()
        self.logger.log_scalars({"wall/ckpt_fetch": t_fetch,
                                 "wall/ckpt_write": t_write}, epoch)
        if self.logger.lifecycle.active:
            self.logger.lifecycle.log_model(self.save_dir / "last.pt",
                                            epoch=epoch, fitness=fit,
                                            best=is_best)

    def close(self) -> None:
        self.pool.shutdown(wait=True)


def _write_saves(save_dir: Path, snap, epoch: int, *, last: bool,
                 best: bool, period: bool) -> tuple[float, float]:
    """The worker's half of a save: the snapshot to the host, then
    last.pt (and best.pt, a copy of it) and epoch{N}.pt as asked. Returns
    the seconds of the fetch and of the last / best writes."""
    t0 = time.time()
    ckpt = None if snap is None else fetch_snapshot(snap)
    t1 = time.time()
    if last:
        write_checkpoint(save_dir / "last.pt", ckpt)
        if best:
            clone_checkpoint(save_dir / "last.pt", save_dir / "best.pt")
    t2 = time.time()
    if period:
        write_checkpoint(save_dir / f"epoch{epoch}.pt", ckpt)
    return t1 - t0, t2 - t1
