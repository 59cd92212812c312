"""The feeds (`sodt_tpu/data/loader.py`): padded labels, the tile sources,
the device tile bank, the streaming regime and the augmentation of a
batch; rect training; the eval batches, square and rect.

  host:    numpy tiles (uint8) and padded labels, the index schedule
           (`_order`, `_step_indices`: numpy in JAX too, copied so that the
           same seed gives the same `prim` / `sec` arrays), and one step's
           augmentation draws (`augment.augment_draws`, from a Generator
           keyed by (seed, step));
  device:  gather -> mosaic-4 -> perspective -> HSV -> flips -> mixup, all
           batched (`augment_batch`).

Two regimes, as in JAX: the device bank (every uint8 tile uploaded once
when the rgb + ir tiles fit `DEVICE_BANK_MAX_GB`, or forced either way by
`device_bank`; a step sends the (B, 4) indices and the draws) and
streaming (tiles read on the host, sent as uint8). JAX's switches keep
their meanings: `epochs` (stop after n epochs), `cache`, `mosaic` (False:
the letterbox-only path), `prefer_native`, `multi_scale_buckets`,
`scale_seed`. Tiles come from a tile source: the port's C++ tile loader
(`csrc/tile_loader.cpp`, built at first use into `libsodt_tiles.so`) where
it builds, else the python dataset; the feed prints which and why on its
`feed:` line. Batches are dicts of tensors on the device: img / ir (B, S, S, 3)
float in [0, 1], targets (B, N, 5) [cls, cx, cy, w, h] normalized, tmask
(B, N) bool.

Both regimes take `start_step`: the schedule, the draws and the multi-scale
stream are run forward to that step without touching a tile, so that
--resume continues the stream where the saved run left it (the JAX package
restarts its stream from the seed on resume). Without --image-weights a
resumed run then sees the batches of the uninterrupted run. Under
--image-weights it need not: the checkpoint holds no per-class maps (nor
does JAX's), so the first resumed epoch draws its order from the class
weights alone, where the uninterrupted run used the last eval's maps.

Rect training (`make_rect_train_batches`) keeps JAX's aspect-ratio groups
and their order (the same numpy Generator calls); its augmentation draws
follow the port's convention, a Generator keyed by (seed, epoch * groups +
group). Eval batches stay uint8 numpy (`make_eval_batches`).

The bank serves two protocols, as in JAX: one step at a time
(`augment_step`, the per-step feed) and a whole epoch's schedule at once
(`epoch_schedule`, the trainer's epoch path: `train.state.make_epoch_scan`
uploads it once and runs the epoch's steps from it). Both consume the
generator alike, so at one seed they give the same sample stream.
"""

from __future__ import annotations

import itertools
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from .augment import (WARP, PerspectiveParams, augment_draws, draw_cols,
                      flip_draws, flips, hsv_apply, hsv_draws, mosaic4,
                      perspective_draws, random_perspective, warp_draws)
from .synthetic import pad_labels
from ..ops.boxes import xywhn2xyxy
from ..ops.letterbox import letterbox_image_np, letterbox_params
from ..ops.resize import resize_bilinear

DEVICE_BANK_MAX_GB = 1.5  # device-bank gate: rgb + ir uint8 tiles must fit


class RamCache:
    """Decode-once RAM cache over a dataset."""

    def __init__(self, dataset):
        self.dataset = dataset
        self._cache: dict[int, tuple] = {}

    def __getitem__(self, i):
        if i not in self._cache:
            self._cache[i] = self.dataset[i]
        return self._cache[i]


def augment_batch(rgb4, ir4, lab4, msk4, rgb4b, ir4b, lab4b, msk4b,
                  draws: torch.Tensor, *, s: int, hyp: dict, use_mixup: bool,
                  mosaic_p: float = 1.0):
    """The full training augmentation of a batch (JAX's `_augment_one`,
    vmapped there).

    rgb4 / ir4: (B, 4, s, s, 3) tiles (uint8); lab4 (B, 4, M, 5) xywhn with
    the class in column 0, msk4 (B, 4, M). The *b operands feed mixup's
    second mosaic. draws: (B, N_DRAWS) from `augment_draws`. `mosaic_p`
    gates the mosaic per sample; the other samples take the single-tile
    branch (tile 0 + the same perspective, its own warp draws), whose
    labels are padded to the mosaic's capacity so that the batch shape
    does not depend on the branch. Returns img, ir (B, s, s, 3) in [0, 1],
    targets (B, N, 5), tmask (B, N)."""
    p = PerspectiveParams.from_hyp(hyp)
    b = rgb4.shape[0]

    def one_mosaic(r4, i4, l4, k4, warp, center):
        lab_px = xywhn2xyxy(l4[..., 1:5], s, s)
        canvas, canvas_ir, labels, mask = mosaic4(
            r4, i4, lab_px, k4, draw_cols(draws, center), s)
        img, ir, labels, mask = random_perspective(
            canvas, canvas_ir, labels, mask, draw_cols(draws, warp), p, (s, s))
        return img, ir, labels, mask, l4[..., 0].reshape(b, -1)

    def one_single():
        lab_px = xywhn2xyxy(lab4[:, 0, :, 1:5], s, s)
        img, ir, labels, mask = random_perspective(
            rgb4[:, 0], ir4[:, 0], lab_px, msk4[:, 0],
            draw_cols(draws, "warp_s"), p, (s, s))
        return img, ir, labels, mask, lab4[:, 0, :, 0]

    if mosaic_p > 0.0:
        img, ir, labels, mask, cls = one_mosaic(rgb4, ir4, lab4, msk4,
                                                "warp_a", "center_a")
        if use_mixup:
            img2, ir2, lab2, msk2, cls2 = one_mosaic(
                rgb4b, ir4b, lab4b, msk4b, "warp_b", "center_b")
            do, lam = draw_cols(draws, "mix").unbind(1)
            do = do > 0
            w = lam[:, None, None, None]
            img = torch.where(do[:, None, None, None],
                              img * w + img2 * (1 - w), img)
            ir = torch.where(do[:, None, None, None],
                             ir * w + ir2 * (1 - w), ir)
            # the second sample's labels switch on only under mixup
            labels = torch.cat([labels, lab2], 1)
            mask = torch.cat([mask, msk2 & do[:, None]], 1)
            cls = torch.cat([cls, cls2], 1)
    if mosaic_p < 1.0:
        imgS, irS, labS, mskS, clsS = one_single()
        if mosaic_p <= 0.0:
            img, ir, labels, mask, cls = imgS, irS, labS, mskS, clsS
        else:
            extra = labels.shape[1] - labS.shape[1]
            labS = torch.cat([labS, labS.new_zeros(b, extra, 4)], 1)
            mskS = torch.cat([mskS, mskS.new_zeros(b, extra)], 1)
            clsS = torch.cat([clsS, clsS.new_zeros(b, extra)], 1)
            do_m = draw_cols(draws, "mosaic")[:, 0] > 0
            px = do_m[:, None, None, None]
            img = torch.where(px, img, imgS)
            ir = torch.where(px, ir, irS)
            labels = torch.where(do_m[:, None, None], labels, labS)
            mask = torch.where(do_m[:, None], mask, mskS)
            cls = torch.where(do_m[:, None], cls, clsS)

    img = hsv_apply(img, draw_cols(draws, "hsv"))

    # xyxy pixels -> normalized xywh, the class in column 0
    lab_n = torch.stack([(labels[..., 0] + labels[..., 2]) / 2 / s,
                         (labels[..., 1] + labels[..., 3]) / 2 / s,
                         (labels[..., 2] - labels[..., 0]) / s,
                         (labels[..., 3] - labels[..., 1]) / s], -1)
    ud, lr = (draw_cols(draws, "flip") > 0).unbind(1)
    img, ir, targets, mask = flips(
        img, ir, torch.cat([cls[..., None], lab_n], -1), mask, ud, lr)
    return img / 255.0, ir / 255.0, targets, mask


class PyTileSource:
    """Tiles through the python dataset: `submit` only records the indices,
    `wait` reads them (stacked uint8 rgb and ir)."""

    name = "python"

    def __init__(self, ds, why: str):
        self.ds = ds
        self.why = why

    def submit(self, flat_idx):
        return flat_idx

    def wait(self, flat_idx):
        items = [self.ds[int(j)] for j in flat_idx]
        return (np.stack([rgb for rgb, _, _ in items]),
                np.stack([ir for _, ir, _ in items]))


class NativeTileSource:
    """Tiles through the port's C++ prefetch loader (`native_loader`,
    `csrc/tile_loader.cpp`): `submit` starts the decode on its worker,
    `wait` collects it."""

    name = "native"
    why = "libsodt_tiles.so built from csrc/tile_loader.cpp"

    def __init__(self, ds, img_size: int, cache: bool):
        from .native_loader import NativeTileLoader
        self.loader = NativeTileLoader(ds.img_files, ds.ir_files, img_size,
                                       cache_gb=8.0 if cache else 0.0)

    def submit(self, flat_idx):
        return self.loader.submit(np.asarray(flat_idx, np.int32))

    def wait(self, job):
        return self.loader.wait(job)


def _make_tile_source(dataset, img_size: int, cache: bool = True,
                      prefer_native: bool = True):
    """The port's native loader where `prefer_native`, the dataset has
    image files and the library builds and loads, else the python dataset
    (through a RamCache when `cache`). The JAX package swallows the reason
    it falls back; here the source carries it (`.name`, `.why`: the
    compiler's or the loader's own words) and the feed prints it."""
    if not prefer_native:
        why = "prefer_native=False"
    elif not hasattr(dataset, "img_files"):
        why = "the dataset has no image files"
    else:
        from . import native_loader
        if native_loader.available():
            return NativeTileSource(dataset, img_size, cache)
        why = f"native loader unavailable: {native_loader.load_error()}"
    return PyTileSource(RamCache(dataset) if cache else dataset, why)


def _pack_labels(labels, flat_idx, m0: int):
    labs = np.empty((len(flat_idx), m0, 5), np.float32)
    msks = np.empty((len(flat_idx), m0), bool)
    for i, j in enumerate(flat_idx):
        labs[i], msks[i] = pad_labels(labels[int(j)], m0)
    return labs, msks


def _step_indices(rng, order, start, batch_size, n, use_mixup):
    """Tile index schedule for one step: (B, 4) primary [+ (B, 4) mixup]."""
    prim = np.empty((batch_size, 4), np.int64)
    for bi in range(batch_size):
        prim[bi, 0] = order[start + bi]
        prim[bi, 1:] = rng.integers(n, size=3)
    if not use_mixup:
        return prim, None
    sec = rng.integers(n, size=(batch_size, 4))
    return prim, sec


def _order(rng, n: int, sample_weights_fn):
    """One epoch's order: a permutation, or class-weighted draws with
    replacement under --image-weights."""
    if sample_weights_fn is not None:
        w = np.asarray(sample_weights_fn(), float)
        return rng.choice(n, size=n, p=w / w.sum())
    return rng.permutation(n)


def step_draws(seed: int, step: int, batch_size: int, s: int,
               hyp: dict) -> np.ndarray:
    """The augmentation draws of one step, from a Generator keyed by
    (seed, step)."""
    return augment_draws(np.random.default_rng((seed, step)), batch_size, s,
                         hyp)


class BankFeed:
    """Device-resident uint8 tile bank + host-side index scheduler, served
    one step at a time (`augment_step`) or an epoch at a time
    (`epoch_schedule`)."""

    def __init__(self, dataset, batch_size: int, img_size: int, hyp: dict,
                 *, seed: int = 0, m0: int = 30, mosaic: bool = True,
                 sample_weights_fn=None, prefer_native: bool = True,
                 device="cuda", start_step: int = 0, process_index: int = 0,
                 process_count: int = 1):
        n = len(dataset)
        if n < batch_size:
            raise ValueError(f"dataset {n} < batch_size {batch_size}")
        # several processes: every one computes the GLOBAL schedule from
        # the shared seed and augments only its row slice of each step
        self.rows = _row_slice(batch_size, process_index, process_count)
        self.n = n
        self.batch_size = batch_size
        self.img_size = img_size
        self.hyp = hyp
        # mosaic=False: the letterbox-only path whatever the hyp says
        self.mosaic_p = float(hyp.get("mosaic", 1.0)) if mosaic else 0.0
        self.use_mixup = hyp.get("mixup", 0.0) > 0 and self.mosaic_p > 0
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.sample_weights_fn = sample_weights_fn
        self.steps_per_epoch = max(n // batch_size, 1)
        self.step = 0
        self.device = torch.device(device)

        self.source = _make_tile_source(dataset, img_size, cache=False,
                                        prefer_native=prefer_native)
        src = self.source
        rgb_all, ir_all = src.wait(src.submit(np.arange(n)))
        labs, msks = _pack_labels(dataset.labels, range(n), m0)
        self.banks = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device) for x in (rgb_all, ir_all, labs, msks))
        while self.step < start_step:
            self.step_schedule(draws=False)

    def step_schedule(self, draws: bool = True):
        """Indices and draws for ONE step: prim (B, 4), sec (B, 4) or None,
        draws (B, N_DRAWS) or None."""
        if self.step % self.steps_per_epoch == 0:
            self._epoch_order = _order(self.rng, self.n,
                                       self.sample_weights_fn)
        start = (self.step % self.steps_per_epoch) * self.batch_size
        prim, sec = _step_indices(self.rng, self._epoch_order, start,
                                  self.batch_size, self.n, self.use_mixup)
        d = (step_draws(self.seed, self.step, self.batch_size, self.img_size,
                        self.hyp) if draws else None)
        self.step += 1
        return prim, sec, d

    def epoch_schedule(self):
        """Indices and draws for a WHOLE epoch: prim (K, B, 4), sec
        (K, B, 4) or None, draws (K, B, N_DRAWS), K = steps_per_epoch.
        The rows are `step_schedule`'s, in order, so the generator is
        consumed as the per-step protocol consumes it."""
        rows = [self.step_schedule() for _ in range(self.steps_per_epoch)]
        prim, sec, draws = zip(*rows)
        return (np.stack(prim), None if sec[0] is None else np.stack(sec),
                np.stack(draws))

    def augment(self, prim, sec, draws):
        """One augmented batch from the bank for a schedule row."""
        up = lambda a: torch.from_numpy(a).to(self.device)
        return self.augment_device(up(prim), None if sec is None else up(sec),
                                   up(draws))

    def augment_device(self, p, q, draws):
        """One augmented batch from schedule rows already on the device
        (q None: no mixup operand, the primary tiles stand in)."""
        rgb, ir, lab, msk = self.banks
        q = p if q is None else q
        img, irr, targets, tmask = augment_batch(
            rgb[p], ir[p], lab[p], msk[p], rgb[q], ir[q], lab[q], msk[q],
            draws, s=self.img_size, hyp=self.hyp,
            use_mixup=self.use_mixup, mosaic_p=self.mosaic_p)
        return {"img": img, "ir": irr, "targets": targets, "tmask": tmask}

    def augment_step(self):
        """One augmented batch: this process's rows of the step."""
        prim, sec, draws = self.step_schedule()
        r = self.rows
        b = self.augment(prim[r], None if sec is None else sec[r], draws[r])
        b["epoch"] = (self.step - 1) // self.steps_per_epoch
        return b


def make_bank_feed(dataset, batch_size: int, img_size: int, hyp: dict,
                   *, seed: int = 0, m0: int = 30, mosaic: bool = True,
                   sample_weights_fn=None, prefer_native: bool = True,
                   device="cuda", start_step: int = 0,
                   device_bank: bool | None = None, process_index: int = 0,
                   process_count: int = 1) -> BankFeed | None:
    """BankFeed when the dataset's rgb + ir uint8 tiles fit
    DEVICE_BANK_MAX_GB, else None; `device_bank` True forces the bank,
    False refuses it, None applies the gate. Every process holds the
    whole bank; `process_index` / `process_count` choose the rows of
    each step that it augments. `mosaic=False` takes the letterbox-only
    path whatever the hyp's mosaic; `prefer_native=False` reads the tiles
    through the python dataset."""
    if device_bank is None:
        bank_bytes = 2 * len(dataset) * img_size * img_size * 3
        device_bank = bank_bytes <= DEVICE_BANK_MAX_GB * 2**30
    if not device_bank:
        return None
    return BankFeed(dataset, batch_size, img_size, hyp, seed=seed, m0=m0,
                    mosaic=mosaic, sample_weights_fn=sample_weights_fn,
                    prefer_native=prefer_native, device=device,
                    start_step=start_step, process_index=process_index,
                    process_count=process_count)


def _row_slice(batch_size: int, process_index: int,
               process_count: int) -> slice:
    if batch_size % process_count:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"process_count {process_count}")
    lb = batch_size // process_count
    return slice(process_index * lb, (process_index + 1) * lb)


def _bucket(scale_rng, img_size: int, buckets) -> int:
    f = buckets[int(scale_rng.integers(len(buckets)))]
    return int(round(img_size * f / 32) * 32)


def _rescale(b: dict, ns: int, img_size: int) -> dict:
    if ns != img_size:
        for k in ("img", "ir"):
            b[k] = resize_bilinear(b[k], ns)
    return b


def make_train_batches(dataset, batch_size: int, img_size: int, hyp: dict,
                       *, seed: int = 0, max_labels_per_image: int = 30,
                       epochs: int | None = None, cache: bool = True,
                       mosaic: bool = True, prefer_native: bool = True,
                       sample_weights_fn=None, multi_scale: bool = False,
                       multi_scale_buckets=(0.75, 1.0, 1.25),
                       scale_seed: int | None = None,
                       device_bank: bool | None = None, device="cuda",
                       start_step: int = 0, process_index: int = 0,
                       process_count: int = 1) -> Iterator[dict]:
    """Iterator of augmented device batches from `start_step` on: endless
    (`epochs` None) or stopping after `epochs` epochs. The device bank
    when the tiles fit DEVICE_BANK_MAX_GB (`device_bank` None; True forces
    the bank, False streaming), else streaming: tiles read on the host by
    the tile source (`_make_tile_source`: the native loader unless
    `prefer_native` is False, else the python dataset, through a RAM
    cache when `cache`), sent as uint8, augmented on the device; within an
    epoch the next step's tiles are submitted before a batch is yielded.
    `mosaic=False` takes the letterbox-only path whatever the hyp's
    mosaic. `multi_scale` resizes each batch to one of
    `multi_scale_buckets` x img_size (rounded to 32 px), drawn from a
    stream of its own seeded with `scale_seed` (default `seed`). The regime
    and the tile source are chosen, and printed on a `feed:` line, when
    this is called. Several processes (`process_count`): `batch_size`
    stays global, every process draws the same global schedule and yields
    its `process_index`-th row slice of each step (JAX's multi-host
    feed)."""
    n = len(dataset)
    if n < batch_size:
        raise ValueError(
            f"dataset has {n} images < batch_size {batch_size}; "
            "the epoch schedule would never yield a batch")
    rows = _row_slice(batch_size, process_index, process_count)
    scale = ((multi_scale_buckets,
              seed if scale_seed is None else scale_seed)
             if multi_scale else None)
    steps_per_epoch = max(n // batch_size, 1)
    total = None if epochs is None else epochs * steps_per_epoch
    feed = make_bank_feed(dataset, batch_size, img_size, hyp, seed=seed,
                          m0=max_labels_per_image, mosaic=mosaic,
                          sample_weights_fn=sample_weights_fn,
                          prefer_native=prefer_native, device=device,
                          start_step=start_step, device_bank=device_bank,
                          process_index=process_index,
                          process_count=process_count)
    if feed is not None:
        src = feed.source
        print(f"feed: device bank ({n} tiles on {feed.device}), tile source: "
              f"{src.name} ({src.why})")
        it = _bank_batches(feed, img_size, scale, start_step)
    else:
        src = _make_tile_source(dataset, img_size, cache, prefer_native)
        print(f"feed: streaming ({n} tiles decoded on the host), tile "
              f"source: {src.name} ({src.why})")
        it = _stream_batches(dataset, src, batch_size, img_size, hyp, seed,
                             max_labels_per_image, sample_weights_fn, scale,
                             torch.device(device), start_step, rows,
                             mosaic)
    if total is None:
        return it
    return itertools.islice(it, max(total - start_step, 0))


def _scale_stream(scale, img_size: int, start_step: int):
    """The multi-scale sizes, step by step from `start_step` (None: no
    multi-scale)."""
    if scale is None:
        return None
    buckets, scale_seed = scale
    rng = np.random.default_rng(scale_seed)
    for _ in range(start_step):
        _bucket(rng, img_size, buckets)
    return lambda: _bucket(rng, img_size, buckets)


def _bank_batches(feed, img_size, scale, start_step):
    size = _scale_stream(scale, img_size, start_step)
    while True:
        b = feed.augment_step()
        if size is not None:
            b = _rescale(b, size(), img_size)
        yield b


def _stream_batches(dataset, src, batch_size, img_size, hyp, seed, m0,
                    sample_weights_fn, scale, dev, start_step, rows, mosaic):
    n = len(dataset)
    labels = dataset.labels
    rng = np.random.default_rng(seed)
    mosaic_p = float(hyp.get("mosaic", 1.0)) if mosaic else 0.0
    use_mixup = hyp.get("mixup", 0.0) > 0 and mosaic_p > 0
    steps_per_epoch = max(n // batch_size, 1)
    size = _scale_stream(scale, img_size, start_step)

    def schedule():
        while True:
            order = _order(rng, n, sample_weights_fn)
            for start in range(0, n - batch_size + 1, batch_size):
                prim, sec = _step_indices(rng, order, start, batch_size, n,
                                          use_mixup)
                prim = prim[rows]       # this process's rows only
                yield (prim.ravel() if sec is None
                       else np.concatenate([prim.ravel(), sec[rows].ravel()]))

    sched = schedule()
    for _ in range(start_step):
        next(sched)
    step = start_step
    lb = len(range(batch_size)[rows])    # this process's rows
    shape4 = (lb, 4, img_size, img_size, 3)
    pending = None                    # the next step's indices and job
    while True:
        if pending is None:
            flat = next(sched)
            pending = (flat, src.submit(flat))
        cur, job = pending
        rgb, ir = src.wait(job)
        pending = None
        if (step + 1) % steps_per_epoch:
            # the next step's decode starts now; not across an epoch's end,
            # whose order --image-weights draws after the epoch's eval
            flat = next(sched)
            pending = (flat, src.submit(flat))
        labs, msks = _pack_labels(labels, cur, m0)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        half = lb * 4
        r1, i1 = t(rgb[:half].reshape(shape4)), t(ir[:half].reshape(shape4))
        l1 = t(labs[:half].reshape(lb, 4, m0, 5))
        k1 = t(msks[:half].reshape(lb, 4, m0))
        if use_mixup:
            r2 = t(rgb[half:].reshape(shape4))
            i2 = t(ir[half:].reshape(shape4))
            l2 = t(labs[half:].reshape(lb, 4, m0, 5))
            k2 = t(msks[half:].reshape(lb, 4, m0))
        else:
            r2, i2, l2, k2 = r1, i1, l1, k1
        img, irr, targets, tmask = augment_batch(
            r1, i1, l1, k1, r2, i2, l2, k2,
            t(step_draws(seed, step, batch_size, img_size, hyp)[rows]),
            s=img_size, hyp=hyp, use_mixup=use_mixup, mosaic_p=mosaic_p)
        b = {"img": img, "ir": irr, "targets": targets, "tmask": tmask,
             "epoch": step // steps_per_epoch}
        if size is not None:
            b = _rescale(b, size(), img_size)
        yield b
        step += 1


# ------------------------------------------------------------------ eval

def _stem(files, i: int) -> str:
    return Path(files[i]).stem if files is not None else str(i)


def make_eval_batches(dataset, batch_size: int, img_size: int,
                      max_labels_per_image: int = 60, rect: bool = False,
                      stride: int = 32, pad: float = 0.5) -> Iterator[dict]:
    """Deterministic eval batches of uint8 numpy arrays (the eval step casts
    and scales on the device): img / ir, padded targets / tmask, the
    dataset `indices`, `valid` (the last batch is padded by repeating its
    final sample), the images' `shapes` and file `stems` (dataset indices
    where it has no files). `rect` batches by aspect ratio, each batch
    letterboxed to its own stride-multiple shape (`net_shape`), as JAX's
    `_rect_eval_batches`."""
    if rect:
        yield from _rect_eval_batches(dataset, batch_size, img_size,
                                      max_labels_per_image, stride, pad)
        return
    n = len(dataset)
    files = getattr(dataset, "img_files", None)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        valid = len(idx)
        while len(idx) < batch_size:
            idx.append(idx[-1])
        rgbs, irs, labs, msks, shapes = [], [], [], [], []
        for i in idx:
            rgb, ir, lab = dataset[i]
            pl, pm = pad_labels(lab, max_labels_per_image)
            rgbs.append(rgb)
            irs.append(ir)
            labs.append(pl)
            msks.append(pm)
            shapes.append(rgb.shape[:2])
        yield {"img": np.stack(rgbs), "ir": np.stack(irs),
               "targets": np.stack(labs), "tmask": np.stack(msks),
               "indices": idx, "valid": valid, "shapes": shapes,
               "stems": [_stem(files, i) for i in idx]}


def _aspect_ratios(dataset) -> np.ndarray:
    """h / w of every image, from the PNG, JPEG, BMP, TIFF or WebP headers
    where the dataset has files (JAX reads them from PIL's headers; a TIFF
    oriented 5-8 reports its sides swapped, as PIL does)."""
    from .vedai import image_size
    files = getattr(dataset, "img_files", None)
    if files is not None:
        shapes = [image_size(f)[::-1] for f in files]
    else:
        shapes = [dataset[i][0].shape[:2] for i in range(len(dataset))]
    shapes = np.asarray(shapes, np.float64)
    return shapes[:, 0] / shapes[:, 1]


def _rect_shape(ari: np.ndarray, img_size: int, stride: int, pad: float):
    shape = [1.0, 1.0]
    if ari.max() < 1:
        shape = [float(ari.max()), 1.0]
    elif ari.min() > 1:
        shape = [1.0, float(1.0 / ari.min())]
    bh, bw = (np.ceil(np.asarray(shape) * img_size / stride
                      + pad).astype(int) * stride).tolist()
    return bh, bw


def _letterboxed(dataset, i: int, hw, scaleup: bool):
    """Item i letterboxed to hw: rgb, ir, its labels in the letterboxed
    frame, and the letterbox's gain and pad."""
    bh, bw = hw
    rgb, ir, lab = dataset[i]
    h1, w1 = rgb.shape[:2]
    (r, _), _, (dw, dh) = letterbox_params((h1, w1), hw, scaleup=scaleup)
    lab = lab.copy()
    if len(lab):
        lab[:, 1] = (lab[:, 1] * w1 * r + dw) / bw
        lab[:, 2] = (lab[:, 2] * h1 * r + dh) / bh
        lab[:, 3] = lab[:, 3] * w1 * r / bw
        lab[:, 4] = lab[:, 4] * h1 * r / bh
    return (letterbox_image_np(rgb, hw, scaleup=scaleup),
            letterbox_image_np(ir, hw, scaleup=scaleup), lab, (h1, w1),
            ((r,), (dw, dh)))


def _rect_eval_batches(dataset, batch_size: int, img_size: int, m0: int,
                       stride: int, pad: float) -> Iterator[dict]:
    """Rectangular eval batching: images sorted by aspect ratio, each batch
    letterboxed (not enlarged) to its own shape."""
    n = len(dataset)
    files = getattr(dataset, "img_files", None)
    ar = _aspect_ratios(dataset)
    order = np.argsort(ar)
    for start in range(0, n, batch_size):
        idx = [int(order[j]) for j in
               range(start, min(start + batch_size, n))]
        valid = len(idx)
        while len(idx) < batch_size:
            idx.append(idx[-1])
        hw = _rect_shape(ar[idx[:valid]], img_size, stride, pad)
        rgbs, irs, labs, msks, shps, rps = [], [], [], [], [], []
        for i in idx:
            rgb, ir, lab, shape, rp = _letterboxed(dataset, i, hw, False)
            pl, pm = pad_labels(lab, m0)
            rgbs.append(rgb)
            irs.append(ir)
            labs.append(pl)
            msks.append(pm)
            shps.append(shape)
            rps.append(rp)
        yield {"img": np.stack(rgbs), "ir": np.stack(irs),
               "targets": np.stack(labs), "tmask": np.stack(msks),
               "indices": idx, "valid": valid, "shapes": shps,
               "ratio_pads": rps, "stems": [_stem(files, i) for i in idx],
               "net_shape": tuple(hw)}


# --------------------------------------------------------- rect training

def rect_draws(seed: int, key: int, batch_size: int, hw: tuple[int, int],
               hyp: dict) -> np.ndarray:
    """The draws of one rect batch, from a Generator keyed by (seed, key):
    (B, WARP + 5) [warp at hw, HSV gains, flips]."""
    rng = np.random.default_rng((seed, key))
    p = PerspectiveParams.from_hyp(hyp)
    warp = warp_draws(perspective_draws(rng, batch_size, p, hw), hw)
    hsv = hsv_draws(rng, batch_size, hyp.get("hsv_h", 0.015),
                    hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4))
    flip = flip_draws(rng, batch_size, hyp.get("flipud", 0.0),
                      hyp.get("fliplr", 0.5))
    return np.concatenate([warp, hsv, flip], 1).astype(np.float32)


def rect_augment_batch(img, ir, lab, msk, draws: torch.Tensor, *, hw,
                       hyp: dict):
    """The rect branch's augmentation of a letterboxed batch (JAX's
    `_rect_augment_one`, vmapped there): perspective, HSV, flips at the
    batch's shape, no mosaic. img / ir (B, bh, bw, 3) uint8; lab (B, M, 5)
    xywhn in the letterboxed frame; draws from `rect_draws`. Returns img,
    ir in [0, 1], targets (B, M, 5), tmask (B, M)."""
    bh, bw = hw
    p = PerspectiveParams.from_hyp(hyp)
    lab_px = xywhn2xyxy(lab[..., 1:5], bw, bh)
    img, ir, labels, mask = random_perspective(
        img.float(), ir.float(), lab_px, msk, draws[:, :WARP], p, (bh, bw))
    img = hsv_apply(img, draws[:, WARP:WARP + 3])
    lab_n = torch.stack([(labels[..., 0] + labels[..., 2]) / 2 / bw,
                         (labels[..., 1] + labels[..., 3]) / 2 / bh,
                         (labels[..., 2] - labels[..., 0]) / bw,
                         (labels[..., 3] - labels[..., 1]) / bh], -1)
    ud, lr = (draws[:, WARP + 3:WARP + 5] > 0).unbind(1)
    img, ir, targets, mask = flips(
        img, ir, torch.cat([lab[..., :1], lab_n], -1), mask, ud, lr)
    return img / 255.0, ir / 255.0, targets, mask


def _rect_groups(dataset, batch_size: int, img_size: int, stride: int = 32,
                pad: float = 0.0):
    """The fixed batches of rect training and their (bh, bw): images sorted
    by aspect ratio, the tail group padded to batch_size by cycling its own
    members (JAX's `make_rect_train_batches`)."""
    n = len(dataset)
    ar = _aspect_ratios(dataset)
    order = np.argsort(ar)
    nb = n // batch_size
    starts = [gi * batch_size for gi in range(nb)]
    if n % batch_size:
        starts.append(n - (n % batch_size))
    groups, shapes = [], []
    for start in starts:
        idx = order[start:start + batch_size]
        if len(idx) < batch_size:
            idx = np.resize(idx, batch_size)
        groups.append(idx)
        shapes.append(_rect_shape(ar[idx], img_size, stride, pad))
    return groups, shapes


def make_rect_train_batches(dataset, batch_size: int, img_size: int,
                            hyp: dict, *, seed: int = 0,
                            max_labels_per_image: int = 30, stride: int = 32,
                            pad: float = 0.0, device="cuda",
                            start_step: int = 0) -> Iterator[dict]:
    """Rect training: the fixed aspect-ratio groups of `_rect_groups`, each
    letterboxed on the host to its own shape and augmented on the device
    by `rect_augment_batch`; items are decoded once, into a RamCache (JAX
    decodes them at every read). Every epoch permutes the groups and shuffles
    each group's members with JAX's `np.random.default_rng(seed)` calls,
    so the port sees JAX's batches in JAX's order; the augmentation draws
    come from `rect_draws` keyed by (seed, epoch * nb + group). Batches
    carry their `net_shape`. `start_step` runs the schedule forward
    without decoding."""
    n = len(dataset)
    if n < batch_size:
        raise ValueError(f"dataset has {n} images < batch {batch_size}")
    groups, shapes = _rect_groups(dataset, batch_size, img_size, stride, pad)
    nb = len(groups)
    dev = torch.device(device)
    print(f"feed: rect ({nb} groups, shapes "
          f"{sorted(set(map(tuple, shapes)))}), tile source: python "
          "(RAM-cached, letterboxed per group on the host)")
    return _rect_batches(RamCache(dataset), groups, shapes, batch_size, hyp,
                         seed, max_labels_per_image, dev, start_step)


def _rect_batches(dataset, groups, shapes, batch_size, hyp, seed, m0, dev,
                  start_step):
    rng = np.random.default_rng(seed)
    nb = len(groups)
    step, epoch = 0, 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    while True:
        for gi in rng.permutation(nb):
            idx = groups[gi].copy()
            rng.shuffle(idx)
            step += 1
            if step <= start_step:
                continue
            hw = shapes[gi]
            items = [_letterboxed(dataset, int(i), hw, True) for i in idx]
            packed = [pad_labels(it[2], m0) for it in items]
            draws = rect_draws(seed, epoch * nb + int(gi), batch_size, hw,
                               hyp)
            img, ir, targets, tmask = rect_augment_batch(
                t(np.stack([it[0] for it in items])),
                t(np.stack([it[1] for it in items])),
                t(np.stack([p[0] for p in packed])),
                t(np.stack([p[1] for p in packed])), t(draws), hw=hw,
                hyp=hyp)
            yield {"img": img, "ir": ir, "targets": targets, "tmask": tmask,
                   "epoch": epoch, "net_shape": hw}
        epoch += 1
