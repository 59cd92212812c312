"""Checkpoint save / resume on `torch.save` (`sodt_tpu/train/checkpoint.py`,
there on orbax).

A checkpoint is one file holding a dict:

  {step, model (parameters + BatchNorm statistics: the state_dict),
   ema (EMA of both), ema_updates, opt_state (`Optimizer.state_dict`),
   epoch, best_fitness}

with every tensor on the CPU. The trainer takes it in two halves
(`snapshot_tree` on its own thread: clones on the device; then
`fetch_snapshot` and the writes on a worker thread, overlapping the next
epoch). It writes `last.pt`, copies it to
`best.pt` (a file copy, as `clone_checkpoint` copies the orbax directory)
and writes `epoch{N}.pt` under --save-period. `strip_checkpoint` keeps the
EMA weights as the final model. `load_weights` reads either a checkpoint
(its EMA weights, else its model) or a state_dict .npz
(`weights.save_npz`); `load_into` loads one into a model, leaving the SR
branch's entries aside where the model has none.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Any

import torch

from ..weights import load_npz


def snapshot_tree(state, *, epoch: int, best_fitness: float,
                  extra: dict | None = None) -> tuple[dict, Any]:
    """The checkpoint of a `TrainState` as clones on the state's device,
    taken in stream order on the calling thread: the training that
    follows updates the parameters, the EMA and the optimizer state in
    place, and never these copies. Returns (the tree, an event recorded
    after the clones on the card; None on the CPU, where the clones are
    done on return). `fetch_snapshot` brings it to the host; `extra` (the
    W&B run id) is kept under "extra" where given."""
    with torch.no_grad():
        clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
        tree = {"step": int(state.step),
                "model": clone(state.model.state_dict()),
                "ema": clone(state.ema), "ema_updates": int(state.ema_updates),
                "opt_state": state.tx.snapshot(), "epoch": int(epoch),
                "best_fitness": float(best_fitness)}
    if extra:
        tree["extra"] = extra
    dev = next(iter(tree["ema"].values())).device
    ready = None
    if dev.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
    return tree, ready


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def fetch_snapshot(snap: tuple[dict, Any]) -> dict:
    """A `snapshot_tree` on the host, from any thread: on the card the
    copies run on a stream of their own after the snapshot's event, so
    that they wait for the clones and not for the work queued after
    them."""
    tree, ready = snap
    if ready is None:
        return tree
    dev = next(iter(tree["ema"].values())).device
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            return _to_host(tree)


def checkpoint_tree(state, *, epoch: int, best_fitness: float,
                    extra: dict | None = None) -> dict:
    """The host-side checkpoint of a `TrainState` (one copy to the CPU, so
    that a caller saving to several paths pays it once); `extra` (the
    W&B run id) is kept under "extra" where given."""
    return fetch_snapshot(snapshot_tree(state, epoch=epoch,
                                        best_fitness=best_fitness,
                                        extra=extra))


def write_checkpoint(path: str | Path, ckpt: dict) -> None:
    """torch.save through a temporary file, renamed when complete."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(ckpt, tmp)
    tmp.replace(path)


def clone_checkpoint(src: str | Path, dst: str | Path) -> None:
    """Copy a finished checkpoint file (last -> best)."""
    dst = Path(dst)
    tmp = dst.with_name(dst.name + ".tmp_clone")
    shutil.copyfile(src, tmp)
    tmp.replace(dst)


def save_checkpoint(path: str | Path, state, *, epoch: int,
                    best_fitness: float) -> None:
    write_checkpoint(path, checkpoint_tree(state, epoch=epoch,
                                           best_fitness=best_fitness))


def load_checkpoint(path: str | Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


@torch.no_grad()
def restore_train_state(state, ckpt: dict) -> None:
    """What --resume restores, IN PLACE on a freshly built `TrainState` of
    the same configuration: parameters and BatchNorm statistics, optimizer
    state, EMA, step and EMA counter. The caller takes epoch and
    best_fitness from the checkpoint."""
    state.model.load_state_dict(ckpt["model"])
    dev = next(state.model.parameters()).device
    state.tx.load_state_dict(ckpt["opt_state"], dev)
    if set(state.ema) != set(ckpt["ema"]):
        raise ValueError("checkpoint EMA names differ from the model's")
    for k, e in state.ema.items():
        e.copy_(ckpt["ema"][k])
    state.step = int(ckpt["step"])
    state.ema_updates = int(ckpt["ema_updates"])


def strip_checkpoint(path: str | Path, out_path: str | Path) -> None:
    """Keep the EMA weights as the final model."""
    ckpt = load_checkpoint(path)
    write_checkpoint(out_path, {"model": eval_variables(ckpt),
                                "epoch": ckpt["epoch"]})


def eval_variables(ckpt: dict) -> dict:
    """The state_dict to evaluate: the EMA weights if present, else the
    model's."""
    if "ema" in ckpt:
        return ckpt["ema"]
    return ckpt["model"]


def load_weights(path: str | Path) -> dict:
    """A state_dict from a .npz (`weights.save_npz`) or a checkpoint
    (`eval_variables`)."""
    if Path(path).suffix == ".npz":
        return load_npz(path)
    return eval_variables(load_checkpoint(path))


def load_into(model, path: str | Path):
    """`load_weights(path)` into `model`, strictly, except that a model
    built without the SR branch leaves a checkpoint's `model_up.*` entries
    aside (a run trained with --super evaluates without it: JAX's apply
    ignores the unused leaves). Returns the model."""
    sd = load_weights(path)
    if not hasattr(model, "model_up"):
        sd = {k: v for k, v in sd.items() if not k.startswith("model_up.")}
    model.load_state_dict(sd)
    return model


def _jax_leaf(name: str) -> str:
    """The JAX leaf that a state_dict entry comes from: the two halves of a
    two-tap neck1 (`weights.from_jax_variables`) are one leaf, so that
    counts agree with the JAX package's."""
    m = re.fullmatch(r"(.*neck1)\.[ab]\.weight", name)
    return m.group(1) + ".weight" if m else name


def load_pretrained_variables(state_dict: dict, path: str | Path,
                              exclude: tuple = ("anchor",)):
    """Initial weights for training: copy the source's entries into
    `state_dict` (a freshly initialized model's) wherever the name avoids
    the `exclude` substrings and the shape matches; everything else keeps
    its fresh value. The optimizer starts fresh; --resume restores the
    full state. The source is a checkpoint (its EMA weights) or a .npz.

    Returns (merged state_dict, n_loaded, n_total), counted in the JAX
    package's leaves (a leaf loads when all its entries do)."""
    src = load_weights(path)
    merged, loaded = {}, {}
    for k, v in state_dict.items():
        sv = src.get(k)
        hit = (sv is not None and not any(e in k for e in exclude)
               and tuple(sv.shape) == tuple(v.shape))
        merged[k] = sv.to(v.dtype) if hit else v
        leaf = _jax_leaf(k)
        loaded[leaf] = loaded.get(leaf, True) and hit
    return merged, sum(loaded.values()), len(loaded)
