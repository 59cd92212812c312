"""Data parallelism over processes (`sodt_tpu/parallel/mesh.py`): one
process per card over `torch.distributed`, where JAX runs one SPMD program
over a device mesh.

Under JAX's mesh a sharded batch is ONE logical batch: XLA inserts the
reductions that make BatchNorm's moments, the loss's positive counts and
the gradients span the global batch. Here each process holds B / W rows of
the global batch of B (W the world size) and the port makes those same
reductions itself:

  * `models.layers.BatchNorm` all-reduces (with autograd) its per-channel
    sums of x and x^2 and the element count in training mode;
  * `train.loss.compute_loss` divides by the global count of positives,
    max(sum over ranks, 1), scales by the global batch and takes a 1 / W
    share of the objectness mean, so that the ranks' losses SUM to the
    global loss;
  * `train.state.make_train_step` sums the gradients over the ranks (one
    flat buffer per dtype, once per micro-step, before the optimizer) and
    the logged metrics, so that every rank holds the global values and
    takes the same update.

At world size 1 (no process group) every one of these is skipped and the
code is the single-process code. Start a run with

    torchrun --standalone --nproc_per_node N -m sodt_tpu_torch.train ...

`init_from_env` reads RANK / WORLD_SIZE / LOCAL_RANK as torchrun sets them;
the backend is nccl on the card and gloo with --device cpu, and a backend
that cannot start raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclass(frozen=True)
class Mesh:
    """This process's place: rank, world size, local rank (its card)."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    backend: str | None = None       # None: no process group

    def device(self, dev: torch.device) -> torch.device:
        """The card of this rank where `dev` names no index."""
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", self.local_rank)
        return dev


def init_from_env(device, backend: str | None = None,
                  init_method: str = "env://") -> Mesh:
    """The mesh of this process. With none of RANK / WORLD_SIZE /
    LOCAL_RANK set: world size 1 and no process group. Else the default
    process group is started (or the running one taken): `backend` nccl
    for a CUDA device, gloo for the CPU, unless given."""
    if not any(k in os.environ for k in ENV):
        return Mesh()
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else local)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    if (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise RuntimeError(
            f"process group rank {dist.get_rank()} / {dist.get_world_size()}"
            f" != RANK {rank} / WORLD_SIZE {world}")
    return Mesh(rank, world, local, dist.get_backend())


def world_size() -> int:
    """The default process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def shard_rows(n: int) -> slice:
    """This rank's rows [r * n / W, (r + 1) * n / W) of a global batch of
    n; raises where W does not divide n."""
    w = world_size()
    if n % w:
        raise ValueError(f"batch_size {n} not divisible by process_count "
                         f"{w}")
    lb = n // w
    return slice(rank() * lb, (rank() + 1) * lb)


def shard_batch(batch: dict) -> dict:
    """This rank's rows of every tensor or array of a global batch dict
    (other values pass through)."""
    if world_size() == 1:
        return batch
    rows = None
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape):
            rows = rows or shard_rows(v.shape[0])
            out[k] = v[rows]
        else:
            out[k] = v
    return out


def replicate_tree(tree):
    """Broadcast from rank 0, in place: a module's parameters and buffers,
    or a dict of tensors. Returns `tree`."""
    if world_size() == 1:
        return tree
    tensors = (list(tree.state_dict(keep_vars=True).values())
               if isinstance(tree, torch.nn.Module) else list(tree.values()))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter)
                           else t, src=0)
    return tree


def replicate_from_local(tree):
    """What every rank built alike from the shared seed (the tile bank, an
    epoch's schedule) is already the replica: returned as it is."""
    return tree


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, differentiable: its backward sums the incoming
    gradients over the ranks (the cross-shard terms of a global
    reduction). The identity at world size 1."""
    if world_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


@torch.no_grad()
def all_reduce_tensors(ts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sum every tensor over the ranks: one flat buffer and one
    all-reduce per (dtype, device); new tensors, in order."""
    if world_size() == 1:
        return list(ts)
    groups: dict = {}
    for i, x in enumerate(ts):
        groups.setdefault((x.dtype, x.device), []).append(i)
    out: list = [None] * len(ts)
    for idx in groups.values():
        flat = torch.cat([ts[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([ts[i].numel() for i in idx])):
            out[i] = part.view_as(ts[i])
    return out


def all_reduce_dict(d: dict) -> dict:
    """`all_reduce_tensors` over a name -> tensor dict."""
    return dict(zip(d, all_reduce_tensors(list(d.values()))))


def broadcast_object(obj):
    """A picklable value of rank 0, on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
