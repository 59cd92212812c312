"""One rank of the data-parallel runs of tests/test_torch_port_parallel.py:

    RANK=r WORLD_SIZE=w LOCAL_RANK=r python tests/torch_port_ddp_worker.py DIR

joins the gloo process group of the file store DIR/store, reads
DIR/inputs.pt (the weights, the batches and the settings the test wrote),
runs every case of the port's training on its rows of the global batches
and writes DIR/out{rank}.pt. The cases:

  step    two steps of `make_train_step` (tests/tiny.yaml, 64 px, global
          batch 4, the positives spread unevenly over the ranks);
  skew    one step with every target in rank 0's rows;
  acc2    four steps at accumulate 2 (two optimizer steps);
  remat   one step of the model built with remat;
  epoch   one epoch of `make_epoch_scan` over a `BankFeed` of 16 synthetic
          tiles (four steps);
  sam     three SAM updates of an elementwise loss over the rank's rows;
  trainer the trainer CLI for one epoch (rank 0 evaluates and writes).
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sodt_tpu_torch.data.loader import make_bank_feed  # noqa: E402
from sodt_tpu_torch.data.synthetic import SyntheticVedai  # noqa: E402
from sodt_tpu_torch.models import build_model  # noqa: E402
from sodt_tpu_torch.parallel.mesh import init_from_env, shard_batch  # noqa
from sodt_tpu_torch.train import cli  # noqa: E402
from sodt_tpu_torch.train.loss import LossConfig  # noqa: E402
from sodt_tpu_torch.train.optim import make_optimizer  # noqa: E402
from sodt_tpu_torch.train.sam import make_sam_optimizer  # noqa: E402
from sodt_tpu_torch.train.state import (TrainState, make_epoch_scan,  # noqa
                                        make_train_step)

TINY = str(ROOT / "tests/tiny.yaml")


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _state(model, tx):
    return TrainState.create(model, tx)


def _model(inp, remat=False):
    m = build_model(TINY, ch_in=3, input_mode="RGB", remat=remat)
    m.load_state_dict(inp["weights"])
    return m


def _snapshot(state) -> dict:
    return {"sd": {k: v.detach().clone()
                   for k, v in state.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.items()}}


def run_steps(inp, batches, *, accumulate=1, remat=False, shard=True):
    """`len(batches)` steps from the test's weights; the metrics of each
    step and the state after the last."""
    model = _model(inp, remat)
    tx = make_optimizer(inp["hyp"], dict(model.named_parameters()),
                        epochs=inp["epochs"], nb=inp["nb"],
                        accumulate=accumulate)
    step = make_train_step(model, tx, LossConfig(**inp["loss"]))
    state = _state(model, tx)
    metrics = []
    for b in batches:
        b = _batch(b)
        state, m = step(state, shard_batch(b) if shard else b)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(_snapshot(state), metrics=metrics)


def run_epoch(inp):
    """One epoch of the epoch path over the shared bank."""
    model = _model(inp)
    ds = SyntheticVedai(n=16, img_size=64, nc=inp["loss"]["nc"], seed=0)
    feed = make_bank_feed(ds, 4, 64, inp["epoch_hyp"], seed=9, device="cpu",
                          device_bank=True)
    tx = make_optimizer(inp["epoch_hyp"], dict(model.named_parameters()),
                        epochs=2, nb=feed.steps_per_epoch)
    step = make_train_step(model, tx, LossConfig(**inp["loss"]))
    state, keys, ms = make_epoch_scan(step, feed)(
        _state(model, tx), *feed.epoch_schedule())
    return dict(_snapshot(state), keys=keys, metrics=ms.numpy())


def sam_loss(p: dict, x: torch.Tensor, coef) -> torch.Tensor:
    """Sum over the rows x (n, 3) of an elementwise loss of the params."""
    cw, cb, cs = (torch.from_numpy(c) for c in coef)
    return sum((cw * torch.sin(p["fc.weight"] * xi[0])).sum()
               + (cb * (p["fc.bias"] * xi[1]) ** 2).sum()
               + (cs * torch.exp(-p["bn.weight"] * xi[2])).sum() for xi in x)


def run_sam(inp):
    s = inp["sam"]
    x = shard_batch({"x": torch.from_numpy(s["x"])})["x"]
    params = {k: torch.from_numpy(v.copy()) for k, v in s["params"].items()}

    def grad_fn(p, i=0):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        gs = torch.autograd.grad(sam_loss(leaves, x, s["coef"]),
                                 list(leaves.values()))
        return dict(zip(leaves, gs))

    opt = make_sam_optimizer(s["hyp"], params, epochs=3, nb=4, rho=0.05)
    for _ in range(3):
        ups = opt.update(grad_fn(params), params, grad_fn=grad_fn)
        params = {k: params[k] + ups[k] for k in params}
    return params


def run_trainer(inp, out_dir: Path):
    # no TensorBoard writer: on the CPU its import pulls TensorFlow (~10 s)
    sys.modules["torch.utils.tensorboard"] = None
    m = cli.main(["--cfg", TINY, "--hyp", inp["trainer_hyp"], "--synthetic",
                  "--synthetic-n", "8", "--img-size", "64", "--batch-size",
                  "4", "--nbs", "4", "--epochs", "1", "--input_mode", "RGB",
                  "--noautoanchor", "--no-bf16", "--platform", "cpu",
                  "--save-dir", str(out_dir / "run")])
    return {"losses": m["losses"], "map50": m["map50"], "steps": m["steps"]}


def main(out_dir: Path):
    torch.set_num_threads(1)
    mesh = init_from_env("cpu", init_method=f"file://{out_dir / 'store'}")
    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    out = {"world": mesh.world,
           "step": run_steps(inp, inp["batches"][:2]),
           "skew": run_steps(inp, [inp["skew"]]),
           "acc2": run_steps(inp, inp["batches"], accumulate=2),
           "remat": run_steps(inp, inp["batches"][:1], remat=True),
           "epoch": run_epoch(inp), "sam": run_sam(inp)}
    out["trainer"] = run_trainer(inp, out_dir)
    torch.save(out, out_dir / f"out{mesh.rank}.pt")


if __name__ == "__main__":
    main(Path(sys.argv[1]))
