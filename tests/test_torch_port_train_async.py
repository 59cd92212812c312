"""The port's trainer with its run-long `EvalRunner`, its asynchronous
checkpoints and `TrainConfig(max_labels=, log_every=)`, on the CPU
(`tests/tiny.yaml`, RGB, 64 px, f32):

  * the asynchronous save writes what the synchronous one wrote: epoch0.pt
    of a two-epoch run (save_period 1) equals, bit for bit, last.pt of a
    one-epoch run, while the writer is slowed so that the second epoch's
    steps run with the write pending;
  * a failing writer makes `train` raise;
  * the trainer's final metrics equal a runnerless `evaluate` of the EMA
    weights it saved;
  * `log_every=5` logs the epoch losses of JAX's per-step path within
    1e-4 relative.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from sodt_tpu_torch.train import checkpoint as tck
from sodt_tpu_torch.train import trainer as ttrainer

from torch_port_common import drawn_variables
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
TINY = str(ROOT / "tests/tiny.yaml")
NO_AUG = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, translate=0.0, scale=0.0,
              fliplr=0.0, mosaic=0.0, mixup=0.0)
LOSS_REL = 1e-4
SLOW_WRITE_S = 0.5


def _hyp(tmp_path, **over) -> str:
    """The hyp file with a warmup of 2 iterations and `over`, written
    under a name of its own."""
    with open(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml") as f:
        h = yaml.safe_load(f)
    path = tmp_path / ("hyp" + "".join(f"_{k}{v}" for k, v in
                                       sorted(over.items())) + ".yaml")
    path.write_text(yaml.safe_dump(dict(h, warmup_iters=2, **over)))
    return str(path)


def _config(tmp_path, tag: str, **over) -> ttrainer.TrainConfig:
    kw = dict(cfg=TINY, synthetic=True, synthetic_n=8, img_size=64,
              batch_size=2, nbs=4, epochs=2, bf16=False, autoanchor=False,
              input_mode="RGB", device="cpu", save_dir=str(tmp_path / tag))
    kw.update(over)
    kw.setdefault("hyp", _hyp(tmp_path))
    return ttrainer.TrainConfig(**kw)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _same_checkpoint(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if k in ("model", "ema"):
            assert set(a[k]) == set(b[k])
            for n in a[k]:
                assert torch.equal(a[k][n], b[k][n]), (k, n)
        elif k == "opt_state":
            for f in ("count", "ni"):
                assert a[k][f] == b[k][f]
            for f in ("acc", "trace", "nu"):
                x, y = a[k][f], b[k][f]
                assert (x is None) == (y is None)
                for n in (x or {}):
                    assert torch.equal(x[n], y[n]), (f, n)
        else:
            assert a[k] == b[k], k


def test_async_epoch0_equals_the_synchronous_last(tmp_path, monkeypatch,
                                                  deterministic):
    """The asynchronous save against a run that ends where it saved: the
    snapshot is taken before the second epoch updates the live tensors in
    place, so epoch0.pt holds epoch 0's state even though it is written
    while epoch 1 trains (the writer sleeps first; a step is seen with
    the write pending). The hyp's lrf is 1: the one-cycle schedule is
    then flat and does not depend on the run's number of epochs."""
    pending = threading.Event()
    real = tck.write_checkpoint
    seen = []

    def slow(path, ckpt):
        pending.set()
        time.sleep(SLOW_WRITE_S)
        real(path, ckpt)
        pending.clear()
    monkeypatch.setattr(ttrainer, "write_checkpoint", slow)
    flat = _hyp(tmp_path, lrf=1.0)
    ttrainer.train(_config(tmp_path, "two", hyp=flat, save_period=1,
                           scan_epoch=False),
                   on_step=lambda s, m: seen.append((s.step,
                                                     pending.is_set())))
    assert any(p for step, p in seen if step > 4), seen
    monkeypatch.setattr(ttrainer, "write_checkpoint", real)
    ttrainer.train(_config(tmp_path, "one", hyp=flat, epochs=1,
                           scan_epoch=False))
    a = tck.load_checkpoint(tmp_path / "two/epoch0.pt")
    b = tck.load_checkpoint(tmp_path / "one/last.pt")
    assert a["epoch"] == b["epoch"] == 0 and a["step"] == 4
    _same_checkpoint(a, b)
    ev = [json.loads(x) for x in open(tmp_path / "two/events.jsonl")]
    for e in (0, 1):
        (w,) = [r for r in ev if r.get("step") == e
                and "wall/ckpt_write" in r]
        assert w["wall/ckpt_write"] >= SLOW_WRITE_S


def test_a_failing_writer_makes_train_raise(tmp_path, monkeypatch):
    def broken(path, ckpt):
        raise OSError("disk full")
    monkeypatch.setattr(ttrainer, "write_checkpoint", broken)
    with pytest.raises(OSError, match="disk full"):
        ttrainer.train(_config(tmp_path, "bad"))


def test_final_metrics_equal_a_runnerless_eval_of_the_ema(tmp_path):
    """The run-long runner's last eval (the EMA weights loaded into its
    module in place, the val set on the device since the first eval)
    equals `evaluate` without a runner of the EMA weights in last.pt."""
    from sodt_tpu_torch.data import SyntheticVedai, make_eval_batches
    from sodt_tpu_torch.models import build_model
    from sodt_tpu_torch.train.evaluate import evaluate
    tc = _config(tmp_path, "run", hyp=_hyp(tmp_path, obj=4.0))
    got = ttrainer.train(tc)
    m = build_model(TINY, ch_in=3, nc=8, input_mode="RGB")
    tck.load_into(m, tmp_path / "run/last.pt")
    val = SyntheticVedai(n=4, img_size=64, nc=8, seed=1)
    want = evaluate(m.eval(), make_eval_batches(val, 2, 64), nc=8,
                    img_size=64, device="cpu")
    for k in set(want) - {"speed_ms"}:
        assert got[k] == want[k], (k, got[k], want[k])


def test_log_every_losses_match_jax(tmp_path, monkeypatch):
    """`TrainConfig(log_every=5)` on the per-step path of both trainers
    (12 steps: the losses of steps 0, 5 and 10 averaged), from the same
    drawn weights, augmentation off so that both feeds give the same
    batches, the eval a stand-in: the epoch losses within 1e-4
    relative."""
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.parallel import make_mesh
    from sodt_tpu.train import trainer as jtrainer
    from sodt_tpu_torch.weights import from_jax_variables, save_npz

    stub = {"mp": 0.5, "mr": 0.25, "map50": 0.125, "map": 0.0625,
            "per_class": {}}
    hyp = _hyp(tmp_path, **NO_AUG)
    jm = jbuild(TINY, ch_in=3, nc=8, input_mode="RGB")
    x0 = np.zeros((2, 64, 64, 3), np.float32)
    v = drawn_variables(jm, x0, x0, seed=3, train=True)
    save_npz(from_jax_variables(v), tmp_path / "w.npz")

    class Drawn:
        def __init__(self, m):
            self._m = m

        def __getattr__(self, k):
            return getattr(self._m, k)

        def init(self, *a, **k):
            return jax.tree.map(jax.numpy.asarray, v)

    real_build = jtrainer.build_model
    monkeypatch.setattr(jtrainer, "build_model",
                        lambda *a, **k: Drawn(real_build(*a, **k)))
    monkeypatch.setattr(jtrainer, "make_mesh", lambda: make_mesh(1))
    monkeypatch.setattr(jtrainer, "evaluate", lambda *a, **k: dict(stub))
    monkeypatch.setattr(ttrainer, "evaluate", lambda *a, **k: dict(stub))
    common = dict(cfg=TINY, hyp=hyp, synthetic=True, synthetic_n=24,
                  img_size=64, batch_size=2, nbs=2, epochs=1, bf16=False,
                  autoanchor=False, input_mode="RGB", scan_epoch=False,
                  log_every=5)
    jtrainer.train(jtrainer.TrainConfig(save_dir=str(tmp_path / "jax"),
                                        **common))
    m = ttrainer.train(ttrainer.TrainConfig(
        save_dir=str(tmp_path / "port"), weights_npz=str(tmp_path / "w.npz"),
        device="cpu", **common))
    (jl,) = [e for e in map(json.loads, open(tmp_path / "jax/events.jsonl"))
             if "train/box_loss" in e]
    assert m["steps"] == 12
    for k in ("box", "obj", "cls"):
        want = jl[f"train/{k}_loss"]
        assert abs(m["losses"][0][k] - want) <= LOSS_REL * abs(want), (
            k, m["losses"][0][k], want)
