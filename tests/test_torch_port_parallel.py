"""Data parallelism of the port (`sodt_tpu_torch.parallel.mesh`) against
JAX's mesh (tests/test_parallel.py): two gloo processes on the CPU, each
holding half of a global batch, give the values of JAX's step sharded over
two of the conftest's CPU devices and of the port's one-process step.

The two ranks (tests/torch_port_ddp_worker.py) run once for the module, on
a file:// store in a temporary directory (no TCP port: xdist workers
cannot collide), each with its own timeout. The model is tests/tiny.yaml
(a CNN with BatchNorm everywhere) at 64 px, global batch 4, its weights
drawn with numpy and carried across with `from_jax_variables`.

Tolerances (f32): the loss and its parts rtol 1e-5; parameters, BN
running statistics and the EMA atol 1e-5; SAM's parameters atol 1e-6.
The step's batch spreads its positives unevenly over the ranks (4 and 2)
and the `skew` case puts all of them in rank 0's rows, where a count of
positives clamped on each rank before the sum (or a mean of the ranks'
losses) gives another loss. World size 1 is bit-equal to no process
group.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_port_ddp_worker as worker
from torch_port_common import drawn_variables
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
TINY = str(ROOT / "tests/tiny.yaml")
HYP = {"lr0": 0.01, "lrf": 0.2, "momentum": 0.937, "warmup_iters": 1,
       "warmup_momentum": 0.8, "warmup_bias_lr": 0.1, "weight_decay": 5e-4}
NO_AUG = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0, degrees=0.0, translate=0.0,
              scale=0.0, shear=0.0, perspective=0.0, flipud=0.0, fliplr=0.0,
              mosaic=0.0, mixup=0.0)
EPOCH_HYP = dict(HYP, warmup_iters=0, weight_decay=0.0, **NO_AUG)
SAM_HYP = dict(lr0=0.01, lrf=0.2, momentum=0.937, warmup_momentum=0.8,
               warmup_bias_lr=0.1, warmup_iters=1)
TIMEOUT = 300       # seconds for each rank


def _batch(seed: int, counts=(3, 1, 2, 0)) -> dict:
    """Global batch 4 at 64 px; row i holds counts[i] targets."""
    rng = np.random.default_rng(seed)
    tg = np.zeros((4, 6, 5), np.float32)
    mask = np.zeros((4, 6), bool)
    for i, n in enumerate(counts):
        tg[i, :n, 0] = rng.integers(0, 3, n)
        tg[i, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        tg[i, :n, 3:5] = rng.uniform(0.1, 0.3, (n, 2))
        mask[i, :n] = True
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    return {"img": x, "ir": x, "targets": tg, "tmask": mask}


def _sam_inputs():
    rng = np.random.default_rng(5)
    params = {"fc.weight": rng.normal(size=(5, 3)).astype(np.float32),
              "fc.bias": rng.normal(size=5).astype(np.float32),
              "bn.weight": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    coef = [rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            for v in params.values()]
    x = rng.uniform(0.5, 1.5, (4, 3)).astype(np.float32)
    return {"params": params, "coef": coef, "x": x, "hyp": SAM_HYP}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model, its drawn variables, and the inputs of every case."""
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu_torch.weights import from_jax_variables
    jm = jbuild(TINY, ch_in=3, input_mode="RGB")
    x0 = np.zeros((4, 64, 64, 3), np.float32)
    v = drawn_variables(jm, x0, x0, seed=2, train=True)
    loss = dict(nc=jm.spec.nc, anchors=jm.spec.anchors,
                strides=jm.spec.detect_strides)
    hyp_file = tmp_path_factory.mktemp("hyp") / "hyp.yaml"
    import yaml
    with open(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml") as f:
        h = yaml.safe_load(f)
    hyp_file.write_text(yaml.safe_dump(dict(h, warmup_iters=1)))
    inp = {"weights": from_jax_variables(v), "hyp": HYP, "epochs": 3,
           "nb": 4, "loss": loss, "epoch_hyp": EPOCH_HYP,
           "batches": [_batch(0), _batch(1), _batch(2), _batch(3)],
           "skew": _batch(4, counts=(2, 3, 0, 0)), "sam": _sam_inputs(),
           "trainer_hyp": str(hyp_file)}
    return jm, v, inp


def _launch(out_dir: Path, inp: dict, world: int) -> list[dict]:
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(inp, out_dir / "inputs.pt")
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, worker.__file__, str(out_dir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(out_dir / f"out{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """The two ranks' results of every case (rank 0's with the run's
    directory under "dir")."""
    out_dir = tmp_path_factory.mktemp("ddp")
    outs = _launch(out_dir, setup[2], 2)
    outs[0]["dir"] = out_dir
    return outs


# ---------------------------------------------------------------- JAX side

_STEPS: dict = {}


def _jax_step(jm, v, accumulate: int, remat: bool):
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train.loss import LossConfig
    from sodt_tpu.train.optim import make_optimizer
    from sodt_tpu.train.state import make_train_step
    key = (accumulate, remat)
    if key not in _STEPS:
        m = jbuild(TINY, ch_in=3, input_mode="RGB", remat=remat) if remat \
            else jm
        cfg = LossConfig(nc=m.spec.nc, anchors=m.spec.anchors,
                         strides=m.spec.detect_strides)
        tx = make_optimizer(HYP, v["params"], epochs=3, nb=4,
                            accumulate=accumulate)
        _STEPS[key] = (tx, jax.jit(make_train_step(m, tx, cfg,
                                                   accumulate=accumulate)))
    return _STEPS[key]


def _jax_run(jm, v, batches, *, accumulate=1, remat=False, n_dev=2):
    """JAX's step over `n_dev` CPU devices (the batch sharded, the state
    replicated): the metrics of each step and the state after, on the
    port's names."""
    import jax
    import jax.numpy as jnp
    from sodt_tpu.parallel import make_mesh, replicate_tree, shard_batch
    from sodt_tpu.train.state import TrainState
    from sodt_tpu_torch.weights import from_jax_tree
    tx, step = _jax_step(jm, v, accumulate, remat)
    mesh = make_mesh(n_dev)
    st = replicate_tree(TrainState.create(
        jax.tree.map(jnp.asarray, v["params"]),
        jax.tree.map(jnp.asarray, v["batch_stats"]), tx), mesh)
    metrics = []
    for b in batches:
        st, m = step(st, shard_batch(jax.tree.map(jnp.asarray, b), mesh))
        metrics.append({k: float(x) for k, x in m.items()})
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return {"sd": from_jax_tree(np_(st.params), np_(st.batch_stats)),
            "ema": from_jax_tree(np_(st.ema_params), np_(st.ema_batch_stats)),
            "metrics": metrics}


# ------------------------------------------------------------- comparisons

def _same_metrics(got, want, rtol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "box", "obj", "cls"):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                       err_msg=k)


def _same_state(got: dict, want: dict, atol=1e-5, keys=("sd", "ema")):
    for part in keys:
        for k, w in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), w.numpy(),
                                       atol=atol, rtol=0, err_msg=(part, k))


def _ranks_agree(r0, r1, case):
    """Both ranks hold the same state and log the same (global) metrics."""
    a, b = r0[case], r1[case]
    assert a["metrics"] == b["metrics"]
    for part in ("sd", "ema"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (case, part, k)


@pytest.mark.parametrize("case", ["step", "skew", "acc2", "remat"])
def test_two_processes_equal_jax_two_devices_and_one_process(setup, ranks,
                                                             case):
    jm, v, inp = setup
    batches = {"step": inp["batches"][:2], "skew": [inp["skew"]],
               "acc2": inp["batches"], "remat": inp["batches"][:1]}[case]
    kw = {"acc2": dict(accumulate=2), "remat": dict(remat=True)}.get(case, {})
    assert ranks[0]["world"] == 2
    _ranks_agree(*ranks, case)
    got = ranks[0][case]
    want = _jax_run(jm, v, batches, **kw)
    _same_metrics(got["metrics"], want["metrics"])
    _same_state(got, want)
    one = worker.run_steps(inp, batches, shard=False, **kw)
    _same_metrics(got["metrics"], one["metrics"])
    _same_state(got, one)


def test_skewed_targets_need_the_global_count(setup, ranks):
    """All positives in rank 0's rows (rank 1 counts none): the loss is
    JAX's only with the count summed over the ranks before its clamp; a
    clamp on each rank would divide by one more."""
    from sodt_tpu_torch.train.loss import build_targets_level
    jm, v, inp = setup
    got = ranks[0]["skew"]["metrics"][0]
    want = _jax_run(jm, v, [inp["skew"]])["metrics"][0]
    np.testing.assert_allclose(got["box"], want["box"], rtol=1e-5)
    loss = inp["loss"]
    ny = nx = 64 // loss["strides"][0]
    grid = torch.tensor(loss["anchors"][0]).reshape(-1, 2) / loss["strides"][0]
    tg = torch.from_numpy(inp["skew"]["targets"])
    tm = torch.from_numpy(inp["skew"]["tmask"])
    npos = [int(build_targets_level(tg[r], tm[r], grid, ny, nx, 4.0)[
        "pos"].sum()) for r in (slice(0, 2), slice(2, 4))]
    assert npos[0] > 0 and npos[1] == 0
    clamped_each = want["box"] * npos[0] / (npos[0] + 1)
    assert abs(clamped_each - got["box"]) > 1e-3 * got["box"]


def test_epoch_path_two_processes(setup, ranks):
    """One epoch of the epoch path (a bank of 16 synthetic tiles, four
    steps of global batch 4, augmentation off so that both packages'
    feeds give the same batches, bit for bit): each rank augments its
    rows; the losses and the state equal JAX's epoch scan over two devices
    and the port's one-process epoch (every part of the loss rtol 1e-5)."""
    import jax
    import jax.numpy as jnp
    from sodt_tpu.data.loader import make_bank_feed
    from sodt_tpu.data.synthetic import SyntheticVedai
    from sodt_tpu.parallel import make_mesh, replicate_tree
    from sodt_tpu.train.loss import LossConfig
    from sodt_tpu.train.optim import make_optimizer
    from sodt_tpu.train.state import (TrainState, make_epoch_scan,
                                      make_train_step)
    from sodt_tpu_torch.weights import from_jax_tree
    jm, v, inp = setup
    r0, r1 = ranks
    assert np.array_equal(r0["epoch"]["metrics"], r1["epoch"]["metrics"])
    ds = SyntheticVedai(n=16, img_size=64, nc=jm.spec.nc)
    feed = make_bank_feed(ds, 4, 64, EPOCH_HYP, seed=9, device_bank=True)
    tx = make_optimizer(EPOCH_HYP, v["params"], epochs=2,
                        nb=feed.steps_per_epoch)
    step = make_train_step(jm, tx, LossConfig(**inp["loss"]))
    mesh = make_mesh(2)
    feed.banks = replicate_tree(feed.banks, mesh)
    st = replicate_tree(TrainState.create(
        jax.tree.map(jnp.asarray, v["params"]),
        jax.tree.map(jnp.asarray, v["batch_stats"]), tx), mesh)
    prim, sec, keys = feed.epoch_schedule()
    st, ms = jax.jit(make_epoch_scan(step, feed.aug_raw, mesh=mesh))(
        st, feed.banks, jnp.asarray(prim),
        jnp.asarray(prim if sec is None else sec), keys)
    got = r0["epoch"]
    for j, k in enumerate(got["keys"]):
        # the parts of the loss hold the packages' own f32 gap on these
        # 16 tiles (cls 2.1e-5 at step 0, before any update, between the
        # one-process port and JAX on one device; the epoch-loss test's
        # 1e-4), the total the 1e-5 of the per-step cases
        np.testing.assert_allclose(got["metrics"][:, j], np.asarray(ms[k]),
                                   rtol=1e-5 if k == "loss" else 1e-4,
                                   atol=1e-7, err_msg=k)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    _same_state(got, {"sd": from_jax_tree(np_(st.params),
                                          np_(st.batch_stats)),
                      "ema": from_jax_tree(np_(st.ema_params),
                                           np_(st.ema_batch_stats))})
    one = worker.run_epoch(inp)
    np.testing.assert_allclose(got["metrics"], one["metrics"], rtol=1e-5,
                               atol=1e-7)
    _same_state(got, one)


def test_sam_sums_both_gradients_over_the_ranks(setup, ranks):
    """Three SAM updates where each rank's loss covers its rows: the
    ascent's norm and the update are the global gradient's, as JAX's SAM
    on the whole batch sharded over two devices computes them."""
    import jax
    import jax.numpy as jnp
    from sodt_tpu.parallel import make_mesh
    from sodt_tpu.train.sam import make_sam_optimizer as jsam
    from jax.sharding import NamedSharding, PartitionSpec as P
    s = setup[2]["sam"]
    assert all(torch.equal(ranks[0]["sam"][k], ranks[1]["sam"][k])
               for k in s["params"])
    cw, cb, cs = (jnp.asarray(c) for c in s["coef"])
    x = jax.device_put(jnp.asarray(s["x"]),
                       NamedSharding(make_mesh(2), P("data")))

    def loss(p, x):
        w, b, sc = p["fc"]["kernel"].T, p["fc"]["bias"], p["bn"]["scale"]
        return (jnp.sum(cw * jnp.sin(w[None] * x[:, 0, None, None]))
                + jnp.sum(cb * (b[None] * x[:, 1, None]) ** 2)
                + jnp.sum(cs * jnp.exp(-sc[None] * x[:, 2, None])))

    grad = jax.jit(jax.grad(loss))
    jp = {"fc": {"kernel": jnp.asarray(s["params"]["fc.weight"].T),
                 "bias": jnp.asarray(s["params"]["fc.bias"])},
          "bn": {"scale": jnp.asarray(s["params"]["bn.weight"])}}
    tx = jsam(SAM_HYP, jp, epochs=3, nb=4, rho=0.05)
    st = tx.init(jp)
    for _ in range(3):
        ups, st = tx.update(grad(jp, x), st, jp,
                            grad_fn=lambda p, i: grad(p, x))
        jp = jax.tree.map(lambda a, u: a + u, jp, ups)
    got = ranks[0]["sam"]
    np.testing.assert_allclose(got["fc.weight"].numpy(),
                               np.asarray(jp["fc"]["kernel"]).T, atol=1e-6)
    np.testing.assert_allclose(got["fc.bias"].numpy(),
                               np.asarray(jp["fc"]["bias"]), atol=1e-6)
    np.testing.assert_allclose(got["bn.weight"].numpy(),
                               np.asarray(jp["bn"]["scale"]), atol=1e-6)


def test_trainer_two_processes_rank0_writes(ranks):
    """The trainer CLI under two processes (--platform cpu): both ranks
    end with rank 0's eval and the same losses; one results line and one
    checkpoint, written by rank 0."""
    r0, r1 = ranks[0]["trainer"], ranks[1]["trainer"]
    assert r0 == r1 and r0["steps"] == 2
    run = ranks[0]["dir"] / "run"
    lines = (run / "results.txt").read_text().splitlines()
    assert len(lines) == 1 and lines[0].startswith("epoch 0/0")
    assert (run / "last.pt").is_file()
    events = (run / "events.jsonl").read_text()
    assert events.count('"train/box_loss"') == 1


def test_world_size_one_is_the_plain_step(setup, tmp_path, monkeypatch):
    """A gloo group of one process takes the code of no group at all: two
    steps, the metrics and the state bit-equal."""
    import torch.distributed as dist
    from sodt_tpu_torch.parallel.mesh import init_from_env, world_size
    inp = setup[2]
    plain = worker.run_steps(inp, inp["batches"][:2], shard=False)
    for k, x in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, x)
    mesh = init_from_env("cpu", init_method=f"file://{tmp_path / 'store'}")
    try:
        assert (mesh.world, mesh.backend, world_size()) == (1, "gloo", 1)
        one = worker.run_steps(inp, inp["batches"][:2])
    finally:
        dist.destroy_process_group()
    assert one["metrics"] == plain["metrics"]
    for part in ("sd", "ema"):
        for k in plain[part]:
            assert torch.equal(one[part][k], plain[part][k]), (part, k)


@pytest.mark.parametrize("regime", ["bank", "streaming"])
def test_feeds_give_each_process_its_rows(regime, monkeypatch):
    """The per-step feed under two processes (`process_index` 0 and 1 of
    2): each yields its half of every step of the one-process feed's
    batch, bit for bit, from the bank and streaming."""
    from sodt_tpu_torch.data import loader
    from sodt_tpu_torch.data.synthetic import SyntheticVedai
    if regime == "streaming":
        monkeypatch.setattr(loader, "DEVICE_BANK_MAX_GB", 0)
    ds = SyntheticVedai(n=8, img_size=64, nc=3, seed=1)
    hyp = dict(EPOCH_HYP, mosaic=1.0, fliplr=0.5, hsv_v=0.4, mixup=0.5)
    feeds = [loader.make_train_batches(ds, 4, 64, hyp, seed=3, device="cpu",
                                       **kw)
             for kw in ({}, dict(process_index=0, process_count=2),
                        dict(process_index=1, process_count=2))]
    for _ in range(3):
        whole, a, b = (next(f) for f in feeds)
        for k in ("img", "ir", "targets", "tmask"):
            assert torch.equal(torch.cat([a[k], b[k]]), whole[k]), k
    with pytest.raises(ValueError, match="not divisible by process_count"):
        loader.make_train_batches(ds, 4, 64, hyp, device="cpu",
                                  process_index=0, process_count=3)


def test_uneven_batch_and_rect_raise(tmp_path, monkeypatch):
    """A global batch that the world size does not divide raises JAX's
    message; so does --rect over several processes."""
    from sodt_tpu_torch.parallel import mesh as pmesh
    from sodt_tpu_torch.train import trainer
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(pmesh.dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="batch_size 3 not divisible by "
                                         "process_count 2"):
        pmesh.shard_rows(3)
    fake = pmesh.Mesh(0, 2, 0, "gloo")
    monkeypatch.setattr(trainer, "init_from_env", lambda dev: fake)
    with pytest.raises(ValueError, match="process_count 2"):
        trainer.train(trainer.TrainConfig(batch_size=3, device="cpu",
                                          save_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="single-host only"):
        trainer.train(trainer.TrainConfig(batch_size=4, rect=True,
                                          device="cpu",
                                          save_dir=str(tmp_path)))
    assert pmesh.shard_batch({"x": np.arange(4), "e": 1})["x"].tolist() == [0, 1]
    bank = {"rgb": torch.zeros(2)}
    assert pmesh.replicate_from_local(bank) is bank
