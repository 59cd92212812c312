"""The port's bench (`sodt_tpu_torch/bench.py`, `python -m
sodt_tpu_torch.bench`) against the JAX system's root `bench.py`, f32 on
the CPU.

  * its eval step and whole pass against JAX's bench step (`make_eval_step`
    with conf 0.25, IoU 0.45, best class only, top-k 1024: `--quick`'s),
    on the in-repo trained flagship at 128 px and uint8 `SyntheticVedai`
    batches: the same survivors, dets within 1e-4, the checksum within
    1e-4 relative, and some detections valid;
  * the port's FLOP count of the flagship's forward (FlopCounterMode, on
    the composition) against JAX's (XLA's cost analysis, `no_kernels()`):
    XLA also counts element-wise work, so the ratio sits below 1. It read
    0.9803 at batch 2 and 128 px; the band is [0.97, 1 + 1e-3];
  * the training step's count on the narrow flagship with remat, at 64
    px: against JAX's count of its step (`make_train_step`, XLA's cost
    analysis, `no_kernels()` on both sides, the recompute in both). It
    read 0.9310 at batch 2; the band is [0.92, 1 + 1e-3]. Carried from 1
    and 2 images to 4, it equals the count at 4, and it leaves the state
    that it was given untouched;
  * `run` / `main` on the CPU return and print JAX's record, and without
    a card and without `--device cpu` the bench exits non-zero and prints
    nothing on stdout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sodt_tpu_torch import bench
from sodt_tpu_torch.data import SyntheticVedai
from sodt_tpu_torch.models import build_model
from sodt_tpu_torch.train.loss import LossConfig
from sodt_tpu_torch.train.optim import make_optimizer
from sodt_tpu_torch.train.state import TrainState, make_train_step
from sodt_tpu_torch.utils.profiler import flops_estimate

from torch_port_common import NARROW_CFG, close
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
TINY = str(ROOT / "tests/tiny.yaml")
IMG = 128
BATCH = 2
ITERS = 3
TOP_K = 1024           # --quick's
DET_TOL = 1e-4
FLOP_BAND = (0.97, 1 + 1e-3)
TRAIN_IMG = 64
TRAIN_FLOP_BAND = (0.92, 1 + 1e-3)
JAX_FIELDS = ("metric", "value", "unit", "vs_baseline", "inference_ips",
              "e2e_host_ips", "e2e_feed_mbps", "int8_ips", "topk_path",
              "train_ips", "train_feed_ips", "train_scan_feed_ips")
CARD_FIELDS = ("gflops_per_img", "inference_mfu", "train_mfu",
               "peak_memory_bytes")


@pytest.fixture(scope="module")
def trained():
    from torch_port_common import trained_pair
    return trained_pair()


def synthetic_batches():
    """ITERS uint8 (BATCH, IMG, IMG, 3) RGB and IR batches of
    SyntheticVedai(seed=1)."""
    ds = SyntheticVedai(n=BATCH * ITERS, img_size=IMG, seed=1)
    rgb, ir = zip(*[ds[i][:2] for i in range(len(ds))])
    shape = (ITERS, BATCH, IMG, IMG, 3)
    return np.stack(rgb).reshape(shape), np.stack(ir).reshape(shape)


def test_eval_step_and_pass_match_jax_bench_step(trained):
    import jax
    import jax.numpy as jnp
    from sodt_tpu.train.evaluate import make_eval_step as jmake
    jm, v, tm = trained
    jstep = jmake(jm, conf_thres=0.25, iou_thres=0.45, multi_label=False,
                  approx_topk=False, top_k=TOP_K)
    vj = jax.tree.map(jnp.asarray, v)
    imgs, irs = synthetic_batches()
    runner = bench.eval_runner(tm, TOP_K)
    jd, jv = zip(*[jstep(vj, jnp.asarray(a), jnp.asarray(b))[:2]
                   for a, b in zip(imgs, irs)])
    jd, jv = np.stack(jd), np.stack(jv)
    pd, pv, _ = runner.scan_fn()(torch.from_numpy(imgs),
                                 torch.from_numpy(irs))
    for i in range(ITERS):
        td, tv, _ = runner.step(torch.from_numpy(imgs[i]),
                                torch.from_numpy(irs[i]))
        np.testing.assert_array_equal(tv.numpy(), jv[i])
        np.testing.assert_array_equal(pv[i].numpy(), jv[i])
        close(td[tv], jd[i][jv[i]], DET_TOL)
        close(pd[i][pv[i]], jd[i][jv[i]], DET_TOL)
    assert jv.sum() > 0
    got = float(bench.pass_checksum(runner, torch.from_numpy(imgs),
                                    torch.from_numpy(irs)))
    want = float(jd.sum())
    assert abs(got - want) <= DET_TOL * abs(want), (got, want)


def test_forward_flops_match_jax_count(trained):
    import jax
    from sodt_tpu.pallas import no_kernels as jax_no_kernels
    from sodt_tpu.utils.profiler import flops_estimate as jax_flops
    from sodt_tpu_torch import kernels
    jm, v, tm = trained
    x = np.zeros((BATCH, IMG, IMG, 3), np.float32)
    with jax_no_kernels():
        want = jax_flops(lambda vv, a, b: jm.apply(vv, a, b,
                                                   train=False)["raw"],
                         jax.tree.map(jax.numpy.asarray, v), x, x)
    xt = torch.from_numpy(x)
    with kernels.no_kernels():
        got = flops_estimate(lambda a, b: tm(a, b), xt, xt)
    assert want and got
    assert FLOP_BAND[0] <= got / want <= FLOP_BAND[1], got / want
    # the bench's count of its eval step: the forward's, and the merge
    # NMS's weighted boxes (a matmul; decode adds none)
    step = bench.eval_flops(bench.eval_runner(tm, TOP_K), xt, xt)
    assert got < step <= got * (1 + 1e-3), (step, got)


def test_train_flops_match_jax_count_and_leave_the_state():
    import copy
    import jax
    import jax.numpy as jnp
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.pallas import no_kernels as jax_no_kernels
    from sodt_tpu.train import loss as jloss, optim as jopt, state as jstate
    from sodt_tpu.utils.profiler import flops_estimate as jax_flops
    from sodt_tpu_torch import kernels
    from sodt_tpu_torch.weights import from_jax_variables
    jm = jbuild(NARROW_CFG, ch_in=4, input_mode="RGB+IR", remat=True)
    x0 = jnp.zeros((1, TRAIN_IMG, TRAIN_IMG, 3))
    v = jax.jit(lambda k: jm.init(k, x0, x0, train=True))(
        jax.random.PRNGKey(0))
    u8 = np.random.default_rng(0).integers(
        0, 256, (2 * BATCH, TRAIN_IMG, TRAIN_IMG, 3), np.uint8)
    targets = np.zeros((2 * BATCH, bench.N_TARGETS, 5), np.float32)
    targets[:, 0] = [1, 0.5, 0.5, 0.2, 0.2]
    tmask = np.zeros((2 * BATCH, bench.N_TARGETS), bool)
    tmask[:, 0] = True

    # JAX's count, as its bench takes it: the step on uint8 images, jitted
    # inside no_kernels()
    jcfg = jloss.LossConfig(nc=jm.spec.nc, anchors=jm.spec.anchors,
                            strides=jm.spec.detect_strides)
    jtx = jopt.make_optimizer(bench.HYP, v["params"], epochs=10, nb=100)
    js = jstate.TrainState.create(v["params"], v["batch_stats"], jtx)
    with jax_no_kernels():
        jstep = jstate.make_train_step(jm, jtx, jcfg)

        def jstep_u8(st, img_u8, t, m):
            img = img_u8.astype(jnp.float32) / 255.0
            return jstep(st, {"img": img, "ir": img, "targets": t,
                              "tmask": m})
        want = jax_flops(jstep_u8, js, *(jnp.asarray(x[:BATCH])
                                         for x in (u8, targets, tmask)))

    model = build_model(NARROW_CFG, ch_in=4, remat=True)
    model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, v)))
    loss_cfg = LossConfig(nc=model.spec.nc, anchors=model.spec.anchors,
                          strides=model.spec.detect_strides)
    tx = make_optimizer(bench.HYP, dict(model.named_parameters()),
                        epochs=10, nb=100)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, loss_cfg)
    batch = bench.train_batch(*map(torch.from_numpy, (u8, targets, tmask)))
    half = {k: t[:BATCH] for k, t in batch.items()}
    step(state, half)           # momentum buffers and an EMA update exist
    before = (
        {k: t.clone() for k, t in model.state_dict().items()},
        {k: t.clone() for k, t in state.ema.items()}, tx.state_dict(),
        state.step, state.ema_updates)
    got = bench.train_flops(state, loss_cfg, half)
    assert want and got
    assert TRAIN_FLOP_BAND[0] <= got / want <= TRAIN_FLOP_BAND[1], got / want
    # carried from 1 and 2 images to 4, the count is the count at 4
    twin = copy.deepcopy(state)
    with kernels.no_kernels():
        at4 = flops_estimate(torch.enable_grad()(
            make_train_step(twin.model, twin.tx, loss_cfg)), twin, batch)
    assert bench.train_flops(state, loss_cfg, batch) == at4 > got
    sd, ema, opt, n, n_ema = before
    assert (state.step, state.ema_updates) == (n, n_ema)
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]), k
    for k, t in state.ema.items():
        assert torch.equal(t, ema[k]), k
    now = tx.state_dict()
    assert (now["count"], now["ni"]) == (opt["count"], opt["ni"])
    assert opt["trace"]
    for k, t in now["trace"].items():
        assert torch.equal(t, opt["trace"][k]), k


def test_run_and_main_on_the_cpu(capsys):
    argv = ["--quick", "--device", "cpu", "--cfg", TINY, "--img-size", "64",
            "--iters", "2", "--int8"]
    rec = bench.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == json.loads(json.dumps(rec))
    for k in JAX_FIELDS:
        assert k in rec, k
    for k in CARD_FIELDS:
        assert k not in rec, k
    assert rec["metric"] == bench.METRIC
    assert rec["unit"] == "images/sec/chip"
    assert rec["topk_path"] == "exact"
    assert rec["vs_baseline"] is None
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["value"] == rec["inference_ips"]
    for k in ("inference_ips", "e2e_host_ips", "e2e_feed_mbps", "int8_ips",
              "train_ips", "train_feed_ips", "train_scan_feed_ips"):
        assert np.isfinite(rec[k]) and rec[k] > 0, (k, rec[k])
    # e2e_feed_mbps is the uint8 RGB + IR bytes that e2e_host_ips moves
    assert rec["e2e_feed_mbps"] == pytest.approx(
        rec["e2e_host_ips"] * 2 * 3 * 64 * 64 / 1e6)
    skip = bench.run(argv[:-1] + ["--skip-train"])
    assert "train_ips" not in skip and "int8_ips" not in skip


def test_no_card_no_record():
    """Whatever the machine, the child sees no card: it must refuse to run
    on the CPU unasked."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "sodt_tpu_torch.bench",
                          "--quick", "--cfg", TINY], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr
