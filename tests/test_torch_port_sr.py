"""The super-resolution branch of the port against the JAX package, f32 on
the CPU: the one bilinear resize (`ops.resize`) against
`jax.image.resize(..., "bilinear")`, pixel_shuffle bit-equal, SRDecoder,
EDSR and DeepLabSR at 64 px, three `make_train_step(sr=True,
down_factor=2)` steps against JAX's on the SR config of
tests/test_train_step.py under RGB+IR (every loss part including `sr`,
every leaf after each update), the SR loss's weights in every input mode
against JAX's step, the trainer CLI's `--super --factor 2 --down-factor 2`
for one step, `--factor 1` failing in both packages, and an SR checkpoint
loading into a model built without the branch.

Tolerance 1e-4 (rtol = atol) unless stated; the step's leaves are held to
max |port - jax| <= 1e-4 * max |jax| (+ 1e-7), the loss parts to 1e-5,
as in tests/test_torch_port_train_step.py.

Conditioning of the SR step. The L1 loss hands every SR pixel a cotangent
of +-1 / N, so its gradient is ill-conditioned in two ways. Where the SR
output lies above (or below) every image pixel, as it does from weights
of unit scale, the cotangent is one constant, and BatchNorm's backward in
training mode subtracts its mean: the parameter gradients are then the
small difference of large terms, and f32 puts either package up to 8e-3
(relative, per leaf) from the gradient that the port computes in f64,
while an f32 step of the input moves that f64 gradient by 4e-6 (measured
on this test's model). Where instead the output crosses the images, a
pixel within the two packages' forward difference (~1e-5) of |sr - img|'s
kink takes opposite signs in them. The step test therefore centres the SR
output (EDSR's last conv scaled by 0.01, its bias 0.5) between pixels
drawn from [0, 0.15) and [0.85, 1), and asserts that the output lies above
the image on between 20 % and 80 % of the pixels and at least 0.05 from
every one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.models import sr as jsr
from sodt_tpu.train import loss as jloss, optim as jopt, state as jstate
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.models import sr as tsr
from sodt_tpu_torch.ops.resize import resize_bilinear
from sodt_tpu_torch.train import loss as tloss, optim as topt, state as tstate
from sodt_tpu_torch.weights import (batch_to_torch, from_jax_tree,
                                    from_jax_variables)

from torch_port_common import close, drawn_variables, j, t
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4
# tests/test_train_step.py's SR config: taps l1 (32 ch at /4), l2 (64 ch
# at /8)
SR_CFG = {
    "nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "l1": 2, "l2": 4, "c1": 32, "c2": 64,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "C3", [32]], [-1, 1, "Conv", [64, 3, 2]],
                 [-1, 1, "C3", [64]]],
    "head": [[-1, 1, "Conv", [32, 1, 1]],
             [[5], 1, "Detect", ["nc", "anchors"]]],
}
HYP = dict(lr0=0.01, lrf=0.2, momentum=0.937, warmup_momentum=0.8,
           warmup_bias_lr=0.1, warmup_iters=2)


@pytest.mark.parametrize("src,dst", [((48, 40), (36, 30)),
                                     ((20, 28), (60, 44)),
                                     ((32, 24), (16, 48))])
def test_resize_matches_jax_bilinear(src, dst):
    # shrinking (antialiased), growing, and one axis each way; non-square
    x = np.random.default_rng(0).uniform(0, 1, (2, *src, 5)).astype(
        np.float32)
    ref = jax.image.resize(j(x), (2, *dst, 5), "bilinear")
    close(resize_bilinear(t(x), dst), ref, 1e-6)


def test_pixel_shuffle_bit_equal():
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 4 * 6)).astype(
        np.float32)
    got = tsr.pixel_shuffle(t(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsr.pixel_shuffle(j(x), 2)))
    nchw = torch.nn.PixelShuffle(2)(t(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got, nchw.permute(0, 2, 3, 1).numpy())


def _held_module(jmod, tmod, inputs, out_shape):
    v = drawn_variables(jmod, *[j(x) for x in inputs], seed=3)
    ref = jax.jit(jmod.apply)(v, *[j(x) for x in inputs])
    tmod.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = tmod(*[t(x) for x in inputs])
    assert tuple(got.shape) == out_shape
    assert float(np.asarray(ref).std()) > 100 * TOL
    close(got, ref, TOL)


@pytest.mark.parametrize("factor", [2, 4])
def test_sr_decoder_matches_jax(factor):
    rng = np.random.default_rng(2)
    high = rng.uniform(0, 1, (2, 8, 8, 64)).astype(np.float32)
    low = rng.uniform(0, 1, (2, 16, 16, 32)).astype(np.float32)
    s = 16 * (factor // 2)
    _held_module(jsr.SRDecoder(32, 64, factor),
                 tsr.SRDecoder(32, 64, 32, 64, factor), [high, low],
                 (2, s, s, 64))


def test_edsr_matches_jax():
    x = np.random.default_rng(4).normal(size=(1, 8, 8, 64)).astype(
        np.float32)
    _held_module(jsr.EDSR(num_channels=4), tsr.EDSR(num_channels=4), [x],
                 (1, 64, 64, 4))


def test_deeplab_sr_matches_jax():
    # 64 px input: the /4 tap at 16 px, the /8 tap at 8 px; x8 after the
    # decoder's x1 (factor 2) gives 128 px
    rng = np.random.default_rng(5)
    low = rng.uniform(0, 1, (2, 16, 16, 32)).astype(np.float32)
    high = rng.uniform(0, 1, (2, 8, 8, 64)).astype(np.float32)
    _held_module(jsr.DeepLabSR(out_ch=3, c1=32, c2=64, factor=2),
                 tsr.DeepLabSR(3, 32, 64, 32, 64, factor=2), [low, high],
                 (2, 128, 128, 3))


IMG = 128


def _batch(seed, img=IMG, b=2):
    rng = np.random.default_rng(seed)
    tg = np.zeros((b, 4, 5), np.float32)
    mask = np.zeros((b, 4), bool)
    for i, n in enumerate((3, 2)):
        tg[i, :n, 0] = rng.integers(0, 3, n)
        tg[i, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        tg[i, :n, 3:5] = rng.uniform(0.1, 0.4, (n, 2))
        mask[i, :n] = True
    # pixels in [0, 0.15) and [0.85, 1): none near the centred SR output
    px = lambda: np.where(*[(u := rng.uniform(0, 1, (b, img, img, 3))) < 0.5,
                            0.3 * u, 0.7 + 0.3 * u]).astype(np.float32)
    return {"img": px(), "ir": px(), "targets": tg, "tmask": mask}


def _held(got: dict, want: dict, tol: float, what: str) -> None:
    assert set(got) == set(want), what
    for k, w in want.items():
        a, w = got[k].detach().numpy(), w.numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(a - w).max())
        assert err <= tol * scale + 1e-7, (what, k, err, scale)


@pytest.mark.parametrize("mode", ["RGB+IR"])
def test_sr_train_step_matches_jax_for_three_steps(mode):
    ch = 3 if mode == "RGB" else 4
    jm = jbuild(SR_CFG, ch_in=ch, input_mode=mode, sr=True, factor=2)
    b0 = _batch(0)
    x0 = j(b0["img"][:, ::2, ::2])
    v = drawn_variables(jm, x0, x0, seed=1)
    # the SR output centred on the images' range (see the module notes)
    tail = v["params"]["model_up"]["edsr"]["tail_out"]
    tail["kernel"] = tail["kernel"] * np.float32(0.01)
    tail["bias"] = np.full_like(tail["bias"], 0.5)
    kw = dict(nc=3, anchors=jm.spec.anchors, strides=jm.spec.detect_strides,
              hyp_box=0.15, hyp_obj=0.03, hyp_cls=0.15)
    jcfg, tcfg = jloss.LossConfig(**kw), tloss.LossConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, v["params"])
    jtx = jopt.make_optimizer(HYP, jparams, 3, 2)
    js = jstate.TrainState.create(
        jparams, jax.tree.map(jnp.asarray, v["batch_stats"]), jtx)
    jstep = jax.jit(jstate.make_train_step(jm, jtx, jcfg, sr=True,
                                           down_factor=2))

    tm = tbuild(SR_CFG, ch_in=ch, input_mode=mode, sr=True, factor=2)
    tm.load_state_dict(from_jax_variables(v))
    ttx = topt.make_optimizer(HYP, dict(tm.named_parameters()), 3, 2)
    ts = tstate.TrainState.create(tm, ttx)
    tstep = tstate.make_train_step(tm, ttx, tcfg, sr=True, down_factor=2)
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)
    for it in range(3):
        batch = _batch(10 + it)
        js, jmet = jstep(js, {k: jnp.asarray(x) for k, x in batch.items()})
        tb = batch_to_torch(batch)
        if it == 0:
            with torch.no_grad():
                size = (IMG // 2, IMG // 2)
                sr_out = tm.train()(resize_bilinear(tb["img"], size),
                                    resize_bilinear(tb["ir"], size))["sr"]
            gap = sr_out[..., :3] - tb["img"]
            above = float((gap > 0).float().mean())
            assert 0.2 < above < 0.8 and float(gap.abs().min()) > 0.05
            tm.load_state_dict(from_jax_variables(v))   # BN stats back
        ts, tmet = tstep(ts, tb)
        assert float(jmet["sr"]) > 0
        for k in ("loss", "box", "obj", "cls", "sr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        want = from_jax_variables({"params": np_tree(js.params),
                                   "batch_stats": np_tree(js.batch_stats)})
        _held(dict(tm.state_dict()), want, TOL, f"params + BN stats {it}")
        _held(ts.ema, from_jax_tree(np_tree(js.ema_params),
                                    np_tree(js.ema_batch_stats)), TOL,
              f"ema {it}")


@pytest.mark.parametrize("mode", ["RGB", "IR", "RGB+IR", "RGB+IR+MF"])
def test_sr_l1_weights_match_jax(mode):
    """The SR loss part of each input mode against JAX's train step, run
    on a stand-in model whose apply returns a given SR output (and one
    empty Detect level)."""
    import optax
    rng = np.random.default_rng(6)
    img, ir = rng.uniform(0, 1, (2, 2, 16, 16, 3)).astype(np.float32)
    out = rng.uniform(0, 1, (2, 16, 16, 3 if mode in ("RGB", "IR") else 4)
                      ).astype(np.float32)

    class Stub:              # the part of DetectionModel the step reads
        input_mode = mode

        def apply(self, v, *a, **kw):
            return ({"raw": [jnp.zeros((2, 2, 2, 3, 8))],
                     "sr": jnp.asarray(out)}, {"batch_stats": {}})

    cfg = jloss.LossConfig(nc=3, anchors=SR_CFG["anchors"], strides=(8.0,))
    tx = optax.sgd(0.1)
    _, met = jax.jit(jstate.make_train_step(Stub(), tx, cfg, sr=True))(
        jstate.TrainState.create({}, {}, tx),
        {"img": jnp.asarray(img), "ir": jnp.asarray(ir),
         "targets": jnp.zeros((2, 1, 5)), "tmask": jnp.zeros((2, 1), bool)})
    got = tstate.sr_l1(t(out), t(img), t(ir), mode)
    np.testing.assert_allclose(float(got), float(met["sr"]), rtol=1e-6)


def _sr_args(tmp_path, *extra):
    cfg = tmp_path / "sr.yaml"
    cfg.write_text(yaml.safe_dump(SR_CFG))
    with open("sodt_tpu_torch/configs/hyp.scratch.yaml") as f:
        h = yaml.safe_load(f)
    hyp = tmp_path / "hyp.yaml"
    hyp.write_text(yaml.safe_dump(dict(h, warmup_iters=2)))
    return ["--cfg", str(cfg), "--hyp", str(hyp), "--synthetic",
            "--synthetic-n", "2", "--img-size", "128", "--batch-size", "2",
            "--nbs", "2", "--epochs", "1", "--no-bf16", "--device", "cpu",
            "--input_mode", "RGB+IR", "--save-dir", str(tmp_path / "run"),
            *extra]


def test_train_cli_super_runs_and_its_checkpoint_evaluates(tmp_path):
    from sodt_tpu_torch import val
    from sodt_tpu_torch.train import cli
    seen = []
    m = cli.main(_sr_args(tmp_path, "--super", "--factor", "2",
                          "--down-factor", "2"),
                 on_step=lambda st, met: seen.append(
                     {k: float(x) for k, x in met.items()}))
    assert m["steps"] == 1 and len(seen) == 1
    assert seen[0]["sr"] > 0 and all(np.isfinite(list(seen[0].values())))
    assert np.isfinite(m["map50"])
    opt = yaml.safe_load((tmp_path / "run" / "opt.yaml").read_text())
    assert (opt["sr"], opt["sr_factor"], opt["down_factor"]) == (True, 2, 2)
    ckpt = tmp_path / "run" / "last.pt"
    sd = torch.load(ckpt, weights_only=True)["ema"]
    assert any(k.startswith("model_up.") for k in sd)
    # a model built without the branch takes the checkpoint, the SR
    # branch's entries left aside, as JAX's apply ignores them
    cfg = str(tmp_path / "sr.yaml")
    r = val.main(["--cfg", cfg, "--weights", str(ckpt), "--synthetic",
                  "--synthetic-n", "2", "--img-size", "128",
                  "--batch-size", "2", "--no-bf16", "--device", "cpu",
                  "--input_mode", "RGB+IR",
                  "--save-dir", str(tmp_path / "val")])
    assert np.isfinite(r["map50"])
    plain = tbuild(cfg, ch_in=4, nc=8)
    from sodt_tpu_torch.train.checkpoint import load_into
    load_into(plain, ckpt)
    for k, p in plain.state_dict().items():
        assert torch.equal(p, sd[k]), k


def test_factor_1_fails_in_both_packages(tmp_path):
    from sodt_tpu_torch.train import cli
    jm = jbuild(SR_CFG, ch_in=3, input_mode="RGB", sr=True, factor=1)
    x = j(np.zeros((1, 64, 64, 3), np.float32))
    with pytest.raises(TypeError):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, x)
    with pytest.raises(ValueError, match="factor 1"):
        tbuild(SR_CFG, ch_in=3, input_mode="RGB", sr=True, factor=1)
    # --factor defaults to 1, as JAX's train.py has it
    with pytest.raises(ValueError, match="factor 1"):
        cli.main(_sr_args(tmp_path, "--super"))
