"""The other model families of the port against the JAX package, f32 on
the CPU: `parse_config` over every shipped config, the CNN blocks (Focus,
SPP, SEBlock, MF) one by one, and whole-model forwards of yolo5m (three
Detect levels), the SR families (SRyolo_PF under RGB+IR, SRyolo_MF under
RGB+IR+MF, both with the SR branch), a steam config under RGB+IR+fusion
and the mono encoder (narrow at 64 px, flagship width at 128 px); then the
three-level head: Detect's bias prior per stride, the loss with its
(4.0, 1.0, 0.4) balance and the decode. Then the port alone: the other
input modes through an eval step, one training step of each CNN family,
the val CLI on yolo5m.

JAX's variables are drawn from a seed on the tree of its init
(`drawn_variables`: biases, BN statistics and scales away from their init
values, so the Detect maps are not the bias prior; `randomize_variables`
of an init for the single blocks), carried over by `from_jax_variables`.
Tolerance 1e-4 (rtol = atol) unless stated; each compared map's spread is
asserted to be 100 times the tolerance or more, so that no comparison is
of near-constant tensors.
"""

import numpy as np
import jax
import pytest
import torch

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.models import layers as JL
from sodt_tpu.models.compiler import parse_config as jparse
from sodt_tpu.models.detect import decode_detections as jdecode
from sodt_tpu.train import loss as jloss
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.models import layers as TL
from sodt_tpu_torch.models.compiler import parse_config as tparse
from sodt_tpu_torch.models.detect import decode_detections as tdecode
from sodt_tpu_torch.train import loss as tloss
from sodt_tpu_torch.weights import from_jax_variables

from torch_port_common import close, drawn_variables, j, randomize_variables, t
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4
CONFIGS = ("model", "model_mono", "model_swinv2", "yolo5m", "SRyolo_MF",
           "SRyolo_PF", "SRyolo_resnet50")
CH_IN = {"RGB": 3, "IR": 3, "RGB+IR": 4, "RGB+IR+MF": 3}

# the steam config of tests/test_models.py: an 8-channel stem on each
# modality, the backbone on their 16-channel concat
STEAM_CFG = {
    "nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "steam": [[-1, 1, "Conv", [8, 3, 1]]],
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]],
    "head": [[-1, 1, "Conv", [32, 1, 1]],
             [[2], 1, "Detect", ["nc", "anchors"]]],
}
# model_mono.yaml's head on a narrow mono encoder (embed 48, 12 heads)
MONO_NARROW = {
    "nc": 8, "depth_multiple": 0.33, "width_multiple": 0.50,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "backbone": [[-1, 1, "ImageEncoderViTMono", [64, 6, 48, 3, 64, 4]]],
    "head": [[2, 1, "Conv", [512, 1, 1]],
             [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 1], 1, "Concat", [1]],
             [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [256, 1, 1]],
             [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 0], 1, "Concat", [1]],
             [-1, 3, "C3", [256, False]],
             [[10], 1, "Detect", ["nc", "anchors"]]],
}


def _cfg(name, pkg):
    return f"{pkg}/configs/{name}.yaml" if isinstance(name, str) else name


def _layers(spec):
    return [(ld.i, ld.f, ld.name, tuple(ld.args), ld.c2)
            for ld in list(spec.backbone) + list(spec.head)]


@pytest.mark.parametrize("name", CONFIGS)
def test_parse_config_matches_jax(name):
    ch = 4 if name in ("model", "model_swinv2", "SRyolo_PF") else 3
    js = jparse(_cfg(name, "sodt_tpu"), ch_in=ch)
    ts = tparse(_cfg(name, "sodt_tpu_torch"), ch_in=ch)
    assert ts.mode == js.mode
    for key in ("detect_from", "detect_ch", "detect_strides", "save",
                "sr_taps", "sr_ch", "anchors", "nc"):
        assert getattr(ts, key) == getattr(js, key), key
    assert _layers(ts) == _layers(js)
    assert _layers(tparse(STEAM_CFG, ch_in=16)) == _layers(
        jparse(STEAM_CFG, ch_in=16))
    jst, tst = jparse(STEAM_CFG, ch_in=16).steam, tparse(STEAM_CFG).steam
    assert [(a.i, a.f, a.c2) for a in jst] == [(b.i, b.f, b.c2) for b in tst]


def test_depth_multiple_and_unported_names():
    spec = tparse("sodt_tpu_torch/configs/yolo5m.yaml", ch_in=3)
    assert [ld.args[1] for ld in spec.backbone if ld.name == "C3"] == [
        2, 6, 6, 2]
    focus = spec.backbone[0]
    assert (focus.name, focus.c1, focus.c2, focus.args) == (
        "Focus", 3, 48, (48, 3))
    assert spec.detect_strides == (8.0, 16.0, 32.0)
    # GhostConv is ported now; a name outside JAX's registry raises JAX's
    # KeyError in both packages
    cfg = dict(STEAM_CFG, backbone=[[-1, 1, "GhostConv", [16, 3, 2]]]
               + STEAM_CFG["backbone"][1:])
    assert tparse(cfg).backbone[0].c2 == 16
    cfg = dict(STEAM_CFG, backbone=[[-1, 1, "GhostConv3D", [16, 3, 2]]]
               + STEAM_CFG["backbone"][1:])
    for parse in (tparse, jparse):
        with pytest.raises(KeyError, match="unknown module 'GhostConv3D'"):
            parse(cfg)


def _module_pair(jmod, tmod, inputs, seed=0):
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed),
                                           *[j(x) for x in inputs]))
    v = randomize_variables(v, seed)
    ref = jmod.apply(v, *[j(x) for x in inputs])
    tmod.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = tmod.eval()(*[t(x) for x in inputs])
    assert float(np.asarray(ref).std()) > 1e-2
    close(got, ref, TOL)


def _rgb(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_focus_matches_jax():
    _module_pair(JL.Focus(c2=16, k=3), TL.Focus(4, 16, k=3),
                 [_rgb((2, 16, 12, 4), 1)])


def test_spp_matches_jax():
    # negative values: the -inf padding, not zeros, must win at the borders
    x = np.random.default_rng(2).normal(size=(2, 10, 12, 16)).astype(
        np.float32) - 1.0
    _module_pair(JL.SPP(c2=24), TL.SPP(16, 24), [x])


def test_seblock_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 6, 5, 64)).astype(
        np.float32)
    _module_pair(JL.SEBlock(reduction=16), TL.SEBlock(64, 16), [x])


def test_mf_matches_jax():
    rgb, ir = _rgb((2, 12, 10, 3), 4), _rgb((2, 12, 10, 1), 5)
    jm, tm = JL.MF(channels=3), TL.MF(3, reduction=3)
    v = jax.tree.map(np.asarray,
                     jm.init(jax.random.PRNGKey(0), [j(rgb), j(ir)]))
    v = randomize_variables(v, 0)
    ref = jm.apply(v, [j(rgb), j(ir)])
    tm.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = tm([t(rgb), t(ir)])
    assert tuple(got.shape) == (2, 12, 10, 64)
    close(got, ref, TOL)


def model_pair(cfg, mode, img, *, sr=False, factor=2, seed=0, batch=2,
               ch_in=None):
    """(raw + sr outputs of JAX, of the port, the port's model) for one
    config at `img` px, from the same perturbed weights."""
    ch_in = ch_in or CH_IN.get(mode, 4)
    jm = jbuild(_cfg(cfg, "sodt_tpu"), ch_in=ch_in, input_mode=mode, sr=sr,
                factor=factor)
    x, ir = _rgb((batch, img, img, 3), seed), _rgb((batch, img, img, 3),
                                                  seed + 1)
    v = drawn_variables(jm, j(x), j(ir), seed=seed)
    ref = jax.jit(jm.apply)(v, j(x), j(ir))
    tm = tbuild(_cfg(cfg, "sodt_tpu_torch"), ch_in=ch_in, input_mode=mode,
                sr=sr, factor=factor).eval()
    tm.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        out = tm(t(x), t(ir))
    return ref, out, tm


def _held(ref, out):
    assert len(out["raw"]) == len(ref["raw"])
    for a, b in zip(out["raw"], ref["raw"]):
        assert tuple(a.shape) == tuple(b.shape)
        assert float(np.asarray(b).std()) > 100 * TOL   # spread >> tolerance
        close(a, b, TOL)
    assert ("sr" in out) == ("sr" in ref)
    if "sr" in ref:
        assert tuple(out["sr"].shape) == tuple(ref["sr"].shape)
        assert float(np.asarray(ref["sr"]).std()) > 1e-3
        close(out["sr"], ref["sr"], TOL)


def test_yolo5m_three_levels_match_jax():
    ref, out, _ = model_pair("yolo5m", "RGB", 64)
    assert [tuple(r.shape[1:3]) for r in out["raw"]] == [(8, 8), (4, 4),
                                                        (2, 2)]
    _held(ref, out)


def test_sryolo_pf_with_sr_matches_jax():
    ref, out, _ = model_pair("SRyolo_PF", "RGB+IR", 64, sr=True)
    assert tuple(out["sr"].shape) == (2, 128, 128, 4)
    _held(ref, out)


def test_sryolo_mf_with_sr_matches_jax():
    ref, out, tm = model_pair("SRyolo_MF", "RGB+IR+MF", 64, sr=True)
    assert tuple(out["sr"].shape) == (2, 128, 128, 4)
    _held(ref, out)
    # the SR decoder's 1x1 convs take the taps' channels from the spec
    assert tm.model_up.sr_decoder.conv1.weight.shape[1] == tm.spec.ch[4]
    assert tm.model_up.sr_decoder.conv2.weight.shape[1] == tm.spec.ch[8]


def test_steam_fusion_matches_jax():
    ref, out, tm = model_pair(STEAM_CFG, "RGB+IR+fusion", 64, ch_in=16)
    assert tuple(out["raw"][0].shape) == (2, 16, 16, 3, 8)
    assert hasattr(tm, "l1000")
    _held(ref, out)


def test_mono_narrow_matches_jax():
    ref, out, _ = model_pair(MONO_NARROW, "RGB", 64)
    _held(ref, out)


def test_mono_flagship_width_matches_jax():
    # embed 192, 6 + 4 + 1 blocks at 128 px: the pos_embed is resampled
    # (antialiased) and stage 3 pads up to one 32x32 window
    ref, out, tm = model_pair("model_mono", "RGB", 128, batch=1)
    assert not hasattr(tm.l0, "chan_block")
    assert tm.l0.patch_embed.proj.weight.shape == (192, 3, 4, 4)
    _held(ref, out)


def test_input_modes_that_jax_cannot_run_raise():
    spec = tparse("sodt_tpu_torch/configs/yolo5m.yaml", ch_in=3)
    from sodt_tpu_torch.models.model import DetectionModel
    with pytest.raises(ValueError, match="first layer is MF"):
        DetectionModel(spec, input_mode="RGB+IR+MF")
    with pytest.raises(ValueError, match="steam"):
        DetectionModel(spec, input_mode="RGB+IR+fusion")
    with pytest.raises(ValueError, match="SR taps"):
        DetectionModel(spec, input_mode="RGB", sr=True)


def test_detect_bias_prior_per_stride():
    from sodt_tpu.models.detect import detect_bias_init
    tm = tbuild("sodt_tpu_torch/configs/yolo5m.yaml", ch_in=3,
                input_mode="RGB")
    for i, stride in enumerate(tm.strides):
        jb = detect_bias_init(8, stride)(jax.random.PRNGKey(0), (39,))
        close(getattr(tm.detect, f"m{i}").bias, jb, 1e-7)
    obj = [getattr(tm.detect, f"m{i}").bias[4].item() for i in range(3)]
    assert obj[0] < obj[1] < obj[2]


def _targets(b, m, seed):
    rng = np.random.default_rng(seed)
    tg = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        n = 3 + i
        tg[i, :n, 0] = rng.integers(0, 8, n)
        tg[i, :n, 1:3] = rng.uniform(0.1, 0.9, (n, 2))
        tg[i, :n, 3:5] = rng.uniform(0.05, 0.6, (n, 2))
        mask[i, :n] = True
    return tg, mask


def test_three_level_loss_and_decode_match_jax():
    spec = tparse("sodt_tpu_torch/configs/yolo5m.yaml", ch_in=3)
    kw = dict(nc=8, anchors=spec.anchors, strides=spec.detect_strides,
              hyp_box=0.05, hyp_obj=1.0, hyp_cls=0.5)
    jcfg, tcfg = jloss.LossConfig(**kw), tloss.LossConfig(**kw)
    assert tcfg.balance == jcfg.balance == (4.0, 1.0, 0.4)
    rng = np.random.default_rng(0)
    raws = [rng.normal(size=(2, s, s, 3, 13)).astype(np.float32)
            for s in (16, 8, 4)]
    tg, mask = _targets(2, 8, 1)
    jtot, jparts = jax.jit(lambda r, g, m: jloss.compute_loss(r, g, m, jcfg))(
        [j(r) for r in raws], j(tg), mask)
    ttot, tparts = tloss.compute_loss([t(r) for r in raws], t(tg),
                                      torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        assert float(jparts[k]) > 0
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    anchors = np.asarray(spec.anchors, np.float32).reshape(3, -1, 2)
    close(tdecode([t(r) for r in raws], anchors, spec.detect_strides),
          jdecode([j(r) for r in raws], anchors, spec.detect_strides), TOL)


# the input modes each family takes in JAX beyond those of the forward
# comparisons above (mono RGB, yolo5m RGB, SRyolo_PF RGB+IR, SRyolo_MF
# RGB+IR+MF)
FAMILY_MODES = [("model_mono", "IR"), ("yolo5m", "IR"), ("yolo5m", "RGB+IR"),
                ("SRyolo_PF", "RGB"), ("SRyolo_PF", "IR")]


def _built(cfg, mode):
    """The model as the CLIs build it (`trainer.CH_IN` of the mode)."""
    from sodt_tpu_torch.train.trainer import CH_IN as TRAIN_CH_IN
    from sodt_tpu_torch.weights import init_weights
    return init_weights(tbuild(f"{cfg}.yaml", ch_in=TRAIN_CH_IN[mode],
                               input_mode=mode), 0)


_IMG, _IR = _rgb((2, 32, 32, 3), 3), _rgb((2, 32, 32, 3), 4)


@pytest.mark.parametrize("cfg,mode", FAMILY_MODES)
def test_every_family_and_mode_evaluates(cfg, mode):
    from sodt_tpu_torch.train.evaluate import make_eval_step
    dets, valid, _ = make_eval_step(_built(cfg, mode).eval())(t(_IMG),
                                                             t(_IR))
    assert dets.shape == (2, 300, 6) and torch.isfinite(dets).all()


@pytest.mark.parametrize("cfg,mode", [("yolo5m", "RGB+IR"),
                                      ("SRyolo_PF", "IR"),
                                      ("SRyolo_MF", "RGB+IR+MF")])
def test_every_cnn_family_trains(cfg, mode):
    """One training step at 32 px gives every parameter a finite gradient,
    and all but MF's squeeze-and-excite weights a non-zero one."""
    from sodt_tpu_torch.train import optim as topt, state as tstate
    tm = _built(cfg, mode)
    params = dict(tm.named_parameters())
    tx = topt.make_optimizer(dict(lr0=0.01, lrf=0.2, momentum=0.937),
                             params, 1, 1)
    grads = {}
    step = tstate.make_train_step(tm, tx, tloss.LossConfig(
        nc=8, anchors=tm.spec.anchors, strides=tm.spec.detect_strides),
        on_grads=grads.update)
    tg, mask = _targets(2, 8, 2)
    _, met = step(tstate.TrainState.create(tm, tx),
                  {"img": t(_IMG), "ir": t(_IR), "targets": t(tg),
                   "tmask": torch.from_numpy(mask)})
    assert all(np.isfinite(float(v)) for v in met.values())
    assert set(grads) == set(params)
    assert all(torch.isfinite(g).all() for g in grads.values())
    # MF's squeeze-and-excite on RGB (3 -> 1) and IR (1 -> 1) has a one-unit
    # ReLU, which a seeded init may leave dead for the batch (so in JAX)
    dead = [k for k, g in grads.items() if not g.abs().max() > 0]
    assert all(".se_r." in k or ".se_i." in k for k in dead), dead


def test_val_cli_runs_a_cnn_family(tmp_path):
    from sodt_tpu_torch import val
    m = val.main(["--cfg", "yolo5m.yaml", "--input_mode", "RGB+IR",
                  "--synthetic", "--synthetic-n", "2", "--img-size", "64",
                  "--batch-size", "2", "--no-bf16", "--device", "cpu",
                  "--save-dir", str(tmp_path)])
    assert m["seen"] == 2 and np.isfinite(m["map50"])
