"""The layers of JAX's registry that no shipped config uses, ported, against
the JAX package in f32 on the CPU: each module against its flax module
(Contract, Expand, Sum, Classify, BottleneckCSP, BottleneckCSP2, SPPCSP,
CrossConv, GhostConv, GhostBottleneck, MixConv2d, AttentionModel,
ScaledDotProductAttentionOnly, ACmix), held to max |port - jax| <= 1e-5 x
max |jax|; Upsample with each of JAX's resize methods against
`jax.image.resize` at 1e-6; the compiler on `every_layer.yaml` (all twelve
registry entries and an Upsample of each method) equal to JAX's LayerDefs,
and the built model's Detect maps at 1e-4; the unknown-name KeyError.

A flax module's variables come from its init, perturbed
(`randomize_variables`: BN statistics and biases away from their init
values; Sum's weights and ACmix's rates are moved here too), carried over
by `from_jax_variables`. Each compared output's spread is asserted, so
that no comparison is of near-constant tensors.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.models import layers as JL
from sodt_tpu.models.compiler import parse_config as jparse
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.models import layers as TL
from sodt_tpu_torch.models.compiler import parse_config as tparse
from sodt_tpu_torch.ops.resize import KERNELS, resize
from sodt_tpu_torch.weights import from_jax_variables

from torch_port_common import drawn_variables, j, randomize_variables, t
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
RESIZE_TOL = 1e-6
MODEL_TOL = 1e-4
EVERY_LAYER = "sodt_tpu_torch/configs/every_layer.yaml"


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, ref) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _moved(v, seed):
    """`randomize_variables`, and the parameters it leaves at their init
    (Sum's w, ACmix's rate1 / rate2) moved as well."""
    v = randomize_variables(v, seed)
    rng = np.random.default_rng(seed + 100)

    def walk(d):
        return {k: (walk(x) if isinstance(x, dict) else
                    x + (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
                    if k in ("w", "rate1", "rate2") else x)
                for k, x in d.items()}
    return walk(v)


def _pair(jmod, tmod, inputs, seed=0, train=False):
    """The flax module and the port's on the same variables and inputs:
    (port output, JAX output, JAX's updated batch_stats or None)."""
    ji = [jax.tree.map(j, x) for x in inputs]
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed), *ji))
    v = _moved(v, seed)
    if train:
        ref, upd = jmod.apply(v, *ji, train=True, mutable=["batch_stats"])
    else:
        ref, upd = jmod.apply(v, *ji), None
    if v:
        tmod.load_state_dict(from_jax_variables(v))
    tmod.train(train)
    with torch.no_grad():
        got = tmod(*[jax.tree.map(t, x) for x in inputs])
    assert float(np.asarray(ref).std()) > 1e-2
    return got, ref, upd


def _check(jmod, tmod, inputs, seed=0):
    got, ref, _ = _pair(jmod, tmod, inputs, seed)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("gain", [2, 4])
def test_contract_expand_match_jax(gain):
    x = _x((2, 8, 16, 3 * gain * gain), 1)
    _check(JL.Contract(gain), TL.Contract(gain), [x])
    _check(JL.Expand(gain), TL.Expand(gain), [x])
    # Expand undoes Contract
    y = TL.Expand(gain)(TL.Contract(gain)(t(x)))
    assert torch.equal(y, t(x))


@pytest.mark.parametrize("weight", [False, True])
def test_sum_matches_jax(weight):
    xs = [_x((2, 5, 6, 8), s) for s in (1, 2, 3)]
    jm, tm = JL.Sum(n=3, weight=weight), TL.Sum(3, weight)
    _check(jm, tm, [xs])
    if weight:     # the init, -(1, 2) / 2, is JAX's
        v = jm.init(jax.random.PRNGKey(0), [j(x) for x in xs])
        np.testing.assert_array_equal(TL.Sum(3, True).w.detach().numpy(),
                                      np.asarray(v["params"]["w"]))


@pytest.mark.parametrize("k, s, listed", [(1, 1, False), (3, 2, True),
                                          (2, 1, True)])
def test_classify_matches_jax(k, s, listed):
    xs = [_x((2, 6, 5, 8), 4), _x((2, 3, 3, 4), 5)]
    inp = xs if listed else xs[0]
    c1 = 12 if listed else 8
    got, ref, _ = _pair(JL.Classify(c2=7, k=k, s=s), TL.Classify(c1, 7, k, s),
                        [inp])
    assert got.shape == (2, 7) and _rel(got, ref) <= TOL


@pytest.mark.parametrize("shortcut", [True, False])
def test_bottleneck_csp_matches_jax(shortcut):
    x = _x((2, 8, 10, 16), 6)
    _check(JL.BottleneckCSP(c2=16, n=2, shortcut=shortcut),
           TL.BottleneckCSP(16, 16, n=2, shortcut=shortcut), [x])


def test_bottleneck_csp_training_mode_matches_jax():
    """Batch statistics and the running update of the bare BatchNorm."""
    x = _x((2, 8, 10, 8), 7)
    tm = TL.BottleneckCSP(8, 24, n=1)
    got, ref, upd = _pair(JL.BottleneckCSP(c2=24, n=1), tm, [x], train=True)
    assert _rel(got, ref) <= TOL
    want = from_jax_variables(jax.tree.map(np.asarray, dict(upd)))
    assert len(want) == 2 * 5       # cv1, m0.cv1, m0.cv2, cv4, the bare bn
    for k, w in want.items():
        assert _rel(tm.state_dict()[k], w) <= TOL, k


def test_bottleneck_csp2_matches_jax():
    x = _x((2, 8, 10, 12), 8)
    _check(JL.BottleneckCSP2(c2=16, n=2), TL.BottleneckCSP2(12, 16, n=2), [x])
    _check(JL.BottleneckCSP2(c2=12, n=1, shortcut=True),
           TL.BottleneckCSP2(12, 12, n=1, shortcut=True), [x])


def test_sppcsp_matches_jax():
    # negative values: the -inf padding of the pools must win at the borders
    x = _x((2, 10, 12, 16), 9) - 1.0
    _check(JL.SPPCSP(c2=16, n=3), TL.SPPCSP(16, 16, n=3), [x])


@pytest.mark.parametrize("k, s, shortcut", [(3, 1, True), (5, 2, False)])
def test_crossconv_matches_jax(k, s, shortcut):
    x = _x((2, 10, 12, 16), 10)
    _check(JL.CrossConv(c2=16, k=k, s=s, shortcut=shortcut),
           TL.CrossConv(16, 16, k=k, s=s, shortcut=shortcut), [x])


@pytest.mark.parametrize("k, s, act", [(1, 1, TL.silu), (3, 2, None)])
def test_ghostconv_matches_jax(k, s, act):
    x = _x((2, 10, 12, 8), 11)
    _check(JL.GhostConv(c2=16, k=k, s=s, act=JL.silu if act else None),
           TL.GhostConv(8, 16, k=k, s=s, act=act), [x])


@pytest.mark.parametrize("c1, s", [(16, 1), (8, 2)])
def test_ghost_bottleneck_matches_jax(c1, s):
    x = _x((2, 10, 12, c1), 12)
    tm = TL.GhostBottleneck(c1, 16, k=3, s=s)
    _check(JL.GhostBottleneck(c2=16, k=3, s=s), tm, [x])
    assert hasattr(tm, "sc_dw") == (s == 2)


@pytest.mark.parametrize("c, k", [(13, (1, 3, 5)), (16, (1, 3))])
def test_mixconv2d_matches_jax(c, k):
    x = _x((2, 9, 11, c), 13)
    tm = TL.MixConv2d(c, c, k=k)
    _check(JL.MixConv2d(c2=c, k=k), tm, [x])
    # the remainder of the channel split goes to the first group
    assert tm.m0.weight.shape[0] == c - (len(k) - 1) * (c // len(k))


def test_attention_model_matches_jax():
    x = _x((2, 9, 11, 8), 14)
    _check(JL.AttentionModel(c2=8), TL.AttentionModel(8), [x])


def test_scaled_dot_product_attention_only_matches_jax():
    vkq = [_x((2, 6, 5, 8), s) for s in (15, 16, 17)]
    _check(JL.ScaledDotProductAttentionOnly(temperature=2.0),
           TL.ScaledDotProductAttentionOnly(2.0), [vkq])


@pytest.mark.parametrize("hw, c1, c2, ka, head, kc, s", [
    ((12, 12), 8, 16, 7, 4, 3, 1),      # the defaults
    ((12, 16), 8, 16, 7, 4, 3, 2),      # stride 2 on a non-square map
    ((10, 14), 6, 12, 5, 2, 3, 1),      # non-square, other kernel and heads
])
def test_acmix_matches_jax(hw, c1, c2, ka, head, kc, s):
    x = _x((2, *hw, c1), 18)
    got, ref, _ = _pair(
        JL.ACmix(c2=c2, kernel_att=ka, head=head, kernel_conv=kc, s=s),
        TL.ACmix(c1, c2, kernel_att=ka, head=head, kernel_conv=kc, s=s), [x])
    assert got.shape == (2, hw[0] // s, hw[1] // s, c2)
    assert _rel(got, ref) <= TOL


def test_acmix_init_and_names():
    tm = TL.ACmix(8, 16)
    assert tm.rate1.item() == tm.rate2.item() == 0.5
    assert tm.dep_conv.bias is None and tm.dep_conv.groups == 4
    assert tuple(tm.fc.weight.shape) == (9, 12)
    v = JL.ACmix(c2=16).init(jax.random.PRNGKey(0), j(_x((1, 8, 8, 8), 0)))
    sd = from_jax_variables(jax.tree.map(np.asarray, v))
    assert set(sd) == set(tm.state_dict())
    for k, w in sd.items():
        assert tuple(w.shape) == tuple(tm.state_dict()[k].shape), k


@pytest.mark.parametrize("method", sorted(KERNELS))
def test_upsample_methods_match_jax_image_resize(method):
    x = _x((2, 5, 7, 3), 19)
    got, ref, _ = _pair(JL.Upsample(scale=2, method=method),
                        TL.Upsample(2, method), [x])
    assert _rel(got, ref) <= RESIZE_TOL
    for size in ((11, 4), (3, 16)):     # down and up, one axis each way
        ref = jax.image.resize(j(x), (2, *size, 3), method=method)
        assert _rel(resize(t(x), size, method), ref) <= RESIZE_TOL


def test_upsample_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match='Unknown resize method "area"'):
        TL.Upsample(2, "area")
    with pytest.raises(ValueError, match='Unknown resize method "area"'):
        jax.image.resize(j(_x((1, 2, 2, 1), 0)), (1, 4, 4, 1), "area")


def _layers(spec):
    return [(ld.i, ld.f, ld.name, tuple(ld.args), ld.c2)
            for ld in list(spec.backbone) + list(spec.head)]


def test_compiler_parses_every_layer_as_jax():
    cfg = yaml.safe_load(open(EVERY_LAYER))
    js, ts = jparse(cfg, ch_in=3), tparse(cfg, ch_in=3)
    assert _layers(ts) == _layers(js)
    for key in ("detect_from", "detect_ch", "detect_strides", "save",
                "anchors"):
        assert getattr(ts, key) == getattr(js, key), key
    names = {ld.name for ld in ts.backbone + ts.head}
    assert {"BottleneckCSP", "BottleneckCSP2", "SPPCSP", "Contract",
            "Expand", "CrossConv", "GhostConv", "GhostBottleneck",
            "MixConv2d", "AttentionModel", "ACmix", "Sum"} <= names
    methods = {ld.args[1] for ld in ts.head if ld.name == "Upsample"}
    assert methods == set(KERNELS) | {"nearest"}
    # strides as JAX reads them: ACmix's args[4], MixConv2d's args[2]
    # (whose module runs at stride 1 all the same), Contract's gain
    mix = dict(cfg, backbone=cfg["backbone"][:6] + [
        [-1, 1, "MixConv2d", [64, [1, 3], 2]]], head=[
        [[-1, 4], 1, "Concat", [1]], [[7], 1, "Detect", ["nc", "anchors"]]])
    assert (tparse(mix, ch_in=3).detect_strides
            == jparse(mix, ch_in=3).detect_strides == (8.0,))


def test_every_layer_model_matches_jax():
    cfg = yaml.safe_load(open(EVERY_LAYER))
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jm = jbuild(cfg, ch_in=3, input_mode="RGB")
    v = drawn_variables(jm, j(x), j(x), seed=0)
    ref = jm.apply(v, j(x), j(x))["raw"]
    tm = tbuild(cfg, ch_in=3, input_mode="RGB").eval()
    tm.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        got = tm(t(x), t(x))["raw"]
    assert [tuple(g.shape) for g in got] == [(2, 16, 16, 3, 7),
                                             (2, 8, 8, 3, 7)]
    for g, r in zip(got, ref):
        r = np.asarray(r)
        # spread over positions (not the bias prior of each channel)
        assert r.reshape(-1, 7).std(0).mean() > 100 * MODEL_TOL
        np.testing.assert_allclose(g.numpy(), r, rtol=MODEL_TOL,
                                   atol=MODEL_TOL)


def test_unknown_module_raises_jax_keyerror():
    cfg = yaml.safe_load(open(EVERY_LAYER))
    bad = dict(cfg, backbone=cfg["backbone"][:1]
               + [[-1, 1, "Classify", [8]]] + cfg["backbone"][2:])
    for parse in (jparse, tparse):
        with pytest.raises(KeyError, match="unknown module 'Classify'"):
            parse(bad, ch_in=3)
