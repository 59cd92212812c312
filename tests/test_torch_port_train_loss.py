"""Loss side of the training slice: bbox_iou, the BCE / focal helpers,
build_targets_level, compute_loss (value and gradient w.r.t. the raw maps)
and BatchNorm's training mode, port vs JAX package, f32 on the CPU.

Tolerances: 1e-5 (absolute and relative) for the loss and its gradients -
both packages run the same f32 formulas, only the summation order and the
transcendental kernels differ; 1e-6 for BatchNorm (a mean and a variance),
1e-4 for the gradient through its batch statistics (sums of squares).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from sodt_tpu.ops.boxes import bbox_iou as j_bbox_iou
from sodt_tpu.train import loss as jloss
from sodt_tpu_torch.ops.boxes import bbox_iou as t_bbox_iou
from sodt_tpu_torch.train import loss as tloss
from sodt_tpu_torch.models.layers import BatchNorm

from torch_port_common import rand, t, j, close

MODES = [{}, {"giou": True}, {"diou": True}, {"ciou": True}]


def _boxes(seed, n=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, (n, 2))
    wh = rng.uniform(0.5, 4, (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


@pytest.mark.parametrize("mode", MODES, ids=["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xyxy", [True, False])
def test_torch_bbox_iou_matches_jax(mode, xyxy):
    b1, b2 = _boxes(1), _boxes(2)
    if xyxy:
        to = lambda b: np.concatenate([b[:, :2] - b[:, 2:] / 2,
                                       b[:, :2] + b[:, 2:] / 2], 1)
        b1, b2 = to(b1), to(b2)
    x1 = t(b1).requires_grad_()
    out = t_bbox_iou(x1, t(b2), xyxy=xyxy, **mode)
    ref, g = jax.value_and_grad(
        lambda a: j_bbox_iou(a, j(b2), xyxy=xyxy, **mode).sum())(j(b1))
    close(out.sum(), ref, 1e-5)
    close(out, j_bbox_iou(j(b1), j(b2), xyxy=xyxy, **mode), 1e-5)
    out.sum().backward()
    close(x1.grad, g, 1e-5)      # includes the stop-gradient on CIoU's alpha


def test_torch_bce_helpers_match_jax():
    x, y = rand((5, 7), 3, 2.0), np.random.default_rng(4).uniform(0, 1, (5, 7))
    y = y.astype(np.float32)
    assert tloss.smooth_bce(0.1) == jloss.smooth_bce(0.1)
    close(tloss.bce_with_logits(t(x), t(y), 1.5),
          jloss.bce_with_logits(j(x), j(y), 1.5), 1e-6)
    base = jloss.bce_with_logits(j(x), j(y))
    close(tloss.focal_modulation(t(x), t(y), t(base), 1.5),
          jloss.focal_modulation(j(x), j(y), base, 1.5), 1e-6)
    close(tloss.qfocal_modulation(t(x), t(y), t(base), 1.5),
          jloss.qfocal_modulation(j(x), j(y), base, 1.5), 1e-6)
    close(tloss.bce_blur_with_logits(t(x), t(y)),
          jloss.bce_blur_with_logits(j(x), j(y)), 1e-6)


def _targets(seed, b=2, m=6, n_real=(4, 2), nc=8):
    rng = np.random.default_rng(seed)
    tg = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i, n in enumerate(n_real):
        tg[i, :n, 0] = rng.integers(0, nc, n)
        tg[i, :n, 1:3] = rng.uniform(0.05, 0.95, (n, 2))
        tg[i, :n, 3:5] = rng.uniform(0.03, 0.3, (n, 2))
        mask[i, :n] = True
    return tg, mask


def test_torch_build_targets_level_equal():
    tg, mask = _targets(5)
    anchors = np.array([[1.2, 1.6], [2.0, 3.7], [4.1, 2.9]], np.float32)
    ja = jloss.build_targets_level(j(tg), jnp.asarray(mask), j(anchors), 16,
                                   16, 4.0)
    ta = tloss.build_targets_level(t(tg), torch.from_numpy(mask), t(anchors),
                                   16, 16, 4.0)
    assert set(ta) == set(ja)
    assert int(np.asarray(ja["pos"]).sum()) > 0
    for k in ja:
        a, b = ta[k].numpy(), np.asarray(ja[k])
        assert a.shape == b.shape, k
        if a.dtype.kind in "biu":
            assert (a == b).all(), k
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)


CFG = dict(nc=8, anchors=((10, 13, 16, 30, 33, 23), (30, 61, 62, 45, 59, 119)),
           strides=(4, 8))


@pytest.mark.parametrize("case", ["plain", "no_target", "focal", "smooth"])
def test_torch_compute_loss_value_and_grad_match_jax(case):
    """Two levels (the 5-level balance table), with targets, with none at
    all (npos clamps at 1) and with the focal modulation."""
    extra = {"focal": dict(fl_gamma=1.5), "smooth": dict(label_smoothing=0.1,
                                                        obj_pw=1.3, cls_pw=0.7)}
    kw = dict(CFG, hyp_box=0.05, hyp_obj=0.64, hyp_cls=0.05, **extra.get(case, {}))
    tg, mask = _targets(6, n_real=(0, 0) if case == "no_target" else (4, 2))
    preds = [rand((2, 16, 16, 3, 13), 7), rand((2, 8, 8, 3, 13), 8)]
    jcfg, tcfg = jloss.LossConfig(**kw), tloss.LossConfig(**kw)
    assert jcfg.balance == tcfg.balance and jcfg.na == tcfg.na == 3

    def jf(ps):
        total, parts = jloss.compute_loss(ps, j(tg), jnp.asarray(mask), jcfg)
        return total, parts
    (jt, jparts), jg = jax.value_and_grad(jf, has_aux=True)([j(p) for p in preds])
    tp = [t(p).requires_grad_() for p in preds]
    tt, tparts = tloss.compute_loss(tp, t(tg), torch.from_numpy(mask), tcfg)
    close(tt, jt, 1e-5)
    for k in ("box", "obj", "cls"):
        close(tparts[k], jparts[k], 1e-5)
    tt.backward()
    for a, b in zip(tp, jg):
        close(a.grad, b, 1e-5)
    if case == "no_target":
        assert float(tparts["box"].detach()) == 0.0
        assert float(tparts["cls"].detach()) == 0.0


def test_torch_scatter_max_on_colliding_slots():
    """Two targets in one cell with the same anchor: the obj target is the
    larger IoU, as JAX's `.at[].max`."""
    tg = np.zeros((1, 4, 5), np.float32)
    tg[0, :2] = [[1, 0.51, 0.52, 0.10, 0.12], [3, 0.515, 0.525, 0.16, 0.10]]
    mask = np.array([[True, True, False, False]])
    kw = dict(nc=8, anchors=((10, 13, 16, 30, 33, 23),), strides=(4,))
    p = rand((1, 32, 32, 3, 13), 9)
    jt, _ = jloss.compute_loss([j(p)], j(tg), jnp.asarray(mask),
                               jloss.LossConfig(**kw))
    tt, _ = tloss.compute_loss([t(p)], t(tg), torch.from_numpy(mask),
                               tloss.LossConfig(**kw))
    close(tt, jt, 1e-5)


class _JBN(nn.Module):
    @nn.compact
    def __call__(self, x, train):
        return nn.BatchNorm(use_running_average=not train, momentum=0.97,
                            epsilon=1e-3, name="bn")(x)


def test_torch_batchnorm_train_mode_matches_flax():
    """Batch statistics, biased variance in the running update, momentum
    0.97, and the gradient through the batch statistics."""
    c = 6
    x = rand((3, 5, 4, c), 10) * 2 + 1
    m = _JBN()
    v = m.init(jax.random.PRNGKey(0), j(x), False)
    v = {"params": {"bn": {"scale": j(1 + rand((c,), 11, 0.1)),
                           "bias": j(rand((c,), 12, 0.1))}},
         "batch_stats": {"bn": {"mean": j(rand((c,), 13, 0.1)),
                                "var": j(1 + np.abs(rand((c,), 14, 0.1)))}}}
    bn = BatchNorm(c)
    bn.load_state_dict({"weight": t(v["params"]["bn"]["scale"]),
                        "bias": t(v["params"]["bn"]["bias"]),
                        "running_mean": t(v["batch_stats"]["bn"]["mean"]),
                        "running_var": t(v["batch_stats"]["bn"]["var"])})
    bn.eval()
    close(bn(t(x)), m.apply(v, j(x), False), 1e-6)
    bn.train()
    for _ in range(2):                       # two updates of the statistics
        ref, mut = m.apply(v, j(x), True, mutable=["batch_stats"])
        close(bn(t(x)), ref, 1e-6)
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        close(bn.running_mean, mut["batch_stats"]["bn"]["mean"], 1e-6)
        close(bn.running_var, mut["batch_stats"]["bn"]["var"], 1e-6)
    xt = t(x).requires_grad_()
    (bn(xt) ** 2).sum().backward()
    g = jax.grad(lambda a: (m.apply(v, a, True, mutable=["batch_stats"])[0]
                            ** 2).sum())(j(x))
    close(xt.grad, g, 1e-4)
