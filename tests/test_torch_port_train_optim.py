"""Schedules, the accumulation plan, parameter groups, the optimizer chain
and the EMA of the port vs the JAX package (optax), f32 on the CPU.

Tolerances: the schedules are scalar formulas, evaluated in f32 by JAX and
in Python floats here (1e-6 relative); SGD updates and EMA values 1e-6
(elementwise f32 arithmetic in another order of operations); Adam 1e-5:
its normalized updates are of size lr whatever the gradient, so seven
steps at the bias group's warmup lr of 0.1 accumulate f32 rounding on
parameters of size ~0.5 (measured 1.4e-6 absolute).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.train import optim as jopt
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.train import optim as topt
from sodt_tpu_torch.weights import from_jax_variables, from_jax_tree

from torch_port_common import rand, t, j, close

HYP = dict(lr0=0.01, lrf=0.2, momentum=0.937, warmup_epochs=3.0,
           warmup_momentum=0.8, warmup_bias_lr=0.1)


def test_torch_one_cycle_and_linear_match_jax():
    for x in (0, 1, 7.5, 30):
        assert topt.one_cycle(1.0, 0.2, 30)(x) == pytest.approx(
            float(jopt.one_cycle(1.0, 0.2, 30)(x)), rel=1e-6)
        assert topt.linear_lf(0.2, 30)(x) == pytest.approx(
            float(jopt.linear_lf(0.2, 30)(x)), rel=1e-6)
    for hyp, nb in ((HYP, 10), (HYP, 500), (dict(HYP, warmup_iters=7), 10)):
        assert topt.warmup_iters_of(hyp, nb) == jopt.warmup_iters_of(hyp, nb)


@pytest.mark.parametrize("k_final,nw", [(1, 10), (4, 10), (8, 37), (2, 3)])
def test_torch_warmup_accumulate_plan_equal(k_final, nw):
    tg, tn = topt.warmup_accumulate_plan(k_final, nw)
    jg, jn = jopt.warmup_accumulate_plan(k_final, nw)
    for ni in range(3 * nw + 20):
        assert tg(ni) == bool(jg(ni)), ni
    for g in range(nw + 20):
        assert tn(g) == int(jn(g)), g


@pytest.mark.parametrize("linear_lr", [False, True])
@pytest.mark.parametrize("accumulate", [1, 4])
def test_torch_lr_schedules_match_jax(linear_lr, accumulate):
    hyp, epochs, nb = dict(HYP, warmup_iters=25), 12, 10
    plans = [(None, None)]
    if accumulate > 1:
        plans.append((topt.warmup_accumulate_plan(accumulate, 25)[1],
                      jopt.warmup_accumulate_plan(accumulate, 25)[1]))
    for tplan, jplan in plans:
        ts = topt.lr_schedules(hyp, epochs, nb, linear_lr=linear_lr,
                               accumulate=accumulate, ni_of_step=tplan)
        js = jopt.lr_schedules(hyp, epochs, nb, linear_lr=linear_lr,
                               accumulate=accumulate, ni_of_step=jplan)
        assert ts[3] == js[3] == 25
        for step in (0, 1, 5, 24, 25, 26, 60, 119):
            for tf, jf in zip(ts[:3], js[:3]):
                assert tf(step) == pytest.approx(float(jf(step)), rel=1e-6,
                                                 abs=1e-9), step


def _flagship_trees():
    jm = jbuild("sodt_tpu/configs/model.yaml", ch_in=4, input_mode="RGB+IR")
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, x))
    v = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return jm, v


def test_torch_param_labels_equal_jax_for_the_flagship_tree():
    """Every parameter of the flagship gets the label JAX gives the flax
    leaf it is converted from (the bridge carries a tree of label codes)."""
    _, v = _flagship_trees()
    jlabels = jopt.param_labels(v["params"])
    code = {"decay": 1.0, "bias": 2.0, "nodecay": 3.0}
    coded = jax.tree.map(lambda lab, p: np.full(p.shape, code[lab], np.float32),
                         jlabels, v["params"])
    want = from_jax_tree(coded)
    tm = tbuild("sodt_tpu_torch/configs/model.yaml", ch_in=4)
    params = dict(tm.named_parameters())
    labels = topt.param_labels(params)
    assert set(labels) == set(want) == set(params)
    for k, lab in labels.items():
        assert (want[k] == code[lab]).all(), (k, lab)
    assert labels["l0.stage1_0.attn.relative_position_bias_table"] == "nodecay"
    assert labels["l0.pos_embed"] == "decay"
    assert labels["l0.neck1.a.weight"] == "decay"
    assert labels["l0.stage1_0.norm1.weight"] == "nodecay"
    assert labels["l0.stage1_0.attn.qkv.bias"] == "bias"


def _small_params(seed):
    shapes = {"conv": {"kernel": (3, 3, 4, 8)},
              "dense": {"kernel": (8, 6), "bias": (6,)},
              "norm": {"scale": (6,), "bias": (6,)},
              "attn": {"relative_position_bias_table": (9, 2)}}
    out, k = {}, 0
    for m, leaves in shapes.items():
        out[m] = {}
        for n, s in leaves.items():
            out[m][n] = rand(s, seed + k, 0.3)
            k += 1
    return out


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
@pytest.mark.parametrize("accumulate", [1, 3])
def test_torch_optimizer_updates_match_optax(adam, accumulate):
    """Seven data iterations of the whole chain (decay, Nesterov trace or
    Adam moments, scheduled lr and momentum, summed accumulation)."""
    hyp, epochs, nb = dict(HYP, warmup_iters=4), 5, 4
    jp = jax.tree.map(jnp.asarray, _small_params(0))
    tx = jopt.make_optimizer(hyp, jp, epochs, nb, adam=adam,
                             accumulate=accumulate)
    ost = tx.init(jp)
    tp = {k: v.clone() for k, v in from_jax_tree(_small_params(0)).items()}
    topt_ = topt.make_optimizer(hyp, tp, epochs, nb, adam=adam,
                                accumulate=accumulate)
    fired = []
    for it in range(7):
        g = _small_params(100 + 10 * it)
        ups, ost = tx.update(jax.tree.map(jnp.asarray, g), ost, jp)
        jp = optax.apply_updates(jp, ups)
        tu = topt_.update(from_jax_tree(g), tp)
        fired.append(topt_.just_stepped)
        if tu is not None:
            for k, u in tu.items():
                tp[k] += u
        want = from_jax_tree(jax.tree.map(np.asarray, jp))
        for k in tp:
            close(tp[k], want[k], 1e-5 if adam else 1e-6)
    if accumulate > 1:
        assert fired == [bool(jopt.warmup_accumulate_plan(accumulate, 4)[0](i))
                         for i in range(7)]
        assert not all(fired)
    else:
        assert all(fired)


def test_torch_ema_matches_jax():
    # d = base * (1 - exp(-step / tau)) in f32: at step 1 the difference
    # 1 - 0.9995 carries one ulp of 1.0 (6e-8) on 5e-4, i.e. 1.2e-4
    # relative, whichever exp is used; the EMA itself moves by that times
    # (ema - param), far below its own tolerance
    for step in (1, 2, 10, 2000, 100000):
        assert topt.ema_decay(step) == pytest.approx(
            float(jopt.ema_decay(jnp.float32(step))), rel=2.5e-4)
    e, p = _small_params(5), _small_params(6)
    want = jopt.ema_update(jax.tree.map(jnp.asarray, e),
                           jax.tree.map(jnp.asarray, p), jnp.asarray(3))
    te = from_jax_tree(e)
    topt.ema_update(te, from_jax_tree(p), 3)
    for k, v in from_jax_tree(jax.tree.map(np.asarray, want)).items():
        close(te[k], v, 1e-6)
