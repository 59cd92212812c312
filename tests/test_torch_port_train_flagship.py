"""The training step at the flagship's width and depth (`model.yaml`:
embed 192, 6 + 4 + 1 Swin blocks, RGB+IR) against the JAX package, f32 on
the CPU, 64 px, batch 2, from the same converted weights and batches:
`make_train_step` of each package for three steps, with the bounds of
`test_torch_port_train_step.py` (`_held`: 1e-4 of a leaf's max for every
gradient, parameter, BN statistic and EMA leaf; 1e-5 for the loss parts).
That file holds the narrow model (embed 48); this one the widths at which
the chains and the replays run on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.train import loss as jloss, optim as jopt, state as jstate
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.train import loss as tloss, optim as topt, state as tstate
from sodt_tpu_torch.weights import (from_jax_variables, from_jax_tree,
                                    batch_to_torch)

from test_torch_port_train_step import HYP, EPOCHS, NB, _batch, _held
from torch_port_common import drawn_variables, j
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FLAGSHIP = "sodt_tpu/configs/model.yaml"
PORT_FLAGSHIP = "sodt_tpu_torch/configs/model.yaml"
STEPS = 3


def test_flagship_train_step_matches_jax_for_three_steps():
    jm = jbuild(FLAGSHIP, ch_in=4, input_mode="RGB+IR")
    b0 = _batch(0)
    v = drawn_variables(jm, j(b0["img"]), j(b0["ir"]), seed=2)
    kw = dict(nc=8, anchors=jm.spec.anchors, strides=jm.spec.detect_strides,
              hyp_box=0.15, hyp_obj=0.03, hyp_cls=0.15)
    jcfg, tcfg = jloss.LossConfig(**kw), tloss.LossConfig(**kw)

    jparams = jax.tree.map(jnp.asarray, v["params"])
    jtx = jopt.make_optimizer(HYP, jparams, EPOCHS, NB)
    js = jstate.TrainState.create(
        jparams, jax.tree.map(jnp.asarray, v["batch_stats"]), jtx)
    jstep = jax.jit(jstate.make_train_step(jm, jtx, jcfg))

    def jtotal(params, bs, batch):
        out, _ = jm.apply({"params": params, "batch_stats": bs}, batch["img"],
                          batch["ir"], train=True, mutable=["batch_stats"])
        return jloss.compute_loss(out["raw"], batch["targets"],
                                  batch["tmask"], jcfg)[0]
    jgrad = jax.jit(jax.grad(jtotal))

    tm = tbuild(PORT_FLAGSHIP, ch_in=4)
    assert sum(p.numel() for p in tm.parameters()) > 2e7     # full width
    tm.load_state_dict(from_jax_variables(v))
    ttx = topt.make_optimizer(HYP, dict(tm.named_parameters()), EPOCHS, NB)
    ts = tstate.TrainState.create(tm, ttx)
    tgrads = {}
    tstep = tstate.make_train_step(tm, ttx, tcfg, on_grads=tgrads.update)

    np_tree = lambda tree: jax.tree.map(np.asarray, tree)
    for it in range(STEPS):
        batch = _batch(30 + it)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        jg = jgrad(js.params, js.batch_stats, jb)
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, batch_to_torch(batch))
        for k in ("loss", "box", "obj", "cls"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert float(jmet["box"]) > 0
        _held(tgrads, from_jax_tree(np_tree(jg)), 1e-4, f"grads {it}")
        want = from_jax_variables({"params": np_tree(js.params),
                                   "batch_stats": np_tree(js.batch_stats)})
        _held(dict(tm.state_dict()), want, 1e-4, f"params + BN stats {it}")
        _held(ts.ema, from_jax_tree(np_tree(js.ema_params),
                                    np_tree(js.ema_batch_stats)), 1e-4,
              f"ema {it}")
        assert ts.step == int(js.step) == it + 1
