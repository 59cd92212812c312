"""The training slice as a whole: `make_train_step` of the port vs the JAX
package for three steps from the same converted weights and batches, f32
on the CPU (narrow flagship-shaped model, 64 px, batch 2), with
`accumulate` 1 and 2; the rule on the eval-time caches; the trainer CLI.

Tolerances. A leaf is held to max |port - jax| <= tol * max |jax| (+ 1e-7).
First step: 1e-4 for every gradient, parameter, BN statistic and EMA leaf,
1e-5 for the loss parts. After three steps the same bounds are still held
(measured on every step: gradients <= 4.8e-5, parameters, BN statistics
and EMA <= 1.6e-6): three steps of f32
training on a small model do not amplify the differences, which come from
the summation order of the two CPU backends.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from sodt_tpu.models import build_model as jbuild
from sodt_tpu.train import loss as jloss, optim as jopt, state as jstate
from sodt_tpu_torch.models import build_model as tbuild
from sodt_tpu_torch.train import loss as tloss, optim as topt, state as tstate
from sodt_tpu_torch.weights import (from_jax_variables, from_jax_tree,
                                    batch_to_torch)

from torch_port_common import NARROW_CFG, randomize_variables, j
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HYP = dict(lr0=0.01, lrf=0.2, momentum=0.937, warmup_momentum=0.8,
           warmup_bias_lr=0.1, warmup_iters=2)
IMG, BATCH, EPOCHS, NB = 64, 2, 3, 2


def _batch(seed):
    rng = np.random.default_rng(seed)
    tg = np.zeros((BATCH, 6, 5), np.float32)
    mask = np.zeros((BATCH, 6), bool)
    for i, n in enumerate((3, 2)):
        tg[i, :n, 0] = rng.integers(0, 8, n)
        tg[i, :n, 1:3] = rng.uniform(0.1, 0.9, (n, 2))
        tg[i, :n, 3:5] = rng.uniform(0.05, 0.3, (n, 2))
        mask[i, :n] = True
    return {"img": rng.uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32),
            "ir": rng.uniform(0, 1, (BATCH, IMG, IMG, 3)).astype(np.float32),
            "targets": tg, "tmask": mask}


def _held(got: dict, want: dict, tol: float, what: str) -> float:
    assert set(got) == set(want), what
    worst = 0.0
    for k, w in want.items():
        a, w = got[k].detach().numpy(), w.numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(a - w).max())
        if scale > 1e-6:     # leaves whose true value is 0 (a key bias's
            worst = max(worst, err / scale)   # gradient) hold by the atol
        assert err <= tol * scale + 1e-7, (what, k, err, scale)
    return worst


@pytest.mark.parametrize("accumulate", [1, 2])
def test_torch_train_step_matches_jax_for_three_steps(accumulate):
    jm = jbuild(NARROW_CFG, ch_in=4, input_mode="RGB+IR")
    b0 = _batch(0)
    v = jm.init(jax.random.PRNGKey(0), j(b0["img"]), j(b0["ir"]))
    v = randomize_variables(jax.tree.map(np.asarray, v), 1)
    kw = dict(nc=8, anchors=jm.spec.anchors, strides=jm.spec.detect_strides,
              hyp_box=0.15, hyp_obj=0.03, hyp_cls=0.15)
    jcfg, tcfg = jloss.LossConfig(**kw), tloss.LossConfig(**kw)

    jparams = jax.tree.map(jnp.asarray, v["params"])
    jtx = jopt.make_optimizer(HYP, jparams, EPOCHS, NB, accumulate=accumulate)
    js = jstate.TrainState.create(jparams,
                                  jax.tree.map(jnp.asarray, v["batch_stats"]),
                                  jtx)
    jstep = jax.jit(jstate.make_train_step(jm, jtx, jcfg,
                                           accumulate=accumulate))

    def jtotal(params, bs, batch):
        out, _ = jm.apply({"params": params, "batch_stats": bs}, batch["img"],
                          batch["ir"], train=True, mutable=["batch_stats"])
        return jloss.compute_loss(out["raw"], batch["targets"],
                                  batch["tmask"], jcfg)[0]
    jgrad = jax.jit(jax.grad(jtotal))

    tm = tbuild(NARROW_CFG, ch_in=4)
    tm.load_state_dict(from_jax_variables(v))
    ttx = topt.make_optimizer(HYP, dict(tm.named_parameters()), EPOCHS, NB,
                              accumulate=accumulate)
    ts = tstate.TrainState.create(tm, ttx)
    tgrads = {}
    tstep = tstate.make_train_step(tm, ttx, tcfg, on_grads=tgrads.update)

    np_tree = lambda tree: jax.tree.map(np.asarray, tree)
    fired = []
    for it in range(3):
        batch = _batch(10 + it)
        jb = {k: jnp.asarray(x) for k, x in batch.items()}
        jg = jgrad(js.params, js.batch_stats, jb)
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, batch_to_torch(batch))
        for k in ("loss", "box", "obj", "cls"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        _held(tgrads, from_jax_tree(np_tree(jg)), 1e-4, f"grads {it}")
        want = from_jax_variables({"params": np_tree(js.params),
                                   "batch_stats": np_tree(js.batch_stats)})
        _held(dict(tm.state_dict()), want, 1e-4, f"params + BN stats {it}")
        _held(ts.ema, from_jax_tree(np_tree(js.ema_params),
                                    np_tree(js.ema_batch_stats)), 1e-4,
              f"ema {it}")
        assert ts.ema_updates == int(js.ema_updates)
        assert ts.step == int(js.step) == it + 1
        fired.append(ttx.just_stepped)
    assert fired == ([True, True, True] if accumulate == 1
                     else [True, False, True])
    # the parameters did move, and the EMA is not the parameters
    moved = from_jax_variables(v)
    assert any((tm.state_dict()[k] - moved[k]).abs().max() > 1e-4
               for k in moved)


def test_torch_train_step_freeze_and_sr():
    tm = tbuild(NARROW_CFG, ch_in=4)
    from sodt_tpu_torch.weights import init_weights
    init_weights(tm, 0)
    cfg = tloss.LossConfig(nc=8, anchors=tm.spec.anchors,
                           strides=tm.spec.detect_strides)
    params = dict(tm.named_parameters())
    tx = topt.make_optimizer(HYP, params, EPOCHS, NB)
    # the SR branch is ported; what still fails is JAX's own failure at
    # --factor 1 (the decoder would resize to an empty map)
    with pytest.raises(ValueError, match="factor 1"):
        tbuild("sodt_tpu_torch/configs/SRyolo_PF.yaml", ch_in=4, sr=True,
               factor=1)
    before = {k: p.detach().clone() for k, p in params.items()}
    grads = {}
    step = tstate.make_train_step(tm, tx, cfg, freeze=("stage1_",),
                                  on_grads=grads.update)
    st = tstate.TrainState.create(tm, tx)
    for it in range(2):
        st, _ = step(st, batch_to_torch(_batch(20 + it)))
    for k, p in params.items():
        if "stage1_" in k:
            assert torch.equal(p, before[k]), k       # neither step nor decay
            assert grads[k].abs().max() == 0
    assert not torch.equal(params["l0.stage2_0.attn.qkv.weight"],
                           before["l0.stage2_0.attn.qkv.weight"])


def test_torch_eval_caches_are_not_read_in_training():
    """One rule for `SwinBlock.kernel_weights` and
    `WindowAttention.rel_bias`: a cache is read only under no_grad and
    only while no source parameter changed; under grad mode the casts and
    the bias gather are in the graph, also after `train()`."""
    from sodt_tpu_torch.models.swin import SwinBlock
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    torch.manual_seed(0)
    blk = SwinBlock(32, 4, 8, shift_size=2, linear_mlp=False).eval()
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.1)
    blk.dtype = torch.bfloat16
    cache_rel_bias(blk)
    assert blk._kernel_weights is not None and blk.attn.bias_cache is not None
    with torch.no_grad():
        kw = blk.kernel_weights(torch.bfloat16)
        assert kw is blk._kernel_weights                  # cached, detached
        assert blk.attn.rel_bias() is blk.attn.bias_cache
        assert not kw["wqkv"].requires_grad
        assert blk.kernel_weights(torch.float32) is not blk._kernel_weights
    # grad mode: in-graph casts and gather, gradients land on the f32 masters
    kw = blk.kernel_weights(torch.bfloat16)
    assert kw is not blk._kernel_weights
    assert kw["wqkv"].dtype == torch.bfloat16 and kw["wqkv"].requires_grad
    assert kw["wc"].shape == (32, 2, 2, 32)
    loss = (kw["wqkv"].float().sum() + kw["wc"].float().sum()
            + blk.attn.rel_bias().sum())
    loss.backward()
    for p in (blk.attn.qkv.weight, blk.mlp.conv1.weight,
              blk.attn.relative_position_bias_table):
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert p.grad.abs().max() > 0
    # an in-place update (an optimizer step) makes the caches stale at once
    with torch.no_grad():
        blk.attn.qkv.weight.add_(1.0)
        blk.attn.relative_position_bias_table.add_(1.0)
        fresh = blk.kernel_weights(torch.bfloat16)
        assert fresh is not blk._kernel_weights
        torch.testing.assert_close(fresh["wqkv"].float(),
                                   blk.attn.qkv.weight.bfloat16().float())
        assert blk.attn.rel_bias() is not blk.attn.bias_cache
        assert (blk.attn.rel_bias() - blk.attn.bias_cache - 1).abs().max() < 1e-6
    # training mode reads no cache either: the key check is the one rule
    blk.train()
    assert blk.kernel_weights(torch.bfloat16) is not blk._kernel_weights
    assert blk.attn.rel_bias().requires_grad
    # the block's output in eval with caches equals the uncached one
    x = torch.randn(1, 16, 16, 32)
    blk.eval()
    with torch.no_grad():
        ref = blk(x)
        cache_rel_bias(blk)
        torch.testing.assert_close(blk(x), ref)


def test_torch_train_cli_runs_on_cpu_when_asked(tmp_path, capsys, monkeypatch):
    from sodt_tpu_torch.train import cli
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    hyp = tmp_path / "hyp.yaml"
    with open("sodt_tpu_torch/configs/hyp.scratch.yaml") as f:
        h = yaml.safe_load(f)
    hyp.write_text(yaml.safe_dump(dict(h, warmup_iters=2)))
    args = ["--cfg", str(cfg), "--hyp", str(hyp), "--synthetic",
            "--synthetic-n", "4", "--img-size", "64", "--batch-size", "2",
            "--nbs", "4", "--epochs", "2", "--notest", "--no-bf16",
            "--save-dir", str(tmp_path / "run")]
    m = cli.main(args + ["--device", "cpu"])
    assert m["steps"] == 4 and m["device"] == "cpu" and m["seen"] == 4
    assert all(np.isfinite(v) for ep in m["losses"] for v in ep.values())
    assert '"map50"' in capsys.readouterr().out
    # --rect and VEDAI folders are ported: JAX's refusal of --rect with
    # --multi-scale, and the data yaml's fold list read without --synthetic
    with pytest.raises(ValueError, match="--rect is incompatible"):
        cli.main(args + ["--device", "cpu", "--rect", "--multi-scale"])
    # --evolve, --remat, --scan-epoch and --wandb are ported: they parse
    a = cli.parser().parse_args(args + ["--evolve", "2", "--remat",
                                        "--scan-epoch", "off", "--wandb"])
    assert (a.evolve, a.remat, a.scan_epoch, a.wandb) == (2, True, "off",
                                                          True)
    with pytest.raises(FileNotFoundError, match="fold01_write.txt"):
        cli.main([a for a in args if a != "--synthetic"] + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)                      # the default device is the card
